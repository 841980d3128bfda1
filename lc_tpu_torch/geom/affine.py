"""Affine crop math for DZI ROI crops, host-side numpy (copy of
lc_tpu/geom/affine.py, which cannot be imported without jax).

The crop is the similarity transform
    A = T(out_w/2, out_h/2) · S(out_w/scale) · Rot(-rot) · T(-cx - sx, -cy - sy)
with (sx, sy) = scale * shift, composed in closed form.
"""
from __future__ import annotations

import numpy as np


def crop_affine(center, scale, rot_rad, output_size, shift=(0.0, 0.0)):
    """The (..., 2, 3) affine mapping full-image pixels -> crop pixels.

    center: (..., 2) ROI center (cx, cy); scale: (...,) ROI side in source
    pixels; rot_rad: (...,) in-plane rotation; output_size: (out_w, out_h);
    shift: (..., 2) relative shift in units of scale.
    """
    center = np.asarray(center, dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    rot_rad = np.asarray(rot_rad, dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)
    out_w, out_h = (output_size, output_size) \
        if isinstance(output_size, (int, float)) else output_size

    src_c = center + scale[..., None] * shift
    s = out_w / scale
    cos, sin = np.cos(rot_rad), np.sin(rot_rad)
    a00 = s * cos
    a01 = s * sin
    a10 = -s * sin
    a11 = s * cos
    b0 = out_w * 0.5 - (a00 * src_c[..., 0] + a01 * src_c[..., 1])
    b1 = out_h * 0.5 - (a10 * src_c[..., 0] + a11 * src_c[..., 1])
    rows = np.stack((a00, a01, b0, a10, a11, b1), axis=-1)
    return rows.reshape(rows.shape[:-1] + (2, 3))


def invert_affine(aff, xp=np):
    """Invert a (..., 2, 3) affine. xp is numpy or torch (both spell the
    elementwise ops used here the same way)."""
    A = aff[..., :2]
    b = aff[..., 2]
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    inv00 = A[..., 1, 1] / det
    inv01 = -A[..., 0, 1] / det
    inv10 = -A[..., 1, 0] / det
    inv11 = A[..., 0, 0] / det
    ib0 = -(inv00 * b[..., 0] + inv01 * b[..., 1])
    ib1 = -(inv10 * b[..., 0] + inv11 * b[..., 1])
    rows = xp.stack((inv00, inv01, ib0, inv10, inv11, ib1), -1)
    return rows.reshape(rows.shape[:-1] + (2, 3))


def affine33(aff):
    """Lift (..., 2, 3) -> (..., 3, 3) homogeneous."""
    last = np.broadcast_to(np.asarray([0.0, 0.0, 1.0], dtype=aff.dtype),
                           aff.shape[:-2] + (1, 3))
    return np.concatenate((aff, last), axis=-2)
