"""ctypes bindings for the native host-side data kernels (native/lcdata.cpp),
with numpy/cv2 fallbacks when the shared library isn't built (copy of
lc_tpu/data/native.py).

Build once with `sh native/build.sh`; auto-discovered next to the repo root.
"""
from __future__ import annotations

import ctypes
import os.path as osp

import numpy as np

_LIB = None


def _find_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    here = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    path = osp.join(here, 'native', 'liblcdata.so')
    if osp.exists(path):
        try:
            _LIB = ctypes.CDLL(path)
        except OSError:
            _LIB = False
    else:
        _LIB = False
    return _LIB


def available() -> bool:
    return bool(_find_lib())


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    lib = _find_lib()
    if not lib:
        from . import rle
        return rle.decode({'size': [h, w], 'counts': counts})
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.zeros((h, w), np.uint8)
    lib.rle_decode_u8(counts.ctypes.data_as(ctypes.c_void_p), len(counts),
                      h, w, out.ctypes.data_as(ctypes.c_void_p))
    return out


def median3_u16(z: np.ndarray) -> np.ndarray:
    lib = _find_lib()
    if not lib:
        import cv2
        return cv2.medianBlur(z, 3)
    z = np.ascontiguousarray(z, np.uint16)
    out = np.empty_like(z)
    lib.median3_u16(z.ctypes.data_as(ctypes.c_void_p), z.shape[0], z.shape[1],
                    out.ctypes.data_as(ctypes.c_void_p))
    return out


def zcrop_expand(z16: np.ndarray, xyxy, z_min: float, z_max: float,
                 size_hw) -> tuple[np.ndarray, np.ndarray]:
    """z_crop patch -> (homo_z (H, W, 3), msk (H, W)) full-image maps."""
    H, W = size_hw
    homo = np.zeros((H, W, 3), np.float32)
    msk = np.zeros((H, W), np.float32)
    x1, y1, _, _ = xyxy
    lib = _find_lib()
    if lib:
        z16 = np.ascontiguousarray(z16, np.uint16)
        lib.zcrop_expand_f32(
            z16.ctypes.data_as(ctypes.c_void_p), z16.shape[0], z16.shape[1],
            int(x1), int(y1), ctypes.c_float(z_min), ctypes.c_float(z_max),
            H, W, homo.ctypes.data_as(ctypes.c_void_p),
            msk.ctypes.data_as(ctypes.c_void_p))
        return homo, msk
    # numpy fallback (same math as reference dataset.py:299-310)
    m = z16 != 0
    v, u = np.nonzero(m)
    z = (z16[m].astype(np.float32) - 1) * ((z_max - z_min) / 65534) + z_min
    u1, v1 = u + int(x1), v + int(y1)
    ok = (u1 >= 0) & (u1 < W) & (v1 >= 0) & (v1 < H)
    u1, v1, z = u1[ok], v1[ok], z[ok]
    homo[v1, u1] = np.stack((u1 + 0.5, v1 + 0.5, np.ones_like(u1)), -1) \
        * z[:, None]
    msk[v1, u1] = 1.0
    return homo, msk
