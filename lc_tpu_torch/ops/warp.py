"""The rotated DZI crop by three shears (counterpart of
lc_tpu/ops/pallas_warp.py), with the shear pass as a hand-written CUDA kernel
(csrc/shear_x.cu).

The crop of a rotated square ROI runs in four stages, as in lc_tpu:
  1. an axis-aligned separable crop into a 1.5x intermediate
     (data/crop.batched_separable_warp, two batched matmuls);
  2. the 90-degree quadrant fold, by indexing: each sample reads its own
     quadrant's pixels, with lc_tpu's flip-and-roll convention;
  3. the residual rotation |theta| <= pi/4 as three shears,
     R(theta) = ShearX(alpha) ShearY(beta) ShearX(alpha),
     alpha = -tan(theta/2), beta = sin(theta);
  4. the central crop to the output size.

`shear_x_reference` is the plain PyTorch version of the shear, which the CPU
takes; `shear_x_cuda` launches the kernel on CUDA tensors and raises on
anything else; `shear_x_auto` dispatches on the tensor's device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..data.crop import batched_separable_warp

_vp, _ci = ctypes.c_void_p, ctypes.c_int


def shear_x_reference(img: torch.Tensor, shifts: torch.Tensor,
                      axis: int = 0) -> torch.Tensor:
    """Per-line fractional shift, bilinear along the line, zero outside it.

    img: (B, H, W, C); shifts: (B, H) for axis=0, where
    out[b, y, x] = img[b, y, x + shifts[b, y]]; (B, W) for axis=1, where
    out[b, y, x] = img[b, y + shifts[b, x], x]."""
    if axis == 1:
        return shear_x_reference(img.transpose(1, 2), shifts).transpose(1, 2)
    B, H, W, C = img.shape
    x = torch.arange(W, dtype=torch.float32, device=img.device)
    src = x[None, None, :] + shifts[..., None]                 # (B, H, W)
    x0 = torch.floor(src)
    f = (src - x0)[..., None]
    x0i = x0.to(torch.int64)

    def tap(xi):
        ok = (xi >= 0) & (xi < W)
        idx = xi.clamp(0, W - 1)[..., None].expand(B, H, W, C)
        return torch.gather(img, 2, idx) * ok[..., None]

    return tap(x0i) * (1.0 - f) + tap(x0i + 1) * f


def _lib():
    from .. import cuda_build
    lib = cuda_build.load('shear_x')
    if lib.lc_shear.argtypes is None:
        lib.lc_shear.argtypes = [_vp, _vp, _vp] + [_ci] * 5 + [_vp]
        lib.lc_shear.restype = _ci
    return lib


def shear_x_cuda(img: torch.Tensor, shifts: torch.Tensor,
                 axis: int = 0) -> torch.Tensor:
    """shear_x_reference on the card, through the kernel. Takes contiguous
    f32 CUDA tensors on one device, with 1 or 3 channels (the mask, the RGB
    crop); `shear_x_cuda.launches` counts the kernel launches."""
    if img.dim() != 4 or img.shape[3] not in (1, 3):
        raise ValueError(f'shear_x: img has shape {tuple(img.shape)}, '
                         'expected (B, H, W, C) with 1 or 3 channels')
    if axis not in (0, 1):
        raise ValueError(f'shear_x: axis is {axis}, expected 0 or 1')
    B, H, W, C = img.shape
    want = (B, H) if axis == 0 else (B, W)
    if tuple(shifts.shape) != want:
        raise ValueError(f'shear_x: shifts has shape {tuple(shifts.shape)}, '
                         f'expected {want}')
    for name, t in (('img', img), ('shifts', shifts)):
        if t.dtype != torch.float32:
            raise TypeError(f'shear_x: {name} is {t.dtype}, expected float32')
        if not t.is_cuda:
            raise ValueError('shear_x_cuda takes CUDA tensors; the CPU runs '
                             'shear_x_reference')
        if not t.is_contiguous():
            raise ValueError(f'shear_x: {name} is not contiguous')
    if shifts.device != img.device:
        raise ValueError(f'shear_x: shifts is on {shifts.device}, img on '
                         f'{img.device}')
    if img.numel() >= 2 ** 31 or max(H, W) >= 2 ** 24:
        raise ValueError('shear_x: image too large for the kernel')
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.lc_shear(img.data_ptr(), shifts.data_ptr(), out.data_ptr(),
                           B, H, W, C, axis, stream)
    if err != 0:
        raise RuntimeError(f'shear_x kernel launch failed: CUDA error {err}')
    shear_x_cuda.launches += 1
    return out


shear_x_cuda.launches = 0


def shear_x_auto(img: torch.Tensor, shifts: torch.Tensor,
                 axis: int = 0) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if img.is_cuda:
        return shear_x_cuda(img, shifts, axis)
    return shear_x_reference(img, shifts, axis)


def _fold_quadrant(theta: torch.Tensor):
    """theta = q * (pi/2) + residual with the residual in [-pi/4, pi/4]."""
    q = torch.round(theta / (math.pi / 2.0))
    return q.to(torch.int64) % 4, theta - q * (math.pi / 2.0)


def quadrant_index(n: int, device) -> torch.Tensor:
    """(4, n*n) flat source index of each output pixel of an n x n image for
    the quarter turns q = 0..3 of lc_tpu's `_apply_quadrant`: the flips and
    transposes rotate about the pixel center (n-1)/2, and the roll by one
    moves that to n/2, so q=1 reads [j, (n-i) % n], q=2 reads
    [(n-i) % n, (n-j) % n] and q=3 reads [(n-j) % n, i]."""
    i = torch.arange(n, device=device)[:, None].expand(n, n)
    j = torch.arange(n, device=device)[None, :].expand(n, n)
    ri, rj = (n - i) % n, (n - j) % n
    maps = [(i, j), (j, ri), (ri, rj), (rj, i)]
    return torch.stack([(r * n + c).reshape(-1) for r, c in maps])


def apply_quadrant(img: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate each square image of (B, n, n, C) by its q[b] quarter turns,
    reading only its own quadrant's pixels (one gather)."""
    B, n, n2, C = img.shape
    if n != n2:
        raise ValueError('apply_quadrant: square images only')
    idx = quadrant_index(n, img.device)[q]                     # (B, n*n)
    flat = img.reshape(B, n * n, C)
    return torch.gather(flat, 1, idx[..., None].expand(B, n * n, C)) \
        .reshape(B, n, n, C)


def unrotated_crop_affine(center: torch.Tensor, scale: torch.Tensor,
                          out_wh: tuple) -> torch.Tensor:
    """geom.affine.crop_affine with rotation 0, on tensors: (B, 2, 3)."""
    out_w, out_h = out_wh
    s = out_w / scale
    zero = torch.zeros_like(s)
    b0 = out_w * 0.5 - s * center[:, 0]
    b1 = out_h * 0.5 - s * center[:, 1]
    return torch.stack((s, zero, b0, zero, s, b1), -1).reshape(-1, 2, 3)


def rotated_crop_warp(imgs: torch.Tensor, center: torch.Tensor,
                      scale: torch.Tensor, rot_rad: torch.Tensor,
                      out_wh: tuple, *, shear=shear_x_auto) -> torch.Tensor:
    """The DZI crop with rotation, without a per-pixel 2D gather.

    imgs: (B, H, W, C) f32; center (B, 2); scale (B,); rot_rad (B,).
    Equivalent to cv2.warpAffine(img, crop_affine(center, scale, rot), out_wh)
    up to the two-stage resampling. The shears run through the CUDA kernel
    on CUDA tensors (three launches), through the plain version on the CPU;
    `shear` replaces that dispatch (chip_smoke.py passes the plain version
    to hold the composed warp on the card against its plain composition)."""
    out_w, out_h = out_wh
    if out_w != out_h:
        raise ValueError('rotated_crop_warp: square crops only')
    q, theta = _fold_quadrant(rot_rad)

    # stage 1: axis-aligned crop into a 1.5x intermediate, which covers the
    # rotated support of the output square for |theta| <= pi/4 plus the
    # shears' padding
    inter = int(out_w * 1.5)
    aff = unrotated_crop_affine(center, scale * 1.5, (inter, inter))
    mid = batched_separable_warp(imgs, aff, (inter, inter), 'bilinear')

    # stage 2: the quarter turns
    mid = apply_quadrant(mid, q)

    # stage 3: the residual rotation about the intermediate's center
    # inter/2 (crop_affine maps the ROI center there, between pixels)
    alpha = -torch.tan(theta / 2.0)
    beta = torch.sin(theta)
    rows = torch.arange(inter, dtype=torch.float32, device=imgs.device) \
        - inter / 2.0
    sx = (alpha[:, None] * rows[None, :]).contiguous()
    sy = (beta[:, None] * rows[None, :]).contiguous()
    mid = shear(mid, sx)
    mid = shear(mid, sy, axis=1)
    mid = shear(mid, sx)

    # stage 4: the central crop
    off = (inter - out_h) // 2
    return mid[:, off:off + out_h, off:off + out_w, :]
