"""The fused LM PnP refiner as a hand-written CUDA kernel (csrc/lm_refine.cu).

Replaces the TPU kernel lc_tpu/pnp/pallas_lm.py::_lm_kernel (wrapper
`pallas_lm_refine`). Its plain PyTorch version is solver.lm_refine, which the
CPU takes and which chip_smoke.py holds the kernel against on the card.

The kernel runs one thread block per problem, keeps the problem's points in
shared memory for the whole solve and lets each problem stop on its own. What
bounds it is the serial iteration chain (reduce, 6x6 Cholesky on one thread,
trial-cost reduce, trust-region decision), not bytes or flops; see the source
for the design.
"""
from __future__ import annotations

import ctypes

import torch

from .solver import LMResult, prepare_weights

# flops per point in one LM iteration (cost/gradient/normal-equation pass plus
# the trial-cost pass) and in the initial cost pass, counted from the
# arithmetic of lm_refine.cu (a fused multiply-add counts as two); used for
# the kernel's roofline bound
FLOPS_PER_POINT_ITER = 271
FLOPS_PER_POINT_INIT = 38

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_max_points: dict[int, int] = {}


def _lib():
    from .. import cuda_build
    lib = cuda_build.load('lm_refine')
    if lib.lc_lm_refine.argtypes is None:
        lib.lc_lm_refine.argtypes = [_vp] * 11 + [_ci, _ci, _ci, _cf, _vp]
        lib.lc_lm_refine.restype = _ci
        lib.lc_lm_max_points.argtypes = [_ci]
        lib.lc_lm_max_points.restype = _ci
    return lib


def check_inputs(pose7_init, cam_K, pts3d, pts2d, weights, valid):
    """Raise on anything the kernel does not take: mixed devices, a dtype other
    than f32 (bool for valid), mismatched shapes, non-contiguous memory."""
    B, N = pts3d.shape[:2] if pts3d.dim() == 3 else (None, None)
    expect = {'pose7_init': (pose7_init, (B, 7)), 'cam_K': (cam_K, (B, 3, 3)),
              'pts3d': (pts3d, (B, N, 3)), 'pts2d': (pts2d, (B, N, 2))}
    if weights.dim() == 2:
        expect['weights'] = (weights, (B, N))
    else:
        expect['weights'] = (weights, (B, N, 2))
    if valid is not None:
        expect['valid'] = (valid, (B, N))
    dev = pts3d.device
    for name, (t, shape) in expect.items():
        if B is None or tuple(t.shape) != shape:
            raise ValueError(f'lm_refine: {name} has shape {tuple(t.shape)}, '
                             f'expected {shape}')
        want = torch.bool if name == 'valid' else torch.float32
        if t.dtype != want:
            raise TypeError(f'lm_refine: {name} is {t.dtype}, expected {want}')
        if t.device != dev:
            raise ValueError(f'lm_refine: {name} is on {t.device}, '
                             f'pts3d on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'lm_refine: {name} is not contiguous')


def lm_refine_cuda(pose7_init: torch.Tensor, cam_K: torch.Tensor,
                   pts3d: torch.Tensor, pts2d: torch.Tensor,
                   weights: torch.Tensor, valid: torch.Tensor | None = None, *,
                   max_iter: int = 50, function_tolerance: float = 1e-6,
                   fallback_to_init: bool = True) -> LMResult:
    """solver.lm_refine on the card, through the fused kernel. Takes CUDA
    tensors only; `lm_refine_cuda.launches` counts the kernel launches."""
    check_inputs(pose7_init, cam_K, pts3d, pts2d, weights, valid)
    if not pts3d.is_cuda:
        raise ValueError('lm_refine_cuda takes CUDA tensors; the CPU runs '
                         'solver.lm_refine')
    B, N = pts3d.shape[:2]
    dev = pts3d.device
    lib = _lib()
    if dev.index not in _max_points:
        _max_points[dev.index] = lib.lc_lm_max_points(dev.index)
    if N > _max_points[dev.index]:
        raise ValueError(f'lm_refine_cuda: {N} points exceed the '
                         f'{_max_points[dev.index]} one block holds in shared '
                         'memory')
    w2, n_valid = prepare_weights(pts2d, weights, valid)
    out_pose = torch.empty((B, 7), dtype=torch.float32, device=dev)
    invalid = torch.empty((B,), dtype=torch.bool, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    n_iter = torch.empty((B,), dtype=torch.int32, device=dev)
    radius = torch.empty((B,), dtype=torch.float32, device=dev)
    if B > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.lc_lm_refine(
                pose7_init.data_ptr(), cam_K.data_ptr(), pts3d.data_ptr(),
                pts2d.data_ptr(), w2.data_ptr(), n_valid.data_ptr(),
                out_pose.data_ptr(), invalid.data_ptr(), cost.data_ptr(),
                n_iter.data_ptr(), radius.data_ptr(), B, N, int(max_iter),
                float(function_tolerance), stream)
        if err != 0:
            raise RuntimeError(f'lm_refine kernel launch failed: CUDA error '
                               f'{err}')
        lm_refine_cuda.launches += 1
    if fallback_to_init:   # Ceres contract: invalid solves keep the init
        out_pose = torch.where(invalid[:, None], pose7_init, out_pose)
    return LMResult(pose7=out_pose, invalid=invalid, cost=cost, n_iter=n_iter,
                    radius=radius)


lm_refine_cuda.launches = 0
