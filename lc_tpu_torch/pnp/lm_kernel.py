"""The fused LM PnP refiner as a hand-written CUDA kernel (csrc/lm_refine.cu).

Replaces the TPU kernel lc_tpu/pnp/pallas_lm.py::_lm_kernel (wrapper
`pallas_lm_refine`). Its plain PyTorch version is solver.lm_refine, which the
CPU takes and which chip_smoke.py holds the kernel against on the card.

A call is one device operation: the kernel takes the weights as given
((B, N) or (B, N, 2)) and the valid mask or none, counts the valid points,
applies `fallback_to_init` and writes every output into one buffer, which the
wrapper allocates with one `torch.empty` and hands out as views. The kernel
spreads each problem over a cluster of 4 thread blocks of 128 threads, each
loading its slice of the points into shared memory by bulk asynchronous
copy, makes one pass over the points and one barrier per iteration, and
lets each problem stop on its own. What bounds it is the serial iteration
chain, not bytes or flops; see the source for the design.
"""
from __future__ import annotations

import ctypes

import torch

from .solver import LMResult

# flops per point of the LM function's least work: the cost, gradient and
# normal equations at the current pose plus the trial cost, per iteration,
# and the initial cost (a fused multiply-add counts as two); used for the
# kernel's roofline bound
FLOPS_PER_POINT_ITER = 271
FLOPS_PER_POINT_INIT = 38

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_max_points: dict[int, int] = {}


def _lib():
    from .. import cuda_build
    lib = cuda_build.load('lm_refine')
    if lib.lc_lm_refine.argtypes is None:
        lib.lc_lm_refine.argtypes = [_vp] * 7 + [_ci] * 4 + [_cf, _ci, _vp]
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


def output_views(buf: torch.Tensor, B: int) -> LMResult:
    """The kernel's outputs as views of its one f32 buffer of 10 B + ⌈B/4⌉
    words: pose (B, 7), cost, radius, n_iter (int32), then invalid (bool
    bytes), in the order lm_refine.cu writes them."""
    pose, cost, radius, n_iter, flags = buf.split_with_sizes(
        [7 * B, B, B, B, buf.numel() - 10 * B])
    # positional: a call's host time is most of its time (PERF.md)
    return LMResult(pose.view(B, 7), flags.view(torch.bool)[:B], cost,
                    n_iter.view(torch.int32), radius)


def max_points(device_index: int) -> int:
    """The largest N a call takes on this device: each of a problem's 4
    blocks holds its quarter of the points in shared memory."""
    if device_index not in _max_points:
        _max_points[device_index] = _lib().lc_lm_max_points(device_index)
    return _max_points[device_index]


def launch(pose7_init, cam_K, pts3d, pts2d, weights, valid, max_iter,
           function_tolerance, fallback_to_init) -> LMResult:
    """The kernel on CUDA inputs that check_inputs has passed; one device
    operation. Counts in `lm_refine_cuda.launches`."""
    B, N = pts3d.shape[:2]
    dev = pts3d.device
    lib = _lib()
    if N > max_points(dev.index):
        raise ValueError(f'lm_refine_cuda: {N} points exceed the '
                         f'{max_points(dev.index)} the kernel holds in shared '
                         'memory')
    buf = torch.empty(10 * B + (B + 3) // 4, dtype=torch.float32, device=dev)
    if B > 0:
        with torch.cuda.device(dev):
            err = lib.lc_lm_refine(
                pose7_init.data_ptr(), cam_K.data_ptr(), pts3d.data_ptr(),
                pts2d.data_ptr(), weights.data_ptr(),
                None if valid is None else valid.data_ptr(), buf.data_ptr(),
                B, N, int(weights.dim() == 3), int(max_iter),
                float(function_tolerance), int(bool(fallback_to_init)),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f'lm_refine kernel launch failed: CUDA error '
                               f'{err}')
        lm_refine_cuda.launches += 1
    return output_views(buf, B)


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
    return launch(pose7_init, cam_K, pts3d, pts2d, weights, valid, max_iter,
                  function_tolerance, fallback_to_init)


lm_refine_cuda.launches = 0
