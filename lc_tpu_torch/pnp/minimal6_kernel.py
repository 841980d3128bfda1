"""RANSAC's minimal-sample hypotheses as a hand-written CUDA kernel
(csrc/minimal6.cu): EPnP-6, planar-6 and DLT-6 on every sample of a
ransac_pnp call, in one launch.

Replaces no Pallas kernel: lc_tpu's ransac_pnp solves its samples with
lc_tpu/pnp/fast_minimal.py on every backend but the CPU, a module XLA fuses
into a handful of kernels. Its plain PyTorch version is
fast_minimal.minimal6, which chip_smoke.py and the CPU tests hold the kernel
against. ransac.hypothesis_solver sends a CUDA call here; the CPU keeps
lc_tpu's CPU branch, the generic estimators.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.smallmat import start_basis
from .fast_minimal import ESTIMATORS

SAMPLE_SIZE = 6   # lc_tpu's _to_lanes takes 6-point samples only

_vp, _ci = ctypes.c_void_p, ctypes.c_int


def _lib():
    from .. import cuda_build
    lib = cuda_build.load('minimal6')
    if lib.lc_minimal6.argtypes is None:
        lib.lc_minimal6.argtypes = [_vp] * 5 + [_ci] * 4 + [_vp]
        lib.lc_minimal6.restype = _ci
        lib.lc_minimal6_set_basis.argtypes = [_vp]
        lib.lc_minimal6_set_basis.restype = _ci
        lib.lc_minimal6_lanes.restype = _ci
    return lib


@functools.cache
def basis_arg() -> np.ndarray:
    """The kernel's start basis: lc_tpu's 12x4 basis in float32, row-major
    (element 4 i + k is row i, column k); computed once, read-only."""
    arg = np.ascontiguousarray(start_basis(12, 4), dtype=np.float32).ravel()
    arg.flags.writeable = False
    return arg


# the devices whose constant memory holds the basis
_basis_on: set[int] = set()


def _put_basis(lib, dev: torch.device):
    """Write the start basis into the kernel's constant memory on `dev`
    (the current device), once a device."""
    if dev.index in _basis_on:
        return
    err = lib.lc_minimal6_set_basis(basis_arg().ctypes.data)
    if err != 0:
        raise RuntimeError(f'minimal6: writing the start basis failed: CUDA '
                           f'error {err}')
    _basis_on.add(dev.index)


def lanes() -> dict[str, int]:
    """The lanes of a warp that solve one problem of each estimator in the
    built kernel (planar and DLT take one)."""
    return dict(epnp=_lib().lc_minimal6_lanes(), planar=1, dlt=1)


def estimator_codes(estimators) -> list[int]:
    """The codes (0 epnp, 1 planar, 2 dlt) of the named estimators in
    lc_tpu's concatenation order; raises on an unknown name or none."""
    unknown = set(estimators) - set(ESTIMATORS)
    if unknown or not estimators:
        raise ValueError(f'minimal6: estimators {tuple(estimators)}, expected '
                         f'a non-empty subset of {ESTIMATORS}')
    return [i for i, name in enumerate(ESTIMATORS) if name in estimators]


def check_inputs(cam_K, sub3d, sub2d, estimators) -> list[int]:
    """Raise on anything the kernel does not take: an unknown estimator, a
    sample size other than 6, mismatched shapes, a dtype other than f32,
    non-contiguous memory, a tensor that is not on one CUDA device. Returns
    the estimators' codes."""
    codes = estimator_codes(estimators)
    if sub3d.dim() != 4 or sub3d.shape[-2:] != (SAMPLE_SIZE, 3):
        raise ValueError(f'minimal6: sub3d has shape {tuple(sub3d.shape)}, '
                         f'expected (B, K, {SAMPLE_SIZE}, 3)')
    B, K = sub3d.shape[:2]
    for name, t, shape in (('cam_K', cam_K, (B, 3, 3)),
                           ('sub2d', sub2d, (B, K, SAMPLE_SIZE, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f'minimal6: {name} has shape {tuple(t.shape)}, '
                             f'expected {shape}')
    tensors = (('cam_K', cam_K), ('sub3d', sub3d), ('sub2d', sub2d))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f'minimal6: {name} is {t.dtype}, expected '
                            'torch.float32')
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f'minimal6: {name} is not contiguous')
    for name, t in tensors:
        if not t.is_cuda or t.device != sub3d.device:
            raise ValueError(f'minimal6_cuda takes CUDA tensors on one device '
                             f'({name} is on {t.device}); the CPU runs '
                             'ransac.generic_hypotheses')
    return codes


def minimal6_cuda(cam_K: torch.Tensor, sub3d: torch.Tensor,
                  sub2d: torch.Tensor, estimators=ESTIMATORS
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """fast_minimal.minimal6 on the card, in one launch: cam_K (B, 3, 3),
    sub3d (B, K, 6, 3), sub2d (B, K, 6, 2), f32 CUDA tensors → pose_h
    (B, nE·K, 7), ok_h (B, nE·K) in lc_tpu's order (epnp, planar, dlt, those
    named). `minimal6_cuda.launches` counts the launches."""
    codes = check_inputs(cam_K, sub3d, sub2d, estimators)
    B, K = sub3d.shape[:2]
    n = len(codes)
    dev = sub3d.device
    pose = torch.empty((B, n * K, 7), dtype=torch.float32, device=dev)
    ok = torch.empty((B, n * K), dtype=torch.bool, device=dev)
    if B * K == 0:
        return pose, ok
    lib = _lib()
    with torch.cuda.device(dev):
        _put_basis(lib, dev)
        err = lib.lc_minimal6(
            cam_K.data_ptr(), sub3d.data_ptr(), sub2d.data_ptr(),
            pose.data_ptr(), ok.data_ptr(), B, K, n,
            sum(c << (2 * i) for i, c in enumerate(codes)),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'minimal6 kernel launch failed: CUDA error {err}')
    minimal6_cuda.launches += 1
    return pose, ok


minimal6_cuda.launches = 0


# element operations that produce a float, counted once per problem by
# ops_per_problem (movement, comparisons and masks are not counted)
_COUNTED_OPS = frozenset((
    'add', 'sub', 'rsub', 'mul', 'div', 'neg', 'reciprocal', 'sqrt', 'atan2',
    'cos', 'sin', 'clamp', 'clamp_min', 'maximum', 'where', 'abs', 'pow',
    'nan_to_num'))


def ops_per_problem() -> dict[str, int]:
    """The f32 element operations each estimator of fast_minimal (the plain
    version) performs on one problem: every arithmetic operation it
    dispatches on its (P,) lanes counts once (a transcendental as one, so
    the count is a floor of the work). The solvers are straight-line, so
    the count is the same for any problem; it is taken on the CPU at P = 1.
    The kernel's bound is this count times P over the card's f32 peak."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from . import fast_minimal

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket.__name__.rstrip('_') in _COUNTED_OPS
                    and isinstance(out, torch.Tensor)
                    and out.is_floating_point()):
                Count.n += 1
            return out

    rng = np.random.default_rng(0)
    cam_K = torch.tensor([[[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]]])
    sub3d = torch.tensor(rng.uniform(-50, 50, (1, 1, 6, 3)), dtype=torch.float32)
    sub2d = torch.tensor(rng.uniform(0, 640, (1, 1, 6, 2)), dtype=torch.float32)
    counts = {}
    for name in ESTIMATORS:
        Count.n = 0
        with Count():
            fast_minimal.minimal6(cam_K, sub3d, sub2d, (name,))
        counts[name] = Count.n
    return counts
