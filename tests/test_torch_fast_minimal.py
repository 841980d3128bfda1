"""The port's accelerator-branch hypothesis solvers against lc_tpu's.

lc_tpu's ransac_pnp solves its 6-point samples with the generic estimators
only on the CPU backend; elsewhere with lc_tpu/pnp/fast_minimal.py, which
lc_tpu_torch/pnp/fast_minimal.py transcribes (the plain version of the
minimal6 CUDA kernel). lc_tpu's functions run eagerly here, as lc_tpu's own
tier-1 tests run them: XLA:CPU takes minutes to compile the scalar-struct
trace. Inputs come from seeded numpy, made as tests/test_pnp.py:301-372 makes
them (P = 8 x 50 samples).

Tolerances. The two packages take atan2/cos/sin from different libraries, so
near-degenerate samples may take another, equally valid branch; the bulk is
held tightly:
  * EPnP and planar (planar on planar samples): `ok` agrees on >= 99%; over
    jointly valid noise-free problems the 99th percentile of the translation
    difference (largest coordinate) < 0.05 mm and the 1st percentile of
    |q·q'| > 1 − 1e-5 (tests/test_torch_ransac.py:90-91); with 1 px noise
    lc_tpu's own `_pin` bounds (tests/test_pnp.py:374-386);
  * DLT, whose 11x11 ridge normal equations are ill-conditioned in f32: the
    quantiles of tests/test_torch_ransac.py:86-88;
  * the helpers: 1e-5 relative.

The kernel's source (csrc/minimal6.cu) is also compiled for the host through
a shim of the CUDA names and held against lc_tpu bit for bit: it cannot run
here as CUDA, but its arithmetic can.
"""
import ctypes
import importlib
import os.path as osp
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu import geom
from lc_tpu_torch import cuda_build
from lc_tpu_torch.ops.smallmat import start_basis
from lc_tpu_torch.pnp import fast_minimal as tf
from lc_tpu_torch.pnp import minimal6_kernel as mk
from lc_tpu_torch.pnp import ransac as tr

jf = importlib.import_module('lc_tpu.pnp.fast_minimal')
jr = importlib.import_module('lc_tpu.pnp.ransac')

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)


def samples(noise, planar=False):
    """tests/test_pnp.py's _problems (spread samples) and _planar_problems
    (6 points on a random plane per sample): (cam_K, sub3d, sub2d, t)."""
    rng = np.random.default_rng(3 if planar else 0)
    B, Kh = 8, 50
    Kc = np.broadcast_to(K, (B, 3, 3)).copy()
    Rs = sciR.random(B * Kh, random_state=4 if planar else 1).as_matrix(
    ).astype(np.float32).reshape(B, Kh, 3, 3)
    ts = np.concatenate((rng.uniform(-5, 5, (B, Kh, 2)),
                         rng.uniform(400, 600, (B, Kh, 1))),
                        -1).astype(np.float32)
    if planar:
        frames = sciR.random(B * Kh, random_state=5).as_matrix().astype(
            np.float32).reshape(B, Kh, 3, 3)
        ab = rng.uniform(-50, 50, (B, Kh, 6, 2)).astype(np.float32)
        P3 = (ab[..., :1] * frames[:, :, None, :, 0]
              + ab[..., 1:2] * frames[:, :, None, :, 1])
    else:
        P3 = rng.uniform(-50, 50, (B, Kh, 6, 3)).astype(np.float32)
    cam = np.einsum('bkij,bknj->bkni', Rs, P3) + ts[:, :, None]
    uvw = np.einsum('bij,bknj->bkni', Kc, cam)
    uv = (uvw[..., :2] / uvw[..., 2:3]
          + rng.normal(0, noise, uvw[..., :2].shape)).astype(np.float32)
    return Kc, P3.astype(np.float32), uv, ts


def lc_tpu_hypotheses(name, Kc, P3, uv):
    kw = dict(tf.EPNP_KW) if name == 'epnp' else {}
    p, ok = getattr(jf, f'{name}6_fast')(jnp.asarray(Kc), jnp.asarray(P3),
                                         jnp.asarray(uv), **kw)
    return np.asarray(p), np.asarray(ok)


def hold(name, noise, pj, okj, pt, okt):
    """The tolerances of the module docstring, lc_tpu (pj, okj) against the
    port or the kernel (pt, okt)."""
    both = okj & okt
    dt = np.abs(pj[..., 4:] - pt[..., 4:]).max(-1)[both]
    dq = np.abs(np.sum(pj[..., :4] * pt[..., :4], -1))[both]
    if name == 'dlt':
        assert (okj == okt).mean() >= 0.99
        assert np.median(dt) < 0.1 and np.quantile(dt, 0.9) < 1.0
        assert np.quantile(dq, 0.1) > 1 - 1e-4
    elif noise == 0:
        assert (okj == okt).mean() >= 0.99, (okj == okt).mean()
        assert np.quantile(dt, 0.99) < 0.05, np.quantile(dt, 0.99)
        assert np.quantile(dq, 0.01) > 1 - 1e-5, np.quantile(dq, 0.01)
    else:   # lc_tpu's _pin
        assert np.mean(okj != okt) < 0.01
        assert both.mean() > 0.7
        dtn = np.linalg.norm(pj[..., 4:] - pt[..., 4:], axis=-1)[both]
        assert np.median(dtn) < 0.1 and np.percentile(dtn, 90) < 5.0


CASES = [(name, noise) for name in tf.ESTIMATORS for noise in (0.0, 1.0)]


@pytest.mark.parametrize('name,noise', CASES,
                         ids=[f'{n}-{s:g}px' for n, s in CASES])
def test_estimator_matches_lc_tpu(name, noise):
    Kc, P3, uv, _ = samples(noise, planar=name == 'planar')
    pj, okj = lc_tpu_hypotheses(name, Kc, P3, uv)
    kw = dict(tf.EPNP_KW) if name == 'epnp' else {}
    pt, okt = getattr(tf, f'{name}6_fast')(torch.tensor(Kc), torch.tensor(P3),
                                           torch.tensor(uv), **kw)
    hold(name, noise, pj, okj, pt.numpy(), okt.numpy())


def test_minimal6_concatenates_in_lc_tpu_order():
    Kc, P3, uv, _ = samples(0.0)
    Kt, P3t, uvt = torch.tensor(Kc), torch.tensor(P3), torch.tensor(uv)
    for est in (('epnp', 'planar', 'dlt'), ('dlt', 'epnp'), ('planar',)):
        pose, ok = tf.minimal6(Kt, P3t, uvt, est)
        parts = [getattr(tf, f'{n}6_fast')(Kt, P3t, uvt)
                 for n in tf.ESTIMATORS if n in est]
        assert torch.equal(pose, torch.cat([p[0] for p in parts], 1))
        assert torch.equal(ok, torch.cat([p[1] for p in parts], 1))


def _lanes(a):
    return [jnp.asarray(x) for x in a], [torch.tensor(x) for x in a]


def _close(j, t, rtol=1e-5):
    j, t = np.asarray(j), t.numpy()
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(j).max()))


def test_helpers_match_lc_tpu():
    rng = np.random.default_rng(5)
    P = 64
    # _eigh3 on symmetric 3x3s
    A = rng.normal(size=(P, 3, 3)).astype(np.float32)
    A = A + A.transpose(0, 2, 1)
    entries = [A[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                       (2, 2))]
    ej, et = _lanes(entries)
    vj, Vj = jf._eigh3(*ej)
    vt, Vt = tf._eigh3(*et)
    for a, b in zip(vj, vt):
        _close(a, b)
    for i in range(3):
        for k in range(3):
            _close(Vj[i][k], Vt[i][k])

    # _chol_lists / _chol_solve_lists on 12x12s with EPnP's absent (x, y)
    # block; the last lane is not SPD
    n = 12
    G = rng.normal(size=(P, n, n)).astype(np.float32)
    S = G @ G.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    S[:, 4:8, 0:4] = S[:, 0:4, 4:8] = 0.0
    S[-1] -= 40.0 * np.eye(n, dtype=np.float32)
    keys = [(i, j) for i in range(n) for j in range(i, n)
            if not (i < 4 <= j < 8)]
    mj, mt = _lanes([S[:, i, j] for i, j in keys])
    Lj, Ldj, okj = jf._chol_lists(dict(zip(keys, mj)), n)
    Lt, Ldt, okt = tf._chol_lists(dict(zip(keys, mt)), n)
    okj, okt = np.asarray(okj), okt.numpy()
    assert okj[:-1].all() and not okj[-1]
    np.testing.assert_array_equal(okj, okt)
    spd = slice(0, P - 1)
    for i in range(n):
        for j in range(n):
            assert (Lj[i][j] is None) == (Lt[i][j] is None), (i, j)
            if Lj[i][j] is not None:
                _close(Lj[i][j][spd], Lt[i][j][spd])
    bj, bt = _lanes(list(rng.normal(size=(n, P)).astype(np.float32)))
    xj = jf._chol_solve_lists(Lj, Ldj, bj, n)
    xt = tf._chol_solve_lists(Lt, Ldt, bt, n)
    for a, b in zip(xj, xt):
        _close(a[spd], b[spd])

    # _polar3 on perturbed rotations, _quat_from_rows on rotations (every
    # Shepperd pivot among them)
    R = sciR.random(P, random_state=6).as_matrix().astype(np.float32)
    R[:4] = np.diag([1, 1, 1]), np.diag([1, -1, -1]), np.diag([-1, 1, -1]), \
        np.diag([-1, -1, 1])
    M = R + 0.05 * rng.normal(size=R.shape).astype(np.float32)
    mj, mt = _lanes([M[:, i, j] for i in range(3) for j in range(3)])
    Xj = jf._polar3([mj[3 * i:3 * i + 3] for i in range(3)])
    Xt = tf._polar3([mt[3 * i:3 * i + 3] for i in range(3)])
    for i in range(3):
        for j in range(3):
            _close(Xj[i][j], Xt[i][j])
    rj, rt = _lanes([R[:, i, j] for i in range(3) for j in range(3)])
    qj = jf._quat_from_rows([rj[3 * i:3 * i + 3] for i in range(3)])
    qt = tf._quat_from_rows([rt[3 * i:3 * i + 3] for i in range(3)])
    for a, b in zip(qj, qt):
        _close(a, b)
    assert (qt[0] >= 0).all()


def test_start_basis_is_lc_tpus(monkeypatch):
    """The basis lc_tpu's epnp6_scalar starts from, caught at its QR, equals
    the port's bit for bit, and the kernel's argument is it in f32,
    row-major (a transposed layout would start another Ritz frame)."""
    seen = []
    qr = np.linalg.qr

    def spy(a, *args, **kw):
        out = qr(a, *args, **kw)
        seen.append(np.array(out[0]))
        return out
    monkeypatch.setattr(np.linalg, 'qr', spy)
    Kc, P3, uv, _ = samples(0.0)
    jf.epnp6_fast(jnp.asarray(Kc[:1]), jnp.asarray(P3[:1, :1]),
                  jnp.asarray(uv[:1, :1]))
    monkeypatch.setattr(np.linalg, 'qr', qr)
    assert len(seen) == 1 and seen[0].shape == (12, 4)
    X0 = seen[0]
    assert np.array_equal(start_basis(12, 4), X0)
    arg = mk.basis_arg()
    assert arg.dtype == np.float32 and arg.shape == (48,)
    for i in range(12):
        for k in range(4):
            assert arg[4 * i + k] == np.float32(X0[i, k])
    assert not np.array_equal(arg, X0.T.astype(np.float32).ravel())


def sparse_samples(untrained):
    """6-of-16-keypoint samples as the sparse path draws them: the 16
    keypoints data/synthetic.py gives the sparse head (the first 16 of
    box_surface_points(half_extents, 16), all on the box's x = -40 face),
    8 x 50 seeded draws, the 64² output grid's camera; noise-free
    projections, or the 2D positions of an untrained head (the soft-argmax
    of near-uniform heatmaps: the grid's centre, +-0.5 px)."""
    from lc_tpu_torch.data.synthetic import box_surface_points
    rng = np.random.default_rng(31)
    B, Kh = 8, 50
    kp = box_surface_points(np.array([40., 30., 20.]), 16)[:16]
    R = sciR.random(B, random_state=32).as_matrix()
    t = np.concatenate((rng.uniform(-50, 50, (B, 2)),
                        rng.uniform(600, 800, (B, 1))), -1)
    f = 0.4 * np.array([572.4, 573.6])
    Kc = np.zeros((B, 3, 3))
    Kc[:, 0, 0], Kc[:, 1, 1], Kc[:, 2, 2] = f[0], f[1], 1.0
    Kc[:, :2, 2] = 32.0 - f * t[:, :2] / t[:, 2:3]
    cam = np.einsum('bij,nj->bni', R, kp) + t[:, None]
    uvw = np.einsum('bij,bnj->bni', Kc, cam)
    uv = uvw[..., :2] / uvw[..., 2:3]
    if untrained:
        uv = 32.0 + rng.normal(0, 0.5, uv.shape)
    idx = np.argsort(rng.random((B, Kh, 16)), -1)[..., :6]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return (f32(Kc), f32(kp[idx]),
            f32(np.take_along_axis(uv[:, None], idx[..., None], 2)))


@pytest.mark.parametrize('untrained', [False, True],
                         ids=['noise_free', 'untrained'])
def test_dlt6_on_sparse_keypoints_matches_lc_tpu(untrained):
    """DLT-6 on the sparse path's samples: lc_tpu's dlt6_fast (eager) and
    the port's plain version flag the same samples. The 16 keypoints lie
    on one face of the box, and DLT-6 needs points off a plane: neither
    finds a valid hypothesis."""
    Kc, P3, uv = sparse_samples(untrained)
    _, okj = lc_tpu_hypotheses('dlt', Kc, P3, uv)
    _, okt = tf.dlt6_fast(torch.tensor(Kc), torch.tensor(P3), torch.tensor(uv))
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert not okj.any()


def lc_tpu_sample_idx(key, valid, num_hypotheses, sample_size=6):
    """lc_tpu's Gumbel top-k draw (lc_tpu/pnp/ransac.py:265-273)."""
    B, N = valid.shape
    gumbel = jax.random.gumbel(key, (B, num_hypotheses, N))
    scores = jnp.where(jnp.asarray(valid)[:, None, :], gumbel, -jnp.inf)
    ar = jnp.arange(N)
    cols = []
    for _ in range(sample_size):
        i = jnp.argmax(scores, axis=-1)
        cols.append(i)
        scores = jnp.where(ar == i[..., None], -jnp.inf, scores)
    return np.asarray(jnp.stack(cols, axis=-1))


def _pose_diff(a, b):
    dt = np.abs(a[..., 4:] - b[..., 4:]).max(-1)
    dq = np.abs(np.sum(a[..., :4] * b[..., :4], -1))
    return dt, dq


def test_accelerator_branch_matches_lc_tpu_tpu_branch(monkeypatch):
    """lc_tpu's test_tpu_dispatch_branch case (tests/test_pnp.py:411-429):
    lc_tpu's ransac_pnp with its backend reported as 'tpu', against the
    port's with hypothesis_solver patched to the plain accelerator branch,
    on lc_tpu's Gumbel indices."""
    rng = np.random.default_rng(11)
    Rs = sciR.random(2, random_state=11).as_matrix().astype(np.float32)
    ts = np.concatenate((rng.uniform(-50, 50, (2, 2)),
                         rng.uniform(600, 800, (2, 1))), -1).astype(np.float32)
    pts3d = rng.uniform(-40, 40, (2, 48, 3)).astype(np.float32)
    Ks = np.ascontiguousarray(np.broadcast_to(K, (2, 3, 3)))
    pose = np.asarray(geom.RT_to_pose7(jnp.asarray(Rs), jnp.asarray(ts)))
    uv = np.asarray(geom.project_apply(jnp.asarray(Ks), jnp.asarray(pts3d),
                                       jnp.asarray(Rs), jnp.asarray(ts)))
    key = jax.random.PRNGKey(0)
    idx = lc_tpu_sample_idx(key, np.ones((2, 48), bool), num_hypotheses=8)

    monkeypatch.setattr(jr.jax, 'default_backend', lambda: 'tpu')
    rj = jr.ransac_pnp(jnp.asarray(Ks), jnp.asarray(pts3d), jnp.asarray(uv),
                       key, num_hypotheses=8, local_opt=False)
    calls = []

    def accelerator(device):
        calls.append(device)
        return tf.minimal6
    monkeypatch.setattr(tr, 'hypothesis_solver', accelerator)
    rt = tr.ransac_pnp(torch.tensor(Ks), torch.tensor(pts3d), torch.tensor(uv),
                       sample_idx=torch.tensor(idx), num_hypotheses=8,
                       local_opt=False)
    assert calls == [torch.device('cpu')]
    assert not np.asarray(rj.invalid).any() and not rt.invalid.any()
    dt, dq = _pose_diff(np.asarray(rj.pose7), rt.pose7.numpy())
    assert np.all(dt < 0.05) and np.all(dq > 1 - 1e-5), (dt, dq)
    np.testing.assert_array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    dt_gt, dq_gt = _pose_diff(rt.pose7.numpy(), pose)
    assert dt_gt.max() < 5.0 and dq_gt.min() > 0.999


def test_cpu_path_reaches_generic_estimators(monkeypatch):
    """On the CPU the hypothesis stage stays lc_tpu's CPU branch; a CUDA
    tensor would go to the kernel."""
    assert tr.hypothesis_solver(torch.device('cpu')) is tr.generic_hypotheses
    assert tr.hypothesis_solver(torch.device('cuda')) is mk.minimal6_cuda
    calls = []
    generic = tr.generic_hypotheses

    def spy(*a):
        calls.append(a[3])
        return generic(*a)
    monkeypatch.setattr(tr, 'generic_hypotheses', spy)
    Kc, P3, uv, _ = samples(0.0)
    pts3d = torch.tensor(P3[:2].reshape(2, -1, 3))
    pts2d = torch.tensor(uv[:2].reshape(2, -1, 2))
    res = tr.ransac_pnp(torch.tensor(Kc[:2]), pts3d, pts2d,
                        torch.Generator().manual_seed(0), num_hypotheses=4,
                        local_opt=False, hyp_estimators=('epnp', 'dlt'))
    assert calls == [('epnp', 'dlt')]
    assert res.pose7.shape == (2, 7)


def _bad_inputs(fault):
    Kc, P3, uv, _ = samples(0.0)
    cam_K, sub3d, sub2d = (torch.tensor(Kc[:2]), torch.tensor(P3[:2, :4]),
                           torch.tensor(uv[:2, :4]))
    est = tf.ESTIMATORS
    if fault == 'float64':
        sub3d = sub3d.double()
    elif fault == 'sample_size_5':
        sub3d, sub2d = sub3d[:, :, :5].contiguous(), sub2d[:, :, :5].contiguous()
    elif fault == 'unknown_estimator':
        est = ('epnp', 'p3p')
    elif fault == 'no_estimator':
        est = ()
    elif fault == 'not_contiguous':
        sub2d = sub2d.transpose(0, 1).contiguous().transpose(0, 1)
    return cam_K, sub3d, sub2d, est


FAULTS = {'cpu_tensor': ValueError, 'float64': TypeError,
          'sample_size_5': ValueError, 'unknown_estimator': ValueError,
          'no_estimator': ValueError, 'not_contiguous': ValueError}


@pytest.mark.parametrize('fault', list(FAULTS))
def test_wrapper_raises_before_build(fault, monkeypatch):
    """minimal6_cuda raises on what the kernel does not take, before it
    builds or launches anything: no fallback to the plain version."""
    def no_build(name):
        raise AssertionError(f'built {name}')
    monkeypatch.setattr(cuda_build, 'load', no_build)
    before = mk.minimal6_cuda.launches
    with pytest.raises(FAULTS[fault]):
        mk.minimal6_cuda(*_bad_inputs(fault))
    assert mk.minimal6_cuda.launches == before


def test_ops_per_problem():
    """The operation count the kernel's bound rests on: straight-line code,
    so each estimator's count is a fixed number of (P,) operations."""
    counts = mk.ops_per_problem()
    assert set(counts) == set(tf.ESTIMATORS)
    assert counts['epnp'] > counts['planar'] > 1000
    assert counts['dlt'] > 1000


# ---------------------------------------------------------------------------
# the kernel's source, compiled for the host
# ---------------------------------------------------------------------------

HOST_SHIM = r"""#pragma once
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
#include <ucontext.h>
using std::isnan; using std::isinf; using std::isfinite;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __constant__
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
static uint3 blockIdx, threadIdx;
static dim3 gridDim, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaErrorInvalidValue = 1;
template <class T>
inline int cudaMemcpyToSymbol(T& symbol, const void* src, size_t count) {
  std::memcpy(&symbol, src, count);
  return 0;
}

// A block's threads run as coroutines on one host thread, one after
// another (in lane order, or reversed), each up to its next __syncwarp; a
// thread waiting there goes on once every lane of its mask has reached the
// same barrier. A lane that returns while its group waits for it, a
// barrier whose lanes name different masks, or a deadlock stops the run,
// and cudaGetLastError reports it.
namespace host_warp {
struct Thread {
  ucontext_t ctx;
  long syncs = 0;
  unsigned mask = 0;
  bool waiting = false, done = false;
};
static ucontext_t scheduler;
static std::vector<Thread> threads;
static std::vector<std::vector<char>> stacks;
static std::function<void()> body;
static int current;
static bool reverse_order;
static const char* error;

inline void fail(const char* what, int t) {
  if (error) return;
  error = what;
  std::fprintf(stderr, "host warp: %s (thread %d)\n", what, t);
}
inline void entry() {
  body();
  threads[current].done = true;
  swapcontext(&threads[current].ctx, &scheduler);
}
inline bool may_resume(int t) {
  const Thread& me = threads[t];
  if (!me.waiting) return true;
  const int base = t - t % 32;
  for (int l = 0; l < 32; ++l) {
    if (!(me.mask >> l & 1u)) continue;
    if (base + l >= (int)threads.size()) {
      fail("mask names no thread", t);
      return false;
    }
    const Thread& other = threads[base + l];
    if (other.syncs < me.syncs) {
      if (other.done) fail("__syncwarp waits for a lane that returned", t);
      return false;
    }
    if (other.syncs == me.syncs && other.mask != me.mask) {
      fail("lanes of one barrier name different masks", t);
      return false;
    }
  }
  return true;
}
template <class F>
void launch(dim3 grid, dim3 block, F f) {
  gridDim = grid;
  blockDim = block;
  const int n = (int)block.x;
  stacks.resize(n);
  for (auto& s : stacks) s.resize(1 << 19);
  body = f;
  error = nullptr;
  for (unsigned bx = 0; bx < grid.x && !error; ++bx) {
    blockIdx.x = bx;
    threads.assign(n, Thread());
    for (int t = 0; t < n; ++t) {
      Thread& th = threads[t];
      getcontext(&th.ctx);
      th.ctx.uc_stack.ss_sp = stacks[t].data();
      th.ctx.uc_stack.ss_size = stacks[t].size();
      th.ctx.uc_link = nullptr;
      makecontext(&th.ctx, entry, 0);
    }
    for (int left = n; left > 0 && !error;) {
      bool moved = false;
      for (int i = 0; i < n && !error; ++i) {
        const int t = reverse_order ? n - 1 - i : i;
        Thread& th = threads[t];
        if (th.done || !may_resume(t)) continue;
        th.waiting = false;
        current = t;
        threadIdx.x = t;
        swapcontext(&scheduler, &th.ctx);
        left -= th.done;
        moved = true;
      }
      if (!moved) fail("no thread can pass its barrier", -1);
    }
  }
}
}  // namespace host_warp

inline int cudaGetLastError() { return host_warp::error ? 1 : 0; }

inline void __syncwarp(unsigned mask = 0xffffffffu) {
  host_warp::Thread& th = host_warp::threads[host_warp::current];
  if (!(mask >> (host_warp::current % 32) & 1u))
    host_warp::fail("__syncwarp outside its own mask", host_warp::current);
  ++th.syncs;
  th.mask = mask;
  th.waiting = true;
  swapcontext(&th.ctx, &host_warp::scheduler);
}

extern "C" void lc_host_reverse_lanes(int on) { host_warp::reverse_order = on; }
"""
# the launch, as the block's threads run by host_warp
HOST_LAUNCH = (r'minimal6_kernel<<<([^,]*), ([^,]*), [^>]*>>>\(([^;]*)\);',
               r'host_warp::launch(dim3(\1), dim3(\2), [&] { '
               r'minimal6_kernel(\3); });')
# lanes an EPnP problem: the card's build, and one lane
LANES = {'card': None, 'one_lane': 1}


@pytest.fixture(scope='module')
def host_kernels(tmp_path_factory):
    """csrc/minimal6.cu compiled for the host at the card's lane widths and
    at one lane a problem: {name: library}."""
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        pytest.skip('needs a host C++ compiler')
    d = tmp_path_factory.mktemp('minimal6_host')
    with open(osp.join(cuda_build.CSRC, 'minimal6.cu')) as f:
        src = f.read()
    src, n = re.subn(HOST_LAUNCH[0], HOST_LAUNCH[1], src)
    assert n == 1
    (d / 'cuda_runtime.h').write_text(HOST_SHIM)
    (d / 'minimal6.cpp').write_text(src)
    jobs = {}
    for name, lanes in LANES.items():
        defs = [] if lanes is None else [f'-DLC_M6_LANES_EPNP={lanes}']
        lib = d / f'libminimal6_{name}.so'
        # -ffp-contract=off: every multiply and add rounded on its own, as
        # the card build's -fmad=false
        jobs[name] = lib, subprocess.Popen(
            [cxx, '-std=c++17', '-O1', '-ffp-contract=off', '-fPIC', '-shared',
             '-Wno-unknown-pragmas', *defs, f'-I{d}', str(d / 'minimal6.cpp'),
             '-o', str(lib)])
    out = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (lib, proc) in jobs.items():
        assert proc.wait() == 0, name
        out[name] = ctypes.CDLL(str(lib))
        out[name].lc_minimal6.argtypes = [vp] * 5 + [ci] * 4 + [vp]
        out[name].lc_minimal6.restype = ci
        out[name].lc_minimal6_set_basis.argtypes = [vp]
        out[name].lc_minimal6_set_basis.restype = ci
        out[name].lc_host_reverse_lanes.argtypes = [ci]
    return out


@pytest.fixture(scope='module')
def host_kernel(host_kernels):
    return host_kernels['card']


def run_host_kernel(lib, Kc, P3, uv, estimators=tf.ESTIMATORS,
                    reverse_lanes=False):
    codes = mk.estimator_codes(estimators)
    B, Kh = P3.shape[:2]
    pose = np.zeros((B, len(codes) * Kh, 7), np.float32)
    ok = np.zeros((B, len(codes) * Kh), np.uint8)
    args = [np.ascontiguousarray(a, np.float32) for a in (Kc, P3, uv)]
    assert lib.lc_minimal6_set_basis(mk.basis_arg().ctypes.data) == 0
    lib.lc_host_reverse_lanes(int(reverse_lanes))
    try:
        err = lib.lc_minimal6(*(a.ctypes.data for a in args), pose.ctypes.data,
                              ok.ctypes.data, B, Kh, len(codes),
                              sum(c << (2 * i) for i, c in enumerate(codes)),
                              None)
    finally:
        lib.lc_host_reverse_lanes(0)
    assert err == 0
    return pose, ok.astype(bool)


@pytest.mark.parametrize('noise,planar', [(0.0, False), (1.0, False),
                                          (0.0, True), (1.0, True)])
def test_kernel_source_on_host_matches_lc_tpu(host_kernel, noise, planar):
    """csrc/minimal6.cu's solvers, run on the host, give lc_tpu's poses and
    flags bit for bit, each estimator at its place in the output."""
    Kc, P3, uv, _ = samples(noise, planar)
    pose, ok = run_host_kernel(host_kernel, Kc, P3, uv)
    Kh = P3.shape[1]
    for e, name in enumerate(tf.ESTIMATORS):
        pj, okj = lc_tpu_hypotheses(name, Kc, P3, uv)
        np.testing.assert_array_equal(pose[:, e * Kh:(e + 1) * Kh], pj)
        np.testing.assert_array_equal(ok[:, e * Kh:(e + 1) * Kh], okj)


def test_kernel_source_on_host_estimator_subsets(host_kernel):
    Kc, P3, uv, _ = samples(1.0)
    for est in (('dlt',), ('planar', 'epnp')):
        pose, ok = run_host_kernel(host_kernel, Kc, P3, uv, est)
        pp, okp = tf.minimal6(torch.tensor(Kc), torch.tensor(P3),
                              torch.tensor(uv), est)
        assert pose.shape == tuple(pp.shape) and ok.shape == tuple(okp.shape)
        full, _ = run_host_kernel(host_kernel, Kc, P3, uv)
        Kh = P3.shape[1]
        for e, code in enumerate(mk.estimator_codes(est)):
            np.testing.assert_array_equal(
                pose[:, e * Kh:(e + 1) * Kh],
                full[:, code * Kh:(code + 1) * Kh])


@pytest.mark.parametrize('noise,planar', [(1.0, False), (0.0, True)])
def test_kernel_source_lane_widths_agree(host_kernels, noise, planar):
    """The host-run kernel at the card's lanes an EPnP problem and at one
    lane gives the same bits; so does the card's width with its lanes run
    in reverse order (a lane reading what another writes in the same step
    would differ)."""
    assert host_kernels['card'].lc_minimal6_lanes() > 1
    assert host_kernels['one_lane'].lc_minimal6_lanes() == 1
    Kc, P3, uv, _ = samples(noise, planar)
    wide = run_host_kernel(host_kernels['card'], Kc, P3, uv)
    one = run_host_kernel(host_kernels['one_lane'], Kc, P3, uv)
    rev = run_host_kernel(host_kernels['card'], Kc, P3, uv,
                          reverse_lanes=True)
    for other in (one, rev):
        np.testing.assert_array_equal(wide[0], other[0])
        np.testing.assert_array_equal(wide[1], other[1])
