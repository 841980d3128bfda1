"""The port's LM refiner (plain version of the CUDA kernel) against lc_tpu's
XLA solver and its Pallas kernel run in interpret mode, on the cases of
tests/test_pallas_lm.py.

Tolerances (those of tests/test_pallas_lm.py): translation atol 0.05 mm,
|q·q'| > 1 − 1e-5, cost rtol 1e-3. The solvers converge to the same optimum;
f32 summation order moves the iterates, not the answer."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu import geom
from lc_tpu.pnp.pallas_lm import pallas_lm_refine
from lc_tpu.pnp.solver import lm_refine as j_lm_refine
from lc_tpu_torch.pnp.lm_kernel import check_inputs
from lc_tpu_torch.pnp.solver import lm_refine, lm_refine_auto

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)


def make_problem(n_pts=100, batch=4, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    Rs = sciR.random(batch, random_state=seed).as_matrix().astype(np.float32)
    ts = np.concatenate((rng.uniform(-50, 50, (batch, 2)),
                         rng.uniform(600, 800, (batch, 1))), -1).astype(np.float32)
    pts3d = rng.uniform(-40, 40, (batch, n_pts, 3)).astype(np.float32)
    Ks = np.ascontiguousarray(np.broadcast_to(K, (batch, 3, 3)))
    pose = np.asarray(geom.RT_to_pose7(jnp.asarray(Rs), jnp.asarray(ts)))
    uv = np.asarray(geom.project_apply(jnp.asarray(Ks), jnp.asarray(pts3d),
                                       jnp.asarray(Rs), jnp.asarray(ts)))
    uv = uv + rng.normal(size=uv.shape).astype(np.float32) * noise
    d = rng.normal(size=(batch, 6)).astype(np.float32) * np.array(
        [0.04, 0.04, 0.04, 8, 8, 15], np.float32)
    start = np.asarray(geom.apply_perturb(jnp.asarray(pose), jnp.asarray(d)))
    w = rng.uniform(0.5, 2.0, (batch, n_pts, 2)).astype(np.float32)
    return pose, start, Ks, pts3d, uv, w


def _agree(a, b, cost=True):
    np.testing.assert_allclose(np.asarray(a.pose7)[:, 4:],
                               np.asarray(b.pose7)[:, 4:], atol=0.05)
    dot = np.abs(np.sum(np.asarray(a.pose7)[:, :4] * np.asarray(b.pose7)[:, :4], -1))
    assert np.all(dot > 1 - 1e-5), dot
    if cost:
        np.testing.assert_allclose(np.asarray(a.cost), np.asarray(b.cost),
                                   rtol=1e-3)
    np.testing.assert_array_equal(np.asarray(a.invalid), np.asarray(b.invalid))


def _port(*arrays, **kw):
    return lm_refine(*(None if a is None else torch.tensor(np.asarray(a))
                       for a in arrays), **kw)


def _jax(fn, *arrays, **kw):
    return fn(*(None if a is None else jnp.asarray(a) for a in arrays), **kw)


@pytest.mark.parametrize('per_coord', [True, False])
def test_matches_xla_solver_and_pallas_kernel(per_coord):
    pose, start, Ks, pts3d, uv, w = make_problem()
    if not per_coord:
        w = w[..., 0]
    port = _port(start, Ks, pts3d, uv, w)
    _agree(port, _jax(j_lm_refine, start, Ks, pts3d, uv, w))
    _agree(port, _jax(pallas_lm_refine, start, Ks, pts3d, uv, w,
                      interpret=True))
    assert not port.invalid.any()
    np.testing.assert_allclose(port.pose7[:, 4:].numpy(), pose[:, 4:], atol=2.5)


@pytest.mark.parametrize('valid_frac', [1.0, 0.6])
def test_float64_inputs_run_in_float64(valid_frac):
    """The f64 referee: f64 inputs keep f64 through the solve and land
    within the kernel tolerance of the f32 run on a well-posed problem."""
    pose, start, Ks, pts3d, uv, w = make_problem()
    valid = np.random.default_rng(2).random(pts3d.shape[:2]) < valid_frac
    f32 = _port(start, Ks, pts3d, uv, w, valid)
    f64 = _port(*(a.astype(np.float64) for a in (start, Ks, pts3d, uv, w)),
                valid)
    assert f64.pose7.dtype == f64.cost.dtype == f64.radius.dtype \
        == torch.float64
    _agree(f64, f32)
    assert not f64.invalid.any()


def test_valid_mask_and_too_few():
    pose, start, Ks, pts3d, uv, w = make_problem(batch=2, n_pts=32)
    valid = np.ones((2, 32), bool)
    valid[0, 16:] = False
    valid[1, 2:] = False  # < 3 points -> invalid, keeps start
    port = _port(start, Ks, pts3d, uv, w, valid)
    _agree(port, _jax(pallas_lm_refine, start, Ks, pts3d, uv, w, valid,
                      interpret=True))
    _agree(port, _jax(j_lm_refine, start, Ks, pts3d, uv, w, valid))
    assert port.invalid.tolist() == [False, True]
    assert int(port.n_iter[1]) == 0
    np.testing.assert_array_equal(port.pose7[1].numpy(), start[1])


def test_padding_with_zero_weight_points():
    pose, start, Ks, pts3d, uv, w = make_problem(batch=2, n_pts=100)
    rng = np.random.default_rng(1)
    pts3d_p = np.concatenate(
        (pts3d, rng.normal(size=(2, 28, 3)).astype(np.float32)), axis=1)
    uv_p = np.concatenate((uv, np.zeros((2, 28, 2), np.float32)), axis=1)
    w_p = np.concatenate((w, np.zeros((2, 28, 2), np.float32)), axis=1)
    full = _port(start, Ks, pts3d, uv, w)
    padded = _port(start, Ks, pts3d_p, uv_p, w_p)
    np.testing.assert_allclose(padded.pose7.numpy(), full.pose7.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize('fallback', [True, False])
def test_budgeted_polish(fallback):
    """max_iter=2 leaves problems running (NO_CONVERGENCE -> invalid): with
    fallback_to_init they keep the start, without it (the LO-RANSAC polish at
    ransac.py:436) they return the last accepted iterate."""
    pose, start, Ks, pts3d, uv, w = make_problem(batch=4, n_pts=64, seed=3)
    ones = np.ones_like(uv)
    port = _port(start, Ks, pts3d, uv, ones, max_iter=2,
                 fallback_to_init=fallback)
    ref = _jax(j_lm_refine, start, Ks, pts3d, uv, ones, max_iter=2,
               fallback_to_init=fallback)
    ref_k = _jax(pallas_lm_refine, start, Ks, pts3d, uv, ones, max_iter=2,
                 fallback_to_init=fallback, interpret=True)
    assert port.invalid.all()
    for other in (ref, ref_k):
        np.testing.assert_array_equal(port.invalid.numpy(),
                                      np.asarray(other.invalid))
        np.testing.assert_array_equal(port.n_iter.numpy(),
                                      np.asarray(other.n_iter))
        np.testing.assert_allclose(port.pose7.numpy(), np.asarray(other.pose7),
                                   atol=1e-3)
    moved = np.abs(port.pose7.numpy() - start).max(-1)
    assert np.all(moved == 0) if fallback else np.all(moved > 0)


def test_auto_takes_the_plain_version_on_cpu():
    pose, start, Ks, pts3d, uv, w = make_problem(batch=2, n_pts=40)
    args = [torch.tensor(a) for a in (start, Ks, pts3d, uv, w)]
    a = lm_refine_auto(*args, max_iter=10, fallback_to_init=False)
    b = lm_refine(*args, max_iter=10, fallback_to_init=False)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_auto_scalar_weights_match_lc_tpu_broadcast():
    """Weights (B, N) on the port's dispatch against lc_tpu's solver with the
    same weights broadcast to (B, N, 2)."""
    pose, start, Ks, pts3d, uv, w = make_problem()
    w1 = np.ascontiguousarray(w[..., 0])
    port = lm_refine_auto(*(torch.from_numpy(a) for a in
                            (start, Ks, pts3d, uv, w1)))
    _agree(port, _jax(j_lm_refine, start, Ks, pts3d, uv,
                      np.broadcast_to(w1[..., None], w.shape)))


def test_auto_valid_none_matches_lc_tpu_all_true():
    pose, start, Ks, pts3d, uv, w = make_problem(batch=2, n_pts=32)
    port = lm_refine_auto(*(torch.from_numpy(a) for a in
                            (start, Ks, pts3d, uv, w)), valid=None)
    _agree(port, _jax(j_lm_refine, start, Ks, pts3d, uv, w,
                      np.ones((2, 32), bool)))


def test_auto_checks_inputs_once(monkeypatch):
    """lm_refine_auto validates once and hands over; lm_refine_cuda, called
    directly, validates once and raises for CPU tensors."""
    from lc_tpu_torch.pnp import lm_kernel
    calls = []
    real = lm_kernel.check_inputs
    monkeypatch.setattr(lm_kernel, 'check_inputs',
                        lambda *a: calls.append(1) or real(*a))
    pose, start, Ks, pts3d, uv, w = make_problem(batch=2, n_pts=16)
    args = [torch.from_numpy(a) for a in (start, Ks, pts3d, uv, w)]
    lm_refine_auto(*args, max_iter=2)
    assert len(calls) == 1
    with pytest.raises(ValueError, match='CUDA'):
        lm_kernel.lm_refine_cuda(*args)
    assert len(calls) == 2


def test_output_views_match_the_kernel_layout():
    """lm_refine.cu writes, into one f32 buffer, the pose of problem b at
    words 7b..7b+6, its cost at 7B + b, radius at 8B + b, n_iter (int32) at
    9B + b and invalid at byte 40B + b."""
    from lc_tpu_torch.pnp.lm_kernel import output_views
    B = 5
    buf = torch.zeros(10 * B + (B + 3) // 4)
    raw = buf.numpy()
    words, octets = raw.view(np.int32), raw.view(np.uint8)
    for b in range(B):
        raw[7 * b:7 * b + 7] = np.arange(7) + 10 * b
        raw[7 * B + b] = 0.5 + b
        raw[8 * B + b] = 100.0 + b
        words[9 * B + b] = b - 2
        octets[40 * B + b] = b % 2
    out = output_views(buf, B)
    assert out.pose7.shape == (B, 7) and out.pose7.is_contiguous()
    np.testing.assert_array_equal(
        out.pose7.numpy(), np.arange(7)[None] + 10 * np.arange(B)[:, None])
    np.testing.assert_array_equal(out.cost.numpy(), 0.5 + np.arange(B))
    np.testing.assert_array_equal(out.radius.numpy(), 100.0 + np.arange(B))
    assert out.n_iter.dtype == torch.int32
    assert out.n_iter.tolist() == [b - 2 for b in range(B)]
    assert out.invalid.dtype == torch.bool
    assert out.invalid.tolist() == [b % 2 == 1 for b in range(B)]
    empty = output_views(torch.empty(0), 0)
    assert empty.pose7.shape == (0, 7) and empty.invalid.shape == (0,)


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'contiguity', 'valid',
                                 'device'])
def test_auto_rejects_what_the_kernel_does_not_take(bad):
    """lm_refine_auto raises on the CPU exactly what the kernel's check
    raises: TypeError for a dtype, ValueError for a shape, a device or
    contiguity."""
    pose, start, Ks, pts3d, uv, w = make_problem(batch=2, n_pts=16)
    args = dict(pose7_init=torch.tensor(start), cam_K=torch.tensor(Ks),
                pts3d=torch.tensor(pts3d), pts2d=torch.tensor(uv),
                weights=torch.tensor(w), valid=None)
    if bad == 'dtype':
        args['weights'] = args['weights'].double()
    elif bad == 'shape':
        args['weights'] = args['weights'][:, :8]
    elif bad == 'contiguity':
        args['pts2d'] = args['pts2d'].transpose(0, 1).contiguous() \
            .transpose(0, 1)
    elif bad == 'valid':
        args['valid'] = torch.ones(2, 16, dtype=torch.uint8)
    else:
        args['cam_K'] = args['cam_K'].to('meta')
    with pytest.raises(TypeError if bad in ('dtype', 'valid') else ValueError,
                       match='lm_refine'):
        lm_refine_auto(**args)


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'contiguity', 'valid'])
def test_kernel_input_checks(bad):
    pose, start, Ks, pts3d, uv, w = make_problem(batch=2, n_pts=16)
    args = dict(pose7_init=torch.from_numpy(start), cam_K=torch.from_numpy(Ks),
                pts3d=torch.from_numpy(pts3d), pts2d=torch.from_numpy(uv),
                weights=torch.from_numpy(w), valid=None)
    check_inputs(**args)
    if bad == 'dtype':
        args['pts3d'] = args['pts3d'].double()
    elif bad == 'shape':
        args['pts2d'] = args['pts2d'][:, :8]
    elif bad == 'contiguity':
        args['pts3d'] = args['pts3d'].transpose(0, 1).contiguous().transpose(0, 1)
    else:
        args['valid'] = torch.ones(2, 16)
    with pytest.raises((TypeError, ValueError)):
        check_inputs(**args)
