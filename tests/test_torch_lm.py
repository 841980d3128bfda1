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
