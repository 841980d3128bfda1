"""The port's RANSAC initializer and its estimators against lc_tpu's generic
(off-TPU) branch, on the same samples: lc_tpu's Gumbel indices are
recomputed in JAX (ransac.py:265-273) and injected through `sample_idx`.

The small solves use torch.linalg Cholesky, lc_tpu's fixed-sweep Jacobi and
its inverse subspace iteration (ops/smallmat.py). On well-conditioned inputs
(noise-free minimal samples, the 64-point refits) the estimators agree to
f32 rounding: translation within 0.05 mm, |q·q'| > 1 − 1e-5. Minimal-sample
DLT normal matrices are ill-conditioned in f32 (κ(AᵀA) ~ κ(A)²), so
their hypotheses are compared by quantiles instead."""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu import geom
from lc_tpu_torch.pnp import epnp as tepnp
from lc_tpu_torch.pnp import ransac as tr

jepnp = importlib.import_module('lc_tpu.pnp.epnp')
jr = importlib.import_module('lc_tpu.pnp.ransac')

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)


def make_problem(batch=2, n_pts=64, seed=3, noise=0.0, n_out=0):
    rng = np.random.default_rng(seed)
    Rs = sciR.random(batch, random_state=seed).as_matrix().astype(np.float32)
    ts = np.concatenate((rng.uniform(-50, 50, (batch, 2)),
                         rng.uniform(600, 800, (batch, 1))), -1).astype(np.float32)
    pts3d = rng.uniform(-40, 40, (batch, n_pts, 3)).astype(np.float32)
    Ks = np.ascontiguousarray(np.broadcast_to(K, (batch, 3, 3)))
    uv = np.asarray(geom.project_apply(jnp.asarray(Ks), jnp.asarray(pts3d),
                                       jnp.asarray(Rs), jnp.asarray(ts)))
    uv = uv + rng.normal(size=uv.shape).astype(np.float32) * noise
    if n_out:
        out = rng.choice(n_pts, n_out, replace=False)
        uv[:, out] = rng.uniform(0, 640, (batch, n_out, 2)).astype(np.float32)
    pose = np.asarray(geom.RT_to_pose7(jnp.asarray(Rs), jnp.asarray(ts)))
    return pose, Ks, pts3d, np.ascontiguousarray(uv)


def lc_tpu_sample_idx(key, valid, num_hypotheses=150, sample_size=6):
    """lc_tpu's Gumbel top-k draw (ransac.py:265-273)."""
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


HYP = [('epnp', jepnp.epnp, tepnp.epnp,
        dict(gn_iters=4, eig_iters=3, cp_sweeps=4)),
       ('planar', jr.planar_pnp, tr.planar_pnp, dict(pca_sweeps=4)),
       ('dlt', jr.dlt_pnp, tr.dlt_pnp, {})]


@pytest.mark.parametrize('name,jfn,tfn,kw', HYP, ids=[h[0] for h in HYP])
def test_hypotheses_match_on_injected_samples(name, jfn, tfn, kw):
    pose, Ks, pts3d, uv = make_problem()
    idx = lc_tpu_sample_idx(jax.random.PRNGKey(0), np.ones(pts3d.shape[:2], bool))
    sub3 = np.take_along_axis(pts3d[:, None], idx[..., None], 2)
    sub2 = np.take_along_axis(uv[:, None], idx[..., None], 2)
    pj, okj = jax.jit(lambda a, b, c: jfn(a, b, c, **kw))(
        jnp.asarray(Ks)[:, None], jnp.asarray(sub3), jnp.asarray(sub2))
    pt, okt = tfn(torch.tensor(Ks)[:, None], torch.tensor(sub3),
                  torch.tensor(sub2), **kw)
    okj, okt = np.asarray(okj), okt.numpy()
    assert (okj == okt).mean() >= 0.99
    dt, dq = _pose_diff(np.asarray(pj), pt.numpy())
    both = okj & okt
    if name == 'dlt':   # ill-conditioned 11x11 normal equations in f32
        assert np.median(dt[both]) < 0.1 and np.quantile(dt[both], 0.9) < 1.0
        assert np.quantile(dq[both], 0.1) > 1 - 1e-4
    else:
        assert np.quantile(dt[both], 0.99) < 0.05, np.quantile(dt[both], 0.99)
        assert np.quantile(dq[both], 0.01) > 1 - 1e-5


def test_recovers_pose_with_outliers():
    """tests/test_pnp.py:111's case and bounds, sampled from torch's RNG."""
    pose, Ks, pts3d, uv = make_problem(batch=4, n_pts=128, seed=3, n_out=50)
    gen = torch.Generator().manual_seed(0)
    res = tr.ransac_pnp(torch.tensor(Ks), torch.tensor(pts3d), torch.tensor(uv),
                        gen, reproj_threshold=3.0)
    assert not res.invalid.any()
    assert np.all(res.n_inliers.numpy() >= 70)
    np.testing.assert_allclose(res.pose7[:, 4:].numpy(), pose[:, 4:], atol=2.0)
    dot = np.abs(np.sum(res.pose7[:, :4].numpy() * pose[:, :4], -1))
    assert np.all(dot > 0.9999)


def test_sample_draw_is_distinct_and_valid():
    valid = torch.rand(3, 40, generator=torch.Generator().manual_seed(1)) < 0.5
    idx = tr.draw_samples(valid, 50, 6, torch.Generator().manual_seed(2))
    assert idx.shape == (3, 50, 6)
    assert torch.gather(valid[:, None].expand(3, 50, 40), 2, idx).all()
    assert all(len(set(row.tolist())) == 6 for row in idx.reshape(-1, 6))


@pytest.mark.slow  # lc_tpu's ransac_pnp compiles ~40 s on XLA:CPU
def test_final_pose_matches_with_injected_indices():
    pose, Ks, pts3d, uv = make_problem(noise=1.0, n_out=20)
    key = jax.random.PRNGKey(0)
    idx = lc_tpu_sample_idx(key, np.ones(pts3d.shape[:2], bool))
    rj = jax.jit(lambda a, b, c: jr.ransac_pnp(a, b, c, key))(
        jnp.asarray(Ks), jnp.asarray(pts3d), jnp.asarray(uv))
    rt = tr.ransac_pnp(torch.tensor(Ks), torch.tensor(pts3d), torch.tensor(uv),
                       sample_idx=torch.tensor(idx))
    dt, dq = _pose_diff(np.asarray(rj.pose7), rt.pose7.numpy())
    assert np.all(dt < 0.05) and np.all(dq > 1 - 1e-5), (dt, dq)
    np.testing.assert_array_equal(np.asarray(rj.inliers), rt.inliers.numpy())


def _psd_batch(seed, batch=16, n=12):
    """Random PSD (batch, n, n) matrices: four small eigenvalues (0.05-0.4,
    each a factor 2 from the next) below a spectrum of 5-10, a gap that
    f32 resolves (the contract of lc_tpu's TestSmallEigh)."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(batch, n, n)))[0]
    lam = np.concatenate((np.array([0.05, 0.1, 0.2, 0.4])
                          * rng.uniform(0.9, 1.1, (batch, 4)),
                          rng.uniform(5.0, 10.0, (batch, n - 4))), -1)
    return ((Q * lam[:, None, :]) @ Q.transpose(0, 2, 1)).astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_smallest_eigvecs_matches_lc_tpu(seed, monkeypatch):
    """The port's subspace iteration + Jacobi Rayleigh-Ritz against
    lc_tpu's on random PSD 12x12 inputs: eigenvalues within 1e-5
    (absolute; f32 rounding at a spectrum of 10), each eigenvector within
    1e-4 of lc_tpu's up to its sign (|v·v'| > 1 - 1e-4). torch.linalg.eigh
    is not reached (monkeypatched to raise)."""
    from lc_tpu.ops import smallmat as jsm
    from lc_tpu_torch.ops import smallmat as tsm

    def no_eigh(*a, **k):
        raise AssertionError('torch.linalg.eigh reached')
    monkeypatch.setattr(torch.linalg, 'eigh', no_eigh)
    A = _psd_batch(seed)
    jv, jl = (np.asarray(x) for x in jsm.smallest_eigvecs(jnp.asarray(A), 4))
    tv, tl = (x.numpy() for x in tsm.smallest_eigvecs(torch.from_numpy(A), 4))
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    dots = np.abs(np.sum(tv * jv, axis=-2))
    assert dots.min() > 1 - 1e-4, dots.min()


def test_jacobi_eigh_matches_lc_tpu_and_keeps_nan():
    """jacobi_eigh_small (plane rotations as batched products) against
    lc_tpu's element-wise form on random symmetric 3x3 and 4x4 inputs:
    the same rotation order, so eigenvectors agree with their signs
    (atol 1e-5); a non-finite input stays non-finite."""
    from lc_tpu.ops import smallmat as jsm
    from lc_tpu_torch.ops import smallmat as tsm
    rng = np.random.default_rng(5)
    for n in (3, 4):
        M = rng.normal(size=(32, n, n)).astype(np.float32)
        A = M + M.transpose(0, 2, 1)
        jl, jv = (np.asarray(x) for x in jsm.jacobi_eigh_small(jnp.asarray(A)))
        tl, tv = (x.numpy() for x in tsm.jacobi_eigh_small(torch.from_numpy(A)))
        np.testing.assert_allclose(tl, jl, atol=1e-5)
        np.testing.assert_allclose(tv, jv, atol=1e-5)
    A[0, 1, 2] = A[0, 2, 1] = np.nan
    tl, tv = tsm.jacobi_eigh_small(torch.from_numpy(A))
    assert not torch.isfinite(tv[0]).all() and torch.isfinite(tv[1:]).all()
