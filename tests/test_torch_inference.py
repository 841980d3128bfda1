"""lc_tpu_torch.inference against lc_tpu.inference.

quantile_mask_bisect must give lc_tpu's mask bit for bit (ties and wide
dynamic range included); dense_grid_outputs agrees to f32 rounding (softmax
and products, rtol 1e-6); solve_pnp_dense recovers the pose of exact
correspondences (translation atol 3 mm, |q·q'| > 0.999, as
tests/test_inference.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu import geom, inference as jinf
from lc_tpu_torch import inference as tinf

K = np.array([[500.0, 0, 32.0], [0, 500.0, 32.0], [0, 0, 1]], np.float32)


def synth_dense_out(batch=2, h=16, w=16, seed=0, noise=0.0, scale=100.0):
    """tests/test_inference.py's perfect dense prediction, as numpy."""
    rng = np.random.default_rng(seed)
    Rs = sciR.random(batch, random_state=seed).as_matrix().astype(np.float32)
    ts = np.concatenate((rng.uniform(-5, 5, (batch, 2)),
                         rng.uniform(400, 600, (batch, 1))), -1).astype(np.float32)
    uv = np.asarray(geom.gen_uv((h, w))).reshape(-1, 2)
    z = rng.uniform(380.0, 620.0, (batch, h * w, 1)).astype(np.float32)
    homo = np.concatenate((np.broadcast_to(uv, (batch, h * w, 2)) * z, z), -1)
    Ks = np.ascontiguousarray(np.broadcast_to(K, (batch, 3, 3)))
    xyz = np.asarray(geom.xyz_from_homo_z(
        jnp.asarray(homo), jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(Ks)))
    xyz = xyz + rng.normal(size=xyz.shape).astype(np.float32) * noise
    out = {
        'xyz_noc': (xyz / scale).reshape(batch, h, w, 3).astype(np.float32),
        'xyz_weight_logits': rng.normal(size=(batch, h, w, 2)).astype(np.float32),
        'xyz_weights_scale': np.full((batch, 1, 1, 1), float(2 * h * w), np.float32),
        'msk_vis_logits': np.full((batch, h, w, 1), 5.0, np.float32),
    }
    gt = {'out_K': Ks, 'noc_scale': np.full((batch, 3), scale, np.float32)}
    pose = np.asarray(geom.RT_to_pose7(jnp.asarray(Rs), jnp.asarray(ts)))
    return out, gt, pose


def _masks(w2, q):
    a = np.asarray(jinf.quantile_mask_bisect(jnp.asarray(w2), jnp.asarray(q)))
    b = tinf.quantile_mask_bisect(torch.tensor(w2), torch.tensor(q)).numpy()
    return a, b


@pytest.mark.parametrize('q', [0.0, 0.3, 0.5, 0.73, 1.0])
def test_quantile_mask_uniform(q):
    w2 = np.random.default_rng(9).uniform(0, 5, (6, 257, 2)).astype(np.float32)
    np.testing.assert_array_equal(*_masks(w2, np.float32(q)))


def test_quantile_mask_signed_values():
    w2 = np.random.default_rng(10).normal(size=(4, 128, 2)).astype(np.float32)
    np.testing.assert_array_equal(*_masks(w2, np.float32(0.3)))


@pytest.mark.parametrize('q', [0.1, 0.3, 0.7])
def test_quantile_mask_wide_dynamic_range(q):
    rng = np.random.default_rng(12)
    w2 = np.exp(rng.normal(0, 10, (4, 512, 2))).astype(np.float32)
    a, b = _masks(w2, np.float32(q))
    np.testing.assert_array_equal(a, b)
    assert np.all(b.mean(-1) >= (1 - q) - 0.01)


def test_quantile_mask_ties_and_per_sample_q():
    rng = np.random.default_rng(11)
    w2 = rng.integers(0, 4, (5, 64, 2)).astype(np.float32)
    q = rng.uniform(0.1, 0.9, (5,)).astype(np.float32)
    np.testing.assert_array_equal(*_masks(w2, q))


def test_dense_grid_outputs_match():
    out, gt, _ = synth_dense_out(noise=0.1)
    j = jinf.dense_grid_outputs({k: jnp.asarray(v) for k, v in out.items()},
                                {k: jnp.asarray(v) for k, v in gt.items()},
                                bit_cnt=None, black_background=False, sample=2)
    t = tinf.dense_grid_outputs({k: torch.tensor(v) for k, v in out.items()},
                                {k: torch.tensor(v) for k, v in gt.items()},
                                sample=2)
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize('select', ['quantile', 'mask', 'quantile_in_mask'])
def test_solve_pnp_dense_recovers_pose(select):
    out, gt, pose = synth_dense_out(noise=0.05)
    states = tinf.solve_pnp_dense(
        {k: torch.tensor(v) for k, v in out.items()},
        {k: torch.tensor(v) for k, v in gt.items()},
        torch.Generator().manual_seed(0), sample=2, point_select=select,
        solvers=('ransac', 'weighted', 'weighted_filtered'), device='cpu')
    for name, p in states.items():
        p = p.numpy()
        np.testing.assert_allclose(p[:, 4:], pose[:, 4:], atol=3.0)
        dot = np.abs(np.sum(p[:, :4] * pose[:, :4], -1))
        assert np.all(dot > 0.999), name


@pytest.mark.slow  # ~100 s: lc_tpu's solve-chain compile on XLA:CPU
def test_solve_pnp_dense_matches_lc_tpu():
    """With good correspondences both converge to the same weighted-LM
    optimum whatever the RANSAC draw: translation within 0.05 mm."""
    out, gt, pose = synth_dense_out(noise=0.5)
    j = jinf.solve_pnp_dense({k: jnp.asarray(v) for k, v in out.items()},
                             {k: jnp.asarray(v) for k, v in gt.items()},
                             jax.random.PRNGKey(0), solvers=('weighted',))
    t = tinf.solve_pnp_dense({k: torch.tensor(v) for k, v in out.items()},
                             {k: torch.tensor(v) for k, v in gt.items()},
                             torch.Generator().manual_seed(0), device='cpu')
    pj, pt = np.asarray(j['weighted']), t['weighted'].numpy()
    np.testing.assert_allclose(pt[:, 4:], pj[:, 4:], atol=0.05)
    assert np.all(np.abs(np.sum(pt[:, :4] * pj[:, :4], -1)) > 1 - 1e-5)
