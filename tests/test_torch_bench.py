"""bench_torch.py, the port's benchmark CLI, against bench.py: the same
scene from the same draws, FLOP counts beside XLA's, every mode of
bench.py accepted, and a few modes run end to end on the CPU.

Tolerances, each with its reason:
  * frames, crop affines, K and noc_scale: bit-equal (the same numpy draws,
    the same float32 affine arithmetic);
  * the pose-consistent NOC field: rtol 1e-5 (its backprojection runs in
    float32 through torch's and XLA's matrix inverse and products, values
    up to ~1);
  * FLOPs of one CDPN forward at 64², batch 1: torch.utils.flop_counter
    counts every tap of a padded convolution (2 x multiply-adds: 1.401
    GFLOP, equal to the layer-by-layer sum); XLA's cost analysis counts
    1.224 GFLOP, 14.5% less, the share a padded window spends outside
    small feature maps (3.2% at 256²). The count must lie between XLA's
    and 1.16x it.
"""
import ast
import json
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import bench_torch  # noqa: E402


@pytest.mark.parametrize('out_c', [32.0, 64.0])
def test_scene_matches_bench_py(monkeypatch, out_c):
    monkeypatch.setattr(bench, 'BATCH', 4)
    frames, affines, K, gt = bench._bench_scene(out_c)
    mine = bench_torch.scene_arrays(4, out_c)
    np.testing.assert_array_equal(mine['frames'], np.asarray(frames))
    np.testing.assert_array_equal(mine['affines'], np.asarray(affines))
    np.testing.assert_array_equal(mine['K'], np.asarray(K))
    np.testing.assert_array_equal(mine['noc_scale'],
                                  np.asarray(gt['noc_scale']))


def test_pose_field_matches_bench_py():
    """bench.py's pose-consistent field (_build_inference's numpy code,
    through lc_tpu's geometry) against the port's."""
    from scipy.spatial.transform import Rotation as sciR
    from lc_tpu import geom
    batch = 4
    K = bench_torch.scene_arrays(batch, 32.0)['K']
    rng = np.random.default_rng(0)
    Rs = sciR.random(batch, random_state=1).as_matrix().astype(np.float32)
    ts = np.concatenate((rng.uniform(-5, 5, (batch, 2)),
                         rng.uniform(400, 600, (batch, 1))), -1
                        ).astype(np.float32)
    uvg = np.asarray(geom.gen_uv((64, 64))).reshape(-1, 2)
    z = rng.uniform(380, 620, (batch, 64 * 64, 1)).astype(np.float32)
    homo = np.concatenate((np.broadcast_to(uvg, (batch, 64 * 64, 2)) * z, z),
                          -1)
    xyz = np.asarray(geom.xyz_from_homo_z(
        jnp.asarray(homo), jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(K)))
    want = (xyz / 100.0).reshape(batch, 64, 64, 3)
    got = bench_torch.pose_field(K)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_synthetic_gt_blob_matches_graft_entry():
    from __graft_entry__ import _synthetic_gt_blob
    want = _synthetic_gt_blob(3, out_res=8, in_res=16)
    got = bench_torch.synthetic_gt_blob(3, out_res=8, in_res=16)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_forward_flops_beside_xla():
    from lc_tpu.models import build_model as j_build_model
    from lc_tpu_torch.models import build_model
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    jm = j_build_model('cdpn_resnet', {'concat': False})
    variables = jm.init(jax.random.PRNGKey(0), img, train=False)
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=False)['xyz_noc'])
    cost = fwd.lower(variables, img).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    xla = float(cost['flops'])
    model = build_model('cdpn_resnet', {'concat': False}).eval()
    with torch.no_grad():
        mine = bench_torch.flops_of(model, torch.zeros(1, 64, 64, 3))
    assert xla <= mine <= 1.16 * xla, (mine, xla)


def _bench_py_modes() -> list:
    tree = ast.parse((ROOT / 'bench.py').read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == 'choices':
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError('bench.py has no --mode choices')


def test_every_bench_py_mode_is_ported():
    modes = _bench_py_modes()
    assert len(modes) == len(bench_torch.MODES) == 24
    assert set(modes) == set(bench_torch.MODES)


@pytest.mark.parametrize('mode', ['headline', 'sparse', 'train'])
def test_mode_prints_one_line_on_cpu(monkeypatch, capsys, mode):
    monkeypatch.setattr(bench_torch, 'WARMUP', 0)
    monkeypatch.setattr(bench_torch, 'ITERS', 1)
    monkeypatch.setattr(bench_torch, 'TRIALS', 1)
    bench_torch.main(['--mode', mode, '--device', 'cpu', '--batch', '2'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {'metric', 'value', 'unit', 'vs_baseline'}
    assert np.isfinite(out['value']) and out['value'] > 0


def test_chained_rate_counts_batches_and_chains():
    run = bench_torch.Run(torch.device('cpu'), warmup=2, iters=3, trials=2)
    seen = []

    def step(x):
        seen.append(x)
        return x + 1
    assert bench_torch.chained_rate(step, 0, run, 'inference') >= 0
    assert seen == list(range(8))
    assert run.batches == {'inference': 8}


def test_mfu_is_null_off_a_listed_card():
    assert bench_torch.peak_ops(torch.device('cpu'), 'bf16') is None
    assert bench_torch.utilization(1e12, 1.0, None) is None


def test_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; this checks the refusal path')
    with pytest.raises(RuntimeError, match='CUDA'):
        bench_torch.main(['--mode', 'headline'])
    assert capsys.readouterr().out == ''
