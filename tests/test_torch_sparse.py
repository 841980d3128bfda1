"""The sparse-keypoint family through the port against lc_tpu: the softargmax
head, the sparse PtNet, solve_pnp_sparse, the in-memory harness and
`python -m lc_tpu_torch.test` on a gspsyn-shaped tree with its FPS pickle.

Sizes: 64² in, 16² out, 16 keypoints (the first 16 of
box_surface_points(half_extents, 16), as configs/gspsyn.yaml's recipe).
Tolerances: softargmax atol 1e-5 px; the forward, both packages in f32 on
the same weights, rtol 1e-4 with atol 1e-4 of each output's scale; the
weighted LM translation 0.05 mm, |q·q'| ≥ 1 − 1e-5. lc_tpu's whole
LO-RANSAC compiles for ~45 s on XLA:CPU, its hypothesis stage for ~16 s:
the port's RANSAC runs on lc_tpu's own sample indices (injected), and its
LO-RANSAC pose is held to lc_tpu's winning hypothesis polished by lc_tpu's
LM (the minimum LO converges to), the weighted LM after it to lc_tpu's."""
import os.path as osp
import pickle
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from lc_tpu import geom
from lc_tpu.models import build_model as j_build_model
from lc_tpu.models import layers as jlayers
from lc_tpu.models.ptnet import softargmax_2d_std as j_softargmax
from lc_tpu.pnp.ransac import ransac_pnp as j_ransac_pnp
from lc_tpu.pnp.solver import lm_refine as j_lm_refine
from lc_tpu_torch import harness
from lc_tpu_torch import inference as tinf
from lc_tpu_torch.data import synthetic
from lc_tpu_torch.data.pipeline import BOPDataset, collate
from lc_tpu_torch.eval.evaluator import Evaluator
from lc_tpu_torch.models import build_model
from lc_tpu_torch.models.ptnet import keypoints_from_logits
from lc_tpu_torch.models.ptnet import softargmax_2d_std as t_softargmax
from lc_tpu_torch.models.weights import random_flax_variables, state_dict_from_flax
from lc_tpu_torch.utils.config import Config
from test_torch_ransac import lc_tpu_sample_idx
from test_torch_zebra import quat_cos

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
IN_WH, OUT_WH = (64, 64), (16, 16)
N_KPT = 16


def test_softargmax_matches():
    logits = np.random.default_rng(0).normal(0, 2, (3, N_KPT, 12, 16)) \
        .astype(np.float32)
    prob = np.array(jax.nn.softmax(
        jnp.asarray(logits).reshape(3, N_KPT, -1), -1)).reshape(logits.shape)
    jm, js = j_softargmax(jnp.asarray(prob))
    tm, ts = t_softargmax(torch.from_numpy(prob))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    km, ks = keypoints_from_logits(torch.from_numpy(logits))
    np.testing.assert_allclose(km.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(ks.numpy(), np.asarray(js), atol=1e-5)


@pytest.fixture
def f32_reference():
    jlayers.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jlayers.set_compute_dtype(jnp.bfloat16)


def _sparse_model(seed=1):
    variables = random_flax_variables(seed=seed, sparse_cnt=N_KPT)
    model = build_model('cdpn_resnet', {'concat': False}, sparse_cnt=N_KPT)
    model.load_state_dict(state_dict_from_flax(variables, sparse_cnt=N_KPT))
    return model.eval(), variables


def test_sparse_forward_matches(f32_reference):
    x = np.random.default_rng(1).normal(size=(2,) + IN_WH + (3,)) \
        .astype(np.float32)
    model, variables = _sparse_model()
    assert not hasattr(model, 'weight_scale_layer')
    jmodel = j_build_model('cdpn_resnet', {'concat': False}, sparse_cnt=N_KPT)
    tmpl = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + IN_WH + (3,))))
    assert jax.tree.map(lambda a: a.shape, tmpl) == \
        jax.tree.map(np.shape, variables)
    j_out = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        t_out = model(torch.from_numpy(x))
    assert set(t_out) == set(j_out) == {'pts2d', 'pts2d_std'}
    for k, v in j_out.items():
        v = np.asarray(v)
        assert t_out[k].shape == v.shape == (2, N_KPT, 2), k
        np.testing.assert_allclose(t_out[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


@pytest.fixture(scope='module')
def eval_set():
    return synthetic.render_eval_set(4, seed=8, net_input_wh=IN_WH,
                                     net_output_wh=OUT_WH, sparse_cnt=N_KPT)


def test_solve_pnp_sparse_matches(eval_set):
    """Noisy oracle keypoint heatmaps: the port's LO-RANSAC on lc_tpu's
    sample indices, then the weighted LM. Every keypoint lies within the
    2 px threshold, so LO-RANSAC's polishes converge to the unit-weight
    least squares over all 16: its pose is held to lc_tpu's winning
    hypothesis on the same draw, polished by lc_tpu's LM with unit weights.
    The weighted LM is held to lc_tpu's from the port's RANSAC pose with
    lc_tpu's 1/std² weights."""
    batch = collate(eval_set['blobs'])
    logits = synthetic.oracle_outputs(eval_set, eval_set['blobs'], OUT_WH,
                                      sparse=True)['kpt_logits']
    logits += np.random.default_rng(3).normal(0, 0.3, logits.shape) \
        .astype(np.float32)
    with torch.no_grad():
        pts2d, std = keypoints_from_logits(
            torch.from_numpy(logits).permute(0, 3, 1, 2))
    out = {'pts2d': pts2d, 'pts2d_std': std}
    gt = {'out_K': torch.from_numpy(batch['out_K']),
          'pts3d': torch.from_numpy(batch['pts3d'])}
    B = len(logits)
    key = jax.random.PRNGKey(0)
    idx = lc_tpu_sample_idx(key, np.ones((B, N_KPT), bool))
    states = tinf.solve_pnp_sparse(out, gt, device='cpu',
                                   sample_idx=torch.tensor(idx))
    assert set(states) == {'ransac', 'weighted'}
    j_args = (jnp.asarray(batch['out_K']), jnp.asarray(batch['pts3d']),
              jnp.asarray(pts2d.numpy()))
    hyp = jax.jit(lambda k, *a: j_ransac_pnp(
        *a, k, reproj_threshold=2.0, local_opt=False))(key, *j_args)
    assert np.asarray(hyp.inliers).all()
    lm = jax.jit(j_lm_refine)
    polished = np.asarray(lm(hyp.pose7, *j_args,
                             jnp.ones((B, N_KPT, 2))).pose7)
    got = states['ransac'].numpy()
    np.testing.assert_allclose(got[:, 4:], polished[:, 4:], atol=0.05)
    assert np.all(quat_cos(got, polished) >= 1 - 1e-5)
    ref = np.asarray(lm(jnp.asarray(got), *j_args,
                        1.0 / jnp.asarray(std.numpy()) ** 2).pose7)
    got = states['weighted'].numpy()
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], atol=0.05)
    assert np.all(quat_cos(got, ref) >= 1 - 1e-5)
    for i, (Rg, tg) in enumerate(eval_set['poses']):
        Rp, tp = geom.pose7_to_RT(jnp.asarray(got[i]))
        dist = np.linalg.norm(eval_set['models'][1] @ (np.asarray(Rp) - Rg).T
                              + (np.asarray(tp) - tg), axis=-1)
        assert dist.mean() < 0.1 * eval_set['models_info'][1]['diameter']


def _gspsyn_cfg(**test_dataset):
    cfg = Config(yaml.safe_load(open(osp.join(ROOT, 'configs',
                                              'gspsyn.yaml'))))
    cfg.merge_from_dict({'net_input_wh': list(IN_WH),
                         'net_output_wh': list(OUT_WH),
                         'dataloader.batch_size': 2,
                         'dataloader.num_workers': 1})
    cfg.merge_from_dict({f'test_dataset.{k}': v
                         for k, v in test_dataset.items()})
    return cfg


def test_run_test_in_memory(eval_set):
    """harness.run_test takes the sparse branch (sparse_cnt > 3): one pose
    per crop for each of gspsyn's solvers."""
    blobs = eval_set['blobs']
    loader = [collate(blobs[:2]), collate(blobs[2:])]
    dataset = types.SimpleNamespace(net_input_wh=IN_WH, bit_cnt=None)
    ev = Evaluator(eval_set['gts'], eval_set['models'],
                   eval_set['models_info'], 'synthetic')
    out = harness.run_test(_gspsyn_cfg(), _sparse_model()[0], loader, dataset,
                           ev, device='cpu')
    assert set(out) == {'ransac', 'weighted'}
    for res in out.values():
        assert len(res['errors']) == 4
        assert all(np.all(np.isfinite(e['t_est'])) for e in res['errors'])


def _gspsyn_tree(tmp_path):
    root = str(tmp_path / 'data')
    synthetic.generate_dataset(root, n_images=4, split='test_syn', seed=5,
                               list_name='test_list.txt')
    pts = synthetic.box_surface_points(np.array([40.0, 30.0, 20.0]), 16)
    fps = osp.join(root, 'fps.pkl')
    with open(fps, 'wb') as f:
        pickle.dump({1: pts.astype(np.float32)}, f)
    return root, fps, pts


def test_dataset_keypoints_from_fps(tmp_path):
    root, fps, pts = _gspsyn_tree(tmp_path)
    cfg = _gspsyn_cfg(dataset_root=root,
                      list_files=[osp.join(root, 'test_list.txt')])
    cfg.fps = fps
    cfg.obj_ids = [1]
    ds = BOPDataset(cfg.test_dataset, cfg, train=False)
    blob = ds.sample(0)
    np.testing.assert_array_equal(blob['pts3d'], pts[:N_KPT])
    assert ds.bit_cnt is None


def test_cli_on_gspsyn_tree(tmp_path):
    """python -m lc_tpu_torch.test --device cpu on a generated tree with its
    FPS pickle: exits 0 with the score tables and CSVs of both solvers."""
    root, fps, _ = _gspsyn_tree(tmp_path)
    cfg = _gspsyn_cfg(dataset_root=root,
                      list_files=[osp.join(root, 'test_list.txt')])
    cfg.fps = fps
    cfg_path = tmp_path / 'gspsyn_tiny.yaml'
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    weight = tmp_path / 'sparse.pth'
    torch.save(_sparse_model(seed=0)[0].state_dict(), weight)
    out_dir = tmp_path / 'out'
    subprocess.run([sys.executable, '-m', 'lc_tpu_torch.test', '--weight',
                    str(weight), '--config', str(cfg_path), '--output',
                    str(out_dir), '--obj', '1', '--deterministic',
                    '--device', 'cpu'], check=True, cwd=ROOT, timeout=120)
    for solver in ('ransac', 'weighted'):
        csv = out_dir / f'gspsyn_tiny-{solver}_synthetic_test_1.csv'
        assert len(csv.read_text().splitlines()) == 4
    log = (out_dir / 'gspsyn_tiny_synthetic_test_1.log').read_text()
    assert 'add(-s)_0.10' in log
