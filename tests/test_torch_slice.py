"""The port's eval slice end to end on the CPU: the eval crop against
lc_tpu's, the oracle solve, run_test on in-memory batches and the test CLI on
a synthetic BOP tree."""
import os.path as osp
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from lc_tpu.data.crop import batched_separable_warp as j_warp
from lc_tpu.data.pipeline import device_preprocess as j_preprocess
from lc_tpu_torch import harness, inference
from lc_tpu_torch.data import synthetic
from lc_tpu_torch.data.crop import batched_separable_warp as t_warp
from lc_tpu_torch.data.pipeline import collate, device_preprocess
from lc_tpu_torch.eval.evaluator import Evaluator
from lc_tpu_torch.geom.pose import pose7_to_RT
from lc_tpu_torch.models import build_model
from lc_tpu_torch.models.weights import random_flax_variables, state_dict_from_flax
from lc_tpu_torch.utils.config import Config

IN_WH, OUT_WH = (64, 64), (16, 16)


@pytest.fixture(scope='module')
def eval_set():
    return synthetic.render_eval_set(4, seed=0,
                                     net_input_wh=IN_WH, net_output_wh=OUT_WH)


@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
def test_separable_warp_f32(eval_set, method):
    """f32 crops agree to f32 rounding (rtol 1e-5 of 8-bit-range values)."""
    batch = collate(eval_set['blobs'])
    img = batch['rgb_full'].astype(np.float32)
    a = np.asarray(j_warp(jnp.asarray(img), jnp.asarray(batch['in_affine']),
                          (64, 64), method))
    b = t_warp(torch.tensor(img), torch.tensor(batch['in_affine']), (64, 64),
               method).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-3)


def test_eval_preprocess_matches(eval_set):
    """Eval-mode device_preprocess: same keys, same crop. The RGB crop runs in
    bf16 on both sides (8-bit RGB); bf16 rounds at 1 intensity level near
    255, so img_in agrees within 3 levels (atol 0.05 after normalization)."""
    batch = collate(eval_set['blobs'])
    j = j_preprocess({k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.PRNGKey(0), net_input_wh=IN_WH,
                     net_output_wh=OUT_WH, train=False)
    t = device_preprocess({k: torch.as_tensor(v) for k, v in batch.items()},
                          net_input_wh=IN_WH)
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   atol=0.05 if k == 'img_in' else 0, err_msg=k)
    assert np.abs(t['img_in'].numpy() - np.asarray(j['img_in'])).mean() < 0.005


def _oracle_out(eval_set):
    return {k: torch.tensor(v) for k, v in synthetic.oracle_outputs(
        eval_set, eval_set['blobs'], OUT_WH).items()}


def test_oracle_network_output_recovers_poses(eval_set):
    """The GT NOC map as network output: ADD well under 1% of the diameter."""
    batch = collate(eval_set['blobs'])
    gt = device_preprocess({k: torch.as_tensor(v) for k, v in batch.items()},
                           net_input_wh=IN_WH)
    poses = inference.solve_pnp_dense(_oracle_out(eval_set), gt,
                                      torch.Generator().manual_seed(0),
                                      device='cpu')['weighted']
    R, t = pose7_to_RT(poses)
    ev = Evaluator(eval_set['gts'], eval_set['models'], eval_set['models_info'])
    res = [dict(scene_id=1, im_id=i, obj_id=1, R_est=R[i].numpy(),
                t_est=t[i].numpy()) for i in range(len(R))]
    per_obj, errors = ev.evaluate(res)
    diameter = eval_set['models_info'][1]['diameter']
    assert max(e['add'] for e in errors) < 0.01 * diameter
    assert per_obj[1]['add(-s)_0.10'] == 1.0


def _tiny_cfg(**test_dataset):
    return Config(dict(
        obj_ids=[1], cache_dir='', net_input_wh=list(IN_WH),
        net_output_wh=list(OUT_WH),
        dataloader=dict(batch_size=2, num_workers=1),
        pnp_solver=dict(dense_point_select='quantile', quantile=0.3,
                        solvers=['weighted', 'ransac']),
        train_dataset=dict(name='synthetic'),
        test_dataset=dict(name='synthetic', visib_frac=0.0, dzi_pad_scale=1.5,
                          **test_dataset),
        model=dict(net_name='cdpn_resnet', net_config=dict(concat=False))))


def _model():
    model = build_model('cdpn_resnet')
    model.load_state_dict(state_dict_from_flax(random_flax_variables(seed=0)))
    return model


def test_run_test_in_memory(eval_set):
    cfg = _tiny_cfg()
    blobs = eval_set['blobs']
    loader = [collate(blobs[:2]), collate(blobs[2:])]
    dataset = types.SimpleNamespace(net_input_wh=IN_WH, bit_cnt=None)
    ev = Evaluator(eval_set['gts'], eval_set['models'], eval_set['models_info'],
                   'synthetic')
    out = harness.run_test(cfg, _model(), loader, dataset, ev, device='cpu')
    assert set(out) == {'weighted', 'ransac'}
    for res in out.values():
        assert len(res['errors']) == 4
        for e in res['errors']:
            assert np.all(np.isfinite(e['R_est'])) and np.all(np.isfinite(e['t_est']))
            assert e['time'] > 0
        assert 0.0 <= res['avg_score'] <= 1.0
        assert 'add(-s)_0.10' in res['tables'][0]


def test_cli_on_synthetic_bop_tree(tmp_path):
    root = str(tmp_path / 'data')
    synthetic.generate_dataset(root, n_images=4, split='test_syn', seed=1,
                               list_name='test_list.txt')
    cfg = _tiny_cfg(dataset_root=root,
                    list_files=[osp.join(root, 'test_list.txt')])
    cfg_path = tmp_path / 'tiny.yaml'
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    weight = tmp_path / 'model.pth'
    torch.save(_model().state_dict(), weight)
    from lc_tpu_torch import test as cli
    out_dir = tmp_path / 'out'
    results = cli.main(['--weight', str(weight), '--config', str(cfg_path),
                        '--output', str(out_dir), '--obj', '1',
                        '--deterministic', '--device', 'cpu'])
    assert set(results) == {'weighted', 'ransac'}
    assert len(results['weighted']['errors']) == 4
    csv = out_dir / 'tiny-weighted_synthetic_test_1.csv'
    assert len(csv.read_text().splitlines()) == 4
    with pytest.raises(SystemExit, match='.ckpt'):
        ckpt = tmp_path / 'model.ckpt'
        ckpt.write_bytes(b'')
        cli.main(['--weight', str(ckpt), '--config', str(cfg_path),
                  '--output', str(out_dir), '--obj', '1', '--device', 'cpu'])
