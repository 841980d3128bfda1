"""The zebra family through the port against lc_tpu: ZebraDeepLabV3 with the
Gray-code head, its reference checkpoint layout, the zebra options of
solve_pnp_dense, and `python -m lc_tpu_torch.test` on a zsyn-shaped tree.

Sizes: 64² in, 32² out, max_bit_cnt 5 (5/5/4 bits for the synthetic box),
as tests/test_integration_zebra.py. Tolerances:
  * forward, both packages in f32 on the same weights: rtol 1e-4 with atol
    1e-4 of each output's scale (as tests/test_torch_models.py);
  * decode and point selection: pts3d atol 1e-4 mm, masks equal;
  * the final weighted-filtered LM: translation 0.05 mm,
    |cos(q, q')| ≥ 1 − 1e-5.
lc_tpu's RANSAC compiles for ~50 s on XLA:CPU, so the RANSAC pose is the
port's, on lc_tpu's own sample indices (its Gumbel draw, injected); every
other stage of the reference chain (decode, selection, inlier set, LM) is
lc_tpu's. tests/test_torch_ransac.py holds the RANSAC stage itself."""
import json
import os.path as osp
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation as sciR

from lc_tpu import geom
from lc_tpu import inference as jinf
from lc_tpu.models import build_model as j_build_model
from lc_tpu.models import layers as jlayers
from lc_tpu.models.torch_port import port_zebra_checkpoint
from lc_tpu.pnp import ransac as jransac
from lc_tpu.pnp.solver import lm_refine as j_lm_refine
from lc_tpu_torch import inference as tinf
from lc_tpu_torch.codec import calc_bit_count
from lc_tpu_torch.data import synthetic
from lc_tpu_torch.data.pipeline import collate, device_preprocess
from lc_tpu_torch.models import build_model
from lc_tpu_torch.models.weights import random_flax_variables, state_dict_from_flax
from lc_tpu_torch.utils.config import Config
from test_torch_ransac import lc_tpu_sample_idx

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
IN_WH, OUT_WH = (64, 64), (32, 32)
HALF = np.array([40.0, 30.0, 20.0], np.float32)
BIT_CNT = tuple(calc_bit_count(HALF.tolist(), max_bits=5))       # (5, 5, 4)
ZEBRA_CFG = {'concat': True, 'output_kernel_size': 1}


@pytest.fixture(scope='module')
def zebra_pair():
    """lc_tpu's ZebraDeepLabV3 forward in f32 on seeded weights, once a file."""
    jlayers.set_compute_dtype(jnp.float32)
    try:
        variables = random_flax_variables(
            seed=1, net_name='zebra_DeepLabV3', total_bit_cnt=sum(BIT_CNT))
        jmodel = j_build_model('zebra_DeepLabV3', ZEBRA_CFG,
                               total_bit_cnt=sum(BIT_CNT))
        x = np.random.default_rng(0).normal(size=(2,) + IN_WH + (3,)) \
            .astype(np.float32)
        tmpl = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1,) + IN_WH + (3,))))
        j_out = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
        j_out = {k: np.asarray(v) for k, v in j_out.items()}
    finally:
        jlayers.set_compute_dtype(jnp.bfloat16)
    return dict(variables=variables, x=x, j_out=j_out,
                tmpl_shapes=jax.tree.map(lambda a: a.shape, tmpl))


def _port_model(variables):
    model = build_model('zebra_DeepLabV3', ZEBRA_CFG,
                        total_bit_cnt=sum(BIT_CNT)).eval()
    model.load_state_dict(state_dict_from_flax(variables,
                                               net_name='zebra_DeepLabV3'))
    return model


def test_zebra_variables_match_lc_tpu_tree(zebra_pair):
    assert jax.tree.map(np.shape, zebra_pair['variables']) == \
        zebra_pair['tmpl_shapes']


def test_zebra_forward_matches(zebra_pair):
    with torch.no_grad():
        t_out = _port_model(zebra_pair['variables'])(
            torch.from_numpy(zebra_pair['x']))
    j_out = zebra_pair['j_out']
    assert set(t_out) == set(j_out) == {
        'xyz_noc_bin', 'xyz_weight_logits', 'xyz_weights_scale',
        'msk_vis_logits'}
    assert t_out['xyz_noc_bin'].shape == (2,) + OUT_WH + (sum(BIT_CNT),)
    for k, v in j_out.items():
        assert t_out[k].shape == v.shape, k
        np.testing.assert_allclose(t_out[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


def test_state_dict_is_the_reference_layout(zebra_pair):
    """The port's state_dict(), as a reference .pth dict, through lc_tpu's
    port_zebra_checkpoint gives back the tree it was made from: the names
    and layouts of a reference zebra checkpoint."""
    variables = zebra_pair['variables']
    sd = {k: v.numpy() for k, v in
          _port_model(variables).state_dict().items()}
    params, stats = port_zebra_checkpoint(sd)
    back = {'params': params, 'batch_stats': stats}
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_v = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert set(flat_b) == set(flat_v)
    for k, v in flat_v.items():
        np.testing.assert_array_equal(np.asarray(flat_b[k]), v,
                                      err_msg=jax.tree_util.keystr(k))


def quat_cos(a, b):
    """|cos| of the angle between two poses' quaternions: a RANSAC pose,
    refined, need not have a unit quaternion."""
    qa, qb = a[:, :4], b[:, :4]
    return np.abs((qa * qb).sum(-1)) / (np.linalg.norm(qa, axis=-1)
                                        * np.linalg.norm(qb, axis=-1))


def test_solve_pnp_dense_zebra_options():
    """zlmo's options (Gray codes under black_background, dense_sample 1,
    quantile_in_mask 0.2, per-sample rel_reproj_err, weighted_filtered) on
    noisy oracle logits of a symmetric box."""
    es = synthetic.render_eval_set(3, seed=4, net_input_wh=IN_WH,
                                   net_output_wh=OUT_WH, symmetric=True)
    batch = collate(es['blobs'])
    rng = np.random.default_rng(5)
    out = synthetic.oracle_outputs(es, es['blobs'], OUT_WH, bit_cnt=BIT_CNT,
                                   black_background=True)
    out['xyz_noc_bin'] += rng.normal(0, 1.0, out['xyz_noc_bin'].shape) \
        .astype(np.float32)
    out['xyz_weight_logits'] += rng.normal(
        0, 1.0, out['xyz_weight_logits'].shape).astype(np.float32)
    gt = {'out_K': batch['out_K'], 'noc_scale': batch['noc_scale']}
    thr = (2.0 / batch['out_pix_scale']).astype(np.float32)

    jo = {k: jnp.asarray(v) for k, v in out.items()}
    jg = {k: jnp.asarray(v) for k, v in gt.items()}
    d = jinf.dense_grid_outputs(jo, jg, bit_cnt=BIT_CNT, black_background=True,
                                sample=1)
    seg_valid = d['seg_prob'] > 0.5
    q = 1.0 - 0.8 * jnp.mean(seg_valid.astype(jnp.float32), -1)
    valid = jinf.quantile_mask_bisect(
        d['inv_std2d'] * seg_valid[..., None], q) & seg_valid

    to = {k: torch.from_numpy(v) for k, v in out.items()}
    tg = {k: torch.from_numpy(v) for k, v in gt.items()}
    td = tinf.dense_grid_outputs(to, tg, bit_cnt=BIT_CNT,
                                 black_background=True, sample=1)
    np.testing.assert_allclose(td['pts3d'].numpy(), np.asarray(d['pts3d']),
                               atol=1e-4)
    idx = lc_tpu_sample_idx(jax.random.PRNGKey(0), np.asarray(valid))
    states = tinf.solve_pnp_dense(
        to, tg, bit_cnt=BIT_CNT, black_background=True, sample=1,
        point_select='quantile_in_mask', quantile=0.2,
        solvers=('ransac', 'weighted_filtered'),
        reproj_err=torch.from_numpy(thr), device='cpu',
        sample_idx=torch.tensor(idx))

    # lc_tpu's inlier set and final LM from the RANSAC pose
    ransac_pose = jnp.asarray(states['ransac'].numpy())
    R, t = geom.pose7_to_RT(ransac_pose)
    err = jransac._reproj_err(R, t, jg['out_K'], d['pts3d'], d['pts2d'])
    inliers = (err < jnp.asarray(thr)[:, None]) & valid
    ref = np.asarray(jax.jit(j_lm_refine)(
        ransac_pose, jg['out_K'], d['pts3d'], d['pts2d'],
        d['inv_std2d'] ** 2, valid=inliers).pose7)
    got = states['weighted-filtered'].numpy()
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], atol=0.05)
    assert np.all(quat_cos(got, ref) >= 1 - 1e-5)
    # and the pose is the object's: ADD within 0.1 d (5-bit codes on a 32²
    # grid quantize the 80 mm axis to 2.6 mm bins)
    for i, (Rg, tg_) in enumerate(es['poses']):
        Rp, tp = geom.pose7_to_RT(jnp.asarray(got[i]))
        dist = np.linalg.norm(es['models'][1] @ (np.asarray(Rp) - Rg).T
                              + (np.asarray(tp) - tg_), axis=-1)
        assert dist.mean() < 0.1 * es['models_info'][1]['diameter']


def _write_models_xform(root, seed=6):
    """A random rigid canonical-frame transform for object 1, in the
    models_xform.json layout, with the NOC scale of the box in that frame."""
    rng = np.random.default_rng(seed)
    xf = np.eye(4)
    xf[:3, :3] = sciR.random(random_state=seed).as_matrix()
    xf[:3, 3] = rng.uniform(-5, 5, 3)
    corners = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                        for c in (-1, 1)]) * HALF
    scale = np.abs(corners @ xf[:3, :3].T + xf[:3, 3]).max(0)
    path = osp.join(root, 'models_xform.json')
    with open(path, 'w') as f:
        json.dump({'1': {'xform': xf.reshape(-1).tolist(),
                         'xformed_noc_scale': scale.tolist()}}, f)
    return path, scale


def test_cli_on_zsyn_tree(tmp_path):
    """python -m lc_tpu_torch.test --device cpu on a generated synthetic_sym
    tree with zsyn's options and a models_xform.json: exits 0, writes the
    score table and the CSV, and builds the model with sum(bit_cnt) output
    channels so a binary-head .pth loads."""
    root = str(tmp_path / 'data')
    synthetic.generate_dataset(root, n_images=4, split='test_syn', seed=5,
                               symmetric=True, list_name='test_list.txt')
    xform_path, xfd_scale = _write_models_xform(root)
    cfg = Config(yaml.safe_load(open(osp.join(ROOT, 'configs', 'zsyn.yaml'))))
    cfg.merge_from_dict({
        'max_bit_cnt': 5, 'net_input_wh': list(IN_WH),
        'net_output_wh': list(OUT_WH), 'dataloader.batch_size': 4,
        'dataloader.num_workers': 1, 'transform_model': True,
        'transform_path': xform_path, 'test_dataset.dataset_root': root,
        'test_dataset.list_files': [osp.join(root, 'test_list.txt')]})
    cfg_path = tmp_path / 'zsyn_tiny.yaml'
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    bit_cnt = calc_bit_count(xfd_scale.tolist(), max_bits=5)
    model = build_model('zebra_DeepLabV3', ZEBRA_CFG,
                        total_bit_cnt=sum(bit_cnt))
    model.load_state_dict(state_dict_from_flax(random_flax_variables(
        seed=0, net_name='zebra_DeepLabV3', total_bit_cnt=sum(bit_cnt)),
        net_name='zebra_DeepLabV3'))
    weight = tmp_path / 'zebra.pth'
    torch.save(model.state_dict(), weight)
    out_dir = tmp_path / 'out'
    subprocess.run([sys.executable, '-m', 'lc_tpu_torch.test', '--weight',
                    str(weight), '--config', str(cfg_path), '--output',
                    str(out_dir), '--obj', '1', '--deterministic',
                    '--device', 'cpu'], check=True, cwd=ROOT, timeout=120)
    csv = out_dir / 'zsyn_tiny-weighted-filtered_synthetic_sym_test_1.csv'
    assert len(csv.read_text().splitlines()) == 4
    log = (out_dir / 'zsyn_tiny_synthetic_sym_test_1.log').read_text()
    assert 'weighted-filtered' in log and 'add(-s)_0.10' in log


def test_eval_blobs_carry_the_model_transform(tmp_path):
    """BOPDataset with max_bit_cnt and transform_model: bit_cnt from the
    transformed NOC scale, and the transform in every eval blob and through
    device_preprocess."""
    from lc_tpu_torch.data.pipeline import BOPDataset
    root = str(tmp_path / 'data')
    synthetic.generate_dataset(root, n_images=2, split='test_syn', seed=2,
                               symmetric=True, list_name='test_list.txt')
    xform_path, xfd_scale = _write_models_xform(root)
    cfg = Config(dict(obj_ids=[1], max_bit_cnt=7, transform_model=True,
                      transform_path=xform_path, sym_aware=True,
                      net_input_wh=list(IN_WH), net_output_wh=list(OUT_WH)))
    ds_cfg = Config(dict(name='synthetic_sym', dataset_root=root,
                         list_files=[osp.join(root, 'test_list.txt')],
                         visib_frac=0.0, dzi_pad_scale=1.5))
    ds = BOPDataset(ds_cfg, cfg, train=False)
    assert ds.bit_cnt == tuple(calc_bit_count(xfd_scale.tolist(), max_bits=7))
    assert ds.max_candidates == 2
    blob = ds.sample(0)
    xf = np.asarray(json.load(open(xform_path))['1']['xform']).reshape(4, 4)
    np.testing.assert_allclose(blob['model_transform'], xf, atol=1e-6)
    np.testing.assert_allclose(blob['noc_scale'], xfd_scale, atol=1e-5)
    gt = device_preprocess({k: torch.as_tensor(v)[None]
                            for k, v in blob.items()}, net_input_wh=IN_WH)
    assert gt['model_transform'].shape == (1, 4, 4)


@pytest.mark.parametrize('dataset,obj_id,symmetric', [
    ('synthetic_sym', 1, True), ('synthetic', 1, False),
    ('ycbvposecnn', 13, True), ('ycbvposecnn', 1, False)])
def test_evaluator_scores_symmetric_objects_by_add_s(dataset, obj_id,
                                                     symmetric):
    """The dataset's table (geom/symmetry.py) decides ADD-S: an estimate
    turned by the box's 180° symmetry about z scores 1.0 under ADD-S, 0.0
    under ADD."""
    from lc_tpu_torch.eval.evaluator import Evaluator
    half = HALF.astype(np.float64)
    pts = synthetic.box_surface_points(half)
    R = sciR.random(random_state=9).as_matrix()
    t = np.array([10.0, -5.0, 700.0])
    flip = sciR.from_rotvec([0, 0, np.pi]).as_matrix()
    gts = [dict(scene_id=1, im_id=0, obj_id=obj_id, R_gt=R,
                t_gt=t[:, None], cam_K=synthetic.K_DEFAULT, im_w=640.0)]
    info = {obj_id: {'diameter': float(2 * np.linalg.norm(half))}}
    ev = Evaluator(gts, {obj_id: pts}, info, dataset)
    per_obj, errors = ev.evaluate([dict(scene_id=1, im_id=0, obj_id=obj_id,
                                        R_est=R @ flip, t_est=t)])
    assert errors[0]['adi'] < 1e-3 < errors[0]['add']
    assert per_obj[obj_id]['add(-s)_0.10'] == (1.0 if symmetric else 0.0)
