"""The sparse-keypoint training path of the port against lc_tpu: the
keypoint Laplace NLL and the sparse LC loss in compute_losses, the 2D
symmetry selection of the targets, one whole train step of CDPN-ResNet34
with the keypoint head, render_train_set's symmetric and sparse blobs, and
the train CLI on a gspsyn-shaped tree with resume.

Sizes: 64² in, 16² out, batch 2, 4 keypoints spread over the box (the
first 4 of render_train_set's are collinear, a degenerate PnP); the CLI:
batch 4 and the box's 8 corners as keypoints, since the test CLI's RANSAC
draws samples of 6.
Tolerances, each with its reason:
  * compute_losses on fixed outputs: each term and the total rtol 1e-4, the
    gradient of pts2d and pts2d_std within 1e-4 of its largest entry;
  * the targets: the best pose and xyz_gt as tests/test_torch_train.py
    (rtol 1e-4, atol 1e-3 mm);
  * the whole step, f32 on both sides: the glmo step's tolerances
    (tests/test_torch_train_step.py): each term rtol 1e-4, the head's
    gradients within 1e-4 of their largest entry, every gradient within
    5e-3 in relative L2 (the head's bias, whose exact gradient is zero since
    a constant added to a heatmap's logits leaves its softmax, below 1e-5
    of the step's largest gradient entry on both sides), BatchNorm's
    running means rtol 1e-4, the clip thresholds rtol 1e-4; grad_norm,
    which glmo's step does not compare, rtol 1e-3: the port's f32 step
    lies 1.4e-4 from its f64 step, lc_tpu's 3.3e-4 (CPU readings of this
    case).
"""
import json
import os.path as osp
import pickle

import numpy as np
import jax
import pytest
import torch
import yaml

from lc_tpu.loss import LossConfig as JLossConfig
from lc_tpu.loss import compute_losses as j_compute_losses
from lc_tpu.loss import init_loss_state as j_init_loss_state
from lc_tpu.loss import targets as jtargets
from lc_tpu.loss import zero_taps
from lc_tpu_torch.data import synthetic
from lc_tpu_torch.data.pipeline import collate
from lc_tpu_torch.loss import targets as ttargets
from lc_tpu_torch.loss.loss_fn import LossConfig, compute_losses, \
    init_loss_state, make_taps
from lc_tpu_torch.models.weights import random_flax_variables
from test_torch_train_zebra import GRAD_REL_BELOW_HEADS, _j, _t, \
    check_whole_step, f32_reference, whole_step_case  # noqa: F401

IN_WH, OUT_WH = (64, 64), (16, 16)
HALF = np.array([40.0, 30.0, 20.0], np.float32)
N_KPTS = 4
# 4 keypoints, no 3 collinear and not coplanar
KPTS = (HALF * np.array([[-1, -1, -1], [1, 1, -1], [1, -1, 1], [-1, 1, 1]])
        ).astype(np.float32)
LOSS_KW = dict(w_loss_kpts=1.0, w_loss_pose=0.7, full_pose_loss_step=0,
               clip_weight_grad=True, sparse=True)


def _gt_batch(seed=5, symmetric=False, B=2):
    b = collate(synthetic.render_train_set(
        B, seed=seed, net_input_wh=IN_WH, net_output_wh=OUT_WH,
        symmetric=symmetric, sparse_cnt=N_KPTS))
    gt = {k: b[k] for k in ('Rt_candi', 'candi_valid', 'homo_z_out',
                            'K_no_aug', 'sym_ck_pts2d', 'noc_scale', 'out_K',
                            'bbox_3d', 'pts3d')}
    gt['msk_vis'] = b['msk_vis_small']
    gt['msk_noc'] = b['msk_noc_small']
    gt['pts3d'] = np.repeat(KPTS[None], B, 0)
    return gt


def test_render_train_set_symmetric_and_sparse():
    """A symmetric blob carries the box's 2 GT-equivalent poses, both
    valid, the second the first turned by pi about z; a sparse blob carries
    the first sparse_cnt keypoints as pts3d; the default blob one
    candidate and no pts3d."""
    sym = synthetic.render_train_set(2, seed=1, net_input_wh=IN_WH,
                                     net_output_wh=OUT_WH, symmetric=True)
    plain = synthetic.render_train_set(2, seed=1, net_input_wh=IN_WH,
                                       net_output_wh=OUT_WH)
    sparse = synthetic.render_train_set(2, seed=1, net_input_wh=IN_WH,
                                        net_output_wh=OUT_WH, sparse_cnt=16)
    for s, p, q in zip(sym, plain, sparse):
        assert s['Rt_candi'].shape == (2, 3, 4) and s['candi_valid'].all()
        np.testing.assert_allclose(
            s['Rt_candi'][1, :, :3],
            s['Rt_candi'][0, :, :3] @ np.diag([-1.0, -1.0, 1.0]), atol=1e-6)
        np.testing.assert_array_equal(s['Rt_candi'][0], p['Rt_candi'][0])
        assert p['Rt_candi'].shape == (1, 3, 4) and 'pts3d' not in p
        np.testing.assert_array_equal(
            q['pts3d'], synthetic.box_surface_points(HALF, 16)[:16])
        for k in p:          # the same frames and crops
            np.testing.assert_array_equal(q[k], p[k], err_msg=k)


def _random_out(rng, gt, B=2):
    """Keypoints scattered ~3 px around their GT projections, stds 0.5-3."""
    from lc_tpu_torch.geom.pose import RT_to_pose7, pose7_to_RT
    from lc_tpu_torch.geom.projection import project_apply
    Rt = torch.as_tensor(gt['Rt_candi'][:, 0])
    proj = project_apply(torch.as_tensor(gt['out_K']),
                         torch.as_tensor(gt['pts3d']),
                         *pose7_to_RT(RT_to_pose7(Rt[..., :3], Rt[..., 3])))
    return {'pts2d': (proj.numpy() + rng.normal(0, 3, proj.shape))
            .astype(np.float32),
            'pts2d_std': rng.uniform(0.5, 3.0, proj.shape).astype(np.float32)}


@pytest.mark.parametrize('ramp', ['full', 'partial'])
def test_compute_losses_sparse_matches(ramp):
    """compute_losses' sparse branch on fixed keypoints and gt (lc_tpu's
    annotations): loss_kpts, loss_pose (full weight, and 0.4 of the way
    through its ramp, blended with loss_kpts), the total, and the gradient
    of pts2d and pts2d_std."""
    gt = _gt_batch()
    out = _random_out(np.random.default_rng(8), gt)
    gt = dict(gt, **{k: np.asarray(v) for k, v in jtargets.annots_on_the_fly(
        _j(gt), _j(out), step=0).items()})
    kw = dict(LOSS_KW, full_pose_loss_step=0 if ramp == 'full' else 10)
    jcfg, tcfg = JLossConfig(**kw), LossConfig(**kw)
    step = 3

    def jloss(o):
        total, terms, _ = j_compute_losses(jcfg, _j(gt), o,
                                           j_init_loss_state(jcfg), step,
                                           zero_taps())
        return total, terms
    (jtot, jterms), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _j(out))
    tout = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    ttot, tterms, tstate = compute_losses(tcfg, _t(gt), tout,
                                          init_loss_state(tcfg), step,
                                          make_taps())
    ttot.backward()
    assert tstate.histogram is None
    assert set(tterms) == set(jterms) == {'loss_kpts', 'loss_pose'}
    np.testing.assert_allclose(ttot.item(), float(jtot), rtol=1e-4)
    for k, v in tterms.items():
        np.testing.assert_allclose(v.item(), float(jterms[k]), rtol=1e-4,
                                   err_msg=k)
    if ramp == 'partial':
        assert abs(tterms['loss_pose'].item()
                   - tterms['loss_kpts'].item()) > 1e-3
    for k, v in tout.items():
        g = np.asarray(jg[k])
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(v.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


def test_sparse_targets_select_in_2d():
    """With the symmetric box's two candidates, the sparse targets pick the
    candidate whose keypoint projections lie nearest the predictions (the
    second, the keypoints put at its projections) in both packages."""
    from lc_tpu_torch.geom.projection import project_apply
    gt = _gt_batch(symmetric=True)
    c1 = torch.as_tensor(gt['Rt_candi'][:, 1])
    proj = project_apply(torch.as_tensor(gt['out_K']),
                         torch.as_tensor(gt['pts3d']), c1[..., :3],
                         c1[..., 3])
    out = {'pts2d': proj.numpy() + 0.5,
           'pts2d_std': np.ones_like(proj.numpy())}
    j = jtargets.annots_on_the_fly(_j(gt), _j(out), step=0)
    t = ttargets.annots_on_the_fly(_t(gt), _t(out), step=0)
    np.testing.assert_allclose(t['Rt_best'].numpy(), gt['Rt_candi'][:, 1],
                               atol=1e-6)
    for k in ('Rt_best', 'pose_best', 'xyz_gt', 'xyz_noc_tgt'):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-4,
                                   atol=1e-3, err_msg=k)


def test_one_sparse_train_step_matches(f32_reference):
    """One whole step of CDPN-ResNet34 with the 4-keypoint head (gsplmo's
    losses: the keypoint NLL and the LC loss on the keypoints at full
    weight) in f32, against lc_tpu's make_train_step, at the glmo step's
    tolerances: the terms, grad_norm, every gradient, BatchNorm's running
    means and the clip thresholds (the sparse path uses no tap: the weight
    clipper sees a norm of 0, in both)."""
    gt = _gt_batch()
    gt['img_in'] = np.random.default_rng(0).normal(
        size=(2,) + IN_WH[::-1] + (3,)).astype(np.float32)
    variables = random_flax_variables(seed=2, sparse_cnt=N_KPTS)
    case = whole_step_case('cdpn_resnet', {'concat': False}, gt, variables,
                           LOSS_KW, sparse_cnt=N_KPTS)
    check_whole_step(case, ('net.decoder.out_layer',),
                     ('loss_kpts', 'loss_pose'),
                     {'loss_kpts': 1.0, 'loss_pose': 0.7},
                     GRAD_REL_BELOW_HEADS, 1e-3)


@pytest.fixture(scope='module')
def gspsyn_tree(tmp_path_factory):
    """A synthetic tree (6 training frames, 4 test frames) and its keypoint
    pickle: the box's 8 corners."""
    root = str(tmp_path_factory.mktemp('gspsyn'))
    synthetic.generate_dataset(root, n_images=6, split='train_syn', seed=0)
    synthetic.generate_dataset(root, n_images=4, split='test_syn', seed=2,
                               list_name='test_list.txt')
    with open(osp.join(root, 'fps.pkl'), 'wb') as f:
        corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                            for z in (-1, 1)]) * HALF
        pickle.dump({1: corners.astype(np.float32)}, f)
    return root


def test_train_cli_gspsyn_resume_and_test(gspsyn_tree, tmp_path,
                                          monkeypatch):
    """python -m lc_tpu_torch.train --device cpu on configs/gspsyn.yaml cut
    to 64² in, 16² out, batch 4, 8 keypoints: three steps with an
    evaluation after step 2; a run cut after its second step and resumed
    from its checkpoint (no histogram: None survives) without device
    prefetch repeats the third step's metrics exactly; then
    lc_tpu_torch.test on model_final."""
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch import train as train_cli
    from lc_tpu_torch.utils.checkpoint import load_checkpoint
    from lc_tpu_torch.utils.config import load_config
    here = osp.dirname(osp.dirname(osp.abspath(__file__)))
    root = gspsyn_tree
    cfg = load_config(osp.join(here, 'configs', 'gspsyn.yaml'))
    cfg.merge_from_dict({
        'sparse_cnt': 8, 'fps': osp.join(root, 'fps.pkl'),
        'net_input_wh': list(IN_WH), 'net_output_wh': list(OUT_WH),
        'dataloader.batch_size': 4, 'dataloader.num_workers': 2,
        'train.num_steps': 3, 'train.test_every': 2, 'train.ckpt_every': 1,
        'scheduler.warmup_iters': 2, 'loss.pose_loss_start_step': 1,
        'train_dataset.dataset_root': root,
        'train_dataset.list_files': [osp.join(root, 'train_syn_list.txt')],
        'train_dataset.valid_pix_cnt_th': 30,
        'test_dataset.dataset_root': root,
        'test_dataset.list_files': [osp.join(root, 'test_list.txt')]})
    cfg_path = tmp_path / 'gspsyn.yaml'
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    base = ['--config', str(cfg_path), '--device', 'cpu']

    out_a = tmp_path / 'a'
    train_cli.main(base + ['--output', str(out_a)])
    exp_a = out_a / 'gspsyn-1'
    lines_a = [json.loads(x) for x in
               (exp_a / 'metrics.jsonl').read_text().splitlines()]
    assert [m['step'] for m in lines_a] == [1, 3]
    assert set(lines_a[0]) == {'step', 'loss', 'grad_norm', 'loss_kpts',
                               'loss_pose'}
    for m in lines_a:
        assert all(np.isfinite(v) for v in m.values())
    assert len(list(exp_a.glob('model_best_2_*.ckpt'))) == 1

    real_step = train_cli.train_step

    def cut_at_third(*args, **kw):
        if args[6] == 2:
            raise KeyboardInterrupt('cut')
        return real_step(*args, **kw)

    out_b = tmp_path / 'b'
    monkeypatch.setattr(train_cli, 'train_step', cut_at_third)
    with pytest.raises(KeyboardInterrupt):
        train_cli.main(base + ['--output', str(out_b)])
    monkeypatch.setattr(train_cli, 'train_step', real_step)
    saved = load_checkpoint(str(out_b / 'gspsyn-1' / 'ckpts' /
                                '000000002.ckpt'))['state']['loss_state']
    assert saved.histogram is None and bool(saved.weight_clip.started)
    # the resumed run stages each batch when its step takes it (no
    # prefetch): the same metrics
    monkeypatch.setattr(train_cli, 'PREFETCH_BATCHES', 0)
    train_cli.main(base + ['--output', str(out_b), '--resume'])
    lines_b = [json.loads(x) for x in
               (out_b / 'gspsyn-1' / 'metrics.jsonl').read_text()
               .splitlines()]
    assert lines_b[-1] == lines_a[-1]

    results = test_cli.main(['--weight', str(exp_a / 'model_final.ckpt'),
                             '--config', str(cfg_path), '--output',
                             str(tmp_path / 'test'), '--obj', '1',
                             '--device', 'cpu'])
    assert set(results) == {'ransac', 'weighted'}
    assert len(results['weighted']['errors']) == 4
