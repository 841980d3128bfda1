"""The port's training pieces against lc_tpu's on numpy-made inputs: the LC
loss and its covariance, the gradient tap and clipper, the schedule and
Ranger, the colour augmentation and the training targets; and the port's
checkpoint rotations and resume on their own.

Tolerances, each with its reason:
  * loss_cov_mixed value rtol 1e-4; its gradients wrt inv_std2d and pts3d
    within 1e-3 of each gradient's max: f32, and the 6x6 solves and the sums
    over 2N points run in another order (torch.linalg vs lc_tpu's unrolled
    Cholesky);
  * weighted_pnp_jac_cov rtol 1e-4 (the same solves); the invalid flags and
    the identity fallback exact;
  * grad_tap and the clipper rtol 1e-6 (a few f32 operations);
  * schedule rtol 1e-5 (lc_tpu evaluates it in f32, the port in f64);
    Ranger rtol 1e-5 / atol 1e-7 over 25 steps (f32 both sides, lookahead
    and the rectification step included);
  * augmentation atol 1e-3 on 0-255 values (the same f32 formulas), and the
    gates' frequencies within 4 standard deviations of their probabilities.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu.data import augment as jaug
from lc_tpu.loss import clip as jclip
from lc_tpu.loss import cov_mixed as jcov
from lc_tpu.loss import targets as jtargets
from lc_tpu.optim.ranger import ranger as jranger
from lc_tpu.optim.schedule import flat_and_anneal_schedule
from lc_tpu.pnp import covariance as jpcov
from lc_tpu_torch.data import augment as taug
from lc_tpu_torch.loss import clip as tclip
from lc_tpu_torch.loss import cov_mixed as tcov
from lc_tpu_torch.loss import targets as ttargets
from lc_tpu_torch.optim.ranger import Ranger
from lc_tpu_torch.optim.schedule import flat_and_anneal
from lc_tpu_torch.pnp import covariance as tpcov

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)


def lc_problem(B=2, N=64, seed=0):
    """A GT pose, its crop camera, predicted 3D points near the model
    surface, their pixels (projections plus noise) and weights."""
    rng = np.random.default_rng(seed)
    R = sciR.random(B, random_state=seed).as_matrix()
    t = np.concatenate((rng.uniform(-30, 30, (B, 2)),
                        rng.uniform(600, 800, (B, 1))), -1)
    q = sciR.from_matrix(R).as_quat()[:, [3, 0, 1, 2]]     # wijk
    pose = np.concatenate((q, t), -1).astype(np.float32)
    pts3d = rng.uniform(-40, 40, (B, N, 3)).astype(np.float32)
    cam = (pts3d @ R.transpose(0, 2, 1) + t[:, None]) @ K.T
    uv = cam[..., :2] / cam[..., 2:]
    pts2d = (uv + rng.normal(size=uv.shape) * 2.0).astype(np.float32)
    inv_std = rng.uniform(0.2, 2.0, (B, N, 2)).astype(np.float32)
    bbox = (np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)]) * [40, 30, 20]).astype(np.float32)
    Ks = np.broadcast_to(K, (B, 3, 3)).copy()
    valid = (rng.random((B, N)) < 0.9).astype(np.float32)
    return dict(K=Ks, pose=pose, pts3d=pts3d, pts2d=pts2d, inv_std=inv_std,
                valid=valid, bbox=np.broadcast_to(bbox, (B, 8, 3)).copy())


@pytest.mark.parametrize('cov_2d', [False, True])
def test_loss_cov_mixed_value_and_grads(cov_2d):
    p = lc_problem()
    kw = dict(max_err_len=8.0, cov_2d=cov_2d)

    def jloss(inv_std, pts3d):
        return jnp.sum(jcov.loss_cov_mixed(
            jnp.asarray(p['K']), jnp.asarray(p['pose']), pts3d,
            jnp.asarray(p['pts2d']), inv_std, jnp.asarray(p['valid']),
            bbox_3d=jnp.asarray(p['bbox']), **kw))

    jv, (jg_std, jg_pts) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(p['inv_std']), jnp.asarray(p['pts3d']))
    inv_std = torch.tensor(p['inv_std'], requires_grad=True)
    pts3d = torch.tensor(p['pts3d'], requires_grad=True)
    tv = tcov.loss_cov_mixed(
        torch.tensor(p['K']), torch.tensor(p['pose']), pts3d,
        torch.tensor(p['pts2d']), inv_std, torch.tensor(p['valid']),
        bbox_3d=torch.tensor(p['bbox']), **kw).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-4)
    for t_g, j_g in ((inv_std.grad, jg_std), (pts3d.grad, jg_pts)):
        j_g = np.asarray(j_g)
        assert np.abs(j_g).max() > 0
        np.testing.assert_allclose(t_g.numpy(), j_g, rtol=0,
                                   atol=1e-3 * np.abs(j_g).max())


def test_corner_jacobian_closed_form_matches_jacfwd():
    """The port's closed-form corner jacobians against lc_tpu's jacfwd over
    apply_perturb, in 3D and through the projection in 2D (rtol 1e-4)."""
    p = lc_problem(B=3, seed=4)
    bb = jnp.asarray(p['bbox'])
    j3 = jax.vmap(lambda st, b: jax.jacfwd(lambda d: jcov.xform_3d(
        jcov.apply_perturb(st, d), b))(jnp.zeros(6)))(jnp.asarray(p['pose']), bb)
    j2 = jax.vmap(lambda st, k, b: jax.jacfwd(lambda d: jcov.xform_2d(
        jcov.apply_perturb(st, d), k, b))(jnp.zeros(6)))(
        jnp.asarray(p['pose']), jnp.asarray(p['K']), bb)
    t3 = tcov.jac_update_to_alter(torch.tensor(p['pose']), torch.tensor(p['bbox']))
    t2 = tcov.jac_update_to_alter(torch.tensor(p['pose']), torch.tensor(p['bbox']),
                                  torch.tensor(p['K']))
    for t, j in ((t3, j3), (t2, j2)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max())


def test_weighted_pnp_jac_cov_and_fallback():
    """Closed-form jacobian and covariance; a row whose weights are all zero
    has a singular H and falls back to the identity on both sides."""
    p = lc_problem(B=3, N=32, seed=1)
    w = p['inv_std'] ** 2
    w[2] = 0.0
    args = [p['pose'], p['K'], p['pts3d'], p['pts2d'], w, p['valid'] > 0]
    j = jpcov.weighted_pnp_jac_cov(*map(jnp.asarray, args))
    t = tpcov.weighted_pnp_jac_cov(*map(torch.tensor, args))
    np.testing.assert_array_equal(t.invalid.numpy(), np.asarray(j.invalid))
    assert t.invalid.tolist() == [False, False, True]
    np.testing.assert_allclose(t.cov[2].numpy(), np.eye(6), atol=1e-6)
    for name in ('cov', 'jac', 'hess_L'):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_pnp_update_backward_is_minus_h_inverse():
    p = lc_problem(B=2, N=16, seed=2)
    L = tpcov.weighted_pnp_jac_cov(*map(torch.tensor, (
        p['pose'], p['K'], p['pts3d'], p['pts2d'], p['inv_std'] ** 2))).hess_L
    jtr = torch.zeros(2, 6, requires_grad=True)
    g = torch.randn(2, 6, generator=torch.Generator().manual_seed(0))
    out = tpcov.pnp_update(L, jtr)
    assert torch.equal(out, torch.zeros(2, 6))
    (out * g).sum().backward()
    # lc_tpu's own backward returns (..., 6, 1) for a (..., 6) primal, which
    # jax refuses (ROADMAP queue C); hold the port to -H^-1 g directly
    Ld = L.detach().double().numpy()
    want = -np.linalg.solve(Ld @ Ld.transpose(0, 2, 1), g.double().numpy()[..., None])
    np.testing.assert_allclose(jtr.grad.numpy(), want[..., 0], rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize('scale', [0.01, 100.0])
def test_grad_tap_clips_and_reports_the_norm(scale):
    """Below the threshold the cotangent passes unchanged, above it is cut
    to max_norm; the tap's gradient is the unclipped global L2 norm."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 4, 2)).astype(np.float32)
    c = (rng.normal(size=x.shape) * scale).astype(np.float32)
    max_norm = np.float32(5.0)
    jg = jax.grad(lambda a, tap: jnp.sum(jclip.grad_tap(a, max_norm, tap) * c),
                  argnums=(0, 1))(jnp.asarray(x), jnp.zeros(()))
    xt = torch.tensor(x, requires_grad=True)
    tap = torch.zeros((), requires_grad=True)
    (tclip.grad_tap(xt, torch.tensor(max_norm), tap) * torch.tensor(c)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[0]), rtol=1e-6)
    np.testing.assert_allclose(float(tap.grad), float(jg[1]), rtol=1e-6)
    np.testing.assert_allclose(float(tap.grad), np.linalg.norm(c), rtol=1e-5)
    assert np.linalg.norm(xt.grad.numpy()) <= max_norm * (1 + 1e-5)


def test_update_clipper_state_sequence():
    """Threshold evolution from the -1 init: the static 100 on step 1, then
    the seeded and EMA thresholds."""
    js, ts = jclip.init_clipper_state(), tclip.init_clipper_state()
    assert float(tclip.clip_threshold(ts)) == 100.0
    for norm in (250.0, 3.0, 3.5, 400.0, 2.0):
        js = jclip.update_clipper_state(js, jnp.float32(norm))
        ts = tclip.update_clipper_state(ts, torch.tensor(norm))
        np.testing.assert_allclose(float(ts.max_norm), float(js.max_norm),
                                   rtol=1e-6)
        assert bool(ts.started)
    np.testing.assert_allclose(float(tclip.clip_threshold(ts)),
                               float(jclip.clip_threshold(js)), rtol=1e-6)


@pytest.mark.parametrize('case', [
    dict(anneal_method='cosine', warmup_iters=10, warmup_factor=0.001,
         anneal_point=0.72),
    dict(anneal_method='step', warmup_iters=8, steps=(0.5, 0.75),
         step_gamma=0.5),
    dict(anneal_method='poly', warmup_iters=5, warmup_method='constant',
         warmup_factor=0.3, anneal_point=0.6, poly_power=2.0),
], ids=['cosine', 'step', 'poly'])
def test_flat_and_anneal_matches(case):
    sched = flat_and_anneal_schedule(total_iters=100, **case)
    mine = [flat_and_anneal(i, total_iters=100, **case) for i in range(101)]
    np.testing.assert_allclose(mine, [float(sched(i)) for i in range(101)],
                               rtol=1e-5, atol=1e-9)


def test_gc_axes_differ_by_layout():
    """lc_tpu centralizes over every axis but the first. On a flax HWIO
    kernel that is per kernel row; on the same kernel in torch's OIHW layout
    it is per output channel, which is what the reference does."""
    g = np.random.default_rng(4).normal(size=(3, 3, 4, 8))        # HWIO
    hwio = g - g.mean(axis=(1, 2, 3), keepdims=True)
    oihw = g.transpose(3, 2, 0, 1)
    oihw = oihw - oihw.mean(axis=(1, 2, 3), keepdims=True)
    assert not np.allclose(hwio.transpose(3, 2, 0, 1), oihw)
    np.testing.assert_allclose(oihw.sum(axis=(1, 2, 3)), 0, atol=1e-9)


@pytest.mark.parametrize('weight_decay', [0.0, 1e-2])
def test_ranger_trajectory_matches_lc_tpu(weight_decay):
    """25 steps on fixed torch-layout arrays (conv OIHW, linear, bias): the
    RAdam warmup, the rectification step, GC per output channel and four
    lookahead syncs, with a schedule."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3, 3, 3), (5, 4), (5,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(25)]
    lr_fn = lambda step: 1e-2 * (0.5 + 0.5 * np.cos(step / 25.0))  # noqa: E731

    tx = jranger(lambda step: 1e-2 * (0.5 + 0.5 * jnp.cos(step / 25.0)),
                 weight_decay=weight_decay)
    jp = {f'p{i}': jnp.asarray(p) for i, p in enumerate(p0)}
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt = Ranger(params, lr=1.0, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: lr_fn(i + 1))
    for gs in grads:
        upd, state = tx.update({f'p{i}': jnp.asarray(g) for i, g in
                                enumerate(gs)}, state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        for p, g in zip(params, gs):
            p.grad = torch.tensor(g)
        opt.step()
        sched.step()
    for i, p in enumerate(params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[f'p{i}']),
                                   rtol=1e-5, atol=1e-7, err_msg=f'param {i}')


def test_augment_formulas_match():
    """Given the same values, the blur, the dropout grid, additive, two
    multiplies, contrast and background switching equal lc_tpu's."""
    rng = np.random.default_rng(6)
    B, H, W = 3, 20, 24
    x = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    sigma = np.array([0.0, 0.5, 1.2], np.float32).reshape(B, 1, 1, 1)
    np.testing.assert_allclose(
        taug.gaussian_blur(torch.tensor(x), torch.tensor(sigma)).numpy(),
        np.asarray(jaug._gaussian_blur(jnp.asarray(x), jnp.asarray(sigma))),
        atol=1e-3)
    keep = np.array([True, False, True]).reshape(B, 1, 1, 1)
    d = taug.draw_color_aug(x.shape, torch.Generator().manual_seed(0))
    for k in d:
        if k.endswith('gate'):
            d[k] = torch.tensor(keep)
    got = taug.apply_color_aug(torch.tensor(x), d).numpy()
    # the same steps written with lc_tpu's helpers and formulas
    j = jnp.asarray(x)
    g = jnp.asarray(keep)
    kp = jnp.asarray(d['drop_keep'].numpy()).astype(j.dtype)
    kp = jnp.repeat(jnp.repeat(kp, -(-H // kp.shape[1]), 1)[:, :H],
                    -(-W // kp.shape[2]), 2)[:, :, :W]
    j = jnp.where(g, j * kp, j)
    j = jnp.where(g, jaug._gaussian_blur(j, jnp.asarray(d['blur_sigma'].numpy())), j)
    j = jnp.where(g, j + jnp.asarray(d['add'].numpy()), j)
    j = jnp.where(g, j * jnp.asarray(d['mul'].numpy()), j)
    j = jnp.where(g, j * jnp.asarray(d['mul2'].numpy()), j)
    j = jnp.where(g, 127.0 + jnp.asarray(d['alpha'].numpy()) * (j - 127.0), j)
    np.testing.assert_allclose(got, np.asarray(jnp.clip(j, 0.0, 255.0)),
                               atol=1e-3)
    m = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    bg = rng.uniform(0, 255, x.shape).astype(np.float32)
    en = np.array([True, False, True])
    np.testing.assert_allclose(
        taug.switch_background(*map(torch.tensor, (x, m, bg, en))).numpy(),
        np.asarray(jaug.switch_background(*map(jnp.asarray, (x, m, bg, en)))),
        atol=1e-3)


def test_augment_gate_frequencies():
    """The port's gates and value ranges against lc_tpu's, statistically:
    4096 samples, each gate within 4 standard deviations of its p."""
    n = 4096
    d = taug.draw_color_aug((n, 20, 20, 3), torch.Generator().manual_seed(1),
                            use_pepper_salt=True, use_motion_blur=True,
                            use_invert=True)
    probs = dict(sp_gate=0.3, mb_gate=0.2, drop_gate=0.5, blur_gate=0.5,
                 add_gate=0.5, inv_gate=0.4, mul_gate=0.5, mul2_gate=0.5,
                 contrast_gate=0.5)
    for k, p in probs.items():
        f = d[k].float().mean().item()
        assert abs(f - p) < 4 * np.sqrt(p * (1 - p) / n), (k, f)
    assert abs(d['drop_keep'].float().mean().item() - 0.9) < 0.01
    for k, lo, hi in (('blur_sigma', 0, 1.2), ('add', -25, 25),
                      ('mul', 0.6, 1.4), ('mul2', 0.6, 1.4), ('alpha', 0.5, 2.2)):
        assert d[k].min() >= lo and d[k].max() <= hi, k
    # lc_tpu's pipeline on a flat grey image: the share of samples that the
    # additive gate moved matches the port's within the same bound
    out = np.asarray(jaug.color_augment(jnp.full((512, 8, 8, 3), 127.0),
                                        jax.random.PRNGKey(0)))
    changed = np.mean(np.abs(out - 127.0).max(axis=(1, 2, 3)) > 1e-3)
    assert changed > 0.8


def test_training_targets_match():
    """annots_on_the_fly (K = 1) and, with two candidates, select_best_pose's
    3D selection: the same best candidate and GT maps."""
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate
    b = collate(synthetic.render_train_set(2, seed=3, net_input_wh=(64, 64),
                                           net_output_wh=(16, 16)))
    gt = {k: b[k] for k in ('Rt_candi', 'candi_valid', 'homo_z_out', 'K_no_aug',
                            'sym_ck_pts2d', 'noc_scale', 'out_K')}
    gt['msk_noc'] = b['msk_noc_small']
    rng = np.random.default_rng(7)
    out = {'xyz_noc': rng.normal(size=(2, 16, 16, 3)).astype(np.float32)}
    j = jtargets.annots_on_the_fly({k: jnp.asarray(v) for k, v in gt.items()},
                                   {k: jnp.asarray(v) for k, v in out.items()},
                                   step=0)
    t = ttargets.annots_on_the_fly({k: torch.tensor(v) for k, v in gt.items()},
                                   {k: torch.tensor(v) for k, v in out.items()},
                                   step=0)
    for k in ('pose_best', 'xyz_gt', 'xyz_noc_tgt'):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-4,
                                   atol=1e-3, err_msg=k)
    # two candidates: the second is the GT turned by pi about z; the oracle
    # prediction of that turned object must select it
    from lc_tpu_torch.geom.projection import xyz_from_homo_z
    Rz = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    c0 = b['Rt_candi'][:, 0]
    c1 = np.concatenate((c0[..., :3] @ Rz, c0[..., 3:]), -1)
    gt['Rt_candi'] = np.stack((c0, c1), 1)
    gt['candi_valid'] = np.ones((2, 2), bool)
    xyz1 = xyz_from_homo_z(torch.tensor(b['homo_z_out']).reshape(2, -1, 3),
                           torch.tensor(c1[..., :3]), torch.tensor(c1[..., 3]),
                           torch.tensor(b['K_no_aug'])).reshape(2, 16, 16, 3)
    out = {'xyz_noc': (xyz1 / torch.tensor(b['noc_scale'])[:, None, None]).numpy()}
    jb = jtargets.select_best_pose({k: jnp.asarray(v) for k, v in gt.items()},
                                   {k: jnp.asarray(v) for k, v in out.items()},
                                   sym_aware_started=True, bit_cnt=None)
    tb = ttargets.select_best_pose({k: torch.tensor(v) for k, v in gt.items()},
                                   {k: torch.tensor(v) for k, v in out.items()},
                                   sym_aware_started=True)
    np.testing.assert_allclose(tb[0].numpy(), c1, atol=1e-6)
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb[0]), atol=1e-6)


def test_checkpoint_rotation_and_resume(tmp_path):
    """latest-2, best-2 and persist rotations; resume takes the newest
    checkpoint that loads and skips a broken one, while an explicit path that
    does not load raises; finish() exports model_final and model_best and
    clears the resume rotation."""
    import pickle
    from lc_tpu_torch.utils.checkpoint import Checkpoint, model_state_dict
    d = tmp_path / 'ckpts'
    ck = Checkpoint(str(d), persist_period=2)
    for step, score in ((1, -1.0), (2, 0.5), (3, 0.7), (4, 0.6), (5, -1.0)):
        ck.step(lambda: {'model': {'w': torch.full((2,), float(step))}},
                step=step, score=score, aux={'note': step})
    assert sorted(f.name for f in d.glob('*.ckpt')) == ['000000004.ckpt',
                                                      '000000005.ckpt']
    assert sorted(f.name for f in (d / 'best').iterdir()) == [
        '000000002_0.50000.ckpt', '000000003_0.70000.ckpt']
    assert sorted(f.name for f in (d / 'persist').iterdir()) == [
        '000000002.ckpt', '000000004.ckpt']

    (d / '000000005.ckpt').write_bytes(b'not a checkpoint')
    state, aux = Checkpoint(str(d)).resume()
    assert aux['step'] == 4 and aux['note'] == 4
    assert torch.equal(state['model']['w'], torch.full((2,), 4.0))
    with pytest.raises(pickle.UnpicklingError):
        Checkpoint(str(d)).resume(ckpt_path=str(d / '000000005.ckpt'))
    with pytest.raises(OSError):
        Checkpoint(str(d)).resume(ckpt_path=str(d / 'missing.ckpt'))
    assert Checkpoint(str(tmp_path / 'empty')).resume() == (None, {'step': 0})

    ck.finish({'w': torch.ones(2)}, str(tmp_path / 'model_final.ckpt'),
              str(tmp_path / 'model_best'))
    assert torch.equal(model_state_dict(str(tmp_path / 'model_final.ckpt'))['w'],
                       torch.ones(2))
    assert model_state_dict(str(tmp_path / 'model_best_3_0.70000.ckpt'))[
        'w'][0] == 3.0
    assert not list(d.glob('*.ckpt'))
