"""The zebra (Gray-code) training path of the port against lc_tpu: the
straight-through training decode, the binary targets, the binary-code loss
with its histogram, compute_losses' binary branch, one whole train step of
ZebraDeepLabV3, RatioMixLoader (train_dataset_1), and the train CLI on a
zsyn-shaped tree with resume.

Sizes: 64² in, 32² out, batch 2 (the CLI: batch 4), max_bit_cnt 3, so
bit_cnt (3, 3, 2) for the synthetic box. Tolerances, each with its reason:
  * logits_to_noc_with_gt: values atol 1e-6 and the gradient of a random
    cotangent atol 1e-6 (one f32 sigmoid and a few exact sums apart); the
    logits are drawn with |x| >= 0.05, so that no sign is left to rounding;
  * noc_to_nn_target and the targets of annots_on_the_fly: bits equal (the
    same f32 arithmetic; a pixel within rounding of a bin edge is a chance
    of about 1e-5 over this test's pixels); the best pose and xyz_gt as
    tests/test_torch_train.py (rtol 1e-4, atol 1e-3 mm);
  * xyz_bin_loss: the loss rtol 1e-5, the histogram atol 1e-6, the logits'
    gradient atol 1e-7 (entries of order 1e-4);
  * compute_losses on fixed outputs: each term and the total rtol 1e-4, the
    gradient of every output within 1e-4 of its largest entry, the tap's
    norm rtol 1e-4, the histogram atol 1e-6;
  * the whole step, f32 on both sides: the glmo step's tolerances
    (tests/test_torch_train_step.py) for each term (rtol 1e-4), the heads'
    gradients (within 1e-4 of their largest entry), BatchNorm's running
    means (rtol 1e-4) and the new loss state (histogram atol 1e-6, clip
    thresholds rtol 1e-4); below the heads every gradient within
    ZEBRA_GRAD_REL = 2e-2 in relative L2 and grad_norm rtol 1e-2, where
    glmo's step holds 5e-3: this deeper train-mode network's f32 gradients
    are resolved to about 1.4% only, see test_one_zebra_train_step_matches;
    the conv biases in front of a train-mode BatchNorm, whose exact
    gradient is zero, below 1e-5 of the step's largest gradient entry on
    both sides (measured up to 2.7e-6, the image-pooling branch's);
  * RatioMixLoader: every host field bit-equal, from the start and resumed.
"""
import json
import os.path as osp

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import yaml

from lc_tpu import codec as jcodec
from lc_tpu import harness as jharness
from lc_tpu.loss import LossConfig as JLossConfig
from lc_tpu.loss import compute_losses as j_compute_losses
from lc_tpu.loss import init_loss_state as j_init_loss_state
from lc_tpu.loss import zero_taps
from lc_tpu.loss import surrogate as jsur
from lc_tpu.loss import targets as jtargets
from lc_tpu.models import build_model as j_build_model
from lc_tpu.models import layers as jlayers
from lc_tpu.parallel.train_step import create_train_state, make_train_step
from lc_tpu.utils.config import Config as JConfig
from lc_tpu_torch import codec, harness
from lc_tpu_torch.codec import calc_bit_count
from lc_tpu_torch.data import synthetic
from lc_tpu_torch.data.pipeline import collate
from lc_tpu_torch.loss import surrogate
from lc_tpu_torch.loss import targets as ttargets
from lc_tpu_torch.loss.loss_fn import LossConfig, compute_losses, \
    init_loss_state, make_taps
from lc_tpu_torch.models import build_model
from lc_tpu_torch.models.layers import BatchNorm2d, Conv2d, Deconv2x
from lc_tpu_torch.models.weights import init_weights, random_flax_variables, \
    state_dict_from_flax
from lc_tpu_torch.train_step import train_step

IN_WH, OUT_WH = (64, 64), (32, 32)
HALF = np.array([40.0, 30.0, 20.0], np.float32)
BIT_CNT = tuple(calc_bit_count(HALF.tolist(), max_bits=3))       # (3, 3, 2)
ZEBRA_CFG = {'concat': True, 'output_kernel_size': 1}
HEADS = ('net.aspp.conv_1x1_4', 'weight_scale_layer')
GRAD_REL_BELOW_HEADS = 5e-3
ZEBRA_GRAD_REL = 2e-2
LOSS_KW = dict(w_loss_noc_bin=3.0, w_loss_seg=1.0, w_loss_pose=0.03,
               seg_loss_type='l1', full_pose_loss_step=0, dense_sample=3,
               clip_weight_grad=True, bit_cnt=BIT_CNT, black_background=True)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def _logits(rng, shape):
    """Logits with |x| in [0.05, 3): no sign decided by rounding."""
    return (rng.choice([-1.0, 1.0], shape)
            * rng.uniform(0.05, 3.0, shape)).astype(np.float32)


@pytest.mark.parametrize('black_background', [False, True])
def test_logits_to_noc_with_gt_matches(black_background):
    """The straight-through decode: values, and the gradient of a random
    cotangent, inside and outside the GT mask. Inside, only the most
    significant wrong bit's logit carries a gradient; outside, none."""
    rng = np.random.default_rng(int(black_background))
    shape = (2, 24, 24)
    logits = _logits(rng, shape + (sum(BIT_CNT),))
    noc = rng.uniform(-1, 1, shape + (3,)).astype(np.float32)
    _, raw = codec.noc_to_bits(torch.from_numpy(noc), BIT_CNT, False)
    raw = raw.numpy()
    mask = rng.random(shape) < 0.6
    cot = rng.normal(size=shape + (3,)).astype(np.float32)

    def jf(x):
        return jcodec.logits_to_noc_with_gt(
            x, jnp.asarray(raw), BIT_CNT, jnp.asarray(mask), black_background)
    jv, jvjp = jax.vjp(jf, jnp.asarray(logits))
    jg = np.asarray(jvjp(jnp.asarray(cot))[0])

    x = torch.tensor(logits, requires_grad=True)
    tv = codec.logits_to_noc_with_gt(x, torch.from_numpy(raw), BIT_CNT,
                                     torch.from_numpy(mask), black_background)
    tv.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), jg, atol=1e-6)
    g = x.grad.numpy()
    assert not g[~mask].any()
    # one logit per axis inside the mask
    starts = np.cumsum((0,) + BIT_CNT)
    for a in range(3):
        nz = (g[mask][:, starts[a]:starts[a + 1]] != 0).sum(-1)
        assert (nz == 1).all()


@pytest.mark.parametrize('black_background', [False, True])
def test_noc_to_nn_target_bit_equal(black_background):
    rng = np.random.default_rng(3)
    noc = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jt, jr = jcodec.noc_to_nn_target(jnp.asarray(noc), BIT_CNT,
                                     black_background)
    tt, tr = codec.noc_to_nn_target(torch.from_numpy(noc), BIT_CNT,
                                    black_background)
    assert tt.dtype == torch.float32 and tr.dtype == torch.bool
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_xyz_bin_loss_matches():
    """Two calls in a row, so the histogram's EMA moves from a state that is
    not its initial 0.5."""
    rng = np.random.default_rng(4)
    C = sum(BIT_CNT)
    hist_j = jsur.init_bin_histogram(C)
    hist_t = surrogate.init_bin_histogram(C)
    assert hist_t.shape == (C,) and (hist_t == 0.5).all()
    for _ in range(2):
        logits = _logits(rng, (2, 16, 16, C))
        gt = (rng.random((2, 16, 16, C)) < 0.5).astype(np.float32)
        vis = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
        (jl, jh), jg = jax.value_and_grad(
            lambda x: jsur.xyz_bin_loss(x, jnp.asarray(gt), jnp.asarray(vis),
                                        hist_j), has_aux=True)(
            jnp.asarray(logits))
        x = torch.tensor(logits, requires_grad=True)
        tl, th = surrogate.xyz_bin_loss(x, torch.from_numpy(gt),
                                        torch.from_numpy(vis), hist_t)
        tl.backward()
        assert not th.requires_grad
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-7)
        hist_j, hist_t = jh, th
    assert np.abs(hist_t.numpy() - 0.5).max() > 1e-3
    # bf16 logits: the loss is computed in f32
    lb, _ = surrogate.xyz_bin_loss(torch.from_numpy(logits).bfloat16(),
                                   torch.from_numpy(gt),
                                   torch.from_numpy(vis), hist_t)
    assert lb.dtype == torch.float32


def _gt_batch(seed=5, symmetric=True, model_transform=False, B=2):
    """A rendered training batch at 64² in, 32² out (the symmetric box: 2
    candidates), as the gt dict of a step; optionally with a rigid
    model_transform (the frame Gray codes are made in)."""
    b = collate(synthetic.render_train_set(B, seed=seed, net_input_wh=IN_WH,
                                           net_output_wh=OUT_WH,
                                           symmetric=symmetric))
    gt = {k: b[k] for k in ('Rt_candi', 'candi_valid', 'homo_z_out',
                            'K_no_aug', 'sym_ck_pts2d', 'noc_scale', 'out_K',
                            'bbox_3d')}
    gt['msk_vis'] = b['msk_vis_small']
    gt['msk_noc'] = b['msk_noc_small']
    if model_transform:
        from scipy.spatial.transform import Rotation as sciR
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = sciR.from_rotvec([0.3, -0.2, 0.5]).as_matrix()
        m[:3, 3] = [2.0, -1.0, 3.0]
        gt['model_transform'] = np.repeat(m[None], B, 0)
        # the canonical frame's scale holds the turned box
        gt['noc_scale'] = gt['noc_scale'] * 1.3
    return gt


def _random_out(rng, h=OUT_WH[1], w=OUT_WH[0], B=2):
    return {'xyz_noc_bin': _logits(rng, (B, h, w, sum(BIT_CNT))),
            'xyz_weight_logits': rng.normal(size=(B, h, w, 2))
            .astype(np.float32),
            'xyz_weights_scale': np.exp(rng.normal(size=(B, 1, 1, 1)))
            .astype(np.float32) * 100,
            'msk_vis_logits': rng.normal(size=(B, h, w, 1)).astype(np.float32)}


@pytest.mark.parametrize('case', ['plain', 'symmetric', 'transform'])
def test_annots_on_the_fly_with_bits(case):
    """Gray-code targets of both packages on the same batch and random
    predictions: with one candidate, with the symmetric box's two (the
    binary branch of select_best_pose decodes the check points with the
    soft LSB), and with a model_transform."""
    gt = _gt_batch(symmetric=case != 'plain',
                   model_transform=case == 'transform')
    out = _random_out(np.random.default_rng(6))
    kw = dict(step=0, sym_aware_start=0, bit_cnt=BIT_CNT,
              black_background=True)
    j = jtargets.annots_on_the_fly(_j(gt), _j(out), **kw)
    t = ttargets.annots_on_the_fly(_t(gt), _t(out), **kw)
    assert set(t) == set(j) == {'Rt_best', 'pose_best', 'xyz_gt',
                                'xyz_noc_bin_tgt', 'xyz_noc_bin_raw'}
    for k in ('Rt_best', 'pose_best', 'xyz_gt'):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-4,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(t['xyz_noc_bin_tgt'].numpy(),
                                  np.asarray(j['xyz_noc_bin_tgt']))
    np.testing.assert_array_equal(t['xyz_noc_bin_raw'].numpy(),
                                  np.asarray(j['xyz_noc_bin_raw']))
    assert gt['Rt_candi'].shape[1] == (1 if case == 'plain' else 2)


def test_compute_losses_binary_matches():
    """compute_losses' binary branch on fixed outputs and gt (lc_tpu's
    annotations), the histogram moved from 0.5 by a first call: each term,
    the total, the new histogram, the weight tap's norm and the gradient of
    every output."""
    gt = _gt_batch(symmetric=True)
    rng = np.random.default_rng(8)
    out = _random_out(rng)
    gt = dict(gt, **{k: np.asarray(v) for k, v in jtargets.annots_on_the_fly(
        _j(gt), _j(out), step=0, bit_cnt=BIT_CNT,
        black_background=True).items()})
    jcfg, tcfg = JLossConfig(**LOSS_KW), LossConfig(**LOSS_KW)
    hist = np.clip(0.5 + 0.3 * rng.normal(size=sum(BIT_CNT)), 0.01, 0.99) \
        .astype(np.float32)
    jstate = j_init_loss_state(jcfg)._replace(histogram=jnp.asarray(hist))
    tstate = init_loss_state(tcfg)._replace(histogram=torch.from_numpy(hist))
    top_left = (1, 2)

    def jloss(o, taps):
        total, terms, st = j_compute_losses(jcfg, _j(gt), o, jstate, 0, taps,
                                            sample_top_left=top_left)
        return total, (terms, st)
    (jtot, (jterms, jst)), (jgo, jgt) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(_j(out), zero_taps())

    tout = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    taps = make_taps()
    ttot, tterms, tst = compute_losses(tcfg, _t(gt), tout, tstate, 0, taps,
                                       sample_top_left=top_left)
    ttot.backward()
    assert set(tterms) == set(jterms) == {'loss_noc_bin', 'loss_seg',
                                          'loss_pose'}
    np.testing.assert_allclose(ttot.item(), float(jtot), rtol=1e-4)
    for k, v in tterms.items():
        np.testing.assert_allclose(v.item(), float(jterms[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(tst.histogram.numpy(),
                               np.asarray(jst.histogram), atol=1e-6)
    np.testing.assert_allclose(taps['weight'].grad.item(),
                               float(jgt['weight']), rtol=1e-4)
    for k, v in tout.items():
        g = np.asarray(jgo[k])
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(v.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


@pytest.fixture
def f32_reference():
    jlayers.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jlayers.set_compute_dtype(jnp.bfloat16)


@pytest.fixture
def two_pass_batchnorm():
    """lc_tpu's BatchNorm computing its batch variance in two passes,
    E[(x − E[x])²], as torch does, instead of flax's default one-pass
    E[x²] − E[x]² (use_fast_variance), whose cancellation in f32 puts
    lc_tpu's zebra gradients 0.7-4.1% from an f64 run of the port where
    the port's f32 lies 0.1-1.4% from it."""
    kw = jlayers.BatchNorm.keywords
    kw['use_fast_variance'] = False
    try:
        yield
    finally:
        del kw['use_fast_variance']


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _recording_tx():
    """An optax transformation that leaves the parameters as they are and
    keeps the step's gradients as its state."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def whole_step_case(net_name, net_config, gt, variables, loss_kw, *,
                    sym_aware_start=0, **model_kw):
    """One step of lc_tpu's make_train_step (its gradients kept by
    _recording_tx) and one of the port's train_step (SGD at lr 0, so its
    .grad stays) in f32 on the same weights, batch and sampling offset.
    Returns (lc_tpu's metrics, new loss state, gradients and batch_stats in
    torch layout; the port's model, metrics and new loss state)."""
    jmodel = j_build_model(net_name, net_config, **model_kw)
    jcfg = JLossConfig(**loss_kw)
    jvars = jax.tree.map(jnp.asarray, variables)
    state = create_train_state(jmodel, _recording_tx(), jax.random.PRNGKey(0),
                               jnp.asarray(gt['img_in'][:1]), jcfg)
    state = state._replace(params=jvars['params'],
                           batch_stats=jvars['batch_stats'])
    key = jax.random.PRNGKey(11)
    top_left = tuple(int(v) for v in jax.random.randint(
        jax.random.split(key)[0], (2,), 0, jcfg.dense_sample))
    step_fn = make_train_step(jmodel, _recording_tx(), jcfg,
                              sym_aware_start=sym_aware_start, donate=False)
    jnew, jmetrics = step_fn(state, _j(gt), key)
    sd_kw = dict(net_name=net_name, sparse_cnt=model_kw.get('sparse_cnt', 0))
    jgrads = state_dict_from_flax(
        {'params': jax.tree.map(np.asarray, jnew.opt_state),
         'batch_stats': jax.tree.map(np.asarray, jnew.batch_stats)}, **sd_kw)

    model = build_model(net_name, net_config, **model_kw).train()
    model.load_state_dict(state_dict_from_flax(variables, **sd_kw))
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    tcfg = LossConfig(**loss_kw)
    tstate, tmetrics = train_step(model, opt, sched, tcfg,
                                  init_loss_state(tcfg), _t(gt), 0, top_left,
                                  sym_aware_start=sym_aware_start)
    return ({k: float(v) for k, v in jmetrics.items()}, jnew.loss_state,
            jgrads, model, {k: float(v) for k, v in tmetrics.items()}, tstate)


def check_whole_step(case, heads, terms, loss_w, grad_rel, grad_norm_rtol):
    """The port's step against lc_tpu's: the terms, the total, grad_norm,
    every gradient (the heads' within 1e-4 of their largest entry, all
    within grad_rel in relative L2 but those whose exact value is zero),
    BatchNorm's running means and the new loss state."""
    jm, jstate, jgrads, model, tm, tstate = case
    assert set(tm) == set(terms) | {'loss', 'grad_norm'}
    assert set(jm) == set(terms) | {'grad_norm'}
    for k in terms:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(
        tm['loss'], sum(jm[k] * w for k, w in loss_w.items()), rtol=1e-4)
    np.testing.assert_allclose(tm['grad_norm'], jm['grad_norm'],
                               rtol=grad_norm_rtol)
    g_max = max(float(np.abs(g.numpy()).max()) for n, g in jgrads.items()
                if 'running' not in n)
    for name, p in model.named_parameters():
        g, mine = jgrads[name].numpy(), p.grad.numpy()
        if np.abs(g).max() < 1e-5 * g_max:
            # a bias in front of a train-mode BatchNorm: zero gradient, f32
            # rounding on both sides
            assert np.abs(mine).max() < 1e-5 * g_max, name
            continue
        if name.startswith(heads):
            np.testing.assert_allclose(mine, g, rtol=0,
                                       atol=1e-4 * np.abs(g).max(),
                                       err_msg=name)
        assert _rel(mine, g) <= grad_rel, (name, _rel(mine, g))
    sd = model.state_dict()
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            np.testing.assert_allclose(sd[f'{name}.running_mean'].numpy(),
                                       jgrads[f'{name}.running_mean'].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    if jstate.histogram is None:
        assert tstate.histogram is None
    else:
        np.testing.assert_allclose(tstate.histogram.numpy(),
                                   np.asarray(jstate.histogram), atol=1e-6)
    for f in ('weight_clip', 'scale_clip', 'pts_clip'):
        for a, b in zip(getattr(tstate, f), getattr(jstate, f)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       err_msg=f)


def test_one_zebra_train_step_matches(f32_reference, two_pass_batchnorm):
    """One whole step of ZebraDeepLabV3 (zlmo's losses: binary-code BCE,
    L1 segmentation, the LC loss on the straight-through decode at
    dense_sample 3, black_background) in f32, against lc_tpu's
    make_train_step: the loss terms, grad_norm, every gradient, BatchNorm's
    running means, and the new histogram and clip thresholds. The
    symmetric box's two candidates, selected from the start.

    Below the heads: ZEBRA_GRAD_REL = 2e-2. Readings of this case (CPU,
    per tensor, relative L2): the port's f32 gradients lie 0.13-1.37% from
    the port's own f64 step (median 0.94% in the backbone), so f32 resolves
    this network's gradients to ~1.4% only (glmo's: 1.24%); lc_tpu with
    two-pass BatchNorm lies 0.3-1.26% from the port (0.7-4.1% with flax's
    one-pass variance, hence two_pass_batchnorm). grad_norm: 0.36% between
    the port's f32 and f64 steps."""
    gt = _gt_batch(symmetric=True)
    gt['img_in'] = np.random.default_rng(0).normal(
        size=(2,) + IN_WH[::-1] + (3,)).astype(np.float32)
    variables = random_flax_variables(seed=2, net_name='zebra_DeepLabV3',
                                      total_bit_cnt=sum(BIT_CNT))
    case = whole_step_case('zebra_DeepLabV3', ZEBRA_CFG, gt, variables,
                           LOSS_KW, total_bit_cnt=sum(BIT_CNT))
    check_whole_step(case, HEADS, ('loss_noc_bin', 'loss_seg', 'loss_pose'),
                     {'loss_noc_bin': 3.0, 'loss_seg': 1.0,
                      'loss_pose': 0.03}, ZEBRA_GRAD_REL, 1e-2)
    assert np.abs(case[5].histogram.numpy() - 0.5).max() > 0


def test_zebra_init_reaches_every_convolution():
    """init_weights draws every convolution and deconvolution of the zebra
    network from N(0, 0.001²) (lc_tpu's conv_init): none keeps torch's
    default initialization."""
    model = build_model('zebra_DeepLabV3', ZEBRA_CFG,
                        total_bit_cnt=sum(BIT_CNT))
    init_weights(model, torch.Generator().manual_seed(0))
    convs = [(n, m) for n, m in model.named_modules()
             if isinstance(m, torch.nn.modules.conv._ConvNd)]
    assert len(convs) > 40
    for name, m in convs:
        assert isinstance(m, (Conv2d, Deconv2x)), name
        assert abs(float(m.weight.std()) - 0.001) < 2e-4, name
        assert m.bias is None or not m.bias.any(), name


# --------------------------------------------------------------------------
# RatioMixLoader and the train CLI on a zsyn-shaped tree
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def zsyn_tree(tmp_path_factory):
    """A symmetric synthetic tree: two training splits (train_syn for
    train_dataset, train_pbr for train_dataset_1) and a test split."""
    root = str(tmp_path_factory.mktemp('zsyn'))
    synthetic.generate_dataset(root, n_images=6, split='train_syn', seed=0,
                               symmetric=True)
    synthetic.generate_dataset(root, n_images=6, split='train_pbr', seed=1,
                               symmetric=True)
    synthetic.generate_dataset(root, n_images=4, split='test_syn', seed=2,
                               symmetric=True, list_name='test_list.txt')
    return root


def zsyn_cfg(root, **overrides):
    """configs/zsyn.yaml cut to 64² in, 32² out, batch 4, max_bit_cnt 3,
    three steps, with train_pbr mixed in as train_dataset_1 at ratio 0.75."""
    here = osp.dirname(osp.dirname(osp.abspath(__file__)))
    from lc_tpu_torch.utils.config import load_config
    cfg = load_config(osp.join(here, 'configs', 'zsyn.yaml'))
    cfg.merge_from_dict({
        'max_bit_cnt': 3, 'net_input_wh': list(IN_WH),
        'net_output_wh': list(OUT_WH), 'dataloader.batch_size': 4,
        'dataloader.num_workers': 2, 'train.num_steps': 3,
        'train.test_every': 2, 'train.ckpt_every': 1,
        'loss.pose_loss_start_step': 1,
        'train_dataset.dataset_root': root,
        'train_dataset.list_files': [osp.join(root, 'train_syn_list.txt')],
        'train_dataset.valid_pix_cnt_th': 30,
        'train_dataset_1': {'name': 'synthetic_sym', 'ratio': 0.75,
                            'list_files': [osp.join(root,
                                                    'train_pbr_list.txt')]},
        'test_dataset.dataset_root': root,
        'test_dataset.list_files': [osp.join(root, 'test_list.txt')]})
    cfg.merge_from_dict(overrides)
    return cfg


def test_ratio_mix_loader_matches_lc_tpu(zsyn_tree):
    """harness.make_datasets with train_dataset_1 in both packages, the same
    seed: every field of the first two mixed batches bit-equal (1 crop of
    train_dataset, then 3 of train_dataset_1, each a symmetric box with 2
    candidates), then again after set_position(3) on fresh loaders, which
    restarts train_dataset_1's 2-batch stream in its second epoch."""
    cfg = zsyn_cfg(zsyn_tree)
    jcfg = JConfig(cfg.to_dict())
    tds, tl = harness.make_datasets(cfg, train=True, seed=3)
    jds, jl = jharness.make_datasets(jcfg, train=True, seed=3)
    assert isinstance(tl, harness.RatioMixLoader)
    assert [x.batch_size for x in tl.loaders] == [1, 3]
    assert [x.num_threads for x in tl.loaders] == [1, 1]
    assert len(tl) == len(jl) == 6
    assert tds.bit_cnt == jds.bit_cnt == BIT_CNT

    def same(tb, jb):
        assert set(tb) == set(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert len(tb['obj_id']) == 4 and tb['Rt_candi'].shape[1] == 2

    for _ in range(2):
        same(next(tl), next(jl))
    _, tl = harness.make_datasets(cfg, train=True, seed=3)
    _, jl = jharness.make_datasets(jcfg, train=True, seed=3)
    tl.set_position(3)
    jl.set_position(3)
    for _ in range(2):
        same(next(tl), next(jl))


def test_ratio_mix_pads_candidates():
    """Sub-batches of 1 and 2 candidates: the mixed batch carries 2, the
    padding repeats candidate 0 and is marked not valid."""
    a = {'Rt_candi': np.ones((1, 1, 3, 4), np.float32),
         'candi_valid': np.ones((1, 1), bool)}
    b = {'Rt_candi': np.zeros((3, 2, 3, 4), np.float32),
         'candi_valid': np.ones((3, 2), bool)}
    mix = harness.RatioMixLoader([a], [b])
    out = next(mix)
    assert out['Rt_candi'].shape == (4, 2, 3, 4)
    np.testing.assert_array_equal(out['Rt_candi'][0, 1], 1.0)
    np.testing.assert_array_equal(out['candi_valid'],
                                  [[True, False]] + [[True, True]] * 3)


def test_train_cli_zsyn_resume_and_test(zsyn_tree, tmp_path, monkeypatch):
    """python -m lc_tpu_torch.train --device cpu on the zsyn-shaped tree
    (RatioMixLoader, sym_aware from step 0, max_bit_cnt 3): three steps with
    an evaluation after step 2; a run cut after its second step and resumed
    from its checkpoint without device prefetch repeats the third step's
    metrics exactly, its checkpoint holding the histogram and the clip
    thresholds; then lc_tpu_torch.test on model_final."""
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch import train as train_cli
    from lc_tpu_torch.utils.checkpoint import load_checkpoint
    cfg_path = tmp_path / 'zsyn.yaml'
    cfg_path.write_text(yaml.safe_dump(zsyn_cfg(zsyn_tree).to_dict()))
    base = ['--config', str(cfg_path), '--device', 'cpu']

    out_a = tmp_path / 'a'
    train_cli.main(base + ['--output', str(out_a)])
    exp_a = out_a / 'zsyn-1'
    lines_a = [json.loads(x) for x in
               (exp_a / 'metrics.jsonl').read_text().splitlines()]
    assert [m['step'] for m in lines_a] == [1, 3]
    assert set(lines_a[0]) == {'step', 'loss', 'grad_norm', 'loss_noc_bin',
                               'loss_seg', 'loss_pose'}
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
    ckpt = out_b / 'zsyn-1' / 'ckpts' / '000000002.ckpt'
    saved = load_checkpoint(str(ckpt))['state']['loss_state']
    assert saved.histogram.shape == (sum(BIT_CNT),)
    assert np.abs(saved.histogram.numpy() - 0.5).max() > 0
    assert float(saved.weight_clip.max_norm) > 0
    # the resumed run stages each batch when its step takes it (no
    # prefetch): the same metrics
    monkeypatch.setattr(train_cli, 'PREFETCH_BATCHES', 0)
    train_cli.main(base + ['--output', str(out_b), '--resume'])
    lines_b = [json.loads(x) for x in
               (out_b / 'zsyn-1' / 'metrics.jsonl').read_text().splitlines()]
    assert lines_b[-1] == lines_a[-1]

    results = test_cli.main(['--weight', str(exp_a / 'model_final.ckpt'),
                             '--config', str(cfg_path), '--output',
                             str(tmp_path / 'test'), '--obj', '1',
                             '--device', 'cpu'])
    assert len(results['weighted-filtered']['errors']) == 4


def test_mploader_still_raises(zsyn_tree):
    """dataloader.multiprocess: make_datasets builds the process-pool
    MPLoader, on num_workers workers, with the loader's dataset returned
    (it no longer raises; the name is kept). A config with train_dataset_1
    keeps the RatioMixLoader whatever multiprocess says, as lc_tpu's
    make_datasets returns that branch first."""
    from lc_tpu_torch.data.pipeline import MPLoader
    cfg = zsyn_cfg(zsyn_tree, **{'dataloader.multiprocess': True})
    _, mix = harness.make_datasets(cfg, train=True)
    assert isinstance(mix, harness.RatioMixLoader)
    del cfg['train_dataset_1']
    ds, loader = harness.make_datasets(cfg, train=True, seed=3)
    try:
        assert isinstance(loader, MPLoader)
        assert ds is loader.ds and ds.bit_cnt == BIT_CNT
        assert loader._pool._max_workers == 2 and loader.seed == 3
        batch = next(iter(loader))
        assert len(batch['obj_id']) == 4
    finally:
        loader.close()
