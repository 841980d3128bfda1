"""The port's int8 inference (models/quant.py) against lc_tpu's
(lc_tpu/models/quant.py), on the CPU, where the int8 product is the exact
float64 convolution of the int8 values (torch._int_mm runs on the card).

Tolerances, each with its reason:
  * quantize_tensor: q and scale equal to lc_tpu's;
  * on the int8 grid (integer weights with a per-channel max of 127,
    integer activations with max 127: every scale exactly 1), the int8
    conv, deconv and stem (odd and even input sizes) equal the f32
    computation bit for bit (int32 accumulation and f32 sums of integers
    below 2²⁴ are exact), as tests/test_quant.py holds lc_tpu;
  * per-sample scales: a sample's output is bit-equal alone and beside a
    1000x larger batchmate; static scales calibrated on a batch of 1 give
    the dynamic output bit for bit;
  * one quantized layer (3x3 at stride 1 and 2, 1x1 downsample, dilated,
    an output head with bias, the deconvolution) on the same non-grid
    input: lc_tpu's output bit for bit;
  * a whole CDPN forward at 64² (f32 compute on both sides, lc_tpu's
    compute dtype set to f32, dynamic scales): the three maps within 0.06
    and the weight scale within 5e-3 relative RMS of lc_tpu's int8 forward
    (measured 0.022-0.033 and 7.9e-4). The quantized network does not
    keep rounding-level differences small: the f32 layers between the
    convolutions (BatchNorm, sums in another order) differ at 1e-6, which
    moves activations across rounding boundaries of the int8 grid, and
    those steps of 1/127 of a tensor's range grow through 40 layers. The
    port's own int8 forward moves as far (0.025-0.034) when its input is
    perturbed by 1e-6 relative; its int8 error against f32 is 0.03-0.05.
    A wrong scale or dequantization is off by orders of magnitude;
  * int8 against f32 within 6x the bf16 forward's own error + 5e-3
    (lc_tpu's yardstick, tests/test_quant.py:212-257), for CDPN; zebra
    under `slow` as there.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from lc_tpu.models import build_model as j_build_model
from lc_tpu.models import layers as jlayers
from lc_tpu.models import quant as JQ
from lc_tpu_torch import harness
from lc_tpu_torch.data import synthetic
from lc_tpu_torch.data.pipeline import collate
from lc_tpu_torch.eval.evaluator import Evaluator
from lc_tpu_torch.models import build_model, quant as Q, set_compute_dtype
from lc_tpu_torch.models.layers import Conv2d, Deconv2x, StemConv2d
from lc_tpu_torch.models.weights import random_flax_variables, \
    state_dict_from_flax
from lc_tpu_torch.utils.config import Config


def _rel_rms(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / (np.sqrt(np.mean(a ** 2)) + 1e-30))


def _int_weights(rng, shape):
    """Integers in [-127, 127] with each output channel's max pinned at 127
    (torch layouts: output channel first for a conv)."""
    w = rng.integers(-127, 128, shape).astype(np.float32)
    w[:, 0, 0, 0] = 127.0
    return w


def _int_input(rng, shape):
    x = rng.integers(-127, 128, shape).astype(np.float32)
    x[:, 0, 0, 0] = 127.0
    return torch.from_numpy(x)


def test_quantize_tensor_matches_lc_tpu():
    """Per-tensor, per-output-channel (torch (O, I, kh, kw) against lc_tpu
    (kh, kw, I, O)) and a dead channel: q and scale equal."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1, (8, 4, 3, 3)).astype(np.float32)
    w[3] = 0.0
    q, s = Q.quantize_tensor(torch.from_numpy(w), dim=(1, 2, 3))
    jq, js = JQ.quantize_tensor(jnp.asarray(w.transpose(2, 3, 1, 0)),
                                axes=(0, 1, 2))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.all(q[3].numpy() == 0) and np.isfinite(s[3].item())
    x = rng.normal(0, 3, (4, 5)).astype(np.float32)
    q, s = Q.quantize_tensor(torch.from_numpy(x))
    jq, js = JQ.quantize_tensor(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)


@pytest.mark.parametrize('stride,pad,dil', [(1, 1, 1), (2, 1, 1), (1, 2, 2),
                                            (1, 0, 1)])
def test_conv_exact_on_int_grid(stride, pad, dil):
    rng = np.random.default_rng(2)
    x = _int_input(rng, (1, 4, 9, 9))
    m = Conv2d(4, 6, 3, stride, pad, dilation=dil, bias=True)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(_int_weights(rng, (6, 4, 3, 3))))
        m.bias.copy_(torch.from_numpy(rng.normal(0, 1, 6).astype(np.float32)))
        ref = m(x)
        with Q.quantized_int8(m):
            got = m(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize('shape', [
    (3, 5, 9, 9, 6, 3, 1, 1, 1),          # (B, C, H, W, O, k, s, p, d)
    (2, 3, 17, 17, 64, 7, 2, 3, 1),       # an odd-size stem
    (4, 16, 12, 12, 23, 3, 1, 6, 6),      # dilated, N off the multiple of 8
    (2, 256, 8, 8, 256, 1, 2, 0, 1),      # 1x1 downsample
    (1, 3, 5, 5, 3, 3, 1, 1, 1)],         # M below 17
    ids=str)
def test_int_mm_im2col_equals_reference(shape, monkeypatch):
    """The card's route (an int8 im2col through torch._int_mm, K and N
    padded to multiples of 8, M beyond 16, chunks of samples) runs on the
    CPU too: its accumulators equal the plain version's exactly, with the
    chunk forced to one sample."""
    B, C, H, W, O, k, s, p, d = shape
    g = torch.Generator().manual_seed(sum(shape))
    xq = torch.randint(-127, 128, (B, C, H, W), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (O, C, k, k), generator=g, dtype=torch.int8)
    monkeypatch.setattr(Q, 'IM2COL_CHUNK_BYTES', 1)
    got = Q._int_mm_conv(xq, wq, (s, s), (p, p), (d, d))
    ref = Q.int8_conv_reference(xq, wq, (s, s), (p, p), (d, d))
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    xd = Q.deconv_input(xq)
    assert torch.equal(Q._int_mm_conv(xd, wq[:, :, :3, :3], (1, 1), (0, 0),
                                      (1, 1)),
                       Q.int8_conv_reference(xd, wq[:, :, :3, :3]))


def test_deconv_exact_on_int_grid():
    rng = np.random.default_rng(3)
    x = _int_input(rng, (1, 4, 8, 8))
    m = Deconv2x(4, 6)
    w = rng.integers(-127, 128, (4, 6, 3, 3)).astype(np.float32)
    w[0, :, 0, 0] = 127.0                        # the per-output max
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
        ref = m(x)
        with Q.quantized_int8(m):
            got = m(x)
    assert got.shape == (1, 6, 16, 16)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize('size', [16, 17])
def test_stem_by_input_size(size):
    """The stem is int8 only at odd sizes (lc_tpu computes the even-size
    stem in its space-to-depth form, never quantized). On the int grid it
    is exact at either size; off the grid the even-size stem is the f32
    forward bit for bit, the odd-size one lc_tpu's quantized nn.Conv."""
    rng = np.random.default_rng(4)
    m = StemConv2d(3, 8, 7, 2, 3, bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(_int_weights(rng, (8, 3, 7, 7))))
        x = _int_input(rng, (1, 3, size, size))
        with Q.quantized_int8(m):
            torch.testing.assert_close(m(x), _plain(m, x), rtol=0, atol=0)
        x = torch.from_numpy(rng.normal(0, 1, (2, 3, size, size))
                             .astype(np.float32))
        with Q.quantized_int8(m):
            got = m(x)
    assert Q.quantizable(m, x) == (size % 2 == 1)
    if size % 2 == 0:
        torch.testing.assert_close(got, _plain(m, x), rtol=0, atol=0)
        return
    jm = nn.Conv(8, (7, 7), strides=(2, 2), padding=((3, 3), (3, 3)),
                 use_bias=False, dtype=jnp.float32)
    v = {'params': {'kernel': jnp.asarray(
        m.weight.detach().numpy().transpose(2, 3, 1, 0))}}
    with JQ.quantized_int8():
        ref = jm.apply(v, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-6, atol=1e-6)


def _plain(m, x):
    """m's forward outside any int8 context."""
    token = Q.layers.INT8_MODE.set(None)
    try:
        return m(x)
    finally:
        Q.layers.INT8_MODE.reset(token)


@pytest.mark.parametrize('kind', ['conv', 'deconv'])
def test_per_sample_scale_batch_independence(kind):
    rng = np.random.default_rng(9)
    small = rng.normal(0, 1, (1, 4, 8, 8)).astype(np.float32)
    big = 1000.0 * rng.normal(0, 1, (1, 4, 8, 8)).astype(np.float32)
    torch.manual_seed(0)
    m = Conv2d(4, 6, 3, 1, 1) if kind == 'conv' else Deconv2x(4, 6)
    with torch.no_grad(), Q.quantized_int8(m):
        alone = m(torch.from_numpy(small))
        paired = m(torch.from_numpy(np.concatenate((small, big))))
    torch.testing.assert_close(alone[0], paired[0], rtol=0, atol=0)


class _OneConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = Conv2d(8, 16, 3, 1, 1)
        self.d = Deconv2x(16, 8)

    def forward(self, z):
        return self.d(self.c(z))


def test_static_equals_dynamic_at_batch_one():
    """Scales calibrated on the one sample are its dynamic scales: the
    static forward equals the dynamic one bit for bit."""
    torch.manual_seed(2)
    m = _OneConv()
    x = torch.randn(1, 8, 16, 16) * 2
    with torch.no_grad():
        scales = Q.calibrate_act_scales(m, [x])
        assert set(scales) == {'c', 'd'}
        with Q.quantized_int8(m):
            dyn = m(x)
        with Q.quantized_int8(m, act_scales=scales):
            st = m(x)
    assert dyn.std() > 0
    torch.testing.assert_close(st, dyn, rtol=0, atol=0)


def _cdpn(seed=1, concat=False):
    variables = random_flax_variables(seed=seed, concat=concat)
    model = build_model('cdpn_resnet', {'concat': concat}).eval()
    model.load_state_dict(state_dict_from_flax(variables, concat))
    return model, variables


@pytest.mark.parametrize('size', [32, 33])
def test_calibration_keys_and_counts(size):
    """CDPN-ResNet34 has 44 convolutions; int8 takes 43 at an even input
    size (not the stem) and 44 at an odd one (README's counts of lc_tpu).
    Every calibrated name is consumed: scales poisoned to NaN make the
    outputs NaN."""
    model, _ = _cdpn()
    convs = [n for n, m in model.named_modules()
             if isinstance(m, (Conv2d, Deconv2x))]
    assert len(convs) == 44
    x = torch.randn(1, size, size, 3, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        scales = Q.calibrate_act_scales(model, [x])
        expect = set(convs) - ({'net.backbone.conv1'} if size % 2 == 0
                               else set())
        assert set(scales) == expect
        poisoned = {k: torch.tensor(float('nan')) for k in scales}
        with Q.quantized_int8(model, act_scales=poisoned):
            out = model(x)
    assert not torch.isfinite(out['xyz_noc']).all()


def test_zebra_quantizes_48_of_49():
    model = build_model('zebra_DeepLabV3', {'concat': True},
                        total_bit_cnt=12).eval()
    convs = [n for n, m in model.named_modules()
             if isinstance(m, (Conv2d, Deconv2x))]
    with torch.no_grad():
        scales = Q.calibrate_act_scales(model, [torch.randn(1, 32, 32, 3)])
    assert len(convs) == 49
    assert set(scales) == set(convs) - {'net.resnet.resnet_layer_1.0'}


@pytest.fixture(scope='module')
def cdpn_pair():
    """The CDPN's forwards at 64²: lc_tpu's int8 (dynamic, f32 compute);
    the port's f32, bf16, int8 dynamic and int8 with static scales
    calibrated on two other batches."""
    model, variables = _cdpn(seed=3)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    calib = [torch.from_numpy(rng.normal(0, 1, (2, 64, 64, 3))
                              .astype(np.float32)) for _ in range(2)]
    jmodel = j_build_model('cdpn_resnet', {'concat': False})
    jlayers.set_compute_dtype(jnp.float32)
    try:
        with JQ.quantized_int8():
            j_dyn = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
                jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    finally:
        jlayers.set_compute_dtype(jnp.bfloat16)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        t_f32 = model(tx)
        with Q.quantized_int8(model):
            t_dyn = model(tx)
        scales = Q.calibrate_act_scales(model, calib)
        with Q.quantized_int8(model, act_scales=scales):
            t_st = model(tx)
        set_compute_dtype(model, torch.bfloat16)
        t_bf16 = model(tx)
        set_compute_dtype(model, torch.float32)
    npd = lambda d: {k: np.asarray(v, np.float32)  # noqa: E731
                     for k, v in d.items()}
    return dict(j_dyn=npd(j_dyn), t_f32=npd(t_f32), t_dyn=npd(t_dyn),
                t_st=npd(t_st), t_bf16=npd(t_bf16), scales=scales)


def test_cdpn_int8_forward_matches_lc_tpu(cdpn_pair):
    p = cdpn_pair
    assert len(p['scales']) == 43
    for k, v in p['j_dyn'].items():
        got = p['t_dyn'][k]
        assert got.shape == v.shape and np.all(np.isfinite(got)), k
        bound = 5e-3 if k == 'xyz_weights_scale' else 0.06
        assert _rel_rms(v, got) < bound, (k, _rel_rms(v, got))


# (cin, cout, kernel, stride, padding, dilation, bias): CDPN's 3x3 convs at
# stride 1 and 2, its 1x1 downsample, zebra's dilated ASPP branch, an
# output head with its bias
LAYERS = [(64, 64, 3, 1, 1, 1, False), (64, 128, 3, 2, 1, 1, False),
          (64, 128, 1, 2, 0, 1, False), (64, 32, 3, 1, 6, 6, True),
          (256, 23, 1, 1, 0, 1, True)]


@pytest.mark.parametrize('layer', LAYERS + ['deconv'], ids=str)
def test_layer_matches_lc_tpu_bitwise(layer):
    """One quantized layer on the same non-grid ReLU activations (f32
    compute): the port's output is lc_tpu's bit for bit. (A whole network
    is not: see the module docstring.)"""
    rng = np.random.default_rng(7)
    cin, cout, k, s, p, d, bias = (32, 16, 3, 2, 1, 1, False) \
        if layer == 'deconv' else layer
    x = np.maximum(rng.normal(0, 1, (2, cin, 16, 16)), 0).astype(np.float32)
    w = rng.normal(0, (cin * k * k) ** -0.5, (k, k, cin, cout)) \
        .astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    v = {'params': {'kernel': jnp.asarray(w)}}
    if layer == 'deconv':
        m = Deconv2x(cin, cout)
        weight = w.transpose(2, 3, 0, 1)
        jm = jlayers.Deconv2x(cout)
    else:
        m = Conv2d(cin, cout, k, s, p, dilation=d, bias=bias)
        weight = w.transpose(3, 2, 0, 1)
        jm = nn.Conv(cout, (k, k), strides=(s, s), padding=((p, p), (p, p)),
                     kernel_dilation=(d, d), use_bias=bias, dtype=jnp.float32)
        if bias:
            v['params']['bias'] = jnp.asarray(b)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(weight))
        if m.bias is not None:
            m.bias.copy_(torch.from_numpy(b))
        with Q.quantized_int8(m):
            got = m(torch.from_numpy(x)).numpy()
    jlayers.set_compute_dtype(jnp.float32)
    try:
        with JQ.quantized_int8():
            ref = jm.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    finally:
        jlayers.set_compute_dtype(jnp.bfloat16)
    np.testing.assert_array_equal(got, np.asarray(ref).transpose(0, 3, 1, 2))


def _yardstick(f32, bf16, q, static):
    for k in f32:
        f, b, x = f32[k], bf16[k], q[k]
        assert np.all(np.isfinite(x)), k
        if k == 'xyz_weights_scale':
            eq = float(np.sqrt(np.mean((np.log(f) - np.log(x)) ** 2)))
            eb = float(np.sqrt(np.mean((np.log(f) - np.log(b)) ** 2)))
            assert np.all(x > 0) and eq < 10 * eb + 0.1, (k, eq, eb)
            continue
        e_b, e_q = _rel_rms(f, b), _rel_rms(f, x)
        bound = 12 * e_b + 1e-2 if static else 6 * e_b + 5e-3
        assert e_q < bound, (k, e_q, e_b)


@pytest.mark.parametrize('mode', ['dyn', 'st'])
def test_cdpn_int8_within_bf16_yardstick(cdpn_pair, mode):
    p = cdpn_pair
    _yardstick(p['t_f32'], p['t_bf16'], p[f't_{mode}'], mode == 'st')


@pytest.mark.slow
def test_zebra_int8_within_bf16_yardstick():
    """The zebra forward at 64²: int8 (dynamic) against f32 within the
    bf16 yardstick (slow as in tests/test_quant.py: a minute on the CPU)."""
    variables = random_flax_variables(seed=2, net_name='zebra_DeepLabV3',
                                      total_bit_cnt=18)
    model = build_model('zebra_DeepLabV3', {'concat': True},
                        total_bit_cnt=18).eval()
    model.load_state_dict(state_dict_from_flax(variables,
                                               net_name='zebra_DeepLabV3'))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    npd = lambda d: {k: v.float().numpy() for k, v in d.items()}  # noqa: E731
    with torch.no_grad():
        f32 = npd(model(x))
        with Q.quantized_int8(model):
            q = npd(model(x))
        bf16 = npd(set_compute_dtype(model, torch.bfloat16)(x))
    _yardstick(f32, bf16, q, False)


def test_skip_predicate_pins_layers():
    model, _ = _cdpn(seed=4)
    x = torch.randn(1, 32, 32, 3)
    with torch.no_grad():
        ref = model(x)
        with Q.quantized_int8(model, skip=lambda m: True):
            got = model(x)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


def test_run_test_int8_modes():
    """harness.run_test with int8_inference, dynamic and static (calibrated
    on the first batch), on an in-memory set: one finite pose a crop; an
    unknown int8_act_scales raises."""
    blobs = synthetic.render_eval_set(2, seed=0, net_input_wh=(64, 64),
                                      net_output_wh=(16, 16))
    loader = [collate(blobs['blobs'])]
    dataset = types.SimpleNamespace(net_input_wh=(64, 64), bit_cnt=None)
    ev = Evaluator(blobs['gts'], blobs['models'], blobs['models_info'],
                   'synthetic')
    model, _ = _cdpn()
    cfg = Config(dict(pnp_solver=dict(dense_point_select='quantile',
                                      quantile=0.3, solvers=['weighted']),
                      int8_inference=True))
    for mode in ('dynamic', 'static'):
        cfg['int8_act_scales'] = mode
        out = harness.run_test(cfg, model, loader, dataset, ev, device='cpu')
        errs = out['weighted']['errors']
        assert len(errs) == 2
        assert all(np.all(np.isfinite(e['t_est'])) for e in errs)
    cfg['int8_act_scales'] = 'Static'
    with pytest.raises(ValueError, match='dynamic or static'):
        harness.run_test(cfg, model, loader, dataset, ev, device='cpu')
