"""The zebra training path of the port against lc_tpu at configs/zsyn.yaml's
own sizes (256² in, 128² out, max_bit_cnt 7: bit_cnt (7, 7, 6) for the
synthetic box), where tests/test_torch_train_zebra.py runs at 64² / 32² and
3 bits: the straight-through decode, the Gray targets, the binary-code loss
and compute_losses on the same inputs, and one whole ZebraDeepLabV3 step in
f32 (batch 2). At 64² in, ASPP's 8² feature map puts every tap of the
dilation-12 and -18 branches on padding; here they read data.

`slow` (about 2 min, most of it lc_tpu's XLA:CPU compile of the step).
Tolerances are test_torch_train_zebra's but for the whole step's
histogram (HIST_ATOL) and gradients, whose reductions are 16 times longer
here: the heads' within
HEADS_ATOL of their largest entry (measured 2.0e-4; 1e-4 at 64²), the
median below the heads within ZEBRA_GRAD_REL in relative L2 (measured
1.67%) and each within FULL_SIZE_GRAD_REL (measured at most 2.29%, a
BatchNorm scale of layer 2); f32 resolves this network's gradients to
about 1.4% at 64². Measured: the loss terms 4e-6 apart, grad_norm 3.5e-4.
"""
import numpy as np
import pytest

import test_torch_train_zebra as z
from lc_tpu_torch.codec import calc_bit_count

pytestmark = pytest.mark.slow

FULL_SIZE_GRAD_REL = 3e-2
# the heads' gradients sum over 16 times the pixels of the 64² test (1e-4
# of their largest entry there): rounding grows as the square root
HEADS_ATOL = 4e-4
# a Gray bit whose logit lies within rounding of 0 can take either sign in
# the two forwards; each such pixel moves the histogram by momentum / (mask
# pixels + 1), about 2.5e-6 at this batch (measured 1.0e-5: four pixels)
HIST_ATOL = 2e-5


@pytest.fixture
def full_size(monkeypatch):
    bit_cnt = tuple(calc_bit_count(z.HALF.tolist(), max_bits=7))
    assert bit_cnt == (7, 7, 6)
    monkeypatch.setattr(z, 'IN_WH', (256, 256))
    monkeypatch.setattr(z, 'OUT_WH', (128, 128))
    monkeypatch.setattr(z, 'BIT_CNT', bit_cnt)
    monkeypatch.setattr(z, 'LOSS_KW', dict(z.LOSS_KW, bit_cnt=bit_cnt))
    monkeypatch.setattr(z._random_out, '__defaults__', (128, 128, 2))
    return bit_cnt


@pytest.mark.parametrize('check', [
    ('test_logits_to_noc_with_gt_matches', (True,)),
    ('test_noc_to_nn_target_bit_equal', (True,)),
    ('test_xyz_bin_loss_matches', ()),
    ('test_annots_on_the_fly_with_bits', ('plain',)),
    ('test_annots_on_the_fly_with_bits', ('symmetric',)),
    ('test_compute_losses_binary_matches', ())],
    ids=lambda c: '-'.join([c[0].removeprefix('test_'), *map(str, c[1])]))
def test_zebra_losses_at_zsyn_size(full_size, check):
    """The Gray-code decode, targets and losses of test_torch_train_zebra,
    each on its own inputs drawn at zsyn's sizes."""
    name, args = check
    getattr(z, name)(*args)


def test_one_zebra_train_step_at_zsyn_size(full_size):
    """One whole step at zsyn's sizes in f32 against lc_tpu's (two-pass
    BatchNorm variance, as in test_torch_train_zebra): the terms, the
    total, grad_norm, the heads' gradients, BatchNorm's running means and
    the loss state; the gradients within the module's tolerances."""
    import contextlib
    f32 = contextlib.contextmanager(z.f32_reference.__wrapped__)
    two_pass = contextlib.contextmanager(z.two_pass_batchnorm.__wrapped__)
    with f32(), two_pass():
        gt = z._gt_batch(symmetric=True)
        gt['img_in'] = np.random.default_rng(0).normal(
            size=(2,) + z.IN_WH[::-1] + (3,)).astype(np.float32)
        variables = z.random_flax_variables(
            seed=2, net_name='zebra_DeepLabV3', total_bit_cnt=sum(full_size))
        case = z.whole_step_case('zebra_DeepLabV3', z.ZEBRA_CFG, gt,
                                 variables, z.LOSS_KW,
                                 total_bit_cnt=sum(full_size))
    jm, jstate, jgrads, model, tm, tstate = case
    for k in ('loss_noc_bin', 'loss_seg', 'loss_pose'):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(tm['grad_norm'], jm['grad_norm'], rtol=1e-2)
    g_max = max(float(np.abs(g.numpy()).max()) for n, g in jgrads.items()
                if 'running' not in n)
    rels = []
    for name, p in model.named_parameters():
        g, mine = jgrads[name].numpy(), p.grad.numpy()
        if np.abs(g).max() < 1e-5 * g_max:
            # a bias in front of a train-mode BatchNorm: zero gradient
            assert np.abs(mine).max() < 1e-5 * g_max, name
            continue
        if name.startswith(z.HEADS):
            np.testing.assert_allclose(mine, g, rtol=0, atol=HEADS_ATOL
                                       * np.abs(g).max(), err_msg=name)
        rels.append(z._rel(mine, g))
        assert rels[-1] <= FULL_SIZE_GRAD_REL, (name, rels[-1])
    assert np.median(rels) <= z.ZEBRA_GRAD_REL, np.median(rels)
    sd = model.state_dict()
    for name in (n[:-len('.running_mean')] for n in sd
                 if n.endswith('running_mean')):
        np.testing.assert_allclose(sd[f'{name}.running_mean'].numpy(),
                                   jgrads[f'{name}.running_mean'].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tstate.histogram.numpy(),
                               np.asarray(jstate.histogram), atol=HIST_ATOL)
    for a, b in zip(tstate.weight_clip, jstate.weight_clip):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
