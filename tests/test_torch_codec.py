"""The port's Gray-code codec (lc_tpu_torch.codec) and the binary branch of
nn_out_to_xyz against lc_tpu's, on the same numpy inputs.

calc_bit_count and noc_to_bits must agree exactly (integers and bits);
logits_to_noc to atol 1e-6 (a sigmoid and a division in f32), with and
without black_background, on axes of 2 bits or fewer too (the sign-corrected
soft LSB), on random logits and on exact ±4 logits of known codes;
nn_out_to_xyz with a random rigid model_transform to atol 1e-4 mm (values
of ~50 mm, one 3x3 product more)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu import codec as jcodec
from lc_tpu.loss.targets import nn_out_to_xyz as j_nn_out_to_xyz
from lc_tpu_torch import codec as tcodec
from lc_tpu_torch.loss.targets import nn_out_to_xyz as t_nn_out_to_xyz

BIT_CNTS = [(7, 7, 6), (5, 4, 3), (2, 3, 1), (1, 2, 2)]


@pytest.mark.parametrize('sizes,max_bits', [
    ((40.0, 30.0, 20.0), 7), ((40.0, 30.0, 20.0), 5), ((10.0, 80.0, 2.0), 7),
    ((50.0, 50.0, 50.0), 4)])
def test_calc_bit_count(sizes, max_bits):
    assert tcodec.calc_bit_count(sizes, max_bits=max_bits) == \
        jcodec.calc_bit_count(sizes, max_bits=max_bits)


@pytest.mark.parametrize('bit_cnt', BIT_CNTS)
@pytest.mark.parametrize('bb', [False, True])
def test_noc_to_bits_exact(bit_cnt, bb):
    # beyond (-1, 1) too: both clamp
    noc = np.random.default_rng(0).uniform(-1.1, 1.1, (3, 7, 3)) \
        .astype(np.float32)
    jm, jr = jcodec.noc_to_bits(jnp.asarray(noc), bit_cnt, bb)
    tm, tr = tcodec.noc_to_bits(torch.from_numpy(noc), bit_cnt, bb)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(
        tcodec.bits_to_int(tr[..., :bit_cnt[0]]).numpy(),
        np.asarray(jcodec.bits_to_int(jr[..., :bit_cnt[0]])))


@pytest.mark.parametrize('bit_cnt', BIT_CNTS)
@pytest.mark.parametrize('bb', [False, True])
def test_logits_to_noc_random_logits(bit_cnt, bb):
    logits = np.random.default_rng(1).normal(0, 3, (4, 9, sum(bit_cnt))) \
        .astype(np.float32)
    j = np.asarray(jcodec.logits_to_noc(jnp.asarray(logits), bit_cnt, bb))
    t = tcodec.logits_to_noc(torch.from_numpy(logits), bit_cnt, bb).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)


@pytest.mark.parametrize('bit_cnt', BIT_CNTS)
@pytest.mark.parametrize('bb', [False, True])
def test_logits_to_noc_round_trip(bit_cnt, bb):
    """±4 logits of a NOC's Gray code decode to within a bin of it, in both
    packages (the soft LSB's sign fixed for short axes under bb)."""
    noc = np.random.default_rng(2).uniform(-0.99, 0.99, (5, 3)) \
        .astype(np.float32)
    mod, _ = tcodec.noc_to_bits(torch.from_numpy(noc), bit_cnt, bb)
    logits = torch.where(mod, 4.0, -4.0)
    t = tcodec.logits_to_noc(logits, bit_cnt, bb).numpy()
    j = np.asarray(jcodec.logits_to_noc(jnp.asarray(logits.numpy()),
                                        bit_cnt, bb))
    np.testing.assert_allclose(t, j, atol=1e-6)
    bin_width = 2.0 / (2.0 ** np.asarray(bit_cnt) - 1)
    assert np.all(np.abs(t - noc) <= bin_width)


@pytest.mark.parametrize('with_transform', [False, True])
def test_nn_out_to_xyz_binary(with_transform):
    rng = np.random.default_rng(3)
    bit_cnt = (7, 7, 6)
    B = 3
    logits = rng.normal(0, 3, (B, 8, 8, sum(bit_cnt))).astype(np.float32)
    scale = rng.uniform(20, 60, (B, 3)).astype(np.float32)
    xform = None
    if with_transform:
        xform = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        xform[:, :3, :3] = sciR.random(B, random_state=4).as_matrix()
        xform[:, :3, 3] = rng.uniform(-10, 10, (B, 3))
    kw = dict(bit_cnt=bit_cnt, black_background=True)
    j = np.asarray(j_nn_out_to_xyz(
        jnp.asarray(logits), jnp.asarray(scale), inference=True,
        model_transform=None if xform is None else jnp.asarray(xform), **kw))
    t = t_nn_out_to_xyz(
        torch.from_numpy(logits), torch.from_numpy(scale), inference=True,
        model_transform=None if xform is None else torch.from_numpy(xform),
        **kw).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)


def test_nn_out_to_xyz_training_decode_not_ported():
    """The training decode (inference=False, named when it still raised)
    is ported: with the GT's plain bits and mask it gives lc_tpu's values,
    a random rigid model_transform included, to atol 1e-4 mm."""
    rng = np.random.default_rng(9)
    B, bit_cnt = 2, (2, 2, 2)
    logits = (rng.choice([-1.0, 1.0], (B, 4, 4, 6))
              * rng.uniform(0.05, 3.0, (B, 4, 4, 6))).astype(np.float32)
    raw = rng.random((B, 4, 4, 6)) < 0.5
    mask = rng.random((B, 4, 4)) < 0.7
    scale = rng.uniform(20, 60, (B, 3)).astype(np.float32)
    xform = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    xform[:, :3, :3] = sciR.random(B, random_state=5).as_matrix()
    xform[:, :3, 3] = rng.uniform(-10, 10, (B, 3))
    kw = dict(bit_cnt=bit_cnt, black_background=True)
    j = np.asarray(j_nn_out_to_xyz(
        jnp.asarray(logits), jnp.asarray(scale), raw_bits_gt=jnp.asarray(raw),
        noc_mask=jnp.asarray(mask), model_transform=jnp.asarray(xform), **kw))
    t = t_nn_out_to_xyz(
        torch.from_numpy(logits), torch.from_numpy(scale),
        raw_bits_gt=torch.from_numpy(raw), noc_mask=torch.from_numpy(mask),
        model_transform=torch.from_numpy(xform), **kw).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)
