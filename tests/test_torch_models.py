"""The port's CDPN-ResNet34 against lc_tpu's Flax model on the same weights.

Weights are made in lc_tpu's layout (numpy), carried into the port by
state_dict_from_flax, and both forwards run in f32 (lc_tpu's compute dtype
set to f32, as tests/test_models.py does). Tolerance: rtol 1e-4 with atol
1e-4 of each output's scale — 34 f32 layers summed in different orders."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lc_tpu.models import build_model as j_build_model
from lc_tpu.models import layers as jlayers
from lc_tpu.models.torch_port import port_cdpn_checkpoint
from lc_tpu_torch.models import build_model
from lc_tpu_torch.models.weights import random_flax_variables, state_dict_from_flax


@pytest.fixture
def f32_reference():
    jlayers.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jlayers.set_compute_dtype(jnp.bfloat16)


@pytest.mark.parametrize('concat', [False, True])
def test_cdpn_forward_matches(f32_reference, concat):
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = random_flax_variables(seed=1, concat=concat)
    jmodel = j_build_model('cdpn_resnet', {'concat': concat})
    tmpl = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 64, 64, 3))))
    assert jax.tree.map(lambda a: a.shape, tmpl) == \
        jax.tree.map(np.shape, variables)
    j_out = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))

    model = build_model('cdpn_resnet', {'concat': concat}).eval()
    model.load_state_dict(state_dict_from_flax(variables, concat=concat))
    with torch.no_grad():
        t_out = model(torch.from_numpy(x))
    assert set(t_out) == set(j_out)
    for k, v in j_out.items():
        v = np.asarray(v)
        assert t_out[k].shape == v.shape, k
        np.testing.assert_allclose(t_out[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


@pytest.mark.parametrize('concat', [False, True])
def test_reference_state_dict_round_trip(concat):
    """A reference-layout state dict -> lc_tpu's port_cdpn_checkpoint ->
    state_dict_from_flax gives the same state dict back."""
    model = build_model('cdpn_resnet', {'concat': concat})
    rng = np.random.default_rng(2)
    fake = {k: rng.normal(size=v.shape).astype(np.float32)
            if v.is_floating_point() else np.zeros(v.shape, np.int64)
            for k, v in model.state_dict().items()}
    params, stats = port_cdpn_checkpoint(fake, concat=concat)
    back = state_dict_from_flax({'params': params, 'batch_stats': stats},
                                concat=concat)
    assert set(back) == set(fake)
    for k, v in fake.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    model.load_state_dict(back)      # strict: every key, every shape


def test_unported_heads_raise():
    """Every head of lc_tpu is ported now (zebra and sparse:
    tests/test_torch_zebra.py, test_torch_sparse.py); a network lc_tpu does
    not have raises as there."""
    with pytest.raises(ValueError, match='unknown net_name'):
        build_model('resnet50')
    assert build_model('zebra_DeepLabV3', total_bit_cnt=20) \
        .channel_slices['xyz_noc_bin'] == slice(0, 20)
    assert build_model('cdpn_resnet', sparse_cnt=8).channel_slices == \
        {'kpt_logits': slice(0, 8)}
