"""lc_tpu's .ckpt files read by the port (utils/flax_ckpt.py and
test.py::load_weights), without jax on the port's side.

Checkpoints are written by lc_tpu's own Checkpoint: a TrainState (Ranger's
optimizer state, the loss state) saved mid-training, and the plain
{'params', 'batch_stats'} export finish() writes. Tolerances:
  * the weights read back: bit-equal to what lc_tpu wrote, the TrainState's
    and the export's state_dicts equal;
  * the forward of the port's model on them against lc_tpu's forward, both
    in f32: rtol 1e-4 with atol 1e-4 of each output's scale, as
    tests/test_torch_models.py and test_torch_zebra.py hold it;
  * a foreign pickle, a truncated payload and a cut file: SystemExit.
"""
import os.path as osp
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lc_tpu.loss import LossConfig as JLossConfig
from lc_tpu.loss import init_loss_state as j_init_loss_state
from lc_tpu.models import build_model as j_build_model
from lc_tpu.models import layers as jlayers
from lc_tpu.optim.factory import build_optimizer as j_build_optimizer
from lc_tpu.parallel.train_step import TrainState
from lc_tpu.utils.checkpoint import Checkpoint as JCheckpoint
from lc_tpu_torch.models import build_model
from lc_tpu_torch.models.weights import random_flax_variables, \
    state_dict_from_flax
from lc_tpu_torch.test import load_weights
from lc_tpu_torch.utils import flax_ckpt
from lc_tpu_torch.utils.config import Config

IN_WH = (32, 32)
# family -> (net_name, net_config, sparse_cnt, total_bit_cnt)
FAMILIES = {
    'cdpn': ('cdpn_resnet', {'concat': False}, 0, 0),
    'cdpn_concat': ('cdpn_resnet', {'concat': True}, 0, 0),
    'zebra': ('zebra_DeepLabV3', {'concat': True, 'output_kernel_size': 1},
              0, 14),
    'sparse': ('cdpn_resnet', {'concat': False}, 8, 0),
}


def _cfg(family):
    net, net_cfg, sparse_cnt, _ = FAMILIES[family]
    return Config({'model': {'net_name': net, 'net_config': net_cfg},
                   'sparse_cnt': sparse_cnt})


def _variables(family, seed=1):
    net, net_cfg, sparse_cnt, bits = FAMILIES[family]
    return random_flax_variables(
        seed=seed, concat=net_cfg['concat'] and net == 'cdpn_resnet',
        net_name=net, sparse_cnt=sparse_cnt, total_bit_cnt=bits)


def _write_export(tmp_path, variables):
    """lc_tpu's finish() export of `variables`."""
    export = str(tmp_path / 'model_final.ckpt')
    JCheckpoint.by_step(str(tmp_path / 'done')).finish(
        jax.tree.map(jnp.asarray, variables), export,
        str(tmp_path / 'model_best'))
    return export


def _write_both(tmp_path, variables):
    """lc_tpu's training checkpoint (step 2) and its finish() export."""
    jv = jax.tree.map(jnp.asarray, variables)
    tx = j_build_optimizer({'type': 'Ranger', 'lr': 2e-4, 'wd': 1e-4},
                           {'name': 'flat_and_anneal', 'warmup_iters': 2,
                            'warmup_factor': 0.001, 'anneal_point': 0.72}, 10)
    state = TrainState(params=jv['params'], batch_stats=jv['batch_stats'],
                       opt_state=tx.init(jv['params']),
                       loss_state=j_init_loss_state(JLossConfig()),
                       step=jnp.zeros((), jnp.int32))
    train_path = JCheckpoint.by_step(str(tmp_path / 'ckpts')).save(
        state, step=2, score=0.5)
    return train_path, _write_export(tmp_path, variables)


@pytest.mark.parametrize('family', list(FAMILIES))
def test_lc_tpu_checkpoints_load_and_forward(family, tmp_path):
    net, net_cfg, sparse_cnt, bits = FAMILIES[family]
    variables = _variables(family)
    train_path, export = _write_both(tmp_path, variables)
    assert flax_ckpt.state_keys(flax_ckpt.read_envelope(train_path)) >= {
        'params', 'batch_stats', 'opt_state', 'loss_state', 'step'}
    read = flax_ckpt.read_variables(export)
    for a, b in zip(jax.tree.leaves(read), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    sd_train = load_weights(train_path, _cfg(family))
    sd_export = load_weights(export, _cfg(family))
    assert sd_train.keys() == sd_export.keys()
    for k in sd_train:
        assert torch.equal(sd_train[k], sd_export[k]), k

    model = build_model(net, net_cfg, sparse_cnt=sparse_cnt,
                        total_bit_cnt=bits).eval()
    model.load_state_dict(sd_train)
    x = np.random.default_rng(0).normal(size=(2,) + IN_WH + (3,)) \
        .astype(np.float32)
    with torch.no_grad():
        t_out = model(torch.from_numpy(x))
    jmodel = j_build_model(net, net_cfg, sparse_cnt=sparse_cnt,
                           total_bit_cnt=bits)
    jlayers.set_compute_dtype(jnp.float32)
    try:
        j_out = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    finally:
        jlayers.set_compute_dtype(jnp.bfloat16)
    assert set(t_out) == set(j_out)
    for k, v in j_out.items():
        v = np.asarray(v)
        np.testing.assert_allclose(t_out[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


def test_foreign_truncated_and_cut_files_exit(tmp_path):
    """A pickle of something else, an envelope whose msgpack is cut short,
    a class outside builtins and numpy, and a cut file: each SystemExit;
    the foreign pickle with lc_tpu's "unrecognized checkpoint payload"."""
    cfg = _cfg('cdpn')
    export = _write_export(tmp_path, _variables('cdpn'))
    with open(export, 'rb') as f:
        raw = f.read()
    blob = pickle.loads(raw)
    cases = {
        'foreign.ckpt': (pickle.dumps({'weights': np.zeros(3)}),
                         'unrecognized checkpoint payload'),
        'short.ckpt': (pickle.dumps({'state': blob['state'][:5000],
                                     'aux': blob['aux']}), 'truncated'),
        'class.ckpt': (pickle.dumps({'state': blob['state'],
                                     'aux': {'when': osp.sep.join}}),
                       'not allowed'),
        'cut.ckpt': (raw[:len(raw) // 2], 'neither'),
    }
    for name, (data, msg) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(SystemExit, match=msg):
            load_weights(str(path), cfg)


def test_jax_objects_in_aux_are_dropped(tmp_path, caplog):
    """An aux holding a jax scalar cannot be built without jax: the reader
    keeps the state and drops aux with a warning."""
    variables = _variables('sparse')
    export = _write_export(tmp_path, variables)
    with open(export, 'rb') as f:
        blob = pickle.loads(f.read())
    path = tmp_path / 'jax_aux.ckpt'
    path.write_bytes(pickle.dumps({'state': blob['state'],
                                   'aux': {'step': jnp.asarray(3)}}))
    env = flax_ckpt.read_envelope(str(path))
    assert env['aux'] == {} and 'aux holds objects of jax' in caplog.text
    sd = load_weights(str(path), _cfg('sparse'))
    ref = state_dict_from_flax(variables, sparse_cnt=8)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
