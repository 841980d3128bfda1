"""Weights in lc_tpu's layout -> the port's state_dict (the inverse of
lc_tpu/models/torch_port.py::port_cdpn_checkpoint, with its own copy of the
key and layout rules).

Layout rules (torch <- flax):
    Conv2d          weight (O, I, kH, kW)  <- kernel (kH, kW, I, O)
    ConvTranspose2d weight (I, O, kH, kW)  <- kernel (kH, kW, I, O)
    Linear          weight (O, I)          <- kernel (I, O)
    BatchNorm2d     weight/bias            <- params scale/bias
                    running_mean/var       <- batch_stats mean/var
Key rules: 'net.backbone.{conv1,bn1}' <- net/backbone/stem/{conv1,bn1};
'net.backbone.layerL.i.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}' <-
net/backbone/layerL/block{i}/{...,downsample_conv,downsample_bn};
'net.decoder.features.<idx>' <- net/decoder/{up0/deconv, up0/bn,
conv{i}_{j}, bn{i}_{j}}; 'net.decoder.out_layer' and 'weight_scale_layer'
keep their names.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d, Deconv2x
from .ptnet import PtNet


def _decoder_paths(concat: bool) -> dict[int, tuple]:
    """features index -> flax module path under net/decoder."""
    paths = {0: ('up0', 'deconv'), 1: ('up0', 'bn')}
    for i in range(3):
        for j in range(2):
            idx = 3 + 7 * i + 1 + 3 * j if concat else \
                {(0, 0): 3, (0, 1): 6, (1, 0): 10, (1, 1): 13,
                 (2, 0): 17, (2, 1): 20}[(i, j)]
            paths[idx] = (f'conv{i}_{j}',)
            paths[idx + 1] = (f'bn{i}_{j}',)
    return paths


def _flax_path(name: str, concat: bool) -> tuple:
    """Torch module name -> flax module path."""
    parts = name.split('.')
    if parts[:2] == ['net', 'backbone']:
        rest = parts[2:]
        if len(rest) == 1:                                    # conv1, bn1
            return ('net', 'backbone', 'stem', rest[0])
        layer, block, *sub = rest
        sub = {'downsample.0': 'downsample_conv',
               'downsample.1': 'downsample_bn'}.get('.'.join(sub), '.'.join(sub))
        return ('net', 'backbone', layer, f'block{block}', sub)
    if parts[:3] == ['net', 'decoder', 'features']:
        return ('net', 'decoder') + _decoder_paths(concat)[int(parts[3])]
    return tuple(parts)          # net.decoder.out_layer, weight_scale_layer


def _param_modules(concat: bool):
    """(name, module) of every module holding parameters, from a model built
    on the meta device (names and shapes only, no memory)."""
    with torch.device('meta'):
        model = PtNet(concat=concat)
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (Conv2d, Deconv2x, BatchNorm2d, nn.Linear))]


def _get(tree: dict, path: tuple) -> dict:
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_flax(variables: dict, concat: bool = False
                         ) -> dict[str, torch.Tensor]:
    """lc_tpu's {'params', 'batch_stats'} tree of numpy arrays -> the port's
    state_dict (CPU f32 tensors, ready for load_state_dict)."""
    sd = {}
    for name, m in _param_modules(concat):
        path = _flax_path(name, concat)
        p = _get(variables['params'], path)
        if isinstance(m, BatchNorm2d):
            s = _get(variables['batch_stats'], path)
            sd[f'{name}.weight'] = p['scale']
            sd[f'{name}.bias'] = p['bias']
            sd[f'{name}.running_mean'] = s['mean']
            sd[f'{name}.running_var'] = s['var']
            sd[f'{name}.num_batches_tracked'] = np.array(0, np.int64)
            continue
        k = np.asarray(p['kernel'])
        if isinstance(m, Deconv2x):
            sd[f'{name}.weight'] = k.transpose(2, 3, 0, 1)
        elif isinstance(m, Conv2d):
            sd[f'{name}.weight'] = k.transpose(3, 2, 0, 1)
        else:
            sd[f'{name}.weight'] = k.transpose(1, 0)
        if m.bias is not None:
            sd[f'{name}.bias'] = p['bias']
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def random_flax_variables(seed: int = 0, concat: bool = False,
                          out_channels: int = 6) -> dict:
    """Seeded weights in lc_tpu's layout (numpy): convolutions and linear
    layers drawn with variance 1/fan_in, BatchNorm near identity. For runs
    that need the full network but no trained checkpoint."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaves):
        for p in path:
            tree = tree.setdefault(p, {})
        tree.update(leaves)

    for name, m in _param_modules(concat):
        path = _flax_path(name, concat)
        if isinstance(m, BatchNorm2d):
            c = m.num_features
            put(params, path, {'scale': rng.uniform(0.8, 1.2, c),
                               'bias': rng.normal(0, 0.1, c)})
            put(stats, path, {'mean': rng.normal(0, 0.1, c),
                              'var': rng.uniform(0.8, 1.2, c)})
            continue
        shape = tuple(m.weight.shape)
        if name == 'net.decoder.out_layer':
            shape = (out_channels,) + shape[1:]
        if isinstance(m, Deconv2x):             # (I, O, kH, kW)
            fan_in = shape[0] * shape[2] * shape[3]
            kshape = (shape[2], shape[3], shape[0], shape[1])
        elif isinstance(m, Conv2d):             # (O, I, kH, kW)
            fan_in = shape[1] * shape[2] * shape[3]
            kshape = (shape[2], shape[3], shape[1], shape[0])
        else:                                   # Linear (O, I)
            fan_in = shape[1]
            kshape = (shape[1], shape[0])
        leaves = {'kernel': rng.normal(0, fan_in ** -0.5, kshape)}
        if m.bias is not None:
            leaves['bias'] = np.zeros(kshape[-1])
        put(params, path, leaves)
    cast = lambda t: {k: cast(v) if isinstance(v, dict)  # noqa: E731
                      else np.asarray(v, np.float32) for k, v in t.items()}
    return {'params': cast(params), 'batch_stats': cast(stats)}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """lc_tpu's initialization (its conv_init): every convolution,
    deconvolution and linear weight drawn from N(0, 0.001²), biases zero,
    BatchNorm the identity."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Deconv2x, nn.Linear)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * 0.001)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()
    return model
