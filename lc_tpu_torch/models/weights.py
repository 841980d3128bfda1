"""Weights in lc_tpu's layout -> the port's state_dict (the inverse of
lc_tpu/models/torch_port.py::port_cdpn_checkpoint, with its own copy of the
key and layout rules).

Layout rules (torch <- flax):
    Conv2d          weight (O, I, kH, kW)  <- kernel (kH, kW, I, O)
    ConvTranspose2d weight (I, O, kH, kW)  <- kernel (kH, kW, I, O)
    Linear          weight (O, I)          <- kernel (I, O)
    BatchNorm2d     weight/bias            <- params scale/bias
                    running_mean/var       <- batch_stats mean/var
Key rules, CDPN: 'net.backbone.{conv1,bn1}' <- net/backbone/stem/{conv1,bn1};
'net.backbone.layerL.i.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}' <-
net/backbone/layerL/block{i}/{...,downsample_conv,downsample_bn};
'net.decoder.features.<idx>' <- net/decoder/{up0/deconv, up0/bn,
conv{i}_{j}, bn{i}_{j}}; 'net.decoder.out_layer' and 'weight_scale_layer'
keep their names. Zebra (the inverse of port_zebra_checkpoint):
'net.resnet.resnet_layer_1.{0,1}' <- net/resnet/stem/{conv1,bn1};
'net.resnet.{resnet_layer_2.1, resnet_layer_3.0, layer4, layer5}.i' <-
net/resnet/{layer1, layer2, layer4, layer5}/block{i};
'net.aspp.<branch>' / 'net.aspp.bn_<branch>' <- net/aspp/<flax branch>/
{conv,bn}; 'net.aspp.upsample_u.{0,1,3,4,6,7}' <- net/aspp/upsample_u/
{deconv/deconv, deconv/bn, conv0, bn0, conv1, bn1}; 'net.aspp.conv_1x1_4' <-
net/aspp/out_layer. The sparse head has no weight_scale_layer.
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


# reference ASPP branch name -> lc_tpu's
_ASPP_BRANCHES = {'conv_1x1_1': 'branch_1x1', 'conv_3x3_1': 'branch_d6',
                  'conv_3x3_2': 'branch_d12', 'conv_3x3_3': 'branch_d18',
                  'conv_1x1_2': 'branch_img', 'conv_1x1_3': 'project'}
_ZEBRA_STAGES = {'resnet_layer_2.1': 'layer1', 'resnet_layer_3.0': 'layer2',
                 'layer4': 'layer4', 'layer5': 'layer5'}
_UPSAMPLE_PATHS = {'0': ('deconv', 'deconv'), '1': ('deconv', 'bn'),
                   '3': ('conv0',), '4': ('bn0',), '6': ('conv1',),
                   '7': ('bn1',)}


def _block_sub(sub: list) -> str:
    return {'downsample.0': 'downsample_conv',
            'downsample.1': 'downsample_bn'}.get('.'.join(sub), '.'.join(sub))


def _zebra_flax_path(parts: list) -> tuple:
    if parts[1] == 'resnet':
        rest = '.'.join(parts[2:])
        if rest.startswith('resnet_layer_1.'):
            return ('net', 'resnet', 'stem',
                    {'0': 'conv1', '1': 'bn1'}[parts[3]])
        for tname, fname in _ZEBRA_STAGES.items():
            if rest.startswith(tname + '.'):
                block, *sub = rest[len(tname) + 1:].split('.')
                return ('net', 'resnet', fname, f'block{block}',
                        _block_sub(sub))
        raise KeyError(rest)
    name = parts[2]                                     # net.aspp.<name>...
    if name.startswith('upsample_'):
        return ('net', 'aspp', name) + _UPSAMPLE_PATHS[parts[3]]
    if name == 'conv_1x1_4':
        return ('net', 'aspp', 'out_layer')
    if name.startswith('bn_'):
        return ('net', 'aspp', _ASPP_BRANCHES[name[3:]], 'bn')
    return ('net', 'aspp', _ASPP_BRANCHES[name], 'conv')


def _flax_path(name: str, concat: bool) -> tuple:
    """Torch module name -> flax module path."""
    parts = name.split('.')
    if parts[:2] in (['net', 'resnet'], ['net', 'aspp']):
        return _zebra_flax_path(parts)
    if parts[:2] == ['net', 'backbone']:
        rest = parts[2:]
        if len(rest) == 1:                                    # conv1, bn1
            return ('net', 'backbone', 'stem', rest[0])
        layer, block, *sub = rest
        return ('net', 'backbone', layer, f'block{block}', _block_sub(sub))
    if parts[:3] == ['net', 'decoder', 'features']:
        return ('net', 'decoder') + _decoder_paths(concat)[int(parts[3])]
    return tuple(parts)          # net.decoder.out_layer, weight_scale_layer


def _param_modules(concat: bool, **model_kw):
    """(name, module) of every module holding parameters, from a model built
    on the meta device (names and shapes only, no memory). model_kw: PtNet's
    net_name, sparse_cnt, binary_bits, output_kernel_size."""
    with torch.device('meta'):
        model = PtNet(concat=concat, **model_kw)
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (Conv2d, Deconv2x, BatchNorm2d, nn.Linear))]


def _get(tree: dict, path: tuple) -> dict:
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_flax(variables: dict, concat: bool = False, *,
                         net_name: str = 'cdpn_resnet', sparse_cnt: int = 0
                         ) -> dict[str, torch.Tensor]:
    """lc_tpu's {'params', 'batch_stats'} tree of numpy arrays -> the port's
    state_dict (CPU f32 tensors, ready for load_state_dict) of the PtNet
    `net_name` with a dense head, or the sparse one if sparse_cnt > 3."""
    sd = {}
    for name, m in _param_modules(concat, net_name=net_name,
                                  sparse_cnt=sparse_cnt):
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


def random_flax_variables(seed: int = 0, concat: bool = False, *,
                          net_name: str = 'cdpn_resnet', sparse_cnt: int = 0,
                          total_bit_cnt: int = 0,
                          output_kernel_size: int = 1) -> dict:
    """Seeded weights in lc_tpu's layout (numpy) for the PtNet those
    arguments build (as build_model takes them): convolutions and linear
    layers drawn with variance 1/fan_in, BatchNorm near identity. For runs
    that need the full network but no trained checkpoint."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaves):
        for p in path:
            tree = tree.setdefault(p, {})
        tree.update(leaves)

    for name, m in _param_modules(concat, net_name=net_name,
                                  sparse_cnt=sparse_cnt,
                                  binary_bits=total_bit_cnt,
                                  output_kernel_size=output_kernel_size):
        path = _flax_path(name, concat)
        if isinstance(m, BatchNorm2d):
            c = m.num_features
            put(params, path, {'scale': rng.uniform(0.8, 1.2, c),
                               'bias': rng.normal(0, 0.1, c)})
            put(stats, path, {'mean': rng.normal(0, 0.1, c),
                              'var': rng.uniform(0.8, 1.2, c)})
            continue
        shape = tuple(m.weight.shape)
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
