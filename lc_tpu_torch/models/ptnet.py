"""PtNet: output-channel registry + confidence heads around the dense backbone
(counterpart of lc_tpu/models/ptnet.py; the dense head only).

Public tensors are channel-last as in lc_tpu: the input image is
(B, H, W, 3) and every value of the output dict is channel-last. NCHW stays
inside the modules.
"""
from __future__ import annotations

import torch
from torch import nn

from .cdpn import ResNetCDPN
from .layers import at_least_f32, set_compute_dtype


def output_channel_slices(sparse_cnt: int = 0, binary_bits: int = 0) -> dict:
    """Name -> slice along the channel axis."""
    channels = {}
    if sparse_cnt > 3:
        channels['kpt_logits'] = sparse_cnt
    else:
        noc_key = 'xyz_noc_bin' if binary_bits > 0 else 'xyz_noc'
        channels[noc_key] = binary_bits if binary_bits > 0 else 3
        channels['xyz_weights'] = 2
        channels['msk_vis'] = 1
    slices, start = {}, 0
    for k, v in channels.items():
        slices[k] = slice(start, start + v)
        start += v
    return slices


class PtNet(nn.Module):
    """Submodules `net` (backbone + decoder) and `weight_scale_layer`, named
    as in the reference checkpoints."""

    def __init__(self, net_name: str = 'cdpn_resnet', sparse_cnt: int = 0,
                 binary_bits: int = 0, concat: bool = False):
        super().__init__()
        if net_name != 'cdpn_resnet':
            raise NotImplementedError(
                f'net_name={net_name}: the zebra network arrives with the zebra '
                'slice of the port')
        if sparse_cnt > 3:
            raise NotImplementedError(
                'the sparse keypoint head arrives with the sparse slice of the '
                'port')
        self.binary_bits = binary_bits
        self.channel_slices = output_channel_slices(sparse_cnt, binary_bits)
        out_ch = max(s.stop for s in self.channel_slices.values())
        self.net = ResNetCDPN(out_ch, concat=concat)
        self.weight_scale_layer = nn.Linear(256, 1)

    def forward(self, rgb: torch.Tensor) -> dict:
        """rgb (B, H, W, 3) normalized -> dict of channel-last f32 tensors."""
        out_raw, feature = self.net(rgb.permute(0, 3, 1, 2))
        # the heads run in f32 whatever the convolution compute dtype
        out_raw = at_least_f32(out_raw).permute(0, 2, 3, 1)
        feature = at_least_f32(feature)
        split = {k: out_raw[..., v] for k, v in self.channel_slices.items()}
        noc_key = 'xyz_noc_bin' if self.binary_bits > 0 else 'xyz_noc'
        scale = torch.exp(self.weight_scale_layer(feature.mean((2, 3))))
        return {
            noc_key: split[noc_key],
            'xyz_weight_logits': split['xyz_weights'],
            'xyz_weights_scale': scale[:, None, None, :],       # (B, 1, 1, 1)
            'msk_vis_logits': split['msk_vis'],
        }


def build_model(net_name: str, net_config: dict | None = None, *,
                sparse_cnt: int = 0, total_bit_cnt: int = 0,
                compute_dtype: torch.dtype = torch.float32) -> PtNet:
    net_config = net_config or {}
    model = PtNet(net_name=net_name, sparse_cnt=sparse_cnt,
                  binary_bits=total_bit_cnt,
                  concat=net_config.get('concat', False))
    return set_compute_dtype(model, compute_dtype)
