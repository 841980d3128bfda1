"""PtNet: output-channel registry + confidence heads around a dense backbone
(counterpart of lc_tpu/models/ptnet.py).

Public tensors are channel-last as in lc_tpu: the input image is
(B, H, W, 3) and every value of the output dict is channel-last. NCHW stays
inside the modules.

Heads:
  * dense: NOC (3 channels) or Gray-code logits (sum(bit_cnt) channels), 2
    weight-logit channels, 1 visibility-mask channel, and a global weight
    scale exp(Linear(mean feature));
  * sparse: a heatmap per keypoint -> softmax over the map -> separable
    soft-argmax mean and std; no weight scale.
"""
from __future__ import annotations

import torch
from torch import nn

from .cdpn import ResNetCDPN
from .layers import at_least_f32, set_compute_dtype
from .zebra import ZebraDeepLabV3


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


def softargmax_2d_std(prob2d: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Separable soft-argmax: prob2d (..., H, W) -> mean (..., 2) as (x, y)
    and std (..., 2), from the row and column marginals."""
    def marginal_stats(p1d):                                  # (..., N)
        xx = torch.arange(p1d.shape[-1], dtype=p1d.dtype, device=p1d.device)
        m = (xx * p1d).sum(-1)
        return m, ((xx - m[..., None]) ** 2 * p1d).sum(-1)

    mx, cx = marginal_stats(prob2d.sum(-2))
    my, cy = marginal_stats(prob2d.sum(-1))
    return (torch.stack((mx, my), -1),
            torch.sqrt(torch.stack((cx, cy), -1) + 1e-6))


def keypoints_from_logits(logits: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sparse head on its logits (B, K, h, w): a softmax over each map,
    then softargmax_2d_std -> pts2d, pts2d_std (B, K, 2)."""
    prob = torch.softmax(logits.flatten(2), -1).view(logits.shape)
    return softargmax_2d_std(prob)


class PtNet(nn.Module):
    """Submodules `net` (backbone + decoder) and, for the dense heads,
    `weight_scale_layer`, named as in the reference checkpoints."""

    def __init__(self, net_name: str = 'cdpn_resnet', sparse_cnt: int = 0,
                 binary_bits: int = 0, concat: bool = False,
                 output_kernel_size: int = 1):
        super().__init__()
        self.binary_bits = binary_bits
        self.channel_slices = output_channel_slices(sparse_cnt, binary_bits)
        out_ch = max(s.stop for s in self.channel_slices.values())
        if net_name == 'cdpn_resnet':
            self.net = ResNetCDPN(out_ch, concat=concat)
            feature_dim = 256
        elif net_name == 'zebra_DeepLabV3':
            self.net = ZebraDeepLabV3(out_ch, output_kernel_size)
            feature_dim = ZebraDeepLabV3.feature_dim
        else:
            raise ValueError(f'unknown net_name {net_name}')
        self.sparse = sparse_cnt > 3
        if not self.sparse:
            self.weight_scale_layer = nn.Linear(feature_dim, 1)

    def forward(self, rgb: torch.Tensor) -> dict:
        """rgb (B, H, W, 3) normalized -> dict of channel-last f32 tensors."""
        out_raw, feature = self.net(rgb.permute(0, 3, 1, 2))
        # the heads run in f32 whatever the convolution compute dtype
        out_raw = at_least_f32(out_raw)
        if self.sparse:
            pts2d, pts2d_std = keypoints_from_logits(
                out_raw[:, self.channel_slices['kpt_logits']])
            return {'pts2d': pts2d, 'pts2d_std': pts2d_std}
        out_raw = out_raw.permute(0, 2, 3, 1)
        split = {k: out_raw[..., v] for k, v in self.channel_slices.items()}
        noc_key = 'xyz_noc_bin' if self.binary_bits > 0 else 'xyz_noc'
        scale = torch.exp(self.weight_scale_layer(
            at_least_f32(feature).mean((2, 3))))
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
                  concat=net_config.get('concat',
                                        net_name == 'zebra_DeepLabV3'),
                  output_kernel_size=net_config.get('output_kernel_size', 1))
    return set_compute_dtype(model, compute_dtype)
