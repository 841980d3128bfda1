"""Network output decoding (counterpart of lc_tpu/loss/targets.py; the
inference decode only)."""
from __future__ import annotations

import torch


def nn_out_to_xyz(nn_out: torch.Tensor, noc_scale_xfd: torch.Tensor, *,
                  model_transform: torch.Tensor | None = None,
                  bit_cnt=None) -> torch.Tensor:
    """Decode network output channels into model-frame XYZ.

    nn_out: (B, ..., C) channel-last, C = 3 for the continuous NOC head;
    noc_scale_xfd: (B, 3). Returns (B, ..., 3).
    """
    if bit_cnt is not None:
        raise NotImplementedError(
            'the binary Gray-code decode (zebra models) arrives with the '
            'zebra slice of the port')
    if model_transform is not None:
        raise ValueError('model transform not supported for continuous xyz '
                         'output (matches reference)')
    scale = noc_scale_xfd.reshape(
        noc_scale_xfd.shape[:1] + (1,) * (nn_out.dim() - 2) + (3,))
    return nn_out * scale
