"""lc_tpu_torch — the PyTorch/CUDA port of lc_tpu for one NVIDIA H100.

Mirrors lc_tpu's layout (geom, pnp, models, data, eval, inference, harness,
test) so each module has an obvious counterpart. It never imports jax, flax,
optax or lc_tpu: the JAX package is the reference the port is held against,
and only the tests import both.

Devices: entry points take an explicit `device`. They run on CUDA unless the
caller asks for the CPU, and raise when CUDA is missing and the CPU was not
asked for (`resolve_device`). Inside, functions follow the device of the
tensors they are given: a CUDA tensor goes through the hand-written kernel, a
CPU tensor through its plain PyTorch version.

Precision policy (the counterpart of lc_tpu/__init__.py's "highest" matmul
precision): geometry, PnP and evaluation run in true f32, so TF32 is turned
off for both matmuls and cuDNN convolutions. The CNN opts into bf16
convolutions on the card explicitly (models/layers.py), with BatchNorm and
the heads in f32; the CPU tests run it in f32.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

# reduced-precision matmuls break rotation traces and the 6x6 normal equations
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only when
    asked for. Raises instead of falling back to the CPU."""
    if device is None:
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'lc_tpu_torch runs on CUDA by default and no CUDA device is '
            'available; pass device="cpu" (CLI: --device cpu) to run on the CPU')
    return device
