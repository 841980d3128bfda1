"""Seeding (counterpart of lc_tpu/utils/seeding.py; reference
lib/utils/random_state.py:29 seed_all).

The host generators (python, numpy's global, torch's default) are seeded
once. Per-step randomness comes from torch.Generators seeded from
(seed, step, stream), so step N of a resumed run draws what step N of the
uninterrupted run drew, whatever happened before it.
"""
from __future__ import annotations

import random

import numpy as np
import torch

# streams of per-step generators
STREAM_PREPROCESS = 0      # colour augmentation of the step's batch
STREAM_STEP = 1            # the dense loss's sampling offset


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (1 << 32))
    torch.manual_seed(seed)


def get_random_state() -> dict:
    return {'python': random.getstate(), 'numpy': np.random.get_state(),
            'torch': torch.get_rng_state()}


def restore_random_state(state: dict) -> None:
    random.setstate(state['python'])
    np.random.set_state(state['numpy'])
    torch.set_rng_state(state['torch'])


def step_generator(seed: int, step: int, stream: int,
                   device='cpu') -> torch.Generator:
    """A generator on `device` seeded from (seed, step, stream)."""
    value = np.random.SeedSequence((seed, step, stream)).generate_state(
        2, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(value) & ((1 << 63) - 1))
    return gen
