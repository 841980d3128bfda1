"""COCO-style run-length mask codec, pure numpy (copy of lc_tpu/data/rle.py;
pycocotools replacement).

Column-major (Fortran) order, counts alternating runs of 0s then 1s, matching the
COCO uncompressed RLE convention the reference caches masks in
(reference dataset.py:174-182 via pycocotools). Vectorized encode/decode.
"""
from __future__ import annotations

import numpy as np


def encode(mask: np.ndarray) -> dict:
    """Binary mask (H, W) -> {'size': [H, W], 'counts': int32 array}."""
    H, W = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order='F').astype(bool)
    # run boundaries
    diffs = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    bounds = np.concatenate(([0], diffs, [flat.size]))
    counts = np.diff(bounds)
    if flat.size and flat[0]:
        counts = np.concatenate(([0], counts))  # first count is always a 0-run
    return {'size': [H, W], 'counts': counts.astype(np.int64)}


def decode(rle: dict) -> np.ndarray:
    """{'size', 'counts'} -> uint8 mask (H, W)."""
    H, W = rle['size']
    counts = np.asarray(rle['counts'], np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < H * W:
        flat = np.concatenate((flat, np.zeros(H * W - flat.size, np.uint8)))
    return flat.reshape((H, W), order='F')


def area(rle: dict) -> int:
    return int(np.sum(np.asarray(rle['counts'])[1::2]))
