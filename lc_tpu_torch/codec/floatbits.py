"""ZebraPose-style Gray-code NOC codec, "floatbits" (counterpart of
lc_tpu/codec/floatbits.py; the inference decode, the training decode with
GT arrives with the zebra training slice).

Each NOC axis in (-1, 1) is quantized to 2^n bins, binary-expanded MSB
first and turned into Gray code; under `black_background` the two most
significant Gray bits are flipped, so an all-zero (background) prediction
decodes away from the object. Bits lie on the trailing axis; `bit_cnt` is
a tuple of 3 ints, the bits of each NOC axis.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def calc_bit_count(sizes: Sequence[float], max_bits: int = 7,
                   min_bits: int = 2) -> list[int]:
    """Bits per NOC axis from the object's extent along it."""
    max_size = max(sizes)
    return [max(min_bits, round(max_bits + math.log2(s / max_size)))
            for s in sizes]


def _axis_slices(bit_cnt: Sequence[int]):
    out, start = [], 0
    for n in bit_cnt:
        out.append(slice(start, start + n))
        start += n
    return out


def _binary_to_gray(bits: torch.Tensor) -> torch.Tensor:
    """MSB-first binary -> Gray: g[0] = b[0], g[i] = b[i] ^ b[i-1]."""
    shifted = torch.cat((torch.zeros_like(bits[..., :1]), bits[..., :-1]), -1)
    return bits ^ shifted


def _gray_to_binary(gray: torch.Tensor) -> torch.Tensor:
    """MSB-first Gray -> binary: b[i] = g[0] ^ ... ^ g[i]."""
    acc = gray[..., 0]
    cols = [acc]
    for i in range(1, gray.shape[-1]):
        acc = acc ^ gray[..., i]
        cols.append(acc)
    return torch.stack(cols, -1)


def _flip_bb(bits: torch.Tensor, black_background: bool) -> torch.Tensor:
    if not black_background:
        return bits
    return torch.cat((~bits[..., :2], bits[..., 2:]), -1)


def noc_to_bits(noc: torch.Tensor, bit_cnt: Sequence[int],
                black_background: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """NOC (..., 3) in (-1, 1) -> (mod_bits, raw_bits), each (...,
    sum(bit_cnt)) bool: the (optionally flipped) Gray code the network
    predicts, and the plain binary expansion."""
    mod_parts, raw_parts = [], []
    for axis, n in enumerate(bit_cnt):
        max_num = 2 ** n - 1
        ints = torch.clamp(torch.round((noc[..., axis] + 1.0)
                                       * (max_num * 0.5)), 0, max_num)
        shifts = torch.arange(n - 1, -1, -1, device=noc.device)
        raw = ((ints.to(torch.int32)[..., None] >> shifts) & 1).bool()
        mod_parts.append(_flip_bb(_binary_to_gray(raw), black_background))
        raw_parts.append(raw)
    return torch.cat(mod_parts, -1), torch.cat(raw_parts, -1)


def bits_to_int(bits: torch.Tensor) -> torch.Tensor:
    """MSB-first bool bits (..., n) -> int32 (...)."""
    n = bits.shape[-1]
    w = 2 ** torch.arange(n - 1, -1, -1, dtype=torch.int32, device=bits.device)
    return (bits.to(torch.int32) * w).sum(-1, dtype=torch.int32)


def _decode_axis_soft(logits: torch.Tensor, black_background: bool
                      ) -> torch.Tensor:
    """Gray logits (..., n) of one axis -> a value in [0, 2^n - 1]: the
    integer part by hard Gray decoding, the LSB replaced by a sigmoid of the
    last logit, sign-corrected so the value moves the right way (sub-bin
    resolution)."""
    val = bits_to_int(_gray_to_binary(_flip_bb(logits > 0, black_background)))
    lsb_factor = (1 - (val & 2)).to(logits.dtype)     # ±1 by binary bit 1
    # for n <= 2 the last Gray bit lies inside the flipped prefix, so its
    # logit's sign is stored inverted (README: the fixed soft-LSB decode)
    if black_background and logits.shape[-1] <= 2:
        lsb_factor = -lsb_factor
    soft_lsb = torch.sigmoid(logits[..., -1] * lsb_factor)
    return (val & -2).to(logits.dtype) + soft_lsb


def logits_to_noc(logits: torch.Tensor, bit_cnt: Sequence[int],
                  black_background: bool) -> torch.Tensor:
    """Inference decode: Gray logits (..., sum(bit_cnt)) -> NOC (..., 3) in
    (-1, 1)."""
    vals = [_decode_axis_soft(logits[..., sl], black_background)
            / ((2 ** n - 1) * 0.5) - 1.0
            for sl, n in zip(_axis_slices(bit_cnt), bit_cnt)]
    return torch.stack(vals, -1)
