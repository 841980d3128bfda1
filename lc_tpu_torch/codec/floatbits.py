"""ZebraPose-style Gray-code NOC codec, "floatbits" (counterpart of
lc_tpu/codec/floatbits.py): the encoding, the inference decode and the
straight-through training decode with the GT bits.

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


def _decode_axis_with_gt(logits: torch.Tensor, gt_raw_bits: torch.Tensor,
                         gt_msk: torch.Tensor, black_background: bool
                         ) -> torch.Tensor:
    """Training decode of one axis, straight through at the most
    significant wrong bit: logits (..., n) Gray logits, gt_raw_bits (..., n)
    bool plain binary, gt_msk (...) bool. Inside the mask the value is the
    GT above that bit plus the sigmoid of its binary logit times its weight,
    the only gradient path; outside it the hard decode, detached. Returns a
    value in [0, 2^n - 1]."""
    n = logits.shape[-1]
    # conditioned on the GT's binary bit i-1, Gray bit i's logit becomes
    # binary bit i's with its sign flipped where that GT bit is set; the
    # first two carry the black_background flip
    prev_gt = torch.cat((torch.zeros_like(gt_raw_bits[..., :1]),
                         gt_raw_bits[..., :-1]), -1)
    sign = 1.0 - 2.0 * prev_gt.to(logits.dtype)
    bb = torch.tensor([-1.0 if black_background and i < 2 else 1.0
                       for i in range(n)], dtype=logits.dtype,
                      device=logits.device)
    bin_logits = logits * sign * bb          # > 0: binary bit predicted 1
    pred_bits = bin_logits > 0
    w = 2.0 ** torch.arange(n - 1, -1, -1, dtype=logits.dtype,
                            device=logits.device)
    out_msk_vals = (pred_bits.to(logits.dtype) * w).sum(-1)

    err = pred_bits ^ gt_raw_bits
    err[..., -1] = True                      # a hit always; the LSB is soft
    # the first True: argmax over an integer cast (ties go to the lowest
    # index in torch's argmax on both devices, a documented guarantee)
    err_msb = torch.argmax(err.to(torch.uint8), -1)
    onehot = torch.nn.functional.one_hot(err_msb, n).to(logits.dtype)
    correct_part = (gt_raw_bits.to(logits.dtype) * (1.0 - onehot) * w).sum(-1)
    picked_logit = (bin_logits * onehot).sum(-1)
    picked_weight = (w * onehot).sum(-1)
    in_msk_vals = correct_part + torch.sigmoid(picked_logit) * picked_weight
    return torch.where(gt_msk, in_msk_vals, out_msk_vals.detach())


def logits_to_noc_with_gt(logits: torch.Tensor, gt_raw_bits: torch.Tensor,
                          bit_cnt: Sequence[int], gt_msk: torch.Tensor,
                          black_background: bool) -> torch.Tensor:
    """Training decode: Gray logits (..., sum(bit_cnt)), the GT's plain
    binary bits and the GT mask (...) -> NOC (..., 3)."""
    vals = [_decode_axis_with_gt(logits[..., sl], gt_raw_bits[..., sl], gt_msk,
                                 black_background) / ((2 ** n - 1) * 0.5) - 1.0
            for sl, n in zip(_axis_slices(bit_cnt), bit_cnt)]
    return torch.stack(vals, -1)


def noc_to_nn_target(noc: torch.Tensor, bit_cnt: Sequence[int],
                     black_background: bool
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """GT NOC -> (the training target, the Gray bits as float32; the plain
    binary bits, bool), channel-last."""
    mod_bits, raw_bits = noc_to_bits(noc, bit_cnt, black_background)
    return mod_bits.to(torch.float32), raw_bits
