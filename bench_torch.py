#!/usr/bin/env python3
"""The port's benchmark CLI: lc_tpu_torch timed on one CUDA card, mode for
mode as bench.py times lc_tpu (bench.py stays the JAX package's).

Default mode measures the production inference pipeline on the flagship
config (CDPN-ResNet34 dense head, 256² crops, batch 32): the axis-aligned
crop and normalization on the card, the CNN forward in bf16, dense decode
and point selection, RANSAC, the weighted LM refine (the hand-written LM
kernel, three launches a batch). Prints ONE JSON line: {"metric", "value",
"unit", "vs_baseline"}.

    python bench_torch.py                    # headline: inference, pose-consistent field
    python bench_torch.py --mode infer_raw   # same pipeline, raw untrained CNN output
    python bench_torch.py --mode int8        # headline pipeline, int8 CNN, dynamic scales
    python bench_torch.py --mode int8_static # headline pipeline, int8 CNN, static
                                             #   scales calibrated on the scene's crops
    python bench_torch.py --mode zebra | zebra_int8 | zebra_int8_static
                                             # Zebra-DeepLabV3 family end to end
    python bench_torch.py --mode sparse      # 16-keypoint family end to end
    python bench_torch.py --mode stages | zebra_stages
                                             # stage budget (crop/CNN/select/RANSAC
                                             #   hypotheses/LO/LM), cumulative prefixes
    python bench_torch.py --mode train | zebra_train
                                             # full train step (fwd + loss + bwd + opt)
    python bench_torch.py --mode train_trace | zebra_train_trace
                                             # train-step split: fwd / bwd / optimizer
    python bench_torch.py --mode mfu | zebra_mfu
                                             # CNN forward alone: ms, FLOPs, MFU
    python bench_torch.py --mode mfu_stages | zebra_mfu_stages
                                             # per-stage ms/GFLOP/MFU, isolated stages
    python bench_torch.py --mode int8_mfu | zebra_int8_mfu
                                             # forward bf16 vs int8 dynamic vs static
    python bench_torch.py --mode int8_stages | zebra_int8_stages
                                             # per-stage bf16/int8 ms
    python bench_torch.py --mode trace       # torch.profiler Chrome trace of six
                                             #   headline batches
    python bench_torch.py --mode ref         # the reference's host RANSAC pool here
    [--batch N] [--device cuda|cpu]

Runs on CUDA and raises without it unless --device cpu is given; on the
CPU every rate is the CPU's. Timing: a chain of steps, step i+1 reading a
value derived from step i's result, so the steps run one after another;
after WARMUP steps, each of TRIALS runs of ITERS steps between two CUDA
events (the end one synchronized), the median per step (the host clock on
the CPU). FLOPs come from torch.utils.flop_counter over one call; MFU is
against the card's dense peak from PEAK_OPS, null for a card not listed
there and on the CPU.

vs_baseline: the reference publishes no throughput. The denominator is the
measured rate of the reference's own mandatory host stage, its
cv2.solvePnPRansac multiprocessing pool (lib/pnp/cv2_solver.py:93-108,
run serially with the GPU every batch, test.py:120), on the host of the
H100 machine (`--mode ref`; REF_HOST_RANSAC_CROPS_PER_SEC below). That
stage alone bounds the reference's end-to-end crops/s on that host from
above, so vs_baseline understates the speedup.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import logging
import os
import tempfile
import time

import numpy as np
import torch

from lc_tpu_torch import resolve_device
from lc_tpu_torch.utils.profiling import profiler_trace, timed

# Measured with `python bench_torch.py --mode ref` on the H100 machine's
# host (see the module docstring): the reference's cv2-RANSAC pool, 32
# instances a batch, 716 points each, 150 iterations, Pool(6); 8 CPU
# cores (its /proc/cpuinfo names no model), beside an NVIDIA H100 80GB
# HBM3 at 700.00 W. Three runs: 139.84 / 120.85 / 108.52 crops/s; their
# mean.
REF_HOST_RANSAC_CROPS_PER_SEC = 123.07
BATCH = 32
# the first steps pay cuDNN's algorithm choice and the allocator's growth
WARMUP = 4
ITERS = 20
TRIALS = 4
# dense peaks of the cards MFU is computed for, by
# torch.cuda.get_device_name(): NVIDIA's H100 datasheet, SXM5, without
# sparsity (bf16 FLOP/s, int8 OP/s)
PEAK_OPS = {'NVIDIA H100 80GB HBM3': {'bf16': 989.4e12, 'int8': 1978.9e12}}
# the zebra family's Gray-code bits per axis (zlmo's 7/7/6)
BIT_CNT = (7, 7, 6)
SPARSE_CNT = 16
IN_RES = 256


@dataclasses.dataclass
class Run:
    """Where and how long a mode runs. `batches` counts the chained steps
    each label ran (one batch a step), for callers that count kernel
    launches."""
    device: torch.device
    batch: int = BATCH
    warmup: int = WARMUP
    iters: int = ITERS
    trials: int = TRIALS
    batches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)


def chained_rates(chains: dict, run: Run, iters: int | None = None,
                  trials: int | None = None) -> dict:
    """Median seconds per step of each chained computation in `chains`
    ({label: (step, x0)}), timed in turns so that a drift of the host or
    the card falls on all of them alike.

    step(x) -> x' must make step i+1 data-depend on step i. After
    run.warmup steps of each chain, each trial times `iters` steps of each
    chain in turn between two CUDA events on the current stream, the end
    event synchronized (on the CPU, the host clock around the steps, which
    run synchronously)."""
    iters = iters or run.iters
    trials = trials or run.trials
    cuda = run.device.type == 'cuda'
    xs = {}
    for label, (step, x) in chains.items():
        for _ in range(run.warmup):
            x = step(x)
        xs[label] = x
        run.batches[label] += run.warmup + iters * trials
    dts = {label: [] for label in chains}
    for _ in range(trials):
        for label, (step, _) in chains.items():
            x = xs[label]
            if cuda:
                torch.cuda.synchronize(run.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    x = step(x)
                end.record()
                end.synchronize()
                dts[label].append(start.elapsed_time(end) / 1e3 / iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    x = step(x)
                dts[label].append((time.perf_counter() - t0) / iters)
            xs[label] = x
    return {label: float(np.median(d)) for label, d in dts.items()}


def chained_rate(step, x0, run: Run, label: str, iters: int | None = None,
                 trials: int | None = None) -> float:
    """chained_rates of one chain."""
    return chained_rates({label: (step, x0)}, run, iters, trials)[label]


def flops_of(fn, *args) -> float:
    """FLOPs of one call, from torch.utils.flop_counter (matmuls and
    convolutions, forward and backward, 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def peak_ops(device: torch.device, kind: str) -> float | None:
    """The card's dense peak for `kind` ('bf16', 'int8'), None on the CPU
    and on a card PEAK_OPS does not list."""
    if device.type != 'cuda':
        return None
    return PEAK_OPS.get(torch.cuda.get_device_name(device), {}).get(kind)


def utilization(flops: float, seconds: float, peak: float | None):
    return None if peak is None or not flops or seconds <= 0 \
        else flops / seconds / peak


def _r(x, nd: int):
    return None if x is None else round(x, nd)


def peak_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')


# --------------------------------------------------------------------------
# the bench scene (bench.py's _bench_scene and pose-consistent field)
# --------------------------------------------------------------------------

def scene_arrays(batch: int, out_c: float) -> dict:
    """Frames (B, 480, 640, 3), 256² crop affines (B, 2, 3), the out-res
    camera K (B, 3, 3) with principal point out_c (half the dense output's
    side) and the gt blob's noc_scale: float32 numpy, bench.py's draws."""
    from lc_tpu_torch.geom.affine import crop_affine
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (batch, 480, 640, 3)).astype(np.float32)
    affs = []
    for _ in range(batch):
        c = rng.uniform(200, 440, 2)
        affs.append(crop_affine(c, float(rng.uniform(120, 260)), 0.0,
                                (IN_RES, IN_RES)))
    K = np.broadcast_to(np.asarray(
        [[572.4, 0, out_c], [0, 573.6, out_c], [0, 0, 1.0]], np.float32),
        (batch, 3, 3)).copy()
    return dict(frames=frames,
                affines=np.stack(affs).astype(np.float32), K=K,
                noc_scale=np.full((batch, 3), 100.0, np.float32))


def pose_field(K: np.ndarray) -> np.ndarray:
    """The pose-consistent 64² NOC field (B, 64, 64, 3) of bench.py: the GT
    pose's backprojection of random depths. With untrained weights the LM
    refiner would burn its 50-iteration budget on noise; the headline
    blends this field with 1e-3 of the head's output so the solver sees
    production-like convergence while the CNN stays in the measured graph
    (infer_raw runs without the blend)."""
    from scipy.spatial.transform import Rotation as sciR
    from lc_tpu_torch.geom.projection import gen_uv, xyz_from_homo_z
    batch = K.shape[0]
    rng = np.random.default_rng(0)
    Rs = sciR.random(batch, random_state=1).as_matrix().astype(np.float32)
    ts = np.concatenate((rng.uniform(-5, 5, (batch, 2)),
                         rng.uniform(400, 600, (batch, 1))), -1
                        ).astype(np.float32)
    uvg = gen_uv((64, 64)).numpy().reshape(-1, 2)
    z = rng.uniform(380, 620, (batch, 64 * 64, 1)).astype(np.float32)
    homo = np.concatenate((np.broadcast_to(uvg, (batch, 64 * 64, 2)) * z, z),
                          -1)
    xyz = xyz_from_homo_z(torch.from_numpy(homo), torch.from_numpy(Rs),
                          torch.from_numpy(ts), torch.from_numpy(K)).numpy()
    return (xyz / 100.0).reshape(batch, 64, 64, 3)


class Scene:
    """The scene on the device: frames, affines, the gt blob the solve
    reads, and the crop + normalization of the headline."""

    def __init__(self, run: Run, out_c: float):
        from lc_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
        arrays = scene_arrays(run.batch, out_c)
        dev = run.device
        self.frames = torch.from_numpy(arrays['frames']).to(dev)
        self.affines = torch.from_numpy(arrays['affines']).to(dev)
        self.K_np = arrays['K']
        self.gt = dict(out_K=torch.from_numpy(arrays['K']).to(dev),
                       noc_scale=torch.from_numpy(arrays['noc_scale']).to(dev))
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
        self.std = torch.as_tensor(IMAGENET_STD, device=dev)

    def crops(self, carry) -> torch.Tensor:
        """The normalized 256² crops of the frames shifted by `carry`."""
        from lc_tpu_torch.data.crop import batched_separable_warp
        crops = batched_separable_warp(self.frames + carry, self.affines,
                                       (IN_RES, IN_RES), 'bilinear',
                                       compute_dtype=torch.bfloat16)
        return (crops / 255.0 - self.mean) / self.std


def bench_model(family: str, device: torch.device, train: bool = False):
    """The family's network ('cdpn', 'zebra', 'sparse') with lc_tpu's
    initialization (seed 0), bf16 convolutions on the card."""
    from lc_tpu_torch.models import (build_model, default_compute_dtype,
                                     set_compute_dtype)
    from lc_tpu_torch.models.weights import init_weights
    if family == 'zebra':
        model = build_model('zebra_DeepLabV3', {'concat': True},
                            total_bit_cnt=sum(BIT_CNT))
    elif family == 'sparse':
        model = build_model('cdpn_resnet', {'concat': False},
                            sparse_cnt=SPARSE_CNT)
    else:
        model = build_model('cdpn_resnet', {'concat': False})
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).train(train)
    return set_compute_dtype(model, default_compute_dtype(device))


def noc_key(family: str) -> str:
    return 'xyz_noc_bin' if family == 'zebra' else 'xyz_noc'


def int8_forward(model, int8: str | None, calib_x=None):
    """The eval forward: bf16 (None), int8 with per-sample scales
    ('dynamic'), or int8 with per-convolution scales calibrated once,
    outside the timed chain, on `calib_x` ('static')."""
    if int8 is None:
        return model
    from lc_tpu_torch.models.quant import calibrate_act_scales, quantized_int8
    scales = calibrate_act_scales(model, [calib_x]) if int8 == 'static' \
        else None

    def forward(x):
        with quantized_int8(model, act_scales=scales):
            return model(x)
    return forward


# --------------------------------------------------------------------------
# end-to-end inference: headline, infer_raw, int8*, zebra*, sparse
# --------------------------------------------------------------------------

def build_inference(run: Run, family: str = 'cdpn', blend: bool = True,
                    int8: str | None = None):
    """(step, x0) of one family's inference chain. The carry is ~0 (1e-20
    of the mean solved pose), added to the next batch's frames; the RANSAC
    generator advances with every batch."""
    from lc_tpu_torch.inference import solve_pnp_dense, solve_pnp_sparse
    dev = run.device
    scene = Scene(run, out_c=64.0 if family == 'zebra' else 32.0)
    model = bench_model(family, dev)
    gt = dict(scene.gt)
    noc_field = None
    if family == 'cdpn' and blend:
        noc_field = torch.from_numpy(pose_field(scene.K_np)).to(dev)
    if family == 'sparse':
        # 16 FPS-like model keypoints (fixed per object in the reference's
        # assets/fps/lmo.pkl; any fixed spread-out set gives the solver
        # the same work)
        rng = np.random.default_rng(0)
        pts = rng.uniform(-50, 50, (SPARSE_CNT, 3)).astype(np.float32)
        gt['pts3d'] = torch.from_numpy(np.broadcast_to(
            pts, (run.batch, SPARSE_CNT, 3)).copy()).to(dev)
    with torch.no_grad():
        forward = int8_forward(model, int8,
                               scene.crops(torch.zeros((), device=dev)))
    generator = torch.Generator(device=dev).manual_seed(0)

    @torch.no_grad()
    def step(carry):
        out = dict(forward(scene.crops(carry)))
        if family == 'sparse':
            pose = solve_pnp_sparse(out, gt, generator,
                                    solvers=('ransac', 'weighted'),
                                    device=dev)['weighted']
        else:
            if noc_field is not None:
                out['xyz_noc'] = noc_field + 1e-3 * out['xyz_noc']
            zebra = family == 'zebra'
            pose = solve_pnp_dense(
                out, gt, generator, bit_cnt=BIT_CNT if zebra else None,
                sample=2,
                point_select='quantile_in_mask' if zebra else 'quantile',
                quantile=0.2 if zebra else 0.3, solvers=('weighted',),
                device=dev)['weighted']
        return 1e-20 * pose.mean()

    return step, torch.zeros((), device=dev)


def bench_inference(run: Run, family: str = 'cdpn', blend: bool = True,
                    int8: str | None = None) -> dict:
    with timed(f'{family} inference setup', sync=run.device):
        step, x0 = build_inference(run, family, blend, int8)
    dt = chained_rate(step, x0, run, 'inference')
    v = run.batch / dt
    if family == 'zebra':
        what = ('zebra crops/s end to end (crop->DeepLabV3 128² bits->Gray '
                'decode->PnP, raw untrained output')
    elif family == 'sparse':
        what = ('sparse-kpt crops/s end to end (crop->CDPN 16-kpt '
                'softargmax->16-pt RANSAC+LM, raw untrained output')
    else:
        what = ('crops/s end-to-end steady-state (crop->CNN->PnP, '
                + ('pose-consistent field' if blend
                   else 'raw untrained CNN output'))
    if int8:
        what += f', int8-{int8} CNN'
    return {
        "metric": f"{what}; batch {run.batch}, {peak_name(run.device)})",
        "value": round(v, 2),
        "unit": "crops/s/card",
        "vs_baseline": round(v / REF_HOST_RANSAC_CROPS_PER_SEC, 3),
    }


# --------------------------------------------------------------------------
# stage budgets: stages, zebra_stages
# --------------------------------------------------------------------------

STAGES = ('crop', 'cnn', 'select', 'hyp', 'ransac', 'lm')


def build_stage_prefix(run: Run, family: str, upto: str, scene: Scene,
                       model, noc_field):
    """The inference chain cut after `upto` (one of STAGES: 'hyp' is
    RANSAC's hypotheses and winner, 'ransac' adds its LO loop); each
    prefix's carry depends on everything it computed."""
    from lc_tpu_torch.inference import dense_grid_outputs, select_points
    from lc_tpu_torch.pnp.ransac import ransac_pnp
    from lc_tpu_torch.pnp.solver import lm_refine_auto
    zebra = family == 'zebra'
    gt = scene.gt
    generator = torch.Generator(device=run.device).manual_seed(0)

    @torch.no_grad()
    def step(carry):
        x = scene.crops(carry)
        if upto == 'crop':
            return 1e-20 * x.mean()
        out = dict(model(x))
        if upto == 'cnn':
            return 1e-20 * sum(v.float().mean() for v in out.values())
        if noc_field is not None:
            out['xyz_noc'] = noc_field + 1e-3 * out['xyz_noc']
        d = dense_grid_outputs(out, gt, bit_cnt=BIT_CNT if zebra else None,
                               sample=2)
        valid = select_points(
            d['inv_std2d'], d['seg_prob'],
            'quantile_in_mask' if zebra else 'quantile',
            0.2 if zebra else 0.3)
        if upto == 'select':
            return 1e-20 * (valid.float().mean() + d['pts3d'].mean())
        rr = ransac_pnp(gt['out_K'], d['pts3d'], d['pts2d'], generator,
                        valid=valid, reproj_threshold=3.0,
                        local_opt=upto != 'hyp')
        if upto in ('hyp', 'ransac'):
            return 1e-20 * rr.pose7.mean()
        lm = lm_refine_auto(rr.pose7, gt['out_K'], d['pts3d'], d['pts2d'],
                            d['inv_std2d'] ** 2, valid=valid, max_iter=50)
        return 1e-20 * lm.pose7.mean()

    return step, torch.zeros((), device=run.device)


def bench_stages(run: Run, family: str) -> dict:
    """Per-stage budget by successive prefix differencing."""
    scene = Scene(run, out_c=64.0 if family == 'zebra' else 32.0)
    model = bench_model(family, run.device)
    noc_field = None if family == 'zebra' else \
        torch.from_numpy(pose_field(scene.K_np)).to(run.device)
    totals = chained_rates(
        {s: build_stage_prefix(run, family, s, scene, model, noc_field)
         for s in STAGES}, run)
    budget, prev = {}, 0.0
    for s in STAGES:
        budget[s] = round((totals[s] - prev) * 1e3, 3)
        prev = totals[s]
    return {
        "metric": f"{family} inference stage budget ms/batch (cumulative-"
                  f"prefix differential; batch {run.batch}, "
                  f"{peak_name(run.device)}): {budget}",
        "value": round(totals['lm'] * 1e3, 3),
        "unit": "ms/batch total",
        "vs_baseline": None,
    }


# --------------------------------------------------------------------------
# the CNN forward alone: mfu, zebra_mfu, *_stages, int8_mfu
# --------------------------------------------------------------------------

def forward_stages(family: str, model, img) -> list:
    """Isolated stages of the family's forward: [(name, fn, its real
    input)], each input materialized by running the prefix once, and the
    decoder (ASPP for zebra) on the high-level feature with its skip inputs
    fixed. Cross-stage fusion is not captured, so the isolated sum may
    differ from the full forward (both are reported)."""
    x = img.permute(0, 3, 1, 2)
    if family == 'zebra':
        r = model.net.resnet
        stages = [('stem', r.resnet_layer_1),
                  ('maxpool+layer1', r.resnet_layer_2),
                  ('layer2', r.resnet_layer_3),
                  ('layer4(d2)', r.layer4),
                  ('layer5(d4)', r.layer5)]
    else:
        b = model.net.backbone
        stages = [('stem', lambda t: b.relu(b.bn1(b.conv1(t)))),
                  ('maxpool+layer1', lambda t: b.layer1(b.maxpool(t))),
                  ('layer2', b.layer2), ('layer3', b.layer3),
                  ('layer4', b.layer4)]
    specs = []
    with torch.no_grad():
        for name, fn in stages:
            specs.append((name, fn, x))
            x = fn(x)
    if family == 'zebra':
        x128, x64 = specs[1][2], specs[2][2]
        aspp = model.net.aspp
        specs.append(('aspp+upsample', lambda t: aspp(t, x128, x64), x))
    else:
        skips = (specs[2][2], specs[3][2], specs[4][2])
        dec = model.net.decoder
        specs.append(('decoder', lambda t: dec(t, skips), x))
    return specs


def leaf_sum(y) -> torch.Tensor:
    if torch.is_tensor(y):
        return y.float().sum()
    return sum(leaf_sum(v) for v in (y.values() if isinstance(y, dict)
                                     else y))


def time_stage(run: Run, fn, x_in, label: str, int8=None, model=None
               ) -> tuple[float, float]:
    """(ms, GFLOP) of one stage, chained on its input; int8 None, or the
    act_scales of quantized_int8 with 'dynamic' meaning None."""
    import contextlib
    from lc_tpu_torch.models.quant import quantized_int8

    def ctx():
        if int8 is None:
            return contextlib.nullcontext()
        return quantized_int8(model, act_scales=None if int8 == 'dynamic'
                              else int8)

    @torch.no_grad()
    def step(c):
        with ctx():
            y = fn(x_in + c.to(x_in.dtype))
        return 1e-20 * leaf_sum(y)

    with torch.no_grad():
        gf = flops_of(fn, x_in) / 1e9
    zero = torch.zeros((), device=run.device)
    dt = chained_rate(step, zero, run, label)
    # sub-ms stages: re-measure with enough steps for ~200 ms a trial
    iters = int(min(4000, max(run.iters, 0.2 / max(dt, 1e-5))))
    if iters > run.iters:
        dt = chained_rate(step, zero, run, label, iters=iters,
                          trials=max(run.trials, 5))
    return dt * 1e3, gf


def family_name(family: str) -> str:
    return 'Zebra-DeepLabV3' if family == 'zebra' else 'CDPN-ResNet34'


def bench_mfu(run: Run, family: str = 'cdpn') -> dict:
    """The CNN forward alone: ms/batch, FLOPs, MFU against the bf16 peak."""
    model = bench_model(family, run.device)
    img = torch.zeros((run.batch, IN_RES, IN_RES, 3), device=run.device)
    key = noc_key(family)

    @torch.no_grad()
    def step(x):
        return x + 1e-12 * model(x)[key].mean().to(x.dtype)

    with torch.no_grad():
        flops = flops_of(model, img)
    dt = chained_rate(step, img, run, 'forward')
    mfu = utilization(flops, dt, peak_ops(run.device, 'bf16'))
    return {
        "metric": f"CNN forward ({family_name(family)} 256², batch "
                  f"{run.batch}): {dt * 1e3:.2f} ms/batch, "
                  f"{flops / 1e9:.1f} GFLOP/batch, MFU vs the dense bf16 "
                  f"peak of {peak_name(run.device)}",
        "value": _r(mfu, 4),
        "unit": "MFU",
        "vs_baseline": None,
    }


def bench_mfu_stages(run: Run, family: str = 'cdpn') -> dict:
    """Forward per-stage budget by isolated stage timing."""
    model = bench_model(family, run.device)
    img = torch.zeros((run.batch, IN_RES, IN_RES, 3), device=run.device)
    peak = peak_ops(run.device, 'bf16')
    table = {}
    for name, fn, x_in in forward_stages(family, model, img):
        ms, gf = time_stage(run, fn, x_in, name)
        table[name] = [round(ms, 3), round(gf, 1),
                       _r(utilization(gf * 1e9, ms * 1e-3, peak), 3)]
    key = noc_key(family)
    full_ms, full_gf = time_stage(run, lambda x: model(x)[key], img, 'full')
    full_mfu = utilization(full_gf * 1e9, full_ms * 1e-3, peak)
    table['SUM(isolated)'] = [round(sum(v[0] for v in table.values()), 3),
                              None, None]
    table['full'] = [round(full_ms, 3), round(full_gf, 1), _r(full_mfu, 3)]
    return {
        "metric": f"{family} forward per-stage [ms, GFLOP, MFU] (isolated-"
                  f"stage timing; batch {run.batch}, "
                  f"{peak_name(run.device)}): {table}",
        "value": _r(full_mfu, 4),
        "unit": "MFU (full forward)",
        "vs_baseline": None,
    }


def bench_int8_stages(run: Run, family: str = 'cdpn') -> dict:
    """Per-stage bf16 vs int8 dynamic vs int8 static-scale ms."""
    from lc_tpu_torch.models.quant import STATIC_SCALE_ANY
    model = bench_model(family, run.device)
    img = torch.zeros((run.batch, IN_RES, IN_RES, 3), device=run.device)
    key = noc_key(family)
    specs = forward_stages(family, model, img) + [
        ('full', lambda x: model(x)[key], img)]
    table = {}
    for name, fn, x_in in specs:
        bf, gf = time_stage(run, fn, x_in, name)
        dyn, _ = time_stage(run, fn, x_in, name, 'dynamic', model)
        st, _ = time_stage(run, fn, x_in, name, STATIC_SCALE_ANY, model)
        table[name] = [round(bf, 3), round(dyn, 3), round(st, 3), round(gf, 1)]
    bf_full, _, st_full, _ = table['full']
    return {
        "metric": f"{family} forward per-stage [bf16 ms, int8-dynamic ms, "
                  f"int8-static ms, GFLOP] (isolated-stage timing; static = "
                  f"fixed act scales; batch {run.batch}, "
                  f"{peak_name(run.device)}): {table}",
        "value": round(bf_full / st_full, 4) if st_full > 0 else None,
        "unit": "int8-static speedup (full forward)",
        "vs_baseline": None,
    }


def bench_int8_mfu(run: Run, family: str = 'cdpn') -> dict:
    """Forward alone, bf16 vs int8: ms, effective TOPS, and int8 MFU
    against the int8 peak (work counted from the bf16 forward's FLOPs: the
    model's arithmetic, not the quantize passes)."""
    from lc_tpu_torch.models.quant import STATIC_SCALE_ANY, quantized_int8
    model = bench_model(family, run.device)
    img = torch.zeros((run.batch, IN_RES, IN_RES, 3), device=run.device)
    key = noc_key(family)

    def make(act_scales=None, int8=False):
        @torch.no_grad()
        def step(x):
            if int8:
                with quantized_int8(model, act_scales=act_scales):
                    out = model(x)
            else:
                out = model(x)
            return x + 1e-12 * out[key].mean().to(x.dtype)
        return step

    with torch.no_grad():
        flops = flops_of(model, img)
    dts = chained_rates({'bf16': (make(), img),
                         'int8_dynamic': (make(None, True), img),
                         'int8_static': (make(STATIC_SCALE_ANY, True), img)},
                        run)
    bf_dt, dyn_dt, st_dt = dts['bf16'], dts['int8_dynamic'], dts['int8_static']
    bf_mfu = utilization(flops, bf_dt, peak_ops(run.device, 'bf16'))
    int8_mfu = utilization(flops, st_dt, peak_ops(run.device, 'int8'))
    return {
        "metric": f"{family} forward bf16 {bf_dt * 1e3:.2f} ms "
                  f"({flops / 1e9:.0f} GFLOP, MFU {_r(bf_mfu, 3)}) | "
                  f"int8-dynamic {dyn_dt * 1e3:.2f} ms ({bf_dt / dyn_dt:.2f}x)"
                  f" | int8-static {st_dt * 1e3:.2f} ms "
                  f"({bf_dt / st_dt:.2f}x, {flops / st_dt / 1e12:.0f} "
                  f"effective TOPS, int8 MFU {_r(int8_mfu, 3)}; batch "
                  f"{run.batch}, {peak_name(run.device)})",
        "value": round(bf_dt / st_dt, 4),
        "unit": "int8-static speedup over bf16 (forward alone)",
        "vs_baseline": None,
    }


# --------------------------------------------------------------------------
# training: train, zebra_train, train_trace, zebra_train_trace
# --------------------------------------------------------------------------

def synthetic_gt_blob(batch: int, out_res: int = 16, in_res: int = 64
                      ) -> dict:
    """In-memory gt blob shaped like data.pipeline.device_preprocess's
    training output (a copy of lc_tpu's __graft_entry__._synthetic_gt_blob,
    which imports jax): numpy arrays."""
    from scipy.spatial.transform import Rotation as sciR
    rng = np.random.default_rng(0)
    K = np.array([[572.4, 0, 32.0], [0, 573.6, 32.0], [0, 0, 1]], np.float32)
    Rs = sciR.random(batch, random_state=0).as_matrix().astype(np.float32)
    ts = np.concatenate((rng.uniform(-10, 10, (batch, 2)),
                         rng.uniform(500, 700, (batch, 1))), -1
                        ).astype(np.float32)
    uv = np.stack(np.meshgrid(np.arange(out_res) + 0.5,
                              np.arange(out_res) + 0.5), -1).reshape(-1, 2)
    z = rng.uniform(550, 650, (batch, out_res * out_res, 1)).astype(np.float32)
    homo = np.concatenate((np.broadcast_to(uv, (batch,) + uv.shape) * z, z), -1)
    cands = np.concatenate((Rs, ts[..., None]), -1)[:, None].astype(np.float32)
    return dict(
        img_in=rng.normal(size=(batch, in_res, in_res, 3)).astype(np.float32),
        msk_vis=np.ones((batch, out_res, out_res), np.float32),
        msk_noc=np.ones((batch, out_res, out_res), np.float32),
        homo_z_out=homo.reshape(batch, out_res, out_res, 3).astype(np.float32),
        K_no_aug=np.broadcast_to(K, (batch, 3, 3)).copy(),
        R_no_aug=Rs, t_no_aug=ts,
        sym_ck_pts2d=np.zeros((batch, 16, 2), np.int32),
        Rt_candi=cands, candi_valid=np.ones((batch, 1), bool),
        noc_scale=np.full((batch, 3), 100.0, np.float32),
        out_K=np.broadcast_to(K, (batch, 3, 3)).copy(),
        bbox_3d=rng.uniform(-50, 50, (batch, 8, 3)).astype(np.float32),
        out_pix_scale=np.full((batch,), 3.0, np.float32),
        obj_id=np.ones((batch,), np.int32),
        im_id=np.arange(batch, dtype=np.int32),
        scene_id=np.ones((batch,), np.int32),
    )


class Training:
    """The family's flagship train step on an in-memory blob: CDPN-ResNet34
    (256² in, 64² out, LC loss, Ranger) or Zebra-DeepLabV3 (128² Gray-code
    output, binary-code + LC loss, Adam), dense_sample 2, bench.py's
    LossConfig numbers. One fixed sampling offset, as bench.py's fixed
    key gives."""

    def __init__(self, run: Run, family: str):
        from lc_tpu_torch.loss.loss_fn import LossConfig, init_loss_state
        from lc_tpu_torch.optim.ranger import Ranger
        dev = run.device
        self.zebra = family == 'zebra'
        self.model = bench_model(family, dev, train=True)
        params = self.model.parameters()
        if self.zebra:
            self.loss_cfg = LossConfig(
                w_loss_noc_bin=3.0, w_loss_seg=1.0, w_loss_pose=0.03,
                full_pose_loss_step=1, dense_sample=2, bit_cnt=BIT_CNT)
            self.optimizer = torch.optim.Adam(params, lr=2e-4, eps=1e-8)
        else:
            self.loss_cfg = LossConfig(
                w_loss_noc=1.0, w_loss_seg=0.25, w_loss_pose=0.02,
                full_pose_loss_step=1, dense_sample=2)
            self.optimizer = Ranger(params, lr=2e-4, weight_decay=1e-4)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda step: 1.0)
        blob = synthetic_gt_blob(run.batch, out_res=128 if self.zebra else 64,
                                 in_res=IN_RES)
        self.gt = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in blob.items()}
        self.loss_state = init_loss_state(self.loss_cfg, dev)
        self.top_left = torch.randint(
            0, self.loss_cfg.dense_sample, (2,),
            generator=torch.Generator().manual_seed(1)).tolist()
        self.device = dev

    def step(self, carry):
        """One train step; the carry is (loss state, step index): the
        weights and the optimizer's state chain in place."""
        from lc_tpu_torch.train_step import train_step
        loss_state, i = carry
        loss_state, _ = train_step(self.model, self.optimizer, self.scheduler,
                                   self.loss_cfg, loss_state, self.gt, i,
                                   self.top_left)
        return loss_state, i + 1

    def loss_value(self, img):
        from lc_tpu_torch.loss.loss_fn import make_taps
        from lc_tpu_torch.train_step import forward_losses
        total, _, _ = forward_losses(
            self.model, self.loss_cfg, self.loss_state,
            dict(self.gt, img_in=img), 1, self.top_left,
            make_taps(self.device))
        return total

    def forward_only(self, carry):
        with torch.no_grad():
            return 1e-20 * self.loss_value(self.gt['img_in'] + carry)

    def forward_backward(self, carry):
        self.model.zero_grad(set_to_none=True)
        self.loss_value(self.gt['img_in'] + carry).backward()
        grads = [p.grad.sum() for p in self.model.parameters()
                 if p.grad is not None]
        return 1e-20 * torch.stack(grads).sum().detach()


def bench_train(run: Run, family: str = 'cdpn') -> dict:
    """Full train step at flagship shapes (fwd + loss + bwd + optimizer)."""
    tr = Training(run, family)
    dt = chained_rate(tr.step, (tr.loss_state, 0), run, 'train')
    v = run.batch / dt
    what = ('zebra train crops/s (fwd + bin-code + LC loss + bwd + Adam, '
            f'batch {run.batch}, 256² in / 128² out' if tr.zebra else
            'train crops/s (fwd + LC loss + bwd + Ranger, '
            f'batch {run.batch}, 256² in / 64² out')
    return {
        "metric": f"{what}, dense_sample=2, {peak_name(run.device)})",
        "value": round(v, 2),
        "unit": "crops/s/card",
        "vs_baseline": None,
    }


def bench_train_split(run: Run, family: str = 'cdpn') -> dict:
    """Train-step budget: forward + loss / backward / optimizer, by the
    chained rates of the loss alone, the loss and its gradients, and the
    full step, with the FLOPs of the first two, so the backward's MFU is
    measured, not inferred."""
    tr = Training(run, family)
    zero = torch.zeros((), device=run.device)
    gf_f = flops_of(tr.forward_only, zero) / 1e9
    gf_fb = flops_of(tr.forward_backward, zero) / 1e9
    dts = chained_rates({'forward': (tr.forward_only, zero),
                         'forward_backward': (tr.forward_backward, zero),
                         'train': (tr.step, (tr.loss_state, 0))}, run)
    t_f, t_fb, t_full = dts['forward'], dts['forward_backward'], dts['train']
    peak = peak_ops(run.device, 'bf16')
    mfu_f = utilization(gf_f * 1e9, t_f, peak)
    mfu_bwd = utilization((gf_fb - gf_f) * 1e9, t_fb - t_f, peak)
    split = dict(fwd_ms=round(t_f * 1e3, 2),
                 bwd_ms=round((t_fb - t_f) * 1e3, 2),
                 optimizer_and_rest_ms=round((t_full - t_fb) * 1e3, 2),
                 full_step_ms=round(t_full * 1e3, 2),
                 fwd_gflop=round(gf_f, 1), bwd_gflop=round(gf_fb - gf_f, 1),
                 fwd_mfu=_r(mfu_f, 3), bwd_mfu=_r(mfu_bwd, 3))
    return {
        "metric": f"train-step budget ({family} flagship, batch {run.batch}, "
                  f"{peak_name(run.device)}): {split}",
        "value": split['full_step_ms'],
        "unit": "ms/step",
        "vs_baseline": None,
    }


# --------------------------------------------------------------------------
# trace, ref
# --------------------------------------------------------------------------

TRACE_BATCHES = 6


def bench_trace(run: Run) -> dict:
    """A torch.profiler Chrome trace of TRACE_BATCHES headline batches in
    <temp dir>/lc_tpu_torch_trace (open the .json in Perfetto or
    chrome://tracing)."""
    out_dir = os.path.join(tempfile.gettempdir(), 'lc_tpu_torch_trace')
    step, x = build_inference(run, 'cdpn', blend=True)
    for _ in range(run.warmup):
        x = step(x)
    with profiler_trace(out_dir) as prof:
        for _ in range(TRACE_BATCHES):
            x = step(x)
        if run.device.type == 'cuda':
            torch.cuda.synchronize(run.device)
    run.batches['inference'] += run.warmup + TRACE_BATCHES
    mib = os.path.getsize(prof.trace_path) / 2 ** 20
    return {
        "metric": f"torch.profiler trace of {TRACE_BATCHES} inference batches"
                  f" -> {prof.trace_path}",
        "value": round(mib, 2),
        "unit": "MiB",
        "vs_baseline": None,
    }


def _ref_solve_one(args):
    import cv2
    p3, uv, Km = args
    return cv2.solvePnPRansac(p3, uv, Km, None, iterationsCount=150,
                              reprojectionError=3.0, confidence=0.99,
                              flags=cv2.SOLVEPNP_EPNP)[0]


def _ref_problem(i: int, n_pts: int, K: np.ndarray):
    from scipy.spatial.transform import Rotation as sciR
    r = np.random.default_rng(i)
    R = sciR.random(random_state=i).as_matrix()
    t = np.concatenate((r.uniform(-5, 5, 2), r.uniform(400, 600, 1)))
    p3 = r.uniform(-50, 50, (n_pts, 3))
    uv = (p3 @ R.T + t) @ K.T
    uv = uv[:, :2] / uv[:, 2:3] + r.normal(0, 2.0, (n_pts, 2))
    return p3.astype(np.float32), uv.astype(np.float32), K.astype(np.float32)


def bench_ref(run: Run) -> dict:
    """The reference's mandatory host stage measured on this host: its
    cv2-RANSAC pool (which bounds the reference's end-to-end crops/s from
    above). Needs no card."""
    import multiprocessing
    K = np.array([[572.4, 0, 32.0], [0, 573.6, 32.0], [0, 0, 1.0]])
    # the reference's dense path, quantile 0.3 of the 32² sampled grid
    n_pts = 716
    problems = [_ref_problem(i, n_pts, K) for i in range(run.batch)]
    # the reference's cv2_solver.get_workers: multiprocessing.Pool(6)
    with multiprocessing.get_context('spawn').Pool(6) as pool:
        pool.map(_ref_solve_one, problems)      # warm
        n_rep = 10
        t0 = time.perf_counter()
        for _ in range(n_rep):
            pool.map(_ref_solve_one, problems)
        dt = (time.perf_counter() - t0) / n_rep
    return {
        "metric": "MEASURED reference host stage: cv2.solvePnPRansac "
                  f"pool(6), {n_pts} pts, 150 iters, batch {run.batch} "
                  "(upper-bounds reference end-to-end crops/s on this host; "
                  "lib/pnp/cv2_solver.py:93-108, test.py:120)",
        "value": round(run.batch / dt, 2),
        "unit": "crops/s",
        "vs_baseline": 1.0,
    }


MODES = {
    'headline': lambda r: bench_inference(r, 'cdpn', blend=True),
    'infer_raw': lambda r: bench_inference(r, 'cdpn', blend=False),
    'train': lambda r: bench_train(r, 'cdpn'),
    'mfu': lambda r: bench_mfu(r, 'cdpn'),
    'ref': bench_ref,
    'trace': bench_trace,
    'zebra': lambda r: bench_inference(r, 'zebra'),
    'stages': lambda r: bench_stages(r, 'cdpn'),
    'zebra_stages': lambda r: bench_stages(r, 'zebra'),
    'zebra_mfu': lambda r: bench_mfu(r, 'zebra'),
    'zebra_train': lambda r: bench_train(r, 'zebra'),
    'train_trace': lambda r: bench_train_split(r, 'cdpn'),
    'sparse': lambda r: bench_inference(r, 'sparse'),
    'mfu_stages': lambda r: bench_mfu_stages(r, 'cdpn'),
    'int8': lambda r: bench_inference(r, 'cdpn', int8='dynamic'),
    'zebra_int8': lambda r: bench_inference(r, 'zebra', int8='dynamic'),
    'zebra_mfu_stages': lambda r: bench_mfu_stages(r, 'zebra'),
    'int8_mfu': lambda r: bench_int8_mfu(r, 'cdpn'),
    'zebra_int8_mfu': lambda r: bench_int8_mfu(r, 'zebra'),
    'int8_stages': lambda r: bench_int8_stages(r, 'cdpn'),
    'zebra_int8_stages': lambda r: bench_int8_stages(r, 'zebra'),
    'zebra_train_trace': lambda r: bench_train_split(r, 'zebra'),
    'int8_static': lambda r: bench_inference(r, 'cdpn', int8='static'),
    'zebra_int8_static': lambda r: bench_inference(r, 'zebra',
                                                   int8='static'),
}


def run_mode(mode: str, run: Run) -> dict:
    """One mode's JSON line (as a dict)."""
    return MODES[mode](run)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--mode', default='headline', choices=list(MODES))
    ap.add_argument('--batch', type=int, default=BATCH,
                    help='the batch size (default 32, the reference '
                         "config's; larger batches amortize fixed per-batch "
                         'work: the throughput-serving regime)')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default; raises without a card) or cpu')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format='%(name)s: %(message)s')
    run = Run(device, batch=args.batch, warmup=WARMUP, iters=ITERS,
              trials=TRIALS)
    print(json.dumps(run_mode(args.mode, run)), flush=True)


if __name__ == '__main__':
    main()
