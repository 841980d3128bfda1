#!/usr/bin/env python3
"""Run the PyTorch port (lc_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. versions, the card's name and power limit; build every CUDA kernel from
     lc_tpu_torch/csrc with nvcc (one process per source, all at once);
  2. each kernel against its plain PyTorch version on the card, at the shapes
     the main paths give it, with the stated tolerance, and both timed with
     CUDA events; for the LM kernel (B1) also the weight and mask forms,
     ragged rows, running out of iterations with either fallback, zlmo's
     16,384 points and gsplmo's 16 a problem, its ceiling of points (beyond
     it a call raises), and one device operation per call;
  3. the oracles: frames rendered in memory, the outputs a perfect network
     would give fed to the path's solve as network output (glmo: the exact
     NOC map; zlmo: the exact Gray logits of it; gsplmo: keypoint heatmaps
     peaked at the GT projections); poses must recover and the LM kernel
     must run exactly 3 times (2 LO-RANSAC polishes + 1 final refine);
  4. the main paths, each through harness.run_test on in-memory batches
     and evaluator, seeded weights carried in through state_dict_from_flax,
     kernel launch counts zeroed just before and read just after, then a
     stage breakdown of one more batch: glmo (CDPN-ResNet34, 256² in, 64²
     out, batch 32), zlmo (ZebraDeepLabV3 with 20 Gray bits, 128² out,
     every pixel a correspondence, quantile_in_mask, per-crop thresholds,
     weighted_filtered; the random head's visibility logit shifted so that
     its mask keeps the object's share of the grid; with the bf16 forward's
     Gray bits against f32's), gsplmo (the 16-keypoint head, ransac +
     weighted); then the LM kernel against its plain version on every
     path's own inputs (both LO polishes and the final refine of each
     oracle's solve and of each path's last batch, over LM_SWEEP_SEEDS
     RANSAC draws), a problem outside the tolerance judged by the plain
     version in float64 (referee); then RANSAC's hypothesis kernel
     (minimal6, phase_minimal6) against its plain version
     (pnp/fast_minimal.py, lc_tpu's accelerator branch) at B = 32, K = 150:
     (a) noise-free well-spread samples, (b) samples on a plane, (c) 1 px
     noise, made as lc_tpu's tests/test_pnp.py makes them, and (d) the
     samples of each path's and oracle's own first RANSAC draw, each
     estimator held to MINIMAL6_TOL, every pose finite, the kernel timed
     (CUDA events; device time from the profiler) beside the plain version
     and its bound (the plain version's counted f32 operations over the
     f32 rate without multiply-add fusion), with the lanes an EPnP problem
     and ptxas's registers and spill bytes. Every path, oracle,
     int8 run, CLI and bench mode launches minimal6 once a ransac_pnp call,
     and no hypothesis stage on the card reaches the generic estimators
     (guard_generic_hypotheses);
  5. the shear kernel (B2) against its plain version at the glmo rotated
     crop's shapes, timed beside grid_sample over buffers the L2 cannot
     hold, the column pass on random per-column shifts and sizes off its
     tile, and the composed rotated crop with the kernel against the same
     composition with the plain shear;
  6. the training paths, each with dataloader.device_rotate on and the LC
     loss at full weight from step 1, at its config's widths and batch:
     glmo (CDPN-ResNet34, background switching), zlmo (ZebraDeepLabV3, 20
     Gray bits under black_background, the binary-code loss and the LC
     loss on the straight-through decode; rotate_prob 0, so the shear
     kernel's six launches a step run at angle 0; with the training decode
     on the card held to the CPU's) and gsplmo (the 16-keypoint head, the
     keypoint NLL and the sparse LC loss; real rotations); six steps of
     the train loop's in-line staging (data/pipeline.device_prefetch of
     size 0 through train.preprocess_step) + train_step on in-memory
     blobs (the first untimed), with the counts zeroed before and read after, the loss
     terms, the clip threshold and the Gray-bit histogram checked; then a
     stage breakdown of one more step and its device-busy share;
  7. the train CLI on the card: `python -m lc_tpu_torch.train`'s main on a
     generated BOP tree (glmo widths and batch, device_rotate, background
     images, the host loader in threads), six steps with an evaluation
     through harness.run_test after step 3, counts zeroed before and read
     after; then `python -m lc_tpu_torch.test` on its model_final; then the
     test CLI on configs/zsyn.yaml's and configs/gspsyn.yaml's generated
     trees (3 batches each, random-weight .pth files); then the train CLI
     on zsyn (a second split mixed in as train_dataset_1: RatioMixLoader;
     sym_aware from step 0) and gspsyn trees, six steps with an evaluation
     after step 3, a run resumed from the step-3 checkpoint that must start
     from its stored histogram and clip thresholds, and the test CLI on
     model_final;
     With the glmo tree also: the host loader alone, threads (Loader) and
     processes (MPLoader), here and on the zsyn and gspsyn trees; the train
     CLI with dataloader.multiprocess (MPLoader), resumed from step 3 to
     the uninterrupted run's step-6 loss; the test CLI on a .ckpt written
     in lc_tpu's format (pickled envelope, flax msgpack, written by this
     script's own packer) against the same weights as a .pth (the same CSV
     rows); zsyn's test CLI with eval_bop_scores (BOP'19 mssd/mspd ARs);
     then, on the same glmo tree, the data-parallel phase
     (phase_data_parallel): the train CLI without device prefetch against
     the prefetched run (every step's staged input bit-equal); one NCCL
     rank in this process (a FileStore group,
     train(..., parallel=group)), first one float64 step of the
     data-parallel path against the one-process step, then the train CLI
     and the one-process test CLI on its model_final; two gloo ranks on
     the one card, each a spawned child on cuda:0 with 16 crops a step (a
     float64 step of two ranks against one process, the train CLI, a
     resume from step 3, the test CLI, every file and directory each rank
     writes recorded: rank 1 none), their test CLI's CSV rows against the
     one-process run's; each run's step losses held to the one-process
     run's, its launches counted per rank;
  8. after the main paths, int8 inference on glmo and zlmo (phase_int8):
     the torch._int_mm accumulators of a stem at odd size, 3x3, dilated,
     deconvolution and head layers against the plain version (exact), the
     int8 forward (dynamic and static) within lc_tpu's bf16 yardstick,
     forward ms against bf16, and harness.run_test with int8_inference in
     both modes; every stage breakdown also reads RANSAC's device
     operations and largest allocations;
     then perf_scripts/learned_syn.py, which runs the learned results
     (phase_learned_driver): its syn-s42 arm at configs/syn.yaml's widths
     and batch cut to 20 steps on a generated 48/8-view tree, the train CLI
     and the arm's four test CLI evaluations each a process of its own;
     every output line parsed and checked, B1 3 and minimal6 1 launch a
     batch in each evaluation on the card;
  9. bench_torch.py, the port's benchmark CLI (phase_bench): its
     headline, infer_raw, int8_static, zebra, sparse, stages, train,
     train_trace and mfu modes in this process at reduced iterations, each
     line with its four keys and a finite positive value, MFU in (0, 1.05]
     (null off a card bench_torch has a peak for), the LM kernel launched
     3 times a batch in every inference mode (2 a batch in the stage
     budget's RANSAC prefix, 3 in its LM prefix) and no kernel in the
     training modes; then `python bench_torch.py` alone, its line last;
 10. summary lines (minimal6's sets, times, bound and spill bytes; the
     launches of the three kernels by path), one JSON line of kernel
     numbers (lm_refine, shear_x, minimal6, with every path's launches,
     each gloo rank's apart), the card line, and the final
     {"ok": true, "device": ...} line.
Imports torch, numpy, scipy, the standard library and the port only. Exits
non-zero without a CUDA device, or outside a checkout of the repository.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# The data sheet's f32 rate counts a fused multiply-add as two operations.
# The kernels built with -fmad=false (lm_refine, minimal6) issue every
# counted multiply or add as its own instruction: 128 f32 lanes x 132 SMs
# x 1.98 GHz (boost clock) a second
PEAK_F32_UNFUSED_OPS = 128 * 132 * 1.98e9
# its L2 (data sheet): a kernel timed against the HBM bound cycles through
# copies of its inputs that this cannot hold
L2_BYTES = 50 * 2 ** 20

# glmo (configs/glmo.yaml): widths, batch, point selection, solvers
GLMO = dict(net_name='cdpn_resnet', net_input_wh=(256, 256),
            net_output_wh=(64, 64), batch_size=32, dense_sample=2,
            point_select='quantile', quantile=0.3, solvers=('weighted',))
# zlmo (configs/zlmo.yaml): the zebra family, Gray codes of up to 7 bits an
# axis (7/7/6 for the synthetic box) under black_background, every pixel of
# the 128² output a correspondence (16,384 a problem)
ZLMO = dict(net_name='zebra_DeepLabV3', net_input_wh=(256, 256),
            net_output_wh=(128, 128), batch_size=32, max_bit_cnt=7,
            black_background=True, dense_sample=1,
            point_select='quantile_in_mask', quantile=0.2,
            rel_reproj_err=True, solvers=('weighted_filtered',))
# gsplmo (configs/gsplmo.yaml): the sparse family, 16 keypoints
GSPLMO = dict(net_name='cdpn_resnet', net_input_wh=(256, 256),
              net_output_wh=(64, 64), batch_size=32, sparse_cnt=16,
              solvers=('ransac', 'weighted'))
# the synthetic box of data/synthetic.py (render_eval_set's default)
BOX_HALF_EXTENTS = (40.0, 30.0, 20.0)
N_BATCHES = 3
# the RANSAC draws of each path's batch whose LM inputs the kernel is held on
LM_SWEEP_SEEDS = range(4)
# kernel-vs-plain tolerance (that of tests/test_pallas_lm.py); the cost's
# relative error is taken beyond float32's floor (cost_floor)
TOL = dict(translation_atol=0.05, quat_dot_min=1 - 1e-5, cost_rtol=1e-3)
# the shear kernel against its plain version: atol on 0-255 values (that of
# tests/test_pallas_warp.py)
SHEAR_ATOL = 5e-4
# the minimal6 kernel against its plain version (fast_minimal), per
# estimator (tests/test_torch_fast_minimal.py's tolerances): ok agreeing on
# >= 99% of problems, every pose finite, and over jointly valid problems:
# noise_free (EPnP, planar) the 99th percentile of the translation
# difference (largest coordinate) < 0.05 mm and the 1st percentile of
# |q·q'| > 1 - 1e-5; noisy (1 px, the paths' own samples) lc_tpu's _pin
# bounds, median translation distance < 0.1 mm and 90th percentile < 5 mm;
# dlt the quantiles of tests/test_torch_ransac.py:86-88 (median < 0.1 mm,
# 90th percentile < 1 mm, 10th percentile of |q·q'| > 1 - 1e-4)
MINIMAL6_TOL = dict(
    noise_free=dict(ok_agree=0.99, t_p99=0.05, qdot_p01=1 - 1e-5),
    noisy=dict(ok_agree=0.99, dist_p50=0.1, dist_p90=5.0),
    dlt=dict(ok_agree=0.99, t_p50=0.1, t_p90=1.0, qdot_p10=1 - 1e-4))
# the hypothesis stage's inputs of each path's and oracle's first RANSAC
# draw (path_lm_inputs), which phase_minimal6 holds the kernel on
HYPOTHESIS_INPUTS = {}
TRAIN_STEPS = 6
# Two train CLI runs on the same batches agree past their first backward
# only within the card's run-to-run spread: the backward is not
# bit-reproducible there (atomic adds, the decoder's bilinear upsampling
# among them), and BatchNorm's backward and the LC loss amplify it. Three
# sets of glmo runs, each run in a process of its own, whose step-1 losses
# and staged inputs were bit-equal (perf_scripts/train_cli_rerun_spread.py,
# NVIDIA H100 80GB HBM3, 700 W): step 6's loss 1.25e-4, 9.4e-5 and 2.2e-4
# apart, the largest each time among the prefetched runs (the side
# stream's kernels run beside the backward's atomics), and a resume check
# read 1.74e-4. A re-fed or resumed run's step-6 loss is held to
# RERUN_RTOL, about 3x the largest; grad_norm, which spreads 4e-4 to 2e-3
# at step 1, is reported, not held. The loss cannot tell a faulty resume
# from a correct one (perf_scripts/dp_fault_gaps.py: a resume without the
# optimizer's state or the clip thresholds read 9.8e-5 and 8.9e-5 at step
# 6), so a resume is held on the state entering its first step, bit for
# bit (held_resumed).
RERUN_RTOL = 7e-4
# the profiler ranges of one training step (data/pipeline.device_prefetch
# and train.preprocess_step staging in line, train_step)
TRAIN_STAGES = ('h2d', 'preprocess', 'forward', 'targets_losses', 'backward',
                'optimizer')
# bench_torch.py's modes phase_bench runs, the inference ones among them,
# and their reduced chain (bench_torch.Run): 12 batches a chain
BENCH_MODES = ('headline', 'infer_raw', 'int8_static', 'zebra', 'sparse',
               'stages', 'train', 'train_trace', 'mfu')
BENCH_INFERENCE = ('headline', 'infer_raw', 'int8_static', 'zebra', 'sparse')
BENCH_RUN = dict(warmup=2, iters=5, trials=2)
BENCH_KEYS = {'metric', 'value', 'unit', 'vs_baseline'}
# flops per output element of the shear (source position, floor, fraction,
# 1 - f, the two-tap lerp), for its roofline bound
SHEAR_FLOPS_PER_ELEM = 6


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_call_ms(fn, windows: int = 5, reps: int = 40) -> float:
    """Time per call of fn (CUDA events), the median over `windows` windows
    of `reps` calls: a call whose host work outlasts its device work is
    timed by the host, whose clock the machine's other work disturbs."""
    return float(np.median([time_ms(fn, reps=reps, warmup=2)
                            for _ in range(windows)]))


def rotating(fn, sets):
    """A call of fn on each argument set in turn."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def l2_cold_sets(args, touched_bytes: int) -> list:
    """Copies of the tensors `args` enough that between two uses of one
    copy the other calls touch at least twice the L2 (`touched_bytes` per
    call), so every launch reads its inputs from HBM."""
    k = 1 + -(-2 * L2_BYTES // touched_bytes)
    return [args] + [tuple(a.clone() for a in args) for _ in range(k - 1)]


def kernel_device_ms(fn, kernel_name: str, reps: int = 10) -> float | None:
    """Device time of one launch of a kernel that fn launches once, from
    torch.profiler: the kernel alone, without the wrapper's host work and
    small torch ops that `time_ms` includes. The mean over the launches a
    window recorded (the profiler at times drops some of a window's
    events); None (not measured) if three windows record none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel_name in e.key]
        n = sum(e.count for e in hits)
        if n:
            return sum(e.self_device_time_total for e in hits) / n / 1e3
    return None


# --------------------------------------------------------------------------
# phase 2: the LM kernel against its plain version
# --------------------------------------------------------------------------

def lm_problem(B, N, seed, valid_frac, per_coord, device):
    import torch
    from scipy.spatial.transform import Rotation as sciR
    from lc_tpu_torch.geom.pose import RT_to_pose7, apply_perturb
    from lc_tpu_torch.geom.projection import project_apply
    rng = np.random.default_rng(seed)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    R = f32(sciR.random(B, random_state=seed).as_matrix())
    t = f32(np.concatenate((rng.uniform(-50, 50, (B, 2)),
                            rng.uniform(600, 800, (B, 1))), -1))
    pts3d = f32(rng.uniform(-40, 40, (B, N, 3)))
    Ks = f32(np.broadcast_to(K, (B, 3, 3)))
    uv = project_apply(Ks, pts3d, R, t) + f32(rng.normal(size=(B, N, 2)) * 0.3)
    start = apply_perturb(RT_to_pose7(R, t), f32(
        rng.normal(size=(B, 6)) * np.array([0.04, 0.04, 0.04, 8, 8, 15])))
    w = f32(rng.uniform(0.5, 2.0, (B, N, 2) if per_coord else (B, N)))
    valid = torch.tensor(rng.random((B, N)) < valid_frac)
    return [x.to(device).contiguous() for x in (start, Ks, pts3d, uv, w, valid)]


def cost_floor(args):
    """Per problem, the least cost difference float32 can resolve: the cost
    0.5 Σ w r² of a residual of two ulps of each pixel coordinate at every
    valid point (the projection and the target each rounded once). Near a
    cost of 0 (exact correspondences) a relative tolerance alone is below
    it."""
    import torch
    pts2d, w, valid = args[3], args[4], args[5]
    a = pts2d.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float('inf'))) - a
    c = (w if w.dim() == 3 else w[..., None]) * (2 * ulp) ** 2
    if valid is not None:
        c = c * valid[..., None]
    return 0.5 * c.sum((-1, -2))


def pose_gap(a, b):
    """Per problem, of two (B, 7) poses: the translation distance (max-abs,
    mm; inf where either is not finite) and the cosine |q·q'| of the two
    rotations' quaternions (the main paths' poses, RANSAC's refined, are
    not of unit norm)."""
    import torch
    t = (a[:, 4:].double() - b[:, 4:].double()).abs().amax(-1)
    qa, qb = a[:, :4].double(), b[:, :4].double()
    qd = ((qa * qb).sum(-1) / (qa.norm(dim=-1) * qb.norm(dim=-1)).clamp(
        min=1e-30)).abs()
    inf = float('inf')
    return torch.nan_to_num(t, nan=inf, posinf=inf), torch.nan_to_num(qd)


def cost_agrees(cost, other, floor):
    """Per problem, whether the f32 `cost` agrees with `other` (f32 or f64)
    within TOL's relative error beyond `floor` (cost_floor), or equals it in
    float32 (a cost past float32's range is inf in both)."""
    err = (cost.double() - other.double()).abs() - floor.double()
    return (cost == other.float()) | (err <= TOL['cost_rtol']
                                      * other.double().abs())


def within_tol(out, other, args):
    """Per problem, whether `out` agrees with `other` within TOL: the
    translation, the rotation, the cost (relative to other's, beyond
    cost_floor) and the invalid flag."""
    t, qd = pose_gap(out.pose7, other.pose7)
    cost_ok = cost_agrees(out.cost, other.cost, cost_floor(args))
    return ((t <= TOL['translation_atol']) & (qd >= TOL['quat_dot_min'])
            & cost_ok & (out.invalid == other.invalid))


def lm_agreement(out, ref, args, keep) -> dict:
    """The kernel's result `out` against the plain version's `ref` on the
    inputs `args`, over the problems in `keep`: the largest translation
    error, the least rotation cosine, the largest cost error relative to
    the plain version's cost beyond cost_floor, whether the invalid flags
    are equal, the largest error of any pose entry (translation in mm,
    quaternions at unit norm)."""
    import torch
    t, qd = pose_gap(out.pose7, ref.pose7)
    # the quaternions at unit norm (RANSAC's refined ones are not), q ~ -q
    aligned, ref7 = out.pose7.clone(), ref.pose7.clone()
    for p in (aligned, ref7):
        p[:, :4] /= p[:, :4].norm(dim=-1, keepdim=True).clamp(min=1e-30)
    signs = torch.sign((aligned[:, :4] * ref7[:, :4]).sum(-1))
    aligned[:, :4] *= torch.where(signs < 0, -1.0, 1.0)[:, None]
    rel = ((out.cost - ref.cost).abs() - cost_floor(args)).clamp(min=0) \
        / ref.cost.abs().clamp(min=1e-30)
    pick = lambda x, empty: x[keep] if bool(keep.any()) else empty  # noqa
    return dict(
        max_translation_err=float(pick(t, torch.zeros(1)).max()),
        min_quat_dot=float(pick(qd, torch.ones(1)).min()),
        max_cost_rel_err=float(pick(rel, torch.zeros(1)).max()),
        invalid_equal=bool((out.invalid == ref.invalid)[keep].all()),
        max_abs_err=float(pick((aligned - ref7).abs().amax(-1),
                               torch.zeros(1)).max()),
        n_iter_kernel=int(out.n_iter.sum()), n_iter_plain=int(ref.n_iter.sum()))


def float32_runs(args, kw, runs: int = 8) -> list:
    """The plain version in float32 on `runs` other float32 renderings of
    the same problems (seeded): every other run with the points in another
    order, the rest with each pixel target moved by at most one ulp."""
    import torch
    from lc_tpu_torch.pnp.solver import lm_refine
    gen = torch.Generator().manual_seed(0)
    results = []
    for i in range(runs):
        if i % 2 == 0:
            p = torch.randperm(args[2].shape[1], generator=gen).to(
                args[2].device)
            moved = list(args[:2]) + [a[:, p].contiguous() if a is not None
                                      else None for a in args[2:]]
        else:
            uv = args[3]
            a = uv.abs()
            ulp = torch.nextafter(a, torch.full_like(a, float('inf'))) - a
            step = torch.randint(-1, 2, uv.shape, generator=gen).to(uv)
            moved = list(args[:3]) + [uv + step * ulp] + list(args[4:])
        results.append(lm_refine(*moved, **kw))
    return results


def referee(args, kw, out, ref, problems) -> list:
    """The problems in `problems` (those on which the kernel's result `out`
    is outside TOL of the f32 plain version's `ref`), judged by the plain
    version in float64 on the same inputs (the referee) and by the f32
    plain version's spread about it: that run as given and float32_runs.

    A problem's pose is determined in float32 when every f32 run lies within
    TOL of the referee (translation, rotation); its invalid flag when,
    besides, every f32 run has the referee's flag and the referee's cost is
    above cost_floor (below it the residuals are rounding, and the
    convergence test, relative to the cost, compares noise). On a
    determined pose the kernel must agree with the referee within TOL
    (translation, rotation, cost beyond cost_floor, and the flag where it is
    determined), or lie within TOL of an iterate of the referee's own path
    (`on_referee_path_at`, the path continued past its stopping test) where
    the referee's cost was within function_tolerance of its final cost: two
    float32 solvers stop an iteration apart where that test (the model
    decrease, or an accepted cost decrease, against function_tolerance x
    the cost) is decided by the rounding of a gradient that cancels to a
    few significant digits near the minimum. Otherwise float32 does not
    determine the answer (a flat minimum, a trajectory cut at max_iter):
    the kernel's translation distance from the referee is ranked among the
    f32 runs', and `farthest` marks a kernel farther than all of them, which
    for a kernel computing the plain version's function happens by chance
    in about 1 of 10 such problems (10 float32 solvers, one of them
    farthest). One row per problem.

    Every run is judged on its last iterate (fallback_to_init off): with
    fallback_to_init an invalid solve returns its initial pose, equal in
    every run, while its cost is that of the iterate where it stopped, so
    the initial pose would make such a problem look determined whatever
    the runs' trajectories did."""
    import torch
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    from lc_tpu_torch.pnp.solver import lm_refine
    if kw.get('fallback_to_init', True):
        kw = dict(kw, fallback_to_init=False)
        out, ref = lm_refine_cuda(*args, **kw), lm_refine(*args, **kw)
    a64 = [a.double() if a is not None and a.is_floating_point() else a
           for a in args]
    r64 = lm_refine(*a64, **kw)
    runs = [ref] + float32_runs(args, kw)
    gaps = [pose_gap(run.pose7, r64.pose7) for run in runs]
    t_runs = torch.stack([g[0] for g in gaps], -1)
    determined = ((t_runs <= TOL['translation_atol']).all(-1)
                  & (torch.stack([g[1] for g in gaps], -1)
                     >= TOL['quat_dot_min']).all(-1))
    floor = cost_floor(args).double()
    flag_determined = (r64.cost > floor) & (torch.stack(
        [r.invalid for r in runs], -1) == r64.invalid[:, None]).all(-1)
    t_k, q_k = pose_gap(out.pose7, r64.pose7)
    agrees = ((t_k <= TOL['translation_atol']) & (q_k >= TOL['quat_dot_min'])
              & cost_agrees(out.cost, r64.cost, floor)
              & ((out.invalid == r64.invalid) | ~flag_determined))
    # where the kernel stopped elsewhere on a determined problem: the
    # iterate of the referee's own path (continued past its stopping test,
    # function_tolerance 0) that it lies at, with the kernel's cost, where
    # the referee's cost was already within function_tolerance of its end
    path_at = torch.full_like(out.n_iter, -1)
    off = (problems & determined & ~agrees).nonzero()[:, 0]
    if len(off):
        sub = [a[off] if a is not None else None for a in a64]
        end = r64.cost[off]
        ftol = kw.get('function_tolerance', 1e-6)
        for k in range(kw.get('max_iter', 50) + 1):
            it = lm_refine(*sub, **dict(kw, max_iter=k, function_tolerance=0.0,
                                        fallback_to_init=False))
            t, q = pose_gap(out.pose7[off], it.pose7)
            hit = ((t <= TOL['translation_atol'])
                   & (q >= TOL['quat_dot_min'])
                   & cost_agrees(out.cost[off], it.cost, floor[off])
                   & (it.cost - end <= ftol * end.abs())
                   & (path_at[off] < 0))
            path_at[off[hit]] = k
    rows = []
    for b in problems.nonzero()[:, 0].tolist():
        rows.append(dict(
            problem=b, determined=bool(determined[b]),
            flag_determined=bool(flag_determined[b]),
            agrees_with_referee=bool(agrees[b]),
            on_referee_path_at=int(path_at[b]) if path_at[b] >= 0 else None,
            kernel_to_referee_mm=float(t_k[b]),
            plain_to_referee_mm=float(t_runs[b, 0]),
            f32_runs_to_referee_mm=[float(t_runs[b].min()),
                                    float(t_runs[b].max())],
            farthest=bool(t_k[b] > t_runs[b].max()),
            invalid=[bool(out.invalid[b]), bool(ref.invalid[b]),
                     bool(r64.invalid[b])]))
    return rows


def lm_case(args, kw, name: str = '', refer: bool = False,
            timed: bool = True):
    """lm_refine_cuda against lm_refine on the same inputs, within TOL;
    if `timed`, the kernel timed per wrapper call (CUDA events) and alone
    (profiler).

    refer (the paths' own inputs, where some problems are ill-posed: random
    networks' correspondences, exact ones at a cost of 0, LO polishes cut
    at 10 iterations): a problem outside TOL goes to the referee, and must
    agree with it where float32 determines the answer; the others are
    listed under 'referred' and left out of the agreement's maxima. Returns
    the report and the kernel's result."""
    import torch
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    from lc_tpu_torch.pnp.solver import lm_refine
    out = lm_refine_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = lm_refine(*args, **kw)
    inside = within_tol(out, ref, args)
    rows = referee(args, kw, out, ref, ~inside) if refer and not bool(
        inside.all()) else []
    agr = lm_agreement(out, ref, args, inside if refer else
                       torch.ones_like(inside))
    if refer:
        agr['referred'] = rows
        check(all(r['agrees_with_referee'] or r['on_referee_path_at']
                  is not None for r in rows if r['determined']),
              f'LM kernel vs the float64 referee, {name}: {agr}')
    else:
        check(agr['max_translation_err'] <= TOL['translation_atol']
              and agr['min_quat_dot'] >= TOL['quat_dot_min']
              and agr['max_cost_rel_err'] <= TOL['cost_rtol']
              and agr['invalid_equal'], f'LM kernel vs plain, {name}: {agr}')
    B, N = args[2].shape[:2]
    valid = args[5]
    agr['shape'] = dict(B=B, N=N, weights=list(args[4].shape[2:]),
                        valid=valid is not None,
                        max_iter=kw.get('max_iter', 50),
                        fallback_to_init=kw.get('fallback_to_init', True))
    agr['valid_points_per_problem'] = float(
        valid.sum(-1).float().mean()) if valid is not None else float(N)
    agr['n_iter_mean'] = float(out.n_iter.float().mean())
    agr['n_iter_max'] = int(out.n_iter.max())
    if timed:
        agr['ms'] = median_call_ms(lambda: lm_refine_cuda(*args, **kw))
        agr['device_ms'] = kernel_device_ms(
            lambda: lm_refine_cuda(*args, **kw), 'lm_refine_kernel', reps=20)
        agr['plain_ms'] = time_ms(lambda: lm_refine(*args, **kw), reps=3,
                                  warmup=1)
        agr['bound_ms'], agr['bound_by'] = lm_bound_ms(args, out)
    return agr, out


def lm_bound_ms(args, out) -> tuple[float, str]:
    """Least time for this call: inputs read once, outputs written once, over
    HBM bandwidth; against the flops these inputs need (valid points times
    the iterations each problem ran) over the f32 rate without multiply-add
    fusion (the kernel builds with -fmad=false). The larger wins."""
    import torch
    from lc_tpu_torch.pnp.lm_kernel import (FLOPS_PER_POINT_INIT,
                                            FLOPS_PER_POINT_ITER)
    nbytes = sum(a.numel() * a.element_size() for a in args if a is not None)
    nbytes += sum(a.numel() * a.element_size() for a in
                  (out.pose7, out.invalid, out.cost, out.n_iter, out.radius))
    n_valid = (args[5].sum(-1).double().cpu() if args[5] is not None else
               torch.full((args[2].shape[0],), float(args[2].shape[1]),
                          dtype=torch.float64))
    n_iter = out.n_iter.double().cpu()
    flops = float((n_valid * (FLOPS_PER_POINT_INIT
                              + FLOPS_PER_POINT_ITER * n_iter)).sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_UNFUSED_OPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def device_ops_per_call(fn, reps: int = 10, windows: int = 3) -> float:
    """Device operations (kernels, copies, memsets) per call of fn, from
    torch.profiler: the most of `windows` windows, as a window may drop
    events but records none that did not run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return max(counts) / reps


def phase_lm(device) -> dict:
    import torch
    from lc_tpu_torch.pnp import lm_kernel
    from lc_tpu_torch.pnp.solver import lm_refine_auto
    w, h = GLMO['net_output_wh']
    s = GLMO['dense_sample']
    B, N = GLMO['batch_size'], (w // s) * (h // s)
    final = dict(max_iter=50, fallback_to_init=True)
    cases = {
        'a_final_refine': (dict(B=B, N=N, seed=0, valid_frac=0.7,
                                per_coord=True), final),
        'b_polish': (dict(B=B, N=N, seed=1, valid_frac=0.7, per_coord=False),
                     dict(max_iter=10, fallback_to_init=False)),
        'c_edges_N1000': (dict(B=B, N=1000, seed=2, valid_frac=0.7,
                               per_coord=True), final),
        # every row off 16-byte boundaries: the kernel's plain-load branch
        'd_weights_BN_no_valid_N1001': (dict(B=B, N=1001, seed=3,
                                             valid_frac=1.0, per_coord=False),
                                        final),
        'e_ran_out_fallback': (dict(B=B, N=N, seed=4, valid_frac=0.7,
                                    per_coord=True),
                               dict(max_iter=2, fallback_to_init=True)),
        'f_ran_out_keep': (dict(B=B, N=N, seed=4, valid_frac=0.7,
                                per_coord=True),
                           dict(max_iter=2, fallback_to_init=False)),
        # zlmo's problem size: every pixel of the 128² output, a quarter of
        # them (~116 KB) in each block's shared memory
        'g_zebra_N16384': (dict(B=ZLMO['batch_size'],
                                N=int(np.prod(ZLMO['net_output_wh'])),
                                seed=5, valid_frac=0.7, per_coord=True),
                           final),
        # gsplmo's: 16 keypoints, 4 a block, no mask
        'h_sparse_N16': (dict(B=GSPLMO['batch_size'], N=GSPLMO['sparse_cnt'],
                              seed=6, valid_frac=1.0, per_coord=True), final),
    }
    report = {}
    # the kernel holds zlmo's 16,384 points a problem, and raises beyond its
    # ceiling rather than falling back to the plain version
    ceiling = lm_kernel.max_points(torch.cuda.current_device())
    report['max_points'] = ceiling
    log(f'[lm] max points a problem on this card: {ceiling}')
    check(ceiling >= int(np.prod(ZLMO['net_output_wh'])),
          f'the LM kernel holds {ceiling} points, zlmo needs 16384')
    over = lm_problem(B=1, N=ceiling + 4, seed=7, valid_frac=1.0,
                      per_coord=True, device=device)
    before = lm_kernel.lm_refine_cuda.launches
    try:
        lm_kernel.lm_refine_cuda(*over)
        raised = False
    except ValueError:
        raised = True
    check(raised and lm_kernel.lm_refine_cuda.launches == before,
          f'{ceiling + 4} points did not raise')
    for name, (pk, kw) in cases.items():
        args = lm_problem(device=device, **pk)
        if name == 'b_polish':
            args[4] = torch.ones_like(args[4])            # unit weights
        if name == 'c_edges_N1000':
            args[5][0, 2:] = False                        # < 3 valid points
        if name.startswith(('d_', 'h_')):
            args[5] = None
        agr, out = lm_case(args, kw, name=name)
        if name == 'c_edges_N1000':
            check(bool(out.invalid[0]), 'row with < 3 valid points not invalid')
            check(torch.equal(out.pose7[0], args[0][0]),
                  'row with < 3 valid points did not keep its init')
        if name.startswith(('e_', 'f_')):
            ran_out = out.invalid & (out.n_iter == 2)
            kept = (out.pose7[ran_out] == args[0][ran_out]).all(-1)
            check(bool(ran_out.any()), f'{name}: no problem ran out')
            check(bool(kept.all()) if name.startswith('e_')
                  else not bool(kept.all()),
                  f'{name}: fallback_to_init not applied as asked')
        report[name] = agr
        log(f'[lm] {name}: {json.dumps(agr)}')
        if name == 'a_final_refine':
            a_args = args

    # one device operation per call, called directly and through the main
    # path's dispatch; ten windows, since three once each dropped one of
    # their ten launches (0.9)
    for fn in (lm_kernel.lm_refine_cuda, lm_refine_auto):
        ops = device_ops_per_call(lambda: fn(*a_args, **final), windows=10)
        report[f'device_ops_per_{fn.__name__}_call'] = ops
        log(f'[lm] device operations per {fn.__name__} call: {ops}')
        check(ops == 1, f'{fn.__name__} ran {ops} device operations per call')

    return report


def phase_lm_main_inputs(captured) -> dict:
    """The LM kernel on the paths' own inputs (path_lm_inputs, every draw),
    each call held with the referee (lm_case's `refer`), the first draw's
    timed. Over all problems float32 does not determine, the kernel may be
    the farthest from the referee in at most max(2, a quarter) of them:
    about a tenth is chance (referee), a kernel computing another function
    would be the farthest in most."""
    report, undetermined = {}, []
    first = f'_s{LM_SWEEP_SEEDS[0]}_'
    for name, (args, kw) in captured.items():
        kw = dict(kw)
        args = list(args) + [kw.pop('valid', None)]
        report[name] = lm_case(args, kw, name=name, refer=True,
                               timed=first in name)[0]
        undetermined += [r for r in report[name]['referred']
                         if not r['determined']]
        log(f'[lm] {name}: {json.dumps(report[name])}')
    n_far = sum(r['farthest'] for r in undetermined)
    report['undetermined'] = dict(problems=len(undetermined),
                                  kernel_farthest=n_far)
    log(f'[lm] problems float32 does not determine: '
        f'{json.dumps(report["undetermined"])}')
    check(n_far <= max(2, len(undetermined) // 4),
          f'the LM kernel is the farthest from the referee in {n_far} of '
          f'{len(undetermined)} undetermined problems')
    return report


def held_summary(lm) -> dict:
    """phase_lm_main_inputs's report by source (a path or its oracle), over
    its calls: problems, those within TOL of the f32 plain version, those
    referred: determined (agreeing with the referee or on its path), on the
    referee's path, not determined, and of those the kernel the farthest;
    the largest translation error within TOL; the timed calls' numbers."""
    out = {}
    for name, rep in lm.items():
        if '_s' not in name or 'referred' not in rep:
            continue
        src, call = name.rsplit('_s', 1)
        o = out.setdefault(src, dict(calls=0, problems=0, within_tol=0,
                                     referred_determined=0,
                                     on_referee_path=0,
                                     referred_undetermined=0,
                                     kernel_farthest=0,
                                     max_translation_err=0.0, timed={}))
        rows = rep['referred']
        o['calls'] += 1
        o['problems'] += rep['shape']['B']
        o['within_tol'] += rep['shape']['B'] - len(rows)
        o['referred_determined'] += sum(r['determined'] for r in rows)
        o['on_referee_path'] += sum(r['on_referee_path_at'] is not None
                                    for r in rows)
        o['referred_undetermined'] += sum(not r['determined'] for r in rows)
        o['kernel_farthest'] += sum(r['farthest'] for r in rows
                                    if not r['determined'])
        o['max_translation_err'] = max(o['max_translation_err'],
                                       rep['max_translation_err'])
        if 'ms' in rep:
            o['timed'][call] = {k: rep[k] for k in (
                'N', 'valid_points_per_problem', 'n_iter_mean', 'n_iter_max',
                'ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by')
                if k in rep} | dict(N=rep['shape']['N'])
    return out


def path_bit_cnt(path) -> tuple | None:
    """The Gray-code bits of each axis of the synthetic box under the path's
    max_bit_cnt (BOPDataset's rule), None for a continuous or sparse head."""
    from lc_tpu_torch.codec import calc_bit_count
    if not path.get('max_bit_cnt'):
        return None
    return tuple(calc_bit_count(list(BOX_HALF_EXTENTS),
                                max_bits=path['max_bit_cnt']))


def path_model(path, seed: int = 0):
    """The path's network with seeded random weights, carried in through
    state_dict_from_flax as a checkpoint would be."""
    from lc_tpu_torch.models import build_model
    from lc_tpu_torch.models.weights import (random_flax_variables,
                                             state_dict_from_flax)
    bit_cnt = path_bit_cnt(path)
    head = dict(sparse_cnt=path.get('sparse_cnt', 0),
                total_bit_cnt=sum(bit_cnt) if bit_cnt else 0)
    zebra = path['net_name'] == 'zebra_DeepLabV3'
    model = build_model(path['net_name'], {'concat': zebra}, **head)
    model.load_state_dict(state_dict_from_flax(
        random_flax_variables(seed=seed, net_name=path['net_name'], **head),
        net_name=path['net_name'], sparse_cnt=head['sparse_cnt']))
    return model


def path_cfg(path):
    """The config keys harness.run_test reads, as the path's yaml sets them."""
    from lc_tpu_torch.utils.config import Config
    return Config(dict(
        black_background=path.get('black_background', False),
        sparse_cnt=path.get('sparse_cnt', 0),
        pnp_solver=dict(dense_sample=path.get('dense_sample', 2),
                        dense_point_select=path.get('point_select', 'quantile'),
                        quantile=path.get('quantile', 0.3),
                        rel_reproj_err=path.get('rel_reproj_err', False),
                        solvers=list(path['solvers']))))


def final_solver(path) -> str:
    """The result key of the path's last solver."""
    return path['solvers'][-1].replace('_', '-')


def h2d(batch, device) -> dict:
    import torch
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def rel_threshold(path, batch, device):
    """rel_reproj_err: 2 px at full-image scale, per crop (run_test's)."""
    import torch
    if not path.get('rel_reproj_err'):
        return None
    return torch.as_tensor(2.0 / np.asarray(batch['out_pix_scale']),
                           dtype=torch.float32, device=device)


def path_threshold(path, batch, device):
    """The RANSAC inlier threshold run_test gives the path: 2 px at
    full-image scale per crop under rel_reproj_err, else 2 px (sparse) or
    3 px (dense)."""
    thr = rel_threshold(path, batch, device)
    if thr is None:
        thr = 2.0 if path.get('sparse_cnt', 0) > 3 else 3.0
    return thr


def path_points(path, net_out, gt):
    """The path's correspondences from network outputs, as the solve of
    harness.run_test forms them: pts3d, pts2d, weights (inverse variances)
    and the valid mask (None: every keypoint)."""
    from lc_tpu_torch.inference import dense_grid_outputs, select_points
    if path.get('sparse_cnt', 0) > 3:
        return (gt['pts3d'], net_out['pts2d'], 1.0 / net_out['pts2d_std'] ** 2,
                None)
    d = dense_grid_outputs(net_out, gt, bit_cnt=path_bit_cnt(path),
                           black_background=path.get('black_background',
                                                     False),
                           sample=path['dense_sample'])
    valid = select_points(d['inv_std2d'], d['seg_prob'], path['point_select'],
                          path['quantile'])
    return d['pts3d'], d['pts2d'], d['inv_std2d'] ** 2, valid


def path_lm_inputs(tag, path, net_out, gt, thr) -> dict:
    """The LM kernel's inputs as the path produces them, over a seeded sweep
    of RANSAC draws (LM_SWEEP_SEEDS): for each draw, the two LO polishes and
    the final refine. {name: (args, kwargs)}."""
    import torch
    from lc_tpu_torch.pnp.ransac import ransac_pnp
    pts3d, pts2d, weights, valid = path_points(path, net_out, gt)
    filtered = path['solvers'][-1] == 'weighted_filtered'
    inputs = {}
    for seed in LM_SWEEP_SEEDS:
        gen = torch.Generator(device=pts2d.device).manual_seed(seed)
        with capture_lm_calls() as cap, capture_hypothesis_calls() as hyp:
            rr = ransac_pnp(gt['out_K'], pts3d, pts2d, gen, valid=valid,
                            reproj_threshold=thr)
        check(len(cap.calls) == 2, f'{tag}: {len(cap.calls)} LO polishes')
        check(len(hyp.calls) == 1, f'{tag}: {len(hyp.calls)} hypothesis stages')
        HYPOTHESIS_INPUTS.setdefault(tag, hyp.calls[0])
        for i, call in enumerate(cap.calls):
            inputs[f'{tag}_s{seed}_lo{i + 1}'] = call
        inputs[f'{tag}_s{seed}_final'] = (
            (rr.pose7, gt['out_K'], pts3d, pts2d, weights),
            dict(valid=valid & rr.inliers if filtered else valid))
    return inputs


def visible_share(es, blobs, path) -> float:
    """The share of the output grid the rendered object covers in `blobs`
    (the oracle's visibility mask)."""
    from lc_tpu_torch.data import synthetic
    vis = synthetic.oracle_outputs(es, blobs, path['net_output_wh'])[
        'msk_vis_logits']
    return float((vis > 0).mean())


def bias_visibility(model, batch, share, path, device) -> float:
    """Shift the random dense head's visibility logit by one constant so that
    `share` of the batch's pixels fall in the mask (a random network's
    logits put almost none there). Returns the shift."""
    import torch
    from lc_tpu_torch.data.pipeline import device_preprocess
    from lc_tpu_torch.models import default_compute_dtype, set_compute_dtype
    gt = device_preprocess(h2d(batch, device),
                           net_input_wh=path['net_input_wh'])
    # the forward harness.run_test runs
    model = set_compute_dtype(model.to(device).eval(),
                              default_compute_dtype(device))
    with torch.no_grad():
        logits = model(gt['img_in'])['msk_vis_logits'].float().flatten()
        shift = -float(torch.quantile(logits, 1.0 - share))
        model.net.aspp.conv_1x1_4.bias[
            model.channel_slices['msk_vis']] += shift
    return shift


def path_setup(tag, path, device, seed: int) -> tuple:
    """A path's N_BATCHES in-memory batches at its widths, its network
    with seeded random weights (the zebra head's visibility logit shifted
    so that its mask keeps the object's share of the grid), the dataset
    attributes and evaluator run_test takes, and the report so far."""
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate
    from lc_tpu_torch.eval.evaluator import Evaluator
    bs = path['batch_size']
    t0 = time.perf_counter()
    es = synthetic.render_eval_set(
        bs * N_BATCHES, seed=seed, net_input_wh=path['net_input_wh'],
        net_output_wh=path['net_output_wh'],
        symmetric=path['net_name'] == 'zebra_DeepLabV3',
        sparse_cnt=path.get('sparse_cnt', 0))
    batches = [collate(es['blobs'][i * bs:(i + 1) * bs])
               for i in range(N_BATCHES)]
    log(f'[{tag}] rendered {bs * N_BATCHES} frames in '
        f'{time.perf_counter() - t0:.1f} s')
    model = path_model(path)
    rep = {}
    if path['net_name'] == 'zebra_DeepLabV3':
        share = visible_share(es, es['blobs'][:bs], path)
        rep['visibility_logit_shift'] = bias_visibility(
            model, batches[0], share, path, device)
        rep['object_share_of_grid'] = share
    dataset = type('EvalSet', (), dict(net_input_wh=path['net_input_wh'],
                                       bit_cnt=path_bit_cnt(path)))
    ev = Evaluator(es['gts'], es['models'], es['models_info'],
                   symmetric_obj_ids=es['symmetric_obj_ids'], device=device)
    return batches, model, dataset, ev, rep


def phase_path(tag, path, device, seed: int) -> tuple:
    """A main path: harness.run_test on N_BATCHES in-memory batches at the
    path's widths, with seeded random weights, the kernel counts zeroed just
    before and read just after; then its stage breakdown on one more run of
    the last batch. The zebra head's visibility logit is first shifted so
    that its mask keeps the object's share of the grid. Returns the report,
    the path's own LM inputs on the last batch (path_lm_inputs), the last
    batch and the model."""
    import torch
    from lc_tpu_torch import harness
    from lc_tpu_torch.data.pipeline import device_preprocess
    bs = path['batch_size']
    batches, model, dataset, ev, rep = path_setup(tag, path, device, seed)

    zero_kernel_counts()
    t0 = time.perf_counter()
    res = harness.run_test(path_cfg(path), model, batches, dataset, ev,
                           device=device)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    launches = counts['lm_refine']

    final = final_solver(path)
    check(set(res) == {p.replace('_', '-') for p in path['solvers']},
          f'{tag}: solvers {sorted(res)}')
    errors = res[final]['errors']
    check(len(errors) == bs * N_BATCHES, f'{tag}: not every crop got a pose')
    check(all(np.all(np.isfinite(e['R_est'])) and np.all(np.isfinite(e['t_est']))
              for e in errors), f'{tag}: non-finite poses')
    check(launches == 3 * N_BATCHES,
          f'{tag}: LM kernel launched {launches} times for {N_BATCHES} batches')
    check_hypotheses_launched(tag, counts)
    per_crop_s = errors[0]['time']     # steady state: batches after the first
    rep.update(batches=N_BATCHES, batch_size=bs, lm_launches=launches,
               launches=counts, crops_per_s=1.0 / per_crop_s, wall_s=wall,
               add_s_0_10=res[final]['avg_score'])
    log(f'[{tag}] {json.dumps(rep)}')
    rep['stages'] = stage_breakdown(model, batches[-1], device, path)
    log(f'[{tag}] stages of one batch: {json.dumps(rep["stages"])}')
    gt = device_preprocess(h2d(batches[-1], device),
                           net_input_wh=path['net_input_wh'])
    with torch.no_grad():
        net_out = model(gt['img_in'])
    lm_inputs = path_lm_inputs(tag, path, net_out, gt,
                               path_threshold(path, batches[-1], device))
    return rep, lm_inputs, batches[-1], model


def phase_main(device) -> tuple[dict, dict]:
    """glmo's main path (CDPN-ResNet34, continuous NOC)."""
    return phase_path('main', GLMO, device, seed=11)[:2]


class capture_lm_calls:
    """Records the arguments of every solver.lm_refine_auto call inside the
    block (RANSAC's LO polishes and the final refines of inference.py) in
    `calls`, in order."""

    def __enter__(self):
        from lc_tpu_torch import inference
        from lc_tpu_torch.pnp import solver
        self.calls = []
        self.orig = orig = solver.lm_refine_auto

        def record(*a, **kw):
            self.calls.append((a, kw))
            return orig(*a, **kw)
        solver.lm_refine_auto = inference.lm_refine_auto = record
        return self

    def __exit__(self, *exc):
        from lc_tpu_torch import inference
        from lc_tpu_torch.pnp import solver
        solver.lm_refine_auto = inference.lm_refine_auto = self.orig


def stage_breakdown(model, batch, device, path, out=None) -> dict:
    """One more batch of a main path, stage by stage (the calls
    harness.run_test and inference.solve_pnp_dense / solve_pnp_sparse make):
    host clock around each stage with the device synchronized, in ms, the
    device memory RANSAC's stages allocate at their peak, its largest
    allocations and its device operations (kernels, copies, memsets) per
    batch, and the points
    RANSAC and the final refine take per problem (mean and least). Then the
    same batch under torch.profiler: device-busy time (sum of kernel times;
    one stream, so kernels do not overlap), kernel count, and the busy share
    of the wall. Given `out` (network outputs on the device, an oracle's),
    the network is not run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lc_tpu_torch.data.pipeline import device_preprocess
    from lc_tpu_torch.pnp.ransac import ransac_pnp
    from lc_tpu_torch.pnp.solver import lm_refine_auto
    gen = torch.Generator(device=device)
    filtered = path['solvers'][-1] == 'weighted_filtered'
    thr = path_threshold(path, batch, device)

    def one_batch(timed):
        dev = timed('h2d', lambda: h2d(batch, device))
        gt = timed('preprocess', lambda: device_preprocess(
            dev, net_input_wh=path['net_input_wh']))
        if model is None:
            net_out = out
        else:
            with torch.no_grad():
                net_out = timed('cnn', lambda: model(gt['img_in']))
        pts3d, pts2d, weights, valid = timed(
            'decode_select', lambda: path_points(path, net_out, gt))
        args = (gt['out_K'], pts3d, pts2d, gen)
        kw = dict(valid=valid, reproj_threshold=thr)
        ransac_call.setdefault('args', (args, kw))
        timed('ransac_hypotheses', lambda: peak(
            'ransac_hypotheses', lambda: ransac_pnp(*args, local_opt=False,
                                                    **kw)))
        rr = timed('ransac_full', lambda: peak(
            'ransac_full', lambda: ransac_pnp(*args, **kw)))
        final_valid = valid & rr.inliers if filtered else valid
        n = pts3d.shape[1]
        for name, v in (('ransac', valid), ('lm_final', final_valid)):
            per = (torch.full((n,), n) if v is None else v.sum(-1)).float()
            stages[f'{name}_valid_points'] = float(per.mean())
            stages[f'{name}_valid_points_least'] = float(per.min())
        timed('lm_final', lambda: lm_refine_auto(
            rr.pose7, gt['out_K'], pts3d, pts2d, weights, valid=final_valid))

    stages: dict[str, float] = {}
    ransac_call = {}

    def peak(name, fn):
        """fn(), recording the device memory it allocated at its peak beyond
        what was allocated before it (the first run's)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        r = fn()
        stages.setdefault(f'{name}_peak_mib', (
            torch.cuda.max_memory_allocated(device) - base) / 2 ** 20)
        return r

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t) * 1e3
        return r

    one_batch(timed)
    stages['ransac_local_opt'] = stages['ransac_full'] - stages['ransac_hypotheses']
    check(stages['ransac_valid_points'] > 0,
          f'{path["net_name"]}: RANSAC took no point')
    args, kw = ransac_call['args']
    stages['ransac_largest_allocations'] = largest_allocations(
        lambda: ransac_pnp(*args, **kw))
    stages['ransac_device_ops'] = device_ops_per_call(
        lambda: ransac_pnp(*args, **kw), reps=1)

    def untimed(name, fn):
        return fn()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        one_batch(untimed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    stages['profiled_wall_ms'] = wall_ms
    stages['device_busy_ms'] = busy_ms
    stages['device_kernels'] = sum(e.count for e in kernels)
    stages['device_busy_share'] = busy_ms / wall_ms
    stages['top_kernels_ms'] = {
        e.key[:60]: e.self_device_time_total / 1e3
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]}
    return stages


def largest_allocations(fn, k: int = 4) -> list:
    """The k largest device allocations fn makes, in MiB, each with the
    innermost lc_tpu_torch frame that made it (the allocator's history,
    recorded for this call only). Python frames only: symbolizing C++
    frames starts one addr2line process per library, which torch keeps
    for the rest of the run."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(stacks='python',
                                             max_entries=100000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    allocs = []
    for trace in snap['device_traces']:
        for e in trace:
            if e['action'] != 'alloc':
                continue
            frames = [f for f in e.get('frames', [])
                      if 'lc_tpu_torch' in f['filename']]
            site = '?' if not frames else (
                f"{frames[0]['filename'].split('lc_tpu_torch/')[-1]}:"
                f"{frames[0]['line']}:{frames[0]['name']}")
            allocs.append([e['size'] / 2 ** 20, site])
    return sorted(allocs, key=lambda a: -a[0])[:k]


def phase_zebra(device) -> tuple[dict, dict]:
    """zlmo's main path, then the card's bf16 forward against the f32 forward
    of the same weights: the share of Gray bits (and of pixels with every bit)
    of equal sign, printed, not gated (the CPU parity tests run f32)."""
    import torch
    from lc_tpu_torch.data.pipeline import device_preprocess
    from lc_tpu_torch.models import set_compute_dtype
    rep, lm_inputs, batch, model = phase_path('zebra', ZLMO, device, seed=12)
    gt = device_preprocess(h2d(batch, device),
                           net_input_wh=ZLMO['net_input_wh'])
    signs = {}
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            signs[dt] = set_compute_dtype(model, dt)(
                gt['img_in'])['xyz_noc_bin'] > 0
    same = signs[torch.bfloat16] == signs[torch.float32]
    rep['bf16_vs_f32'] = dict(bit_agreement=float(same.float().mean()),
                              pixel_agreement=float(
                                  same.all(-1).float().mean()))
    log(f'[zebra] bf16 against f32 forward: {json.dumps(rep["bf16_vs_f32"])}')
    return rep, lm_inputs


def phase_sparse(device) -> tuple[dict, dict]:
    """gsplmo's main path."""
    return phase_path('sparse', GSPLMO, device, seed=13)[:2]


# int8 inference: the layers whose _int_mm accumulators are held to the
# plain version on the path's own activations (the stem on an odd-size crop
# of the input, where lc_tpu quantizes it too), and the convolutions int8
# takes at the even 256² input (README's counts of lc_tpu: all but the stem)
INT8_LAYERS = {
    'glmo': {'stem_odd': 'net.backbone.conv1',
             'conv3x3': 'net.backbone.layer1.0.conv1',
             'deconv': 'net.decoder.features.0',
             'head': 'net.decoder.out_layer'},
    'zlmo': {'stem_odd': 'net.resnet.resnet_layer_1.0',
             'conv3x3': 'net.aspp.upsample_2.3',
             'aspp_dilated': 'net.aspp.conv_3x3_1',
             'deconv': 'net.aspp.upsample_1.0',
             'head': 'net.aspp.conv_1x1_4'}}
INT8_CONVS = {'glmo': 43, 'zlmo': 48}
PEAK_INT8_OPS = 1979e12


def rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt()
                 / ((a ** 2).mean().sqrt() + 1e-30))


def int8_accumulators(model, x, layers: dict) -> dict:
    """Each named layer's int32 accumulators through torch._int_mm against
    the plain version (the float64 convolution of the same int8 values) on
    its own input in the bf16 forward of x: exact. Both timed, beside the
    layer's bf16 convolution (cuDNN)."""
    import torch
    from lc_tpu_torch.models import quant
    from lc_tpu_torch.models.layers import Deconv2x
    mods = dict(model.named_modules())
    inputs, hooks = {}, []
    for key, name in layers.items():
        if key != 'stem_odd':
            hooks.append(mods[name].register_forward_pre_hook(
                lambda m, a, key=key: inputs.__setitem__(key, a[0])))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    nchw = x.permute(0, 3, 1, 2)
    inputs['stem_odd'] = nchw[:, :, :nchw.shape[2] - 1, :nchw.shape[3] - 1]
    out = {}
    with torch.no_grad():
        for key, name in layers.items():
            m, xin = mods[name], inputs[key]
            xq, _ = quant.quantize_tensor(xin, dim=(1, 2, 3), keepdim=True)
            if isinstance(m, Deconv2x):
                w = m.weight.transpose(0, 1).flip(2, 3)
                xq, geom = quant.deconv_input(xq), ((1, 1), (0, 0), (1, 1))
            else:
                w, geom = m.weight, (m.stride, m.padding, m.dilation)
            check(quant.quantizable(m, xin), f'{name} is not quantizable')
            wq, _ = quant.quantize_tensor(w, dim=(1, 2, 3))
            acc = quant.int8_conv_accumulate(xq, wq, *geom)
            ref = quant.int8_conv_reference(xq, wq, *geom)
            check(acc.dtype == torch.int32 and torch.equal(acc, ref),
                  f'{name}: _int_mm accumulators differ from the plain '
                  f'version by {int((acc - ref).abs().max())}')
            M = acc.numel() // acc.shape[1]
            K, N = wq[0].numel(), wq.shape[0]
            out[key] = dict(
                module=name, M=M, K=K, N=N, max_abs_err=0.0,
                ms=time_ms(lambda: quant.int8_conv_accumulate(xq, wq, *geom),
                           reps=5),
                plain_ms=time_ms(lambda: quant.int8_conv_reference(
                    xq, wq, *geom), reps=2, warmup=1),
                bf16_conv_ms=time_ms(lambda: m(xin), reps=5),
                bound_ms=2 * M * K * N / PEAK_INT8_OPS * 1e3)
    return out


def phase_int8(tag, path, device, seed: int) -> dict:
    """int8 inference at the path's widths and batch (random weights):
    the _int_mm accumulators of its layers against the plain version; the
    int8 forward (dynamic, and static scales calibrated on the batch)
    against f32 within lc_tpu's yardstick, the bf16 forward's own error
    (tests/test_quant.py: dynamic 6x + 5e-3, static 12x + 1e-2, the weight
    scale in log domain); forward ms of bf16, int8 dynamic and static; then
    harness.run_test with int8_inference in both modes on N_BATCHES
    batches, counts zeroed before and read after."""
    import torch
    from lc_tpu_torch import harness
    from lc_tpu_torch.data.pipeline import device_preprocess
    from lc_tpu_torch.models import quant, set_compute_dtype
    batches, model, dataset, ev, rep = path_setup(
        f'int8_{tag}', path, device, seed)
    model = set_compute_dtype(model.to(device).eval(), torch.bfloat16)
    x = device_preprocess(h2d(batches[0], device),
                          net_input_wh=path['net_input_wh'])['img_in']
    rep['accumulators'] = int8_accumulators(model, x, INT8_LAYERS[tag])
    log(f'[int8_{tag}] accumulators: {json.dumps(rep["accumulators"])}')

    with torch.no_grad():
        outs = {'f32': set_compute_dtype(model, torch.float32)(x)}
        set_compute_dtype(model, torch.bfloat16)
        scales = quant.calibrate_act_scales(model, [x])

        def fwd(mode):
            if mode == 'bf16':
                return model(x)
            with quant.quantized_int8(model, act_scales=None
                                      if mode == 'dynamic' else scales):
                return model(x)
        for mode in ('bf16', 'dynamic', 'static'):
            outs[mode] = fwd(mode)
        check(len(scales) == INT8_CONVS[tag],
              f'{tag}: int8 takes {len(scales)} convolutions')
        errs = {}
        for k, f in outs['f32'].items():
            e = {}
            for mode in ('bf16', 'dynamic', 'static'):
                q = outs[mode][k].float()
                check(bool(torch.isfinite(q).all()), f'{tag} {mode}: {k}')
                e[mode] = float((torch.log(f) - torch.log(q)).pow(2).mean()
                                .sqrt()) if k == 'xyz_weights_scale' \
                    else rel_rms(f, q)
            if k == 'xyz_weights_scale':
                ok = all(e[m] < 10 * e['bf16'] + 0.1
                         for m in ('dynamic', 'static'))
            else:
                ok = (e['dynamic'] < 6 * e['bf16'] + 5e-3
                      and e['static'] < 12 * e['bf16'] + 1e-2)
            check(ok, f'{tag}: int8 outside the bf16 yardstick on {k}: {e}')
            errs[k] = e
        rep['error_vs_f32'] = errs
        rep['forward_ms'] = {mode: median_call_ms(lambda: fwd(mode),
                                                  windows=3, reps=5)
                             for mode in ('bf16', 'dynamic', 'static')}
    rep['convs_int8'] = len(scales)
    log(f'[int8_{tag}] {json.dumps({k: rep[k] for k in ("error_vs_f32", "forward_ms", "convs_int8")})}')

    final = final_solver(path)
    for mode in ('dynamic', 'static'):
        cfg = path_cfg(path)
        cfg.merge_from_dict({'int8_inference': True,
                             'int8_act_scales': mode})
        zero_kernel_counts()
        t0 = time.perf_counter()
        res = harness.run_test(cfg, model, batches, dataset, ev,
                               device=device)
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        errors = res[final]['errors']
        check(len(errors) == path['batch_size'] * N_BATCHES and all(
            np.all(np.isfinite(e['t_est'])) for e in errors),
            f'int8 {tag} {mode}: not a finite pose for every crop')
        check(counts['lm_refine'] == 3 * N_BATCHES,
              f'int8 {tag} {mode}: LM kernel launched '
              f'{counts["lm_refine"]} times')
        check_hypotheses_launched(f'int8 {tag} {mode}', counts)
        rep[f'run_test_{mode}'] = dict(
            crops_per_s=1.0 / errors[0]['time'], wall_s=wall,
            launches=counts, add_s_0_10=res[final]['avg_score'])
        log(f'[int8_{tag}] run_test {mode}: '
            f'{json.dumps(rep[f"run_test_{mode}"])}')
    return rep


def phase_path_oracle(tag, path, device, limit: float) -> tuple[dict, dict]:
    """A path's oracle, one batch of the path's size: frames rendered in
    memory and the network outputs a perfect network would give
    (synthetic.oracle_outputs: the exact NOC map, the exact Gray logits of
    it, or keypoint heatmaps peaked at the GT projections) through the
    path's decode, RANSAC and the LM kernel. Every pose must recover within
    ADD(-S) `limit` x the diameter (ADD-S for the symmetric zebra object),
    with 3 LM launches. Then the stage breakdown of the same solve, which
    RANSAC runs on the oracle's points, not on a random network's. Returns
    the report and the solve's own LM inputs (path_lm_inputs)."""
    import torch
    from lc_tpu_torch import inference
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate, device_preprocess
    from lc_tpu_torch.eval.evaluator import Evaluator
    from lc_tpu_torch.geom.pose import pose7_to_RT
    from lc_tpu_torch.models.ptnet import keypoints_from_logits
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    sparse = path.get('sparse_cnt', 0) > 3
    symmetric = path['net_name'] == 'zebra_DeepLabV3'
    n = path['batch_size']
    es = synthetic.render_eval_set(
        n, seed=7, net_input_wh=path['net_input_wh'],
        net_output_wh=path['net_output_wh'], symmetric=symmetric,
        sparse_cnt=path.get('sparse_cnt', 0))
    batch = collate(es['blobs'])
    gt = device_preprocess(h2d(batch, device),
                           net_input_wh=path['net_input_wh'])
    raw = synthetic.oracle_outputs(
        es, es['blobs'], path['net_output_wh'], bit_cnt=path_bit_cnt(path),
        black_background=path.get('black_background', False), sparse=sparse)
    if sparse:
        pts2d, std = keypoints_from_logits(torch.as_tensor(
            raw['kpt_logits'], device=device).permute(0, 3, 1, 2))
        out = {'pts2d': pts2d, 'pts2d_std': std}
    else:
        out = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    thr = rel_threshold(path, batch, device)
    from lc_tpu_torch.pnp.minimal6_kernel import minimal6_cuda
    before = lm_refine_cuda.launches
    before_m6 = minimal6_cuda.launches
    if sparse:
        states = inference.solve_pnp_sparse(
            out, gt, gen, solvers=path['solvers'], reproj_err=thr,
            device=device)
    else:
        states = inference.solve_pnp_dense(
            out, gt, gen, bit_cnt=path_bit_cnt(path),
            black_background=path.get('black_background', False),
            sample=path['dense_sample'], point_select=path['point_select'],
            quantile=path['quantile'], solvers=path['solvers'],
            reproj_err=thr, device=device)
    launches = lm_refine_cuda.launches - before
    m6_launches = minimal6_cuda.launches - before_m6
    R, t = pose7_to_RT(states[final_solver(path)])
    ev = Evaluator(es['gts'], es['models'], es['models_info'],
                   symmetric_obj_ids=es['symmetric_obj_ids'], device=device)
    _, errors = ev.evaluate([dict(scene_id=1, im_id=i, obj_id=1,
                                  R_est=R[i].cpu().numpy(),
                                  t_est=t[i].cpu().numpy()) for i in range(n)])
    metric = 'adi' if symmetric else 'add'
    diameter = es['models_info'][1]['diameter']
    rep = dict(crops=n, lm_launches=launches, minimal6_launches=m6_launches,
               metric=metric,
               max_err_mm=max(e[metric] for e in errors), diameter_mm=diameter,
               limit_mm=limit * diameter)
    log(f'[{tag}_oracle] {json.dumps(rep)}')
    check(launches == 3, f'{tag} oracle launched the LM kernel {launches} times')
    check(m6_launches == 1,
          f'{tag} oracle launched the minimal6 kernel {m6_launches} times')
    check(rep['max_err_mm'] < limit * diameter, f'{tag} oracle poses off: {rep}')
    rep['stages'] = stage_breakdown(None, batch, device, path, out=out)
    log(f'[{tag}_oracle] stages of the solve: {json.dumps(rep["stages"])}')
    return rep, path_lm_inputs(f'{tag}_oracle', path, out, gt,
                               path_threshold(path, batch, device))


def kernel_counts() -> dict:
    from lc_tpu_torch.ops.warp import shear_x_cuda
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    from lc_tpu_torch.pnp.minimal6_kernel import minimal6_cuda
    return {'lm_refine': lm_refine_cuda.launches,
            'shear_x': shear_x_cuda.launches,
            'minimal6': minimal6_cuda.launches}


def zero_kernel_counts():
    from lc_tpu_torch.ops.warp import shear_x_cuda
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    from lc_tpu_torch.pnp.minimal6_kernel import minimal6_cuda
    lm_refine_cuda.launches = 0
    shear_x_cuda.launches = 0
    minimal6_cuda.launches = 0


def check_hypotheses_launched(tag: str, counts: dict):
    """Each ransac_pnp call launches the minimal6 kernel once; on an
    inference path that is once a batch, beside the LM kernel's three
    launches (two LO polishes, the final refine)."""
    check(counts['minimal6'] > 0
          and 3 * counts['minimal6'] == counts['lm_refine'],
          f'{tag}: minimal6 launched {counts["minimal6"]} times beside '
          f'{counts["lm_refine"]} LM launches')


# --------------------------------------------------------------------------
# RANSAC's hypothesis kernel (minimal6) against its plain version
# --------------------------------------------------------------------------

class capture_hypothesis_calls:
    """Records the arguments (cam_K, sub3d, sub2d, estimators) of every
    hypothesis stage ransac_pnp runs inside the block, in `calls`."""

    def __enter__(self):
        from lc_tpu_torch.pnp import ransac
        self.calls = []
        self.orig = orig = ransac.hypothesis_solver

        def solver(device):
            fn = orig(device)

            def record(*a):
                self.calls.append(a)
                return fn(*a)
            return record
        ransac.hypothesis_solver = solver
        return self

    def __exit__(self, *exc):
        from lc_tpu_torch.pnp import ransac
        ransac.hypothesis_solver = self.orig


def guard_generic_hypotheses():
    """Make the generic estimators' hypothesis stage raise on a CUDA
    tensor for the rest of the run: on the card every sample goes through
    the minimal6 kernel."""
    from lc_tpu_torch.pnp import ransac
    generic = ransac.generic_hypotheses

    def guarded(cam_K, *a):
        check(not cam_K.is_cuda, 'a hypothesis stage on the card took the '
              'generic estimators')
        return generic(cam_K, *a)
    ransac.generic_hypotheses = guarded


def minimal_samples(B, Kh, noise, planar, seed, device):
    """6-point samples as lc_tpu's tests/test_pnp.py:301-372 makes them:
    spread in a 100 mm cube, or on a random plane, 400-600 mm in front of
    the camera, with `noise` px of Gaussian noise. (cam_K, sub3d, sub2d,
    estimators) on the device."""
    import torch
    from scipy.spatial.transform import Rotation as sciR
    from lc_tpu_torch.pnp.fast_minimal import ESTIMATORS
    rng = np.random.default_rng(seed)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]])
    Kc = np.broadcast_to(K, (B, 3, 3)).copy()
    Rs = sciR.random(B * Kh, random_state=seed + 1).as_matrix().reshape(
        B, Kh, 3, 3)
    ts = np.concatenate((rng.uniform(-5, 5, (B, Kh, 2)),
                         rng.uniform(400, 600, (B, Kh, 1))), -1)
    if planar:
        frames = sciR.random(B * Kh, random_state=seed + 2).as_matrix(
        ).reshape(B, Kh, 3, 3)
        ab = rng.uniform(-50, 50, (B, Kh, 6, 2))
        P3 = (ab[..., :1] * frames[:, :, None, :, 0]
              + ab[..., 1:2] * frames[:, :, None, :, 1])
    else:
        P3 = rng.uniform(-50, 50, (B, Kh, 6, 3))
    P3 = P3.astype(np.float32)
    cam = np.einsum('bkij,bknj->bkni', Rs, P3) + ts[:, :, None]
    uvw = np.einsum('bij,bknj->bkni', Kc, cam)
    uv = uvw[..., :2] / uvw[..., 2:3] + rng.normal(0, noise, uvw[..., :2].shape)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                 for a in (Kc, P3, uv)) + (ESTIMATORS,)


def minimal6_agreement(name, rule, p, ok, pr, okr) -> dict:
    """One estimator's hypotheses from the kernel (p, ok) against the plain
    version's (pr, okr), (B, K, 7) and (B, K), held to MINIMAL6_TOL's
    `rule`; every pose must be finite."""
    import torch
    both = ok & okr
    dt = (p[..., 4:] - pr[..., 4:]).abs().amax(-1)[both].double().cpu()
    dn = (p[..., 4:] - pr[..., 4:]).norm(dim=-1)[both].double().cpu()
    dq = (p[..., :4] * pr[..., :4]).sum(-1).abs()[both].double().cpu()
    # over no jointly valid problem a quantile holds vacuously
    q = lambda x, f, none: float(torch.quantile(x, f)) if x.numel() else none  # noqa: E731
    agr = dict(problems=int(ok.numel()), ok_kernel=float(ok.float().mean()),
               ok_agree=float((ok == okr).float().mean()),
               bit_equal=float((p == pr).all(-1).float().mean()),
               finite=bool(torch.isfinite(p).all()),
               max_abs_err=float((p - pr).abs()[both].max())
               if bool(both.any()) else 0.0,
               t_p50=q(dt, 0.5, 0.0), t_p90=q(dt, 0.9, 0.0),
               t_p99=q(dt, 0.99, 0.0), dist_p50=q(dn, 0.5, 0.0),
               dist_p90=q(dn, 0.9, 0.0), qdot_p01=q(dq, 0.01, 1.0),
               qdot_p10=q(dq, 0.1, 1.0), rule=rule)
    tol = MINIMAL6_TOL[rule]
    held = agr['finite'] and agr['ok_agree'] >= tol['ok_agree']
    if rule == 'dlt':
        held &= (agr['t_p50'] < tol['t_p50'] and agr['t_p90'] < tol['t_p90']
                 and agr['qdot_p10'] > tol['qdot_p10'])
    elif rule == 'noise_free':
        held &= agr['t_p99'] < tol['t_p99'] and agr['qdot_p01'] > tol['qdot_p01']
    else:
        held &= (agr['dist_p50'] < tol['dist_p50']
                 and agr['dist_p90'] < tol['dist_p90'])
    check(held, f'minimal6 kernel vs plain, {name}: {agr}')
    return agr


def minimal6_bound_ms(args, ops) -> tuple[float, str]:
    """Least time for this call: the bytes (inputs read once, pose and ok
    written once) over HBM bandwidth against the f32 operations of the
    plain version (ops per problem of each estimator named, times the
    problems) over the f32 rate without multiply-add fusion (the kernel
    builds with -fmad=false); the larger wins."""
    cam_K, sub3d, sub2d, est = args
    P = sub3d.shape[0] * sub3d.shape[1]
    nbytes = sum(a.numel() * a.element_size() for a in (cam_K, sub3d, sub2d))
    nbytes += len(est) * P * (7 * 4 + 1)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = P * sum(ops[e] for e in est) / PEAK_F32_UNFUSED_OPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def minimal6_case(name, args, rules, ops, plain_reps: int = 1) -> dict:
    """The kernel against the plain version on one set of samples (each
    estimator held to its rule in `rules`, or only reported where it has
    none), timed beside its bound; the plain version's time over
    `plain_reps` calls after the comparison's."""
    import torch
    from lc_tpu_torch.pnp import fast_minimal
    from lc_tpu_torch.pnp.minimal6_kernel import minimal6_cuda
    pose, ok = minimal6_cuda(*args)
    torch.cuda.synchronize()
    pr, okr = fast_minimal.minimal6(*args)
    check(pose.shape == pr.shape and ok.shape == okr.shape,
          f'minimal6 {name}: shapes {tuple(pose.shape)} {tuple(pr.shape)}')
    B, Kh = args[1].shape[:2]
    rep = dict(B=B, K=Kh, estimators=list(args[3]))
    for e, est in enumerate(args[3]):
        sl = slice(e * Kh, (e + 1) * Kh)
        rule = rules.get(est)
        agr = minimal6_agreement(f'{name} {est}', rule or 'noisy',
                                 pose[:, sl], ok[:, sl], pr[:, sl], okr[:, sl])
        if rule is None:
            agr['rule'] = 'reported only'
        rep[est] = agr
    rep['ms'] = median_call_ms(lambda: minimal6_cuda(*args))
    rep['device_ms'] = kernel_device_ms(lambda: minimal6_cuda(*args),
                                        'minimal6_kernel', reps=20)
    rep['plain_ms'] = time_ms(lambda: fast_minimal.minimal6(*args),
                              reps=plain_reps, warmup=0)
    rep['bound_ms'], rep['bound_by'] = minimal6_bound_ms(args, ops)
    rep['ops_per_call'] = B * Kh * sum(ops[e] for e in args[3])
    return rep


def ptxas_summary(log_text: str) -> dict:
    """Registers, stack frame and spill bytes of each function in an
    `nvcc -Xptxas -v` log, by mangled name."""
    import re
    out, name = {}, None
    for line in (log_text or '').splitlines():
        m = re.search(r'(?:Compiling entry function|Function properties '
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and name:
            out[name].update(stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out[name]['registers'] = int(m.group(1))
    return out


def phase_minimal6(device) -> dict:
    """The minimal6 kernel against its plain version (fast_minimal) on the
    card at the main paths' B = 32, K = 150: (a) noise-free well-spread
    samples, (b) samples on a plane, (c) 1 px noise, and (d) the samples,
    cameras and estimators of each path's and oracle's own RANSAC call
    (HYPOTHESIS_INPUTS), each timed beside its bound."""
    from lc_tpu_torch import cuda_build
    from lc_tpu_torch.pnp.minimal6_kernel import lanes, ops_per_problem
    ops = ops_per_problem()
    log(f'[minimal6] f32 operations a problem (fast_minimal, counted): '
        f'{json.dumps(ops)}')
    B, Kh = GLMO['batch_size'], 150
    sets = {
        'a_noise_free': (minimal_samples(B, Kh, 0.0, False, 0, device),
                         dict(epnp='noise_free', dlt='dlt')),
        'b_planar': (minimal_samples(B, Kh, 0.0, True, 10, device),
                     dict(planar='noise_free')),
        'c_1px': (minimal_samples(B, Kh, 1.0, False, 20, device),
                  dict(epnp='noisy', dlt='dlt')),
    }
    for tag, args in HYPOTHESIS_INPUTS.items():
        sets[f'd_{tag}'] = (args, dict(epnp='noisy', planar='noisy',
                                       dlt='dlt'))
    rep = dict(ops_per_problem=ops, tolerance=MINIMAL6_TOL, lanes=lanes(),
               ptxas=ptxas_summary(cuda_build.build_logs.get('minimal6')))
    log(f'[minimal6] lanes a problem {json.dumps(rep["lanes"])}; ptxas: '
        f'{json.dumps(rep["ptxas"])}')
    for name, (args, rules) in sets.items():
        rep[name] = minimal6_case(name, args, rules, ops,
                                  plain_reps=3 if name == 'a_noise_free' else 1)
        log(f'[minimal6] {name}: {json.dumps(rep[name])}')
    check(len(sets) == 9, f'minimal6: {len(sets)} sample sets, 9 expected')
    return rep


# --------------------------------------------------------------------------
# phase 5: the shear kernel against its plain version
# --------------------------------------------------------------------------

def glmo_shifts(B, n, seed, device):
    """The x and y shifts of rotated_crop_warp's three shears for B glmo
    rotations, theta spread over [0, 4 pi) as BOPDataset draws them."""
    import torch
    from lc_tpu_torch.ops.warp import _fold_quadrant
    theta = torch.linspace(0, 4 * np.pi, B + 1, device=device)[:B]
    theta = theta + torch.rand(B, generator=torch.Generator(device=device)
                               .manual_seed(seed), device=device) * 0.1
    _, res = _fold_quadrant(theta)
    rows = torch.arange(n, dtype=torch.float32, device=device) - n / 2.0
    sx = (-torch.tan(res / 2.0)[:, None] * rows[None]).contiguous()
    sy = (torch.sin(res)[:, None] * rows[None]).contiguous()
    return sx, sy


def shear_grid(shifts, H, W, axis):
    """grid_sample's sampling grid for the same shear (align_corners=True,
    normalized coordinates)."""
    import torch
    dev = shifts.device
    y = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    if axis == 0:
        xs = (x + shifts[:, :, None]).expand(-1, H, W)
        ys = y.expand(shifts.shape[0], H, W)
    else:
        xs = x.expand(shifts.shape[0], H, W)
        ys = (y + shifts[:, None, :]).expand(-1, H, W)
    return torch.stack((2 * xs / (W - 1) - 1, 2 * ys / (H - 1) - 1), -1)


def shear_bound_ms(img, shifts) -> tuple[float, str]:
    nbytes = 2 * img.numel() * 4 + shifts.numel() * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = SHEAR_FLOPS_PER_ELEM * img.numel() / PEAK_F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_shear(device) -> dict:
    import torch
    import torch.nn.functional as F
    from lc_tpu_torch.ops.warp import shear_x_cuda, shear_x_reference
    n = int(GLMO['net_input_wh'][0] * 1.5)                 # the 1.5x intermediate
    B = GLMO['batch_size']
    gen = torch.Generator(device=device).manual_seed(0)
    report = {}
    for C in (3, 1):
        img = torch.rand(B, n, n, C, generator=gen, device=device) * 255
        sx, sy = glmo_shifts(B, n, C, device)
        half = torch.full_like(sx, n / 2.0 + 3.0)
        half[1::2] *= -1                                  # beyond ±W/2
        width = torch.full_like(sx, n + 2.0)
        width[1::2] *= -1                                 # beyond ±W: all zero
        for case, shifts, axis in (('x', sx, 0), ('y', sy, 1),
                                   ('beyond_half_width', half, 0),
                                   ('beyond_width', width, 1)):
            out = shear_x_cuda(img, shifts, axis)
            torch.cuda.synchronize()
            ref = shear_x_reference(img, shifts, axis)
            err = float((out - ref).abs().max())
            check(err <= SHEAR_ATOL, f'shear C={C} {case}: max err {err}')
            if case.startswith('beyond'):
                check(case == 'beyond_half_width' or bool((out == 0).all()),
                      'shifts beyond the line must read zero')
                report[f'C{C}_{case}'] = dict(max_abs_err=err)
                continue
            nchw = img.permute(0, 3, 1, 2).contiguous()
            grid = shear_grid(shifts, n, n, axis)
            lib = F.grid_sample(nchw, grid, mode='bilinear',
                                padding_mode='zeros', align_corners=True)
            # timed L2-cold: at C = 1 one image and its output fit the L2
            # and a repeated launch would read them from there
            kern = rotating(lambda i, s: shear_x_cuda(i, s, axis),
                            l2_cold_sets((img, shifts), 2 * img.numel() * 4))
            sample = rotating(
                lambda i, g: F.grid_sample(i, g, mode='bilinear',
                                           padding_mode='zeros',
                                           align_corners=True),
                l2_cold_sets((nchw, grid),
                             2 * img.numel() * 4 + grid.numel() * 4))
            rep = dict(
                shape=[B, n, n, C], axis=axis, max_abs_err=err,
                max_shift=float(shifts.abs().max()),
                library_max_abs_err=float(
                    (lib.permute(0, 2, 3, 1) - ref).abs().max()),
                ms=time_ms(kern, reps=48),
                device_ms=kernel_device_ms(kern, 'shear_', reps=12),
                # the same buffers every launch, L2-resident at C = 1, as
                # the kernel was timed before its column pass was redesigned
                device_ms_same_buffers=kernel_device_ms(
                    lambda: shear_x_cuda(img, shifts, axis), 'shear_'),
                plain_ms=time_ms(lambda: shear_x_reference(img, shifts, axis),
                                 reps=10),
                library_ms=time_ms(sample, reps=48),
                # cuDNN's bilinear_sampler, or PyTorch's grid_sampler_2d
                library_device_ms=kernel_device_ms(sample, 'sampler',
                                                   reps=12))
            rep['bound_ms'], rep['bound_by'] = shear_bound_ms(img, shifts)
            report[f'C{C}_{case}'] = rep
            log(f'[shear] C={C} {case}: {json.dumps(rep)}')
        # the column pass on harder inputs: a random shift per column,
        # uniform in +-n/2 (windows beyond a tile's shared memory, walked in
        # chunks), and sizes that are not multiples of the 32 x 64 tile
        for m in (384, 383, 97):
            img_m = torch.rand(B, m, m, C, generator=gen, device=device) * 255
            rnd = (torch.rand(B, m, generator=gen, device=device) - 0.5) * m
            cases = [('y_random', rnd)]
            if m != n:
                cases.append(('y_glmo', glmo_shifts(B, m, C, device)[1]))
            for case, shifts in cases:
                out = shear_x_cuda(img_m, shifts, 1)
                torch.cuda.synchronize()
                err = float((out - shear_x_reference(img_m, shifts, 1))
                            .abs().max())
                check(err <= SHEAR_ATOL,
                      f'shear C={C} {case} n={m}: max err {err}')
                kern = rotating(lambda i, s: shear_x_cuda(i, s, 1),
                                l2_cold_sets((img_m, shifts),
                                             2 * img_m.numel() * 4))
                rep = dict(shape=[B, m, m, C], max_abs_err=err,
                           device_ms=kernel_device_ms(kern, 'shear_'))
                rep['bound_ms'], rep['bound_by'] = shear_bound_ms(img_m,
                                                                  shifts)
                report[f'C{C}_{case}_n{m}'] = rep
                log(f'[shear] C={C} {case} n={m}: {json.dumps(rep)}')
    report['rotated_crop'] = composed_rotated_crop(device)
    return report


def composed_rotated_crop(device) -> dict:
    """rotated_crop_warp at glmo's shapes, RGB and mask, with the kernel
    against the same composition with the plain shear."""
    import torch
    from lc_tpu_torch.ops import warp
    B = GLMO['batch_size']
    gen = torch.Generator(device=device).manual_seed(1)
    rgb = torch.rand(B, 480, 640, 3, generator=gen, device=device) * 255
    center = torch.stack((torch.rand(B, generator=gen, device=device) * 400 + 120,
                          torch.rand(B, generator=gen, device=device) * 240 + 120),
                         -1)
    scale = torch.rand(B, generator=gen, device=device) * 150 + 100
    rot = torch.rand(B, generator=gen, device=device) * 4 * np.pi
    rep = {}
    for name, img in (('rgb', rgb), ('mask', rgb[..., :1] / 255.0)):
        args = (img, center, scale, rot, GLMO['net_input_wh'])
        before = warp.shear_x_cuda.launches
        out = warp.rotated_crop_warp(*args)
        torch.cuda.synchronize()
        check(warp.shear_x_cuda.launches == before + 3,
              'rotated_crop_warp did not launch the shear kernel 3 times')
        plain = warp.rotated_crop_warp(*args, shear=warp.shear_x_reference)
        err = float((out - plain).abs().max())
        check(err <= SHEAR_ATOL, f'rotated crop {name}: max err {err}')
        rep[name] = dict(max_abs_err=err, shape=list(out.shape),
                         ms=time_ms(lambda: warp.rotated_crop_warp(*args),
                                    reps=10),
                         plain_ms=time_ms(lambda: warp.rotated_crop_warp(
                             *args, shear=warp.shear_x_reference), reps=5))
    log(f'[shear] rotated_crop_warp: {json.dumps(rep)}')
    return rep


# --------------------------------------------------------------------------
# phase 6: the training path
# --------------------------------------------------------------------------

def family_train_cfg(name: str, *overrides):
    """configs/<name>.yaml with the device-rotated crop and the LC loss at
    its full weight from the first step."""
    from lc_tpu_torch.utils.config import load_config
    here = os.path.dirname(os.path.abspath(__file__))
    return load_config(os.path.join(here, 'configs', f'{name}.yaml'), [
        'dataloader.device_rotate=true', 'loss.pose_loss_start_step=0',
        'loss.pose_loss_start_epoch=0', *overrides])


# the training phases: (tag, config, path (widths, head), loss terms)
TRAIN_PATHS = (('glmo', 'glmo', GLMO, ('loss_noc', 'loss_seg', 'loss_pose')),
               ('zlmo', 'zlmo', ZLMO,
                ('loss_noc_bin', 'loss_seg', 'loss_pose')),
               ('gsplmo', 'gsplmo', GSPLMO, ('loss_kpts', 'loss_pose')))


def staged_in_line(batch: dict, seed: int, step: int, device,
                   pp: dict) -> dict:
    """A host batch staged as the train loop stages it without prefetch:
    device_prefetch of size 0 through train.preprocess_step."""
    from lc_tpu_torch.data.pipeline import device_prefetch
    from lc_tpu_torch.train import preprocess_step
    return next(device_prefetch(
        [batch], lambda dev, _: preprocess_step(dev, seed, step, pp), device,
        size=0))


def phase_train(device, tag: str = 'glmo') -> dict:
    """Six steps of the train loop's in-line staging + train_step on two
    in-memory batches of the family's config at its widths and batch (random
    weights, bf16 convolutions), counts zeroed before and read after; then
    a stage breakdown of one more step."""
    import torch
    from types import SimpleNamespace
    from lc_tpu_torch import harness
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate
    from lc_tpu_torch.loss.loss_fn import init_loss_state
    from lc_tpu_torch.models import set_compute_dtype
    from lc_tpu_torch.optim.factory import build_optimizer
    from lc_tpu_torch.train import sample_offset
    from lc_tpu_torch.train_step import train_step
    _, name, path, terms = next(p for p in TRAIN_PATHS if p[0] == tag)
    cfg = family_train_cfg(name)
    ds_cfg = cfg.train_dataset
    bs = cfg.dataloader.batch_size
    # the config's top level or its train_dataset (BOPDataset's rule)
    in_wh, out_wh = (tuple(cfg.get(k, ds_cfg.get(k)))
                     for k in ('net_input_wh', 'net_output_wh'))
    check((bs, in_wh, out_wh) == (path['batch_size'], path['net_input_wh'],
                                  path['net_output_wh']),
          f'{tag}: batch and widths of the config')
    bit_cnt = path_bit_cnt(path)
    sparse_cnt = cfg.get('sparse_cnt', 0)
    t0 = time.perf_counter()
    blobs = synthetic.render_train_set(
        2 * bs, seed=21, net_input_wh=in_wh, net_output_wh=out_wh,
        dzi_scale_ratio=ds_cfg.dzi_scale_ratio,
        dzi_shift_ratio=ds_cfg.dzi_shift_ratio,
        dzi_pad_scale=ds_cfg.dzi_pad_scale, rotate_prob=ds_cfg.rotate_prob,
        switch_bg_prob=ds_cfg.switch_bg_prob,
        pixel_aug_prob=ds_cfg.pixel_aug_prob, sparse_cnt=sparse_cnt)
    batches = [collate(blobs[i * bs:(i + 1) * bs]) for i in range(2)]
    log(f'[train_{tag}] rendered {2 * bs} training frames in '
        f'{time.perf_counter() - t0:.1f} s')
    rotated = sum(int((b['crop_rot'] != 0).sum()) for b in batches)
    if ds_cfg.switch_bg_prob:
        check(all(b['switch_bg'].any() for b in batches),
              'no background switch')

    model = set_compute_dtype(path_model(path).to(device), torch.bfloat16)
    initial = {k: v.detach().clone() for k, v in model.named_parameters()}
    # the schedule's length: num_steps, or nominal epochs of 100 steps
    steps_per_epoch = 0 if cfg.train.get('num_steps') else 100
    loss_cfg = harness.make_loss_config(cfg, steps_per_epoch, bit_cnt)
    check(loss_cfg.full_pose_loss_step == 0, 'LC loss not at full weight')
    check(loss_cfg.sparse == (sparse_cnt > 3) and loss_cfg.bit_cnt == bit_cnt,
          f'{tag}: loss head')
    optimizer, scheduler = build_optimizer(
        model.parameters(), cfg.optimizer, cfg.scheduler,
        cfg.train.get('num_steps') or cfg.train.num_epochs * steps_per_epoch)
    loss_state = init_loss_state(loss_cfg, device)
    pp = harness.preprocess_kwargs(cfg, SimpleNamespace(
        net_input_wh=in_wh, net_output_wh=out_wh,
        mask_nearest=ds_cfg.get('mask_interp', 'linear') == 'nearest'),
        train=True)
    s = loss_cfg.dense_sample
    seed = 42
    sym_aware_start = cfg.get('sym_aware_start', 0)

    def one_step(step, loss_state):
        # the body of train.train's loop, on in-memory batches
        return train_step(model, optimizer, scheduler, loss_cfg, loss_state,
                          staged_in_line(batches[step % 2], seed, step,
                                         device, pp), step,
                          sample_offset(seed, step, s),
                          sym_aware_start=sym_aware_start)

    zero_kernel_counts()
    all_metrics = []
    t_first = time.perf_counter()
    loss_state, m = one_step(0, loss_state)
    all_metrics.append({k: float(v) for k, v in m.items()})
    first_s = time.perf_counter() - t_first
    thr_after_1 = float(loss_state.weight_clip.max_norm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_metrics = []
    for step in range(1, TRAIN_STEPS):
        loss_state, m = one_step(step, loss_state)
        step_metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    all_metrics += [{k: float(v) for k, v in m.items()} for m in step_metrics]

    for i, m in enumerate(all_metrics):
        check(all(np.isfinite(v) for v in m.values()),
              f'{tag}: non-finite training metrics at step {i + 1}: {m}')
    check(set(all_metrics[0]) == {'loss', 'grad_norm', *terms},
          f'{tag}: metrics {sorted(all_metrics[0])}')
    thr = float(loss_state.weight_clip.max_norm)
    # the sparse loss taps no weight logits: its clipper is set from an
    # observed norm of 0 at step 1 and moves by its EMA from there
    check(bool(loss_state.weight_clip.started) and thr > 0
          and (sparse_cnt > 3 or thr_after_1 > 0),
          f'{tag}: weight clipper threshold {thr_after_1} after step 1, '
          f'{thr} after {TRAIN_STEPS}')
    hist = None
    if bit_cnt:
        hist = loss_state.histogram.cpu().numpy()
        check(hist.shape == (sum(bit_cnt),) and np.abs(hist - 0.5).max() > 0,
              f'{tag}: the binary-code histogram did not move: {hist}')
    changed = sum(not torch.equal(p.detach(), initial[k])
                  for k, p in model.named_parameters())
    max_delta = max(float((p.detach() - initial[k]).abs().max())
                    for k, p in model.named_parameters())
    check(changed > 0, 'no parameter changed')
    check(counts['shear_x'] == 6 * TRAIN_STEPS,
          f'{tag}: shear kernel launched {counts["shear_x"]} times in '
          f'{TRAIN_STEPS} steps (expected 6 per step)')
    rep = dict(config=name, steps=TRAIN_STEPS, batch_size=bs,
               net_input_wh=in_wh, net_output_wh=out_wh, bit_cnt=bit_cnt,
               sparse_cnt=sparse_cnt, launches=counts,
               rotated_crops=f'{rotated}/{2 * bs}',
               first_step_s=first_s, timed_steps=TRAIN_STEPS - 1,
               timed_wall_s=wall,
               crops_per_s=(TRAIN_STEPS - 1) * bs / wall,
               weight_clip_after_step_1=thr_after_1,
               weight_clip_after_last=thr,
               histogram=None if hist is None else hist.tolist(),
               params_changed=f'{changed}/{len(initial)}',
               max_param_delta=max_delta, metrics=all_metrics)
    log(f'[train_{tag}] {json.dumps(rep)}')
    if bit_cnt:
        rep['decode_on_card'] = check_training_decode(bit_cnt, device)
    rep['stages'] = train_stage_breakdown(
        lambda: one_step(TRAIN_STEPS, loss_state))
    log(f'[train_{tag}] stages of one step: {json.dumps(rep["stages"])}')
    return rep


def check_training_decode(bit_cnt, device) -> dict:
    """The straight-through training decode on the card against the CPU on
    zlmo's shapes: random logits (|x| >= 0.05), GT bits and mask; values
    and the gradient of a random cotangent. Every pixel has several wrong
    bits, so the most significant one is argmax's first of several hits:
    its tie-breaking on the card is checked here, not assumed."""
    import torch
    from lc_tpu_torch.codec import logits_to_noc_with_gt, noc_to_bits
    g = torch.Generator().manual_seed(5)
    shape = (ZLMO['batch_size'],) + ZLMO['net_output_wh']
    C = sum(bit_cnt)
    logits = (torch.rand(shape + (C,), generator=g) * 2.95 + 0.05) \
        * (torch.randint(0, 2, shape + (C,), generator=g) * 2 - 1)
    _, raw = noc_to_bits(torch.rand(shape + (3,), generator=g) * 2 - 1,
                         bit_cnt, False)
    mask = torch.rand(shape, generator=g) < 0.7
    cot = torch.randn(shape + (3,), generator=g)
    res = []
    for dev in ('cpu', device):
        x = logits.to(dev).clone().requires_grad_()
        v = logits_to_noc_with_gt(x, raw.to(dev), bit_cnt, mask.to(dev),
                                  True)
        v.backward(cot.to(dev))
        res.append((v.detach().cpu(), x.grad.cpu()))
    (v0, g0), (v1, g1) = res
    err = dict(value=float((v0 - v1).abs().max()),
               grad=float((g0 - g1).abs().max()),
               grad_entries_differ=int(((g0 != 0) != (g1 != 0)).sum()))
    check(err['value'] <= 1e-6 and err['grad'] <= 1e-6
          and err['grad_entries_differ'] == 0,
          f'training decode on the card vs the CPU: {err}')
    log(f'[train_zlmo] training decode, card vs CPU: {json.dumps(err)}')
    return err


def train_stage_breakdown(step_fn) -> dict:
    """One more training step, `step_fn` (the call the timed steps made),
    under torch.profiler, read through the ranges that the in-line staging
    (data/pipeline.device_prefetch, train.preprocess_step) and train_step
    open (TRAIN_STAGES). For each stage: host_ms, the time
    between its range's ends, and device_ms, the device time of the kernels
    and copies launched inside it from any thread (autograd launches the
    backward's kernels from its device thread while the caller waits in the
    'backward' range). Then the device-busy time, the kernel count and the
    busy share of the wall, what no range claims, and the shear kernel's
    recorded launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    # ranges (these and torch's 'Optimizer.step#...') also show as device
    # spans; they are not work of the device
    annotations = {e.name for e in events if e.device_type == cpu and (
        getattr(e, 'is_user_annotation', False) or e.name in TRAIN_STAGES
        or '#' in e.name)}
    ranges = {e.name: e.time_range for e in events
              if e.device_type == cpu and e.name in TRAIN_STAGES}
    check(set(ranges) == set(TRAIN_STAGES),
          f'profiled step has the ranges {sorted(ranges)}')
    stages = {name: dict(host_ms=r.elapsed_us() / 1e3, device_ms=0.0)
              for name, r in sorted(ranges.items(), key=lambda x: x[1].start)}
    for e in events:
        if e.device_type != cpu:
            continue
        dev_ms = sum(k.duration for k in e.kernels
                     if k.name not in annotations) / 1e3
        if not dev_ms:
            continue
        for name, r in ranges.items():
            if r.start <= e.time_range.start < r.end:
                stages[name]['device_ms'] += dev_ms
                break
    work = [e for e in events
            if e.device_type == cuda and e.name not in annotations]
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    per_name: dict[str, float] = {}
    for e in work:
        per_name[e.name[:60]] = per_name.get(e.name[:60], 0.0) \
            + e.time_range.elapsed_us() / 1e3
    host = [e for e in prof.key_averages()
            if e.device_type == cpu and e.key not in annotations]
    # the shear kernel's (B2) launches the profiler recorded in this step,
    # at the path's own crops and angles
    shear_ms = [e.time_range.elapsed_us() / 1e3 for e in work
                if 'shear_' in e.name]
    stages.update(
        shear_x_recorded=dict(launches=len(shear_ms),
                              device_ms=sum(shear_ms),
                              mean_ms=float(np.mean(shear_ms))
                              if shear_ms else None),
        profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_outside_ranges_ms=busy_ms - sum(
            v['device_ms'] for k, v in stages.items() if k in TRAIN_STAGES),
        device_kernels=len(work), device_busy_share=busy_ms / wall_ms,
        top_kernels_ms=dict(sorted(per_name.items(),
                                   key=lambda x: -x[1])[:8]),
        top_host_ops_ms={
            e.key[:60]: e.self_cpu_time_total / 1e3
            for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]})
    return stages


# --------------------------------------------------------------------------
# phase 7: the train and test CLIs on a generated BOP tree
# --------------------------------------------------------------------------

def glmo_cli_tree(tmp: str):
    """Phase 7's generated BOP tree under tmp (glmo's widths: 32 training
    and 8 test images, 4 background images) and its config, six steps with
    an evaluation after step 3: (cfg, the path of its YAML)."""
    import cv2
    import yaml
    from lc_tpu_torch.data import synthetic
    bs = GLMO['batch_size']
    root = os.path.join(tmp, 'data')
    t0 = time.perf_counter()
    synthetic.generate_dataset(root, n_images=bs, split='train_syn', seed=3)
    synthetic.generate_dataset(root, n_images=8, split='test_syn', seed=4,
                               list_name='test_list.txt')
    bg = os.path.join(root, 'bg')
    os.makedirs(bg)
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(os.path.join(bg, f'{i}.jpg'), rng.integers(
            0, 256, (60, 80, 3)).repeat(8, 0).repeat(8, 1).astype(np.uint8))
    log(f'[cli] generated the BOP tree in {time.perf_counter() - t0:.1f} s')
    cfg = family_train_cfg('glmo')
    del cfg.train['num_epochs']
    cfg.merge_from_dict({
        'train.num_steps': TRAIN_STEPS, 'train.test_every': 3,
        'train.ckpt_every': 100, 'train_dataset.name': 'synthetic',
        'train_dataset.dataset_root': root,
        'train_dataset.list_files': [os.path.join(root,
                                                  'train_syn_list.txt')],
        'train_dataset.bg_dir': bg,
        'test_dataset.name': 'synthetic',
        'test_dataset.dataset_root': root, 'test_dataset.detection': '',
        'test_dataset.list_files': [os.path.join(root, 'test_list.txt')]})
    cfg_path = os.path.join(tmp, 'glmo_syn.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return cfg, cfg_path


def phase_cli(device) -> dict:
    """Both CLIs as a user runs them, on the card (their default device;
    `--device cpu` only when rehearsed on the CPU), in a temporary
    directory that is removed afterwards."""
    import tempfile
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch import train as train_cli
    bs = GLMO['batch_size']
    with tempfile.TemporaryDirectory() as tmp:
        cfg, cfg_path = glmo_cli_tree(tmp)
        # the host loader alone (PNG decode, cv2 warps, z_crop expansion):
        # the threaded Loader and MPLoader, on the train CLI's own stream
        from lc_tpu_torch.data import native
        loaders = loader_rates(cfg, 'glmo')
        loader_rate = loaders['threads']['crops_per_s']
        log(f'[cli] native z_crop library '
            f'{"used" if native.available() else "absent"}')
        out = os.path.join(tmp, 'out')
        dev_args = [] if device.type == 'cuda' else ['--device', 'cpu']
        zero_kernel_counts()
        t0 = time.perf_counter()
        with recorded_steps(train_cli) as rec:
            train_cli.main(['--config', cfg_path, '--output', out] + dev_args)
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        plain = steps_report(rec, bs)
        exp = os.path.join(out, 'glmo-1')
        with open(os.path.join(exp, 'metrics.jsonl')) as f:
            lines = [json.loads(x) for x in f]
        check([m['step'] for m in lines] == [1, TRAIN_STEPS],
              f'train CLI metrics lines: {lines}')
        check(all(np.isfinite(v) for m in lines for v in m.values()),
              f'non-finite train CLI metrics: {lines}')
        check(counts['shear_x'] == 6 * TRAIN_STEPS,
              f'train CLI: shear kernel launched {counts["shear_x"]} times')
        check(counts['lm_refine'] == 3,
              f'train CLI: LM kernel launched {counts["lm_refine"]} times in '
              'one evaluation of one batch (expected 3)')
        check_hypotheses_launched('train CLI', counts)
        best = [f for f in os.listdir(exp) if f.startswith('model_best_3_')]
        check(len(best) == 1, 'no scored checkpoint exported')
        t0 = time.perf_counter()
        res = test_cli.main(['--weight', os.path.join(exp, 'model_final.ckpt'),
                             '--config', cfg_path, '--output',
                             os.path.join(tmp, 'test'), '--obj', '1']
                            + dev_args)
        test_wall = time.perf_counter() - t0
        check(len(res['weighted']['errors']) == 8, 'test CLI: not 8 poses')
        mp = cli_train_mploader(cfg_path, tmp, lines, dev_args)
        ckpt = cli_test_lc_tpu_ckpt(cfg_path, tmp, dev_args)
        t0 = time.perf_counter()
        dp = phase_data_parallel(cfg_path, tmp, plain, device, dev_args)
        log(f'[phase] data-parallel train and test CLIs: '
            f'{time.perf_counter() - t0:.1f} s')
    rep = dict(train_wall_s=wall, launches=counts, metrics=lines,
               test_wall_s=test_wall, host_loader_crops_per_s=loader_rate,
               loaders=loaders, mploader_train_cli=mp, lc_tpu_ckpt=ckpt,
               loop_crops_per_s=plain['crops_per_s'],
               train_step_ms=plain['train_step_ms'], data_parallel=dp)
    log(f'[cli] {json.dumps(rep)}')
    return rep


def process_cpu_s() -> float:
    """CPU seconds this process (all its threads) has used."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def loader_rates(cfg, tag: str) -> dict:
    """The host loader alone on cfg's training split (train_dataset_1
    left out), as the train loop streams it (train.endless_batches): the
    threaded Loader and MPLoader, each on dataloader.num_workers workers;
    the first batch (the pool's start) timed apart from the next n = 3 x
    num_workers (both keep about num_workers batches in flight, so the
    first n / 3 arrive with the first wave), and the cores this process
    kept busy over those n (the loader's threads, or MPLoader's
    unpickling: its workers are other processes)."""
    import copy
    from lc_tpu_torch import harness
    from lc_tpu_torch.train import endless_batches
    cfg = copy.deepcopy(cfg)
    cfg.pop('train_dataset_1', None)
    rep = dict(cpu_count=os.cpu_count(),
               usable_cpus=len(os.sched_getaffinity(0)),
               workers=cfg.dataloader.get('num_workers', 4))
    n = 3 * rep['workers']
    for name, mp in (('threads', False), ('processes', True)):
        cfg.dataloader['multiprocess'] = mp
        _, loader = harness.make_datasets(cfg, train=True, seed=0)
        try:
            t0 = time.perf_counter()
            it = endless_batches(loader, 0)
            next(it)
            first = time.perf_counter() - t0
            cpu0, t0 = process_cpu_s(), time.perf_counter()
            crops = sum(len(next(it)['obj_id']) for _ in range(n))
            wall = time.perf_counter() - t0
            rep[name] = dict(
                first_batch_s=first, crops_per_s=crops / wall,
                cores_busy_in_this_process=(process_cpu_s() - cpu0) / wall)
        finally:
            if mp:
                loader.close()
    log(f'[loader_{tag}] {json.dumps(rep)}')
    return rep


def cli_train_mploader(cfg_path: str, tmp: str, threaded: list,
                       dev_args: list) -> dict:
    """The train CLI with --opts dataloader.multiprocess=true (MPLoader)
    on the glmo tree: six steps, an evaluation after step 3, counts zeroed
    before and read after; then a run resumed from the step-3 checkpoint
    (held_resumed); the step losses beside the threaded Loader's run of
    the same stream (`threaded`)."""
    from lc_tpu_torch import train as train_cli
    opts = ['--opts', 'dataloader.multiprocess=true']
    out = os.path.join(tmp, 'out_mp')
    zero_kernel_counts()
    t0 = time.perf_counter()
    with recorded_steps(train_cli, snapshot_step=3) as rec:
        train_cli.main(['--config', cfg_path, '--output', out] + opts
                       + dev_args)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    uninterrupted, state = steps_report(rec, GLMO['batch_size']), rec['state']
    exp = os.path.join(out, 'glmo-1')
    with open(os.path.join(exp, 'metrics.jsonl')) as f:
        lines = [json.loads(x) for x in f]
    check([m['step'] for m in lines] == [1, TRAIN_STEPS]
          and all(np.isfinite(v) for m in lines for v in m.values()),
          f'MPLoader train CLI metrics: {lines}')
    check(counts['shear_x'] == 6 * TRAIN_STEPS and counts['lm_refine'] == 3,
          f'MPLoader train CLI launches: {counts}')
    check_hypotheses_launched('MPLoader train CLI', counts)
    best = [f for f in os.listdir(exp) if f.startswith('model_best_3_')]
    check(len(best) == 1, 'MPLoader train CLI: no step-3 checkpoint')
    out2 = os.path.join(tmp, 'resumed_mp')
    with recorded_steps(train_cli, snapshot_step=3) as rec:
        train_cli.main(['--config', cfg_path, '--output', out2, '--ckpt',
                        os.path.join(exp, best[0])] + opts + dev_args)
    resumed = steps_report(rec, GLMO['batch_size'])
    resumed['state_diff'] = state_diff(rec['state'], state)
    rep = dict(train_wall_s=wall, launches=counts, metrics=lines,
               resume=held_resumed(resumed, uninterrupted, 'MPLoader resume'),
               vs_threaded_loss={m['step']: m['loss'] - t['loss']
                                 for m, t in zip(lines, threaded)})
    log(f'[cli_mploader] {json.dumps(rep)}')
    return rep


def held_resumed(resumed: dict, uninterrupted: dict, tag: str) -> dict:
    """A run resumed from the step-3 checkpoint against the uninterrupted
    run, each the steps_report of a run recorded with snapshot_step=3: the
    state entering step 4 (weights, BatchNorm statistics, the optimizer's
    and scheduler's state, the clip thresholds and histogram) bit for bit,
    so is step 4's forward (its loss terms, the stream's batch 4), and step
    6's loss within RERUN_RTOL (the card's backward is not
    bit-reproducible)."""
    steps, ref = resumed['steps'], uninterrupted['steps']
    check(len(steps) == TRAIN_STEPS - 3 and len(ref) == TRAIN_STEPS,
          f'{tag}: {len(steps)} resumed steps')
    diff = resumed['state_diff']
    check(not diff, f'{tag}: the state entering step 4 differs at {diff[:8]}')
    first, want = dict(steps[0]), dict(ref[3])
    first.pop('grad_norm')
    want.pop('grad_norm')
    check(first == want, f'{tag}: step 4 {first} against {want}')
    a, b = steps[-1]['loss'], ref[-1]['loss']
    gap = abs(a - b) / abs(b)
    check(gap <= RERUN_RTOL, f'{tag}: step-6 loss {a} against {b}')
    return dict(state_equal=True, step4_loss_terms_equal=True,
                step6_loss_gap=gap)


def msgpack_pack(obj) -> bytes:
    """msgpack of dicts, lists, str, bytes, ints, floats, None and bools,
    with numpy arrays as flax's ext type 1 (shape, dtype name, C-order
    bytes): the encoding of flax.serialization.to_bytes for a tree of
    arrays, written here so that this script needs neither flax nor the
    msgpack package."""
    import struct
    out = bytearray()

    def size(n, fix, fix_max, *codes):
        if fix is not None and n <= fix_max:
            out.append(fix | n)
            return
        for code, fmt in zip(codes, ('>B', '>H', '>I')):
            if code is not None and n < 256 ** struct.calcsize(fmt):
                out.extend(bytes([code]) + struct.pack(fmt, n))
                return

    def pack(x):
        if x is None or isinstance(x, bool):
            out.append({None: 0xc0, False: 0xc2, True: 0xc3}[x])
        elif isinstance(x, int):
            out.extend(bytes([x]) if 0 <= x < 128
                       else b'\xd3' + struct.pack('>q', x))
        elif isinstance(x, float):
            out.extend(b'\xcb' + struct.pack('>d', x))
        elif isinstance(x, str):
            b = x.encode()
            size(len(b), 0xa0, 31, 0xd9, 0xda, 0xdb)
            out.extend(b)
        elif isinstance(x, (bytes, bytearray)):
            size(len(x), None, 0, 0xc4, 0xc5, 0xc6)
            out.extend(x)
        elif isinstance(x, (list, tuple)):
            size(len(x), 0x90, 15, None, 0xdc, 0xdd)
            for v in x:
                pack(v)
        elif isinstance(x, dict):
            size(len(x), 0x80, 15, None, 0xde, 0xdf)
            for k, v in x.items():
                pack(k)
                pack(v)
        elif isinstance(x, np.ndarray):
            data = msgpack_pack([list(x.shape), x.dtype.name,
                                 np.ascontiguousarray(x).tobytes()])
            out.extend(b'\xc9' + struct.pack('>Ib', len(data), 1) + data)
        else:
            raise TypeError(type(x))
    pack(obj)
    return bytes(out)


def cli_test_lc_tpu_ckpt(cfg_path: str, tmp: str, dev_args: list) -> dict:
    """The test CLI on a .ckpt in lc_tpu's format (the pickled envelope
    around flax msgpack that lc_tpu.train's finish() writes, a plain
    {'params', 'batch_stats'} export of seeded glmo weights) and on the
    same weights saved as a .pth, --deterministic, counts zeroed before
    each and read after: the CSV rows must match (ids and score equal, R
    and t within 1e-4 mm / 1e-6, the time column aside)."""
    import pickle
    import torch
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch.models.weights import (random_flax_variables,
                                             state_dict_from_flax)
    variables = random_flax_variables(seed=21)
    paths = {'ckpt': os.path.join(tmp, 'lc_tpu_export.ckpt'),
             'pth': os.path.join(tmp, 'same_weights.pth')}
    with open(paths['ckpt'], 'wb') as f:
        pickle.dump({'state': msgpack_pack(variables),
                     'aux': {'step': -1}}, f)
    torch.save(state_dict_from_flax(variables), paths['pth'])
    rows, rep = {}, {}
    for fmt, weight in paths.items():
        out = os.path.join(tmp, f'test_{fmt}')
        zero_kernel_counts()
        t0 = time.perf_counter()
        test_cli.main(['--weight', weight, '--config', cfg_path, '--output',
                       out, '--obj', '1', '--deterministic'] + dev_args)
        rep[f'{fmt}_wall_s'] = time.perf_counter() - t0
        rep[f'{fmt}_launches'] = kernel_counts()
        csv = [f for f in os.listdir(out) if f.endswith('.csv')]
        with open(os.path.join(out, csv[0])) as f:
            rows[fmt] = [line.strip().split(',') for line in f]
    a, b = rows['ckpt'], rows['pth']
    check(len(a) == len(b) == 8 and all(x[:4] == y[:4] for x, y in zip(a, b)),
          'lc_tpu .ckpt and .pth test CLI rows differ in ids or scores')
    num = lambda r, i: np.array([float(v) for v in r[i].split()])  # noqa: E731
    dR = max(np.abs(num(x, 4) - num(y, 4)).max() for x, y in zip(a, b))
    dt = max(np.abs(num(x, 5) - num(y, 5)).max() for x, y in zip(a, b))
    check(dR <= 1e-6 and dt <= 1e-4,
          f'lc_tpu .ckpt against .pth: R {dR}, t {dt} mm apart')
    rep.update(rows=len(a), max_R_diff=float(dR), max_t_diff_mm=float(dt),
               identical_rows=all(x[:6] == y[:6] for x, y in zip(a, b)))
    log(f'[cli_lc_tpu_ckpt] {json.dumps(rep)}')
    return rep


# --------------------------------------------------------------------------
# phase 9: data parallelism (torch.distributed) on the one card
# --------------------------------------------------------------------------

# A data-parallel run's step metrics against the one-process run's on the
# same global batches, bf16 convolutions on both sides: step 1's loss terms
# within DP_STEP1_RTOL, every later step's within DP_RTOL, grad_norm within
# DP_GRAD_NORM_RTOL at every step (a loss scale off by the ranks moves it
# 2x), each about 3x the largest gap measured (NVIDIA H100 80GB HBM3,
# 700 W; perf_scripts/dp_fault_gaps.py and chip_smoke runs): step 1 5.5e-4
# (two gloo ranks' loss_pose; one NCCL rank 3.3e-5), later steps 3.3e-3,
# grad_norm 6.8e-2. BatchNorm's statistics are summed in another order,
# which the LC loss amplifies, and the card's backward is not
# bit-reproducible (RERUN_RTOL). These limits cannot see a rank-local
# BatchNorm at glmo's 16 crops a rank (it read 1.9e-4 at step 1): the f64
# step of dp_step_f64, one and two ranks against one process within 1e-9,
# does (a rank-local BatchNorm read 9.5e-2 there).
DP_STEP1_RTOL = 2e-3
DP_RTOL = 1e-2
DP_GRAD_NORM_RTOL = 0.2
# dp_step_f64: the data-parallel step against the one-process step in f64
DP_F64_RTOL = 1e-9
DP_RANKS = 2


class recorded_steps:
    """Context: the train loop of train_cli recorded as it runs, with CUDA
    events and no synchronization: an event when the loop asks for its
    first batch (device_prefetch's first staging), each step's metrics
    (device scalars, read after the run) between two events around
    train_step, then a fingerprint of the step's staged input, and two
    events around each evaluation (harness.run_test). With `snapshot_step`,
    also the training state entering that step (0-based), copied to the
    host between two events that steps_report takes out like an
    evaluation's."""

    def __init__(self, train_cli, snapshot_step: int | None = None):
        self.train_cli = train_cli
        self.snapshot_step = snapshot_step
        self.rec = dict(start=None, steps=[], evals=[], inputs=[],
                        state=None)

    def __enter__(self):
        import torch
        cli, rec = self.train_cli, self.rec
        self.real = (cli.train_step, cli.device_prefetch, cli.harness.run_test)
        real_step, real_prefetch, real_eval = self.real

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def step(*args, **kw):
            if args[6] == self.snapshot_step:
                start = event()
                rec['state'] = training_state(*args[:3], args[4])
                rec['evals'].append((start, event()))
            start = event()
            state, metrics = real_step(*args, **kw)
            rec['steps'].append((start, event(), metrics))
            rec['inputs'].append(fingerprint(args[5]))
            return state, metrics

        def prefetch(*args, **kw):
            rec['start'] = event()
            yield from real_prefetch(*args, **kw)

        def evaluate(*args, **kw):
            start = event()
            out = real_eval(*args, **kw)
            rec['evals'].append((start, event()))
            return out

        cli.train_step, cli.device_prefetch, cli.harness.run_test = \
            step, prefetch, evaluate
        return rec

    def __exit__(self, *exc):
        cli = self.train_cli
        cli.train_step, cli.device_prefetch, cli.harness.run_test = self.real


def training_state(model, optimizer, scheduler, loss_state) -> dict:
    """What a step reads besides its input, on the host: the model's
    state_dict, the optimizer's and the scheduler's, and the loss state
    (the clip thresholds, the histogram)."""
    import torch

    def host(x):
        if torch.is_tensor(x):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [host(v) for v in x]
        return x
    return host(dict(model=model.state_dict(),
                     optimizer=optimizer.state_dict(),
                     scheduler=scheduler.state_dict(),
                     loss_state=loss_state._asdict()))


def state_diff(a, b, at: str = '') -> list:
    """The places where two training_state trees differ, bit for bit."""
    import torch
    if torch.is_tensor(a) or torch.is_tensor(b):
        same = torch.is_tensor(a) and torch.is_tensor(b) \
            and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [at]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f'{at}: keys']
        return [d for k in a for d in state_diff(a[k], b[k], f'{at}/{k}')]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in state_diff(x, y, f'{at}/{i}')]
    return [] if a == b else [at]


def fingerprint(gt: dict):
    """An exact integer checksum of each tensor of a staged input, on the
    device: its bytes weighted by their position (mod 65521, plus 1)."""
    import torch
    sums = []
    for k in sorted(gt):
        b = gt[k].detach().contiguous().view(-1).view(torch.uint8).long()
        w = torch.arange(b.numel(), device=b.device) % 65521 + 1
        sums.append((b * w).sum())
    return torch.stack(sums)


def steps_report(rec, crops: int) -> dict:
    """Every step's metrics; the loop's rate, `crops` a step, from its
    first batch request to the end of its last step with the evaluations'
    (and a state snapshot's) spans taken out (input loading and staging included); and train_step's
    own span, the median over the steps after the first (the step without
    its inputs). Device-timeline times from the recorded events, idle gaps
    included."""
    import torch
    torch.cuda.synchronize()
    steps = rec['steps']
    rep = dict(steps=[{k: float(v) for k, v in m.items()}
                      for _, _, m in steps],
               inputs=[fp.tolist() for fp in rec['inputs']])
    if rec['start'] is not None:
        ms = rec['start'].elapsed_time(steps[-1][1]) - sum(
            a.elapsed_time(b) for a, b in rec['evals'])
        rep.update(loop_ms=ms, crops_per_s=crops * len(steps) / ms * 1e3)
    rep['train_step_ms'] = float(np.median(
        [a.elapsed_time(b) for a, b, _ in steps[1:]]))
    return rep


def held_to_plain(steps, plain, tag: str) -> dict:
    """Each step's metrics of a data-parallel run against the one-process
    run's (DP_STEP1_RTOL, DP_RTOL, DP_GRAD_NORM_RTOL); the largest relative
    gaps, of step 1 and of the later steps apart."""
    check(len(steps) == len(plain), f'{tag}: {len(steps)} steps')
    gaps = dict(step1={}, later={})
    for i, (a, b) in enumerate(zip(steps, plain)):
        check(set(a) == set(b), f'{tag}: metrics {sorted(a)}')
        at = gaps['step1' if i == 0 else 'later']
        for k in a:
            gap = abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
            at[k] = max(at.get(k, 0.0), gap)
            limit = DP_GRAD_NORM_RTOL if k == 'grad_norm' \
                else DP_STEP1_RTOL if i == 0 else DP_RTOL
            check(gap <= limit,
                  f'{tag}: step {i + 1} {k} {a[k]} against {b[k]}')
    return gaps


def dp_step_f64(device, shard, crops: int = 8) -> dict:
    """One f64 training step of CDPN at glmo's widths on a global batch of
    `crops` rendered crops (device-rotated, colour augmentation, the LC
    loss and the clip tap), the one-process step against the data-parallel
    step over `shard` on this rank's rows: loss terms, grad_norm and every
    gradient within DP_F64_RTOL (relative L2 a tensor; a norm below a
    millionth of the largest is noise of an exact zero, of a conv bias
    before BatchNorm)."""
    import torch
    from types import SimpleNamespace
    from lc_tpu_torch import harness
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate
    from lc_tpu_torch.loss.loss_fn import init_loss_state
    from lc_tpu_torch.models import set_compute_dtype
    from lc_tpu_torch.parallel import mesh
    from lc_tpu_torch.train import sample_offset
    from lc_tpu_torch.train_step import train_step
    cfg = family_train_cfg('glmo')
    ds = cfg.train_dataset
    batch = collate(synthetic.render_train_set(
        crops, seed=23, net_input_wh=GLMO['net_input_wh'],
        net_output_wh=GLMO['net_output_wh'], pixel_aug_prob=1.0))
    loss_cfg = harness.make_loss_config(cfg, 100, None)
    pp = harness.preprocess_kwargs(cfg, SimpleNamespace(
        net_input_wh=GLMO['net_input_wh'],
        net_output_wh=GLMO['net_output_wh'],
        mask_nearest=ds.get('mask_interp', 'linear') == 'nearest'), train=True)
    runs = {}
    for name, sh in (('one', None), ('dp', shard)):
        model = set_compute_dtype(path_model(GLMO).to(device).double(),
                                  torch.float64)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
        with mesh.data_parallel(sh):
            gt = staged_in_line({k: mesh.local_rows(v, sh)
                                 for k, v in batch.items()}, 42, 0, device, pp)
            gt = {k: v.double() if v.is_floating_point() else v
                  for k, v in gt.items()}
            _, m = train_step(model, opt, sched, loss_cfg,
                              init_loss_state(loss_cfg, device), gt, 0,
                              sample_offset(42, 0, loss_cfg.dense_sample))
        runs[name] = ({k: float(v) for k, v in m.items()},
                      {k: p.grad.detach().clone()
                       for k, p in model.named_parameters()
                       if p.grad is not None})
    (m1, g1), (m2, g2) = runs['one'], runs['dp']
    check(set(g1) == set(g2), 'f64 step: gradients of other parameters')
    metric_gap = max(abs(m2[k] - v) / abs(v) for k, v in m1.items())
    floor = 1e-6 * max(float(torch.linalg.vector_norm(v)) for v in g1.values())
    grad_gap = max(float(torch.linalg.vector_norm(g2[k] - v))
                   / max(float(torch.linalg.vector_norm(v)), floor)
                   for k, v in g1.items())
    check(max(metric_gap, grad_gap) <= DP_F64_RTOL,
          f'f64 step, {shard.count} data-parallel rank(s) against one '
          f'process: metrics {metric_gap}, gradients {grad_gap} apart')
    return dict(crops=crops, ranks=shard.count, metrics_gap=metric_gap,
                gradients_gap=grad_gap, grad_norm=m1['grad_norm'])


def grad_all_reduce_ms(model, shard, reps: int = 5) -> float:
    """Host time of one flat all-reduce of the model's gradients
    (mesh.all_reduce_grads, as a step runs it), synchronized."""
    import torch
    from lc_tpu_torch.parallel import mesh
    params = [p for p in model.parameters() if p.grad is not None]
    mesh.all_reduce_grads(params, shard)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.all_reduce_grads(params, shard)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def csv_rows(out_dir: str) -> dict:
    """{solver: rows} of the test CLI's CSVs in out_dir."""
    rows = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith('.csv'):
            with open(os.path.join(out_dir, name)) as f:
                rows[name.split('-', 1)[1].split('_')[0]] = [
                    line.strip().split(',') for line in f]
    return rows


def held_csv_rows(rows, ref, tag: str) -> dict:
    """A sharded test CLI's CSV rows against the one-process run's, the
    rule of tests/test_torch_parallel.py: the same crops in the same order
    and scores; where the RANSAC winners agree within B1's tolerance, the
    weighted poses too."""
    from scipy.spatial.transform import Rotation
    check(set(rows) == set(ref) == {'weighted', 'ransac'},
          f'{tag}: CSVs {sorted(rows)}')
    num = lambda r, i: np.array([float(v) for v in r[i].split()])  # noqa: E731

    def agree(a, b):
        qa, qb = (Rotation.from_matrix(num(x, 4).reshape(3, 3)).as_quat()
                  for x in (a, b))
        return np.abs(num(a, 5) - num(b, 5)).max() <= TOL['translation_atol'] \
            and abs(float(qa @ qb)) >= TOL['quat_dot_min']

    for solver in rows:
        check(len(rows[solver]) == len(ref[solver])
              and all(a[:4] == b[:4] for a, b in zip(rows[solver],
                                                     ref[solver])),
              f'{tag}: {solver} rows differ in ids or scores')
    same = [i for i, (a, b) in enumerate(zip(rows['ransac'], ref['ransac']))
            if agree(a, b)]
    check(len(same) >= len(ref['ransac']) // 2,
          f'{tag}: RANSAC winners agree on {len(same)} crops only')
    for i in same:
        check(agree(rows['weighted'][i], ref['weighted'][i]),
              f'{tag}: crop {i}: weighted poses differ')
    return dict(rows=len(ref['weighted']), ransac_winners_agree=len(same),
                identical_rows=all(a[:6] == b[:6] for s in rows
                                   for a, b in zip(rows[s], ref[s])))


def test_cli_args(weight: str, cfg_path: str, out: str) -> list:
    return ['--weight', weight, '--config', cfg_path, '--output', out,
            '--obj', '1', '--deterministic', '--opts',
            "pnp_solver.solvers=['weighted','ransac']"]


def phase_data_parallel(cfg_path: str, tmp: str, plain: dict, device,
                        dev_args: list) -> dict:
    """The train and test CLIs data-parallel on phase 7's glmo tree (glmo's
    widths, global batch 32, device_rotate, an evaluation after step 3):
    (a) one rank over NCCL in this process: an f64 step against one
    process (dp_step_f64), train(..., parallel=<group>) so that the
    data-parallel path runs, then the one-process test CLI on its
    model_final; (b) two ranks on the one card over gloo, each a child
    process with device cuda:0 (NCCL refuses two ranks on one device;
    gloo takes CUDA tensors through host memory): the f64 step, then 16
    crops a rank, a resume from step 3 (held_resumed), the test CLI on its
    model_final; also the one-process loop that stages each batch when the
    step takes it (no prefetch) against phase 7's run, every staged input
    bit-equal. Each run's counts are zeroed just before and read just
    after; the step metrics are held to the one-process run's (`plain`,
    held_to_plain). Two ranks sharing one card are no scaling
    figure: their crops/s says what the collectives cost, not what two
    cards would give."""
    import argparse
    import multiprocessing
    import torch
    import torch.distributed as dist
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch import train as train_cli
    from lc_tpu_torch.parallel import mesh
    from lc_tpu_torch.utils.config import load_config
    bs = GLMO['batch_size']
    rep = dict(plain=dict(crops_per_s=plain['crops_per_s'],
                          train_step_ms=plain['train_step_ms']))

    # the loop without prefetch: the same values. Every step's staged input
    # and step 1's forward bit for bit; every later step's loss within the
    # card's run-to-run spread (the backward is not bit-reproducible there;
    # grad_norm, which spreads most, is reported)
    saved, train_cli.PREFETCH_BATCHES = train_cli.PREFETCH_BATCHES, 0
    zero_kernel_counts()
    try:
        with recorded_steps(train_cli) as rec:
            train_cli.main(['--config', cfg_path, '--output',
                            os.path.join(tmp, 'out_inline')] + dev_args)
    finally:
        train_cli.PREFETCH_BATCHES = saved
    inline_counts = kernel_counts()
    check(inline_counts == {'lm_refine': 3, 'shear_x': 6 * TRAIN_STEPS,
                           'minimal6': 1},
          f'train CLI without prefetch: launches {inline_counts}')
    inline = steps_report(rec, bs)
    check(inline.pop('inputs') == plain['inputs'],
          'no prefetch: staged inputs differ from the prefetched run\'s')
    first, ref = dict(inline['steps'][0]), dict(plain['steps'][0])
    grad_gap = abs(first.pop('grad_norm') / ref.pop('grad_norm') - 1)
    check(first == ref, f'no prefetch: step 1 {first} against {ref}')
    gap = max(abs(a['loss'] - b['loss']) / abs(b['loss'])
              for a, b in zip(inline['steps'], plain['steps']))
    check(gap <= RERUN_RTOL, f'no prefetch: step losses {gap} apart')
    rep['no_prefetch'] = dict(launches=inline_counts,
                              crops_per_s=inline['crops_per_s'],
                              train_step_ms=inline['train_step_ms'],
                              max_loss_gap=gap, step1_grad_norm_gap=grad_gap,
                              staged_inputs_equal=True)

    # (a) NCCL, one rank, in this process
    dist.init_process_group('nccl', store=dist.FileStore(
        os.path.join(tmp, 'nccl1.store'), 1), rank=0, world_size=1)
    try:
        f64 = dp_step_f64(device, mesh.shard_of(dist.group.WORLD))
        log(f'[dp_nccl1] f64 step: {json.dumps(f64)}')
        outdir = os.path.join(tmp, 'out_nccl1', 'glmo-1')
        os.makedirs(outdir)
        zero_kernel_counts()
        with recorded_steps(train_cli) as rec:
            model = train_cli.train(argparse.Namespace(resume=False,
                                                       ckpt=None),
                                    load_config(cfg_path), outdir,
                                    device=device, parallel=dist.group.WORLD)
        counts = kernel_counts()
        a = steps_report(rec, bs)
        a.pop('inputs')
        a['grad_all_reduce_ms'] = grad_all_reduce_ms(
            model, mesh.shard_of(dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    del model
    check(counts == {'lm_refine': 3, 'shear_x': 6 * TRAIN_STEPS,
                     'minimal6': 1},
          f'NCCL one-rank train CLI launches: {counts}')
    a.update(launches=counts, f64_step=f64,
             gaps=held_to_plain(a['steps'], plain['steps'], 'nccl1'))
    zero_kernel_counts()
    res = test_cli.main(test_cli_args(os.path.join(outdir, 'model_final.ckpt'),
                                      cfg_path, os.path.join(tmp, 'test_nccl1'))
                        + dev_args)
    a['test_launches'] = kernel_counts()
    check(len(res['weighted']['errors']) == 8
          and a['test_launches']['lm_refine'] == 3,
          f'test CLI on the NCCL run: {a["test_launches"]}')
    check_hypotheses_launched('test CLI on the NCCL run', a['test_launches'])
    rep['nccl1'] = a
    log(f'[dp_nccl1] {json.dumps(a)}')

    # (b) two ranks on the one card over gloo
    torch.cuda.empty_cache()
    import socket
    with socket.socket() as sk:
        sk.bind(('127.0.0.1', 0))
        port = sk.getsockname()[1]
    ctx = multiprocessing.get_context('spawn')
    results = [os.path.join(tmp, f'dp_rank{r}.json') for r in range(DP_RANKS)]
    procs = [ctx.Process(target=dp_rank_main,
                         args=(r, port, cfg_path, tmp, results[r]))
             for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 600
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(all(p.exitcode == 0 for p in procs),
          f'gloo ranks exit codes {[p.exitcode for p in procs]}')
    ranks = []
    for path in results:
        with open(path) as f:
            ranks.append(json.load(f))
    r0, r1 = ranks
    check(r0['train']['steps'] == r1['train']['steps'],
          'gloo ranks report different step metrics')
    b = dict(gaps=held_to_plain(r0['train']['steps'], plain['steps'],
                                'gloo2'))
    for r, x in enumerate(ranks):
        check(x['train_launches'] == {'lm_refine': 3,
                                      'shear_x': 6 * TRAIN_STEPS,
                                      'minimal6': 1},
              f'gloo rank {r} train CLI launches: {x["train_launches"]}')
        check(x['resumed_launches']['shear_x'] == 6 * (TRAIN_STEPS - 3),
              f'gloo rank {r} resumed launches: {x["resumed_launches"]}')
        check(x['test_launches']['lm_refine'] == 3,
              f'gloo rank {r} test CLI launches: {x["test_launches"]}')
        check_hypotheses_launched(f'gloo rank {r} test CLI',
                                  x['test_launches'])
    check(not r1['written'] and not r1['made_dirs']
          and any(w.endswith('metrics.jsonl') for w in r0['written']),
          f'files written: rank 0 {r0["written"]}, rank 1 {r1["written"]}; '
          f'directories made by rank 1 {r1["made_dirs"]}')
    resume = [held_resumed(x['resumed'], x['train'], f'gloo rank {r} resume')
              for r, x in enumerate(ranks)]
    check(r0['scores'] == r1['scores'], 'gloo ranks: different scores')
    # the one-process test CLI on the two-rank run's model_final
    final = os.path.join(tmp, 'out_gloo2', 'glmo-1', 'model_final.ckpt')
    test_cli.main(test_cli_args(final, cfg_path,
                                os.path.join(tmp, 'test_gloo2_ref'))
                  + dev_args)
    b['csv'] = held_csv_rows(csv_rows(os.path.join(tmp, 'test_gloo2')),
                             csv_rows(os.path.join(tmp, 'test_gloo2_ref')),
                             'gloo2 test CLI')
    b.update(crops_per_s=r0['train']['crops_per_s'],
             train_step_ms=[x['train']['train_step_ms'] for x in ranks],
             grad_all_reduce_ms=[x['grad_all_reduce_ms'] for x in ranks],
             resume=resume, f64_step=r0['f64_step'],
             launches={f'rank{r}': dict(train=x['train_launches'],
                                        resumed=x['resumed_launches'],
                                        test=x['test_launches'])
                       for r, x in enumerate(ranks)},
             written_by_rank0=len(r0['written']),
             gloo_cuda_tensors=r0['gloo_cuda_tensors'])
    rep['gloo2'] = b
    log(f'[dp_gloo2] {json.dumps(b)}')
    log(f'[dp] glmo train CLI, crops/s of the loop (evaluation out) / '
        f'train_step ms: one process {plain["crops_per_s"]:.1f} / '
        f'{plain["train_step_ms"]:.1f}, no prefetch '
        f'{inline["crops_per_s"]:.1f} / {inline["train_step_ms"]:.1f}, NCCL '
        f'one rank {a["crops_per_s"]:.1f} / {a["train_step_ms"]:.1f} '
        f'(gradient all-reduce {a["grad_all_reduce_ms"]:.2f} ms), two gloo '
        f'ranks on one card {b["crops_per_s"]:.1f} / '
        f'{max(b["train_step_ms"]):.1f} (gradient all-reduce '
        f'{max(b["grad_all_reduce_ms"]):.1f} ms; two ranks sharing one card '
        f'through host memory: not a scaling figure)')
    return rep


def dp_rank_main(rank: int, port: int, cfg_path: str, tmp: str,
                 result: str):
    """One gloo rank of phase 9 (b), in a child process on cuda:0: the
    train CLI, a resume from step 3 and the test CLI, each with the
    counts zeroed before and read after, every file this rank writes
    recorded, and every directory it makes in the run's tree `tmp`.
    First one f64 step of the two ranks against one process (dp_step_f64).
    Writes its report to `result`."""
    import builtins
    import datetime
    import glob
    import shutil
    import torch
    import torch.distributed as dist
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch import train as train_cli
    from lc_tpu_torch.parallel import mesh
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=DP_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    written, made_dirs = [], []
    real_open, real_replace, real_link = builtins.open, os.replace, os.link
    real_copy, real_makedirs = shutil.copy2, os.makedirs

    def opened(file, mode='r', *a, **k):
        if any(c in mode for c in 'wax+'):
            written.append(str(file))
        return real_open(file, mode, *a, **k)

    def replaced(src, dst, *a, **k):
        written.append(str(dst))
        return real_replace(src, dst, *a, **k)

    def linked(src, dst, *a, **k):
        written.append(str(dst))
        return real_link(src, dst, *a, **k)

    def copied(src, dst, *a, **k):
        written.append(str(dst))
        return real_copy(src, dst, *a, **k)

    def made(name, *a, **k):
        if str(name).startswith(tmp) and not os.path.isdir(name):
            made_dirs.append(str(name))
        return real_makedirs(name, *a, **k)

    builtins.open, os.replace, os.link, shutil.copy2, os.makedirs = \
        opened, replaced, linked, copied, made
    try:
        # gloo takes CUDA tensors (through host memory)
        probe = torch.full((4,), float(rank + 1), device='cuda:0')
        dist.all_reduce(probe)
        rep = dict(gloo_cuda_tensors=probe.tolist())
        check(rep['gloo_cuda_tensors'] == [3.0] * 4, f'gloo: {probe}')
        rep['f64_step'] = dp_step_f64('cuda:0',
                                      mesh.shard_of(dist.group.WORLD))
        dev = ['--device', 'cuda:0']
        zero_kernel_counts()
        with recorded_steps(train_cli, snapshot_step=3) as rec:
            model = train_cli.main(['--config', cfg_path, '--output',
                                    os.path.join(tmp, 'out_gloo2')] + dev)
        rep['train_launches'] = kernel_counts()
        rep['train'] = steps_report(rec, GLMO['batch_size'])
        state = rec['state']
        rep['grad_all_reduce_ms'] = grad_all_reduce_ms(
            model, mesh.shard_of(dist.group.WORLD))
        del model
        step3, = glob.glob(os.path.join(tmp, 'out_gloo2', 'glmo-1',
                                        'model_best_3_*.ckpt'))
        zero_kernel_counts()
        with recorded_steps(train_cli, snapshot_step=3) as rec:
            train_cli.main(['--config', cfg_path, '--output',
                            os.path.join(tmp, 'out_gloo2_resumed'),
                            '--ckpt', step3] + dev)
        rep['resumed_launches'] = kernel_counts()
        rep['resumed'] = steps_report(rec, GLMO['batch_size'])
        rep['resumed']['state_diff'] = state_diff(rec['state'], state)
        del state
        zero_kernel_counts()
        res = test_cli.main(test_cli_args(
            os.path.join(tmp, 'out_gloo2', 'glmo-1', 'model_final.ckpt'),
            cfg_path, os.path.join(tmp, 'test_gloo2')) + dev)
        rep['test_launches'] = kernel_counts()
        rep['scores'] = {k: v['avg_score'] for k, v in res.items()}
    finally:
        builtins.open, os.replace, os.link, shutil.copy2, os.makedirs = \
            real_open, real_replace, real_link, real_copy, real_makedirs
        dist.destroy_process_group()
    rep.update(written=written, made_dirs=made_dirs)
    with open(result, 'w') as f:
        json.dump(rep, f)


def phase_cli_families(device) -> dict:
    """`python -m lc_tpu_torch.test` as a user runs it on the zebra and the
    sparse family: configs/zsyn.yaml on a generated synthetic_sym tree and
    configs/gspsyn.yaml on a generated tree with its FPS pickle (the recipes
    in those files' headers, at their widths and batch), 3 batches each, a
    .pth of seeded random weights in the reference layout; counts zeroed
    before each and read after."""
    import pickle
    import tempfile
    import torch
    import yaml
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.utils.config import load_config
    here = os.path.dirname(os.path.abspath(__file__))
    dev_args = [] if device.type == 'cuda' else ['--device', 'cpu']
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in (('zsyn', ZLMO), ('gspsyn', GSPLMO)):
            cfg = load_config(os.path.join(here, 'configs', f'{name}.yaml'))
            bs = cfg.dataloader.batch_size
            root = os.path.join(tmp, name)
            t0 = time.perf_counter()
            list_file = synthetic.generate_dataset(
                root, n_images=N_BATCHES * bs, split='test_syn', seed=5,
                symmetric=name == 'zsyn', list_name='test_list.txt')
            overrides = {'test_dataset.dataset_root': root,
                         'test_dataset.list_files': [list_file]}
            if cfg.get('sparse_cnt', 0):
                overrides['fps'] = os.path.join(root, 'fps.pkl')
                with open(overrides['fps'], 'wb') as f:
                    pickle.dump({1: synthetic.box_surface_points(
                        np.array(BOX_HALF_EXTENTS), 16)}, f)
            cfg.merge_from_dict(overrides)
            cfg_path = os.path.join(tmp, f'{name}.yaml')
            with open(cfg_path, 'w') as f:
                yaml.safe_dump(cfg.to_dict(), f)
            # the family's network at this config's head (zsyn: 7/7/6 bits)
            weight = os.path.join(tmp, f'{name}.pth')
            torch.save(path_model(dict(path, max_bit_cnt=cfg.get(
                'max_bit_cnt', 0))).state_dict(), weight)
            log(f'[cli_{name}] generated {N_BATCHES * bs} frames in '
                f'{time.perf_counter() - t0:.1f} s')
            # BOP'19 scores on the symmetric object
            bop = ['--opts', 'eval_bop_scores=true'] if name == 'zsyn' else []
            zero_kernel_counts()
            t0 = time.perf_counter()
            res = test_cli.main(['--weight', weight, '--config', cfg_path,
                                 '--output', os.path.join(tmp, f'out_{name}'),
                                 '--obj', '1'] + bop + dev_args)
            wall = time.perf_counter() - t0
            counts = kernel_counts()
            solvers = {p.replace('_', '-') for p in cfg.pnp_solver.solvers}
            check(set(res) == solvers, f'{name} test CLI: solvers {set(res)}')
            for solver in solvers:
                check(len(res[solver]['errors']) == N_BATCHES * bs,
                      f'{name} test CLI: not {N_BATCHES * bs} poses')
                check(os.path.exists(os.path.join(
                    tmp, f'out_{name}',
                    f'{name}-{solver}_{cfg.train_dataset.name}_test_1.csv')),
                    f'{name} test CLI: no CSV for {solver}')
            check(counts['lm_refine'] == 3 * N_BATCHES,
                  f'{name} test CLI: LM kernel launched '
                  f'{counts["lm_refine"]} times in {N_BATCHES} batches')
            check_hypotheses_launched(f'{name} test CLI', counts)
            rep[name] = dict(wall_s=wall, crops=N_BATCHES * bs,
                             launches=counts, solvers=sorted(solvers),
                             add_s_0_10={k: v['avg_score']
                                         for k, v in res.items()})
            if bop:
                ar = {k: {key: v['per_obj_score'][1][key] for key in
                          ('bop_mssd_ar', 'bop_mspd_ar')}
                      for k, v in res.items()}
                check(all(0 <= x <= 1 for d in ar.values()
                          for x in d.values()), f'{name} BOP AR: {ar}')
                # a random network's pose may lie far enough for f32 to
                # overflow: its error is inf, a miss, as in lc_tpu
                errs = [e for v in res.values() for e in v['errors']]
                check(all(isinstance(e.get('mssd'), float)
                          and isinstance(e.get('mspd'), float)
                          for e in errs), f'{name}: mssd / mspd missing')
                rep[name]['bop_ar'] = ar
                rep[name]['bop_finite_errors'] = sum(
                    bool(np.isfinite(e['mssd']) and np.isfinite(e['mspd']))
                    for e in errs)
            log(f'[cli_{name}] {json.dumps(rep[name])}')
    return rep


def phase_cli_train_families(device) -> dict:
    """`python -m lc_tpu_torch.train` as a user runs it on the zebra and the
    sparse family, at their configs' widths and batch: configs/zsyn.yaml on
    a generated synthetic_sym tree with a second generated split mixed in
    as train_dataset_1 at ratio 0.75 (RatioMixLoader; sym_aware from step
    0, so the targets select among the symmetric candidates on the card),
    configs/gspsyn.yaml on a generated tree with its keypoint pickle. Each:
    six steps with an evaluation after step 3 (counts zeroed before and
    read after), a second run resumed from the step-3 checkpoint that must
    start from the stored histogram and clip thresholds, then
    `python -m lc_tpu_torch.test` on the first run's model_final."""
    import pickle
    import tempfile
    import torch
    import yaml
    from lc_tpu_torch import harness
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch import train as train_cli
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.utils.checkpoint import load_checkpoint
    from lc_tpu_torch.utils.config import load_config
    here = os.path.dirname(os.path.abspath(__file__))
    dev_args = [] if device.type == 'cuda' else ['--device', 'cpu']
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, terms in (
                ('zsyn', ('loss_noc_bin', 'loss_seg', 'loss_pose')),
                ('gspsyn', ('loss_kpts', 'loss_pose'))):
            cfg = load_config(os.path.join(here, 'configs', f'{name}.yaml'))
            bs = cfg.dataloader.batch_size
            root = os.path.join(tmp, name)
            sym = name == 'zsyn'
            t0 = time.perf_counter()
            gen = dict(symmetric=sym)
            train_list = synthetic.generate_dataset(
                root, n_images=bs, split='train_syn', seed=6, **gen)
            test_list = synthetic.generate_dataset(
                root, n_images=8, split='test_syn', seed=7,
                list_name='test_list.txt', **gen)
            overrides = {
                'train.num_steps': TRAIN_STEPS, 'train.test_every': 3,
                'train.ckpt_every': 100,
                'train_dataset.dataset_root': root,
                'train_dataset.list_files': [train_list],
                'test_dataset.dataset_root': root,
                'test_dataset.list_files': [test_list]}
            if sym:
                pbr_list = synthetic.generate_dataset(
                    root, n_images=bs, split='train_pbr', seed=8, **gen)
                overrides['train_dataset_1'] = {
                    'name': 'synthetic_sym', 'ratio': 0.75,
                    'list_files': [pbr_list]}
            else:
                overrides['fps'] = os.path.join(root, 'fps.pkl')
                with open(overrides['fps'], 'wb') as f:
                    pickle.dump({1: synthetic.box_surface_points(
                        np.array(BOX_HALF_EXTENTS), 16)}, f)
            cfg.merge_from_dict(overrides)
            cfg_path = os.path.join(tmp, f'{name}.yaml')
            with open(cfg_path, 'w') as f:
                yaml.safe_dump(cfg.to_dict(), f)
            log(f'[train_cli_{name}] generated the tree in '
                f'{time.perf_counter() - t0:.1f} s')
            _, loader = harness.make_datasets(cfg, train=True, seed=0)
            mixed = isinstance(loader, harness.RatioMixLoader)
            check(mixed == sym, f'{name}: RatioMixLoader {mixed}')
            loaders = loader_rates(cfg, name)

            out = os.path.join(tmp, f'out_{name}')
            zero_kernel_counts()
            t0 = time.perf_counter()
            train_cli.main(['--config', cfg_path, '--output', out] + dev_args)
            wall = time.perf_counter() - t0
            counts = kernel_counts()
            exp = os.path.join(out, f'{name}-1')
            with open(os.path.join(exp, 'metrics.jsonl')) as f:
                lines = [json.loads(x) for x in f]
            check([m['step'] for m in lines] == [1, TRAIN_STEPS],
                  f'{name} train CLI metrics lines: {lines}')
            check(set(lines[0]) == {'step', 'loss', 'grad_norm', *terms},
                  f'{name} train CLI metrics: {sorted(lines[0])}')
            check(all(np.isfinite(v) for m in lines for v in m.values()),
                  f'non-finite {name} train CLI metrics: {lines}')
            check(counts['lm_refine'] == 3,
                  f'{name} train CLI: LM kernel launched '
                  f'{counts["lm_refine"]} times in one evaluation of one '
                  'batch (expected 3)')
            check_hypotheses_launched(f'{name} train CLI', counts)
            best = [f for f in os.listdir(exp)
                    if f.startswith('model_best_3_')]
            check(len(best) == 1, f'{name}: no scored checkpoint exported')
            best = os.path.join(exp, best[0])
            stored = load_checkpoint(best)['state']['loss_state']

            # resume from the step-3 checkpoint (model_best_3 is the full
            # training state at step 3): the loop's first step must get the
            # stored histogram and clip thresholds
            seen = []
            real_step = train_cli.train_step

            def spy(*args, **kw):
                seen.append((args[6], args[4]))
                return real_step(*args, **kw)
            train_cli.train_step = spy
            try:
                out2 = os.path.join(tmp, f'resumed_{name}')
                train_cli.main(['--config', cfg_path, '--output', out2,
                                '--ckpt', best] + dev_args)
            finally:
                train_cli.train_step = real_step
            first_step, state = seen[0]
            check(first_step == 3 and len(seen) == TRAIN_STEPS - 3,
                  f'{name}: resumed at step {first_step}, {len(seen)} steps')
            same = [(a is None and b is None) or (
                a is not None and b is not None
                and torch.equal(a.cpu(), b.cpu()))
                for a, b in zip(
                    (state.histogram, *state.weight_clip),
                    (stored.histogram, *stored.weight_clip))]
            check(all(same) and (stored.histogram is None) == (not sym),
                  f'{name}: the resumed loss state is not the stored one '
                  f'({same})')
            with open(os.path.join(out2, f'{name}-1', 'metrics.jsonl')) as f:
                resumed = [json.loads(x) for x in f]
            check(resumed[-1]['step'] == TRAIN_STEPS and all(
                np.isfinite(v) for v in resumed[-1].values()),
                f'{name}: resumed run metrics {resumed}')

            t0 = time.perf_counter()
            res = test_cli.main(['--weight',
                                 os.path.join(exp, 'model_final.ckpt'),
                                 '--config', cfg_path, '--output',
                                 os.path.join(tmp, f'test_{name}'),
                                 '--obj', '1'] + dev_args)
            test_wall = time.perf_counter() - t0
            for solver, r in res.items():
                check(len(r['errors']) == 8,
                      f'{name} test CLI: not 8 poses for {solver}')
            rep[name] = dict(
                train_wall_s=wall, launches=counts, ratio_mix=mixed,
                loaders=loaders,
                metrics=lines, resumed_last=resumed[-1],
                resumed_vs_uninterrupted_loss=resumed[-1]['loss']
                - lines[-1]['loss'],
                stored_histogram=None if stored.histogram is None
                else stored.histogram.tolist(),
                stored_weight_clip=float(stored.weight_clip.max_norm),
                test_wall_s=test_wall,
                add_s_0_10={k: v['avg_score'] for k, v in res.items()})
            log(f'[train_cli_{name}] {json.dumps(rep[name])}')
    return rep


# --------------------------------------------------------------------------
# the learned results' script (perf_scripts/learned_syn.py)
# --------------------------------------------------------------------------

# perf_scripts/learned_syn.py's arm at configs/syn.yaml's widths and batch,
# cut to LEARNED_OPTS' steps on a tree of LEARNED_VIEWS (training/held-out)
LEARNED_ARM = 'syn-s42'
LEARNED_VIEWS = '48/8'
LEARNED_OPTS = ('train.num_steps=20', 'train.ckpt_every=10')
LEARNED_KEYS = {'arm', 'config', 'seed', 'steps', 'batch', 'eval', 'device',
                'solver', 'AUCadi_10_p11', 'AUCad_10_p11', 'AUCadi_10_all',
                'AUCad_10_all', 'add(-s)_0.10', 'train_wall_s',
                'train_attempts', 'loop_crops_per_s', 'eval_wall_s',
                'test_views', 'test_batches', 'launches', 'card'}


def phase_learned_driver(device) -> dict:
    """perf_scripts/learned_syn.py, the script of the learned results, as
    it runs an arm: the syn-s42 arm (configs/syn.yaml, 256² in, 64² out,
    batch 16) cut to 20 steps with a checkpoint at step 10, on a 48/8-view
    tree generated in a temporary directory, through the train CLI and
    each of the arm's evaluations by the test CLI (f32, int8 dynamic and
    static on the card, the CPU), every CLI a process of its own. Every
    line of its output must parse and hold its keys and the run's steps and
    batch; each evaluation on the card must launch B1 3 times a batch and
    minimal6 once, the CPU's neither, and the training no shear kernel
    (syn does not rotate on the device). Returns its lines and seconds."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    dev_args = [] if device.type == 'cuda' else ['--device', 'cpu']
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.join(here, 'perf_scripts',
                                          'learned_syn.py'),
             '--arm', LEARNED_ARM, '--root', tmp, '--views', LEARNED_VIEWS,
             *dev_args, '--opts', *LEARNED_OPTS],
            capture_output=True, text=True, timeout=900, cwd=here)
        seconds = time.perf_counter() - t0
        check(p.returncode == 0, f'learned_syn.py exited {p.returncode}: '
              f'{p.stderr[-3000:]}')
    from lc_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(here, 'configs', 'syn.yaml'),
                      list(LEARNED_OPTS))
    lines = [json.loads(s) for s in p.stdout.splitlines()]
    check({line['eval'] for line in lines}
          == {'f32', 'int8_dynamic', 'int8_static', 'cpu'},
          f'learned_syn.py evaluations: {[x["eval"] for x in lines]}')
    for line in lines:
        tag = f'learned_syn.py {line["eval"]} {line["solver"]}'
        check(set(line) == LEARNED_KEYS, f'{tag}: keys {sorted(line)}')
        check(line['steps'] == cfg.train.num_steps
              and line['batch'] == cfg.dataloader.batch_size
              and line['test_views'] == int(LEARNED_VIEWS.split('/')[1]),
              f'{tag}: {line}')
        check(all(line[k] is None or np.isfinite(line[k])
                  for k in ('AUCadi_10_p11', 'AUCad_10_p11', 'AUCadi_10_all',
                            'AUCad_10_all', 'add(-s)_0.10')),
              f'{tag}: scores {line}')
        ev, batches = line['launches']['eval'], line['test_batches']
        on_card = line['device'] == 'cuda'
        check(ev['lm_refine'] == (3 * batches if on_card else 0)
              and ev['minimal6'] == (batches if on_card else 0)
              and ev['shear_x'] == 0,
              f'{tag}: launches {ev} in {batches} batches')
        check(line['launches']['train']['shear_x'] == 0
              and line['launches']['train']['lm_refine'] == 0,
              f'{tag}: training launches {line["launches"]["train"]}')
        log(f'[learned] {json.dumps(line)}')
    return dict(lines=lines, seconds=seconds)


# --------------------------------------------------------------------------
# phase 9: bench_torch.py, the port's benchmark CLI
# --------------------------------------------------------------------------

def bench_line_ok(out: dict, tag: str):
    check(set(out) == BENCH_KEYS, f'bench {tag}: keys {sorted(out)}')


def bench_mfu_ok(mfu, tag: str, device):
    """MFU in (0, 1.05], or null where bench_torch has no peak for the
    card."""
    import bench_torch
    if bench_torch.peak_ops(device, 'bf16') is None:
        check(mfu is None, f'bench {tag}: MFU {mfu} without a known peak')
    else:
        check(mfu is not None and 0 < mfu <= 1.05, f'bench {tag}: MFU {mfu}')


def phase_bench(device) -> dict:
    """bench_torch's modes in this process at reduced iterations, the
    kernel counts zeroed before each and read after; then the script
    alone, as a user runs it."""
    import ast
    import torch
    import bench_torch
    rep = {}
    for mode in BENCH_MODES:
        run = bench_torch.Run(device, **BENCH_RUN)
        zero_kernel_counts()
        t0 = time.perf_counter()
        out = bench_torch.run_mode(mode, run)
        seconds = time.perf_counter() - t0
        counts = kernel_counts()
        bench_line_ok(out, mode)
        if mode == 'mfu':
            bench_mfu_ok(out['value'], mode, device)
        else:
            check(out['value'] is not None and np.isfinite(out['value'])
                  and out['value'] > 0, f'bench {mode}: value {out["value"]}')
        if mode == 'train_trace':
            split = ast.literal_eval(out['metric'].split('): ', 1)[1])
            for k in ('fwd_mfu', 'bwd_mfu'):
                bench_mfu_ok(split[k], f'{mode} {k}', device)
        b = run.batches
        # one RANSAC call a batch, with its 2 LO polishes, and the final
        # refine; the stage budget's prefixes: hyp (RANSAC without LO),
        # ransac, lm
        if mode in BENCH_INFERENCE:
            want, want_m6 = 3 * b['inference'], b['inference']
        elif mode == 'stages':
            want = 2 * b['ransac'] + 3 * b['lm']
            want_m6 = b['hyp'] + b['ransac'] + b['lm']
        else:
            want = want_m6 = 0
        check(counts['lm_refine'] == want,
              f'bench {mode}: LM kernel launched {counts["lm_refine"]} '
              f'times, {want} expected for {dict(b)}')
        check(counts['minimal6'] == want_m6,
              f'bench {mode}: minimal6 kernel launched {counts["minimal6"]} '
              f'times, {want_m6} expected for {dict(b)}')
        check(counts['shear_x'] == 0,
              f'bench {mode}: shear kernel launched {counts["shear_x"]} times')
        rep[mode] = dict(line=out, seconds=seconds, launches=counts,
                         batches=dict(b))
        log(f'[bench] {mode} {seconds:.1f} s {json.dumps(out)} '
            f'launches {counts} batches {dict(b)}')
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, 'bench_torch.py'],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    check(p.returncode == 0,
          f'python bench_torch.py exited {p.returncode}: {p.stderr[-2000:]}')
    last = p.stdout.strip().splitlines()[-1]
    out = json.loads(last)
    bench_line_ok(out, 'cli')
    check(np.isfinite(out['value']) and out['value'] > 0,
          f'python bench_torch.py: value {out["value"]}')
    rep['cli_headline'] = dict(line=out, seconds=seconds)
    log(f'[bench] python bench_torch.py {seconds:.1f} s: {last}')
    return rep


def descendants(pid: int) -> list[int]:
    """Every live process below `pid`, from /proc."""
    children: dict[int, list[int]] = {}
    for entry in os.listdir('/proc'):
        if not entry.isdigit():
            continue
        try:
            with open(f'/proc/{entry}/stat') as f:
                fields = f.read().rsplit(')', 1)[1].split()
        except OSError:
            continue
        if fields[0] != 'Z':
            children.setdefault(int(fields[1]), []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        found += kids
        todo += kids
    return found


def stop_children() -> list[str]:
    """Stop every process this run started. MPLoader's pool is shut down
    by its owner, but multiprocessing keeps its forkserver and resource
    tracker alive until the interpreter exits: stop both and wait for them
    (each in a thread, so a stuck one cannot hang the run), then kill and
    reap whatever is still below this process. Returns those, described."""
    import signal
    import threading
    from multiprocessing import forkserver, resource_tracker
    for server in (forkserver._forkserver, resource_tracker._resource_tracker):
        stopper = threading.Thread(target=server._stop, daemon=True)
        stopper.start()
        stopper.join(30)
    left = descendants(os.getpid())
    seen = [describe_process(pid) for pid in left]
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in left:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:   # a grandchild: its own parent reaps it
            pass
    return seen


def describe_process(pid: int) -> str:
    """'pid (parent, state): command line', from /proc."""
    try:
        with open(f'/proc/{pid}/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open(f'/proc/{pid}/cmdline', 'rb') as f:
            cmd = f.read().replace(b'\0', b' ').decode(errors='replace')
    except OSError:
        return f'{pid} (gone)'
    return f'{pid} (parent {fields[1]}, {fields[0]}): {cmd.strip()[:160]}'


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port runs on the card',
              file=sys.stderr)
        return 1
    try:
        kernels, card = run_phases(torch)
    finally:
        killed = stop_children()
        log(f'[teardown] forkserver and resource tracker stopped; other '
            f'processes killed: {killed}')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def run_phases(torch):
    """Every phase; returns (the kernels line's entries, the card line)."""
    from lc_tpu_torch import cuda_build, resolve_device
    device = resolve_device('cuda')
    card = card_line()
    log(f'[setup] python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda} card {card}; os.cpu_count() '
        f'{os.cpu_count()}, usable CPUs {len(os.sched_getaffinity(0))}')
    guard_generic_hypotheses()
    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f'[setup] kernels built in {time.perf_counter() - t0:.1f} s')
    for name, text in cuda_build.build_logs.items():
        log(f'[setup] nvcc {name}:\n{text.strip()}')

    t0 = time.perf_counter()
    lm = phase_lm(device)
    log(f'[phase] kernels vs plain: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    # the LM kernel's own inputs, as each path produces them: its oracle's
    # solve and its main path's (random weights) last batch, over
    # LM_SWEEP_SEEDS RANSAC draws each
    lm_inputs = {}
    for tag, path, limit in (('glmo', GLMO, 0.01), ('zebra', ZLMO, 0.1),
                             ('sparse', GSPLMO, 0.1)):
        lm_inputs.update(phase_path_oracle(tag, path, device, limit)[1])
    log(f'[phase] oracles: {time.perf_counter() - t0:.1f} s')
    paths = {}
    for tag, fn in (('main', phase_main), ('zebra', phase_zebra),
                    ('sparse', phase_sparse)):
        t0 = time.perf_counter()
        paths[tag], inputs = fn(device)
        lm_inputs.update(inputs)
        log(f'[phase] {tag} path: {time.perf_counter() - t0:.1f} s')
        log(f'[{tag}] {paths[tag]["crops_per_s"]:.1f} crops/s on {card}')
    int8 = {}
    for tag, path, seed in (('glmo', GLMO, 14), ('zlmo', ZLMO, 15)):
        t0 = time.perf_counter()
        int8[tag] = phase_int8(tag, path, device, seed)
        log(f'[phase] int8 {tag}: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    held = phase_lm_main_inputs(lm_inputs)
    log(f'[phase] LM kernel on the paths\' own inputs: '
        f'{time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    m6 = phase_minimal6(device)
    log(f'[phase] minimal6 kernel vs plain: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    shear = phase_shear(device)
    log(f'[phase] shear kernel vs plain: {time.perf_counter() - t0:.1f} s')
    trains = {}
    for tag, *_ in TRAIN_PATHS:
        t0 = time.perf_counter()
        trains[tag] = phase_train(device, tag)
        log(f'[phase] {tag} training path: {time.perf_counter() - t0:.1f} s')
        log(f'[train_{tag}] {trains[tag]["crops_per_s"]:.1f} train crops/s '
            f'on {card}')
    t0 = time.perf_counter()
    cli = phase_cli(device)
    log(f'[phase] train and test CLIs: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    phase_cli_families(device)
    log(f'[phase] test CLI on the zebra and sparse families: '
        f'{time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    cli_train = phase_cli_train_families(device)
    log(f'[phase] train CLI on the zebra and sparse families: '
        f'{time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    learned = phase_learned_driver(device)
    log(f'[phase] perf_scripts/learned_syn.py, {LEARNED_ARM} cut to '
        f'{LEARNED_OPTS[0]}: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    bench = phase_bench(device)
    log(f'[phase] bench_torch.py: {time.perf_counter() - t0:.1f} s')

    a = lm['a_final_refine']
    dp = cli['data_parallel']

    def ransac_launches(kernel: str) -> dict:
        """The launches of a RANSAC kernel (lm_refine, minimal6) on every
        path that runs ransac_pnp: the inference paths, int8, the
        evaluations of the train CLIs, the test CLIs, the data-parallel
        CLIs (one NCCL rank, and each of two gloo ranks), and
        bench_torch.py's inference modes and stage budget."""
        out = {tag: rep['launches'][kernel] for tag, rep in paths.items()}
        out.update({f'int8_{tag}_{mode}':
                    rep[f'run_test_{mode}']['launches'][kernel]
                    for tag, rep in int8.items()
                    for mode in ('dynamic', 'static')})
        out['train_cli_glmo'] = cli['launches'][kernel]
        out['train_cli_glmo_mploader'] = \
            cli['mploader_train_cli']['launches'][kernel]
        out.update({f'test_cli_glmo_{fmt}':
                    cli['lc_tpu_ckpt'][f'{fmt}_launches'][kernel]
                    for fmt in ('ckpt', 'pth')})
        out.update({f'train_cli_{k}': v['launches'][kernel]
                    for k, v in cli_train.items()})
        out['train_cli_glmo_no_prefetch'] = \
            dp['no_prefetch']['launches'][kernel]
        out['train_cli_glmo_nccl1'] = dp['nccl1']['launches'][kernel]
        out['test_cli_glmo_nccl1'] = dp['nccl1']['test_launches'][kernel]
        for rank, counts in dp['gloo2']['launches'].items():
            out[f'train_cli_glmo_gloo2_{rank}'] = counts['train'][kernel]
            out[f'test_cli_glmo_gloo2_{rank}'] = counts['test'][kernel]
        out.update({f'learned_syn_{line["eval"]}':
                    line['launches']['eval'][kernel]
                    for line in learned['lines'] if line['device'] == 'cuda'})
        out.update({f'bench_{mode}': bench[mode]['launches'][kernel]
                    for mode in BENCH_MODES
                    if bench[mode]['launches'][kernel]})
        return out

    # B1: 3 a batch (2 LO polishes, the final refine)
    launches = ransac_launches('lm_refine')
    # minimal6: once a ransac_pnp call
    m6_launches = ransac_launches('minimal6')
    for tag, n in m6_launches.items():
        if not tag.startswith('bench_'):   # phase_bench holds its own
            check(n > 0 and 3 * n == launches[tag],
                  f'{tag}: minimal6 launched {n} times beside '
                  f'{launches[tag]} LM launches')
    kernels = [dict(
        name='lm_refine', route='cuda', source='lc_tpu_torch/csrc/lm_refine.cu',
        replaces='lc_tpu/pnp/pallas_lm.py:32',
        launches=sum(launches.values()), launches_by_path=launches,
        max_abs_err=max(c['max_abs_err'] for c in (*lm.values(),
                                                    *held.values())
                        if isinstance(c, dict) and 'max_abs_err' in c),
        ms=a['ms'], plain_ms=a['plain_ms'], bound_ms=a['bound_ms'],
        bound_by=a['bound_by'], library_ms=None,
        tolerance=TOL, cases=lm, paths_own_inputs=held_summary(held))]
    x = shear['C3_x']
    # B2: the three training paths (device_rotate), and the glmo train CLI
    shear_launches = {f'train_{tag}': rep['launches']['shear_x']
                      for tag, rep in trains.items()}
    shear_launches['train_cli_glmo'] = cli['launches']['shear_x']
    shear_launches['train_cli_glmo_mploader'] = \
        cli['mploader_train_cli']['launches']['shear_x']
    shear_launches['train_cli_glmo_no_prefetch'] = \
        dp['no_prefetch']['launches']['shear_x']
    shear_launches['train_cli_glmo_nccl1'] = dp['nccl1']['launches']['shear_x']
    for rank, counts in dp['gloo2']['launches'].items():
        shear_launches[f'train_cli_glmo_gloo2_{rank}'] = \
            counts['train']['shear_x']
        shear_launches[f'train_cli_glmo_gloo2_resumed_{rank}'] = \
            counts['resumed']['shear_x']
    kernels.append(dict(
        name='shear_x', route='cuda', source='lc_tpu_torch/csrc/shear_x.cu',
        replaces='lc_tpu/ops/pallas_warp.py:53',
        launches=sum(shear_launches.values()),
        launches_by_path=shear_launches,
        max_abs_err=max(c['max_abs_err'] for k, c in shear.items()
                        if k != 'rotated_crop'),
        ms=x['ms'], plain_ms=x['plain_ms'], bound_ms=x['bound_ms'],
        bound_by=x['bound_by'], library_ms=x['library_ms'],
        tolerance=dict(atol=SHEAR_ATOL), cases=shear))
    m = m6['a_noise_free']
    kernels.append(dict(
        name='minimal6', route='cuda', source='lc_tpu_torch/csrc/minimal6.cu',
        replaces='lc_tpu/pnp/fast_minimal.py:213',
        launches=sum(m6_launches.values()), launches_by_path=m6_launches,
        max_abs_err=max(c[e]['max_abs_err'] for c in m6.values()
                        if isinstance(c, dict) and 'estimators' in c
                        for e in c['estimators']),
        ms=m['ms'], device_ms=m['device_ms'], plain_ms=m['plain_ms'],
        bound_ms=m['bound_ms'], bound_by=m['bound_by'], library_ms=None,
        tolerance=MINIMAL6_TOL, cases=m6))
    log('[summary] minimal6 (RANSAC hypotheses, one launch a ransac_pnp '
        f'call) on {card}: lanes a problem {json.dumps(m6["lanes"])}, ptxas '
        f'{json.dumps(m6["ptxas"])}')
    for name, c in m6.items():
        if isinstance(c, dict) and 'estimators' in c:
            log(f'[summary] minimal6 {name} (B={c["B"]}, K={c["K"]}): ms '
                f'{c["ms"]:.4f}, device ms {c["device_ms"]}, plain ms '
                f'{c["plain_ms"]:.2f}, bound ms {c["bound_ms"]:.5f} '
                f'({c["bound_by"]}); ' + '; '.join(
                    f'{e} ok {c[e]["ok_kernel"]:.3f}, ok agree '
                    f'{c[e]["ok_agree"]:.4f}, bit-equal {c[e]["bit_equal"]:.4f}'
                    f', max abs err {c[e]["max_abs_err"]:.3g}'
                    for e in c['estimators']))
    log(f'[summary] launches by path, LM (B1) {json.dumps(launches)}; '
        f'minimal6 {json.dumps(m6_launches)}; shear (B2) '
        f'{json.dumps(shear_launches)}')
    return kernels, card


if __name__ == '__main__':
    sys.exit(main())
