#!/usr/bin/env python3
"""Run the PyTorch port (lc_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. versions, the card's name and power limit; build every CUDA kernel from
     lc_tpu_torch/csrc with nvcc (one process per source, all at once);
  2. each kernel against its plain PyTorch version on the card, at the shapes
     the main path gives it, with the stated tolerance, and both timed with
     CUDA events; for the LM kernel (B1) also the weight and mask forms,
     ragged rows, running out of iterations with either fallback, and one
     device operation per call;
  3. the oracle path: frames rendered in memory, the exact NOC map fed to
     inference.solve_pnp_dense as network output; poses must recover and
     the LM kernel must run exactly 3 times (2 LO-RANSAC polishes + 1 final
     refine);
  4. the main path: harness.run_test with CDPN-ResNet34 at the widths of
     configs/glmo.yaml (256² in, 64² out, batch 32), seeded weights carried
     in through state_dict_from_flax, in-memory batches and evaluator;
     kernel launch counts are zeroed just before and read just after; then
     the LM kernel against its plain version on that path's own inputs (one
     batch's final refine and first LO polish; a problem more than the
     tolerance away is held to the plain version on its points reordered);
  5. the shear kernel (B2) against its plain version at the glmo rotated
     crop's shapes, timed beside grid_sample over buffers the L2 cannot
     hold, the column pass on random per-column shifts and sizes off its
     tile, and the composed rotated crop with the kernel against the same
     composition with the plain shear;
  6. the training path: configs/glmo.yaml with dataloader.device_rotate on
     and background switching, CDPN-ResNet34 at glmo's widths and batch,
     six steps of device_preprocess + train_step on in-memory blobs (the
     first untimed), with the counts zeroed before and read after; then a
     stage breakdown of one more step and its device-busy share;
  7. the train CLI on the card: `python -m lc_tpu_torch.train`'s main on a
     generated BOP tree (glmo widths and batch, device_rotate, background
     images, the host loader in threads), six steps with an evaluation
     through harness.run_test after step 3, counts zeroed before and read
     after; then `python -m lc_tpu_torch.test` on its model_final;
  8. one JSON line of kernel numbers, the card line, and the final
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
# its L2 (data sheet): a kernel timed against the HBM bound cycles through
# copies of its inputs that this cannot hold
L2_BYTES = 50 * 2 ** 20

# glmo (configs/glmo.yaml): widths, batch, point selection, solvers
GLMO = dict(net_input_wh=(256, 256), net_output_wh=(64, 64), batch_size=32,
            quantile=0.3, dense_sample=2)
N_BATCHES = 3
# kernel-vs-plain tolerance (that of tests/test_pallas_lm.py)
TOL = dict(translation_atol=0.05, quat_dot_min=1 - 1e-5, cost_rtol=1e-3)
# the shear kernel against its plain version: atol on 0-255 values (that of
# tests/test_pallas_warp.py)
SHEAR_ATOL = 5e-4
TRAIN_STEPS = 6
# the profiler ranges of one training step (train.step_inputs, train_step)
TRAIN_STAGES = ('h2d', 'preprocess', 'forward', 'targets_losses', 'backward',
                'optimizer')
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


def lm_agreement(out, ref, keep=None) -> dict:
    """The kernel's result `out` against the plain version's `ref`; the
    translation and max_abs_err over the problems in `keep` (all if None)."""
    import torch
    # the cosine of the two rotations' quaternions: the main path's poses
    # (RANSAC's, refined) are not of unit norm
    qa, qb = out.pose7[:, :4], ref.pose7[:, :4]
    qd = (qa * qb).sum(-1) / (qa.norm(dim=-1) * qb.norm(dim=-1)).clamp(
        min=1e-30)
    aligned = out.pose7.clone()
    aligned[:, :4] *= torch.where(qd < 0, -1.0, 1.0)[:, None]   # q ~ -q
    rel = (out.cost - ref.cost).abs() / ref.cost.abs().clamp(min=1e-12)
    if keep is None:
        keep = torch.ones_like(out.invalid)
    return dict(
        max_translation_err=float(
            (out.pose7[keep, 4:] - ref.pose7[keep, 4:]).abs().max()),
        min_quat_dot=float(qd.abs().min()),
        max_cost_rel_err=float(rel.max()),
        invalid_equal=bool((out.invalid == ref.invalid).all()),
        max_abs_err=float((aligned[keep] - ref.pose7[keep]).abs().max()),
        n_iter_kernel=int(out.n_iter.sum()), n_iter_plain=int(ref.n_iter.sum()))


def translation_err(a, b):
    return (a.pose7[:, 4:] - b.pose7[:, 4:]).abs().amax(-1)


def order_sensitive(args, kw, out, ref, orders: int = 8) -> dict:
    """The problems on which the kernel's translation is more than TOL from
    the plain version's, each with the plain version run again with its
    points in `orders` other orders (seeded permutations): the same problem,
    only the order of the float32 sums differs. Returns {problem: (error
    against the plain version as given, the least error against a
    reordered one)}."""
    import torch
    from lc_tpu_torch.pnp.solver import lm_refine
    far = translation_err(out, ref) > TOL['translation_atol']
    if not bool(far.any()):
        return {}
    gen = torch.Generator().manual_seed(0)
    nearest = torch.full_like(out.cost, float('inf'))
    for _ in range(orders):
        p = torch.randperm(args[2].shape[1], generator=gen).to(args[2].device)
        moved = [a[:, p].contiguous() if a is not None else None
                 for a in args[2:]]
        nearest = torch.minimum(nearest, translation_err(
            out, lm_refine(*args[:2], *moved, **kw)))
    err = translation_err(out, ref)
    return {int(b): (float(err[b]), float(nearest[b]))
            for b in far.nonzero()[:, 0]}


def lm_bound_ms(args, out) -> tuple[float, str]:
    """Least time for this call: inputs read once, outputs written once, over
    HBM bandwidth; against the flops these inputs need (valid points times
    the iterations each problem ran) over the f32 peak. The larger wins."""
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
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def device_ops_per_call(fn, reps: int = 10) -> float:
    """Device operations (kernels, copies, memsets) per call of fn, from
    torch.profiler: the most of three windows, as a window may drop
    events but records none that did not run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return max(counts) / reps


def lm_case(args, kw, reorder_witness: bool = False):
    """lm_refine_cuda against lm_refine on the same inputs, within TOL; the
    kernel timed per wrapper call (CUDA events) and alone (profiler).

    reorder_witness (the main path's own inputs, from a network with random
    weights, where some problems' minima are shallow): a problem whose
    translation is more than TOL from the plain version's agrees if it is
    within TOL of the plain version's on the same points in another order
    (order_sensitive). Such problems are listed under their own key and
    left out of max_translation_err and max_abs_err. Returns the report and
    the kernel's result."""
    import torch
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    from lc_tpu_torch.pnp.solver import lm_refine
    out = lm_refine_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = lm_refine(*args, **kw)
    sensitive = order_sensitive(args, kw, out, ref) if reorder_witness else {}
    keep = torch.ones_like(out.invalid)
    keep[list(sensitive)] = False
    agr = lm_agreement(out, ref, keep)
    if reorder_witness:
        agr['order_sensitive'] = [
            dict(problem=b, translation_err=e, nearest_reordered_plain=r)
            for b, (e, r) in sensitive.items()]
    check(agr['max_translation_err'] <= TOL['translation_atol']
          and all(r <= TOL['translation_atol']
                  for _, r in sensitive.values())
          and agr['min_quat_dot'] >= TOL['quat_dot_min']
          and agr['max_cost_rel_err'] <= TOL['cost_rtol']
          and agr['invalid_equal'], f'LM kernel vs plain: {agr}')
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
    agr['ms'] = median_call_ms(lambda: lm_refine_cuda(*args, **kw))
    agr['device_ms'] = kernel_device_ms(
        lambda: lm_refine_cuda(*args, **kw), 'lm_refine_kernel', reps=20)
    agr['plain_ms'] = time_ms(lambda: lm_refine(*args, **kw), reps=3, warmup=1)
    agr['bound_ms'], agr['bound_by'] = lm_bound_ms(args, out)
    return agr, out


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
    }
    report = {}
    for name, (pk, kw) in cases.items():
        args = lm_problem(device=device, **pk)
        if name == 'b_polish':
            args[4] = torch.ones_like(args[4])            # unit weights
        if name == 'c_edges_N1000':
            args[5][0, 2:] = False                        # < 3 valid points
        if name.startswith('d_'):
            args[5] = None
        agr, out = lm_case(args, kw)
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
    # path's dispatch
    for fn in (lm_kernel.lm_refine_cuda, lm_refine_auto):
        ops = device_ops_per_call(lambda: fn(*a_args, **final))
        report[f'device_ops_per_{fn.__name__}_call'] = ops
        log(f'[lm] device operations per {fn.__name__} call: {ops}')
        check(ops == 1, f'{fn.__name__} ran {ops} device operations per call')

    return report


def phase_lm_main_inputs(captured) -> dict:
    """The LM kernel on the main path's own inputs, kept from one profiled
    batch of phase 4: the final weighted refine and the first LO polish."""
    report = {}
    for name, (args, kw) in captured.items():
        kw = dict(kw)
        args = list(args) + [kw.pop('valid', None)]
        report[name] = lm_case(args, kw, reorder_witness=True)[0]
        log(f'[lm] {name}: {json.dumps(report[name])}')
    return report


# --------------------------------------------------------------------------
# phases 3-4: the oracle path and the main path
# --------------------------------------------------------------------------

def phase_oracle(device) -> dict:
    import torch
    from lc_tpu_torch import inference
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate, device_preprocess
    from lc_tpu_torch.eval.evaluator import Evaluator
    from lc_tpu_torch.geom.pose import pose7_to_RT
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    in_wh, out_wh = GLMO['net_input_wh'], GLMO['net_output_wh']
    es = synthetic.render_eval_set(4, seed=7, net_input_wh=in_wh,
                                   net_output_wh=out_wh)
    batch = collate(es['blobs'])
    gt = device_preprocess({k: torch.as_tensor(v).to(device)
                            for k, v in batch.items()},
                           net_input_wh=in_wh)
    h, w = out_wh[1], out_wh[0]
    noc = np.stack([synthetic.oracle_noc(batch['out_K'][i].astype(np.float64),
                                         R, t, es['half_extents'], (h, w))
                    for i, (R, t) in enumerate(es['poses'])])
    B = len(noc)
    out = {'xyz_noc': torch.tensor(noc),
           'xyz_weight_logits': torch.zeros(B, h, w, 2),       # constant
           'xyz_weights_scale': torch.full((B, 1, 1, 1), float(h * w)),
           'msk_vis_logits': torch.full((B, h, w, 1), 8.0)}
    before = lm_refine_cuda.launches
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    pose = inference.solve_pnp_dense(out, gt, gen, quantile=GLMO['quantile'],
                                     device=device)['weighted']
    launches = lm_refine_cuda.launches - before
    R, t = pose7_to_RT(pose)
    ev = Evaluator(es['gts'], es['models'], es['models_info'], device=device)
    _, errors = ev.evaluate([dict(scene_id=1, im_id=i, obj_id=1,
                                  R_est=R[i].cpu().numpy(),
                                  t_est=t[i].cpu().numpy()) for i in range(B)])
    diameter = es['models_info'][1]['diameter']
    rep = dict(lm_launches=launches, max_add_mm=max(e['add'] for e in errors),
               diameter_mm=diameter)
    log(f'[oracle] {json.dumps(rep)}')
    check(launches == 3, f'oracle solve launched the LM kernel {launches} times')
    check(rep['max_add_mm'] < 0.01 * diameter, f'oracle poses off: {rep}')
    return rep


def phase_main(device) -> dict:
    import torch
    from lc_tpu_torch import harness
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate
    from lc_tpu_torch.eval.evaluator import Evaluator
    from lc_tpu_torch.models import build_model
    from lc_tpu_torch.models.weights import (random_flax_variables,
                                             state_dict_from_flax)
    from lc_tpu_torch.utils.config import Config
    bs = GLMO['batch_size']
    t0 = time.perf_counter()
    es = synthetic.render_eval_set(bs * N_BATCHES, seed=11,
                                   net_input_wh=GLMO['net_input_wh'],
                                   net_output_wh=GLMO['net_output_wh'])
    batches = [collate(es['blobs'][i * bs:(i + 1) * bs])
               for i in range(N_BATCHES)]
    log(f'[main] rendered {bs * N_BATCHES} frames in '
        f'{time.perf_counter() - t0:.1f} s')
    cfg = Config(dict(pnp_solver=dict(
        dense_point_select='quantile', quantile=GLMO['quantile'],
        solvers=['weighted'])))
    model = build_model('cdpn_resnet', {'concat': False})
    model.load_state_dict(state_dict_from_flax(random_flax_variables(seed=0)))
    dataset = type('EvalSet', (), dict(net_input_wh=GLMO['net_input_wh'],
                                       bit_cnt=None))
    ev = Evaluator(es['gts'], es['models'], es['models_info'], device=device)

    zero_kernel_counts()
    t0 = time.perf_counter()
    res = harness.run_test(cfg, model, batches, dataset, ev, device=device)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    launches = counts['lm_refine']

    errors = res['weighted']['errors']
    check(len(errors) == bs * N_BATCHES, 'not every crop got a pose')
    check(all(np.all(np.isfinite(e['R_est'])) and np.all(np.isfinite(e['t_est']))
              for e in errors), 'non-finite poses')
    check(launches == 3 * N_BATCHES,
          f'LM kernel launched {launches} times for {N_BATCHES} batches')
    per_crop_s = errors[0]['time']     # steady state: batches after the first
    rep = dict(batches=N_BATCHES, batch_size=bs, lm_launches=launches,
               launches=counts,
               crops_per_s=1.0 / per_crop_s, wall_s=wall,
               add_s_0_10=res['weighted']['avg_score'])
    log(f'[main] {json.dumps(rep)}')
    rep['stages'], lm_inputs = stage_breakdown(model, batches[-1], device)
    log(f'[main] stages of one batch: {json.dumps(rep["stages"])}')
    return rep, lm_inputs


def stage_breakdown(model, batch, device) -> tuple[dict, dict]:
    """One more batch of the main path, stage by stage (the calls
    harness.run_test and inference.solve_pnp_dense make): host clock around
    each stage with the device synchronized, in ms. Then the same batch under
    torch.profiler: device-busy time (sum of kernel times; one stream, so
    kernels do not overlap), kernel count, and the busy share of the wall.
    Also returns the main path's own LM inputs: the arguments of the batch's
    final refine and of its first LO polish."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lc_tpu_torch.data.pipeline import device_preprocess
    from lc_tpu_torch.inference import dense_grid_outputs, quantile_mask_bisect
    from lc_tpu_torch.pnp import solver
    from lc_tpu_torch.pnp.ransac import ransac_pnp
    from lc_tpu_torch.pnp.solver import lm_refine_auto
    gen = torch.Generator(device=device)
    lm_inputs = {}

    def first_polish(*a, **kw):
        # ransac_pnp's LO polish, which calls solver.lm_refine_auto
        lm_inputs.setdefault('main_lo_polish', (a, kw))
        return lm_refine_auto(*a, **kw)

    def one_batch(timed):
        dev = timed('h2d', lambda: {k: torch.as_tensor(v).to(device)
                                    for k, v in batch.items()})
        gt = timed('preprocess', lambda: device_preprocess(
            dev, net_input_wh=GLMO['net_input_wh']))
        with torch.no_grad():
            out = timed('cnn', lambda: model(gt['img_in']))
        d = timed('decode_select', lambda: dense_grid_outputs(out, gt))
        valid = timed('decode_select', lambda: quantile_mask_bisect(
            d['inv_std2d'], GLMO['quantile']))
        args = (gt['out_K'], d['pts3d'], d['pts2d'], gen)
        timed('ransac_hypotheses', lambda: ransac_pnp(*args, valid=valid,
                                                      local_opt=False))
        solver.lm_refine_auto = first_polish
        try:
            rr = timed('ransac_full', lambda: ransac_pnp(*args, valid=valid))
        finally:
            solver.lm_refine_auto = lm_refine_auto
        final = lm_inputs['main_final_refine'] = (
            (rr.pose7, gt['out_K'], d['pts3d'], d['pts2d'],
             d['inv_std2d'] ** 2), dict(valid=valid))
        timed('lm_final', lambda: lm_refine_auto(*final[0], **final[1]))

    stages: dict[str, float] = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t) * 1e3
        return r

    one_batch(timed)
    stages['ransac_local_opt'] = stages['ransac_full'] - stages['ransac_hypotheses']

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
    return stages, lm_inputs


def kernel_counts() -> dict:
    from lc_tpu_torch.ops.warp import shear_x_cuda
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    return {'lm_refine': lm_refine_cuda.launches,
            'shear_x': shear_x_cuda.launches}


def zero_kernel_counts():
    from lc_tpu_torch.ops.warp import shear_x_cuda
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    lm_refine_cuda.launches = 0
    shear_x_cuda.launches = 0


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

def glmo_train_cfg():
    """configs/glmo.yaml with the device-rotated crop and the LC loss at its
    full weight from the first step."""
    from lc_tpu_torch.utils.config import load_config
    here = os.path.dirname(os.path.abspath(__file__))
    return load_config(os.path.join(here, 'configs', 'glmo.yaml'), [
        'dataloader.device_rotate=true', 'loss.pose_loss_start_step=0',
        'loss.pose_loss_start_epoch=0'])


def phase_train(device) -> dict:
    import torch
    from lc_tpu_torch import harness
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate
    from lc_tpu_torch.loss.loss_fn import init_loss_state
    from lc_tpu_torch.models import build_model, set_compute_dtype
    from lc_tpu_torch.models.weights import (random_flax_variables,
                                             state_dict_from_flax)
    from lc_tpu_torch.optim.factory import build_optimizer
    from lc_tpu_torch.train import step_inputs
    from lc_tpu_torch.train_step import train_step
    cfg = glmo_train_cfg()
    ds_cfg = cfg.train_dataset
    bs = cfg.dataloader.batch_size
    check(bs == GLMO['batch_size'], 'glmo batch size')
    t0 = time.perf_counter()
    blobs = synthetic.render_train_set(
        2 * bs, seed=21, net_input_wh=tuple(ds_cfg.net_input_wh),
        net_output_wh=tuple(ds_cfg.net_output_wh),
        dzi_scale_ratio=ds_cfg.dzi_scale_ratio,
        dzi_shift_ratio=ds_cfg.dzi_shift_ratio,
        dzi_pad_scale=ds_cfg.dzi_pad_scale, rotate_prob=ds_cfg.rotate_prob,
        switch_bg_prob=ds_cfg.switch_bg_prob,
        pixel_aug_prob=ds_cfg.pixel_aug_prob)
    batches = [collate(blobs[i * bs:(i + 1) * bs]) for i in range(2)]
    log(f'[train] rendered {2 * bs} training frames in '
        f'{time.perf_counter() - t0:.1f} s')
    check(all(b['switch_bg'].any() for b in batches), 'no background switch')

    model = build_model('cdpn_resnet', {'concat': False})
    model.load_state_dict(state_dict_from_flax(random_flax_variables(seed=0)))
    model = set_compute_dtype(model.to(device), torch.bfloat16)
    initial = {k: v.detach().clone() for k, v in model.named_parameters()}
    steps_per_epoch = 100                      # nominal: schedule length only
    loss_cfg = harness.make_loss_config(cfg, steps_per_epoch)
    check(loss_cfg.full_pose_loss_step == 0, 'LC loss not at full weight')
    optimizer, scheduler = build_optimizer(
        model.parameters(), cfg.optimizer, cfg.scheduler,
        cfg.train.num_epochs * steps_per_epoch)
    loss_state = init_loss_state(device)
    pp = dict(net_input_wh=tuple(ds_cfg.net_input_wh),
              net_output_wh=tuple(ds_cfg.net_output_wh), mask_nearest=False,
              train=True)
    s = loss_cfg.dense_sample
    seed = 42

    def one_step(step, loss_state):
        # the body of train.train's loop, on in-memory batches
        gt, top_left = step_inputs(batches[step % 2], seed, step, device, pp, s)
        return train_step(model, optimizer, scheduler, loss_cfg, loss_state,
                          gt, step, top_left)

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
              f'non-finite training metrics at step {i + 1}: {m}')
    check(set(all_metrics[0]) >= {'loss', 'loss_noc', 'loss_seg', 'loss_pose',
                                  'grad_norm'}, 'missing metrics')
    check(thr_after_1 != -1.0 and thr_after_1 > 0,
          f'weight clipper threshold after step 1: {thr_after_1}')
    changed = sum(not torch.equal(p.detach(), initial[k])
                  for k, p in model.named_parameters())
    max_delta = max(float((p.detach() - initial[k]).abs().max())
                    for k, p in model.named_parameters())
    check(changed > 0, 'no parameter changed')
    check(counts['shear_x'] == 6 * TRAIN_STEPS,
          f'shear kernel launched {counts["shear_x"]} times in '
          f'{TRAIN_STEPS} steps (expected 6 per step)')
    rep = dict(steps=TRAIN_STEPS, batch_size=bs, launches=counts,
               first_step_s=first_s, timed_steps=TRAIN_STEPS - 1,
               timed_wall_s=wall,
               crops_per_s=(TRAIN_STEPS - 1) * bs / wall,
               weight_clip_after_step_1=thr_after_1,
               params_changed=f'{changed}/{len(initial)}',
               max_param_delta=max_delta, metrics=all_metrics)
    log(f'[train] {json.dumps(rep)}')
    rep['stages'] = train_stage_breakdown(
        lambda: one_step(TRAIN_STEPS, loss_state))
    log(f'[train] stages of one step: {json.dumps(rep["stages"])}')
    return rep


def train_stage_breakdown(step_fn) -> dict:
    """One more training step, `step_fn` (the call the timed steps made),
    under torch.profiler, read through the ranges that train.step_inputs and
    train_step open (TRAIN_STAGES). For each stage: host_ms, the time
    between its range's ends, and device_ms, the device time of the kernels
    and copies launched inside it from any thread (autograd launches the
    backward's kernels from its device thread while the caller waits in the
    'backward' range). Then the device-busy time, the kernel count and the
    busy share of the wall, and what no range claims."""
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
    stages.update(
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

def phase_cli(device) -> dict:
    """Both CLIs as a user runs them, on the card (their default device;
    `--device cpu` only when rehearsed on the CPU), in a temporary
    directory that is removed afterwards."""
    import tempfile
    import cv2
    import yaml
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch import train as train_cli
    from lc_tpu_torch.data import synthetic
    bs = GLMO['batch_size']
    with tempfile.TemporaryDirectory() as tmp:
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
        cfg = glmo_train_cfg()
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
        # the host loader alone (threads over PNG decode, cv2 warps, z_crop
        # expansion), three epochs of one batch each
        from lc_tpu_torch import harness
        from lc_tpu_torch.data import native
        _, loader = harness.make_datasets(cfg, train=True, seed=0)
        t0 = time.perf_counter()
        n_loaded = sum(len(b['obj_id']) for _ in range(3) for b in loader)
        loader_rate = n_loaded / (time.perf_counter() - t0)
        log(f'[cli] host loader alone: {loader_rate:.1f} crops/s with '
            f'{cfg.dataloader.num_workers} threads, native z_crop library '
            f'{"used" if native.available() else "absent"}')
        out = os.path.join(tmp, 'out')
        dev_args = [] if device.type == 'cuda' else ['--device', 'cpu']
        zero_kernel_counts()
        t0 = time.perf_counter()
        train_cli.main(['--config', cfg_path, '--output', out] + dev_args)
        wall = time.perf_counter() - t0
        counts = kernel_counts()
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
        best = [f for f in os.listdir(exp) if f.startswith('model_best_3_')]
        check(len(best) == 1, 'no scored checkpoint exported')
        t0 = time.perf_counter()
        res = test_cli.main(['--weight', os.path.join(exp, 'model_final.ckpt'),
                             '--config', cfg_path, '--output',
                             os.path.join(tmp, 'test'), '--obj', '1']
                            + dev_args)
        test_wall = time.perf_counter() - t0
        check(len(res['weighted']['errors']) == 8, 'test CLI: not 8 poses')
    rep = dict(train_wall_s=wall, launches=counts, metrics=lines,
               test_wall_s=test_wall, host_loader_crops_per_s=loader_rate)
    log(f'[cli] {json.dumps(rep)}')
    return rep


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port runs on the card',
              file=sys.stderr)
        return 1
    from lc_tpu_torch import cuda_build, resolve_device
    device = resolve_device('cuda')
    card = card_line()
    log(f'[setup] python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda} card {card}')
    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f'[setup] kernels built in {time.perf_counter() - t0:.1f} s')
    for name, text in cuda_build.build_logs.items():
        log(f'[setup] nvcc {name}:\n{text.strip()}')

    t0 = time.perf_counter()
    lm = phase_lm(device)
    log(f'[phase] kernels vs plain: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    phase_oracle(device)
    log(f'[phase] oracle: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    main_rep, lm_inputs = phase_main(device)
    log(f'[phase] main path: {time.perf_counter() - t0:.1f} s')
    log(f'[main] {main_rep["crops_per_s"]:.1f} crops/s on {card}')
    t0 = time.perf_counter()
    lm.update(phase_lm_main_inputs(lm_inputs))
    log(f'[phase] LM kernel on the main path\'s inputs: '
        f'{time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    shear = phase_shear(device)
    log(f'[phase] shear kernel vs plain: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    train_rep = phase_train(device)
    log(f'[phase] training path: {time.perf_counter() - t0:.1f} s')
    log(f'[train] {train_rep["crops_per_s"]:.1f} train crops/s on {card}')
    t0 = time.perf_counter()
    phase_cli(device)
    log(f'[phase] train and test CLIs: {time.perf_counter() - t0:.1f} s')

    a = lm['a_final_refine']
    kernels = [dict(
        name='lm_refine', route='cuda', source='lc_tpu_torch/csrc/lm_refine.cu',
        replaces='lc_tpu/pnp/pallas_lm.py:32',
        launches=main_rep['lm_launches'],
        max_abs_err=max(c['max_abs_err'] for c in lm.values()
                        if isinstance(c, dict) and 'max_abs_err' in c),
        ms=a['ms'], plain_ms=a['plain_ms'], bound_ms=a['bound_ms'],
        bound_by=a['bound_by'], library_ms=None,
        tolerance=TOL, cases=lm)]
    x = shear['C3_x']
    kernels.append(dict(
        name='shear_x', route='cuda', source='lc_tpu_torch/csrc/shear_x.cu',
        replaces='lc_tpu/ops/pallas_warp.py:53',
        launches=train_rep['launches']['shear_x'],
        max_abs_err=max(c['max_abs_err'] for k, c in shear.items()
                        if k != 'rotated_crop'),
        ms=x['ms'], plain_ms=x['plain_ms'], bound_ms=x['bound_ms'],
        bound_by=x['bound_by'], library_ms=x['library_ms'],
        tolerance=dict(atol=SHEAR_ATOL), cases=shear))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
