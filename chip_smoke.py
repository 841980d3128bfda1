#!/usr/bin/env python3
"""Run the PyTorch port (lc_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. versions, the card's name and power limit; build every CUDA kernel from
     lc_tpu_torch/csrc with nvcc (one process per source, all at once);
  2. each kernel against its plain PyTorch version on the card, at the shapes
     the main path gives it, with the stated tolerance, and both timed with
     CUDA events;
  3. the oracle path: frames rendered in memory, the exact NOC map fed to
     inference.solve_pnp_dense as network output; poses must recover and
     the LM kernel must run exactly 3 times (2 LO-RANSAC polishes + 1 final
     refine);
  4. the main path: harness.run_test with CDPN-ResNet34 at the widths of
     configs/glmo.yaml (256² in, 64² out, batch 32), seeded weights carried
     in through state_dict_from_flax, in-memory batches and evaluator;
     kernel launch counts are zeroed just before and read just after;
  5. one JSON line of kernel numbers, the card line, and the final
     {"ok": true, "device": ...} line.
Imports torch, numpy, scipy, the standard library and the port only. Exits
non-zero without a CUDA device, or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# glmo (configs/glmo.yaml): widths, batch, point selection, solvers
GLMO = dict(net_input_wh=(256, 256), net_output_wh=(64, 64), batch_size=32,
            quantile=0.3, dense_sample=2)
N_BATCHES = 3
# kernel-vs-plain tolerance (that of tests/test_pallas_lm.py)
TOL = dict(translation_atol=0.05, quat_dot_min=1 - 1e-5, cost_rtol=1e-3)


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


def kernel_device_ms(fn, kernel_name: str, reps: int = 10) -> float:
    """Mean device time of one kernel per call of fn, from torch.profiler:
    the kernel alone, without the wrapper's host work and small torch ops
    that `time_ms` includes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if kernel_name in e.key)
    return total / reps / 1e3


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


def lm_agreement(out, ref) -> dict:
    import torch
    qd = (out.pose7[:, :4] * ref.pose7[:, :4]).sum(-1)
    aligned = out.pose7.clone()
    aligned[:, :4] *= torch.where(qd < 0, -1.0, 1.0)[:, None]   # q ~ -q
    rel = (out.cost - ref.cost).abs() / ref.cost.abs().clamp(min=1e-12)
    return dict(
        max_translation_err=float((out.pose7[:, 4:] - ref.pose7[:, 4:]).abs().max()),
        min_quat_dot=float(qd.abs().min()),
        max_cost_rel_err=float(rel.max()),
        invalid_equal=bool((out.invalid == ref.invalid).all()),
        max_abs_err=float((aligned - ref.pose7).abs().max()),
        n_iter_kernel=int(out.n_iter.sum()), n_iter_plain=int(ref.n_iter.sum()))


def lm_bound_ms(args, out) -> tuple[float, str]:
    """Least time for this call: inputs read once, outputs written once, over
    HBM bandwidth; against the flops these inputs need (valid points times
    the iterations each problem ran) over the f32 peak. The larger wins."""
    from lc_tpu_torch.pnp.lm_kernel import (FLOPS_PER_POINT_INIT,
                                            FLOPS_PER_POINT_ITER)
    nbytes = sum(a.numel() * a.element_size() for a in args)
    nbytes += sum(a.numel() * a.element_size() for a in
                  (out.pose7, out.invalid, out.cost, out.n_iter, out.radius))
    n_valid = args[5].sum(-1).double().cpu()
    n_iter = out.n_iter.double().cpu()
    flops = float((n_valid * (FLOPS_PER_POINT_INIT
                              + FLOPS_PER_POINT_ITER * n_iter)).sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_lm(device) -> dict:
    import torch
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    from lc_tpu_torch.pnp.solver import lm_refine
    w, h = GLMO['net_output_wh']
    s = GLMO['dense_sample']
    B, N = GLMO['batch_size'], (w // s) * (h // s)
    cases = {
        'a_final_refine': (dict(B=B, N=N, seed=0, valid_frac=0.7, per_coord=True),
                           dict(max_iter=50, fallback_to_init=True)),
        'b_polish': (dict(B=B, N=N, seed=1, valid_frac=0.7, per_coord=False),
                     dict(max_iter=10, fallback_to_init=False)),
        'c_edges_N1000': (dict(B=B, N=1000, seed=2, valid_frac=0.7,
                               per_coord=True),
                          dict(max_iter=50, fallback_to_init=True)),
    }
    report = {}
    for name, (pk, kw) in cases.items():
        args = lm_problem(device=device, **pk)
        if name == 'b_polish':
            args[4] = torch.ones_like(args[4])            # unit weights
        if name == 'c_edges_N1000':
            args[5][0, 2:] = False                        # < 3 valid points
        out = lm_refine_cuda(*args, **kw)
        torch.cuda.synchronize()
        ref = lm_refine(*args, **kw)
        agr = lm_agreement(out, ref)
        if name == 'c_edges_N1000':
            check(bool(out.invalid[0]), 'row with < 3 valid points not invalid')
            check(torch.equal(out.pose7[0], args[0][0]),
                  'row with < 3 valid points did not keep its init')
        check(agr['max_translation_err'] <= TOL['translation_atol']
              and agr['min_quat_dot'] >= TOL['quat_dot_min']
              and agr['max_cost_rel_err'] <= TOL['cost_rtol']
              and agr['invalid_equal'], f'LM kernel vs plain, case {name}: {agr}')
        agr['ms'] = time_ms(lambda: lm_refine_cuda(*args, **kw), reps=20)
        agr['device_ms'] = kernel_device_ms(
            lambda: lm_refine_cuda(*args, **kw), 'lm_refine_kernel')
        agr['plain_ms'] = time_ms(lambda: lm_refine(*args, **kw), reps=3, warmup=1)
        agr['bound_ms'], agr['bound_by'] = lm_bound_ms(args, out)
        agr['shape'] = dict(B=pk['B'], N=pk['N'], **kw)
        report[name] = agr
        log(f'[lm] {name}: {json.dumps(agr)}')
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
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
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

    lm_refine_cuda.launches = 0
    t0 = time.perf_counter()
    res = harness.run_test(cfg, model, batches, dataset, ev, device=device)
    wall = time.perf_counter() - t0
    launches = lm_refine_cuda.launches

    errors = res['weighted']['errors']
    check(len(errors) == bs * N_BATCHES, 'not every crop got a pose')
    check(all(np.all(np.isfinite(e['R_est'])) and np.all(np.isfinite(e['t_est']))
              for e in errors), 'non-finite poses')
    check(launches == 3 * N_BATCHES,
          f'LM kernel launched {launches} times for {N_BATCHES} batches')
    per_crop_s = errors[0]['time']     # steady state: batches after the first
    rep = dict(batches=N_BATCHES, batch_size=bs, lm_launches=launches,
               crops_per_s=1.0 / per_crop_s, wall_s=wall,
               add_s_0_10=res['weighted']['avg_score'])
    log(f'[main] {json.dumps(rep)}')
    rep['stages'] = stage_breakdown(model, batches[-1], device)
    log(f'[main] stages of one batch: {json.dumps(rep["stages"])}')
    return rep


def stage_breakdown(model, batch, device) -> dict:
    """One more batch of the main path, stage by stage (the calls
    harness.run_test and inference.solve_pnp_dense make): host clock around
    each stage with the device synchronized, in ms. Then the same batch under
    torch.profiler: device-busy time (sum of kernel times; one stream, so
    kernels do not overlap), kernel count, and the busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lc_tpu_torch.data.pipeline import device_preprocess
    from lc_tpu_torch.inference import dense_grid_outputs, quantile_mask_bisect
    from lc_tpu_torch.pnp.ransac import ransac_pnp
    from lc_tpu_torch.pnp.solver import lm_refine_auto
    gen = torch.Generator(device=device)

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
        rr = timed('ransac_full', lambda: ransac_pnp(*args, valid=valid))
        timed('lm_final', lambda: lm_refine_auto(
            rr.pose7, gt['out_K'], d['pts3d'], d['pts2d'], d['inv_std2d'] ** 2,
            valid=valid))

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
    return stages


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port runs on the card',
              file=sys.stderr)
        return 1
    from lc_tpu_torch import cuda_build, resolve_device
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
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
    main_rep = phase_main(device)
    log(f'[phase] main path: {time.perf_counter() - t0:.1f} s')
    log(f'[main] {main_rep["crops_per_s"]:.1f} crops/s on {card}')

    a = lm['a_final_refine']
    kernels = [dict(
        name='lm_refine', route='cuda', source='lc_tpu_torch/csrc/lm_refine.cu',
        replaces='lc_tpu/pnp/pallas_lm.py:32',
        launches=main_rep['lm_launches'],
        max_abs_err=max(c['max_abs_err'] for c in lm.values()),
        ms=a['ms'], plain_ms=a['plain_ms'], bound_ms=a['bound_ms'],
        bound_by=a['bound_by'], library_ms=None,
        tolerance=TOL, cases=lm)]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
