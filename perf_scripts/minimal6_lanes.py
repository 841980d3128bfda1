"""The minimal6 kernel (csrc/minimal6.cu) built at several lane widths
(the lanes an EPnP problem, LC_M6_LANES_EPNP), and optionally an earlier
version of the source (`--parent`, the one-thread-a-problem kernel with the
basis passed by value), in one process on the card. Each build is held to
the plain version (fast_minimal.minimal6) on chip_smoke's sets a-c (B = 32,
K = 150; the share of bit-equal poses and equal ok flags per estimator),
then the builds are timed in turns (device time from torch.profiler, the
mean launch of each window; `--rounds` rounds, the order reversed every
other round), on each set and with each estimator alone on set a, with
ptxas's registers, stack frame and spill bytes.

    python perf_scripts/minimal6_lanes.py [--parent OLD_minimal6.cu]
        [--lanes N ...] [--other LABEL=PATH ...]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

# label: lanes an EPnP problem; None = the source's default
VARIANTS = {'default': None, 'E1': 1, 'E2': 2, 'E3': 3, 'E8': 8}
SETS = {'a_noise_free': (0.0, False, 0), 'b_planar': (0.0, True, 10),
        'c_1px': (1.0, False, 20)}


def build(out_dir, variants, parent, others):
    """One nvcc a build, all started together: {label: (library, log)}."""
    from lc_tpu_torch import cuda_build
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(cuda_build.CSRC, 'minimal6.cu')
    jobs = {}
    for label, v in variants.items():
        defs = [] if v is None else [f'-DLC_M6_LANES_EPNP={v}']
        jobs[label] = (src, defs)
    for label, path in others.items():
        jobs[label] = (path, [])
    if parent:
        jobs['parent'] = (parent, [])
    procs = {}
    for i, (label, (path, defs)) in enumerate(jobs.items()):
        lib = os.path.join(out_dir, f'libminimal6_{i}.so')
        procs[label] = lib, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.flags('minimal6'), *defs,
             '-o', lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f'[build] {label} failed:\n{log}', flush=True)
            continue
        out[label] = lib, log
    return out


class Build:
    def __init__(self, label, path, log):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.label, self.log = label, log
        self.lib = ctypes.CDLL(path)
        self.parent = label == 'parent'
        self.lib.lc_minimal6.argtypes = [vp] * 5 + [ci] * 4 + (
            [vp, vp] if self.parent else [vp])
        self.lib.lc_minimal6.restype = ci
        if not self.parent:
            from lc_tpu_torch.pnp import minimal6_kernel as mk
            self.lib.lc_minimal6_set_basis.argtypes = [vp]
            self.lib.lc_minimal6_set_basis.restype = ci
            if self.lib.lc_minimal6_set_basis(mk.basis_arg().ctypes.data):
                raise RuntimeError(f'{label}: writing the basis failed')

    def __call__(self, cam_K, sub3d, sub2d, estimators):
        import torch
        from lc_tpu_torch.pnp import minimal6_kernel as mk
        codes = mk.estimator_codes(estimators)
        B, K = sub3d.shape[:2]
        n = len(codes)
        pose = torch.empty((B, n * K, 7), device=sub3d.device)
        ok = torch.empty((B, n * K), dtype=torch.bool, device=sub3d.device)
        basis = mk.basis_arg()
        args = [cam_K.data_ptr(), sub3d.data_ptr(), sub2d.data_ptr(),
                pose.data_ptr(), ok.data_ptr(), B, K, n,
                sum(c << (2 * i) for i, c in enumerate(codes))]
        if self.parent:
            args.append(basis.ctypes.data)
        err = self.lib.lc_minimal6(*args,
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'{self.label}: launch failed: CUDA error {err}')
        return pose, ok


def agreement(build, sets, plain):
    import torch
    rep = {}
    for name, args in sets.items():
        pose, ok = build(*args)
        torch.cuda.synchronize()
        pr, okr = plain[name]
        Kh = args[1].shape[1]
        rep[name] = {}
        for e, est in enumerate(args[3]):
            sl = slice(e * Kh, (e + 1) * Kh)
            rep[name][est] = dict(
                bit_equal=float((pose[:, sl] == pr[:, sl]).all(-1)
                                .float().mean()),
                ok_equal=float((ok[:, sl] == okr[:, sl]).float().mean()))
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', help='an earlier csrc/minimal6.cu to time')
    ap.add_argument('--other', action='append', default=[],
                    help='LABEL=PATH: another source with this interface')
    ap.add_argument('--lanes', type=int, action='append', default=[],
                    help='lanes an EPnP problem to build instead of VARIANTS '
                         '(besides the default)')
    ap.add_argument('--rounds', type=int, default=4)
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'lc_tpu_torch', 'build', 'minimal6_lanes'),
        help='where the builds go (the package\'s gitignored build directory)')
    a = ap.parse_args()
    import torch
    from lc_tpu_torch import resolve_device
    from lc_tpu_torch.pnp import fast_minimal
    dev = resolve_device('cuda')
    print(cs.card_line(), flush=True)
    variants = VARIANTS
    if a.lanes:
        variants = {'default': None, **{f'E{n}': n for n in a.lanes}}
    built = build(a.out, variants, a.parent,
                  dict(o.split('=', 1) for o in a.other))
    sets = {name: cs.minimal_samples(32, 150, noise, planar, seed, dev)
            for name, (noise, planar, seed) in SETS.items()}
    builds = [Build(label, lib, log) for label, (lib, log) in built.items()]
    plain = {name: fast_minimal.minimal6(*args) for name, args in sets.items()}
    report = {}
    for b in builds:
        report[b.label] = dict(ptxas=cs.ptxas_summary(b.log),
                               agreement=agreement(b, sets, plain),
                               device_ms={n: [] for n in sets})
        print(f'[lanes] {b.label}: ptxas {json.dumps(report[b.label]["ptxas"])}'
              f'; agreement {json.dumps(report[b.label]["agreement"])}',
              flush=True)
    alone = {est: sets['a_noise_free'][:3] + ((est,),)
             for est in fast_minimal.ESTIMATORS}
    for b in builds:
        report[b.label]['alone_ms'] = {est: [] for est in alone}
    for r in range(a.rounds):
        for b in (builds if r % 2 == 0 else builds[::-1]):
            for name, args in sets.items():
                ms = cs.kernel_device_ms(lambda: b(*args), 'minimal6_kernel',
                                         reps=20)
                report[b.label]['device_ms'][name].append(ms)
            for est, args in alone.items():
                ms = cs.kernel_device_ms(lambda: b(*args), 'minimal6_kernel',
                                         reps=20)
                report[b.label]['alone_ms'][est].append(ms)
    for label, rep in report.items():
        print(f'[lanes] {label}: device ms {json.dumps(rep["device_ms"])}; '
              f'each estimator alone on set a {json.dumps(rep["alone_ms"])}',
              flush=True)
    print(json.dumps({'card': cs.card_line(),
                      'torch': torch.__version__, 'builds': report}))


if __name__ == '__main__':
    main()
