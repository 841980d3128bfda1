"""Where EPnP's time goes inside the minimal6 kernel: csrc/minimal6.cu
built as it is and with one phase of EPnP-6 cut out at a time (its loop run
zero times, or the call dropped), each build timed with EPnP alone on
chip_smoke's set a (B = 32, K = 150; device time from torch.profiler, the
mean launch of each window, `--rounds` rounds in turns). A cut build's
hypotheses are wrong: it is timed, not compared. The difference from the
whole build is the phase's share of the chain that sets the kernel's time.

    python perf_scripts/minimal6_phases.py
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'perf_scripts'))
import chip_smoke as cs  # noqa: E402
import minimal6_lanes as ml  # noqa: E402

# phase: (text in epnp6, its replacement); each text occurs once in epnp6
CUTS = {
    'pca_eigh3': ('cov[4] * inv_s, cov[5] * inv_s, 4, vals, V3);',
                  'cov[4] * inv_s, cov[5] * inv_s, 0, vals, V3);'),
    'inverse_iteration': ('  for (int it = 0; it < 3; ++it) {',
                          '  for (int it = 0; it < 0; ++it) {'),
    'ritz_jacobi_4x4': ('  jacobi_sym(T, Q, 8);', '  jacobi_sym(T, Q, 0);'),
    'gauss_newton': ('  for (int it = 0; it < 4; ++it) {',
                     '  for (int it = 0; it < 0; ++it) {'),
    'procrustes_polar': ('  polar3(H, R);',
                         '  for (int i = 0; i < 9; ++i) R[i / 3][i % 3] = H[i / 3][i % 3];'),
}


def cut_sources(out_dir):
    from lc_tpu_torch import cuda_build
    with open(os.path.join(cuda_build.CSRC, 'minimal6.cu')) as f:
        src = f.read()
    start = src.index('__device__ __forceinline__ Hyp epnp6(')
    end = src.index('// DLT-6 (lc_tpu')
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for phase, (old, new) in CUTS.items():
        body = src[start:end]
        if body.count(old) != 1:
            raise RuntimeError(f'{phase}: {old!r} occurs {body.count(old)} '
                               'times in epnp6')
        path = os.path.join(out_dir, f'minimal6_cut_{phase}.cu')
        with open(path, 'w') as f:
            f.write(src[:start] + body.replace(old, new) + src[end:])
        paths[f'without {phase}'] = path
    return paths


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'lc_tpu_torch', 'build', 'minimal6_phases'),
        help='where the builds go (the package\'s gitignored build directory)')
    a = ap.parse_args()
    from lc_tpu_torch import resolve_device
    dev = resolve_device('cuda')
    print(cs.card_line(), flush=True)
    built = ml.build(a.out, {'whole': None}, None, cut_sources(a.out))
    args = cs.minimal_samples(32, 150, 0.0, False, 0, dev)[:3] + (('epnp',),)
    builds = [ml.Build(label, lib, log) for label, (lib, log) in built.items()]
    times = {b.label: [] for b in builds}
    for r in range(a.rounds):
        for b in (builds if r % 2 == 0 else builds[::-1]):
            times[b.label].append(cs.kernel_device_ms(
                lambda: b(*args), 'minimal6_kernel', reps=20))
    whole = min(times['whole'])
    for label, ts in times.items():
        print(f'[phases] {label}: EPnP alone {min(ts):.4f} ms '
              f'(whole minus this {whole - min(ts):.4f} ms)', flush=True)
    print(json.dumps({'card': cs.card_line(), 'epnp_alone_ms': times}))


if __name__ == '__main__':
    main()
