"""The f32 operations each lane of a minimal6 problem performs, counted on
the host: csrc/minimal6.cu compiled with g++ through the host shim of
tests/test_torch_fast_minimal.py, with `float` replaced by a type that
counts, per lane, every +, -, *, /, negation, sqrtf, fabsf, atan2f and
sinf/cosf (sincosf counts two), the operations minimal6_kernel.
ops_per_problem counts in the plain version (selects and clamps are not
counted here; they are there). Prints, for EPnP at the card's lanes and at
one lane, and for planar-6 and DLT-6, the operations of each lane of a
problem, the longest lane's, and the plain version's count a problem.

    python perf_scripts/minimal6_lane_ops.py
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]

COUNTING = r'''
#include <float.h>
namespace host_warp { static long op_count[1024]; }
struct CF {
  float v;
  CF() = default;
  CF(float x) : v(x) {}
  CF(double x) : v((float)x) {}
};
static inline CF counted(float x) {
  ++host_warp::op_count[host_warp::current];
  return CF(x);
}
static inline CF operator+(CF a, CF b) { return counted(a.v + b.v); }
static inline CF operator-(CF a, CF b) { return counted(a.v - b.v); }
static inline CF operator*(CF a, CF b) { return counted(a.v * b.v); }
static inline CF operator/(CF a, CF b) { return counted(a.v / b.v); }
static inline CF operator-(CF a) { return counted(-a.v); }
static inline bool operator<(CF a, CF b) { return a.v < b.v; }
static inline bool operator>(CF a, CF b) { return a.v > b.v; }
static inline bool operator<=(CF a, CF b) { return a.v <= b.v; }
static inline bool operator>=(CF a, CF b) { return a.v >= b.v; }
static inline bool operator==(CF a, CF b) { return a.v == b.v; }
static inline CF sqrtf(CF a) { return counted(std::sqrt(a.v)); }
static inline CF fabsf(CF a) { return counted(std::fabs(a.v)); }
static inline CF atan2f(CF a, CF b) { return counted(std::atan2(a.v, b.v)); }
static inline void sincosf(CF a, CF* s, CF* c) {
  float sv, cv;
  ::sincosf(a.v, &sv, &cv);
  *s = counted(sv);
  *c = counted(cv);
}
static inline bool isnan(CF a) { return std::isnan(a.v); }
static inline bool isinf(CF a) { return std::isinf(a.v); }
static inline bool isfinite(CF a) { return std::isfinite(a.v); }
extern "C" void lc_host_op_counts(long* out, int n) {
  for (int i = 0; i < n; ++i) {
    out[i] = host_warp::op_count[i];
    host_warp::op_count[i] = 0;
  }
}
#define float CF
'''


def build(d, lanes):
    import test_torch_fast_minimal as tm
    from lc_tpu_torch import cuda_build
    with open(os.path.join(cuda_build.CSRC, 'minimal6.cu')) as f:
        src = f.read()
    src, n = re.subn(tm.HOST_LAUNCH[0], tm.HOST_LAUNCH[1], src)
    assert n == 1
    with open(os.path.join(d, 'cuda_runtime.h'), 'w') as f:
        f.write(tm.HOST_SHIM + COUNTING)
    cpp = os.path.join(d, 'minimal6.cpp')
    with open(cpp, 'w') as f:
        f.write(src)
    lib = os.path.join(d, f'libminimal6_ops_{lanes}.so')
    defs = [] if lanes is None else [f'-DLC_M6_LANES_EPNP={lanes}']
    subprocess.run(['g++', '-std=c++17', '-O1', '-ffp-contract=off', '-fPIC',
                    '-shared', '-Wno-unknown-pragmas', *defs, f'-I{d}', cpp,
                    '-o', lib], check=True)
    out = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    out.lc_minimal6.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    out.lc_minimal6_set_basis.argtypes = [vp]
    out.lc_host_op_counts.argtypes = [vp, ci]
    return out


def lane_ops(lib, est):
    """Operations of each lane of problem 0, one estimator alone on 8
    problems (one warp)."""
    from lc_tpu_torch.pnp import minimal6_kernel as mk
    from test_torch_fast_minimal import samples
    Kc, P3, uv, _ = samples(1.0)
    Kc, P3, uv = (np.ascontiguousarray(a, np.float32)
                  for a in (Kc[:1], P3[:1, :8], uv[:1, :8]))
    pose = np.zeros((1, 8, 7), np.float32)
    ok = np.zeros((1, 8), np.uint8)
    assert lib.lc_minimal6_set_basis(mk.basis_arg().ctypes.data) == 0
    counts = np.zeros(1024, np.int64)
    lib.lc_host_op_counts(counts.ctypes.data, 1024)     # reset
    code = mk.estimator_codes((est,))[0]
    assert lib.lc_minimal6(Kc.ctypes.data, P3.ctypes.data, uv.ctypes.data,
                           pose.ctypes.data, ok.ctypes.data, 1, 8, 1, code,
                           None) == 0
    lib.lc_host_op_counts(counts.ctypes.data, 1024)
    G = lib.lc_minimal6_lanes() if est == 'epnp' else 1
    return [int(c) for c in counts[:G]]


def main():
    from lc_tpu_torch.pnp import minimal6_kernel as mk
    plain = mk.ops_per_problem()
    report = dict(plain_ops_per_problem=plain)
    with tempfile.TemporaryDirectory() as d:
        card, one = build(d, None), build(d, 1)
        for label, lib, est in (('epnp', card, 'epnp'),
                                ('epnp_one_lane', one, 'epnp'),
                                ('planar', card, 'planar'),
                                ('dlt', card, 'dlt')):
            ops = lane_ops(lib, est)
            report[label] = dict(lanes=len(ops), ops_per_lane=ops,
                                 longest_lane=max(ops), group_total=sum(ops))
            print(f'[lane ops] {label}: {json.dumps(report[label])}',
                  flush=True)
    print(json.dumps(report))


if __name__ == '__main__':
    main()
