"""The LM kernel (B1) with and without multiply-add contraction on the
sparse path's own LM inputs, in one process on the card: chip_smoke's
gsplmo path and its oracle (every RANSAC draw of LM_SWEEP_SEEDS), each
call held to the float64 referee (chip_smoke.lm_case with refer=True),
first with csrc/lm_refine.cu built with -fmad=true, then with
-fmad=false. Prints, for each build, each call's referred and undetermined
problems, those where the kernel is the farthest float32 solver, and the
calls that fail the referee.

    python perf_scripts/lm_contraction_referee.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from lc_tpu_torch import cuda_build, resolve_device  # noqa: E402
from lc_tpu_torch.pnp import lm_kernel  # noqa: E402


def hold_all(inputs: dict, label: str):
    out = {}
    for name, (args, kw) in inputs.items():
        kw = dict(kw)
        args = list(args) + [kw.pop('valid', None)]
        try:
            r = cs.lm_case(args, kw, name=name, refer=True, timed=False)[0]
            rows = r['referred']
            out[name] = dict(held=True, referred=len(rows),
                             undetermined=sum(not x['determined'] for x in rows),
                             farthest=sum(x['farthest'] for x in rows
                                          if not x['determined']))
        except RuntimeError as e:
            out[name] = dict(held=False, error=str(e)[:600])
    print(label, json.dumps(out), flush=True)
    print(label, 'failed:', [k for k, v in out.items() if not v['held']],
          flush=True)


def build_lm(fmad: str):
    cuda_build.EXTRA_FLAGS['lm_refine'] = (f'-fmad={fmad}',)
    cuda_build._libs.pop('lm_refine', None)
    lm_kernel._max_points.clear()
    cuda_build.build_all(('lm_refine',))


def main():
    dev = resolve_device('cuda')
    print(cs.card_line(), flush=True)
    cuda_build.build_all()
    inputs = dict(cs.phase_sparse(dev)[1])
    inputs.update(cs.phase_path_oracle('sparse', cs.GSPLMO, dev, 0.1)[1])
    for fmad in ('true', 'false'):
        build_lm(fmad)
        hold_all(inputs, f'fmad={fmad}')


if __name__ == '__main__':
    main()
