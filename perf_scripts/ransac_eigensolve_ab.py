"""RANSAC with three forms of its small eigensolvers, in one process on the
card: the earlier small solvers (the 4x4 Rayleigh-Ritz step through
torch.linalg.eigh, element-wise Jacobi for the 3x3 frames), a ten-operation
rotation form and this tree's six-operation form, on each inference path's
own batch: RANSAC's device operations per batch, peak device memory, ms,
and run_test crops/s, in turns."""
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from lc_tpu_torch.ops import smallmat  # noqa: E402
from lc_tpu_torch.pnp import epnp  # noqa: E402

import importlib.util  # noqa: E402
from lc_tpu_torch.pnp import ransac  # noqa: E402


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# each version: (smallest_eigvecs for EPnP's 12x12, jacobi_eigh_small for the
# 3x3 PCA frames): the earlier form (smallmat_parent.py: eigh for the 4x4
# Rayleigh-Ritz step, element-wise Jacobi), a ten-operation rotation form
# (smallmat_rotation10.py), lc_tpu_torch/ops/smallmat.py's six-operation form
parent, j10 = _load('smallmat_parent'), _load('smallmat_rotation10')
VERSIONS = {'eigh': (parent.smallest_eigvecs, parent.jacobi_eigh_small),
            'jacobi10': (j10.smallest_eigvecs, j10.jacobi_eigh_small),
            'jacobi6': (smallmat.smallest_eigvecs,
                        smallmat.jacobi_eigh_small)}


def use(name):
    eig, jac = VERSIONS[name]
    epnp.smallest_eigvecs = eig
    epnp.jacobi_eigh_small = jac
    ransac.jacobi_eigh_small = jac


def main():
    from lc_tpu_torch import harness
    from lc_tpu_torch.data.pipeline import device_preprocess
    from lc_tpu_torch.pnp.ransac import ransac_pnp
    from lc_tpu_torch import cuda_build
    cuda_build.build_all()
    dev = torch.device('cuda')
    card = cs.card_line()
    out = {'card': card}
    for tag, path, seed in (('glmo', cs.GLMO, 11), ('zlmo', cs.ZLMO, 12),
                            ('gsplmo', cs.GSPLMO, 13)):
        batches, model, dataset, ev, _ = cs.path_setup(tag, path, dev, seed)
        model = model.to(dev).eval()
        from lc_tpu_torch.models import set_compute_dtype
        set_compute_dtype(model, torch.bfloat16)
        gt = device_preprocess(cs.h2d(batches[-1], dev),
                               net_input_wh=path['net_input_wh'])
        with torch.no_grad():
            net_out = model(gt['img_in'])
        pts3d, pts2d, _, valid = cs.path_points(path, net_out, gt)
        thr = cs.path_threshold(path, batches[-1], dev)
        gen = torch.Generator(device=dev)
        call = lambda: ransac_pnp(gt['out_K'], pts3d, pts2d, gen.manual_seed(0),  # noqa: E731
                                  valid=valid, reproj_threshold=thr)
        rep = {}
        for name in ('eigh', 'jacobi10', 'jacobi6', 'jacobi6', 'jacobi10',
                     'eigh'):
            use(name)
            r = rep.setdefault(name, {'ms': [], 'crops_per_s': []})
            call()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            call()
            torch.cuda.synchronize()
            r['peak_mib'] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
            r['device_ops'] = cs.device_ops_per_call(call, reps=1)
            r['ms'].append(cs.median_call_ms(call, windows=3, reps=3))
            res = harness.run_test(cs.path_cfg(path), model, batches,
                                   dataset, ev, device=dev)
            r['crops_per_s'].append(
                1.0 / res[cs.final_solver(path)]['errors'][0]['time'])
            r['largest_allocations'] = cs.largest_allocations(call)
        out[tag] = rep
        print(tag, json.dumps(rep), flush=True)
    use('jacobi6')
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/ransac_eigensolve_ab.json', 'w') as f:
        json.dump(out, f, indent=1)
    print(card)


if __name__ == '__main__':
    main()
