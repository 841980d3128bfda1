"""The port's LO-RANSAC refit estimators against lc_tpu's on a weighted
64-point support: EPnP, planar and DLT refits and the planar flip agree to
f32 rounding (translation within 0.05 mm, |q·q'| > 1 − 1e-5). Split from
test_torch_ransac.py to keep each file's lc_tpu compiles short."""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import torch

from lc_tpu_torch.pnp import epnp as tepnp
from lc_tpu_torch.pnp import ransac as tr
from test_torch_ransac import _pose_diff, make_problem

jepnp = importlib.import_module('lc_tpu.pnp.epnp')
jr = importlib.import_module('lc_tpu.pnp.ransac')


def test_refit_estimators_match():
    """The LO refits: EPnP, planar and DLT on a weighted 64-point support
    (noise 1 px), and the planar flip of the result."""
    pose, Ks, pts3d, uv = make_problem(noise=1.0)
    w = (np.random.default_rng(5).random(pts3d.shape[:2]) < 0.8).astype(np.float32)
    J = [jnp.asarray(a) for a in (Ks, pts3d, uv, w)]
    T = [torch.tensor(a) for a in (Ks, pts3d, uv, w)]
    for jfn, tfn in ((jepnp.epnp, tepnp.epnp), (jr.planar_pnp, tr.planar_pnp),
                     (jr.dlt_pnp, tr.dlt_pnp)):
        pj, okj = jax.jit(jfn)(*J)
        pt, okt = tfn(*T)
        np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
        dt, dq = _pose_diff(np.asarray(pj), pt.numpy())
        assert np.all(dt < 0.05) and np.all(dq > 1 - 1e-5), (jfn, dt, dq)
    fj = jax.jit(jr._planar_flip)(jnp.asarray(pose), J[1], J[3])
    ft = tr._planar_flip(torch.tensor(pose), T[1], T[3])
    dt, dq = _pose_diff(np.asarray(fj), ft.numpy())
    assert np.all(dt < 0.05) and np.all(dq > 1 - 1e-5)
