"""The port's BOP'19 scores (eval/error6d.py mssd_err / mspd_err /
proj_err, eval/evaluator.py _sym_transforms, compute_bop_errors and the
average recalls of compute_scores) against lc_tpu's, on a generated
symmetric tree: the cases of tests/test_eval_and_tools.py
(test_bop_scores_optional, test_sym_transforms_semantics) and perturbed
estimates.

Tolerances: symmetry transforms atol 1e-6 (f32 rounding of a float64
Rodrigues against scipy's quaternion form); mssd atol 1e-3 mm and mspd
atol 1e-3 px (f32 over ~1e3 mm camera coordinates, summed in another
order); proj_err atol 1e-3 px; the AR keys equal, as no error lies within
those tolerances of a threshold here (checked).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as sciR

from lc_tpu import eval as jev
from lc_tpu.data import synthetic as jsynthetic
from lc_tpu.eval import error6d as jerr
from lc_tpu_torch.eval import error6d as terr
from lc_tpu_torch.eval.evaluator import Evaluator


@pytest.fixture(scope='module')
def sym_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('bop'))
    flist = jsynthetic.generate_dataset(root, n_images=6, split='test_syn',
                                        seed=3, list_name='l.txt',
                                        symmetric=True)
    return root, flist


def _pair(root, flist, name='synthetic_sym'):
    return (jev.Evaluator([flist], root, name, obj_ids=[1], visib_fract_th=0),
            Evaluator.from_bop([flist], root, name, obj_ids=[1],
                               visib_fract_th=0))


def _as_results(gts, R, t):
    return [dict(scene_id=g['scene_id'], im_id=g['im_id'],
                 obj_id=g['obj_id'], R_est=r, t_est=tt)
            for g, r, tt in zip(gts, R, t)]


def _compare(jres, tres):
    (jper, jerrs), (tper, terrs) = jres, tres
    for a, b in zip(jerrs, terrs):
        assert abs(a['mssd'] - b['mssd']) <= 1e-3, (a['mssd'], b['mssd'])
        assert abs(a['mspd'] - b['mspd']) <= 1e-3, (a['mspd'], b['mspd'])
    assert jper.keys() == tper.keys()
    for oid in jper:
        assert jper[oid].keys() == tper[oid].keys()
        for k in ('bop_mssd_ar', 'bop_mspd_ar'):
            assert tper[oid][k] == jper[oid][k], k


def test_bop_scores_gt_flipped_and_perturbed(sym_tree):
    """GT as the estimate: zero errors, both ARs 1; a 180° flip about the
    box's symmetry axis: zero mssd, AR 1 (a large plain ADD); perturbed
    poses: the port's errors and ARs are lc_tpu's."""
    root, flist = sym_tree
    jeval, teval = _pair(root, flist)
    gts = teval.gts
    R = [np.asarray(g['R_gt'], np.float64).reshape(3, 3) for g in gts]
    t = [np.asarray(g['t_gt'], np.float64).reshape(3) for g in gts]
    res = _as_results(gts, R, t)
    tper, terrs = teval.evaluate(res, bop=True)
    assert all(e['mssd'] < 1e-3 and e['mspd'] < 1e-3 for e in terrs)
    assert tper[1]['bop_mssd_ar'] == tper[1]['bop_mspd_ar'] == 1.0
    _compare(jeval.evaluate(res, bop=True), (tper, terrs))

    sym = np.asarray(teval.models_info[1]['symmetries_discrete'][0]
                     ).reshape(4, 4)
    flipped = _as_results(gts, [r @ sym[:3, :3] for r in R], t)
    tper_f, terrs_f = teval.evaluate(flipped, bop=True)
    assert all(e['mssd'] < 1e-2 for e in terrs_f)
    assert tper_f[1]['bop_mssd_ar'] == 1.0
    assert min(e['add'] for e in terrs_f) > 10.0
    _compare(jeval.evaluate(flipped, bop=True), (tper_f, terrs_f))

    rng = np.random.default_rng(4)
    dR = sciR.from_rotvec(rng.normal(0, 0.05, (len(R), 3))).as_matrix()
    pert = _as_results(gts, [d @ r for d, r in zip(dR, R)],
                       [x + rng.normal(0, 4.0, 3) for x in t])
    tres = teval.evaluate(pert[:-1], bop=True)      # the last one a miss
    jres = jeval.evaluate(pert[:-1], bop=True)
    _compare(jres, tres)
    ar = tres[0][1]
    assert 0 < ar['bop_mssd_ar'] < 1 and 0 < ar['bop_mspd_ar'] < 1
    diameter = teval.models_info[1]['diameter']
    for e in tres[1][:-1]:
        for th in np.arange(0.05, 0.51, 0.05):
            assert abs(e['mssd'] - th * diameter) > 1e-3
        for r in np.arange(5, 51, 5):
            assert abs(e['mspd'] - r * e['im_w'] / 640.0) > 1e-3


def test_sym_transforms_semantics(sym_tree):
    """The toolkit's composition rules (pysixd/misc.py:206-254): identity
    first, t = offset − R·offset for a continuous symmetry, discrete ∘
    continuous; the port's set is lc_tpu's, at π/4 and at the default
    0.01 step."""
    root, flist = sym_tree
    jeval, teval = _pair(root, flist)
    info = dict(teval.models_info[1], symmetries_continuous=[
        dict(axis=[0, 0, 1], offset=[5.0, 0, 0])])
    jeval.models_info[1] = teval.models_info[1] = info
    Rs, ts = teval._sym_transforms(1, max_sym_disc_step=np.pi / 4)
    # the discrete flip and the identity, each with 3 continuous steps
    assert Rs.shape == (6, 3, 3)
    off = np.array([5.0, 0, 0])
    for R, t in zip(Rs[:3], ts[:3]):
        np.testing.assert_allclose(t, off - R @ off, atol=1e-5)
        np.testing.assert_allclose(R @ np.array([0, 0, 1.0]), [0, 0, 1.0],
                                   atol=1e-6)
    for step in (np.pi / 4, 0.01):
        for a, b in zip(jeval._sym_transforms(1, step),
                        teval._sym_transforms(1, step)):
            np.testing.assert_allclose(b, a, atol=1e-6)


def test_error_functions_match():
    """mssd_err, mspd_err and proj_err on random poses, a random point set
    and four symmetries, batched over 5 instances."""
    rng = np.random.default_rng(0)
    B = 5
    R_e, R_g = (sciR.random(B, random_state=s).as_matrix().astype(np.float32)
                for s in (1, 2))
    t_e = np.concatenate((rng.normal(0, 30, (B, 2)),
                          rng.uniform(600, 900, (B, 1))), -1).astype(np.float32)
    t_g = (t_e + rng.normal(0, 5, (B, 3))).astype(np.float32)
    pts = rng.uniform(-40, 40, (300, 3)).astype(np.float32)
    K = np.broadcast_to(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0],
                                  [0, 0, 1]], np.float32), (B, 3, 3)).copy()
    sym_R = sciR.random(4, random_state=3).as_matrix().astype(np.float32)
    sym_R[0] = np.eye(3)
    sym_t = rng.normal(0, 2, (4, 3)).astype(np.float32)
    j = lambda *a: [jnp.asarray(x) for x in a]  # noqa: E731
    t = lambda *a: [torch.from_numpy(x) for x in a]  # noqa: E731
    args = (R_e, t_e, R_g, t_g)
    pairs = [
        (jerr.mssd_err(*j(*args, pts, sym_R, sym_t)),
         terr.mssd_err(*t(*args, pts, sym_R, sym_t))),
        (jerr.mspd_err(*j(*args, K, pts, sym_R, sym_t)),
         terr.mspd_err(*t(*args, K, pts, sym_R, sym_t))),
        (jerr.proj_err(*j(*args, K, pts)), terr.proj_err(*t(*args, K, pts)))]
    for a, b in pairs:
        assert b.shape == (B,)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
