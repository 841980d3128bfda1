"""Parity of lc_tpu's and lc_tpu_torch's train and test CLIs on shared
checkpoints (ROADMAP A item 3), on the CPU, on generated trees of four
families: syn (glmo-shaped CDPN, configs/syn.yaml), zsyn (zebra Gray codes,
configs/zsyn.yaml), gspsyn (16 sparse keypoints, configs/gspsyn.yaml) and
zycbv (a zsyn tree with transform_model and a models_xform.json, the
zycbv shape). Each config is cut to 64² in, batch 4, valid_pix_cnt_th
30, the output 16² (CDPN) or 32² (ZebraDeepLabV3, at half the input, and
zsyn's max_bit_cnt to 5: a 32² grid holds no finer code).

Both train CLIs start from one step-0 checkpoint that lc_tpu writes (its
own Checkpoint of its own TrainState); the port's step-0 resume file is
made from it by the port's utils/flax_ckpt and state_dict_from_flax, and
each CLI takes its file through --ckpt. Both run their CNN in float32
(lc_tpu's compute dtype set to f32 here, as tests/test_torch_train_step.py
does). The CLIs are run in this process through their main(); their
per-step metrics are recorded by wrapping the step function each calls
(lc_tpu: train()'s record_metrics; the port: train.train_step).

Per step (test_per_step): steps 1-3 with the draws of the two packages'
own device generators off through --opts: the colour augmentation
(`train_dataset.pixel_aug_prob=0`; its values come from a jax key in
lc_tpu, a torch generator in the port) and the dense loss's sampling
offset (`loss.pose_loss_cfg.dense_sample=1`; a jax key against a torch
generator). Rotation and the background switch are host draws of the
loader's stream, which is bit-equal (tests/test_torch_mploader.py), and
stay as the configs set them. lc_tpu's BatchNorm computes its variance
in two passes here, as torch does. Tolerances: step 1, every loss term rtol
1e-4 (the one-step limit of tests/test_torch_train_step.py: the same
f32 arithmetic on the same weights and batch); steps 2 and 3, every loss
term rtol STEP_RTOL: the weights entering them differ by one or two
optimizer updates built from gradients that agree only to the f32
floor, 5e-3 relative below the heads (the same test's f64 readings), and
the first updates of Adam are the gradient's sign times the learning
rate, so a gradient element near zero can move its weight by 2 lr
between the packages. Measured: step 1 at most 6.3e-5 (syn's loss_pose),
steps 2-3 at most 3.6e-4 (zycbv's loss_seg at step 3); grad_norm, which
the largest gradients' rounding moves, is printed, not held (up to 19%
apart at step 3 of syn).

Long runs (test_long_runs_and_test_clis): 200 steps with the configs'
augmentation on; syn from 3 inits, the others from 1. The statistic is a
run's mean total loss (the sum of the loss terms both packages report)
over its last 50 steps. The init spread is the larger, over the two
packages, of the range of syn's three inits relative to their mean; each
family's gap between the packages, relative to their mean, must lie
within it.

Crossed test CLIs: both test CLIs with --deterministic on the same
file, once the port's model_final as a .pth (which lc_tpu.test ports),
once lc_tpu's model_final.ckpt (which lc_tpu_torch.test reads); with
'ransac' added to the family's solvers. Held: the same CSV files, rows
(scene, image, object) and columns; per instance, where the two RANSAC
poses agree (translation within 1 mm, rotation within 0.5 degrees: the
same LO winner), the final solver's poses within 0.01 degrees and, in
translation, 0.05 mm (chip_smoke's LM tolerance) plus 1e-3 of the pose's
distance: an untrained sparse head's winners lie 4.5-20 m away, where
the LM cost is flat along the line of sight and its stop (a relative
cost change of 1e-6) leaves the depth loose (measured: 2.41 mm apart at
8.3 m, 2.9e-4 of the distance; syn's one agreeing crop 3e-5 mm);
add(-s)_0.10 within 3 binomial
standard deviations of a difference at the instance count, plus one
instance; the median ADD(-S) error (ADD-S for the symmetric zsyn and
zycbv boxes) within 3 standard errors of a difference of two medians
(each sqrt(pi / 2) sigma / sqrt(n), sigma from the interquartile range:
a degenerate solve far away makes a mean meaningless). At this size and
200 steps no crop reaches add(-s)_0.10 in either package, so the median
error is the statistic that sees the poses of every instance. The two packages draw RANSAC's samples from different
generators (lc_tpu/pnp/ransac.py:265 Gumbel keys, the port torch's), so
instances whose winners differ are held only through that score.

Slow: each lc_tpu train step and RANSAC program compiles on XLA:CPU for
40-100 s, and the long runs take 200 steps a run on both sides.
"""
import functools
import json
import math
import os.path as osp
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

from lc_tpu import test as jtest
from lc_tpu import train as jtrain
from lc_tpu.data import synthetic as jsynthetic
from lc_tpu.models import layers as jlayers
from lc_tpu.utils.checkpoint import Checkpoint as JCheckpoint
from lc_tpu.utils.config import load_config as j_load_config
from lc_tpu_torch import test as ttest
from lc_tpu_torch import train as ttrain
from lc_tpu_torch.models.weights import state_dict_from_flax
from lc_tpu_torch.utils import flax_ckpt, seeding
from lc_tpu_torch.utils.checkpoint import Checkpoint, model_state_dict
from lc_tpu_torch.utils.config import load_config

pytestmark = pytest.mark.slow

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FAMILIES = ('syn', 'zsyn', 'gspsyn', 'zycbv')
CONFIG = dict(syn='syn.yaml', zsyn='zsyn.yaml', gspsyn='gspsyn.yaml',
              zycbv='zsyn.yaml')
HALF = np.array([40.0, 30.0, 20.0])
LONG_STEPS = 200
LAST = 50
SYN_INITS = (0, 1, 2)
STEP1_RTOL = 1e-4
STEP_RTOL = 1e-3
# the final solver's poses where the RANSAC winners agree: translation
# within FINAL_MM + FINAL_REL x the pose's distance
FINAL_MM = 0.05
FINAL_REL = 1e-3
_ORIG_JTRAIN = jtrain.train


@pytest.fixture(autouse=True)
def _f32_lc_tpu():
    jlayers.set_compute_dtype(jnp.float32)
    yield
    jlayers.set_compute_dtype(jnp.bfloat16)


def _set(d: dict, key: str, value):
    *head, last = key.split('.')
    for k in head:
        d = d.setdefault(k, {})
    d[last] = value


def make_tree(root: str, family: str) -> dict:
    """A generated tree (32 training frames, 24 test frames) and the
    config keys that point at it."""
    sym = family in ('zsyn', 'zycbv')
    jsynthetic.generate_dataset(root, n_images=32, split='train_syn', seed=0,
                                symmetric=sym)
    jsynthetic.generate_dataset(root, n_images=24, split='test_syn', seed=5,
                                symmetric=sym, list_name='test_list.txt')
    keys = {}
    if family == 'gspsyn':
        pts = jsynthetic.box_surface_points(HALF, 16).astype(np.float32)
        keys['fps'] = osp.join(root, 'fps.pkl')
        with open(keys['fps'], 'wb') as f:
            pickle.dump({1: pts}, f)
    if family == 'zycbv':
        from scipy.spatial.transform import Rotation as sciR
        rng = np.random.default_rng(6)
        xf = np.eye(4)
        xf[:3, :3] = sciR.random(random_state=6).as_matrix()
        xf[:3, 3] = rng.uniform(-5, 5, 3)
        corners = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                            for c in (-1, 1)]) * HALF
        scale = np.abs(corners @ xf[:3, :3].T + xf[:3, 3]).max(0)
        keys['transform_path'] = osp.join(root, 'models_xform.json')
        keys['transform_model'] = True
        with open(keys['transform_path'], 'w') as f:
            json.dump({'1': {'xform': xf.reshape(-1).tolist(),
                             'xformed_noc_scale': scale.tolist()}}, f)
    return keys


def write_cfg(path: str, family: str, root: str, tree_keys: dict,
              num_steps: int) -> str:
    with open(osp.join(ROOT, 'configs', CONFIG[family])) as f:
        cfg = yaml.safe_load(f)
    cfg.update(tree_keys)
    solvers = cfg['pnp_solver']['solvers']
    if 'ransac' not in solvers:
        solvers.insert(0, 'ransac')
    for key, value in {
            'net_input_wh': [64, 64], 'net_output_wh': [16, 16],
            'dataloader.batch_size': 4, 'dataloader.num_workers': 2,
            'train.num_steps': num_steps, 'train.test_every': 0,
            'train.ckpt_every': 100000,
            'train_dataset.dataset_root': root,
            'train_dataset.list_files': [osp.join(root, 'train_syn_list.txt')],
            'train_dataset.valid_pix_cnt_th': 30,
            'test_dataset.dataset_root': root,
            'test_dataset.list_files': [osp.join(root, 'test_list.txt')],
            'test_dataset.valid_pix_cnt_th': 30}.items():
        _set(cfg, key, value)
    if 'max_bit_cnt' in cfg:
        cfg['max_bit_cnt'] = 5
        cfg['net_output_wh'] = [32, 32]
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def shared_init(cfg_path: str, seed: int, out: str) -> tuple[str, str]:
    """lc_tpu's step-0 training checkpoint (its TrainState from init seed
    `seed`) and the port's step-0 resume file made from it."""
    jcomps = jtrain.build_training(j_load_config(cfg_path), seed=seed)
    jpath = JCheckpoint.by_step(osp.join(out, 'lc_tpu')).save(
        jcomps['state'], step=0)
    cfg = load_config(cfg_path)
    comps = ttrain.build_training(cfg, device='cpu')
    net_cfg = cfg.model.get('net_config', {})
    comps['model'].load_state_dict(state_dict_from_flax(
        flax_ckpt.read_variables(jpath), bool(net_cfg.get('concat', False)),
        net_name=cfg.model.net_name, sparse_cnt=cfg.get('sparse_cnt', 0)))
    seeding.seed_all(comps['seed'])
    tpath = Checkpoint.by_step(osp.join(out, 'port')).save(
        {'model': comps['model'].state_dict(),
         'optimizer': comps['optimizer'].state_dict(),
         'scheduler': comps['scheduler'].state_dict(),
         'loss_state': comps['loss_state']},
        step=0, aux={'random_state': seeding.get_random_state()})
    return jpath, tpath


def run_train_clis(monkeypatch, cfg_path: str, out: str, jckpt: str,
                   tckpt: str, opts=()) -> dict:
    """Both train CLIs from their step-0 files: {'lc_tpu'|'port':
    (per-step metrics, model_final path)}."""
    rec = {'lc_tpu': [], 'port': []}
    monkeypatch.setattr(jtrain, 'train', functools.partial(
        _ORIG_JTRAIN, mesh=None, record_metrics=rec['lc_tpu']))
    step_fn = ttrain.train_step

    def recording(*a, **kw):
        state, metrics = step_fn(*a, **kw)
        rec['port'].append({k: float(v) for k, v in metrics.items()})
        return state, metrics
    monkeypatch.setattr(ttrain, 'train_step', recording)
    opts = ['--opts', *opts] if opts else []
    jtrain.main(['--config', cfg_path, '--output', osp.join(out, 'lc_tpu'),
                 '--ckpt', jckpt, *opts])
    ttrain.main(['--config', cfg_path, '--output', osp.join(out, 'port'),
                 '--ckpt', tckpt, '--device', 'cpu', *opts])
    exp = load_config(cfg_path).exp_name + '-1'
    rec['lc_tpu'] = [{k: float(v) for k, v in m.items()}
                     for m in rec['lc_tpu']]
    return {pkg: (rec[pkg], osp.join(out, pkg, exp, 'model_final.ckpt'))
            for pkg in rec}


def loss_terms(j: dict, t: dict) -> list:
    return sorted(k for k in j if k.startswith('loss_') and k in t)


@pytest.fixture
def two_pass_batchnorm():
    """lc_tpu's BatchNorm with its batch variance in two passes, as
    torch computes it (tests/test_torch_train_zebra.py: flax's one-pass
    variance puts lc_tpu's f32 zebra gradients 0.7-4.1% from an f64 run of
    the port)."""
    kw = jlayers.BatchNorm.keywords
    kw['use_fast_variance'] = False
    try:
        yield
    finally:
        del kw['use_fast_variance']


@pytest.fixture
def tree(tmp_path, request):
    family = request.node.callspec.params['family']
    root = str(tmp_path / 'data')
    return family, root, make_tree(root, family)


@pytest.mark.parametrize('family', FAMILIES)
def test_per_step(tree, tmp_path, monkeypatch, two_pass_batchnorm, family):
    _, root, keys = tree
    cfg_path = write_cfg(str(tmp_path / f'{family}.yaml'), family, root,
                         keys, num_steps=3)
    jckpt, tckpt = shared_init(cfg_path, 0, str(tmp_path / 'init'))
    runs = run_train_clis(monkeypatch, cfg_path, str(tmp_path / 'out'),
                          jckpt, tckpt,
                          opts=['train_dataset.pixel_aug_prob=0',
                                'loss.pose_loss_cfg.dense_sample=1'])
    (jm, _), (tm, _) = runs['lc_tpu'], runs['port']
    assert len(jm) == len(tm) == 3
    gaps = []
    for step, (j, t) in enumerate(zip(jm, tm), 1):
        terms = loss_terms(j, t)
        assert terms, (j, t)
        gap = {k: abs(t[k] - j[k]) / max(abs(j[k]), 1e-12) for k in terms}
        gaps.append(gap)
        print(f'[{family}] step {step} relative gaps {gap}; grad_norm '
              f'{j["grad_norm"]:.6g} / {t["grad_norm"]:.6g}')
    for k, g in gaps[0].items():
        assert g <= STEP1_RTOL, (family, 1, k, g)
    for step, gap in enumerate(gaps[1:], 2):
        for k, g in gap.items():
            assert g <= STEP_RTOL, (family, step, k, g)


def mean_last(metrics: list) -> float:
    terms = [k for k in metrics[0] if k.startswith('loss_')]
    return float(np.mean([sum(m[k] for k in terms)
                          for m in metrics[-LAST:]]))


def rot_deg(Ra, Rb) -> float:
    """The angle between two rotations, from the chord ||Ra - Rb||_F =
    2 sqrt(2) sin(angle / 2) (exact near 0, where acos of the trace is
    not)."""
    chord = np.linalg.norm(np.asarray(Ra) - np.asarray(Rb))
    return math.degrees(2 * math.asin(min(1.0, chord / (2 * math.sqrt(2)))))


def pose_gap(ea: dict, eb: dict) -> tuple[float, float]:
    """(translation mm, rotation degrees) between two estimates."""
    return (float(np.linalg.norm(np.asarray(ea['t_est']).reshape(-1)
                                 - np.asarray(eb['t_est']).reshape(-1))),
            rot_deg(np.asarray(ea['R_est']).reshape(3, 3),
                    np.asarray(eb['R_est']).reshape(3, 3)))


def run_test_clis(monkeypatch, cfg_path: str, weight: str, out: str) -> dict:
    """Both test CLIs with --deterministic on one weight file:
    {'lc_tpu'|'port': (results, {csv name: text})}."""
    import glob
    monkeypatch.setattr(jtest, 'auto_mesh', lambda: None)
    found = {}
    for pkg, main, extra in (('lc_tpu', jtest.main, []),
                             ('port', ttest.main, ['--device', 'cpu'])):
        d = osp.join(out, pkg)
        res = main(['--weight', weight, '--config', cfg_path, '--output', d,
                    '--obj', '1', '--deterministic', *extra])
        found[pkg] = (res, {osp.basename(p): open(p).read()
                            for p in glob.glob(osp.join(d, '*.csv'))})
    return found


def median_error(errors: list, key: str) -> tuple[float, float]:
    """(median, standard error of the median) of the instances' errors,
    the spread from the interquartile range."""
    v = np.array([e[key] for e in errors], np.float64)
    q1, q2, q3 = np.percentile(v, [25, 50, 75])
    sigma = (q3 - q1) / 1.349
    return float(q2), math.sqrt(math.pi / 2) * sigma / math.sqrt(len(v))


def held_test_clis(family: str, cfg_path: str, found: dict) -> dict:
    """The crossed test CLIs' agreement on one weight file."""
    (jres, jcsv), (tres, tcsv) = found['lc_tpu'], found['port']
    assert sorted(jcsv) == sorted(tcsv)
    for name in jcsv:
        jrows = [r.split(',') for r in jcsv[name].strip().splitlines()]
        trows = [r.split(',') for r in tcsv[name].strip().splitlines()]
        assert len(jrows) == len(trows) and len(jrows) > 0, name
        assert [len(r) for r in jrows] == [len(r) for r in trows], name
        assert [r[:3] for r in jrows] == [r[:3] for r in trows], name
    final = load_config(cfg_path).pnp_solver.solvers[-1].replace('_', '-')
    assert set(jres) == set(tres)
    n = len(jres[final]['errors'])
    assert n == len(tres[final]['errors']) > 0
    agree, finals = 0, []
    for ja, ta, jf, tf in zip(jres['ransac']['errors'],
                              tres['ransac']['errors'],
                              jres[final]['errors'], tres[final]['errors']):
        dt, dr = pose_gap(ja, ta)
        if dt < 1.0 and dr < 0.5:
            agree += 1
            finals.append(pose_gap(jf, tf) + (float(np.linalg.norm(
                np.asarray(jf['t_est']).reshape(-1))),))
    sj, st = jres[final]['avg_score'], tres[final]['avg_score']
    p = (sj + st) / 2
    limit = 3 * math.sqrt(2 * p * (1 - p) / n) + 1 / n
    key = 'adi' if family in ('zsyn', 'zycbv') else 'add'
    (mj, dj), (mt, dt_) = (median_error(r[final]['errors'], key)
                           for r in (jres, tres))
    err_limit = 3 * math.sqrt(dj ** 2 + dt_ ** 2)
    rep = dict(instances=n, ransac_agree=agree,
               final_gap_mm=max((g[0] for g in finals), default=None),
               final_gap_deg=max((g[1] for g in finals), default=None),
               add_s_0_10=(sj, st), score_limit=limit,
               median_error_mm=(mj, mt), error_limit=err_limit)
    print(f'[{family}] crossed test CLIs {rep}')
    for g in finals:
        assert g[0] <= FINAL_MM + FINAL_REL * g[2] and g[1] <= 0.01, (
            family, g)
    assert abs(sj - st) <= limit, rep
    assert abs(mj - mt) <= err_limit, rep
    return rep


LONG = {}


@pytest.mark.parametrize('family', FAMILIES)
def test_long_runs_and_test_clis(tree, tmp_path, monkeypatch, family):
    _, root, keys = tree
    cfg_path = write_cfg(str(tmp_path / f'{family}.yaml'), family, root,
                         keys, num_steps=LONG_STEPS)
    means = {'lc_tpu': [], 'port': []}
    for seed in SYN_INITS if family == 'syn' else (0,):
        run_dir = str(tmp_path / f'init{seed}')
        jckpt, tckpt = shared_init(cfg_path, seed, run_dir)
        runs = run_train_clis(monkeypatch, cfg_path, run_dir, jckpt, tckpt)
        for pkg, (metrics, _) in runs.items():
            assert len(metrics) == LONG_STEPS
            means[pkg].append(mean_last(metrics))
        print(f'[{family}] init {seed}: mean loss over the last {LAST} '
              f'steps lc_tpu {means["lc_tpu"][-1]:.6g} port '
              f'{means["port"][-1]:.6g}')
    LONG[family] = means
    if family == 'syn':
        spread = max((max(v) - min(v)) / np.mean(v) for v in means.values())
        LONG['spread'] = spread
        print(f'[syn] init spread (relative range) {spread:.4g}')
    assert 'spread' in LONG, 'the syn case runs first: it gives the spread'
    for j, t in zip(means['lc_tpu'], means['port']):
        assert abs(t - j) / ((t + j) / 2) <= LONG['spread'], (
            family, j, t, LONG['spread'])
    # the crossed test CLIs on the last init's checkpoints
    final = {pkg: path for pkg, (_, path) in runs.items()}
    pth = str(tmp_path / 'port_final.pth')
    torch.save(model_state_dict(final['port']), pth)
    for tag, weight in (('port_pth', pth), ('lc_tpu_ckpt', final['lc_tpu'])):
        held_test_clis(family, cfg_path, run_test_clis(
            monkeypatch, cfg_path, weight, str(tmp_path / f'test_{tag}')))
