"""Data parallelism of the port (lc_tpu_torch/parallel/mesh.py) on the CPU:
two gloo ranks, each a process of its own, against one process on the same
global batch.

The chain to lc_tpu: the port's one-process step is held to lc_tpu's
(test_torch_train_step.py, test_torch_train_zebra.py), and lc_tpu holds its
sharded step to its single-device step (tests/test_multichip.py); holding
the port's two ranks to its one rank closes the chain without compiling
lc_tpu here.

Tolerances, each with its reason:
  * loaders: bit-equal (the same numpy/cv2 code, rows drawn from their
    global positions);
  * the training step, in f64 at 64² in, 16² out, global batch 4: loss
    terms, grad_norm, every gradient and every update of one Ranger step
    (relative L2 per tensor), BatchNorm's running statistics, the clip
    threshold and the Gray-code histogram within 1e-9 relative. The ranks
    sum in another order (per-rank sums, then across ranks; BatchNorm's
    statistics combined from per-rank moments), a few f64 ulps; the
    preprocessed rows are bit-equal;
  * sharded run_test: the same RANSAC draws for each crop at both world
    sizes; poses where both RANSAC winners agree within B1's tolerance
    (0.05 mm, |q.q'| >= 1 - 1e-5) agree within it, ADD within lc_tpu's own
    rule (tests/test_multichip.py: rtol 0.03, atol 1.0); static int8 scales
    equal;
  * the train CLI over two ranks against one, in f32: step 1's loss terms
    and grad_norm rtol 1e-3, step 3's loss terms rtol 5e-3, its grad_norm
    not compared. The same step in f64 agrees to 1e-9 (above); in f32 the
    LC loss amplifies the rounding of BatchNorm's statistics and of the
    sums taken in another order: measured on this CPU, step 1 3e-5
    (loss_pose) and 1e-4 (grad_norm), step 3 up to 3.9e-4 (loss_pose) and
    5.4e-2 (grad_norm, after two Ranger updates). Both ranks agree
    exactly, and a resumed run repeats its step exactly.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from lc_tpu.data import synthetic as jsynthetic
from lc_tpu.data.pipeline import BOPDataset as JDataset
from lc_tpu.data.pipeline import Loader as JLoader
from lc_tpu.utils.config import Config as JConfig
from lc_tpu_torch.data.pipeline import BOPDataset, Loader, MPLoader
from lc_tpu_torch.parallel import mesh

from test_torch_train_step import tiny_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL = 1e-9

# The cases both sides run: exec'd here for one process, and in each of two
# spawned processes for the ranks (which import no jax).
CASES = textwrap.dedent(r'''
    import types

    import numpy as np
    import torch

    from lc_tpu_torch import harness
    from lc_tpu_torch.codec import calc_bit_count
    from lc_tpu_torch.data import synthetic
    from lc_tpu_torch.data.pipeline import collate
    from lc_tpu_torch.eval.evaluator import Evaluator
    from lc_tpu_torch.loss.loss_fn import init_loss_state
    from lc_tpu_torch.models import quant, set_compute_dtype
    from lc_tpu_torch.models.weights import init_weights
    from lc_tpu_torch.optim.factory import build_optimizer
    from lc_tpu_torch.parallel import mesh
    from lc_tpu_torch.data.pipeline import device_prefetch
    from lc_tpu_torch.train import preprocess_step, sample_offset
    from lc_tpu_torch.train_step import train_step
    from lc_tpu_torch.utils.config import Config

    IN_WH = (64, 64)
    HALF_EXTENTS = np.array([40., 30., 20.], np.float32)
    FAMILIES = {
        'cdpn': dict(out_wh=(16, 16), max_bit_cnt=0, model=dict(
            net_name='cdpn_resnet', net_config=dict(concat=False)),
            loss=dict(w_loss_noc=1.0, w_loss_seg=0.25, w_loss_pose=0.02)),
        'zebra': dict(out_wh=(32, 32), max_bit_cnt=4, model=dict(
            net_name='zebra_DeepLabV3',
            net_config=dict(back_layers_num=34, output_kernel_size=1)),
            loss=dict(w_loss_noc_bin=1.0, w_loss_seg=1.0, w_loss_pose=0.02)),
    }


    def step_case(family, shard):
        """One f64 training step on a global batch of 4 rendered crops
        (device-rotated, background switch, colour augmentation), this
        rank's rows under `shard`: what the comparison reads."""
        torch.set_default_dtype(torch.float32)
        fam = FAMILIES[family]
        cfg = Config(dict(
            max_bit_cnt=fam['max_bit_cnt'], model=fam['model'],
            optimizer=dict(type='Ranger', lr=1e-3, wd=1e-4),
            scheduler=dict(name='none'),
            train_dataset=dict(use_peper_salt=True, use_motion_blur=True,
                               use_invert=True),
            loss=dict(pose_loss_cfg=dict(clip_weight_grad=True),
                      pose_loss_start_step=0, **fam['loss'])))
        bit_cnt = tuple(calc_bit_count(HALF_EXTENTS.tolist(),
                                       max_bits=fam['max_bit_cnt'])) \
            if fam['max_bit_cnt'] else None
        host = collate(synthetic.render_train_set(
            4, seed=9, net_input_wh=IN_WH, net_output_wh=fam['out_wh'],
            pixel_aug_prob=1.0, switch_bg_prob=0.5))
        local = {k: mesh.local_rows(v, shard) for k, v in host.items()}
        model = harness.build_model_from_cfg(cfg, sum(bit_cnt or ()))
        init_weights(model, torch.Generator().manual_seed(3))
        model = set_compute_dtype(model.to(torch.float64), torch.float64)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        loss_cfg = harness.make_loss_config(cfg, 0, bit_cnt)
        optimizer, scheduler = build_optimizer(
            model.parameters(), cfg.optimizer, cfg.scheduler, 10)
        pp = harness.preprocess_kwargs(cfg, types.SimpleNamespace(
            net_input_wh=IN_WH, net_output_wh=fam['out_wh'],
            mask_nearest=False), train=True)
        with mesh.data_parallel(shard):
            # the train loop's staging, in line
            gt = next(device_prefetch(
                [local], lambda dev, _: preprocess_step(dev, 7, 0, pp),
                'cpu', size=0))
            img_in = gt['img_in'].clone()
            gt = {k: v.double() if v.is_floating_point() else v
                  for k, v in gt.items()}
            state, metrics = train_step(
                model, optimizer, scheduler, loss_cfg,
                init_loss_state(loss_cfg), gt, 0,
                sample_offset(7, 0, loss_cfg.dense_sample))
        params = dict(model.named_parameters())
        return dict(
            img_in=img_in,
            metrics={k: float(v) for k, v in metrics.items()},
            grads={k: p.grad.clone() for k, p in params.items()
                   if p.grad is not None},
            updates={k: (p.detach() - before[k]) for k, p in params.items()},
            running={k: v.clone() for k, v in model.named_buffers()},
            clip=float(state.weight_clip.max_norm),
            histogram=None if state.histogram is None
            else state.histogram.clone())


    def test_case(shard, int8_static=False):
        """harness.run_test on 5 rendered crops in batches of 3 and 2 (the
        3 padded to 4 over two ranks), seeded random weights: the results
        and the static int8 scales it used."""
        es = synthetic.render_eval_set(5, seed=4, net_input_wh=IN_WH,
                                       net_output_wh=(16, 16))
        loader = [collate(es['blobs'][:3]), collate(es['blobs'][3:])]
        cfg = Config(dict(pnp_solver=dict(
            dense_point_select='quantile', quantile=0.3,
            solvers=['weighted', 'ransac'])))
        if int8_static:
            cfg.update(int8_inference=True, int8_act_scales='static')
        model = harness.build_model_from_cfg(Config(FAMILIES['cdpn']))
        init_weights(model, torch.Generator().manual_seed(5))
        ev = Evaluator(es['gts'], es['models'], es['models_info'],
                       'synthetic')
        scales = {}
        real = quant.quantized_int8

        def recording(model, act_scales=None, **kw):
            scales.update({k: float(v) for k, v in
                           (act_scales or {}).items()})
            return real(model, act_scales=act_scales, **kw)

        quant.quantized_int8 = recording
        try:
            with mesh.data_parallel(shard):
                out = harness.run_test(
                    cfg, model, loader,
                    types.SimpleNamespace(net_input_wh=IN_WH, bit_cnt=None),
                    ev, device='cpu')
        finally:
            quant.quantized_int8 = real
        return dict(scales=scales, results={
            name: dict(avg_score=r['avg_score'],
                       R=np.stack([e['R_est'] for e in r['errors']]),
                       t=np.stack([e['t_est'] for e in r['errors']]),
                       add=np.array([e['add'] for e in r['errors']]))
            for name, r in out.items()})
''')

WORKER = CASES + textwrap.dedent(r'''
    import sys
    import torch.distributed as dist

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=2)
    shard = mesh.shard_of(dist.group.WORLD)
    job, *args = sys.argv[4:]
    result = step_case(args[0], shard) if job == 'step' \
        else test_case(shard, int8_static=args[0] == 'static')
    torch.save(result, f'{out}/rank{rank}.pt')
    dist.destroy_process_group()
''')


def _cases():
    ns = {}
    exec(compile(CASES, 'cases', 'exec'), ns)
    return ns


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2')


def _two_ranks(tmp_path, *args, timeout=300):
    """Run WORKER's job on two gloo ranks; their results, in rank order."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, '-c', WORKER, str(r), port, str(tmp_path), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=ROOT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    results = []
    for r in range(2):      # a step's f64 results: ~0.4 GB a rank
        path = tmp_path / f'rank{r}.pt'
        results.append(torch.load(path, weights_only=False))
        path.unlink()
    return results


def _rel(a, b, floor: float = 0.0) -> float:
    """Relative L2 distance of a from b; b's norm taken as at least
    `floor` (a conv bias before BatchNorm has an exact gradient of zero,
    of which f64 keeps only noise)."""
    a, b = torch.as_tensor(a, dtype=torch.float64), \
        torch.as_tensor(b, dtype=torch.float64)
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), floor, 1e-300))


# --------------------------------------------------------------------------
# the loaders' carving
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp('syn')
    jsynthetic.generate_dataset(str(root), n_images=8, split='train_syn',
                                seed=0)
    jsynthetic.generate_dataset(str(root), n_images=5, split='test_syn',
                                seed=1, list_name='test_list.txt')
    bg = root / 'bg'
    bg.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(str(bg / f'{i}.png'),
                    rng.integers(0, 256, (96, 128, 3)).astype(np.uint8))
    return str(root)


def test_carved_loaders_match_lc_tpu(tree):
    """The port's Loader and MPLoader carved for process 0 and 1 of 2 give
    lc_tpu's carved Loader's rows bit for bit, and the union of the two is
    the one-process stream."""
    cfg = tiny_cfg(tree)
    jcfg = JConfig(cfg.to_dict())
    ds = BOPDataset(cfg.train_dataset, cfg, train=True)
    jds = JDataset(jcfg.train_dataset, jcfg, train=True)
    whole = list(Loader(ds, 4, seed=5, num_threads=2))
    per_rank = []
    for r in range(2):
        ours = list(Loader(ds, 4, seed=5, num_threads=2, process_index=r,
                           process_count=2))
        theirs = list(JLoader(jds, 4, seed=5, num_threads=2, process_index=r,
                              process_count=2))
        mp = MPLoader(cfg.train_dataset, cfg, batch_size=4, seed=5,
                      num_workers=2, process_index=r, process_count=2)
        try:
            procs = list(mp)
        finally:
            mp.close()
        assert len(ours) == len(theirs) == len(procs) == len(whole) == 2
        for a, b, c in zip(ours, theirs, procs):
            assert set(a) == set(b) == set(c)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                np.testing.assert_array_equal(a[k], c[k], err_msg=k)
        per_rank.append(ours)
    for g, a, b in zip(whole, *per_rank):
        for k in g:
            np.testing.assert_array_equal(np.concatenate((a[k], b[k])), g[k])


def test_carving_checks(tree):
    """An indivisible global batch raises; so do RatioMixLoader's two
    sub-batches when either does not divide (lc_tpu/harness.py's check)."""
    from lc_tpu_torch import harness
    cfg = tiny_cfg(tree)
    ds = BOPDataset(cfg.train_dataset, cfg, train=True)
    with pytest.raises(ValueError, match='divisible'):
        Loader(ds, 4, process_count=3)
    mixed = tiny_cfg(tree, **{'train_dataset_1.ratio': 0.25,
                              'train_dataset_1.name': 'synthetic'})
    with pytest.raises(ValueError, match='sub-batches 1 and 3'):
        harness.make_datasets(mixed, train=True, process_index=0,
                              process_count=2)
    mixed['dataloader']['batch_size'] = 8
    ds0, loader = harness.make_datasets(mixed, train=True, process_index=1,
                                        process_count=2)
    assert [x.batch_size for x in loader.loaders] == [6, 2]
    assert all(x.process_index == 1 for x in loader.loaders)
    # the test loader is never carved: run_test shards it
    _, test_loader = harness.make_datasets(cfg, train=False, process_index=1,
                                           process_count=2)
    assert test_loader.process_count == 1


def test_helpers_without_a_group():
    """With no shard the helpers are the identity (no device operation),
    and padding repeats the last row."""
    x = torch.arange(6.0, requires_grad=True)
    assert mesh.all_reduce_sum(x, None) is x
    assert mesh.all_reduce_max(x, None) is x
    assert mesh.cross_rank_mean(x) is x
    assert mesh.local_rows(x, None) is x
    assert mesh.gather_rows(x, None) is x
    assert mesh.resolve_group('auto') is None and mesh.shard_of(None) is None
    assert mesh.is_primary(None)
    batch, n = mesh.pad_to_multiple({'a': np.arange(3)}, 2)
    assert n == 3 and batch['a'].tolist() == [0, 1, 2, 2]
    shard = mesh.Shard(None, 1, 2)
    assert mesh.local_rows(batch['a'], shard).tolist() == [2, 2]
    with pytest.raises(ValueError, match='pad it'):
        mesh.local_rows(np.arange(3), shard)
    with pytest.raises(ValueError, match='parallel must be'):
        mesh.resolve_group('all')


# --------------------------------------------------------------------------
# one training step
# --------------------------------------------------------------------------

@pytest.mark.parametrize('family', ['cdpn', 'zebra'])
def test_two_rank_step_equals_one_rank_step(tmp_path, family):
    """One f64 step of CDPN (dense NOC, clip tap) and of ZebraDeepLabV3
    (Gray codes, the histogram) on two gloo ranks equals the step of one
    process on the same global batch of 4: every rank reports the global
    loss terms and grad_norm, holds the global gradient, takes the same
    Ranger update, moves BatchNorm's running statistics, the clip threshold
    and the histogram as one process does."""
    ranks = _two_ranks(tmp_path, 'step', family)
    one = _cases()['step_case'](family, None)
    # each rank preprocessed its own rows of the global batch, draws and all
    torch.testing.assert_close(torch.cat([r['img_in'] for r in ranks]),
                               one['img_in'], rtol=0, atol=0)
    # norms below a millionth of the largest tensor's are noise of zero
    floors = {name: 1e-6 * max(float(torch.linalg.vector_norm(v.double()))
                               for v in one[name].values())
              for name in ('grads', 'updates', 'running')}
    for r in ranks:
        assert set(r['metrics']) == set(one['metrics'])
        for k, v in one['metrics'].items():
            assert r['metrics'][k] == pytest.approx(v, rel=STEP_RTOL), k
        for name in ('grads', 'updates', 'running'):
            assert set(r[name]) == set(one[name])
            for k, v in one[name].items():
                if v.is_floating_point():
                    assert _rel(r[name][k], v, floors[name]) <= STEP_RTOL, \
                        (name, k)
                else:
                    assert torch.equal(r[name][k], v), (name, k)
        assert r['clip'] == pytest.approx(one['clip'], rel=STEP_RTOL)
        if family == 'zebra':
            torch.testing.assert_close(r['histogram'], one['histogram'],
                                       rtol=STEP_RTOL, atol=0)
    assert one['clip'] > 0 and one['metrics']['grad_norm'] > 0
    if family == 'zebra':
        assert not torch.equal(one['histogram'],
                               torch.full_like(one['histogram'], 0.5))


# --------------------------------------------------------------------------
# sharded evaluation
# --------------------------------------------------------------------------

def _quat(R):
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R).as_quat()


@pytest.mark.parametrize('mode', ['float', 'static'])
def test_sharded_run_test_equals_one_rank(tmp_path, mode):
    """harness.run_test over two gloo ranks on batches of 3 (padded to 4)
    and 2 gives every rank the one-process results: the same crops in the
    same order; the weighted poses within B1's tolerance where the RANSAC
    winners agree within it; ADD within lc_tpu's rule; under static int8
    the one-process scales (the max over the ranks of each rank's amax)."""
    ranks = _two_ranks(tmp_path, 'test', mode)
    one = _cases()['test_case'](None, int8_static=mode == 'static')
    if mode == 'static':
        assert one['scales'] and len(one['scales']) > 40
    for r in ranks:
        assert r['scales'] == one['scales']
        agree = 0
        for name in ('ransac', 'weighted'):
            a, b = r['results'][name], one['results'][name]
            assert a['R'].shape == b['R'].shape == (5, 3, 3)
            np.testing.assert_allclose(a['add'], b['add'], rtol=0.03, atol=1.0)
        ra, rb = r['results']['ransac'], one['results']['ransac']
        wa, wb = r['results']['weighted'], one['results']['weighted']
        for i in range(5):
            same_winner = np.abs(ra['t'][i] - rb['t'][i]).max() <= 0.05 and \
                abs(np.dot(_quat(ra['R'][i]), _quat(rb['R'][i]))) >= 1 - 1e-5
            if same_winner:
                agree += 1
                assert np.abs(wa['t'][i] - wb['t'][i]).max() <= 0.05
                assert abs(np.dot(_quat(wa['R'][i]), _quat(wb['R'][i]))) \
                    >= 1 - 1e-5
        assert agree >= 4, agree


# --------------------------------------------------------------------------
# the train and test CLIs over two ranks
# --------------------------------------------------------------------------

CLI_RANK = textwrap.dedent(r'''
    import glob
    import json
    import sys

    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch import train as train_cli

    rank, out, cfg_path, out_dir = sys.argv[1:5]
    argv = ['--config', cfg_path, '--device', 'cpu']
    real = train_cli.train_step
    steps = []

    def recording(*args, **kw):
        state, metrics = real(*args, **kw)
        steps.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    train_cli.train_step = recording
    train_cli.main(argv + ['--output', out_dir + '/train'])
    step2, = glob.glob(out_dir + '/train/syn-1/model_best_2_*.ckpt')
    train_cli.main(argv + ['--output', out_dir + '/resumed', '--ckpt', step2])
    res = test_cli.main(['--weight', out_dir + '/train/syn-1/model_final.ckpt',
                         '--output', out_dir + '/test', '--obj', '1',
                         '--deterministic'] + argv)
    with open(f'{out}/rank{rank}.json', 'w') as f:
        json.dump(dict(steps=steps, scores={k: v['avg_score']
                                            for k, v in res.items()},
                       add={k: [e['add'] for e in v['errors']]
                            for k, v in res.items()}), f)
''')


def _files(root):
    """The files under root (TensorBoard's event files by their kind: their
    names hold the time and the host)."""
    return sorted('events.out.tfevents' if 'tfevents' in f
                  else os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_two_rank_train_and_test_cli(tree, tmp_path):
    """python -m lc_tpu_torch.train and .test as two ranks under torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK;
    gloo, --device cpu), 3 steps of global batch 4 with an evaluation after
    step 2, a run resumed from the step-2 checkpoint, and the test CLI on
    model_final: both ranks see the same losses, scores and ADD; the losses
    are the one-process run's; rank 0 alone wrote the files (the
    one-process run's set, metrics.jsonl two lines, one event file); the
    resumed run repeats step 3; the one-process test CLI and lc_tpu's
    converter read the two-rank model_final."""
    try:
        _two_rank_cli_case(tree, tmp_path)
    finally:   # the runs' checkpoints hold ~0.5 GB each
        for name in ('one', 'two', 'test_one'):
            shutil.rmtree(tmp_path / name, ignore_errors=True)


def _two_rank_cli_case(tree, tmp_path):
    from lc_tpu_torch import train as train_cli
    cfg_path = tmp_path / 'tiny.yaml'
    cfg_path.write_text(yaml.safe_dump(
        tiny_cfg(tree, **{'train.ckpt_every': 100}).to_dict()))
    one = tmp_path / 'one'
    train_cli.main(['--config', str(cfg_path), '--device', 'cpu', '--output',
                    str(one)])
    one_lines = [json.loads(x) for x in
                 (one / 'syn-1' / 'metrics.jsonl').read_text().splitlines()]

    two = tmp_path / 'two'
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(_env(), RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE='2',
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, '-c', CLI_RANK, str(r), str(tmp_path),
             str(cfg_path), str(two)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert 'data-parallel over 2 ranks' in logs[0]
    r0, r1 = (json.loads((tmp_path / f'rank{r}.json').read_text())
              for r in range(2))
    assert r0 == r1
    steps = r0['steps']
    assert len(steps) == 4                 # 3 steps, then the resumed third
    assert steps[3] == steps[2]
    two_lines = [json.loads(x) for x in (two / 'train' / 'syn-1' /
                                         'metrics.jsonl').read_text()
                 .splitlines()]
    assert [m['step'] for m in two_lines] == [1, 3]
    for a, b in zip(two_lines, one_lines):
        assert set(a) == set(b)
        for k in a:
            if a['step'] == 1:
                assert a[k] == pytest.approx(b[k], rel=1e-3), k
            elif k != 'grad_norm':
                assert a[k] == pytest.approx(b[k], rel=5e-3), k
    assert two_lines[-1]['loss'] == steps[2]['loss']
    files = _files(two / 'train')
    assert files == _files(one)
    assert files.count('events.out.tfevents') == 1
    assert len([f for f in _files(two / 'test') if f.endswith('.csv')]) == 1
    assert set(r0['scores']) == {'weighted'} and len(r0['add']['weighted']) == 5

    # the two-rank run's model_final: the keys of a one-process run (no
    # wrapper's prefix), read by the one-process test CLI and lc_tpu's
    # converter
    from lc_tpu.models.torch_port import port_cdpn_checkpoint
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch.utils.checkpoint import model_state_dict
    final = two / 'train' / 'syn-1' / 'model_final.ckpt'
    sd = model_state_dict(str(final))
    assert list(sd) == list(model_state_dict(str(one / 'syn-1' /
                                                 'model_final.ckpt')))
    params, stats = port_cdpn_checkpoint({k: v.numpy() for k, v in sd.items()})
    assert set(params) == {'net', 'weight_scale_layer'} and stats
    res = test_cli.main(['--weight', str(final), '--config', str(cfg_path),
                         '--output', str(tmp_path / 'test_one'), '--obj', '1',
                         '--device', 'cpu', '--deterministic'])
    assert len(res['weighted']['errors']) == 5
