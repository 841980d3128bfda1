"""perf_scripts/learned_syn.py, which runs the port's learned results, on
the CPU at a tiny size: its JSON lines carry the test CLI's score table, a
second call skips what is done, and a cut training run is taken up again
with the train CLI's --resume. Also the learning-rate schedule of the
3000-step recipes through both packages' factories."""
import importlib.util
import json
import math
import os
import os.path as osp
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCRIPT = osp.join(ROOT, 'perf_scripts', 'learned_syn.py')
ARM = 'syn-s43'     # syn's recipe at seed 43, its one evaluation f32
# 64² in, 16² out, batch 4, 2 steps with a checkpoint after each; 16²
# crops need a lower valid-pixel threshold than the default
TINY = ['net_input_wh=[64,64]', 'net_output_wh=[16,16]',
        'dataloader.batch_size=4', 'dataloader.num_workers=2',
        'train.num_steps=2', 'train.ckpt_every=1',
        'train_dataset.valid_pix_cnt_th=30']


def load_script():
    spec = importlib.util.spec_from_file_location('learned_syn', SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_argv(root):
    return ['--arm', ARM, '--root', str(root), '--views', '24/8',
            '--device', 'cpu', '--opts', *TINY]


@pytest.fixture(scope='module')
def script():
    return load_script()


@pytest.fixture(scope='module')
def done(tmp_path_factory, script):
    """One finished tiny arm: (root, its outputs, its JSON lines)."""
    root = tmp_path_factory.mktemp('learned')
    lines = script.main(script_argv(root))
    return root, root / 'learned_out', lines


def test_lines_equal_the_test_cli_scores(done, script, monkeypatch):
    """Each line's scores are the test CLI's for its solver, as its table
    prints them (percent, two decimals), on the same model_final; the
    line names the arm's recipe and the training's numbers."""
    from lc_tpu_torch import test as test_cli
    root, out, lines = done
    run = out / ARM / 'train' / f'{ARM}-1'
    monkeypatch.chdir(root)     # the config's dataset paths are relative
    results = test_cli.main([
        '--config', osp.join(ROOT, 'configs/syn.yaml'),
        '--weight', str(run / 'model_final.ckpt'),
        '--output', str(root / 'again'), '--obj', '1', '--deterministic',
        '--device', 'cpu', '--opts', *TINY])
    assert sorted(line['solver'] for line in lines) == sorted(results)
    for line in lines:
        assert json.loads(json.dumps(line)) == line
        score = results[line['solver']]['per_obj_score'][1]
        for key in script.SCORES:
            want = round(100 * score[key], 2)
            assert line[key] == (None if math.isnan(want) else want), key
        assert (line['arm'], line['config'], line['seed'], line['steps'],
                line['batch'], line['eval'], line['device']) == \
            (ARM, 'configs/syn.yaml', 43, 2, 4, 'f32', 'cpu')
        assert line['test_views'] == 8 and line['test_batches'] == 2
        assert line['train_attempts'] == 1 and line['train_wall_s'] > 0
        assert line['loop_crops_per_s'] > 0
        # the CPU launches no kernel
        assert set(line['launches']['eval'].values()) == {0}
    with open(run / 'metrics.jsonl') as f:
        assert [json.loads(s)['step'] for s in f] == [1, 2]


def test_second_call_skips_finished_steps(done, script, capsys):
    """Run again, the script trains and evaluates nothing: it prints the
    same lines from what the first call left."""
    root, out, lines = done
    run = out / ARM / 'train' / f'{ARM}-1'
    before = {p: p.stat().st_mtime_ns for p in out.rglob('*')}
    capsys.readouterr()
    again = script.main(script_argv(root))
    assert again == lines
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] \
        == lines
    assert {p: p.stat().st_mtime_ns for p in out.rglob('*')} == before
    assert (run / 'model_final.ckpt').exists()


def test_cut_training_resumes(done, script, tmp_path):
    """A script killed after the train CLI's first checkpoint, run again,
    takes the run up with --resume from step 1: the same model_final and
    the same scores as the uninterrupted run."""
    from lc_tpu_torch.utils.checkpoint import model_state_dict
    _, out, lines = done
    root = tmp_path
    cut = root / 'learned_out'
    run = cut / ARM / 'train' / f'{ARM}-1'
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.Popen([sys.executable, SCRIPT, *script_argv(root)],
                         env=env, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL, start_new_session=True)
    try:
        t0 = time.monotonic()
        while not (run / 'ckpts' / '000000001.ckpt').exists():
            assert p.poll() is None, 'learned_syn.py ended before step 1'
            assert time.monotonic() - t0 < 120
            time.sleep(0.01)
    finally:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    assert not (run / 'model_final.ckpt').exists()
    resumed = script.main(script_argv(root))
    with open(run / 'log.txt') as f:
        assert 'resumed from step 1' in f.read()
    record = json.load(open(cut / ARM / 'train.json'))
    assert record['attempts'] == 2
    a = model_state_dict(str(run / 'model_final.ckpt'))
    b = model_state_dict(str(out / ARM / 'train' / f'{ARM}-1'
                             / 'model_final.ckpt'))
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert torch.equal(a[k], v), k
    keys = script.SCORES + ('solver', 'eval', 'steps')
    assert [{k: r[k] for k in keys} for r in resumed] == \
        [{k: r[k] for k in keys} for r in lines]


@pytest.mark.parametrize('extra', [[], TINY], ids=['recipe', 'tiny'])
def test_cli_argv_of_every_arm(script, extra):
    """The CLIs' argument lists of every arm and evaluation, with and
    without --opts of the caller: each option's values parse (an arm with no
    options of its own passes no empty --opts), the arm's options come
    first, and only the cpu evaluation (or --device cpu) leaves the card."""
    import argparse
    parser = argparse.ArgumentParser()
    for flag in ('--config', '--output', '--name', '--weight', '--device'):
        parser.add_argument(flag)
    parser.add_argument('--obj', nargs='+')
    parser.add_argument('--opts', nargs='+')
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--deterministic', action='store_true')
    paths = dict(arm='out/a', train='out/a/train', run='out/a/train/a-1')
    for device in (None, 'cpu'):
        args = script.parse_args(['--arm', 'zsyn'] + (
            ['--device', device] if device else []) + (
            ['--opts', *extra] if extra else []))
        for arm, (config, _, opts, evals) in script.ARMS.items():
            got = parser.parse_args(script.train_argv(arm, paths, args))
            assert got.resume and got.config.endswith(config)
            assert (got.opts or []) == [*opts, *extra]
            assert got.device == device
            for kind in evals:
                got = parser.parse_args(
                    script.eval_argv(arm, kind, paths, args))
                assert got.deterministic and got.obj == ['1']
                assert (got.opts or []) == [*script.EVAL_OPTS[kind], *extra]
                assert got.device == ('cpu' if kind == 'cpu' else device)


def test_score_rows_reads_the_logged_table(script):
    """The table parser takes each solver's Avg row, the last table of a
    solver winning; nan reads as nan."""
    from lc_tpu_torch.eval.evaluator import gen_score_table
    text = ''
    for scale in (1.0, 0.5):
        per_obj = {1: {'AUCadi_10_p11': 0.832 * scale, 'AUCad_10_p11': 0.668,
                       'AUCadi_10_all': float('nan'), 'AUCad_10_all': 0.5,
                       'add(-s)_0.10': 0.06}}
        for name in ('ransac', 'weighted'):
            text += ('12:00:00 INFO lc_tpu_torch.test: \n' + name + '\n'
                     + gen_score_table(per_obj)[0] + '\n')
    rows = script.score_rows(text)
    assert sorted(rows) == ['ransac', 'weighted']
    assert rows['weighted']['AUCadi_10_p11'] == 41.6
    assert rows['ransac']['add(-s)_0.10'] == 6.0
    assert math.isnan(rows['ransac']['AUCadi_10_all'])


def test_loop_rate_over_a_resumed_log(script):
    """Loop crops/s is the logged steps' crops over their windows' seconds,
    a resumed run's windows counted from its resumed step."""
    log = '\n'.join([
        'x: step 1/60  loss=1.0  (8.0 crops/s)',
        'x: step 20/60  loss=1.0  (38.0 crops/s)',
        'x: resumed from step 20',
        'x: step 40/60  loss=1.0  (40.0 crops/s)',
        'x: step 60/60  loss=1.0  (80.0 crops/s)'])
    rate, steps = script.loop_rate(log, batch=2)
    assert steps == 60
    assert rate == pytest.approx(120 / (2 / 8 + 38 / 38 + 40 / 40 + 40 / 80))


@pytest.mark.parametrize('config', ['syn', 'zsyn', 'gspsyn'])
def test_recipe_schedule_matches_lc_tpu(config):
    """The learning-rate factor of each recipe's 3000 steps (gspsyn: linear
    warmup over 100 steps, flat, cosine from 72%) through both packages'
    build_schedule, at every step."""
    import jax.numpy as jnp
    from lc_tpu.optim.factory import build_schedule as j_build_schedule
    from lc_tpu_torch.optim.factory import build_schedule
    from lc_tpu_torch.utils.config import load_config
    cfg = load_config(osp.join(ROOT, 'configs', f'{config}.yaml'),
                      ['train.num_steps=3000'])
    mine = build_schedule(cfg.scheduler, cfg.train.num_steps)
    ref = j_build_schedule(cfg.scheduler.to_dict(), cfg.train.num_steps)
    steps = np.arange(cfg.train.num_steps + 2)
    got = np.array([mine(int(i)) for i in steps], np.float64)
    want = np.broadcast_to(np.asarray(ref(jnp.asarray(steps)), np.float64),
                           got.shape)
    # lc_tpu evaluates the cosine in float32: 6e-8 is its unit's spacing
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=6e-8)
    if config == 'gspsyn':
        assert got[0] < 0.01 and got[1000] == 1.0 and got[3000] < 1e-6
