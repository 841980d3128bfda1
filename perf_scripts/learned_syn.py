"""Learned results of lc_tpu_torch: the three synthetic families trained for
3000 steps and scored, through the port's two CLIs.

    python3 perf_scripts/learned_syn.py --arm ARM [--root DIR]
        [--views 400/50] [--device cpu] [--opts k=v ...]

ARM is one of ARMS below. An arm generates its tree under ROOT/datasets if
it is missing (lc_tpu_torch.data.synthetic, by the recipes in the headers
of configs/zsyn.yaml and configs/gspsyn.yaml: 400 training views of seed 0,
50 held-out views of seed 5), trains with `python -m lc_tpu_torch.train`
on the config and the arm's --opts, then scores model_final with
`python -m lc_tpu_torch.test --deterministic --obj 1` once for each of its
evaluations:
  f32           on the card (the CNN's convolutions in bf16, as training);
  int8_dynamic  --opts int8_inference=true;
  int8_static   --opts int8_inference=true int8_act_scales=static;
  cpu           --device cpu on the same checkpoint.
Both CLIs run as subprocesses from ROOT (the configs' dataset paths are
relative to it; ROOT defaults to the repository's root) through RUNNER,
which runs the module as `python -m` does and then writes the launches of
the three CUDA kernels in that process to a file.

Each evaluation prints one JSON line per solver row of the test CLI's
score table: the arm, config, seed, steps, batch, the evaluation's kind,
the solver, the five scores read from the table the test CLI logged (in
percent, as printed there; null for nan), the training's wall seconds and loop crops/s
(from the train CLI's own log: the crops of its logged steps over the
seconds their windows took), the kernels' launches in training and in the
evaluation, the evaluation's batches and wall seconds, and the card's name
and power limit as nvidia-smi gives them (null without nvidia-smi).

Outputs go under ROOT/learned_out/ARM. The script can be restarted: a
finished tree, training or evaluation is skipped (its lines are printed
again from what it left), and a training run that was
cut goes on from its newest checkpoint with the train CLI's own --resume.
--opts are appended to the arm's options in both CLIs (later keys win:
tests shrink widths and steps with them); --device cpu runs everything on
the CPU. Imports no jax and nothing of lc_tpu.
"""
from __future__ import annotations

import argparse
import fcntl
import json
import math
import os
import os.path as osp
import pickle
import re
import subprocess
import sys
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

SYN_OPTS = ('train.num_steps=3000', 'train.test_every=0',
            'train.ckpt_every=1000')
ALL_EVALS = ('f32', 'int8_dynamic', 'int8_static', 'cpu')
EVAL_OPTS = {'f32': (), 'cpu': (),
             'int8_dynamic': ('int8_inference=true',),
             'int8_static': ('int8_inference=true', 'int8_act_scales=static')}
# config, tree, the train CLI's --opts, evaluations of model_final
ARMS = {
    'syn-s42': ('configs/syn.yaml', 'synthetic',
                SYN_OPTS + ('train.seed=42',), ALL_EVALS),
    'syn-s43': ('configs/syn.yaml', 'synthetic',
                SYN_OPTS + ('train.seed=43',), ('f32',)),
    'syn-s44': ('configs/syn.yaml', 'synthetic',
                SYN_OPTS + ('train.seed=44',), ('f32',)),
    'syn-s42-rot': ('configs/syn.yaml', 'synthetic',
                    SYN_OPTS + ('train.seed=42', 'dataloader.device_rotate=true'),
                    ('f32',)),
    'zsyn': ('configs/zsyn.yaml', 'synthetic_sym', (), ALL_EVALS),
    # the zebra recipe under two more seeds: its run-to-run spread
    'zsyn-s43': ('configs/zsyn.yaml', 'synthetic_sym', ('train.seed=43',),
                 ('f32',)),
    'zsyn-s44': ('configs/zsyn.yaml', 'synthetic_sym', ('train.seed=44',),
                 ('f32',)),
    'gspsyn': ('configs/gspsyn.yaml', 'synthetic', (), ('f32', 'cpu')),
}
SCORES = ('AUCadi_10_p11', 'AUCad_10_p11', 'AUCadi_10_all', 'AUCad_10_all',
          'add(-s)_0.10')
TRAIN_SEED, TEST_SEED = 0, 5
BOX_HALF_EXTENTS = (40.0, 30.0, 20.0)
SPARSE_KEYPOINTS = 16

# runs `python -m MODULE ARGS...` and writes the kernels' launches in this
# process to COUNTS: python -c RUNNER MODULE COUNTS ARGS...
RUNNER = r'''
import json, runpy, sys
module, counts = sys.argv[1], sys.argv[2]
sys.argv = [module] + sys.argv[3:]
try:
    runpy.run_module(module, run_name='__main__', alter_sys=True)
finally:
    from lc_tpu_torch.ops.warp import shear_x_cuda
    from lc_tpu_torch.pnp.lm_kernel import lm_refine_cuda
    from lc_tpu_torch.pnp.minimal6_kernel import minimal6_cuda
    with open(counts, 'w') as f:
        json.dump({'lm_refine': lm_refine_cuda.launches,
                   'minimal6': minimal6_cuda.launches,
                   'shear_x': shear_x_cuda.launches}, f)
'''

STEP_LINE = re.compile(r'step (\d+)/\d+ .*\(([0-9.]+) crops/s\)')
RESUMED_LINE = re.compile(r'resumed from step (\d+)')


def card_line() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, or
    None where there is no nvidia-smi."""
    try:
        p = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip() if p.returncode == 0 else None


def ensure_tree(root: str, name: str, views: tuple[int, int]) -> str:
    """ROOT/datasets/NAME with views[0] training and views[1] held-out
    views, generated once (under a lock, so arms started together share
    it); the sparse keypoints' fps.pkl beside the plain tree."""
    from lc_tpu_torch.data import synthetic
    d = osp.join(root, 'datasets', name)
    os.makedirs(osp.join(root, 'datasets'), exist_ok=True)
    with open(d + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        lists = {osp.join(d, 'train_syn_list.txt'): views[0],
                 osp.join(d, 'test_list.txt'): views[1]}
        have = {p: sum(1 for _ in open(p)) if osp.exists(p) else None
                for p in lists}
        if all(have[p] is not None for p in lists):
            if have != lists:
                raise SystemExit(f'{d} holds {list(have.values())} views, not '
                                 f'{list(views)}: remove it or pass --views')
        else:
            symmetric = name == 'synthetic_sym'
            synthetic.generate_dataset(d, n_images=views[1], split='test_syn',
                                       seed=TEST_SEED, symmetric=symmetric,
                                       list_name='test_list.txt')
            # the training list last: its presence marks a finished tree
            synthetic.generate_dataset(d, n_images=views[0], split='train_syn',
                                       seed=TRAIN_SEED, symmetric=symmetric)
        fps = osp.join(d, 'fps.pkl')
        if name == 'synthetic' and not osp.exists(fps):
            import numpy as np
            pts = synthetic.box_surface_points(np.array(BOX_HALF_EXTENTS),
                                               SPARSE_KEYPOINTS)
            with open(fps + '.part', 'wb') as f:
                pickle.dump({1: pts.astype(np.float32)}, f)
            os.replace(fps + '.part', fps)
    return d


def run_cli(module: str, args: list, counts: str, cwd: str, log: str) -> float:
    """`python -m module args` through RUNNER from cwd, its output into
    log; returns its wall seconds. Raises when it fails."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep) if p])
    t0 = time.perf_counter()
    with open(log, 'a') as f:
        p = subprocess.run([sys.executable, '-c', RUNNER, module, counts,
                            *args], cwd=cwd, env=env, stdout=f,
                           stderr=subprocess.STDOUT)
    seconds = time.perf_counter() - t0
    if p.returncode:
        raise SystemExit(f'python -m {module} exited {p.returncode}; see {log}')
    return seconds


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def write_json(path: str, obj):
    with open(path + '.part', 'w') as f:
        json.dump(obj, f)
    os.replace(path + '.part', path)


def add_counts(total: dict, path: str) -> dict:
    got = read_json(path) if osp.exists(path) else {}
    return {k: total.get(k, 0) + got.get(k, 0)
            for k in ('lm_refine', 'minimal6', 'shear_x')}


def loop_rate(log_text: str, batch: int) -> tuple[float, int]:
    """(loop crops/s, steps) over the train CLI's logged windows: each
    'step N/M ... (R crops/s)' line covers the steps since the line before
    it (or since the start or the resumed step), at R crops/s."""
    prev, crops, seconds = 0, 0, 0.0
    for line in log_text.splitlines():
        m = RESUMED_LINE.search(line)
        if m:
            prev = int(m.group(1))
            continue
        m = STEP_LINE.search(line)
        if m:
            step, rate = int(m.group(1)), float(m.group(2))
            n = (step - prev) * batch
            crops, seconds, prev = crops + n, seconds + n / rate, step
    return (crops / seconds if seconds else float('nan')), crops // batch


def score_rows(log_text: str) -> dict:
    """{solver: {column: value}} from the last score table of each solver
    in the test CLI's log: a line with the solver's name, the header row
    ('object' and the score names), the objects' rows and 'Avg(n)', whose
    values (percent, as printed) are taken."""
    lines = log_text.splitlines()
    rows = {}
    for i, line in enumerate(lines):
        head = line.split()
        if not head or head[0] != 'object' or i == 0:
            continue
        solver = lines[i - 1].strip()
        for row in lines[i + 1:]:
            cells = row.split()
            if cells and cells[0].startswith('Avg('):
                rows[solver] = {k: float(v) for k, v in zip(head[1:], cells[1:])}
                break
    return rows


def train_arm(arm: str, cfg, paths: dict, args) -> dict:
    """Train (or take up a cut run again), unless model_final exists;
    returns the training's record."""
    record = osp.join(paths['arm'], 'train.json')
    final = osp.join(paths['run'], 'model_final.ckpt')
    if osp.exists(record) and osp.exists(final):
        return read_json(record)
    attempts = osp.join(paths['arm'], 'train_attempts.json')
    done = read_json(attempts) if osp.exists(attempts) else dict(
        wall_s=0.0, attempts=0, launches={})
    attempt = done['attempts'] + 1
    counts = osp.join(paths['arm'], f'train_counts_{attempt}.json')
    done['attempts'] = attempt
    write_json(attempts, done)
    seconds = run_cli('lc_tpu_torch.train', train_argv(arm, paths, args),
                      counts, args.root, osp.join(paths['arm'], 'train_cli.log'))
    if not osp.exists(final):
        # resumed from a checkpoint at the last step: the CLI returns
        # without its export (lc_tpu.train does the same)
        raise SystemExit(f'{paths["run"]} holds no model_final.ckpt after '
                         'the train CLI; its newest checkpoint is at the '
                         'last step: remove it and run again')
    done['wall_s'] += seconds
    done['launches'] = add_counts(done['launches'], counts)
    with open(osp.join(paths['run'], 'log.txt')) as f:
        rate, steps = loop_rate(f.read(), cfg.dataloader.batch_size)
    done.update(loop_crops_per_s=rate, logged_steps=steps)
    write_json(record, done)
    return done


def evaluate(arm: str, kind: str, cfg, paths: dict, trained: dict,
             card: str | None, args) -> list[dict]:
    """One evaluation of model_final (skipped when its lines exist);
    returns its JSON lines, one per solver."""
    config, _, _, _ = ARMS[arm]
    out = osp.join(paths['arm'], f'eval_{kind}')
    lines_path = out + '.json'
    if osp.exists(lines_path):
        return read_json(lines_path)
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):       # a cut evaluation's leftovers
        os.remove(osp.join(out, f))
    counts = out + '_counts.json'
    device = 'cpu' if kind == 'cpu' else args.device
    seconds = run_cli('lc_tpu_torch.test', eval_argv(arm, kind, paths, args),
                      counts, args.root, osp.join(out, 'test_cli.log'))
    cfg_name = osp.splitext(osp.basename(config))[0]
    log_name = f'{cfg_name}_{cfg.train_dataset.name}_test_1.log'
    with open(osp.join(out, log_name)) as f:
        table = score_rows(f.read())
    if not table:
        raise SystemExit(f'no score table in {osp.join(out, log_name)}')
    n_test = sum(1 for _ in open(osp.join(
        args.root, cfg.test_dataset.list_files[0])))
    lines = [dict(
        arm=arm, config=config, seed=int(cfg.train.get('seed', 42)),
        steps=int(cfg.train.num_steps), batch=int(cfg.dataloader.batch_size),
        eval=kind, device=device or 'cuda', solver=solver,
        **{k: None if math.isnan(row[k]) else row[k] for k in SCORES},
        train_wall_s=trained['wall_s'], train_attempts=trained['attempts'],
        loop_crops_per_s=trained['loop_crops_per_s'],
        eval_wall_s=seconds, test_views=n_test,
        test_batches=math.ceil(n_test / cfg.dataloader.batch_size),
        launches=dict(train=trained['launches'], eval=add_counts({}, counts)),
        card=card) for solver, row in table.items()]
    write_json(lines_path, lines)
    return lines


def train_argv(arm: str, paths: dict, args) -> list:
    """The train CLI's arguments for the arm (always --resume: a run with
    no checkpoint yet starts fresh)."""
    config, _, opts, _ = ARMS[arm]
    return ['--config', osp.join(REPO, config), '--output', paths['train'],
            '--name', arm, '--obj', '1', '--resume',
            *opts_argv([*opts, *args.opts]), *device_argv(args.device)]


def eval_argv(arm: str, kind: str, paths: dict, args) -> list:
    """The test CLI's arguments for one evaluation of model_final."""
    config = ARMS[arm][0]
    return ['--config', osp.join(REPO, config), '--weight',
            osp.join(paths['run'], 'model_final.ckpt'), '--output',
            osp.join(paths['arm'], f'eval_{kind}'), '--obj', '1',
            '--deterministic', *opts_argv([*EVAL_OPTS[kind], *args.opts]),
            *device_argv('cpu' if kind == 'cpu' else args.device)]


def opts_argv(opts: list) -> list:
    """--opts takes one value or more: none, no flag."""
    return ['--opts', *opts] if opts else []


def device_argv(device: str | None) -> list:
    return ['--device', device] if device else []


def run_arm(arm: str, args) -> list[dict]:
    """The arm's tree, training and evaluations; returns its JSON lines,
    each printed as soon as it is known."""
    from lc_tpu_torch.utils.config import load_config
    config, tree, opts, evals = ARMS[arm]
    ensure_tree(args.root, tree, args.views)
    cfg = load_config(osp.join(REPO, config), [*opts, *args.opts])
    paths = dict(arm=osp.join(args.out, arm),
                 train=osp.join(args.out, arm, 'train'))
    paths['run'] = osp.join(paths['train'], f'{arm}-1')
    os.makedirs(paths['arm'], exist_ok=True)
    trained = train_arm(arm, cfg, paths, args)
    card = card_line()
    lines = []
    for kind in evals:
        for line in evaluate(arm, kind, cfg, paths, trained, card, args):
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--arm', required=True, choices=sorted(ARMS))
    parser.add_argument('--root', default=REPO,
                        help='holds datasets/ and is the CLIs\' working '
                        'directory (default: the repository)')
    parser.add_argument('--views', default='400/50',
                        help='training/held-out views of a generated tree')
    parser.add_argument('--device', default=None,
                        help='cpu runs both CLIs on the CPU')
    parser.add_argument('--opts', nargs='+', default=[])
    args = parser.parse_args(argv)
    args.root = osp.abspath(args.root)
    args.out = osp.join(args.root, 'learned_out')
    args.views = tuple(int(v) for v in args.views.split('/'))
    return args


def main(argv=None) -> list[dict]:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return run_arm((args := parse_args(argv)).arm, args)


if __name__ == '__main__':
    main()
