"""Run-to-run spread of the glmo train CLI's step metrics on the card.

    python3 perf_scripts/train_cli_rerun_spread.py [--reps N] [OTHER_CHECKOUT]

Runs `python -m lc_tpu_torch.train`'s main at glmo's widths (6 steps of a
batch of 32, device_rotate, an evaluation after step 3) on one generated
tree N times (3 by default) each: this checkout's loop, the same with
train.PREFETCH_BATCHES = 0 (no device prefetch), and, when a path is given,
the lc_tpu_torch of another checkout (e.g. `git archive` of an earlier
commit), every run in a process of its own. Prints each run's
metrics.jsonl and the spread (max - min over the mean) of steps 1 and 6's
loss and grad_norm within each variant and across all. Needs a CUDA card;
run it from the repository's root."""
import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402

RUN = r'''
import sys
sys.path.insert(0, sys.argv[1])
from lc_tpu_torch import train
if sys.argv[4] == '0':
    train.PREFETCH_BATCHES = 0
train.main(['--config', sys.argv[2], '--output', sys.argv[3]])
'''


def main():
    import chip_smoke as cs
    parser = argparse.ArgumentParser()
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('other', nargs='?')
    args = parser.parse_args()
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        spread(cs, tmp, args.reps, args.other)


def spread(cs, tmp, reps: int, other: str | None):
    import yaml
    from lc_tpu_torch.data import synthetic
    root = os.path.join(tmp, 'data')
    synthetic.generate_dataset(root, n_images=32, split='train_syn', seed=3)
    synthetic.generate_dataset(root, n_images=8, split='test_syn', seed=4,
                               list_name='test_list.txt')
    cfg = cs.family_train_cfg('glmo')
    del cfg.train['num_epochs']
    cfg.merge_from_dict({
        'train.num_steps': 6, 'train.test_every': 3, 'train.ckpt_every': 100,
        'train_dataset.name': 'synthetic', 'train_dataset.dataset_root': root,
        'train_dataset.list_files': [os.path.join(root, 'train_syn_list.txt')],
        'train_dataset.bg_dir': '', 'test_dataset.name': 'synthetic',
        'test_dataset.dataset_root': root, 'test_dataset.detection': '',
        'test_dataset.list_files': [os.path.join(root, 'test_list.txt')]})
    cfg_path = os.path.join(tmp, 'glmo_syn.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg.to_dict(), f)
    here = os.getcwd()
    variants = [('prefetch', here, '2'), ('inline', here, '0')]
    if other:
        variants.insert(0, ('other', os.path.abspath(other), '2'))
    out = {}
    for rep in range(reps):
        for name, repo, pf in variants:
            o = os.path.join(tmp, f'{name}{rep}')
            r = subprocess.run([sys.executable, '-c', RUN, repo, cfg_path, o,
                                pf], capture_output=True, text=True)
            if r.returncode:
                print(r.stderr[-3000:])
                raise SystemExit(1)
            with open(os.path.join(o, 'glmo-1', 'metrics.jsonl')) as f:
                lines = [json.loads(x) for x in f]
            out.setdefault(name, []).append(lines)
            print(name, rep, json.dumps(lines), flush=True)
    allruns = [x for v in out.values() for x in v]
    for step_i in (0, 1):
        for k in ('loss', 'grad_norm'):
            vals = {n: [r[step_i][k] for r in v] for n, v in out.items()}
            every = np.array([r[step_i][k] for r in allruns])
            print(f'step {allruns[0][step_i]["step"]} {k}: spread within '
                  + ', '.join(f'{n} {(max(v) - min(v)) / np.mean(v):.2e}'
                              for n, v in vals.items())
                  + f'; across all {np.ptp(every) / every.mean():.2e}')


if __name__ == '__main__':
    main()
