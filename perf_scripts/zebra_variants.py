"""Train a recipe with one numerical departure of the port from lc_tpu
patched in from outside the package, and score its model_final.

    python3 perf_scripts/zebra_variants.py VARIANT --config configs/zsyn.yaml \\
        --output DIR [--seed 42] [--device cpu] [--opts k=v ...]

VARIANT is one of
  f32_convs       every convolution in float32 (the port trains with bf16
                  convolutions on the card, as lc_tpu does);
  flax_batchnorm  BatchNorm in training as flax computes it: the one-pass
                  batch variance max(E[x²] − E[x]², 0), and the running
                  variance moved by that biased variance (the port: torch's
                  two-pass variance, the running one unbiased).
The train CLI (`python -m lc_tpu_torch.train --config CONFIG --output
DIR/train --name VARIANT --obj 1 --opts train.seed=SEED`) runs in this
process with the variant patched in; then `python -m lc_tpu_torch.test
--deterministic --obj 1` scores model_final as the port is, in a process of
its own. Prints one JSON line per solver: the variant, seed, the five
scores from the test CLI's table (perf_scripts/learned_syn.py's reading)
and the card's name and power limit. Run it from the repository's root (the
configs' dataset paths are relative to it; learned_syn.py generates the
trees). Imports no jax and nothing of lc_tpu.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, osp.join(REPO, 'perf_scripts'))


def f32_convs():
    import torch
    from lc_tpu_torch import train
    train.default_compute_dtype = lambda device: torch.float32


def flax_batchnorm():
    import torch
    from lc_tpu_torch.models import layers
    native = layers.BatchNorm2d.forward

    def forward(self, x):
        if not self.training:
            return native(self, x)
        x = layers.at_least_f32(x)
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean * m)
            self.running_var.mul_(1 - m).add_(var * m)
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        return (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(
            shape) * self.weight.view(shape) + self.bias.view(shape)
    layers.BatchNorm2d.forward = forward


VARIANTS = {'f32_convs': f32_convs, 'flax_batchnorm': flax_batchnorm}


def main():
    import learned_syn
    parser = argparse.ArgumentParser()
    parser.add_argument('variant', choices=sorted(VARIANTS))
    parser.add_argument('--config', required=True)
    parser.add_argument('--output', required=True)
    parser.add_argument('--seed', type=int, default=42)
    parser.add_argument('--device', default=None,
                        help='cpu runs both CLIs on the CPU')
    parser.add_argument('--opts', nargs='+', default=[],
                        help='more options of both CLIs (tests shrink sizes)')
    args = parser.parse_args()
    dev = ['--device', args.device] if args.device else []
    VARIANTS[args.variant]()
    from lc_tpu_torch import train
    from lc_tpu_torch.utils.config import load_config
    run = osp.join(args.output, 'train')
    train.main(['--config', args.config, '--output', run, '--name',
                args.variant, '--obj', '1', '--opts',
                f'train.seed={args.seed}', *args.opts, *dev])
    weight = osp.join(run, f'{args.variant}-1', 'model_final.ckpt')
    out = osp.join(args.output, 'eval')
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, '-m', 'lc_tpu_torch.test', '--config',
                    args.config, '--weight', weight, '--output', out,
                    '--obj', '1', '--deterministic', *dev]
                   + (['--opts', *args.opts] if args.opts else []),
                   check=True, env=env)
    cfg = load_config(args.config, args.opts or None)
    cfg_name = osp.splitext(osp.basename(args.config))[0]
    with open(osp.join(out, f'{cfg_name}_{cfg.train_dataset.name}'
                            '_test_1.log')) as f:
        table = learned_syn.score_rows(f.read())
    card = learned_syn.card_line()
    for solver, row in table.items():
        print(json.dumps(dict(variant=args.variant, config=args.config,
                              seed=args.seed, solver=solver,
                              **{k: row[k] for k in learned_syn.SCORES},
                              card=card)), flush=True)


if __name__ == '__main__':
    main()
