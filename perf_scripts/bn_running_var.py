"""Scores of a trained checkpoint with BatchNorm's running variance as torch
keeps it and as flax (lc_tpu) keeps it.

    python3 perf_scripts/bn_running_var.py --config configs/zsyn.yaml \\
        --weight learned_out/zsyn/train/zsyn-1/model_final.ckpt --output DIR \\
        [--device cpu] [--opts k=v ...]

torch's BatchNorm moves its running variance by the unbiased batch variance
(times n / (n - 1), n the values a channel normalizes in a training step),
flax's by the biased one. Only evaluation reads the running statistics, so
the difference is a per-layer factor on them: this script finds n of every
BatchNorm from one training-mode forward at the config's batch and input
size, and scores the checkpoint with `python -m lc_tpu_torch.test`'s main
(in process, --deterministic --obj 1, from the repository's root) twice: as
trained ('unbiased'), and with every running variance times (n - 1) / n
('biased', what lc_tpu's training would have kept from the same batches).
Prints the layers whose factor is below 0.999 and one JSON line per variant
and solver: the five scores of the test CLI's results, in percent.
Imports no jax and nothing of lc_tpu.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCORES = ('AUCadi_10_p11', 'AUCad_10_p11', 'AUCadi_10_all', 'AUCad_10_all',
          'add(-s)_0.10')


def values_per_channel(model, batch: int, in_wh) -> dict:
    """{BatchNorm's name: values per channel it normalizes} in one
    training-mode forward of a (batch, H, W, 3) input, as the
    networks take it."""
    import torch
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, args, out, name=name: seen.__setitem__(
            name, args[0].numel() // args[0].shape[1]))
        for name, m in model.named_modules()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    model.train()
    with torch.no_grad():
        model(torch.zeros(batch, in_wh[1], in_wh[0], 3))
    for h in hooks:
        h.remove()
    return seen


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', required=True)
    parser.add_argument('--weight', required=True)
    parser.add_argument('--output', required=True)
    parser.add_argument('--device', default=None)
    parser.add_argument('--opts', nargs='+', default=[])
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    from lc_tpu_torch import harness
    from lc_tpu_torch import test as test_cli
    from lc_tpu_torch.data.pipeline import BOPDataset
    from lc_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, args.opts or None)
    bit_cnt = BOPDataset(cfg.test_dataset, cfg, train=False).bit_cnt
    model = harness.build_model_from_cfg(cfg, sum(bit_cnt) if bit_cnt else 0)
    sd = test_cli.load_weights(args.weight, cfg)
    n = values_per_channel(model, cfg.dataloader.batch_size, cfg.net_input_wh)
    biased = dict(sd)
    for name, count in n.items():
        biased[f'{name}.running_var'] = sd[f'{name}.running_var'] * (
            (count - 1) / count)
        if (count - 1) / count < 0.999:
            print(json.dumps(dict(layer=name, n=count,
                                  factor=(count - 1) / count)), flush=True)
    os.makedirs(args.output, exist_ok=True)
    for variant, state in (('unbiased', sd), ('biased', biased)):
        weight = osp.join(args.output, f'{variant}.pth')
        torch.save(state, weight)
        cli = ['--config', args.config, '--weight', weight, '--output',
               osp.join(args.output, variant), '--obj', '1', '--deterministic']
        if args.opts:
            cli += ['--opts', *args.opts]
        if args.device:
            cli += ['--device', args.device]
        results = test_cli.main(cli)
        for solver, res in results.items():
            score = res['per_obj_score'][1]
            print(json.dumps(dict(
                weight=args.weight, variant=variant, solver=solver,
                **{k: round(100 * score[k], 2) for k in SCORES})), flush=True)


if __name__ == '__main__':
    main()
