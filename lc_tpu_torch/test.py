"""Evaluation entry point (counterpart of lc_tpu/test.py):

    python -m lc_tpu_torch.test --weight model.pth --config configs/glmo.yaml \\
        --output out --obj 1 [--opts ...] [--deterministic] [--device cpu]
    torchrun --nproc_per_node N -m lc_tpu_torch.test ...   (sharded)

--weight takes a .pth/.pt state dict in the reference layout, or a .ckpt
written by lc_tpu_torch.train or by lc_tpu.train (model_final.ckpt,
model_best_*.ckpt or a training checkpoint; told apart by their envelope).
Runs on CUDA unless --device cpu is given. Under torchrun the evaluation
is sharded over the ranks (harness.run_test), each holding every pose of
the run; rank 0 alone writes the log file and the CSVs.
"""
from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import pickle
import zipfile

import torch

from . import harness
from .eval.evaluator import csv_from_results
from .models.weights import state_dict_from_flax
from .parallel import mesh
from .utils import flax_ckpt
from .utils.checkpoint import model_state_dict
from .utils.config import load_config
from .utils.logging import setup_logger

logger = logging.getLogger(__name__)


def load_reference_state_dict(path: str) -> dict:
    """A .pth/.pt in the reference layout -> state_dict (CPU tensors), with
    DataParallel 'module.' prefixes dropped. Loads tensors only (no pickled
    code runs)."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd.get('model'), dict):
        sd = sd['model']
    return {k[len('module.'):] if k.startswith('module.') else k:
            torch.as_tensor(v) for k, v in sd.items()}


def load_weights(path: str, cfg) -> dict:
    """The model's state_dict from a reference .pth/.pt, a .ckpt of
    lc_tpu_torch.train (torch's zip format) or a .ckpt of lc_tpu.train (a
    pickled envelope around flax msgpack: a TrainState's or a plain
    export's params and batch_stats, carried over by
    state_dict_from_flax for the configured network)."""
    if not path.endswith('.ckpt'):
        return load_reference_state_dict(path)
    if zipfile.is_zipfile(path):
        try:
            return model_state_dict(path)
        except (RuntimeError, KeyError, TypeError) as e:
            raise SystemExit(f'{path} is not a checkpoint of '
                             f'lc_tpu_torch.train: {e}')
    try:
        variables = flax_ckpt.read_variables(path)
    except (EOFError, pickle.UnpicklingError) as e:
        raise SystemExit(f'{path} is neither a checkpoint of '
                         f'lc_tpu_torch.train nor of lc_tpu.train: {e!r}')
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise SystemExit(f'{path}: {e}')
    net_cfg = cfg.model.get('net_config', {})
    return state_dict_from_flax(
        variables, bool(net_cfg.get('concat', False)),
        net_name=cfg.model.net_name, sparse_cnt=cfg.get('sparse_cnt', 0))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--weight', type=str, required=True)
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--obj', type=int, nargs='+', required=True)
    parser.add_argument('--opts', nargs='+')
    parser.add_argument('--deterministic', action='store_true')
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)

    # joins torchrun's process group, if any, before anything else runs
    device = mesh.maybe_init_distributed(args.device)
    shard = mesh.shard_of(mesh.resolve_group('auto'))
    primary = mesh.is_primary(shard)
    if not osp.exists(args.weight):
        raise SystemExit(f'weight file "{args.weight}" not found.')
    if not args.weight.endswith(('.pth', '.pt', '.ckpt')):
        raise SystemExit('lc_tpu_torch.test reads .pth/.pt state dicts in the '
                         'reference layout and .ckpt files of '
                         'lc_tpu_torch.train and lc_tpu.train')

    cfg_name = osp.splitext(osp.split(args.config)[1])[0]
    cfg = load_config(args.config, args.opts)
    cfg.obj_ids = args.obj

    log_name = '_'.join([cfg_name, cfg.train_dataset.name, 'test',
                         ','.join(map(str, cfg.obj_ids)) + '.log'])
    if primary:
        os.makedirs(args.output, exist_ok=True)
    setup_logger(osp.join(args.output, log_name) if primary else None)

    evaluator = harness.get_evaluator(cfg, device=device)
    test_set, test_loader = harness.make_datasets(cfg, train=False)
    bit_cnt = test_set.bit_cnt
    model = harness.build_model_from_cfg(
        cfg, 0 if bit_cnt is None else sum(bit_cnt))
    model.load_state_dict(load_weights(args.weight, cfg))
    logger.info('loaded %s', args.weight)

    if args.deterministic:
        import numpy as np
        np.random.seed(0)
        torch.manual_seed(0)

    with mesh.data_parallel(shard):
        results = harness.run_test(cfg, model, test_loader, test_set,
                                   evaluator,
                                   seed=0 if args.deterministic else 1,
                                   device=device)

    table = ''
    for name, res in results.items():
        table += '\n' + name + '\n' + res['tables'][0] + '\n'
    logger.info(table)

    if not primary:
        return results
    for name, text in csv_from_results(results).items():
        csv_name = '_'.join([f'{cfg_name}-{name}', cfg.train_dataset.name,
                             'test', ','.join(map(str, cfg.obj_ids)) + '.csv'])
        with open(osp.join(args.output, csv_name), 'w') as f:
            f.write(text)
    return results


if __name__ == '__main__':
    main()
