"""Training entry point (counterpart of lc_tpu/train.py):

    python -m lc_tpu_torch.train --config configs/glmo.yaml --output out
        [--obj 1] [--name exp] [--ckpt path] [--resume] [--opts a.b=c ...]
        [--device cpu]
    torchrun --nproc_per_node N -m lc_tpu_torch.train ...   (data-parallel)

Trains every family: CDPN dense NOC (glmo), zebra Gray codes (max_bit_cnt:
zlmo, zsyn; with train_dataset_1 mixed in by ratio) and sparse keypoints
(sparse_cnt: gsplmo, gspsyn).

Epoch-based (cfg.train.num_epochs) or step-based (cfg.train.num_steps)
loops, with periodic evaluation through harness.run_test and the best
checkpoint chosen on add(-s)_0.10. Runs on CUDA unless --device cpu is
given. The run is deterministic: the loader's stream is a function of
(seed, position) and every step's random draws come from generators seeded
from (seed, step), so a resumed run repeats the uninterrupted one.

Data-parallel under torchrun (parallel/mesh.py: NCCL on cuda:LOCAL_RANK,
gloo with --device cpu): each rank loads, preprocesses and trains on its
contiguous slice of every global batch (dataloader.batch_size crops), and
computes what one process computes on the whole batch; rank 0 alone writes
the checkpoints, metrics.jsonl, the TensorBoard scalars and the exports.
The loop stages the next batches on the device ahead of the step
(data/pipeline.device_prefetch). TensorBoard: `loss/<term>` at step 1 and
every 20th, `eval/score` after each evaluation, through tensorboardX when
it imports; metrics.jsonl is always written.
"""
from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import os.path as osp
import time

import torch
from torch.profiler import record_function

from . import harness, resolve_device
from .data.pipeline import device_prefetch, device_preprocess
from .loss.loss_fn import init_loss_state, loss_state_to
from .models import default_compute_dtype, set_compute_dtype
from .models.weights import init_weights
from .optim.factory import build_optimizer
from .parallel import mesh
from .train_step import train_step
from .utils import seeding
from .utils.checkpoint import Checkpoint
from .utils.config import load_config
from .utils.logging import setup_logger

logger = logging.getLogger(__name__)

# batches staged on the device ahead of the step (lc_tpu's device_prefetch
# size); 0 stages each batch when the step takes it
PREFETCH_BATCHES = 2


def build_training(cfg, seed: int | None = None, device=None) -> dict:
    """Wire everything on `device`; returns a dict of components. seed
    defaults to cfg.train.seed (42 when unset): one knob drives the loader's
    shuffle, the model's init and the per-step generators. Inside a
    data-parallel context (parallel/mesh.py) the training loader yields
    this rank's slice of each global batch."""
    device = resolve_device(device)
    if seed is None:
        seed = int(cfg.train.get('seed', 42))
    shard = mesh.active()
    proc = {} if shard is None else dict(process_index=shard.index,
                                         process_count=shard.count)
    train_set, train_loader = harness.make_datasets(cfg, train=True,
                                                    seed=seed, **proc)
    if not len(train_loader):
        raise ValueError(f'the training set holds {len(train_set)} samples, '
                         f'fewer than one batch of {cfg.dataloader.batch_size}')
    if cfg.train.get('test_every', 0):
        test_set, test_loader = harness.make_datasets(cfg, train=False,
                                                      seed=seed)
        evaluator = harness.get_evaluator(cfg, device=device)
    else:
        test_set = test_loader = evaluator = None
    bit_cnt = train_set.bit_cnt
    model = harness.build_model_from_cfg(cfg, sum(bit_cnt) if bit_cnt else 0)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = set_compute_dtype(model.to(device), default_compute_dtype(device))

    if cfg.train.get('num_steps'):
        num_steps, steps_per_epoch = cfg.train.num_steps, 0
    else:
        steps_per_epoch = len(train_loader)
        num_steps = cfg.train.num_epochs * steps_per_epoch
    loss_cfg = harness.make_loss_config(cfg, steps_per_epoch, bit_cnt)
    optimizer, scheduler = build_optimizer(model.parameters(), cfg.optimizer,
                                           cfg.scheduler, num_steps)
    return dict(model=model, optimizer=optimizer, scheduler=scheduler,
                loss_cfg=loss_cfg,
                loss_state=init_loss_state(loss_cfg, device),
                train_set=train_set, train_loader=train_loader,
                test_set=test_set, test_loader=test_loader,
                evaluator=evaluator, seed=seed, device=device,
                pp_kwargs=harness.preprocess_kwargs(cfg, train_set, train=True),
                num_steps=num_steps, steps_per_epoch=steps_per_epoch)


def preprocess_step(dev: dict, seed: int, step: int, pp_kwargs: dict) -> dict:
    """The train branch of device_preprocess on a batch already on the
    device, its draws from the step's generator (for the global batch, of
    which a data-parallel rank holds its rows)."""
    device = next(iter(dev.values())).device
    with record_function('preprocess'):
        return device_preprocess(dev, seeding.step_generator(
            seed, step, seeding.STREAM_PREPROCESS, device), **pp_kwargs)


def sample_offset(seed: int, step: int, dense_sample: int) -> list:
    """The dense loss's sampling offset of the step, the same on every
    rank."""
    return torch.randint(0, dense_sample, (2,),
                         generator=seeding.step_generator(
                             seed, step, seeding.STREAM_STEP)).tolist()


def endless_batches(loader, start_step: int):
    """The loader's batches from global batch index start_step on, across
    epochs (MPLoader streams across them itself)."""
    if hasattr(loader, 'endless'):
        yield from loader.endless(start_step)
        return
    loader.set_position(start_step)
    while True:
        yield from loader


def summary_writer(outdir: str):
    """tensorboardX's SummaryWriter on outdir, or None, said once in the
    log, when tensorboardX is not installed (metrics.jsonl has the same
    numbers)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.info('tensorboardX is not installed: no TensorBoard scalars; '
                    'metrics.jsonl has them')
        return None
    return SummaryWriter(outdir)


def train(args, cfg, outdir: str, device=None, parallel='auto'):
    """The training loop; returns the trained model. `parallel` (lc_tpu's
    `mesh` argument): 'auto' is data-parallel over the default process
    group when it holds more than one rank, None a single process, and a
    process group is used as given (of one rank too: the data-parallel path
    then runs). A loader with worker processes (MPLoader) is closed when
    the loop ends."""
    shard = mesh.shard_of(mesh.resolve_group(parallel))
    with mesh.data_parallel(shard):
        comps = build_training(cfg, device=device)
        if shard is not None:
            logger.info('data-parallel over %d ranks, %d crops a rank on %s',
                        shard.count, cfg.dataloader.batch_size // shard.count,
                        comps['device'])
        writer = summary_writer(outdir) if mesh.is_primary(shard) else None
        try:
            return _train_loop(args, cfg, outdir, comps, writer)
        finally:
            close = getattr(comps['train_loader'], 'close', None)
            if close is not None:
                close()
            if writer is not None:
                writer.close()


def _train_loop(args, cfg, outdir: str, comps: dict, writer):
    model, optimizer, scheduler = (comps['model'], comps['optimizer'],
                                   comps['scheduler'])
    loss_state, device, seed = comps['loss_state'], comps['device'], comps['seed']
    num_steps = comps['num_steps']
    shard = mesh.active()
    primary = mesh.is_primary(shard)
    ckpter = Checkpoint.by_step(
        osp.join(outdir, 'ckpts'),
        resume_period=cfg.train.get('ckpt_every',
                                    comps['steps_per_epoch'] or 5000))
    start_step = 0
    state = None
    if args.resume or args.ckpt:
        # an explicit --ckpt must load; --resume alone starts fresh when the
        # run's directory holds no checkpoint yet
        state, aux = ckpter.resume(ckpt_path=args.ckpt)
        if state is not None and 'optimizer' not in state:
            raise SystemExit('the checkpoint holds a model only (a finish() '
                             'export); resume needs a training checkpoint')
    if state is None:
        seeding.seed_all(seed)
    else:
        model.load_state_dict(state['model'])
        optimizer.load_state_dict(state['optimizer'])
        scheduler.load_state_dict(state['scheduler'])
        loss_state = loss_state_to(state['loss_state'], device)
        seeding.restore_random_state(aux['random_state'])
        start_step = int(aux['step'])
        logger.info('resumed from step %d', start_step)
    if start_step >= num_steps:
        return model

    test_every = cfg.train.get('test_every', 0)
    test_start = cfg.train.get('test_start', 0)
    # the test cadence counts epochs in epoch mode, steps in step mode
    test_every_steps = test_every * comps['steps_per_epoch'] \
        if cfg.train.get('num_epochs') else test_every
    s = comps['loss_cfg'].dense_sample

    def full_state():
        return {'model': model.state_dict(),
                'optimizer': optimizer.state_dict(),
                'scheduler': scheduler.state_dict(),
                'loss_state': loss_state}

    batches = itertools.islice(
        endless_batches(comps['train_loader'], start_step),
        num_steps - start_step)
    staged = device_prefetch(
        batches, lambda dev, i: preprocess_step(
            dev, seed, start_step + i, comps['pp_kwargs']),
        device, size=PREFETCH_BATCHES)
    metrics_path = osp.join(outdir, 'metrics.jsonl')
    step = last_step = start_step
    t0 = time.perf_counter()
    while step < num_steps:
        gt = next(staged)
        loss_state, metrics = train_step(
            model, optimizer, scheduler, comps['loss_cfg'], loss_state, gt,
            step, sample_offset(seed, step, s),
            sym_aware_start=cfg.get('sym_aware_start', 0))
        step += 1
        if step % 20 == 0 or step == 1 or step == num_steps:
            m = {k: float(v) for k, v in metrics.items()}     # syncs the device
            rate = (step - last_step) * cfg.dataloader.batch_size / max(
                time.perf_counter() - t0, 1e-9)
            t0, last_step = time.perf_counter(), step
            logger.info('step %d/%d  %s  (%.1f crops/s)', step, num_steps,
                        ' '.join(f'{k}={v:.4f}' for k, v in m.items()), rate)
            if primary:
                with open(metrics_path, 'a') as f:
                    f.write(json.dumps(dict(step=step, **m)) + '\n')
            # lc_tpu writes its TensorBoard scalars at step 1 and every 20th
            if writer is not None and (step % 20 == 0 or step == 1):
                for k, v in m.items():
                    writer.add_scalar(f'loss/{k}', v, step)

        score = -1.0
        if test_every_steps and step % test_every_steps == 0 \
                and step >= test_start and step != num_steps:
            res = harness.run_test(cfg, model, comps['test_loader'],
                                   comps['test_set'], comps['evaluator'],
                                   device=device)
            score = next(iter(res.values()))['avg_score']
            if writer is not None:
                writer.add_scalar('eval/score', score, step)
        if primary:
            ckpter.step(full_state, step=step, score=score,
                        aux={'random_state': seeding.get_random_state()})
        if ckpter.due(step, score):
            mesh.barrier(shard)     # no rank reads a checkpoint mid-write

    if primary:
        ckpter.save(full_state(), step=step, score=-1.0,
                    aux={'random_state': seeding.get_random_state()})
        # the final export is the model alone: lc_tpu_torch.test loads it
        ckpter.finish(model.state_dict(), osp.join(outdir, 'model_final.ckpt'),
                      osp.join(outdir, 'model_best'))
    mesh.barrier(shard)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, default='configs/glmo.yaml')
    parser.add_argument('--output', type=str, default='output')
    parser.add_argument('--name', type=str)
    parser.add_argument('--obj', type=int, nargs='+')
    parser.add_argument('--ckpt', type=str)
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--opts', nargs='+')
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)

    # joins torchrun's process group, if any, before anything else runs
    device = mesh.maybe_init_distributed(args.device)
    primary = mesh.is_primary(mesh.shard_of(mesh.resolve_group('auto')))
    cfg = load_config(args.config, args.opts)
    if args.name:
        cfg['exp_name'] = args.name
    if args.obj is not None:
        cfg.obj_ids = args.obj
    if bool(cfg.train.get('num_epochs')) == bool(cfg.train.get('num_steps')):
        raise SystemExit('set exactly one of train.num_epochs, train.num_steps')
    outdir = osp.join(args.output, cfg.exp_name) + '-' + \
        '_'.join(map(str, cfg.obj_ids))
    if primary:
        os.makedirs(outdir, exist_ok=True)
    setup_logger(outdir if primary else None)
    return train(args, cfg, outdir, device=device)


if __name__ == '__main__':
    main()
