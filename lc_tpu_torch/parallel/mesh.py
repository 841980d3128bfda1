"""Data parallelism over processes (counterpart of lc_tpu/parallel/mesh.py).

lc_tpu runs one global program over a 1-D 'data' mesh: the batch is
sharded, the parameters replicated, and every reduction over the batch
(BatchNorm's statistics, the losses' means, the Gray-code histogram, the
clip taps' norms, int8's static scales) is taken over the global batch by
the SPMD partitioner. The port runs one process (rank) per card, each on
its contiguous slice of the global batch, through torch.distributed (NCCL
on cards, gloo on the CPU), and takes those reductions across the ranks
with the collectives here, so that N ranks compute what one rank computes
on the same global batch.

A run's data-parallel context is a `Shard` (group, index, count), made
current by `data_parallel(shard)` (train.train and the test CLI); the
loaders' carving, preprocessing's and RANSAC's draws, the layers, the
losses, the train step and run_test read it with `active()`. With no shard every helper is the identity and adds no device
operation: one process computes exactly what it computed before.

Gradient convention (that of torch.distributed.nn.functional.all_reduce):
the backward of `all_reduce_sum` is itself a sum over ranks, so a value
that reaches the loss through it on every rank collects every rank's
cotangent (x*x all-reduced over 2 ranks and backpropagated on both gives
4x, not 2x). Each rank therefore backpropagates its share of the global
loss, loss / count (train_step.train_step): every activation's cotangent is
then the global program's, each rank's parameter gradients are its part of
the global gradient, and their sum over ranks (`all_reduce_grads`) is the
global gradient. Callers and what they rely on:
  * models/layers._GlobalBatchNorm takes its cotangent as the global
    loss's and writes its backward in closed form, with plain all-reduces
    of its statistics (forward) and of Σg, Σg·x̂ (backward);
  * cross_rank_mean, the losses' batch means (loss/loss_fn.py,
    loss/surrogate.py): the mean of the ranks' equal-sized local means;
    with loss / count backpropagated each local mean gets 1 / count, its
    weight in the global mean;
  * loss/clip._GradTap.backward and loss/surrogate.xyz_bin_loss reduce
    outside autograd (inside a backward, or under no_grad).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .. import resolve_device

# torchrun's environment: its presence starts the process group
TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR')


class Shard(NamedTuple):
    """This process's place in a data-parallel group."""
    group: object        # a torch.distributed ProcessGroup
    index: int           # this rank's position, which slice of each batch
    count: int           # the group's size


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar('data_parallel',
                                                         default=None)


def maybe_init_distributed(device=None) -> torch.device:
    """Join the process group when torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR) is present and no group exists yet: NCCL on
    cuda:LOCAL_RANK, gloo on the CPU. Returns the device this process runs
    on (resolve_device's: CUDA unless 'cpu' is asked for). Raises when
    cuda:LOCAL_RANK does not exist, so two ranks never share a card, and
    never falls back to the CPU."""
    device = resolve_device(device)
    if dist.is_initialized() or not all(k in os.environ
                                        for k in TORCHRUN_ENV):
        return device
    if device.type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK', 0))
        if device.index is not None and device.index != local:
            raise RuntimeError(f'--device {device} under torchrun: rank '
                               f'{os.environ["RANK"]} runs on cuda:{local} '
                               '(LOCAL_RANK)')
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f'LOCAL_RANK {local} names cuda:{local}, but this machine has '
                f'{torch.cuda.device_count()} CUDA device(s): one rank a card')
        device = torch.device('cuda', local)
        torch.cuda.set_device(device)
        dist.init_process_group('nccl')
    else:
        dist.init_process_group('gloo')
    return device


def resolve_group(parallel='auto'):
    """The group a run is data-parallel over (lc_tpu's `mesh` argument):
    'auto' the default group when one exists with more than one rank, else
    None; None a single process; a ProcessGroup itself."""
    if isinstance(parallel, str):
        if parallel != 'auto':
            raise ValueError(f"parallel must be 'auto', None or a process "
                             f'group, not {parallel!r}')
        if dist.is_initialized() and dist.get_world_size() > 1:
            return dist.group.WORLD
        return None
    return parallel


def shard_of(group) -> Shard | None:
    """This process's Shard of `group` (None for None)."""
    if group is None:
        return None
    return Shard(group, dist.get_rank(group), dist.get_world_size(group))


def is_primary(shard: Shard | None) -> bool:
    """True on the rank that writes files (checkpoints, logs, CSVs)."""
    return shard is None or shard.index == 0


@contextlib.contextmanager
def data_parallel(shard: Shard | None):
    """Make `shard` the data-parallel context of what runs inside."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Shard | None:
    return _ACTIVE.get()


def pad_to_multiple(batch: dict, multiple: int):
    """Pad every array's leading axis to a multiple of `multiple` by
    repeating its last row (eval batches; the padded rows are dropped from
    the results). Returns (padded batch, n_valid)."""
    n = len(next(iter(batch.values())))
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    return {k: np.concatenate((v, np.repeat(v[-1:], pad, axis=0)), axis=0)
            for k, v in batch.items()}, n


def local_rows(x, shard: Shard | None):
    """This rank's contiguous slice of a global batch's leading axis."""
    if shard is None:
        return x
    if len(x) % shard.count:
        raise ValueError(f'a global batch of {len(x)} rows does not divide '
                         f'over {shard.count} ranks; pad it (pad_to_multiple)')
    per = len(x) // shard.count
    return x[shard.index * per:(shard.index + 1) * per]


def gather_rows(x: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """Every rank's rows of x, in rank order, on every rank (lc_tpu's
    fetch_global); the ranks' row counts must be equal."""
    if shard is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.count)]
    dist.all_gather(parts, x, group=shard.group)
    return torch.cat(parts)


def barrier(shard: Shard | None):
    if shard is not None:
        dist.barrier(group=shard.group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g * (x == y).to(g.dtype), None


def all_reduce_sum(x: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """The sum of x over the ranks, on every rank; its backward sums the
    cotangents over the ranks (the convention above). The identity with no
    shard."""
    return x if shard is None else _AllReduceSum.apply(x, shard.group)


def all_reduce_max(x: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """The element-wise max of x over the ranks, on every rank; its
    backward sums the cotangents over the ranks and gives them to the
    elements equal to the max. The identity with no shard."""
    return x if shard is None else _AllReduceMax.apply(x, shard.group)


def cross_rank_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the active group's ranks of x, a rank's mean over its
    rows: the global batch's mean, the ranks holding equal row counts. x
    itself outside a data-parallel context."""
    shard = active()
    return x if shard is None else all_reduce_sum(x, shard) / shard.count


def all_reduce_grads(params, shard: Shard):
    """Sum the parameters' gradients over the ranks, in one flat
    all-reduce: each rank's are its part of the global gradient."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=shard.group)
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)
