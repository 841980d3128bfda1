"""Profiling helpers (counterpart of lc_tpu/utils/profiling.py): a timed
section, the training loop's EMA step timer, and a torch.profiler trace
(the counterpart of lc_tpu's xla_trace)."""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler over the block, CPU activities and, when a card is
    present, CUDA ones; on exit writes a Chrome trace (viewable in Perfetto
    or chrome://tracing) into `logdir`. Yields the profiler; its
    `trace_path` names the file once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(
        logdir, f'trace_{os.getpid()}_{time.time_ns()}.json')
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def timed(name: str, sync=None):
    """Time a section and log '<name>: <ms> ms'. `sync` a CUDA tensor or
    device: CUDA events on its current stream, the end event synchronized;
    otherwise (None, or on the CPU) the host clock."""
    device = None
    if sync is not None:
        device = sync.device if torch.is_tensor(sync) else torch.device(sync)
    if device is None or device.type != 'cuda':
        t0 = time.perf_counter()
        try:
            yield
        finally:
            logger.info('%s: %.2f ms', name, (time.perf_counter() - t0) * 1e3)
        return
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        end.synchronize()
        logger.info('%s: %.2f ms', name, start.elapsed_time(end))


class StepTimer:
    """EMA step timer for training loops (crops/s reporting)."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.ema = None
        self._last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else \
                self.momentum * self.ema + (1 - self.momentum) * dt
        self._last = now
        return self.ema
