"""lc_tpu_torch.utils.profiling against lc_tpu.utils.profiling: the EMA
step timer on one injected clock, the timed section's log line, and the
torch.profiler trace on the CPU."""
import json
import logging
import re
import time

import pytest
import torch

from lc_tpu.utils import profiling as jprofiling
from lc_tpu_torch.utils import profiling


def test_step_timer_matches_lc_tpu(monkeypatch):
    clock = iter([0.0, 0.10, 0.25, 0.27, 0.70, 0.71, 1.5] * 2)
    monkeypatch.setattr(time, 'perf_counter', lambda: next(clock))
    mine, ref = profiling.StepTimer(0.8), jprofiling.StepTimer(0.8)
    got = [mine.tick() for _ in range(7)]
    want = [ref.tick() for _ in range(7)]
    assert got[0] is None and want[0] is None
    assert got == want


@pytest.mark.parametrize('sync', [None, 'tensor', 'device'])
def test_timed_logs_one_line(caplog, sync):
    arg = {None: None, 'tensor': torch.zeros(2),
           'device': torch.device('cpu')}[sync]
    with caplog.at_level(logging.INFO, logger=profiling.__name__):
        with profiling.timed('section', sync=arg):
            torch.ones(8).sum()
    lines = [r.getMessage() for r in caplog.records
             if r.name == profiling.__name__]
    assert len(lines) == 1
    assert re.fullmatch(r'section: \d+\.\d\d ms', lines[0])


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path / 'trace')) as prof:
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    with open(prof.trace_path) as f:
        events = json.load(f)['traceEvents']
    assert any('mm' in e.get('name', '') for e in events)
