"""Console + file logging (copy of lc_tpu/utils/logging.py).

Reference lib/utils/setup_logger.py:107-187: colored console sink + per-run log
file, intercepting stdlib logging. We are already stdlib, so this is a formatter +
two handlers.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import sys

_COLORS = {'DEBUG': '\x1b[36m', 'INFO': '\x1b[32m', 'WARNING': '\x1b[33m',
           'ERROR': '\x1b[31m', 'CRITICAL': '\x1b[41m'}
_RESET = '\x1b[0m'


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelname, '')
        base = super().format(record)
        return f'{color}{base}{_RESET}' if color and sys.stderr.isatty() else base


def setup_logger(output: str | None = None, level=logging.INFO,
                 name: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = '%(asctime)s %(levelname)s %(name)s: %(message)s'

    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(_ColorFormatter(fmt, datefmt='%H:%M:%S'))
    logger.addHandler(console)

    if output:
        path = output if output.endswith('.log') or output.endswith('.txt') \
            else osp.join(output, 'log.txt')
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    return logger
