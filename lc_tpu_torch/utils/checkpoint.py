"""Checkpoints with latest-N / best-N / persist rotations and resume
(counterpart of lc_tpu/utils/checkpoint.py; reference
lib/utils/checkpoint.py:13-275), in torch's format.

A checkpoint is one torch.save of {'state': ..., 'aux': ...}: `state` a dict
of state_dicts (model, optimizer, scheduler, loss state) and `aux` the step,
the score and the host RNG state. Files are written to a temporary name
and renamed, then hard-linked into ckpts/ (latest-N), ckpts/best/ (best-N,
the score in the name) and ckpts/persist/ (every persist_period steps).
Resume reads the file it is given, or scans newest first and skips files
that do not load; finish()
exports model_final and model_best and clears the resume rotation.
lc_tpu's msgpack .ckpt files are not read here (ROADMAP queue A).
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import pickle
import re
import shutil

import torch

logger = logging.getLogger(__name__)


def _atomic_save(obj, path: str):
    tmp = path + '.tmp'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _link_or_copy(src: str, dst: str):
    if osp.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def load_checkpoint(path: str) -> dict:
    """{'state', 'aux'} of a checkpoint written here. It holds numpy and
    python RNG state besides tensors, so it is unpickled in full: load only
    files this program wrote."""
    return torch.load(path, map_location='cpu', weights_only=False)


class Checkpoint:
    def __init__(self, ckpt_dir: str, *, latest_keep: int = 2,
                 best_keep: int = 2, persist_period: int | None = None,
                 resume_period: int = 1):
        self.dir = ckpt_dir
        self.best_dir = osp.join(ckpt_dir, 'best')
        self.persist_dir = osp.join(ckpt_dir, 'persist')
        self.latest_keep = latest_keep
        self.best_keep = best_keep
        self.persist_period = persist_period
        self.resume_period = resume_period
        self.best_score = -float('inf')

    @classmethod
    def by_step(cls, ckpt_dir: str, resume_period: int = 5000, **kw):
        return cls(ckpt_dir, resume_period=resume_period, **kw)

    def save(self, state: dict, *, step: int, score: float = -1.0,
             aux: dict | None = None) -> str:
        os.makedirs(self.dir, exist_ok=True)
        aux = dict(aux or {}, step=step, score=score)
        path = osp.join(self.dir, f'{step:09d}.ckpt')
        _atomic_save({'state': state, 'aux': aux}, path)
        self._rotate(self.dir, r'^(\d+)\.ckpt$', self.latest_keep)
        if score >= 0 and score > self.best_score:
            self.best_score = score
            os.makedirs(self.best_dir, exist_ok=True)
            _link_or_copy(path, osp.join(self.best_dir,
                                         f'{step:09d}_{score:.5f}.ckpt'))
            self._rotate(self.best_dir, r'^\d+_([\d.]+)\.ckpt$',
                         self.best_keep, key='score')
        if self.persist_period and step and step % self.persist_period == 0:
            os.makedirs(self.persist_dir, exist_ok=True)
            _link_or_copy(path, osp.join(self.persist_dir, f'{step:09d}.ckpt'))
        return path

    def due(self, step: int, score: float = -1.0) -> bool:
        """Whether step() saves at this step: every resume_period steps, or
        when scored."""
        return step % self.resume_period == 0 or score >= 0

    def step(self, state_fn, *, step: int, score: float = -1.0,
             aux: dict | None = None):
        """Save when due(step, score). `state_fn()` makes the state dict,
        only when a save happens."""
        if self.due(step, score):
            return self.save(state_fn(), step=step, score=score, aux=aux)
        return None

    @staticmethod
    def _rotate(directory: str, pattern: str, keep: int, key: str = 'name'):
        entries = []
        for f in os.listdir(directory):
            m = re.match(pattern, f)
            if m:
                entries.append((float(m.group(1)) if key == 'score' else f, f))
        entries.sort()
        for _, f in entries[:-keep] if keep else entries:
            try:
                os.remove(osp.join(directory, f))
            except OSError:
                pass

    def list_ckpts(self) -> list[str]:
        if not osp.isdir(self.dir):
            return []
        return sorted((f for f in os.listdir(self.dir)
                       if re.match(r'^\d+\.ckpt$', f)), reverse=True)

    def resume(self, ckpt_path: str | None = None):
        """(state, aux) of `ckpt_path`, which must load, or else of the newest
        checkpoint in the directory that loads; (None, {'step': 0}) when the
        directory holds none."""
        if ckpt_path:
            return self._adopt(load_checkpoint(ckpt_path))
        for f in self.list_ckpts():
            path = osp.join(self.dir, f)
            try:
                blob = load_checkpoint(path)
            except (OSError, EOFError, RuntimeError, KeyError, ValueError,
                    pickle.UnpicklingError) as e:
                logger.warning('skipping unloadable checkpoint %s: %s', path, e)
                continue
            return self._adopt(blob)
        logger.warning('no checkpoint to resume from in %s; starting fresh',
                       self.dir)
        return None, {'step': 0}

    def _adopt(self, blob: dict):
        self.best_score = max(self.best_score,
                              blob['aux'].get('score', -float('inf')))
        return blob['state'], blob['aux']

    def finish(self, model_state: dict, final_path: str, best_prefix: str):
        """Export model_final (the model's state_dict alone) and the best
        scored checkpoint, and delete the resume rotation."""
        _atomic_save({'state': {'model': model_state}, 'aux': {'step': -1}},
                     final_path)
        best = []
        if osp.isdir(self.best_dir):
            for f in os.listdir(self.best_dir):
                m = re.match(r'^(\d+)_([\d.]+)\.ckpt$', f)
                if m:
                    best.append((float(m.group(2)), int(m.group(1)), f))
        if best:
            score, step, fname = max(best)
            _link_or_copy(osp.join(self.best_dir, fname),
                          f'{best_prefix}_{step}_{score:.5f}.ckpt')
        for f in self.list_ckpts():
            os.remove(osp.join(self.dir, f))


def model_state_dict(path: str) -> dict:
    """The model's state_dict from a checkpoint written here (a full
    training checkpoint or a finish() export)."""
    return load_checkpoint(path)['state']['model']
