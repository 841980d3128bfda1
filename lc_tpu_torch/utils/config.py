"""Config system: YAML files + dotted-key CLI overrides (copy of
lc_tpu/utils/config.py; yaml is imported only when a file is read).

Accepts the reference's configs/*.yaml unchanged (reference loads them with mmcv
Config.fromfile and merges `--opts a.b.c=v` via DictAction, train.py:163-167).
"""
from __future__ import annotations

import ast
import copy
from typing import Any


class Config(dict):
    """dict with attribute access, recursive wrapping, and cfg.get defaults."""

    def __init__(self, data: dict | None = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = _wrap(value)

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def merge_from_dict(self, options: dict):
        """Merge {'a.b.c': v} dotted-key overrides (mmcv DictAction semantics)."""
        for key, value in options.items():
            node = self
            parts = key.split('.')
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], dict):
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = _wrap(value)

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v
        return unwrap(self)


def _wrap(v):
    if isinstance(v, Config):
        return v
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def parse_opt_value(s: str):
    """Best-effort typed parse of a CLI override value (mmcv DictAction behaviour)."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        low = s.lower()
        if low in ('true', 'false'):
            return low == 'true'
        return s


def parse_opts(pairs: list[str] | None) -> dict:
    """['a.b=1', 'c=x,y', 'd=[64,64]'] -> {'a.b': 1, 'c': ['x', 'y'],
    'd': [64, 64]} — bare comma => list, and bracketed values parse whole
    (mmcv DictAction accepts both; the comma split alone shredded '[64,64]'
    into ['[64', '64]')."""
    out: dict = {}
    for pair in pairs or []:
        key, _, val = pair.partition('=')
        sval = val.strip()
        if sval[:1] in '[(':
            # a value that LOOKS bracketed but doesn't parse is a typo
            # (e.g. '[64,64' from a shell slip) — falling through to the
            # comma split would shred it into ['[64', '64'] and train on
            # silently wrong values; reject it instead
            try:
                parsed = ast.literal_eval(sval)
            except (ValueError, SyntaxError) as e:
                raise ValueError(
                    f'--opts {key}: malformed bracketed value {sval!r}'
                ) from e
            out[key] = list(parsed) if isinstance(parsed, tuple) else parsed
            continue
        if ',' in val:
            out[key] = [parse_opt_value(v) for v in val.split(',')]
        else:
            out[key] = parse_opt_value(val)
    return out


def load_config(path: str, opts: list[str] | dict | None = None) -> Config:
    import yaml
    with open(path) as f:
        cfg = Config(yaml.safe_load(f))
    if opts:
        cfg.merge_from_dict(opts if isinstance(opts, dict) else parse_opts(opts))
    return cfg
