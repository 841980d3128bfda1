"""lc_tpu's .ckpt files -> numpy trees, in pure Python (no jax, flax or
msgpack package).

The format (lc_tpu/utils/checkpoint.py): a pickled envelope
{'state': <flax msgpack bytes>, 'aux': {step, score, ...}}. The state is
flax's serialization of a TrainState or of a plain {'params',
'batch_stats'} export: msgpack maps and arrays, with numpy arrays as
msgpack ext types (1 ndarray, 3 numpy scalar: each a msgpack triple of
shape, dtype name, C-order bytes; 2 a python complex), and arrays above
2**30 bytes split into dicts marked '__msgpack_chunked_array__'.

The envelope is unpickled by a restricted Unpickler that admits builtins
and numpy only. Objects of jax in `aux` (a jax scalar) cannot be built
without jax: the reader then drops `aux` with a warning and keeps `state`,
which is all the test CLI needs. Any other class is refused.
"""
from __future__ import annotations

import logging
import pickle
import struct

import numpy as np

logger = logging.getLogger(__name__)

_BUILTINS = frozenset({'dict', 'list', 'tuple', 'set', 'frozenset', 'int',
                       'float', 'bool', 'str', 'bytes', 'bytearray',
                       'complex', 'slice', 'range', 'object'})
_NUMPY = frozenset({'_reconstruct', 'scalar', 'ndarray', 'dtype',
                    '_frombuffer'})


class _Unreadable:
    """Stands for an object of jax in the envelope; takes any arguments."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _EnvelopeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split('.')[0]
        if module == 'builtins' and name in _BUILTINS:
            return super().find_class(module, name)
        if module == 'copyreg' and name == '_reconstructor':
            return super().find_class(module, name)
        if root == 'numpy' and (name in _NUMPY
                                or module == 'numpy.random._pickle'):
            return super().find_class(module, name)
        if root in ('jax', 'jaxlib'):
            return _Unreadable
        raise pickle.UnpicklingError(f'{module}.{name} is not allowed in a '
                                     'checkpoint envelope')


def _holds_unreadable(x) -> bool:
    if isinstance(x, _Unreadable):
        return True
    if isinstance(x, dict):
        return any(_holds_unreadable(v) for v in x.values())
    if isinstance(x, (list, tuple, set, frozenset)):
        return any(_holds_unreadable(v) for v in x)
    return False


def read_envelope(path: str) -> dict:
    """The pickled envelope {'state': bytes, 'aux': dict} of `path`, the
    state left as msgpack bytes. Raises pickle.UnpicklingError (or
    EOFError on an empty file) on what is not such an envelope."""
    with open(path, 'rb') as f:
        blob = _EnvelopeUnpickler(f).load()
    if isinstance(blob, dict) and _holds_unreadable(blob.get('aux')):
        logger.warning('%s: aux holds objects of jax; dropped, the state '
                       'kept', path)
        blob = dict(blob, aux={})
    return blob


class _Reader:
    """A msgpack reader over bytes: value() decodes one object, skip()
    passes over one."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError('truncated msgpack payload')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def header(self) -> tuple[str, object]:
        """(kind, payload): ('scalar', value), ('array', n), ('map', n),
        ('str' / 'bin', length) or ('ext', (code, length))."""
        b = self.take(1)[0]
        if b <= 0x7f:
            return 'scalar', b
        if b >= 0xe0:
            return 'scalar', b - 0x100
        if 0x80 <= b <= 0x8f:
            return 'map', b & 0x0f
        if 0x90 <= b <= 0x9f:
            return 'array', b & 0x0f
        if 0xa0 <= b <= 0xbf:
            return 'str', b & 0x1f
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in fixed:
            return 'scalar', fixed[b]
        numbers = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H',
                   0xce: '>I', 0xcf: '>Q', 0xd0: '>b', 0xd1: '>h',
                   0xd2: '>i', 0xd3: '>q'}
        if b in numbers:
            return 'scalar', self.unpack(numbers[b])
        sized = {0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'),
                 0xc6: ('bin', '>I'), 0xd9: ('str', '>B'),
                 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
                 0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
                 0xde: ('map', '>H'), 0xdf: ('map', '>I')}
        if b in sized:
            kind, fmt = sized[b]
            return kind, self.unpack(fmt)
        if 0xd4 <= b <= 0xd8:                              # fixext 1..16
            return 'ext', (self.unpack('>b'), 1 << (b - 0xd4))
        if b in (0xc7, 0xc8, 0xc9):                        # ext 8/16/32
            n = self.unpack({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[b])
            return 'ext', (self.unpack('>b'), n)
        raise ValueError(f'unknown msgpack type byte 0x{b:02x}')

    def value(self):
        kind, arg = self.header()
        if kind == 'scalar':
            return arg
        if kind == 'str':
            return str(self.take(arg), 'utf-8')
        if kind == 'bin':
            return bytes(self.take(arg))
        if kind == 'array':
            return [self.value() for _ in range(arg)]
        if kind == 'map':
            out = {}
            for _ in range(arg):
                k = self.value()
                out[k] = self.value()
            return out
        code, n = arg
        return _ext(code, bytes(self.take(n)))

    def skip(self):
        kind, arg = self.header()
        if kind in ('str', 'bin'):
            self.take(arg)
        elif kind == 'array':
            for _ in range(arg):
                self.skip()
        elif kind == 'map':
            for _ in range(2 * arg):
                self.skip()
        elif kind == 'ext':
            self.take(arg[1])


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = _Reader(data).value()
    if dtype == 'bfloat16':           # no numpy dtype: widen the bits to f32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        re, im = _Reader(data).value()
        return complex(re, im)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f'unknown msgpack ext type {code}')


def _unchunk(tree):
    """Join flax's chunked-array dicts back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if '__msgpack_chunked_array__' in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def state_keys(blob) -> set:
    """The top-level field names of the envelope's state, its values
    skipped: {'step', 'params', 'opt_state', ...} for a TrainState,
    {'params', 'batch_stats'} for an export; empty for what is not an
    envelope, and what parsed of a truncated one."""
    state = blob.get('state') if isinstance(blob, dict) else None
    if not isinstance(state, (bytes, bytearray)):
        return set()
    r = _Reader(state)
    keys = set()
    try:
        kind, n = r.header()
        if kind != 'map':
            return set()
        for _ in range(n):
            keys.add(str(r.value()))
            r.skip()
    except (ValueError, UnicodeDecodeError, struct.error):
        pass
    return keys


def restore_state(blob: dict) -> dict:
    """The envelope's state as a tree of dicts, numpy arrays and python
    scalars. Raises ValueError on a truncated or malformed payload."""
    r = _Reader(blob['state'])
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError('trailing bytes after the msgpack payload')
    return _unchunk(tree)


def read_variables(path: str) -> dict:
    """{'params', 'batch_stats'} of an lc_tpu .ckpt: a TrainState's (it has
    'opt_state') or a plain export's, sniffed as lc_tpu/test.py does.
    Raises ValueError naming the fields of any other payload."""
    blob = read_envelope(path)
    keys = state_keys(blob)
    if 'opt_state' not in keys and 'params' not in keys:
        raise ValueError(f'unrecognized checkpoint payload in {path}: '
                         f'top-level fields {sorted(keys)}')
    tree = restore_state(blob)
    return {'params': tree['params'], 'batch_stats': tree['batch_stats']}

