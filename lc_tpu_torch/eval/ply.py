"""Copy of lc_tpu/eval/ply.py (importing lc_tpu would pull in jax).

Minimal PLY vertex loader (trimesh replacement — only vertices are needed;
reference lib/utils/evaluate.py:139 loads models_eval/*.ply vertices)."""
from __future__ import annotations

import numpy as np

_DTYPES = {
    'float': '<f4', 'float32': '<f4', 'double': '<f8', 'float64': '<f8',
    'uchar': '<u1', 'uint8': '<u1', 'char': '<i1', 'int8': '<i1',
    'short': '<i2', 'int16': '<i2', 'ushort': '<u2', 'uint16': '<u2',
    'int': '<i4', 'int32': '<i4', 'uint': '<u4', 'uint32': '<u4',
}


def load_ply_vertices(path: str) -> np.ndarray:
    """Return (N, 3) float32 vertex positions from an ascii or
    binary_little_endian PLY."""
    with open(path, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError(f'{path}: not a PLY file')
        fmt = None
        n_verts = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode('ascii').strip()
            if line == 'end_header':
                break
            parts = line.split()
            if not parts or parts[0] == 'comment':
                continue
            if parts[0] == 'format':
                fmt = parts[1]
            elif parts[0] == 'element':
                in_vertex = parts[1] == 'vertex'
                if in_vertex:
                    n_verts = int(parts[2])
            elif parts[0] == 'property' and in_vertex:
                if parts[1] == 'list':
                    raise ValueError('list property in vertex element')
                props.append((parts[2], _DTYPES[parts[1]]))

        names = [p[0] for p in props]
        if fmt == 'ascii':
            rows = []
            for _ in range(n_verts):
                vals = f.readline().split()
                rows.append([float(v) for v in vals[:len(props)]])
            arr = np.asarray(rows, np.float64)
            xyz = arr[:, [names.index('x'), names.index('y'), names.index('z')]]
        elif fmt == 'binary_little_endian':
            dt = np.dtype([(n, t) for n, t in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt,
                                count=n_verts)
            xyz = np.stack([raw['x'], raw['y'], raw['z']], axis=-1)
        else:
            raise ValueError(f'unsupported PLY format {fmt}')
    return np.ascontiguousarray(xyz, np.float32)
