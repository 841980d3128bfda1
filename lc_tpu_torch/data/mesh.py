"""Mesh loading + software depth rasterization (the OpenGL renderer
replacement; a copy of lc_tpu/data/mesh.py, numpy only).

The reference's offline z_crop generation renders GT depth with an EGL OpenGL
context (reference tools/gen_z.py:153, tools/lib/meshrenderer). This image has no
GL; depth is all the pipeline needs, so we rasterize triangles with a vectorized
numpy z-buffer — exact perspective-correct depth, no shading, no GPU.
"""
from __future__ import annotations

import numpy as np


def load_ply_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(verts (N,3) f32, faces (M,3) i32) from ascii or binary_little_endian PLY."""
    with open(path, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError(f'{path}: not a PLY')
        fmt = None
        elems = []  # (name, count, [(prop_name, dtype) or ('list', cdt, idt, name)])
        cur = None
        while True:
            line = f.readline().decode('ascii').strip()
            if line == 'end_header':
                break
            p = line.split()
            if not p or p[0] == 'comment':
                continue
            if p[0] == 'format':
                fmt = p[1]
            elif p[0] == 'element':
                cur = (p[1], int(p[2]), [])
                elems.append(cur)
            elif p[0] == 'property':
                if p[1] == 'list':
                    cur[2].append(('list', p[2], p[3], p[4]))
                else:
                    cur[2].append((p[2], p[1]))  # (name, scalar type)

        from ..eval.ply import _DTYPES as DTYPES  # shared with eval.ply
        verts = None
        faces = None
        for name, count, props in elems:
            if fmt == 'ascii':
                rows = [f.readline().split() for _ in range(count)]
                if name == 'vertex':
                    names = [pr[0] for pr in props]
                    xi, yi, zi = (names.index(a) for a in 'xyz')
                    verts = np.asarray(
                        [[r[xi], r[yi], r[zi]] for r in rows], np.float32)
                elif name == 'face':
                    faces = np.asarray([r[1:4] for r in rows], np.int64)
            else:  # binary little endian
                if any(pr[0] == 'list' for pr in props):
                    # faces: assume single list property, uniform 3-vertex faces
                    _, cdt, idt, _ = props[0]
                    cnp = np.dtype(DTYPES[cdt])
                    inp = np.dtype(DTYPES[idt])
                    out = np.empty((count, 3), np.int64)
                    for i in range(count):
                        n = int(np.frombuffer(f.read(cnp.itemsize), cnp)[0])
                        idx = np.frombuffer(f.read(inp.itemsize * n), inp)
                        out[i] = idx[:3]
                    if name == 'face':
                        faces = out
                else:
                    dt = np.dtype([(pr[0], DTYPES[pr[1]]) for pr in props])
                    raw = np.frombuffer(f.read(dt.itemsize * count), dt,
                                        count=count)
                    if name == 'vertex':
                        verts = np.stack([raw['x'], raw['y'], raw['z']],
                                         -1).astype(np.float32)
    if verts is None:
        raise ValueError(f'{path}: no vertex element')
    if faces is None:
        faces = np.zeros((0, 3), np.int64)
    return verts, faces.astype(np.int64)


def rasterize_depth(verts: np.ndarray, faces: np.ndarray, K: np.ndarray,
                    R: np.ndarray, t: np.ndarray, im_hw=(480, 640),
                    near: float = 10.0) -> np.ndarray:
    """Z-buffer depth render (mm); 0 where no surface. Perspective-correct via
    barycentric interpolation of 1/z."""
    H, W = im_hw
    cam = verts @ R.T + t                                     # (N, 3)
    h = cam @ K.T
    z = np.maximum(h[:, 2], 1e-6)
    uv = h[:, :2] / z[:, None]
    inv_z = 1.0 / z

    tri_uv = uv[faces]                                        # (M, 3, 2)
    tri_iz = inv_z[faces]                                     # (M, 3)
    tri_z = z[faces]
    # cull triangles behind the near plane or fully outside
    ok = (tri_z > near).all(-1)
    x_min = np.clip(np.floor(tri_uv[..., 0].min(-1)), 0, W - 1).astype(int)
    x_max = np.clip(np.ceil(tri_uv[..., 0].max(-1)), 0, W - 1).astype(int)
    y_min = np.clip(np.floor(tri_uv[..., 1].min(-1)), 0, H - 1).astype(int)
    y_max = np.clip(np.ceil(tri_uv[..., 1].max(-1)), 0, H - 1).astype(int)
    ok &= (x_max >= x_min) & (y_max >= y_min)

    depth = np.full((H, W), np.inf, np.float32)
    idxs = np.nonzero(ok)[0]
    # sort by bbox area so large triangles (rare) don't dominate Python overhead
    for m in idxs:
        x0, x1 = x_min[m], x_max[m]
        y0, y1 = y_min[m], y_max[m]
        a, b, c = tri_uv[m]
        den = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(den) < 1e-12:
            continue
        xs = np.arange(x0, x1 + 1) + 0.5
        ys = np.arange(y0, y1 + 1) + 0.5
        gx, gy = np.meshgrid(xs, ys)
        w0 = ((b[1] - c[1]) * (gx - c[0]) + (c[0] - b[0]) * (gy - c[1])) / den
        w1 = ((c[1] - a[1]) * (gx - c[0]) + (a[0] - c[0]) * (gy - c[1])) / den
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        iz = w0 * tri_iz[m, 0] + w1 * tri_iz[m, 1] + w2 * tri_iz[m, 2]
        zval = np.where(inside, 1.0 / np.maximum(iz, 1e-12), np.inf)
        sub = depth[y0:y1 + 1, x0:x1 + 1]
        np.minimum(sub, zval.astype(np.float32), out=sub)
    depth[~np.isfinite(depth)] = 0.0
    return depth
