"""Minimal-sample PnP estimators in scalar-struct form: lc_tpu's accelerator
branch of RANSAC's hypothesis stage (counterpart of
lc_tpu/pnp/fast_minimal.py), the plain version of the CUDA kernel
csrc/minimal6.cu (wrapper pnp/minimal6_kernel.py).

lc_tpu's ransac_pnp solves its 6-point samples with the generic estimators
(pnp/epnp.epnp, ransac.planar_pnp, ransac.dlt_pnp) only on the CPU backend;
on every other backend it runs these solvers, which follow the same
algorithms in another layout: every solver variable is one (P,) vector over
the P = B·K problems, and the whole solve (PCA control points, barycentric
inversion, the 12x12 normal matrix, its near-null 4-space by shifted inverse
iteration, the β Gauss-Newton, Procrustes/polar) is straight-line
elementwise code with Python-unrolled indices. The two branches agree only
statistically: the orders of operations differ.

This module is a transcription on (P,) torch tensors, in lc_tpu's order of
operations, structural zeros kept as `None`. It is the referee of the kernel
in the CPU tests and in chip_smoke.py, and is not on the main path: on the
CPU ransac_pnp keeps lc_tpu's CPU branch (the generic estimators), and on
the card it launches the kernel.
"""
from __future__ import annotations

import torch

from ..ops.smallmat import start_basis

# lc_tpu's hypothesis-stage settings (lc_tpu/pnp/ransac.py:316-318)
EPNP_KW = dict(gn_iters=4, eig_iters=3, pca_sweeps=4)
PLANAR_SWEEPS = 4
# the estimators in lc_tpu's concatenation order (lc_tpu/pnp/ransac.py:314-322)
ESTIMATORS = ('epnp', 'planar', 'dlt')


# ---------------------------------------------------------------------------
# small dense helpers on lists of (P,) lane vectors
# ---------------------------------------------------------------------------

def _jacobi_sym(a, V, pairs, sweeps):
    """Cyclic Jacobi on a symmetric matrix stored as a dict {(i, j): (P,)}
    (upper triangle, i <= j) with eigenvector columns V[i][k]."""
    n = len(V)

    def get(i, j):
        return a[(i, j)] if i <= j else a[(j, i)]

    def put(i, j, val):
        a[(min(i, j), max(i, j))] = val

    for _ in range(sweeps):
        for (p, q) in pairs:
            app = get(p, p)
            aqq = get(q, q)
            apq = get(p, q)
            theta = 0.5 * torch.atan2(2.0 * apq, app - aqq)
            c = torch.cos(theta)
            s = torch.sin(theta)
            old = {k: get(p, k) for k in range(n)}
            oldq = {k: get(q, k) for k in range(n)}
            for k in range(n):
                if k == p or k == q:
                    continue
                put(p, k, c * old[k] + s * oldq[k])
                put(q, k, -s * old[k] + c * oldq[k])
            app_n = c * c * app + 2.0 * s * c * apq + s * s * aqq
            aqq_n = s * s * app - 2.0 * s * c * apq + c * c * aqq
            put(p, p, app_n)
            put(q, q, aqq_n)
            put(p, q, torch.zeros_like(apq))
            for i in range(n):
                vp = V[i][p]
                vq = V[i][q]
                V[i][p] = c * vp + s * vq
                V[i][q] = -s * vp + c * vq
    return a, V


def _eigh3(cxx, cxy, cxz, cyy, cyz, czz, sweeps=4):
    """Symmetric 3x3 eigendecomposition: (values ascending [3], vecs[i][k]
    with the eigenvectors as columns)."""
    a = {(0, 0): cxx, (0, 1): cxy, (0, 2): cxz,
         (1, 1): cyy, (1, 2): cyz, (2, 2): czz}
    one = torch.ones_like(cxx)
    zero = torch.zeros_like(cxx)
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    a, V = _jacobi_sym(a, V, [(0, 1), (0, 2), (1, 2)], sweeps)
    vals = [a[(0, 0)], a[(1, 1)], a[(2, 2)]]

    def cswap(i, j):
        swap = vals[i] > vals[j]
        vi, vj = vals[i], vals[j]
        vals[i] = torch.where(swap, vj, vi)
        vals[j] = torch.where(swap, vi, vj)
        for r in range(3):
            ci, cj = V[r][i], V[r][j]
            V[r][i] = torch.where(swap, cj, ci)
            V[r][j] = torch.where(swap, ci, cj)
    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)
    return vals, V


def _chol_lists(A, n):
    """Unrolled Cholesky of a symmetric matrix stored sparsely as
    {(i, j): (P,)} with i <= j; absent keys are structural zeros. Returns
    (L rows with None for structural zeros, inverse diagonal, ok)."""
    eps = 1e-30

    def get(i, j):
        return A.get((min(i, j), max(i, j)))

    ok = None
    L = [[None] * n for _ in range(n)]
    Ld = [None] * n
    for j in range(n):
        s = get(j, j)
        for k in range(j):
            if L[j][k] is not None:
                s = s - L[j][k] * L[j][k]
        okj = s > eps
        ok = okj if ok is None else (ok & okj)
        Ljj = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = Ljj
        Ld[j] = 1.0 / Ljj
        for i in range(j + 1, n):
            t = get(i, j)
            for k in range(j):
                if L[i][k] is not None and L[j][k] is not None:
                    term = L[i][k] * L[j][k]
                    t = -term if t is None else t - term
            L[i][j] = None if t is None else t * Ld[j]
    return L, Ld, ok


def _chol_solve_lists(L, Ld, b, n):
    """Forward and back substitution with _chol_lists's factor; b is a list
    of n (P,) vectors."""
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            if L[i][k] is not None:
                s = s - L[i][k] * y[k]
        y[i] = s * Ld[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            if L[k][i] is not None:
                s = s - L[k][i] * x[k]
        x[i] = s * Ld[i]
    return x


def _polar3(M, iters=12):
    """Newton–Schulz polar factor of a 3x3 given as rows M[i][j] of (P,)."""
    fro = torch.zeros_like(M[0][0])
    for i in range(3):
        for j in range(3):
            fro = fro + M[i][j] * M[i][j]
    inv = 1.0 / torch.sqrt(torch.clamp(fro, min=1e-20))
    X = [[M[i][j] * inv for j in range(3)] for i in range(3)]
    for _ in range(iters):
        G = [[sum(X[i][k] * X[j][k] for k in range(3)) for j in range(3)]
             for i in range(3)]
        X = [[1.5 * X[i][j] - 0.5 * sum(G[i][k] * X[k][j] for k in range(3))
              for j in range(3)] for i in range(3)]
    return X


def _det3_rows(R):
    return (R[0][0] * (R[1][1] * R[2][2] - R[1][2] * R[2][1])
            - R[0][1] * (R[1][0] * R[2][2] - R[1][2] * R[2][0])
            + R[0][2] * (R[1][0] * R[2][1] - R[1][1] * R[2][0]))


def _quat_from_rows(R):
    """Branchless Shepperd quaternion (w, x, y, z), w >= 0, from rotation
    rows."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cands = [
        (qw2, m21 - m12, m02 - m20, m10 - m01),
        (m21 - m12, qx2, m01 + m10, m02 + m20),
        (m02 - m20, m01 + m10, qy2, m12 + m21),
        (m10 - m01, m02 + m20, m12 + m21, qz2),
    ]
    mags = [qw2, qx2, qy2, qz2]
    best = mags[0]
    out = list(cands[0])
    for i in range(1, 4):
        better = mags[i] > best
        out = [torch.where(better, cands[i][k], out[k]) for k in range(4)]
        best = torch.where(better, mags[i], best)
    norm = torch.sqrt(out[0] * out[0] + out[1] * out[1]
                      + out[2] * out[2] + out[3] * out[3])
    inv = 1.0 / torch.clamp(norm, min=1e-20)
    sign = torch.where(out[0] < 0, -1.0, 1.0).to(out[0].dtype)
    return [o * inv * sign for o in out]


def _div(x, c: float):
    """x / c rounded once, as lc_tpu and the kernel divide: on CUDA torch
    divides a tensor by a Python scalar through its reciprocal."""
    return x / torch.full_like(x, c)


def _pose_or_default(q, t, ok):
    """(pose7, ok): the default pose [1,0,0,0,0,0,1] with ok False where
    the pose is not finite."""
    pose = torch.stack([q[0], q[1], q[2], q[3], t[0], t[1], t[2]], -1)
    finite = torch.isfinite(pose).all(-1)
    default = torch.zeros_like(pose)
    default[..., 0] = 1.0
    default[..., 6] = 1.0
    return torch.where(finite[..., None], pose, default), ok & finite


# ---------------------------------------------------------------------------
# the EPnP-6 hypothesis solver
# ---------------------------------------------------------------------------

def epnp6_scalar(x, y, z, u, v, fx, fy, cx, cy, *, eig_iters=3, gn_iters=4,
                 pca_sweeps=4):
    """EPnP on 6-point minimal samples over (P,) problems. x, y, z, u, v:
    lists of 6 (P,) coordinates; fx, fy, cx, cy: (P,). Returns (pose7
    (P, 7), ok (P,))."""
    S = 6
    inv_s = 1.0 / S
    c0x = sum(x) * inv_s
    c0y = sum(y) * inv_s
    c0z = sum(z) * inv_s
    dx = [xi - c0x for xi in x]
    dy = [yi - c0y for yi in y]
    dz = [zi - c0z for zi in z]
    cxx = sum(d * d for d in dx) * inv_s
    cyy = sum(d * d for d in dy) * inv_s
    czz = sum(d * d for d in dz) * inv_s
    cxy = sum(a * b for a, b in zip(dx, dy)) * inv_s
    cxz = sum(a * b for a, b in zip(dx, dz)) * inv_s
    cyz = sum(a * b for a, b in zip(dy, dz)) * inv_s
    vals, V3 = _eigh3(cxx, cxy, cxz, cyy, cyz, czz, sweeps=pca_sweeps)
    scale = [torch.sqrt(torch.clamp(w, min=1e-9)) for w in vals]
    # world control points: c0 and c0 + the PCA axes
    ctrl = [(c0x, c0y, c0z)]
    for k in range(3):
        ctrl.append((c0x + V3[0][k] * scale[k],
                     c0y + V3[1][k] * scale[k],
                     c0z + V3[2][k] * scale[k]))

    # barycentric coordinates: invert the 3x3 whose columns are the axes
    b00, b01, b02 = V3[0][0] * scale[0], V3[0][1] * scale[1], V3[0][2] * scale[2]
    b10, b11, b12 = V3[1][0] * scale[0], V3[1][1] * scale[1], V3[1][2] * scale[2]
    b20, b21, b22 = V3[2][0] * scale[0], V3[2][1] * scale[1], V3[2][2] * scale[2]
    A00 = b11 * b22 - b12 * b21
    A01 = b02 * b21 - b01 * b22
    A02 = b01 * b12 - b02 * b11
    A10 = b12 * b20 - b10 * b22
    A11 = b00 * b22 - b02 * b20
    A12 = b02 * b10 - b00 * b12
    A20 = b10 * b21 - b11 * b20
    A21 = b01 * b20 - b00 * b21
    A22 = b00 * b11 - b01 * b10
    det = b00 * A00 + b01 * A10 + b02 * A20
    inv_det = 1.0 / torch.where(det.abs() > 1e-30, det, 1e-30)
    alph = []
    for j in range(S):
        b1 = (A00 * dx[j] + A01 * dy[j] + A02 * dz[j]) * inv_det
        b2 = (A10 * dx[j] + A11 * dy[j] + A12 * dz[j]) * inv_det
        b3 = (A20 * dx[j] + A21 * dy[j] + A22 * dz[j]) * inv_det
        alph.append((1.0 - b1 - b2 - b3, b1, b2, b3))

    # MᵀM (12x12, symmetric; its (x, y) block is identically zero and absent)
    cu = [cx - ui for ui in u]
    cv = [cy - vi for vi in v]
    MtM = {}
    for l in range(4):
        for m in range(l, 4):
            s_lm = sum(alph[j][l] * alph[j][m] for j in range(S))
            tu = sum(alph[j][l] * alph[j][m] * cu[j] for j in range(S))
            tv = sum(alph[j][l] * alph[j][m] * cv[j] for j in range(S))
            uu = sum(alph[j][l] * alph[j][m]
                     * (cu[j] * cu[j] + cv[j] * cv[j]) for j in range(S))
            MtM[(l, m)] = fx * fx * s_lm
            MtM[(4 + l, 4 + m)] = fy * fy * s_lm
            MtM[(8 + l, 8 + m)] = uu
            MtM[(l, 8 + m)] = fx * tu
            MtM[(4 + l, 8 + m)] = fy * tv
            if m != l:
                MtM[(m, 8 + l)] = fx * tu
                MtM[(4 + m, 8 + l)] = fy * tv

    # shifted inverse subspace iteration for the 4 smallest eigenvectors
    tr = sum(MtM[(i, i)] for i in range(12))
    shift = _div(1e-6 * tr, 12.0) + 1e-25
    Ash = dict(MtM)
    for i in range(12):
        Ash[(i, i)] = Ash[(i, i)] + shift
    L, Ld, chol_ok = _chol_lists(Ash, 12)
    X0 = start_basis(12, 4)
    one = torch.ones_like(fx)
    X = [[one * float(X0[i, k]) for k in range(4)] for i in range(12)]
    for _ in range(eig_iters):
        cols = [_chol_solve_lists(L, Ld, [X[i][k] for i in range(12)], 12)
                for k in range(4)]
        X = [[cols[k][i] for k in range(4)] for i in range(12)]
        # modified Gram-Schmidt over the 4 columns
        for kcol in range(4):
            for kprev in range(kcol):
                dot = sum(X[i][kprev] * X[i][kcol] for i in range(12))
                for i in range(12):
                    X[i][kcol] = X[i][kcol] - dot * X[i][kprev]
            nrm = torch.sqrt(torch.clamp(
                sum(X[i][kcol] * X[i][kcol] for i in range(12)), min=1e-30))
            inv_n = 1.0 / nrm
            for i in range(12):
                X[i][kcol] = X[i][kcol] * inv_n

    # Rayleigh-Ritz: T = Xᵀ MᵀM X (4x4), Jacobi, rotate X
    def mtm_get(i, j):
        if (i, j) in MtM:
            return MtM[(i, j)]
        if (j, i) in MtM:
            return MtM[(j, i)]
        return None
    Y = [[None] * 4 for _ in range(12)]
    for i in range(12):
        for k in range(4):
            scol = None
            for j in range(12):
                mij = mtm_get(i, j)
                if mij is None:
                    continue
                term = mij * X[j][k]
                scol = term if scol is None else scol + term
            Y[i][k] = scol
    T = {}
    for a_ in range(4):
        for b_ in range(a_, 4):
            T[(a_, b_)] = sum(X[i][a_] * Y[i][b_] for i in range(12))
    zero = torch.zeros_like(fx)
    Q = [[one if i == k else zero for k in range(4)] for i in range(4)]
    T, Q = _jacobi_sym(T, Q, [(p, q) for p in range(3) for q in range(p + 1, 4)],
                       8)
    tvals = [T[(k, k)] for k in range(4)]
    Vb = [[sum(X[i][j] * Q[j][k] for j in range(4)) for k in range(4)]
          for i in range(12)]

    def cswap4(i, j):
        swap = tvals[i] > tvals[j]
        ti, tj = tvals[i], tvals[j]
        tvals[i] = torch.where(swap, tj, ti)
        tvals[j] = torch.where(swap, ti, tj)
        for r in range(12):
            ci, cj = Vb[r][i], Vb[r][j]
            Vb[r][i] = torch.where(swap, cj, ci)
            Vb[r][j] = torch.where(swap, ci, cj)
    for (i, j) in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        cswap4(i, j)

    # the 6 distances of the world control points, and per basis vector k
    # the camera-frame difference vectors of the same pairs
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    d_w = []
    for (i, j) in pairs:
        ddx = ctrl[i][0] - ctrl[j][0]
        ddy = ctrl[i][1] - ctrl[j][1]
        ddz = ctrl[i][2] - ctrl[j][2]
        d_w.append(torch.sqrt(torch.clamp(ddx * ddx + ddy * ddy + ddz * ddz,
                                          min=1e-30)))
    diffs = [[(Vb[i][k] - Vb[j][k], Vb[4 + i][k] - Vb[4 + j][k],
               Vb[8 + i][k] - Vb[8 + j][k]) for k in range(4)]
             for (i, j) in pairs]
    # β from the N = 1 case (basis vector 0, the smallest)
    num = zero
    den = zero
    for p in range(6):
        d0, d1, d2 = diffs[p][0]
        dv = torch.sqrt(torch.clamp(d0 * d0 + d1 * d1 + d2 * d2, min=1e-30))
        num = num + dv * d_w[p]
        den = den + dv * dv
    betas = [num / torch.clamp(den, min=1e-12), zero, zero, zero]

    # Gauss-Newton on the 6 squared-distance constraints over 4 betas
    for _ in range(gn_iters):
        Jt = [[None] * 6 for _ in range(4)]
        r = [None] * 6
        for p in range(6):
            e0 = sum(betas[k] * diffs[p][k][0] for k in range(4))
            e1 = sum(betas[k] * diffs[p][k][1] for k in range(4))
            e2 = sum(betas[k] * diffs[p][k][2] for k in range(4))
            r[p] = e0 * e0 + e1 * e1 + e2 * e2 - d_w[p] * d_w[p]
            for k in range(4):
                Jt[k][p] = 2.0 * (e0 * diffs[p][k][0] + e1 * diffs[p][k][1]
                                  + e2 * diffs[p][k][2])
        JtJ = {}
        for a_ in range(4):
            for b_ in range(a_, 4):
                JtJ[(a_, b_)] = sum(Jt[a_][p] * Jt[b_][p] for p in range(6))
            JtJ[(a_, a_)] = JtJ[(a_, a_)] + 1e-9
        Jtr = [sum(Jt[k][p] * r[p] for p in range(6)) for k in range(4)]
        Lb, Lbd, _ = _chol_lists(JtJ, 4)
        db = _chol_solve_lists(Lb, Lbd, Jtr, 4)
        betas = [betas[k] - torch.nan_to_num(db[k]) for k in range(4)]

    # camera control points; cheirality by the mean z of the 6 points
    cc = [(sum(betas[k] * Vb[p][k] for k in range(4)),
           sum(betas[k] * Vb[4 + p][k] for k in range(4)),
           sum(betas[k] * Vb[8 + p][k] for k in range(4))) for p in range(4)]
    mean_z = zero
    for j in range(S):
        mean_z = mean_z + sum(alph[j][p] * cc[p][2] for p in range(4))
    flip = torch.where(mean_z < 0, -1.0, 1.0).to(mean_z.dtype)
    cc = [(cx_ * flip, cy_ * flip, cz_ * flip) for (cx_, cy_, cz_) in cc]

    # Procrustes world → camera on the 4 control points
    mwx = sum(c[0] for c in ctrl) * 0.25
    mwy = sum(c[1] for c in ctrl) * 0.25
    mwz = sum(c[2] for c in ctrl) * 0.25
    mcx = sum(c[0] for c in cc) * 0.25
    mcy = sum(c[1] for c in cc) * 0.25
    mcz = sum(c[2] for c in cc) * 0.25
    H = [[zero] * 3 for _ in range(3)]
    for p in range(4):
        a3 = (cc[p][0] - mcx, cc[p][1] - mcy, cc[p][2] - mcz)
        b3 = (ctrl[p][0] - mwx, ctrl[p][1] - mwy, ctrl[p][2] - mwz)
        for i in range(3):
            for j in range(3):
                H[i][j] = H[i][j] + a3[i] * b3[j]
    R = _polar3(H)
    ok = chol_ok & (_det3_rows(R) > 0)
    tx = mcx - (R[0][0] * mwx + R[0][1] * mwy + R[0][2] * mwz)
    ty = mcy - (R[1][0] * mwx + R[1][1] * mwy + R[1][2] * mwz)
    tz = mcz - (R[2][0] * mwx + R[2][1] * mwy + R[2][2] * mwz)
    return _pose_or_default(_quat_from_rows(R), (tx, ty, tz), ok)


# ---------------------------------------------------------------------------
# DLT-6 and planar-homography-6, same layout
# ---------------------------------------------------------------------------

def dlt6_scalar(x, y, z, u, v, fx, fy, cx, cy):
    """Ridge-regularized inhomogeneous DLT on 6-point samples over (P,)
    problems (normalized 3D frame, P[2,3] = 1, 11x11 ridge Cholesky,
    Newton–Schulz polar)."""
    S = 6
    inv_s = 1.0 / S
    xn = [(ui - cx) / fx for ui in u]
    yn = [(vi - cy) / fy for vi in v]
    c0x = sum(x) * inv_s
    c0y = sum(y) * inv_s
    c0z = sum(z) * inv_s
    dx = [xi - c0x for xi in x]
    dy = [yi - c0y for yi in y]
    dz = [zi - c0z for zi in z]
    ms = sum(a * a + b * b + c * c for a, b, c in zip(dx, dy, dz)) * inv_s
    s3d = torch.clamp(torch.sqrt(_div(ms, 3.0)), min=1e-6)
    inv3d = 1.0 / s3d
    X = [d * inv3d for d in dx]
    Y = [d * inv3d for d in dy]
    Z = [d * inv3d for d in dz]

    # rows per point: ru = [X Y Z 1 0000 −u·X −u·Y −u·Z] = xn
    #                 rv = [0000 X Y Z 1 −v·X −v·Y −v·Z] = yn
    # AᵀA (11x11) and Aᵀb entry by entry: rows 0-3 meet only ru, rows 4-7
    # only rv, rows 8-10 both
    one = torch.ones_like(fx)
    ru = [[X[j], Y[j], Z[j], one] for j in range(S)]
    w3 = [[-xn[j] * X[j], -xn[j] * Y[j], -xn[j] * Z[j]] for j in range(S)]
    w3v = [[-yn[j] * X[j], -yn[j] * Y[j], -yn[j] * Z[j]] for j in range(S)]
    A = {}
    b = [None] * 11

    def acc(i, jdx, val):
        key = (min(i, jdx), max(i, jdx))
        A[key] = val if key not in A else A[key] + val

    for j in range(S):
        for a_ in range(4):
            for b_ in range(a_, 4):
                acc(a_, b_, ru[j][a_] * ru[j][b_])
            for b_ in range(3):
                acc(a_, 8 + b_, ru[j][a_] * w3[j][b_])
            t = ru[j][a_] * xn[j]
            b[a_] = t if b[a_] is None else b[a_] + t
        for a_ in range(4):
            for b_ in range(a_, 4):
                acc(4 + a_, 4 + b_, ru[j][a_] * ru[j][b_])
            for b_ in range(3):
                acc(4 + a_, 8 + b_, ru[j][a_] * w3v[j][b_])
            t = ru[j][a_] * yn[j]
            b[4 + a_] = t if b[4 + a_] is None else b[4 + a_] + t
        for a_ in range(3):
            for b_ in range(a_, 3):
                acc(8 + a_, 8 + b_,
                    w3[j][a_] * w3[j][b_] + w3v[j][a_] * w3v[j][b_])
            t = w3[j][a_] * xn[j] + w3v[j][a_] * yn[j]
            b[8 + a_] = t if b[8 + a_] is None else b[8 + a_] + t
    for i in range(11):
        A[(i, i)] = A[(i, i)] + 1e-8
    L, Ld, chol_ok = _chol_lists(A, 11)
    h = _chol_solve_lists(L, Ld, b, 11)

    # P' = λ'[R | t'] for the normalized points: rows of M from h
    M = [[h[0], h[1], h[2]], [h[4], h[5], h[6]], [h[8], h[9], h[10]]]
    t_vec = [h[3], h[7], one]
    R = _polar3(M)
    lam_p = _div(sum(R[i][j] * M[i][j] for i in range(3) for j in range(3)),
                 3.0)
    lam = lam_p * inv3d
    ok = chol_ok & (lam > 1e-12) & (_det3_rows(R) > 0)
    inv_lam = 1.0 / torch.clamp(lam, min=1e-12)
    Rc = [R[i][0] * c0x + R[i][1] * c0y + R[i][2] * c0z for i in range(3)]
    tx = t_vec[0] * inv_lam - Rc[0]
    ty = t_vec[1] * inv_lam - Rc[1]
    tz = t_vec[2] * inv_lam - Rc[2]
    return _pose_or_default(_quat_from_rows(R), (tx, ty, tz), ok)


def planar6_scalar(x, y, z, u, v, fx, fy, cx, cy, pca_sweeps=4):
    """Plane PCA, the 8-unknown homography and its Zhang decomposition on
    6-point samples over (P,) problems."""
    S = 6
    inv_s = 1.0 / S
    c0x = sum(x) * inv_s
    c0y = sum(y) * inv_s
    c0z = sum(z) * inv_s
    dx = [xi - c0x for xi in x]
    dy = [yi - c0y for yi in y]
    dz = [zi - c0z for zi in z]
    cxx = sum(d * d for d in dx)
    cyy = sum(d * d for d in dy)
    czz = sum(d * d for d in dz)
    cxy = sum(a * b for a, b in zip(dx, dy))
    cxz = sum(a * b for a, b in zip(dx, dz))
    cyz = sum(a * b for a, b in zip(dy, dz))
    vals, V3 = _eigh3(cxx, cxy, cxz, cyy, cyz, czz, sweeps=pca_sweeps)
    b1 = (V3[0][2], V3[1][2], V3[2][2])     # the largest two: in the plane
    b2 = (V3[0][1], V3[1][1], V3[2][1])
    q1 = [dx[j] * b1[0] + dy[j] * b1[1] + dz[j] * b1[2] for j in range(S)]
    q2 = [dx[j] * b2[0] + dy[j] * b2[1] + dz[j] * b2[2] for j in range(S)]
    qs = torch.sqrt(torch.clamp(
        sum(a * a + b * b for a, b in zip(q1, q2)) * inv_s * 0.5, min=1e-12))
    inv_qs = 1.0 / qs
    q1 = [a * inv_qs for a in q1]
    q2 = [a * inv_qs for a in q2]
    xn = [(ui - cx) / fx for ui in u]
    yn = [(vi - cy) / fy for vi in v]

    # homography rows: [q1 q2 1 000 −x q1 −x q2] = x; the v row likewise
    one = torch.ones_like(fx)
    A = {}
    b = [None] * 8

    def acc(i, jdx, val):
        key = (min(i, jdx), max(i, jdx))
        A[key] = val if key not in A else A[key] + val

    for j in range(S):
        r3 = [q1[j], q2[j], one]
        wu = [-xn[j] * q1[j], -xn[j] * q2[j]]
        wv = [-yn[j] * q1[j], -yn[j] * q2[j]]
        for a_ in range(3):
            for b_ in range(a_, 3):
                acc(a_, b_, r3[a_] * r3[b_])
                acc(3 + a_, 3 + b_, r3[a_] * r3[b_])
            for b_ in range(2):
                acc(a_, 6 + b_, r3[a_] * wu[b_])
                acc(3 + a_, 6 + b_, r3[a_] * wv[b_])
            tu = r3[a_] * xn[j]
            tv = r3[a_] * yn[j]
            b[a_] = tu if b[a_] is None else b[a_] + tu
            b[3 + a_] = tv if b[3 + a_] is None else b[3 + a_] + tv
        for a_ in range(2):
            for b_ in range(a_, 2):
                acc(6 + a_, 6 + b_, wu[a_] * wu[b_] + wv[a_] * wv[b_])
            t = wu[a_] * xn[j] + wv[a_] * yn[j]
            b[6 + a_] = t if b[6 + a_] is None else b[6 + a_] + t
    for i in range(8):
        A[(i, i)] = A[(i, i)] + 1e-8
    L, Ld, chol_ok = _chol_lists(A, 8)
    h = _chol_solve_lists(L, Ld, b, 8)

    h1 = (h[0], h[3], h[6])
    h2 = (h[1], h[4], h[7])
    h3 = (h[2], h[5], one)
    n1 = torch.sqrt(h1[0] ** 2 + h1[1] ** 2 + h1[2] ** 2)
    n2 = torch.sqrt(h2[0] ** 2 + h2[1] ** 2 + h2[2] ** 2)
    lam = 2.0 / torch.clamp(n1 + n2, min=1e-12)
    r1 = [lam * c for c in h1]
    r2 = [lam * c for c in h2]
    r3 = [r1[1] * r2[2] - r1[2] * r2[1],
          r1[2] * r2[0] - r1[0] * r2[2],
          r1[0] * r2[1] - r1[1] * r2[0]]
    Rp = _polar3([[r1[0], r2[0], r3[0]],
                  [r1[1], r2[1], r3[1]],
                  [r1[2], r2[2], r3[2]]])
    tp = [lam * c for c in h3]
    # the world frame: columns (b1, b2, b1 × b2)
    b3 = (b1[1] * b2[2] - b1[2] * b2[1],
          b1[2] * b2[0] - b1[0] * b2[2],
          b1[0] * b2[1] - b1[1] * b2[0])
    Bf = [[b1[i], b2[i], b3[i]] for i in range(3)]
    Rw = [[sum(Rp[i][k] * Bf[j][k] for k in range(3)) for j in range(3)]
          for i in range(3)]
    tw = [tp[i] * qs - (Rw[i][0] * c0x + Rw[i][1] * c0y + Rw[i][2] * c0z)
          for i in range(3)]
    ok = chol_ok & (_det3_rows(Rw) > 0) & (tw[2] > 0)
    return _pose_or_default(_quat_from_rows(Rw), tw, ok)


# ---------------------------------------------------------------------------
# adapters: (B, K) samples → (P,) lanes
# ---------------------------------------------------------------------------

def _to_lanes(cam_K, sub3d, sub2d):
    B, K = sub3d.shape[:2]
    P = B * K
    p3 = sub3d.reshape(P, 6, 3)
    p2 = sub2d.reshape(P, 6, 2)
    x = [p3[:, j, 0] for j in range(6)]
    y = [p3[:, j, 1] for j in range(6)]
    z = [p3[:, j, 2] for j in range(6)]
    u = [p2[:, j, 0] for j in range(6)]
    v = [p2[:, j, 1] for j in range(6)]
    Km = cam_K.reshape(B, -1)[:, [0, 4, 2, 5]]      # fx, fy, cx, cy
    Ke = torch.repeat_interleave(Km, K, dim=0)
    return (B, K), x, y, z, u, v, Ke


def epnp6_fast(cam_K, sub3d, sub2d, **kw):
    """cam_K (B, 1, 3, 3) or (B, 3, 3); sub3d (B, K, 6, 3); sub2d
    (B, K, 6, 2) → (pose7 (B, K, 7), ok (B, K))."""
    (B, K), x, y, z, u, v, Ke = _to_lanes(cam_K, sub3d, sub2d)
    pose, ok = epnp6_scalar(x, y, z, u, v, Ke[:, 0], Ke[:, 1], Ke[:, 2],
                            Ke[:, 3], **kw)
    return pose.reshape(B, K, 7), ok.reshape(B, K)


def dlt6_fast(cam_K, sub3d, sub2d):
    (B, K), x, y, z, u, v, Ke = _to_lanes(cam_K, sub3d, sub2d)
    pose, ok = dlt6_scalar(x, y, z, u, v, Ke[:, 0], Ke[:, 1], Ke[:, 2],
                           Ke[:, 3])
    return pose.reshape(B, K, 7), ok.reshape(B, K)


def planar6_fast(cam_K, sub3d, sub2d, pca_sweeps=4):
    (B, K), x, y, z, u, v, Ke = _to_lanes(cam_K, sub3d, sub2d)
    pose, ok = planar6_scalar(x, y, z, u, v, Ke[:, 0], Ke[:, 1], Ke[:, 2],
                              Ke[:, 3], pca_sweeps=pca_sweeps)
    return pose.reshape(B, K, 7), ok.reshape(B, K)


def minimal6(cam_K, sub3d, sub2d, estimators=ESTIMATORS):
    """lc_tpu's accelerator-branch hypothesis stage (lc_tpu/pnp/ransac.py:
    314-324): the named estimators' hypotheses in the order epnp, planar,
    dlt, concatenated: (pose_h (B, nE·K, 7), ok_h (B, nE·K)). The plain
    version of minimal6_kernel.minimal6_cuda."""
    cand = []
    if 'epnp' in estimators:
        cand.append(epnp6_fast(cam_K, sub3d, sub2d, **EPNP_KW))
    if 'planar' in estimators:
        cand.append(planar6_fast(cam_K, sub3d, sub2d, pca_sweeps=PLANAR_SWEEPS))
    if 'dlt' in estimators:
        cand.append(dlt6_fast(cam_K, sub3d, sub2d))
    return (torch.cat([c[0] for c in cand], 1),
            torch.cat([c[1] for c in cand], 1))
