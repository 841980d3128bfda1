// RANSAC's minimal-sample hypotheses for Hopper (sm_90a): EPnP-6, planar-6
// and DLT-6 on every 6-point sample of a ransac_pnp call, in one launch.
//
// Replaces no Pallas kernel: it replaces the XLA fusion of
// lc_tpu/pnp/fast_minimal.py (epnp6_fast :213, planar6_fast, dlt6_fast),
// which lc_tpu's ransac_pnp runs on every backend but the CPU
// (lc_tpu/pnp/ransac.py:305-324). Its plain PyTorch version, the referee it
// is held against, is lc_tpu_torch/pnp/fast_minimal.py::minimal6, a
// transcription of lc_tpu's module; every value below is computed with the
// operations of the plain version, in the same order, with the same
// structural zeros:
//  * the 12x12 EPnP normal matrix MtM has no (x, y) block, the 11x11 DLT
//    matrix none between its u rows (0-3) and v rows (4-7), the 8x8
//    homography matrix none between rows 0-2 and 3-5; their Cholesky
//    factors have no fill-in there either (no column left of the block has
//    entries in both its rows), so those entries are never formed, read or
//    multiplied (Block::absent);
//  * a sum starts from +0 where lc_tpu's Python sum() starts from 0, and
//    from its first term where lc_tpu starts from None, and adds its terms
//    in lc_tpu's order (never a tree across lanes); a max with a constant
//    lets NaN through (jnp.maximum), unlike fmaxf;
//  * the shifted inverse iteration starts from lc_tpu's basis, the Q of
//    default_rng(7)'s (12, 4) Gaussian, which the wrapper writes once into
//    __constant__ memory (lc_minimal6_set_basis, row-major, 48 floats);
//  * each solver ends with lc_tpu's non-finite test: a pose with a
//    non-finite entry becomes [1,0,0,0,0,0,1] with ok false.
// The file builds without fast-math and with -fmad=false (cuda_build's
// EXTRA_FLAGS): every multiply and add is rounded on its own, as in the
// plain version's one-operation-a-kernel torch code on the card, and
// division and square root are IEEE. atan2f and sincosf (the bits of sinf
// and cosf from one range reduction) come from CUDA's math library, as the
// plain version's atan2, sin and cos do on the card, so the two can agree
// bit for bit; compiled for the host, this file gives lc_tpu's hypotheses
// bit for bit (tests/test_torch_fast_minimal.py, which also runs it at one
// lane an EPnP problem and with the lanes in reverse order).
//
// Layout. A block is 4 warps (fewer where their shared memory would pass
// 48 KB). The EPnP blocks, the longest, come first: a group of
// LC_M6_LANES_EPNP lanes (4) of one warp solves an EPnP problem. Then the
// one-lane blocks: each thread solves planar-6 and DLT-6 (those asked for)
// of its problem, one after the other, so a warp never mixes EPnP with the
// others. `order` packs the codes asked for, two bits each, in lc_tpu's
// order, which sets each estimator's place in the output. A warp stages
// the samples of its problems, which are contiguous, through shared memory
// (neighbouring lanes read neighbouring floats). The lanes of an EPnP
// group exchange data only through the group's slice of shared memory
// (MtM, X, Y: under 0.7 KB), with __syncwarp(group mask) between steps;
// nothing goes through device memory. Two kinds of EPnP step:
//  * split across the lanes, each element with exactly the operations and
//    order of the plain version: lane q forms MtM's sum q (Σ αl αm, Σ αl αm
//    cu, Σ αl αm cv, Σ αl αm (cu² + cv²)) of every (l, m) block; lane k
//    solves column k of the inverse iteration and takes part in modified
//    Gram-Schmidt pipelined across the column owners (at stage kp the owner
//    of column kp normalizes and publishes it, the owners of the later
//    columns take their projections out); lane k forms column k of
//    Y = MtM X;
//  * serial chains, computed by every lane of the group in the same order
//    (the same bits in every lane, no exchange): the 3x3 PCA, the
//    barycentric coordinates, MtM's Cholesky factor, T = Xᵀ Y and its 4x4
//    Jacobi, Vb and its sort, the β Gauss-Newton, Procrustes and its polar
//    iteration, the quaternion.
// Lane 0 of a group writes its pose7 and ok into pose_h (B, nE*K, 7) and
// ok_h (B, nE*K) at lc_tpu's concatenated position b, e*K + k. Groups past
// the last problem return as a whole; every lane of a group runs the same
// steps, so every __syncwarp of a group is reached by all its lanes.
//
// What bounds it on this card: one EPnP chain. At the main path's B = 32,
// K = 150 (P = 4,800 problems an estimator) it reads 0.6 MB and writes
// 0.5 MB, 0.3 us at 3.35 TB/s, against 22,439 f32 operations a problem over
// the three estimators (fast_minimal's operations, counted by
// minimal6_kernel.ops_per_problem), each issued as its own instruction
// under -fmad=false: 3.2 us at 128 lanes x 132 SMs x 1.98 GHz. The card is
// far from that rate: the kernel lasts as long as the longest EPnP chain,
// and the chain is serial. Its 4x4 Rayleigh-Ritz Jacobi alone (48
// rotations, each an atan2f and a sincosf behind the last rotation's
// update) is nearly half of it (perf_scripts/minimal6_phases.py). Lanes
// shorten only the work that splits across elements; the serial chains
// run on every lane of a group, so each lane more multiplies their issue:
// at 4 lanes an EPnP problem the grid holds 750 warps (EPnP 600, planar-6
// and DLT-6 150), about one EPnP warp a scheduler; fewer or more lanes were
// slower with the three estimators (perf_scripts/minimal6_lanes.py).
// Planar-6 and DLT-6 together end well before EPnP-6 at one lane a problem;
// split across lanes they were slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

// lanes an EPnP problem (planar and DLT take one); a warp holds 32 / this
// groups
#ifndef LC_M6_LANES_EPNP
#define LC_M6_LANES_EPNP 4
#endif

namespace {

constexpr int kS = 6;          // points a sample
constexpr int kEpnp = 0, kPlanar = 1, kDlt = 2;

static_assert(LC_M6_LANES_EPNP >= 1 && LC_M6_LANES_EPNP <= 32,
              "a group lies in one warp");

// lc_tpu's 12x4 start basis, row-major: c_basis[4 * i + k]
__constant__ float c_basis[48];

struct Sample {
  float x[kS], y[kS], z[kS], u[kS], v[kS];
  float fx, fy, cx, cy;
};

struct Hyp {
  float pose[7];
  bool ok;
};

// jnp.maximum(a, c) for a constant c: NaN in a stays NaN
__device__ __forceinline__ float maxp(float a, float c) {
  return a < c ? c : a;
}

__device__ __forceinline__ float nan_to_num(float a) {
  if (isnan(a)) return 0.0f;
  if (isinf(a)) return a > 0.0f ? FLT_MAX : -FLT_MAX;
  return a;
}

// entry (i, j) of a symmetric matrix kept in its upper triangle
template <int N>
__device__ __forceinline__ float& sym(float (&a)[N][N], int i, int j) {
  return i <= j ? a[i][j] : a[j][i];
}

// Cyclic Jacobi (lc_tpu's _jacobi_sym) over the pairs (p, q), p < q, in
// lexicographic order, which is the order both of its callers give.
template <int N>
__device__ __forceinline__ void jacobi_sym(float (&a)[N][N], float (&V)[N][N],
                                           int sweeps) {
#pragma unroll 1
  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float app = a[p][p];
        const float aqq = a[q][q];
        const float apq = a[p][q];
        const float theta = 0.5f * atan2f(2.0f * apq, app - aqq);
        float s, c;
        sincosf(theta, &s, &c);   // the bits of sinf and cosf, one reduction
        float old[N], oldq[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          old[k] = sym(a, p, k);
          oldq[k] = sym(a, q, k);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          if (k == p || k == q) continue;
          sym(a, p, k) = c * old[k] + s * oldq[k];
          sym(a, q, k) = -s * old[k] + c * oldq[k];
        }
        const float app_n = c * c * app + 2.0f * s * c * apq + s * s * aqq;
        const float aqq_n = s * s * app - 2.0f * s * c * apq + c * c * aqq;
        a[p][p] = app_n;
        a[q][q] = aqq_n;
        a[p][q] = 0.0f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float vp = V[i][p];
          const float vq = V[i][q];
          V[i][p] = c * vp + s * vq;
          V[i][q] = -s * vp + c * vq;
        }
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void set_identity(float (&V)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) V[i][k] = i == k ? 1.0f : 0.0f;
}

// swap eigenpairs i and j where vals[i] > vals[j] (lc_tpu's cswap)
template <int R, int N>
__device__ __forceinline__ void cswap(float (&vals)[N], float (&V)[R][N], int i,
                                      int j) {
  const bool swap = vals[i] > vals[j];
  const float vi = vals[i], vj = vals[j];
  vals[i] = swap ? vj : vi;
  vals[j] = swap ? vi : vj;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float ci = V[r][i], cj = V[r][j];
    V[r][i] = swap ? cj : ci;
    V[r][j] = swap ? ci : cj;
  }
}

// symmetric 3x3 eigendecomposition (lc_tpu's _eigh3): values ascending,
// eigenvectors as the columns of V
__device__ __forceinline__ void eigh3(float cxx, float cxy, float cxz,
                                      float cyy, float cyz, float czz,
                                      int sweeps, float (&vals)[3],
                                      float (&V)[3][3]) {
  float a[3][3];
  a[0][0] = cxx; a[0][1] = cxy; a[0][2] = cxz;
  a[1][1] = cyy; a[1][2] = cyz; a[2][2] = czz;
  set_identity(V);
  jacobi_sym(a, V, sweeps);
  vals[0] = a[0][0];
  vals[1] = a[1][1];
  vals[2] = a[2][2];
  cswap(vals, V, 0, 1);
  cswap(vals, V, 1, 2);
  cswap(vals, V, 0, 1);
}

// The structural zeros of a matrix below its diagonal: rows [R0, R1) x
// columns [C0, C1) (none when R0 == R1). They are the zeros of the
// Cholesky factor as well (no fill-in, see the top of the file).
template <int R0, int R1, int C0, int C1>
struct Block {
  __host__ __device__ static constexpr bool absent(int i, int j) {
    return i >= R0 && i < R1 && j >= C0 && j < C1;
  }
};
using Dense = Block<0, 0, 0, 0>;

// Unrolled Cholesky (lc_tpu's _chol_lists) of the symmetric matrix with
// diagonal `diag` and off-diagonal entries A[j][i], j < i (upper triangle).
// L[i][j], i > j, and Ld = 1 / diag(L). Returns ok (every pivot > 1e-30).
template <int N, class Z>
__device__ __forceinline__ bool chol(const float (&A)[N][N],
                                     const float (&diag)[N], float (&L)[N][N],
                                     float (&Ld)[N]) {
  const float eps = 1e-30f;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = diag[j];
#pragma unroll
    for (int k = 0; k < j; ++k)
      if (!Z::absent(j, k)) s = s - L[j][k] * L[j][k];
    ok = ok && (s > eps);
    const float ljj = sqrtf(maxp(s, eps));
    L[j][j] = ljj;
    Ld[j] = 1.0f / ljj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      if (Z::absent(i, j)) continue;
      float t = A[j][i];
#pragma unroll
      for (int k = 0; k < j; ++k)
        if (!Z::absent(i, k) && !Z::absent(j, k)) t = t - L[i][k] * L[j][k];
      L[i][j] = t * Ld[j];
    }
  }
  return ok;
}

// forward and back substitution in place (lc_tpu's _chol_solve_lists)
template <int N, class Z>
__device__ __forceinline__ void chol_solve(const float (&L)[N][N],
                                           const float (&Ld)[N],
                                           float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k)
      if (!Z::absent(i, k)) s = s - L[i][k] * x[k];
    x[i] = s * Ld[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k)
      if (!Z::absent(k, i)) s = s - L[k][i] * x[k];
    x[i] = s * Ld[i];
  }
}

// Newton-Schulz polar factor of a 3x3, 12 steps (lc_tpu's _polar3); M in
// rows, the result in X
__device__ __forceinline__ void polar3(const float (&M)[3][3],
                                       float (&X)[3][3]) {
  float fro = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) fro = fro + M[i][j] * M[i][j];
  const float inv = 1.0f / sqrtf(maxp(fro, 1e-20f));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) X[i][j] = M[i][j] * inv;
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    float G[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float g = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) g = g + X[i][k] * X[j][k];
        G[i][j] = g;
      }
    float Xn[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float g = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) g = g + G[i][k] * X[k][j];
        Xn[i][j] = 1.5f * X[i][j] - 0.5f * g;
      }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) X[i][j] = Xn[i][j];
  }
}

__device__ __forceinline__ float det3(const float (&R)[3][3]) {
  return R[0][0] * (R[1][1] * R[2][2] - R[1][2] * R[2][1]) -
         R[0][1] * (R[1][0] * R[2][2] - R[1][2] * R[2][0]) +
         R[0][2] * (R[1][0] * R[2][1] - R[1][1] * R[2][0]);
}

// branchless Shepperd quaternion (w, x, y, z), w >= 0 (lc_tpu's
// _quat_from_rows)
__device__ __forceinline__ void quat_from_rows(const float (&R)[3][3],
                                               float (&q)[4]) {
  const float m00 = R[0][0], m01 = R[0][1], m02 = R[0][2];
  const float m10 = R[1][0], m11 = R[1][1], m12 = R[1][2];
  const float m20 = R[2][0], m21 = R[2][1], m22 = R[2][2];
  const float tr = m00 + m11 + m22;
  const float qw2 = maxp(1.0f + tr, 0.0f);
  const float qx2 = maxp(1.0f + m00 - m11 - m22, 0.0f);
  const float qy2 = maxp(1.0f - m00 + m11 - m22, 0.0f);
  const float qz2 = maxp(1.0f - m00 - m11 + m22, 0.0f);
  const float cands[4][4] = {
      {qw2, m21 - m12, m02 - m20, m10 - m01},
      {m21 - m12, qx2, m01 + m10, m02 + m20},
      {m02 - m20, m01 + m10, qy2, m12 + m21},
      {m10 - m01, m02 + m20, m12 + m21, qz2},
  };
  const float mags[4] = {qw2, qx2, qy2, qz2};
  float best = mags[0];
  float out[4] = {cands[0][0], cands[0][1], cands[0][2], cands[0][3]};
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const bool better = mags[i] > best;
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = better ? cands[i][k] : out[k];
    best = better ? mags[i] : best;
  }
  const float norm = sqrtf(out[0] * out[0] + out[1] * out[1] +
                           out[2] * out[2] + out[3] * out[3]);
  const float inv = 1.0f / maxp(norm, 1e-20f);
  const float sign = out[0] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = out[k] * inv * sign;
}

// lc_tpu's ending: the pose, or the default pose with ok false where it is
// not finite
__device__ __forceinline__ Hyp finish(const float (&R)[3][3], float tx,
                                      float ty, float tz, bool ok) {
  Hyp h;
  float q[4];
  quat_from_rows(R, q);
  h.pose[0] = q[0]; h.pose[1] = q[1]; h.pose[2] = q[2]; h.pose[3] = q[3];
  h.pose[4] = tx; h.pose[5] = ty; h.pose[6] = tz;
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 7; ++i) finite = finite && isfinite(h.pose[i]);
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 7; ++i) h.pose[i] = 0.0f;
    h.pose[0] = 1.0f;
    h.pose[6] = 1.0f;
  }
  h.ok = ok && finite;
  return h;
}

// the sample's centroid and the points about it
__device__ __forceinline__ void center(const Sample& s, float inv_s,
                                       float& c0x, float& c0y, float& c0z,
                                       float (&dx)[kS], float (&dy)[kS],
                                       float (&dz)[kS]) {
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
  for (int j = 0; j < kS; ++j) sx = sx + s.x[j];
#pragma unroll
  for (int j = 0; j < kS; ++j) sy = sy + s.y[j];
#pragma unroll
  for (int j = 0; j < kS; ++j) sz = sz + s.z[j];
  c0x = sx * inv_s;
  c0y = sy * inv_s;
  c0z = sz * inv_s;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    dx[j] = s.x[j] - c0x;
    dy[j] = s.y[j] - c0y;
    dz[j] = s.z[j] - c0z;
  }
}

// the six sums of products of the centred coordinates (a scatter matrix)
__device__ __forceinline__ void scatter(const float (&dx)[kS],
                                        const float (&dy)[kS],
                                        const float (&dz)[kS], float (&c)[6]) {
  float cxx = 0.0f, cyy = 0.0f, czz = 0.0f, cxy = 0.0f, cxz = 0.0f,
        cyz = 0.0f;
#pragma unroll
  for (int j = 0; j < kS; ++j) cxx = cxx + dx[j] * dx[j];
#pragma unroll
  for (int j = 0; j < kS; ++j) cyy = cyy + dy[j] * dy[j];
#pragma unroll
  for (int j = 0; j < kS; ++j) czz = czz + dz[j] * dz[j];
#pragma unroll
  for (int j = 0; j < kS; ++j) cxy = cxy + dx[j] * dy[j];
#pragma unroll
  for (int j = 0; j < kS; ++j) cxz = cxz + dx[j] * dz[j];
#pragma unroll
  for (int j = 0; j < kS; ++j) cyz = cyz + dy[j] * dz[j];
  c[0] = cxx; c[1] = cxy; c[2] = cxz; c[3] = cyy; c[4] = cyz; c[5] = czz;
}

// --------------------------------------------------------------------------
// lane groups
// --------------------------------------------------------------------------

// The G lanes of one warp that solve one problem: lane in [0, G), mask the
// group's bits in the warp.
template <int G>
struct Group {
  int lane;
  unsigned mask;
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

template <int G>
__device__ __forceinline__ Group<G> make_group() {
  const int t = (int)threadIdx.x & 31;
  Group<G> g;
  g.lane = t % G;
  g.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (t - t % G);
  return g;
}

// --------------------------------------------------------------------------
// EPnP-6 (lc_tpu's epnp6_scalar, eig_iters = 3, gn_iters = 4,
// pca_sweeps = 4), a problem over G lanes
// --------------------------------------------------------------------------

// what the lanes of one EPnP problem exchange
struct EpnpWs {
  float M[78];      // MtM's upper triangle, row by row (upper())
  float X[12][4];   // the inverse iteration's basis, a column as it is final
  float Y[12][4];   // MtM X
};

// the place of MtM's (i, j), i <= j, in EpnpWs::M
__host__ __device__ constexpr int upper(int i, int j) {
  return i * (23 - i) / 2 + j;
}

// the 6 pairs of control points, (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
__host__ __device__ constexpr int pair_first(int p) {
  return p < 3 ? 0 : p < 5 ? 1 : 2;
}
__host__ __device__ constexpr int pair_second(int p) {
  return p < 3 ? p + 1 : p < 5 ? p - 1 : 3;
}

template <int G>
__device__ __forceinline__ Hyp epnp6(const Group<G>& g, EpnpWs& w,
                                     const Sample& s) {
  const float inv_s = (float)(1.0 / kS);
  float c0x, c0y, c0z, dx[kS], dy[kS], dz[kS];
  center(s, inv_s, c0x, c0y, c0z, dx, dy, dz);
  float cov[6];
  scatter(dx, dy, dz, cov);
  float vals[3], V3[3][3];
  eigh3(cov[0] * inv_s, cov[1] * inv_s, cov[2] * inv_s, cov[3] * inv_s,
        cov[4] * inv_s, cov[5] * inv_s, 4, vals, V3);
  float scale[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) scale[k] = sqrtf(maxp(vals[k], 1e-9f));
  // world control points: c0 and c0 + the PCA axes
  float ctrl[4][3];
  ctrl[0][0] = c0x; ctrl[0][1] = c0y; ctrl[0][2] = c0z;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ctrl[k + 1][0] = c0x + V3[0][k] * scale[k];
    ctrl[k + 1][1] = c0y + V3[1][k] * scale[k];
    ctrl[k + 1][2] = c0z + V3[2][k] * scale[k];
  }

  // barycentric coordinates: invert the 3x3 whose columns are the axes
  float b[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) b[i][k] = V3[i][k] * scale[k];
  const float A00 = b[1][1] * b[2][2] - b[1][2] * b[2][1];
  const float A01 = b[0][2] * b[2][1] - b[0][1] * b[2][2];
  const float A02 = b[0][1] * b[1][2] - b[0][2] * b[1][1];
  const float A10 = b[1][2] * b[2][0] - b[1][0] * b[2][2];
  const float A11 = b[0][0] * b[2][2] - b[0][2] * b[2][0];
  const float A12 = b[0][2] * b[1][0] - b[0][0] * b[1][2];
  const float A20 = b[1][0] * b[2][1] - b[1][1] * b[2][0];
  const float A21 = b[0][1] * b[2][0] - b[0][0] * b[2][1];
  const float A22 = b[0][0] * b[1][1] - b[0][1] * b[1][0];
  const float det = b[0][0] * A00 + b[0][1] * A10 + b[0][2] * A20;
  const float inv_det = 1.0f / (fabsf(det) > 1e-30f ? det : 1e-30f);
  float alph[kS][4];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const float b1 = (A00 * dx[j] + A01 * dy[j] + A02 * dz[j]) * inv_det;
    const float b2 = (A10 * dx[j] + A11 * dy[j] + A12 * dz[j]) * inv_det;
    const float b3 = (A20 * dx[j] + A21 * dy[j] + A22 * dz[j]) * inv_det;
    alph[j][0] = 1.0f - b1 - b2 - b3;
    alph[j][1] = b1;
    alph[j][2] = b2;
    alph[j][3] = b3;
  }

  // MtM, upper triangle; the (x, y) block rows 4-7 x columns 0-3 is
  // absent. Lane q forms sum q of every (l, m) block: Σ αl αm w with w = 1
  // (q = 0, MtM[l][m] and MtM[4+l][4+m]), cu (1, MtM[l][8+m]), cv (2,
  // MtM[4+l][8+m]), cu² + cv² (3, MtM[8+l][8+m]); a product with w = 1
  // is the product itself.
  using ZM = Block<4, 8, 0, 4>;
  {
    float cu[kS], cv[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      cu[j] = s.cx - s.u[j];
      cv[j] = s.cy - s.v[j];
    }
    const float fx2 = s.fx * s.fx, fy2 = s.fy * s.fy;
    for (int q = g.lane; q < 4; q += G) {
      float wt[kS];
#pragma unroll
      for (int j = 0; j < kS; ++j)
        wt[j] = q == 0   ? 1.0f
                : q == 1 ? cu[j]
                : q == 2 ? cv[j]
                         : cu[j] * cu[j] + cv[j] * cv[j];
      const int r0 = q == 3 ? 8 : q == 2 ? 4 : 0, c0 = q == 0 ? 0 : 8;
      const float sc = q == 0 ? fx2 : q == 1 ? s.fx : q == 2 ? s.fy : 1.0f;
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int m = l; m < 4; ++m) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < kS; ++j)
            acc = acc + alph[j][l] * alph[j][m] * wt[j];
          const float v = sc * acc;
          w.M[upper(r0 + l, c0 + m)] = v;
          if (q == 0)
            w.M[upper(4 + l, 4 + m)] = fy2 * acc;
          else if (q != 3 && m != l)
            w.M[upper(r0 + m, c0 + l)] = v;
        }
    }
  }
  g.sync();
  float M[12][12];
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int j = i; j < 12; ++j)
      if (!ZM::absent(j, i)) M[i][j] = w.M[upper(i, j)];

  // shifted inverse subspace iteration for the 4 smallest eigenvectors;
  // every lane factors MtM, lane k solves column k
  float tr = 0.0f;
#pragma unroll
  for (int i = 0; i < 12; ++i) tr = tr + M[i][i];
  const float shift = 1e-6f * tr / 12.0f + 1e-25f;
  float diag[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) diag[i] = M[i][i] + shift;
  float L[12][12], Ld[12];
  const bool chol_ok = chol<12, ZM>(M, diag, L, Ld);
  constexpr int C = (4 + G - 1) / G;   // columns a lane: k = lane + c G
  float x[C][12];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = g.lane + c * G;
    if (k < 4)
#pragma unroll
      for (int i = 0; i < 12; ++i) x[c][i] = c_basis[4 * i + k];
  }
#pragma unroll 1
  for (int it = 0; it < 3; ++it) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (g.lane + c * G < 4) chol_solve<12, ZM>(L, Ld, x[c]);
    // modified Gram-Schmidt over the 4 columns: at stage kp the owner of
    // column kp normalizes it and publishes it, then the owners of the
    // later columns take their projection on it out
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (g.lane + c * G != kp) continue;
        float nn = 0.0f;
#pragma unroll
        for (int i = 0; i < 12; ++i) nn = nn + x[c][i] * x[c][i];
        const float inv_n = 1.0f / sqrtf(maxp(nn, 1e-30f));
#pragma unroll
        for (int i = 0; i < 12; ++i) {
          x[c][i] = x[c][i] * inv_n;
          w.X[i][kp] = x[c][i];
        }
      }
      g.sync();
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = g.lane + c * G;
        if (k <= kp || k >= 4) continue;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < 12; ++i) dot = dot + w.X[i][kp] * x[c][i];
#pragma unroll
        for (int i = 0; i < 12; ++i) x[c][i] = x[c][i] - dot * w.X[i][kp];
      }
    }
  }

  // Rayleigh-Ritz: lane k forms column k of Y = MtM X (each entry's sum
  // over j from its first term); every lane then forms T = Xᵀ Y (each sum
  // over the rows in order, from 0), its Jacobi rotation Q and Vb = X Q
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = g.lane + c * G;
    if (k >= 4) continue;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      float acc = 0.0f;
      bool first = true;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        if (ZM::absent(i, j) || ZM::absent(j, i)) continue;
        const float term = sym(M, i, j) * x[c][j];
        acc = first ? term : acc + term;
        first = false;
      }
      w.Y[i][k] = acc;
    }
  }
  g.sync();
  float X[12][4];
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) X[i][k] = w.X[i][k];
  float T[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = a; c < 4; ++c) T[a][c] = 0.0f;
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = a; c < 4; ++c) T[a][c] = T[a][c] + X[i][a] * w.Y[i][c];
  float Q[4][4];
  set_identity(Q);
  jacobi_sym(T, Q, 8);
  float tvals[4] = {T[0][0], T[1][1], T[2][2], T[3][3]};
  float Vb[12][4];
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc = acc + X[i][j] * Q[j][k];
      Vb[i][k] = acc;
    }
  cswap(tvals, Vb, 0, 1);
  cswap(tvals, Vb, 2, 3);
  cswap(tvals, Vb, 0, 2);
  cswap(tvals, Vb, 1, 3);
  cswap(tvals, Vb, 1, 2);

  // the 6 distances of the world control points; diff(p, k, c) is
  // coordinate c of the camera-frame difference of pair p in basis k
  float d_w[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int i = pair_first(p), j = pair_second(p);
    const float ddx = ctrl[i][0] - ctrl[j][0];
    const float ddy = ctrl[i][1] - ctrl[j][1];
    const float ddz = ctrl[i][2] - ctrl[j][2];
    d_w[p] = sqrtf(maxp(ddx * ddx + ddy * ddy + ddz * ddz, 1e-30f));
  }
#define DIFF(p, k, c) \
  (Vb[4 * (c) + pair_first(p)][k] - Vb[4 * (c) + pair_second(p)][k])
  // β from the N = 1 case (basis vector 0, the smallest)
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const float d0 = DIFF(p, 0, 0), d1 = DIFF(p, 0, 1), d2 = DIFF(p, 0, 2);
    const float dv = sqrtf(maxp(d0 * d0 + d1 * d1 + d2 * d2, 1e-30f));
    num = num + dv * d_w[p];
    den = den + dv * dv;
  }
  float betas[4] = {num / maxp(den, 1e-12f), 0.0f, 0.0f, 0.0f};

  // Gauss-Newton on the 6 squared-distance constraints over 4 betas
#pragma unroll 1
  for (int it = 0; it < 4; ++it) {
    float Jt[4][6], r[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      float e[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc = acc + betas[k] * DIFF(p, k, c);
        e[c] = acc;
      }
      r[p] = e[0] * e[0] + e[1] * e[1] + e[2] * e[2] - d_w[p] * d_w[p];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Jt[k][p] = 2.0f * (e[0] * DIFF(p, k, 0) + e[1] * DIFF(p, k, 1) +
                           e[2] * DIFF(p, k, 2));
    }
    float JtJ[4][4], jd[4], Jtr[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = a; c < 4; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int p = 0; p < 6; ++p) acc = acc + Jt[a][p] * Jt[c][p];
        JtJ[a][c] = acc;
      }
      jd[a] = JtJ[a][a] + 1e-9f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int p = 0; p < 6; ++p) acc = acc + Jt[k][p] * r[p];
      Jtr[k] = acc;
    }
    float Lb[4][4], Lbd[4];
    chol<4, Dense>(JtJ, jd, Lb, Lbd);
    chol_solve<4, Dense>(Lb, Lbd, Jtr);
#pragma unroll
    for (int k = 0; k < 4; ++k) betas[k] = betas[k] - nan_to_num(Jtr[k]);
  }
#undef DIFF

  // camera control points; cheirality by the mean z of the 6 points
  float cc[4][3];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = acc + betas[k] * Vb[4 * c + p][k];
      cc[p][c] = acc;
    }
  float mean_z = 0.0f;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p) acc = acc + alph[j][p] * cc[p][2];
    mean_z = mean_z + acc;
  }
  const float flip = mean_z < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < 3; ++c) cc[p][c] = cc[p][c] * flip;

  // Procrustes world -> camera on the 4 control points
  float mw[3], mc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float sw = 0.0f, sc = 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p) sw = sw + ctrl[p][c];
#pragma unroll
    for (int p = 0; p < 4; ++p) sc = sc + cc[p][c];
    mw[c] = sw * 0.25f;
    mc[c] = sc * 0.25f;
  }
  float H[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = 0.0f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float a3[3], b3[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a3[c] = cc[p][c] - mc[c];
      b3[c] = ctrl[p][c] - mw[c];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) H[i][j] = H[i][j] + a3[i] * b3[j];
  }
  float R[3][3];
  polar3(H, R);
  const bool ok = chol_ok && det3(R) > 0.0f;
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = mc[i] - (R[i][0] * mw[0] + R[i][1] * mw[1] + R[i][2] * mw[2]);
  return finish(R, t[0], t[1], t[2], ok);
}

// --------------------------------------------------------------------------
// DLT-6 (lc_tpu's dlt6_scalar)
// --------------------------------------------------------------------------

__device__ __noinline__ Hyp dlt6(const Sample& s) {
  const float inv_s = (float)(1.0 / kS);
  float xn[kS], yn[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    xn[j] = (s.u[j] - s.cx) / s.fx;
    yn[j] = (s.v[j] - s.cy) / s.fy;
  }
  float c0x, c0y, c0z, dx[kS], dy[kS], dz[kS];
  center(s, inv_s, c0x, c0y, c0z, dx, dy, dz);
  float ms = 0.0f;
#pragma unroll
  for (int j = 0; j < kS; ++j)
    ms = ms + (dx[j] * dx[j] + dy[j] * dy[j] + dz[j] * dz[j]);
  ms = ms * inv_s;
  const float s3d = maxp(sqrtf(ms / 3.0f), 1e-6f);
  const float inv3d = 1.0f / s3d;

  // AᵀA (11x11, upper triangle) and Aᵀb: rows 0-3 meet only the u rows,
  // rows 4-7 only the v rows (the block rows 4-7 x columns 0-3 is absent),
  // rows 8-10 both; each entry's sum starts from its first term
  using ZA = Block<4, 8, 0, 4>;
  float A[11][11], rhs[11];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const float ru[4] = {dx[j] * inv3d, dy[j] * inv3d, dz[j] * inv3d, 1.0f};
    float w3[3], w3v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w3[c] = -xn[j] * ru[c];
      w3v[c] = -yn[j] * ru[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = a; c < 4; ++c) {
        const float val = ru[a] * ru[c];
        A[a][c] = j == 0 ? val : A[a][c] + val;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float val = ru[a] * w3[c];
        A[a][8 + c] = j == 0 ? val : A[a][8 + c] + val;
      }
      const float t = ru[a] * xn[j];
      rhs[a] = j == 0 ? t : rhs[a] + t;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = a; c < 4; ++c) {
        const float val = ru[a] * ru[c];
        A[4 + a][4 + c] = j == 0 ? val : A[4 + a][4 + c] + val;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float val = ru[a] * w3v[c];
        A[4 + a][8 + c] = j == 0 ? val : A[4 + a][8 + c] + val;
      }
      const float t = ru[a] * yn[j];
      rhs[4 + a] = j == 0 ? t : rhs[4 + a] + t;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int c = a; c < 3; ++c) {
        const float val = w3[a] * w3[c] + w3v[a] * w3v[c];
        A[8 + a][8 + c] = j == 0 ? val : A[8 + a][8 + c] + val;
      }
      const float t = w3[a] * xn[j] + w3v[a] * yn[j];
      rhs[8 + a] = j == 0 ? t : rhs[8 + a] + t;
    }
  }
  float diag[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) diag[i] = A[i][i] + 1e-8f;
  float L[11][11], Ld[11];
  const bool chol_ok = chol<11, ZA>(A, diag, L, Ld);
  chol_solve<11, ZA>(L, Ld, rhs);
  const float* h = rhs;

  // P' = λ'[R | t'] for the normalized points: the rows of M from h
  const float M[3][3] = {{h[0], h[1], h[2]}, {h[4], h[5], h[6]},
                         {h[8], h[9], h[10]}};
  float R[3][3];
  polar3(M, R);
  float lam_p = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) lam_p = lam_p + R[i][j] * M[i][j];
  const float lam = lam_p / 3.0f * inv3d;
  const bool ok = chol_ok && lam > 1e-12f && det3(R) > 0.0f;
  const float inv_lam = 1.0f / maxp(lam, 1e-12f);
  const float t_vec[3] = {h[3], h[7], 1.0f};
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = t_vec[i] * inv_lam - (R[i][0] * c0x + R[i][1] * c0y + R[i][2] * c0z);
  return finish(R, t[0], t[1], t[2], ok);
}

// --------------------------------------------------------------------------
// planar-6 (lc_tpu's planar6_scalar, pca_sweeps = 4)
// --------------------------------------------------------------------------

__device__ __noinline__ Hyp planar6(const Sample& s) {
  const float inv_s = (float)(1.0 / kS);
  float c0x, c0y, c0z, dx[kS], dy[kS], dz[kS];
  center(s, inv_s, c0x, c0y, c0z, dx, dy, dz);
  float cov[6];
  scatter(dx, dy, dz, cov);
  float vals[3], V3[3][3];
  eigh3(cov[0], cov[1], cov[2], cov[3], cov[4], cov[5], 4, vals, V3);
  const float b1[3] = {V3[0][2], V3[1][2], V3[2][2]};  // in the plane
  const float b2[3] = {V3[0][1], V3[1][1], V3[2][1]};
  float q1[kS], q2[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    q1[j] = dx[j] * b1[0] + dy[j] * b1[1] + dz[j] * b1[2];
    q2[j] = dx[j] * b2[0] + dy[j] * b2[1] + dz[j] * b2[2];
  }
  float qq = 0.0f;
#pragma unroll
  for (int j = 0; j < kS; ++j) qq = qq + (q1[j] * q1[j] + q2[j] * q2[j]);
  const float qs = sqrtf(maxp(qq * inv_s * 0.5f, 1e-12f));
  const float inv_qs = 1.0f / qs;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    q1[j] = q1[j] * inv_qs;
    q2[j] = q2[j] * inv_qs;
  }

  // the homography's normal equations (8x8, upper triangle; rows 3-5 x
  // columns 0-2 absent): rows [q1 q2 1 000 −x q1 −x q2] = x, and the v row
  using ZA = Block<3, 6, 0, 3>;
  float A[8][8], rhs[8];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const float xn = (s.u[j] - s.cx) / s.fx;
    const float yn = (s.v[j] - s.cy) / s.fy;
    const float r3[3] = {q1[j], q2[j], 1.0f};
    const float wu[2] = {-xn * q1[j], -xn * q2[j]};
    const float wv[2] = {-yn * q1[j], -yn * q2[j]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int c = a; c < 3; ++c) {
        const float val = r3[a] * r3[c];
        A[a][c] = j == 0 ? val : A[a][c] + val;
        A[3 + a][3 + c] = j == 0 ? val : A[3 + a][3 + c] + val;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float vu = r3[a] * wu[c];
        const float vv = r3[a] * wv[c];
        A[a][6 + c] = j == 0 ? vu : A[a][6 + c] + vu;
        A[3 + a][6 + c] = j == 0 ? vv : A[3 + a][6 + c] + vv;
      }
      const float tu = r3[a] * xn;
      const float tv = r3[a] * yn;
      rhs[a] = j == 0 ? tu : rhs[a] + tu;
      rhs[3 + a] = j == 0 ? tv : rhs[3 + a] + tv;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = a; c < 2; ++c) {
        const float val = wu[a] * wu[c] + wv[a] * wv[c];
        A[6 + a][6 + c] = j == 0 ? val : A[6 + a][6 + c] + val;
      }
      const float t = wu[a] * xn + wv[a] * yn;
      rhs[6 + a] = j == 0 ? t : rhs[6 + a] + t;
    }
  }
  float diag[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) diag[i] = A[i][i] + 1e-8f;
  float L[8][8], Ld[8];
  const bool chol_ok = chol<8, ZA>(A, diag, L, Ld);
  chol_solve<8, ZA>(L, Ld, rhs);
  const float* h = rhs;

  const float h1[3] = {h[0], h[3], h[6]};
  const float h2[3] = {h[1], h[4], h[7]};
  const float h3[3] = {h[2], h[5], 1.0f};
  const float n1 = sqrtf(h1[0] * h1[0] + h1[1] * h1[1] + h1[2] * h1[2]);
  const float n2 = sqrtf(h2[0] * h2[0] + h2[1] * h2[1] + h2[2] * h2[2]);
  const float lam = 2.0f / maxp(n1 + n2, 1e-12f);
  float r1[3], r2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r1[c] = lam * h1[c];
    r2[c] = lam * h2[c];
  }
  const float r3[3] = {r1[1] * r2[2] - r1[2] * r2[1],
                       r1[2] * r2[0] - r1[0] * r2[2],
                       r1[0] * r2[1] - r1[1] * r2[0]};
  const float Mp[3][3] = {{r1[0], r2[0], r3[0]},
                          {r1[1], r2[1], r3[1]},
                          {r1[2], r2[2], r3[2]}};
  float Rp[3][3];
  polar3(Mp, Rp);
  // the world frame: columns (b1, b2, b1 x b2)
  const float b3[3] = {b1[1] * b2[2] - b1[2] * b2[1],
                       b1[2] * b2[0] - b1[0] * b2[2],
                       b1[0] * b2[1] - b1[1] * b2[0]};
  const float Bf[3][3] = {{b1[0], b2[0], b3[0]},
                          {b1[1], b2[1], b3[1]},
                          {b1[2], b2[2], b3[2]}};
  float Rw[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = acc + Rp[i][k] * Bf[j][k];
      Rw[i][j] = acc;
    }
  float tw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    tw[i] = lam * h3[i] * qs -
            (Rw[i][0] * c0x + Rw[i][1] * c0y + Rw[i][2] * c0z);
  const bool ok = chol_ok && det3(Rw) > 0.0f && tw[2] > 0.0f;
  return finish(Rw, tw[0], tw[1], tw[2], ok);
}

// --------------------------------------------------------------------------
// the launch
// --------------------------------------------------------------------------

// a warp's shared memory: the samples of its problems, staged by the whole
// warp, then one EPnP exchange slice a group
union WarpWs {
  struct {
    float p3[32 * 3 * kS];
    float p2[32 * 2 * kS];
  } in;
  EpnpWs epnp[32 / LC_M6_LANES_EPNP];
};

// warps a block: 4, or as many as 48 KB of static shared memory holds
constexpr int kWarps = 4 * sizeof(WarpWs) <= 48 * 1024   ? 4
                       : 2 * sizeof(WarpWs) <= 48 * 1024 ? 2
                                                         : 1;
constexpr int kThreads = 32 * kWarps;

// problems a warp, and blocks, of an EPnP or a one-lane block
__host__ __device__ constexpr int per_warp(bool epnp) {
  return 32 / (epnp ? LC_M6_LANES_EPNP : 1);
}
__host__ __device__ constexpr int blocks_of(bool epnp, int P) {
  return (P + kWarps * per_warp(epnp) - 1) / (kWarps * per_warp(epnp));
}

// a hypothesis into row `row` of pose_h and ok_h
__device__ __forceinline__ void put(float* __restrict__ pose,
                                    unsigned char* __restrict__ ok,
                                    size_t row, const Hyp& h) {
#pragma unroll
  for (int i = 0; i < 7; ++i) pose[row * 7 + i] = h.pose[i];
  ok[row] = h.ok ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    minimal6_kernel(const float* __restrict__ cam_K,
                    const float* __restrict__ sub3d,
                    const float* __restrict__ sub2d, float* __restrict__ pose,
                    unsigned char* __restrict__ ok, int B, int Kh, int n_est,
                    int order) {
  __shared__ WarpWs ws[kWarps];
  const int P = B * Kh;
  // the EPnP blocks first, then the one-lane blocks, whose every thread
  // solves planar-6 and DLT-6 (those asked for) of its problem
  int e_epnp = -1;
  for (int e = 0; e < n_est; ++e)
    if (((order >> (2 * e)) & 3) == kEpnp) e_epnp = e;
  const int nb_epnp = e_epnp >= 0 ? blocks_of(true, P) : 0;
  const bool epnp = (int)blockIdx.x < nb_epnp;
  const int blk = (int)blockIdx.x - (epnp ? 0 : nb_epnp);
  // the warp's problems p0 .. p0 + n - 1 are contiguous in sub3d and
  // sub2d: the whole warp stages them, neighbouring lanes on neighbouring
  // floats
  const int G = epnp ? LC_M6_LANES_EPNP : 1;
  const int warp = (int)threadIdx.x >> 5, lane = (int)threadIdx.x & 31;
  const int p0 = (blk * kWarps + warp) * per_warp(epnp);
  const int n = P - p0 < per_warp(epnp) ? P - p0 : per_warp(epnp);
  if (n <= 0) return;   // the whole warp
  WarpWs& w = ws[warp];
  for (int i = lane; i < n * 3 * kS; i += 32)
    w.in.p3[i] = sub3d[(size_t)p0 * (3 * kS) + i];
  for (int i = lane; i < n * 2 * kS; i += 32)
    w.in.p2[i] = sub2d[(size_t)p0 * (2 * kS) + i];
  __syncwarp();
  const int grp = lane / G;
  const int q = grp < n ? grp : 0;
  Sample s;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    s.x[j] = w.in.p3[q * 3 * kS + 3 * j];
    s.y[j] = w.in.p3[q * 3 * kS + 3 * j + 1];
    s.z[j] = w.in.p3[q * 3 * kS + 3 * j + 2];
    s.u[j] = w.in.p2[q * 2 * kS + 2 * j];
    s.v[j] = w.in.p2[q * 2 * kS + 2 * j + 1];
  }
  __syncwarp();   // the EPnP slices reuse the staging
  if (grp >= n) return;   // the whole group
  const int p = p0 + grp;
  const int b = p / Kh;
  const int k = p - b * Kh;
  const float* Kb = cam_K + (size_t)b * 9;
  s.fx = Kb[0];
  s.fy = Kb[4];
  s.cx = Kb[2];
  s.cy = Kb[5];
  const size_t row0 = (size_t)b * n_est * Kh + k;   // + e * Kh
  if (epnp) {
    const Group<LC_M6_LANES_EPNP> g = make_group<LC_M6_LANES_EPNP>();
    const Hyp h = epnp6(g, w.epnp[grp], s);
    if (g.lane == 0) put(pose, ok, row0 + (size_t)e_epnp * Kh, h);
    return;
  }
  for (int e = 0; e < n_est; ++e) {
    const int est = (order >> (2 * e)) & 3;
    if (est == kEpnp) continue;
    put(pose, ok, row0 + (size_t)e * Kh, est == kPlanar ? planar6(s) : dlt6(s));
  }
}

}  // namespace

// Writes the 12x4 start basis (48 floats in host memory, row-major) into
// the current device's constant memory; once a device, before the first
// lc_minimal6 there. Returns the CUDA error code.
extern "C" int lc_minimal6_set_basis(const float* basis) {
  return (int)cudaMemcpyToSymbol(c_basis, basis, 48 * sizeof(float));
}

// The lanes an EPnP problem in this build.
extern "C" int lc_minimal6_lanes() { return LC_M6_LANES_EPNP; }

// Hypotheses of n_est estimators (codes in `order`, two bits each, 0 epnp,
// 1 planar, 2 dlt) for the B*Kh samples: pose (B, n_est*Kh, 7) f32 and ok
// (B, n_est*Kh) bytes. Returns the launch's CUDA error code.
extern "C" int lc_minimal6(const float* cam_K, const float* sub3d,
                           const float* sub2d, float* pose, unsigned char* ok,
                           int B, int Kh, int n_est, int order, void* stream) {
  if (n_est < 1 || n_est > 3) return (int)cudaErrorInvalidValue;
  if ((long)B * Kh == 0) return 0;
  unsigned seen = 0;
  for (int e = 0; e < n_est; ++e) {
    const int est = (order >> (2 * e)) & 3;
    if (est > kDlt || (seen >> est & 1u)) return (int)cudaErrorInvalidValue;
    seen |= 1u << est;
  }
  const unsigned blocks =
      (seen & 1u ? blocks_of(true, B * Kh) : 0) +
      (seen & 6u ? blocks_of(false, B * Kh) : 0);
  minimal6_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cam_K, sub3d, sub2d, pose, ok, B, Kh, n_est, order);
  return (int)cudaGetLastError();
}
