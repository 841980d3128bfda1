// Fused batched Levenberg-Marquardt PnP refiner for Hopper (sm_90a).
//
// Replaces the TPU kernel lc_tpu/pnp/pallas_lm.py::_lm_kernel (wrapper
// pallas_lm_refine). Same function as lc_tpu_torch/pnp/solver.py::lm_refine,
// the plain PyTorch version it is held against: per problem, a weighted
// reprojection least squares over N points in the right-perturbation chart,
// solved with Ceres's trust-region LM rules (see solver.py's docstring), with
// the valid mask, the fewer-than-3-points rule and the fallback of an invalid
// solve to its initial pose.
//
// What bounds it on this card: neither bytes (about 0.9 MB of input at the
// main path's B = 32, N = 1024) nor arithmetic (about 250 flops per point and
// pass), but the serial chain of each problem's iterations: a pass over the
// points, a reduction of the sums, a 6x6 solve and the trust-region
// decision, each waiting on the one before. Its roofline bound (operations
// over the f32 peak) is far below that chain. What the design does about
// it:
//  * One launch per call. The kernel takes the weights as given, (B, N) or
//    (B, N, 2), and the valid mask as bool bytes or none; it applies the mask
//    and counts the valid points in its first pass, applies fallback_to_init
//    itself and writes every output into one buffer, so a call is one device
//    operation.
//  * A problem runs on a cluster of kCluster = 4 blocks of kThreads = 128
//    threads. Each block takes a slice of the points: the pass over them,
//    the largest part of an iteration at N = 1024 on one block, is split
//    four ways, and B = 32 problems fill 128 of the 132 SMs. (One block of
//    128, 256 or 512 threads, and clusters of 2, were slower; PERF.md.)
//  * A block's slices of pts3d, pts2d, weights and valid reach shared memory
//    by the bulk asynchronous copy (cp.async.bulk, one thread issuing,
//    completion on an mbarrier); the ends of a slice that are not 16-byte
//    aligned (under 16 bytes each) come by plain loads. The passes read the
//    rows as they lie: pts3d's stride of 3 words is free of bank conflicts,
//    so there is no conversion pass.
//  * One pass over the points per iteration. It evaluates the trial pose's
//    cost together with its gradient g and Gauss-Newton matrix H. On accept
//    these are the next iteration's terms; on reject the terms of the last
//    accepted pose, which every thread keeps in registers, are used again.
//    The first pass, at the initial pose, is the initial cost. Two points
//    are in flight per thread.
//  * One barrier per iteration, of the cluster. A thread's 32 sums (cost,
//    g[6], H's upper triangle [21], the valid count, 3 unused) are
//    reduce-scattered over the warp in 31 shuffles, lane i ending with
//    slot i; after the barrier every warp adds the per-warp
//    slots of all the cluster's blocks (distributed shared memory) in the
//    same order and broadcasts them by shuffles, so every thread holds the
//    same bits. The per-warp slots alternate between two buffers, so the
//    next pass writes without waiting for a second barrier.
//  * No serial section: every thread solves the damped 6x6 system (LDL', no
//    square roots), forms the step and applies the trust-region rule in
//    registers on the same inputs, so the loop's exit is uniform without a
//    flag in shared memory. What remains of each iteration is this chain of
//    IEEE divisions and dependent multiply-adds.
// IEEE division (no fast-math) and no multiply-add contraction
// (-fmad=false, cuda_build.EXTRA_FLAGS), for parity with the plain version:
// contracted, the kernel stopped an LO polish of the sparse path 0.073 mm
// from the float64 referee on a problem where ten float32 runs of the
// plain version lay within 0.023 mm of it (chip_smoke's referee).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kCluster = 4;    // blocks per problem
constexpr int kWarps = kThreads / 32;
constexpr float kInitialRadius = 1e4f;
constexpr float kMinRelativeDecrease = 1e-3f;
constexpr float kMinDiagonal = 1e-6f;
constexpr float kMaxDiagonal = 1e32f;
constexpr int kValidSlot = 28;  // slots 0..27: cost, g[6], H upper [21]

// Shared-memory bytes of one input row of `bytes` bytes: rounded up to 16,
// plus 16 so that the row can start at its source address modulo 16.
__host__ __device__ inline size_t row_region(size_t bytes) {
  return ((bytes + 15) & ~(size_t)15) + 16;
}

// Dynamic shared memory of a block: the four rows and 16 bytes to align the
// base.
__host__ __device__ inline size_t smem_bytes(int N, int per_coord,
                                             int has_valid) {
  return row_region((size_t)12 * N) + row_region((size_t)8 * N) +
         row_region((size_t)4 * (per_coord ? 2 : 1) * N) +
         row_region(has_valid ? (size_t)N : 0) + 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One input row of the block's problem: its bytes in device memory and where
// they land in shared memory (at the same address modulo 16).
struct Row {
  const unsigned char* src;
  uint32_t bytes;
  unsigned char* dst;
};

// Copy the rows into shared memory: each row's 16-byte aligned interior by
// one bulk copy that thread 0 issues on the mbarrier, the rest by plain byte
// loads spread over the threads. Every thread returns after all bytes landed.
__device__ void load_rows(const Row (&rows)[4], uint64_t* bar) {
  const uint32_t bar_a = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uintptr_t lo[4], hi[4];
  uint32_t tx = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uintptr_t s = (uintptr_t)rows[i].src, e = s + rows[i].bytes;
    lo[i] = (s + 15) & ~(uintptr_t)15;
    hi[i] = e & ~(uintptr_t)15;
    if (hi[i] <= lo[i]) lo[i] = hi[i] = e;  // no aligned interior
    tx += (uint32_t)(hi[i] - lo[i]);
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar_a),
                 "r"(tx)
                 : "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (hi[i] > lo[i]) {
        const uintptr_t off = lo[i] - (uintptr_t)rows[i].src;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_addr(rows[i].dst + off)),
            "l"(rows[i].src + off), "r"((uint32_t)(hi[i] - lo[i])), "r"(bar_a)
            : "memory");
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int head = (int)(lo[i] - (uintptr_t)rows[i].src);
    const int tail_at = (int)(hi[i] - (uintptr_t)rows[i].src);
    const int tail = (int)rows[i].bytes - tail_at;
    for (int k = threadIdx.x; k < head + tail; k += kThreads) {
      const int o = k < head ? k : tail_at + (k - head);
      rows[i].dst[o] = rows[i].src[o];
    }
  }
  uint32_t ready = 0;
  while (!ready) {  // the barrier's first phase (parity 0)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ready)
        : "r"(bar_a), "r"(0u)
        : "memory");
  }
  __syncthreads();  // the plain-loaded bytes
}

__device__ __forceinline__ void quat_to_R(const float (&q)[4], float (&R)[9]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float s = 2.0f / (w * w + x * x + y * y + z * z);
  R[0] = 1.0f - s * (y * y + z * z);
  R[1] = s * (x * y - w * z);
  R[2] = s * (x * z + w * y);
  R[3] = s * (x * y + w * z);
  R[4] = 1.0f - s * (x * x + z * z);
  R[5] = s * (y * z - w * x);
  R[6] = s * (x * z - w * y);
  R[7] = s * (y * z + w * x);
  R[8] = 1.0f - s * (x * x + y * y);
}

// The block's problem in shared memory, as the input rows lie.
struct Points {
  const float* X;               // (N, 3)
  const float* uv;              // (N, 2)
  const float* w;               // (N, 2) or (N,)
  const unsigned char* valid;   // (N,) bool bytes, or null: all valid
  int n, per_coord;
};

// This thread's share of the 32 sums at pose (q, t): cost (without the
// factor 1/2), g, H's upper triangle, the valid count.
__device__ __forceinline__ void pass_terms(const Points& P,
                                           const float (&Kp)[6],
                                           const float (&q)[4],
                                           const float (&t)[3],
                                           float (&acc)[32]) {
  float R[9];
  quat_to_R(q, R);
  const float fx = Kp[0], k01 = Kp[1], cx = Kp[2];
  const float k10 = Kp[3], fy = Kp[4], cy = Kp[5];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;

  // two points in flight per thread: their latency chains overlap
#pragma unroll 2
  for (int n = threadIdx.x; n < P.n; n += kThreads) {
    const float X0 = P.X[3 * n], X1 = P.X[3 * n + 1], X2 = P.X[3 * n + 2];
    // the plain version's w * valid
    const float vf = P.valid ? (P.valid[n] ? 1.0f : 0.0f) : 1.0f;
    const float wu = (P.per_coord ? P.w[2 * n] : P.w[n]) * vf;
    const float wv = (P.per_coord ? P.w[2 * n + 1] : P.w[n]) * vf;
    const float p0 = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0];
    const float p1 = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1];
    const float p2 = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2];
    const float inv_z = 1.0f / fmaxf(p2, 1e-6f);
    const float u0 = p0 * inv_z, v0 = p1 * inv_z;
    const float ru = fx * u0 + k01 * v0 + cx - P.uv[2 * n];
    const float rv = k10 * u0 + fy * v0 + cy - P.uv[2 * n + 1];

    // jacobian rows: d(u0, v0)/d(delta) then through K's 2x2 block.
    // rotation columns: dp/drot_k = R (e_k x X)
    float ju[6], jv[6];
    const float C[3][3] = {{0.0f, -X2, X1}, {X2, 0.0f, -X0}, {-X1, X0, 0.0f}};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d0 = R[0] * C[k][0] + R[1] * C[k][1] + R[2] * C[k][2];
      const float d1 = R[3] * C[k][0] + R[4] * C[k][1] + R[5] * C[k][2];
      const float d2 = R[6] * C[k][0] + R[7] * C[k][1] + R[8] * C[k][2];
      const float a = inv_z * (d0 - u0 * d2);
      const float b = inv_z * (d1 - v0 * d2);
      ju[k] = fx * a + k01 * b;
      jv[k] = k10 * a + fy * b;
    }
    // translation columns: dp/dt = I
    ju[3] = fx * inv_z;
    jv[3] = k10 * inv_z;
    ju[4] = k01 * inv_z;
    jv[4] = fy * inv_z;
    {
      const float a = -u0 * inv_z, b = -v0 * inv_z;
      ju[5] = fx * a + k01 * b;
      jv[5] = k10 * a + fy * b;
    }

    // the cost as the plain version forms it: (w r) r
    const float wru = wu * ru, wrv = wv * rv;
    acc[0] += wru * ru + wrv * rv;
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[1 + i] += wru * ju[i] + wrv * jv[i];
    int k = 7;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float wji = wu * ju[i], wvi = wv * jv[i];
#pragma unroll
      for (int j = i; j < 6; ++j) acc[k++] += wji * ju[j] + wvi * jv[j];
    }
    acc[kValidSlot] += vf;
  }
}

// One level of the warp's reduce-scatter: a lane keeps one half of its 2W
// slots, sends the other half to the lane W away and adds what it receives.
// W is a template constant so that v stays in registers.
template <int W>
__device__ __forceinline__ void scatter_level(float (&v)[32], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Reduce-scatter 32 values over the warp in 31 shuffles: lane i ends with
// the warp's sum of slot i in v[0].
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  scatter_level<16>(v, lane);
  scatter_level<8>(v, lane);
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
}

// The problem's sums of the first 29 slots over the blocks of its cluster,
// the same bits in every thread. `red` is one of this block's two per-warp
// buffers, [kWarps][32]; one cluster barrier, after which every thread reads
// the buffers of all the cluster's blocks through distributed shared memory
// and adds the slots in the same order.
__device__ __forceinline__ void problem_sums(float (&v)[32], float* red,
                                             float (&s)[29]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce_scatter(v);
  red[warp * 32 + lane] = v[0];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float part[kCluster][kWarps];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    const float* remote = cluster.map_shared_rank(red, r);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) part[r][w] = remote[w * 32 + lane];
  }
  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[r][w];
#pragma unroll
  for (int k = 0; k < 29; ++k) s[k] = __shfl_sync(0xffffffffu, total, k);
}

__device__ __forceinline__ int ut_index(int i, int j) {
  // row-major upper triangle of a 6x6 matrix, i <= j
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// Solve (H + clip(diag H) / radius) d = -g by an unrolled LDL' factorization
// (Cholesky's pivots squared: the same positive-definiteness test without
// its six square roots on the serial chain); return whether the matrix was
// positive definite, and the model decrease of 0.5 r'Wr under the
// linearized step (undamped H).
__device__ __forceinline__ bool solve_step(const float (&g)[6],
                                           const float (&h)[21], float radius,
                                           float (&d)[6], float& decrease) {
  const float mu = 1.0f / radius;
  // L unit lower triangular, E[j][p] = L[j][p] * D[p], inv[j] = 1 / D[j]
  float L[6][6], E[6][6], inv[6];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float hjj = h[ut_index(j, j)];
    float dj = hjj + mu * fminf(fmaxf(hjj, kMinDiagonal), kMaxDiagonal);
#pragma unroll
    for (int p = 0; p < j; ++p) dj -= L[j][p] * E[j][p];
    ok = ok && (dj > 0.0f);
    dj = fmaxf(dj, 1e-30f);
    inv[j] = 1.0f / dj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float a = h[ut_index(j, i)];
#pragma unroll
      for (int p = 0; p < j; ++p) a -= L[i][p] * E[j][p];
      E[i][j] = a;
      L[i][j] = a * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = -g[i];
#pragma unroll
    for (int p = 0; p < i; ++p) acc -= L[i][p] * y[p];
    y[i] = acc;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float acc = y[i] * inv[i];
#pragma unroll
    for (int p = i + 1; p < 6; ++p) acc -= L[p][i] * d[p];
    d[i] = acc;
  }
  float gd = 0.0f, dHd = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float Hd = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Hd += h[i <= j ? ut_index(i, j) : ut_index(j, i)] * d[j];
    gd += g[i] * d[i];
    dHd += d[i] * Hd;
  }
  decrease = -(gd + 0.5f * dHd);
  return ok;
}

// Right perturbation through the Taylor chart: q' = q * quat(d_rot),
// t' = t + d_t.
__device__ __forceinline__ void perturb(const float (&q)[4],
                                        const float (&t)[3],
                                        const float (&d)[6], float (&qn)[4],
                                        float (&tn)[3]) {
  const float sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float bw = 1.0f - sq / 8.0f;
  const float f = 0.5f - sq / 48.0f;
  const float bx = d[0] * f, by = d[1] * f, bz = d[2] * f;
  qn[0] = q[0] * bw - q[1] * bx - q[2] * by - q[3] * bz;
  qn[1] = q[0] * bx + q[1] * bw + q[2] * bz - q[3] * by;
  qn[2] = q[0] * by - q[1] * bz + q[2] * bw + q[3] * bx;
  qn[3] = q[0] * bz + q[1] * by - q[2] * bx + q[3] * bw;
#pragma unroll
  for (int i = 0; i < 3; ++i) tn[i] = t[i] + d[3 + i];
}

// Outputs, one buffer of 10 B floats and B bytes: pose (B, 7), cost (B,),
// radius (B,), n_iter (B,) int32, then invalid (B,) bool. Problem b runs on
// the blocks of cluster b; the block of rank r takes the r-th of kCluster
// equal slices of the points.
__global__ void __launch_bounds__(kThreads)
lm_refine_kernel(const float* __restrict__ pose_in,  // (B, 7)
                 const float* __restrict__ K,        // (B, 3, 3)
                 const float* __restrict__ pts3d,    // (B, N, 3)
                 const float* __restrict__ pts2d,    // (B, N, 2)
                 const float* __restrict__ weights,  // (B, N, 2) or (B, N)
                 const unsigned char* __restrict__ valid,  // (B, N) or null
                 float* __restrict__ out, int B, int N, int per_coord,
                 int max_iter, float ftol, int fallback) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][kThreads];  // two buffers of [kWarps][32] sums
  __shared__ uint64_t bar;
  const int b = blockIdx.x / kCluster;
  const int rank = blockIdx.x % kCluster;  // the block's rank in its cluster
  const int chunk = (N + kCluster - 1) / kCluster;
  const int n0 = min(rank * chunk, N), n1 = min(n0 + chunk, N);
  const size_t first = (size_t)b * N + n0, m = (size_t)(n1 - n0);
  const int wc = per_coord ? 2 : 1;

  unsigned char* base = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + 15) & ~(uintptr_t)15);
  const unsigned char* src[4] = {
      reinterpret_cast<const unsigned char*>(pts3d + first * 3),
      reinterpret_cast<const unsigned char*>(pts2d + first * 2),
      reinterpret_cast<const unsigned char*>(weights + first * wc),
      valid ? valid + first : nullptr};
  const uint32_t bytes[4] = {(uint32_t)(12 * m), (uint32_t)(8 * m),
                             (uint32_t)(4 * wc * m),
                             valid ? (uint32_t)m : 0u};
  Row rows[4];
  size_t off = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = {src[i], bytes[i], base + off + ((uintptr_t)src[i] & 15)};
    off += row_region(bytes[i]);
  }
  load_rows(rows, &bar);
  const Points P = {reinterpret_cast<const float*>(rows[0].dst),
                    reinterpret_cast<const float*>(rows[1].dst),
                    reinterpret_cast<const float*>(rows[2].dst),
                    valid ? rows[3].dst : nullptr, (int)m, per_coord};

  float q[4], t[3], Kp[6];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __ldg(pose_in + b * 7 + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = __ldg(pose_in + b * 7 + 4 + i);
#pragma unroll
  for (int i = 0; i < 6; ++i) Kp[i] = __ldg(K + b * 9 + i);

  float v[32], s[29];
  pass_terms(P, Kp, q, t, v);
  problem_sums(v, red[0], s);
  int buf = 1;
  float cost = 0.5f * s[0], g[6], h[21];
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = s[1 + i];
#pragma unroll
  for (int i = 0; i < 21; ++i) h[i] = s[7 + i];
  const bool too_few = s[kValidSlot] < 3.0f;

  bool done = too_few;
  int it = 0;
  float radius = kInitialRadius, decrease_factor = 2.0f;
  while (!done && it < max_iter) {
    float d[6], model_decrease, qn[4], tn[3];
    const bool chol_ok = solve_step(g, h, radius, d, model_decrease);
    perturb(q, t, d, qn, tn);
    // a step that cannot be accepted needs no trial cost
    const bool tried = chol_ok && model_decrease > 0.0f;
    float new_cost = cost;
    if (tried) {
      pass_terms(P, Kp, qn, tn, v);
      problem_sums(v, red[buf], s);
      buf ^= 1;
      new_cost = 0.5f * s[0];
    }
    // Ceres's step acceptance and trust-region update
    const float rho = (cost - new_cost) / fmaxf(model_decrease, 1e-30f);
    const bool accept = tried && rho > kMinRelativeDecrease &&
                        isfinite(new_cost);
    if (accept) {
      const float shrink = 2.0f * rho - 1.0f;
      const float grow =
          fmaxf(1.0f / 3.0f, 1.0f - shrink * shrink * shrink);
      radius = radius / grow;
    } else {
      radius = radius / decrease_factor;
    }
    radius = fminf(fmaxf(radius, 1e-32f), 1e16f);
    decrease_factor = accept ? 2.0f : 2.0f * decrease_factor;
    const bool converged = accept && fabsf(cost - new_cost) <= ftol * cost;
    const bool collapsed = radius <= 1e-32f;
    const bool stalled =
        chol_ok && model_decrease <= ftol * fmaxf(cost, 1e-30f);
    done = converged || collapsed || stalled;
    if (accept) {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = qn[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = tn[i];
      cost = new_cost;
#pragma unroll
      for (int i = 0; i < 6; ++i) g[i] = s[1 + i];
#pragma unroll
      for (int i = 0; i < 21; ++i) h[i] = s[7 + i];
    }
    ++it;
  }
  // no block leaves while another may still read its buffers
  cg::this_cluster().sync();

  if (rank == 0 && threadIdx.x == 0) {
    const bool invalid = too_few || !done;  // or ran out of iterations
    const bool keep_init = fallback ? invalid : too_few;
    float* pose = out + (size_t)b * 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) pose[i] = keep_init ? pose_in[b * 7 + i] : q[i];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      pose[4 + i] = keep_init ? pose_in[b * 7 + 4 + i] : t[i];
    out[(size_t)7 * B + b] = cost;
    out[(size_t)8 * B + b] = radius;
    reinterpret_cast<int*>(out + (size_t)9 * B)[b] = it;
    reinterpret_cast<unsigned char*>(out + (size_t)10 * B)[b] = invalid;
  }
}

}  // namespace

// C entry point: launches on `stream`, allocates nothing, returns
// cudaGetLastError() of the launch (0 on success). `valid` may be null (all
// points valid).
extern "C" int lc_lm_refine(const float* pose_in, const float* K,
                            const float* pts3d, const float* pts2d,
                            const float* weights, const unsigned char* valid,
                            float* out, int B, int N, int per_coord,
                            int max_iter, float ftol, int fallback,
                            void* stream) {
  const size_t smem =
      smem_bytes((N + kCluster - 1) / kCluster, per_coord, valid != nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lm_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lm_refine_kernel, pose_in, K, pts3d, pts2d, weights, valid, out,
      B, N, per_coord, max_iter, ftol, fallback);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Largest point count a call takes on this device: a block's slice of
// ceil(N / kCluster) points in the widest rows (per-coordinate weights and a
// valid mask: 29 bytes a point) beside the kernel's static shared memory.
extern "C" int lc_lm_max_points(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, lm_refine_kernel) != cudaSuccess)
    return -1;
  // smem_bytes(n, 1, 1) <= 29 n + 4 * 31 + 16
  const long room =
      (long)optin - (long)attr.sharedSizeBytes - 4 * 31 - 16;
  return room > 0 ? kCluster * (int)(room / 29) : 0;
}
