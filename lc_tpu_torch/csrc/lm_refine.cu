// Fused batched Levenberg-Marquardt PnP refiner for Hopper (sm_90a).
//
// Replaces the TPU kernel lc_tpu/pnp/pallas_lm.py::_lm_kernel (wrapper
// pallas_lm_refine). Same function as lc_tpu_torch/pnp/solver.py::lm_refine,
// the plain PyTorch version it is held against: per problem, a weighted
// reprojection least squares over N points in the right-perturbation chart,
// solved with Ceres's trust-region LM rules (see solver.py's docstring).
//
// What bounds it on this card: not bytes (about 0.9 MB of input at the main
// path's B=32, N=1024) and not arithmetic (about 300 flops per point and
// iteration), but the serial chain of each problem: every iteration is a
// reduction over the points, a 6x6 Cholesky on one thread, a trial-cost
// reduction and the trust-region decision, each waiting on the one before.
//
// Design, simple first: one thread block per problem, LM_THREADS threads.
//  * The problem's points are loaded once into shared memory (7 floats each,
//    28 KB at N = 1024) and stay there for the whole solve, so no iteration
//    touches device memory.
//  * Each evaluation strides the points over the threads; the 28 sums (cost,
//    g[6], upper-triangular H[21]) are reduced with warp shuffles and one
//    pass through shared memory; the trial cost is a one-value reduction.
//  * Thread 0 does the Cholesky, the step and the trust-region update and
//    publishes the state through shared memory; every thread then reads the
//    same done flag, so the loop exit is uniform across the block.
//  * Each block loops until its own problem is done: no lockstep with the
//    slowest problem of the batch.
// The fallback of invalid rows to their initial pose is applied by the
// wrapper (pnp/lm_kernel.py), as pallas_lm.py does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast-math: the parity with the plain version needs IEEE div and sqrt).

#include <cuda_runtime.h>

#define LM_THREADS 128
#define LM_WARPS (LM_THREADS / 32)
#define LM_NSUM 28  // cost, g[6], H upper triangle [21]

#define LM_INITIAL_RADIUS 1e4f
#define LM_MIN_RELATIVE_DECREASE 1e-3f
#define LM_MIN_DIAGONAL 1e-6f
#define LM_MAX_DIAGONAL 1e32f

struct LMState {
  float q[4], t[3];     // current (last accepted) pose
  float qn[4], tn[3];   // trial pose
  float cost, radius, decrease_factor;
  float model_decrease;
  float sums[LM_NSUM];  // reduced GN terms
  float red[LM_WARPS * LM_NSUM];
  float new_cost;
  int chol_ok, done, it;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void quat_to_R(const float* q, float* R) {
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

// Shared-memory point arrays, structure of arrays.
struct Points {
  const float *X0, *X1, *X2, *u, *v, *wu, *wv;
};

// Weighted cost 0.5 * sum(w r^2) of the block's problem at (q, t); the result
// is valid on thread 0 after the call.
__device__ float block_cost(const Points& P, int N, const float* q,
                            const float* t, const float* Kp, float* red) {
  float R[9];
  quat_to_R(q, R);
  const float fx = Kp[0], k01 = Kp[1], cx = Kp[2];
  const float k10 = Kp[3], fy = Kp[4], cy = Kp[5];
  float acc = 0.0f;
  for (int n = threadIdx.x; n < N; n += LM_THREADS) {
    const float X0 = P.X0[n], X1 = P.X1[n], X2 = P.X2[n];
    const float p0 = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0];
    const float p1 = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1];
    const float p2 = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2];
    const float inv_z = 1.0f / fmaxf(p2, 1e-6f);
    const float u0 = p0 * inv_z, v0 = p1 * inv_z;
    const float ru = fx * u0 + k01 * v0 + cx - P.u[n];
    const float rv = k10 * u0 + fy * v0 + cy - P.v[n];
    acc += P.wu[n] * ru * ru + P.wv[n] * rv * rv;
  }
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < LM_WARPS; ++w) total += red[w];
    total *= 0.5f;
  }
  __syncthreads();  // red may be reused right after
  return total;
}

// Cost, gradient and upper-triangular Gauss-Newton matrix at (q, t), reduced
// into S.sums (valid for every thread after the call).
__device__ void block_gn_terms(const Points& P, int N, const float* Kp,
                               LMState& S) {
  float R[9];
  quat_to_R(S.q, R);
  const float fx = Kp[0], k01 = Kp[1], cx = Kp[2];
  const float k10 = Kp[3], fy = Kp[4], cy = Kp[5];
  const float t0 = S.t[0], t1 = S.t[1], t2 = S.t[2];
  float acc[LM_NSUM];
#pragma unroll
  for (int k = 0; k < LM_NSUM; ++k) acc[k] = 0.0f;

  for (int n = threadIdx.x; n < N; n += LM_THREADS) {
    const float X0 = P.X0[n], X1 = P.X1[n], X2 = P.X2[n];
    const float wu = P.wu[n], wv = P.wv[n];
    const float p0 = R[0] * X0 + R[1] * X1 + R[2] * X2 + t0;
    const float p1 = R[3] * X0 + R[4] * X1 + R[5] * X2 + t1;
    const float p2 = R[6] * X0 + R[7] * X1 + R[8] * X2 + t2;
    const float inv_z = 1.0f / fmaxf(p2, 1e-6f);
    const float u0 = p0 * inv_z, v0 = p1 * inv_z;
    const float ru = fx * u0 + k01 * v0 + cx - P.u[n];
    const float rv = k10 * u0 + fy * v0 + cy - P.v[n];

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
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < LM_NSUM; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) S.red[warp * LM_NSUM + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < LM_NSUM) {
    float s = 0.0f;
    for (int w = 0; w < LM_WARPS; ++w) s += S.red[w * LM_NSUM + threadIdx.x];
    S.sums[threadIdx.x] = threadIdx.x == 0 ? 0.5f * s : s;
  }
  __syncthreads();
}

__device__ __forceinline__ int ut_index(int i, int j) {
  // row-major upper triangle of a 6x6 matrix, i <= j
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// Thread 0: solve (H + mu * clip(diag H)) delta = -g by an unrolled Cholesky,
// form the trial pose and the model decrease.
__device__ void propose_step(LMState& S) {
  const float* g = S.sums + 1;
  const float* h = S.sums + 7;
  const float mu = 1.0f / S.radius;
  float A[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      A[i][j] = h[i <= j ? ut_index(i, j) : ut_index(j, i)];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    A[i][i] += mu * fminf(fmaxf(A[i][i], LM_MIN_DIAGONAL), LM_MAX_DIAGONAL);

  float L[6][6];
  int ok = 1;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float acc = A[j][j];
#pragma unroll
    for (int p = 0; p < j; ++p) acc -= L[j][p] * L[j][p];
    ok = ok && (acc > 0.0f);
    const float Ljj = sqrtf(fmaxf(acc, 1e-30f));
    L[j][j] = Ljj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float a = A[i][j];
#pragma unroll
      for (int p = 0; p < j; ++p) a -= L[i][p] * L[j][p];
      L[i][j] = a / Ljj;
    }
  }
  float y[6], d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = -g[i];
#pragma unroll
    for (int p = 0; p < i; ++p) acc -= L[i][p] * y[p];
    y[i] = acc / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int p = i + 1; p < 6; ++p) acc -= L[p][i] * d[p];
    d[i] = acc / L[i][i];
  }

  // model decrease of 0.5 r'Wr under the linearized step (undamped H)
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
  S.model_decrease = -(gd + 0.5f * dHd);
  S.chol_ok = ok;

  // right perturbation through the Taylor chart: q' = q * quat(d_rot)
  const float sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float bw = 1.0f - sq / 8.0f;
  const float f = 0.5f - sq / 48.0f;
  const float bx = d[0] * f, by = d[1] * f, bz = d[2] * f;
  const float aw = S.q[0], ax = S.q[1], ay = S.q[2], az = S.q[3];
  S.qn[0] = aw * bw - ax * bx - ay * by - az * bz;
  S.qn[1] = aw * bx + ax * bw + ay * bz - az * by;
  S.qn[2] = aw * by - ax * bz + ay * bw + az * bx;
  S.qn[3] = aw * bz + ax * by - ay * bx + az * bw;
  S.tn[0] = S.t[0] + d[3];
  S.tn[1] = S.t[1] + d[4];
  S.tn[2] = S.t[2] + d[5];
}

// Thread 0: Ceres's step acceptance and trust-region update.
__device__ void update_region(LMState& S, float ftol) {
  const float cost = S.cost, new_cost = S.new_cost;
  const float md = S.model_decrease;
  const float rho = (cost - new_cost) / fmaxf(md, 1e-30f);
  const bool accept = S.chol_ok && md > 0.0f && rho > LM_MIN_RELATIVE_DECREASE &&
                      isfinite(new_cost);
  float radius;
  if (accept) {
    const float shrink = 2.0f * rho - 1.0f;
    const float grow = fmaxf(1.0f / 3.0f, 1.0f - shrink * shrink * shrink);
    radius = S.radius / grow;
  } else {
    radius = S.radius / S.decrease_factor;
  }
  radius = fminf(fmaxf(radius, 1e-32f), 1e16f);
  S.decrease_factor = accept ? 2.0f : 2.0f * S.decrease_factor;
  S.radius = radius;

  const bool converged = accept && fabsf(cost - new_cost) <= ftol * cost;
  const bool collapsed = radius <= 1e-32f;
  const bool stalled = S.chol_ok && md <= ftol * fmaxf(cost, 1e-30f);
  S.done = converged || collapsed || stalled;
  if (accept) {
#pragma unroll
    for (int i = 0; i < 4; ++i) S.q[i] = S.qn[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) S.t[i] = S.tn[i];
    S.cost = new_cost;
  }
  S.it += 1;
}

__global__ void __launch_bounds__(LM_THREADS)
lm_refine_kernel(const float* __restrict__ pose_in,  // (B, 7)
                 const float* __restrict__ K,        // (B, 3, 3)
                 const float* __restrict__ pts3d,    // (B, N, 3)
                 const float* __restrict__ pts2d,    // (B, N, 2)
                 const float* __restrict__ w2,       // (B, N, 2)
                 const int* __restrict__ n_valid,    // (B,)
                 float* __restrict__ out_pose,       // (B, 7)
                 bool* __restrict__ out_invalid,     // (B,)
                 float* __restrict__ out_cost,       // (B,)
                 int* __restrict__ out_iter,         // (B,)
                 float* __restrict__ out_radius,     // (B,)
                 int N, int max_iter, float ftol) {
  extern __shared__ float pts_smem[];
  __shared__ LMState S;
  __shared__ float Kp[6];
  const int b = blockIdx.x;
  const size_t base = (size_t)b * N;

  Points P;
  P.X0 = pts_smem;
  P.X1 = pts_smem + N;
  P.X2 = pts_smem + 2 * N;
  P.u = pts_smem + 3 * N;
  P.v = pts_smem + 4 * N;
  P.wu = pts_smem + 5 * N;
  P.wv = pts_smem + 6 * N;
  for (int n = threadIdx.x; n < N; n += LM_THREADS) {
    const float* X = pts3d + (base + n) * 3;
    const float* x = pts2d + (base + n) * 2;
    const float* w = w2 + (base + n) * 2;
    pts_smem[n] = X[0];
    pts_smem[N + n] = X[1];
    pts_smem[2 * N + n] = X[2];
    pts_smem[3 * N + n] = x[0];
    pts_smem[4 * N + n] = x[1];
    pts_smem[5 * N + n] = w[0];
    pts_smem[6 * N + n] = w[1];
  }
  if (threadIdx.x == 0) {
    const float* k = K + (size_t)b * 9;
    Kp[0] = k[0]; Kp[1] = k[1]; Kp[2] = k[2];
    Kp[3] = k[3]; Kp[4] = k[4]; Kp[5] = k[5];
    const float* p = pose_in + (size_t)b * 7;
    for (int i = 0; i < 4; ++i) S.q[i] = p[i];
    for (int i = 0; i < 3; ++i) S.t[i] = p[4 + i];
    S.radius = LM_INITIAL_RADIUS;
    S.decrease_factor = 2.0f;
    S.done = n_valid[b] < 3;
    S.it = 0;
  }
  __syncthreads();

  const float cost0 = block_cost(P, N, S.q, S.t, Kp, S.red);
  if (threadIdx.x == 0) S.cost = cost0;

  while (true) {
    __syncthreads();  // publishes thread 0's state update
    if (S.done || S.it >= max_iter) break;
    block_gn_terms(P, N, Kp, S);
    if (threadIdx.x == 0) propose_step(S);
    __syncthreads();
    const float new_cost = block_cost(P, N, S.qn, S.tn, Kp, S.red);
    if (threadIdx.x == 0) {
      S.new_cost = new_cost;
      update_region(S, ftol);
    }
  }

  if (threadIdx.x == 0) {
    float* po = out_pose + (size_t)b * 7;
    for (int i = 0; i < 4; ++i) po[i] = S.q[i];
    for (int i = 0; i < 3; ++i) po[4 + i] = S.t[i];
    const bool too_few = n_valid[b] < 3;
    const bool ran_out = !S.done && S.it >= max_iter;
    out_invalid[b] = too_few || ran_out;
    out_cost[b] = S.cost;
    out_iter[b] = S.it;
    out_radius[b] = S.radius;
  }
}

// C entry point: launches on `stream`, allocates nothing, returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int lc_lm_refine(const float* pose_in, const float* K,
                            const float* pts3d, const float* pts2d,
                            const float* w2, const int* n_valid,
                            float* out_pose, bool* out_invalid,
                            float* out_cost, int* out_iter, float* out_radius,
                            int B, int N, int max_iter, float ftol,
                            void* stream) {
  const size_t smem = (size_t)7 * N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lm_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lm_refine_kernel<<<B, LM_THREADS, smem, (cudaStream_t)stream>>>(
      pose_in, K, pts3d, pts2d, w2, n_valid, out_pose, out_invalid, out_cost,
      out_iter, out_radius, N, max_iter, ftol);
  return (int)cudaGetLastError();
}

// Largest point count one block can hold in shared memory on this device.
extern "C" int lc_lm_max_points(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  const int reserved = (int)(sizeof(LMState) + 6 * sizeof(float)) + 64;
  return (optin - reserved) / (7 * (int)sizeof(float));
}
