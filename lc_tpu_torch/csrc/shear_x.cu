// Per-line fractional shift with bilinear taps: the shear pass of the rotated
// DZI crop (ops/warp.py::rotated_crop_warp), for sm_90a.
//
// Replaces the TPU kernel lc_tpu/ops/pallas_warp.py::_shear_kernel (wrapper
// shear_x_pallas). It computes shear_x_reference's function,
//
//   out[b, y, x, c] = lerp(img[b, y, x0, c], img[b, y, x0 + 1, c], f),
//   x0 = floor(x + s), f = x + s - x0, s = shifts[b, y],
//
// with a tap outside [0, W) reading zero, for any finite shift. With
// axis = 1 the same shift runs along y instead, one shift per column:
//
//   out[b, y, x, c] = lerp(img[b, y0, x, c], img[b, y0 + 1, x, c], f),
//   y0 = floor(y + s), s = shifts[b, x],
//
// which is swapaxes -> shear along x -> swapaxes without the two copies.
//
// What bounds it on the card: bytes. Each output element is two reads of
// neighbouring input elements and one write; at the glmo crop's (32, 384,
// 384, 3) f32 one launch reads and writes 56.6 MB each, which is 0.034 ms at
// 3.35 TB/s, against about 0.5 GFLOP of lerps. The channel count, 1 for the
// mask or 3 for the RGB crop, is a compile-time constant, and the kernel
// takes no other. The TPU kernel zero-padded every row in device memory and
// kept the whole shift table in SMEM; here the two taps are masked at the
// line's ends, so no padded copy is made. The wrapper keeps B*H*W*C below
// 2^31, so line and element indices fit 32 bits; addresses are formed in 64.
//
// The row pass (axis = 0): a block row per image line (a thread finds its
// line without 64-bit division); each thread makes four consecutive values
// of the channel-last line, so eight independent loads are in flight per
// thread and the four values leave in one 16-byte store; neighbouring
// threads cover neighbouring addresses, so loads and stores coalesce, and
// the second tap is the neighbour of the first and comes from L1/L2.
//
// The column pass (axis = 1) through a tile in shared memory: read directly,
// neighbouring columns have their own shifts, so a warp's loads scatter over
// many rows and share no sectors. Instead a block takes a tile of 32 columns
// by TH output rows. Its shifts give the window of source rows the tile
// reads, [floor(y0 + min s), floor(y0 + TH - 1 + max s) + 1] clipped to
// [0, H); the block copies those rows of its columns (32 * C floats each)
// into shared memory with coalesced 16-byte cp.async copies (4-byte ones
// where a row is not 16-byte aligned), then each warp makes whole output
// rows from shared memory: lane i reads word i of a tile row (mod 32), so
// the reads are free of bank conflicts whatever rows the taps fall in, and
// the stores coalesce. For glmo's shears (|s'| <= sin(pi/4) per column) the
// window is about TH + 23 rows. A window larger than the tile's shared
// memory (shifts that vary more across the tile) is walked in chunks of
// rows, each output adding the taps that fall in the chunk, so any finite
// shifts stay exact in the same kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ img,
                                     int64_t base, int64_t stride, int i,
                                     int n) {
  return (i >= 0 && i < n) ? __ldg(img + base + (int64_t)i * stride) : 0.0f;
}

// The source position along a line of n samples, clamped to [-2, n + 1]:
// that keeps the int conversion defined for any shift, and there both taps
// lie outside the line and read zero.
__device__ __forceinline__ float source(int pos, float s, int n) {
  return fminf(fmaxf((float)pos + s, -2.0f), (float)n + 1.0f);
}

// ---------------------------------------------------------------------------
// axis = 0
// ---------------------------------------------------------------------------

// One value of a line of the output: the lerp of its two taps along x.
template <int NC>
__device__ __forceinline__ float row_value(const float* __restrict__ img,
                                           float s, int64_t line_base, int e,
                                           int W) {
  const int x = e / NC;
  const int c = e - x * NC;
  const float src = source(x, s, W);
  const float x0f = floorf(src);
  const float f = src - x0f;
  const int i0 = (int)x0f;
  return tap(img, line_base + c, NC, i0, W) * (1.0f - f) +
         tap(img, line_base + c, NC, i0 + 1, W) * f;
}

constexpr int VEC = 4;

template <int NC>
__global__ void shear_rows_kernel(const float* __restrict__ img,
                                  const float* __restrict__ shifts,
                                  float* __restrict__ out, int B, int H,
                                  int W, int vec_store) {
  const int row_len = W * NC;
  for (int line = blockIdx.y; line < B * H; line += gridDim.y) {
    const float s = __ldg(shifts + line);
    const int64_t line_base = (int64_t)line * row_len;
    float* __restrict__ orow = out + line_base;
    for (int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC; e0 < row_len;
         e0 += gridDim.x * blockDim.x * VEC) {
      float v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        v[k] = e0 + k < row_len
                   ? row_value<NC>(img, s, line_base, e0 + k, W)
                   : 0.0f;
      }
      if (vec_store && e0 + VEC <= row_len) {
        *reinterpret_cast<float4*>(orow + e0) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int k = 0; k < VEC && e0 + k < row_len; ++k) orow[e0 + k] = v[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// axis = 1
// ---------------------------------------------------------------------------

constexpr int TW = 32;            // tile columns
constexpr int TH = 64;            // tile output rows
constexpr int COL_THREADS = 256;  // 8 warps; warp w makes rows w, w + 8, ...
constexpr int COL_WARPS = COL_THREADS / 32;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <int NC>
__global__ void __launch_bounds__(COL_THREADS)
shear_cols_kernel(const float* __restrict__ img,
                  const float* __restrict__ shifts, float* __restrict__ out,
                  int B, int H, int W, int tiles_y, int vec16) {
  constexpr int ROW = TW * NC;  // floats in a tile row
  // window rows one chunk holds: 36 KB at C = 3, 24 KB at C = 1
  constexpr int CHUNK = NC == 3 ? 96 : 192;
  __shared__ __align__(16) float win[CHUNK * ROW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TW;
  const int ncols = min(TW, W - x0);
  const int nvals = ncols * NC;  // valid floats in a tile row
  const int64_t row_len = (int64_t)W * NC;

  for (int tile = blockIdx.y; tile < B * tiles_y; tile += gridDim.y) {
    const int b = tile / tiles_y;
    const int y0 = (tile - b * tiles_y) * TH;
    const int y_last = min(y0 + TH, H) - 1;
    // every warp reads the tile's 32 shifts (lane i: column x0 + i) and
    // finds the same window
    const float s = lane < ncols ? __ldg(shifts + (int64_t)b * W + x0 + lane)
                                 : 0.0f;
    float smin = lane < ncols ? s : INFINITY;
    float smax = lane < ncols ? s : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      smin = fminf(smin, __shfl_xor_sync(0xffffffffu, smin, o));
      smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, o));
    }
    // the source position is monotonic in y and s, so every tap of the tile
    // lies in [r_lo, r_hi]
    const int r_lo = max((int)floorf(source(y0, smin, H)), 0);
    const int r_hi = min((int)floorf(source(y_last, smax, H)) + 1, H - 1);
    const float* __restrict__ src_img = img + (int64_t)b * H * row_len + (int64_t)x0 * NC;

    float acc[TH / COL_WARPS][NC];
#pragma unroll
    for (int j = 0; j < TH / COL_WARPS; ++j)
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[j][k] = 0.0f;

    for (int c0 = r_lo; c0 <= r_hi; c0 += CHUNK) {
      const int rows = min(CHUNK, r_hi + 1 - c0);
      // rows [c0, c0 + rows) of the tile's columns into win
      if (vec16) {
        for (int i = threadIdx.x; i < rows * (ROW / 4); i += COL_THREADS) {
          const int r = i / (ROW / 4);
          const int e = (i - r * (ROW / 4)) * 4;
          if (e < nvals)
            cp_async16(win + r * ROW + e, src_img + (c0 + r) * row_len + e);
        }
      } else {
        for (int i = threadIdx.x; i < rows * ROW; i += COL_THREADS) {
          const int r = i / ROW;
          const int e = i - r * ROW;
          if (e < nvals)
            cp_async4(win + r * ROW + e, src_img + (c0 + r) * row_len + e);
        }
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
      __syncthreads();
#pragma unroll
      for (int j = 0; j < TH / COL_WARPS; ++j) {
        const int y = y0 + warp + COL_WARPS * j;
        if (y > y_last) break;  // the same for the whole warp
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int e = lane + 32 * k;  // word e of the tile row
          const float se = __shfl_sync(0xffffffffu, s, e / NC);
          const float src = source(y, se, H);
          const float y0f = floorf(src);
          const float f = src - y0f;
          const int i0 = (int)y0f - c0;  // row in the chunk
          if (i0 >= 0 && i0 < rows) acc[j][k] += win[i0 * ROW + e] * (1.0f - f);
          if (i0 + 1 >= 0 && i0 + 1 < rows)
            acc[j][k] += win[(i0 + 1) * ROW + e] * f;
        }
      }
      __syncthreads();  // win is refilled by the next chunk or tile
    }

    float* __restrict__ dst = out + (int64_t)b * H * row_len + (int64_t)x0 * NC;
#pragma unroll
    for (int j = 0; j < TH / COL_WARPS; ++j) {
      const int y = y0 + warp + COL_WARPS * j;
      if (y > y_last) break;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int e = lane + 32 * k;
        if (e < nvals) dst[y * row_len + e] = acc[j][k];
      }
    }
  }
}

template <int NC>
int launch(const float* img, const float* shifts, float* out, int B, int H,
           int W, int axis, cudaStream_t stream) {
  if (axis == 0) {
    const int threads = 128;
    const int row_len = W * NC;
    const int lines = B * H;
    dim3 grid((unsigned)((row_len + threads * VEC - 1) / (threads * VEC)),
              (unsigned)(lines < 65535 ? lines : 65535));
    // 16-byte stores need every line to start on a 16-byte boundary
    const int vec_store =
        row_len % VEC == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    shear_rows_kernel<NC><<<grid, threads, 0, stream>>>(img, shifts, out, B,
                                                        H, W, vec_store);
  } else {
    const int tiles_y = (H + TH - 1) / TH;
    const int tiles = B * tiles_y;
    dim3 grid((unsigned)((W + TW - 1) / TW),
              (unsigned)(tiles < 65535 ? tiles : 65535));
    // 16-byte copies need every tile row to start on a 16-byte boundary
    // (tile columns start at multiples of 32, so W * C % 4 == 0 suffices)
    const int vec16 = (W * NC) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(img) % 16 == 0;
    shear_cols_kernel<NC><<<grid, COL_THREADS, 0, stream>>>(
        img, shifts, out, B, H, W, tiles_y, vec16);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lc_shear(const float* img, const float* shifts, float* out,
                        int B, int H, int W, int C, int axis,
                        cudaStream_t stream) {
  if (C != 1 && C != 3) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W == 0) return 0;
  return C == 3 ? launch<3>(img, shifts, out, B, H, W, axis, stream)
                : launch<1>(img, shifts, out, B, H, W, axis, stream);
}
