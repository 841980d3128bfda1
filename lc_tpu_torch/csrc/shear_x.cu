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
// 3.35 TB/s, against about 0.5 GFLOP of lerps. What the design does about it:
// a block row per image line (a thread finds its line without 64-bit
// division; the channel count, 1 for the mask or 3 for the RGB crop, is a
// compile-time constant, and the kernel takes no other); each thread makes four consecutive values of the channel-last
// line, so eight independent loads are in flight per thread and the four
// values leave in one 16-byte store; neighbouring threads cover
// neighbouring addresses, so the stores and (along x, or along y where
// neighbouring columns share a source row) the loads coalesce; the second
// tap is the neighbour of the first and comes from L1/L2. The TPU kernel zero-padded every row in device memory and
// kept the whole shift table in SMEM; here each thread reads its line's
// shift (a cached load) and masks the two taps at the line's ends, so no
// padded copy is made. The wrapper keeps B*H*W*C below 2^31, so line and
// element indices fit 32 bits; addresses are formed in 64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ img,
                                     int64_t base, int64_t stride, int i,
                                     int n) {
  return (i >= 0 && i < n) ? __ldg(img + base + (int64_t)i * stride) : 0.0f;
}

// One value of the output: the lerp of its two taps along the shear axis.
template <int NC>
__device__ __forceinline__ float shear_value(
    const float* __restrict__ img, const float* __restrict__ shifts, int b,
    int y, int line, int e, int H, int W, int axis) {
  const int row_len = W * NC;
  const int x = e / NC;
  const int c = e - x * NC;
  // the position along the shear axis, the line's length, its shift, and
  // where the line starts and how far apart its elements lie
  int pos, n;
  float s;
  int64_t base, stride;
  if (axis == 0) {
    pos = x;
    n = W;
    s = __ldg(shifts + line);
    base = (int64_t)line * row_len + c;
    stride = NC;
  } else {
    pos = y;
    n = H;
    s = __ldg(shifts + (int64_t)b * W + x);
    base = (int64_t)b * H * row_len + (int64_t)x * NC + c;
    stride = row_len;
  }
  // clamping the source to [-2, n + 1] keeps the int conversion defined for
  // any shift; there both taps lie outside the line and read zero
  const float src = fminf(fmaxf((float)pos + s, -2.0f), (float)n + 1.0f);
  const float x0f = floorf(src);
  const float f = src - x0f;
  const int i0 = (int)x0f;
  return tap(img, base, stride, i0, n) * (1.0f - f) +
         tap(img, base, stride, i0 + 1, n) * f;
}

// A block row per image line (b, y); each thread makes VEC consecutive
// values of the line (independent loads in flight, one 16-byte store when
// `vec_store`). NC is the channel count, 1 or 3.
constexpr int VEC = 4;

template <int NC>
__global__ void shear_kernel(const float* __restrict__ img,
                             const float* __restrict__ shifts,
                             float* __restrict__ out, int B, int H, int W,
                             int axis, int vec_store) {
  const int row_len = W * NC;
  for (int line = blockIdx.y; line < B * H; line += gridDim.y) {
    const int b = line / H;
    const int y = line - b * H;
    float* __restrict__ orow = out + (int64_t)line * row_len;
    for (int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC; e0 < row_len;
         e0 += gridDim.x * blockDim.x * VEC) {
      float v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        v[k] = e0 + k < row_len
                   ? shear_value<NC>(img, shifts, b, y, line, e0 + k, H, W,
                                     axis)
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

}  // namespace

extern "C" int lc_shear(const float* img, const float* shifts, float* out,
                        int B, int H, int W, int C, int axis,
                        cudaStream_t stream) {
  if (C != 1 && C != 3) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W == 0) return 0;
  const int threads = 128;
  const int row_len = W * C;
  const int lines = B * H;
  dim3 grid((unsigned)((row_len + threads * VEC - 1) / (threads * VEC)),
            (unsigned)(lines < 65535 ? lines : 65535));
  // 16-byte stores need every line to start on a 16-byte boundary
  const int vec_store =
      row_len % VEC == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (C == 3) {
    shear_kernel<3><<<grid, threads, 0, stream>>>(img, shifts, out, B, H, W,
                                                  axis, vec_store);
  } else {
    shear_kernel<1><<<grid, threads, 0, stream>>>(img, shifts, out, B, H, W,
                                                  axis, vec_store);
  }
  return (int)cudaGetLastError();
}
