// The LayerNorm row pass of the bf16 ViT bodies (K1 ln_dense, K4 vit_mlp):
// y = LN(x; g, b, eps) rounded to bf16, one warp a row, two-pass f32
// statistics.  It is the TPU kernels' first rounding point (the LN output
// cast to W's dtype before the product), so the product that follows can
// take y straight from TMA into wgmma.  The statistics and the
// normalisation are the arithmetic of gemm_tile.cuh's LayerNorm prologue
// (the f32 bodies').  D % 8 == 0.
#pragma once

#include "common.cuh"

namespace sa {

constexpr int kLnRows = 8;  // rows (warps) a block

__global__ void __launch_bounds__(32 * kLnRows) ln_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                               const __nv_bfloat16* __restrict__ g,
                                                               const __nv_bfloat16* __restrict__ b,
                                                               __nv_bfloat16* __restrict__ y, int M, int D,
                                                               float eps) {
  const int lane = threadIdx.x % 32, m = blockIdx.x * kLnRows + threadIdx.x / 32;
  if (m >= M) return;
  const __nv_bfloat16* row = x + static_cast<size_t>(m) * D;
  float v[8], s = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    load8(row + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  const float mean = warp_sum(s) / D;
  float q = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    load8(row + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) q += (v[j] - mean) * (v[j] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
  for (int k = lane * 8; k < D; k += 256) {
    float gv[8], bv[8];
    load8(row + k, v);
    load8(g + k, gv);
    load8(b + k, bv);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] - mean) * rstd * gv[j] + bv[j];
    store8(y + static_cast<size_t>(m) * D + k, v);
  }
}

inline cudaError_t launch_ln_rows(const void* x, const void* g, const void* b, void* y, int M, int D, float eps,
                                  cudaStream_t s) {
  if (D % 8 != 0) return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  ln_rows_kernel<<<(M + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b), static_cast<T*>(y), M, D, eps);
  return cudaGetLastError();
}

}  // namespace sa
