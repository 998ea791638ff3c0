// K4 vit_mlp: gelu_erf(LN(x) @ W1^T + b1) @ W2^T + b2.
// Replaces stereoanywhere_tpu/ops/pallas/vit_mlp.py (vit_mlp); design and
// bound: ops/cuda/vit_mlp.py.
//
// bf16: three launches.  (1) ln_rows_kernel writes LN(x) rounded to bf16,
// one warp a row, two-pass f32 statistics: exactly the rounding the TPU
// kernel applies before its first product, so A can go from TMA straight
// into wgmma.  (2) the TMA + wgmma product of gemm_wgmma.cuh with the
// bias + gelu epilogue into an (M, hidden) bf16 scratch, the TPU kernel's
// second rounding point.  (3) the same product with the bias epilogue.
// f32: the two FMA-tile products of gemm_tile.cuh, LN in the prologue.
#include "gemm_wgmma.cuh"

namespace {

constexpr int kLnRows = 8;  // rows (warps) a block

// y = LN(x; g, b, eps) in bf16; the statistics and the normalisation are
// the arithmetic of gemm_tile.cuh's LayerNorm prologue.  D % 8 == 0.
__global__ void __launch_bounds__(32 * kLnRows) ln_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                               const __nv_bfloat16* __restrict__ g,
                                                               const __nv_bfloat16* __restrict__ b,
                                                               __nv_bfloat16* __restrict__ y, int M, int D,
                                                               float eps) {
  const int lane = threadIdx.x % 32, m = blockIdx.x * kLnRows + threadIdx.x / 32;
  if (m >= M) return;
  const __nv_bfloat16* row = x + static_cast<size_t>(m) * D;
  auto load8 = [](const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
  };
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
    uint4 u;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16((v[j] - mean) * rstd * gv[j] + bv[j]);
    *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * D + k) = u;
  }
}

cudaError_t run_f32(const void* x, const void* g, const void* b, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* hidden, void* out, int M, int D, int Hd, float eps, cudaStream_t s) {
  cudaError_t e = sa::launch_gemm<float, sa::PRO_LAYERNORM, sa::EPI_BIAS_GELU>(x, w1, b1, g, b, eps, nullptr,
                                                                              nullptr, hidden, M, D, Hd, s);
  if (e != cudaSuccess) return e;
  return sa::launch_gemm<float, sa::PRO_NONE, sa::EPI_BIAS>(hidden, w2, b2, nullptr, nullptr, 0.f, nullptr, nullptr,
                                                            out, M, Hd, D, s);
}

cudaError_t run_bf16(const void* x, const void* g, const void* b, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* ln, void* hidden, void* out, int M, int D, int Hd, float eps,
                     cudaStream_t s) {
  if (D % 8 != 0 || Hd % 8 != 0) return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  ln_rows_kernel<<<(M + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b), static_cast<T*>(ln), M, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = sa::wg::launch_wgmma_gemm<sa::EPI_BIAS_GELU>(ln, w1, b1, hidden, M, D, Hd, s);
  if (e == cudaSuccess) e = sa::wg::launch_wgmma_gemm<sa::EPI_BIAS>(hidden, w2, b2, out, M, Hd, D, s);
  return e;
}

}  // namespace

// ln: (M, D) scratch for the bf16 body's LN pass (unused in f32)
extern "C" int sa_vit_mlp(const void* x, const void* g, const void* b, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* ln, void* hidden, void* out, int M, int D, int Hd,
                          int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SA_F32) return run_f32(x, g, b, w1, b1, w2, b2, hidden, out, M, D, Hd, eps, s);
  if (dtype == SA_BF16) return run_bf16(x, g, b, w1, b1, w2, b2, ln, hidden, out, M, D, Hd, eps, s);
  return cudaErrorInvalidValue;
}

// The bf16 body's launch geometry: out[0..1] = the LN pass's blocks and
// threads; out[2..5] and out[6..9] = each product's tile width BN, tiles,
// blocks (the persistent grid, one block an SM) and dynamic shared memory
// in bytes; out[10] = the products' threads.
extern "C" int sa_vit_mlp_geometry(int M, int D, int Hd, int* out) {
  using namespace sa::wg;
  out[0] = (M + kLnRows - 1) / kLnRows;
  out[1] = 32 * kLnRows;
  const int n_of[2] = {Hd, D};  // the two products' widths
  for (int p = 0; p < 2; ++p) {
    const int bn = pick_bn(M, n_of[p]);
    const size_t smem = bn == 256 ? Tile<256>::SMEM : bn == 208 ? Tile<208>::SMEM : Tile<176>::SMEM;
    const int v[4] = {bn, tile_count(M, n_of[p], bn), grid_size(M, n_of[p], bn), static_cast<int>(smem)};
    for (int i = 0; i < 4; ++i) out[2 + 4 * p + i] = v[i];
  }
  out[10] = THREADS;
  return cudaSuccess;
}
