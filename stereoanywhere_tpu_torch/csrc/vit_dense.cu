// K1 ln_dense and K3 dense_scale_residual: the Dense side of a ViT block.
// Replaces stereoanywhere_tpu/ops/pallas/vit_dense.py (ln_dense,
// dense_scale_residual).  Design and bound: ops/cuda/vit_dense.py.
//
// bf16, both on the TMA + wgmma product of gemm_wgmma.cuh.  K1: two
// launches, K4's first half with the bias epilogue: the LayerNorm row pass
// (ln_rows.cuh) writes LN(x) rounded to bf16 into an (M, K) scratch, the TPU
// kernel's rounding point, and the product adds the bias.  K3: one launch,
// the product with the bias + LayerScale + residual epilogue, x + gamma y
// taken in f32 from the accumulators and rounded once, as the TPU kernel
// does.  f32: the FMA tiles of gemm_tile.cuh, LayerNorm in K1's prologue
// and LayerScale + residual in K3's epilogue.
#include "gemm_wgmma.cuh"
#include "ln_rows.cuh"

// ln: (M, K) scratch for the bf16 body's LN pass (unused in f32)
extern "C" int sa_ln_dense(const void* x, const void* g, const void* b, const void* w, const void* bias, void* ln,
                           void* out, int M, int K, int N, int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SA_F32)
    return sa::launch_gemm<sa::PRO_LAYERNORM, sa::EPI_BIAS>(x, w, bias, g, b, eps, nullptr, nullptr, out, M, K, N, s);
  if (dtype != SA_BF16) return cudaErrorInvalidValue;
  if (K % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
  cudaError_t e = sa::launch_ln_rows(x, g, b, ln, M, K, eps, s);
  return e != cudaSuccess ? e : sa::wg::launch_wgmma_gemm<sa::EPI_BIAS>(ln, w, bias, out, M, K, N, s);
}

// K1's bf16 launch geometry: out[0..1] = the LN pass's blocks and threads;
// out[2..5] = the product's tile width BN, tiles, blocks and dynamic shared
// memory in bytes; out[6] = the product's threads.
extern "C" int sa_ln_dense_geometry(int M, int N, int* out) {
  out[0] = (M + sa::kLnRows - 1) / sa::kLnRows;
  out[1] = 32 * sa::kLnRows;
  sa::wg::geometry(M, N, out + 2);
  out[6] = sa::wg::THREADS;
  return cudaSuccess;
}

extern "C" int sa_dense_scale_residual(const void* x, const void* o, const void* w, const void* bias,
                                       const void* gamma, void* out, int M, int K, int N, int dtype,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SA_F32)
    return sa::launch_gemm<sa::PRO_NONE, sa::EPI_BIAS_SCALE_RESIDUAL>(o, w, bias, nullptr, nullptr, 0.f, x, gamma,
                                                                      out, M, K, N, s);
  if (dtype == SA_BF16)
    return sa::wg::launch_wgmma_gemm<sa::EPI_BIAS_SCALE_RESIDUAL>(o, w, bias, out, M, K, N, s, x, gamma);
  return cudaErrorInvalidValue;
}

// K3's bf16 launch geometry: out[0..3] = the product's tile width BN, tiles,
// blocks and dynamic shared memory in bytes; out[4] = its threads.
extern "C" int sa_dense_scale_residual_geometry(int M, int N, int* out) {
  sa::wg::geometry(M, N, out);
  out[4] = sa::wg::THREADS;
  return cudaSuccess;
}
