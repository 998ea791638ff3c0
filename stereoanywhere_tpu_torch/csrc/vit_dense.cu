// K1 ln_dense and K3 dense_scale_residual: the Dense side of a ViT block.
// Replaces stereoanywhere_tpu/ops/pallas/vit_dense.py (ln_dense,
// dense_scale_residual).  Design and bound: ops/cuda/vit_dense.py.
#include "gemm_tile.cuh"

extern "C" int sa_ln_dense(const void* x, const void* g, const void* b, const void* w, const void* bias,
                           void* out, int M, int K, int N, int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SA_F32)
    return sa::launch_gemm<float, sa::PRO_LAYERNORM, sa::EPI_BIAS>(x, w, bias, g, b, eps, nullptr, nullptr, out,
                                                                   M, K, N, s);
  if (dtype == SA_BF16)
    return sa::launch_gemm<__nv_bfloat16, sa::PRO_LAYERNORM, sa::EPI_BIAS>(x, w, bias, g, b, eps, nullptr,
                                                                           nullptr, out, M, K, N, s);
  return cudaErrorInvalidValue;
}

extern "C" int sa_dense_scale_residual(const void* x, const void* o, const void* w, const void* bias,
                                       const void* gamma, void* out, int M, int K, int N, int dtype,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SA_F32)
    return sa::launch_gemm<float, sa::PRO_NONE, sa::EPI_BIAS_SCALE_RESIDUAL>(o, w, bias, nullptr, nullptr, 0.f, x,
                                                                             gamma, out, M, K, N, s);
  if (dtype == SA_BF16)
    return sa::launch_gemm<__nv_bfloat16, sa::PRO_NONE, sa::EPI_BIAS_SCALE_RESIDUAL>(
        o, w, bias, nullptr, nullptr, 0.f, x, gamma, out, M, K, N, s);
  return cudaErrorInvalidValue;
}
