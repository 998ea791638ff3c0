// K4 vit_mlp: gelu_erf(LN(x) @ W1^T + b1) @ W2^T + b2.
// Replaces stereoanywhere_tpu/ops/pallas/vit_mlp.py (vit_mlp).  Two launches
// of the tiled product through an (M, hidden) scratch buffer in device
// memory; design and bound: ops/cuda/vit_mlp.py.
#include "gemm_tile.cuh"

template <typename T>
static cudaError_t run(const void* x, const void* g, const void* b, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* hidden, void* out, int M, int D, int Hd, float eps,
                       cudaStream_t s) {
  cudaError_t e = sa::launch_gemm<T, sa::PRO_LAYERNORM, sa::EPI_BIAS_GELU>(x, w1, b1, g, b, eps, nullptr, nullptr,
                                                                          hidden, M, D, Hd, s);
  if (e != cudaSuccess) return e;
  return sa::launch_gemm<T, sa::PRO_NONE, sa::EPI_BIAS>(hidden, w2, b2, nullptr, nullptr, 0.f, nullptr, nullptr,
                                                        out, M, Hd, D, s);
}

extern "C" int sa_vit_mlp(const void* x, const void* g, const void* b, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* hidden, void* out, int M, int D, int Hd,
                          int dtype, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SA_F32) return run<float>(x, g, b, w1, b1, w2, b2, hidden, out, M, D, Hd, eps, s);
  if (dtype == SA_BF16) return run<__nv_bfloat16>(x, g, b, w1, b1, w2, b2, hidden, out, M, D, Hd, eps, s);
  return cudaErrorInvalidValue;
}
