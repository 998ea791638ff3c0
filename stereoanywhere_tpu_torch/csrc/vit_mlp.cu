// K4 vit_mlp: gelu_erf(LN(x) @ W1^T + b1) @ W2^T + b2.
// Replaces stereoanywhere_tpu/ops/pallas/vit_mlp.py (vit_mlp); design and
// bound: ops/cuda/vit_mlp.py.
//
// bf16: three launches.  (1) ln_rows.cuh's row pass writes LN(x) rounded
// to bf16, one warp a row, two-pass f32 statistics: exactly the rounding the
// TPU kernel applies before its first product, so A can go from TMA
// straight into wgmma.  (2) the TMA + wgmma product of gemm_wgmma.cuh with the
// bias + gelu epilogue into an (M, hidden) bf16 scratch, the TPU kernel's
// second rounding point.  (3) the same product with the bias epilogue.
// f32: the two FMA-tile products of gemm_tile.cuh, LN in the prologue.
#include "gemm_wgmma.cuh"
#include "ln_rows.cuh"

namespace {

cudaError_t run_f32(const void* x, const void* g, const void* b, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* hidden, void* out, int M, int D, int Hd, float eps, cudaStream_t s) {
  cudaError_t e = sa::launch_gemm<sa::PRO_LAYERNORM, sa::EPI_BIAS_GELU>(x, w1, b1, g, b, eps, nullptr, nullptr,
                                                                       hidden, M, D, Hd, s);
  if (e != cudaSuccess) return e;
  return sa::launch_gemm<sa::PRO_NONE, sa::EPI_BIAS>(hidden, w2, b2, nullptr, nullptr, 0.f, nullptr, nullptr, out,
                                                     M, Hd, D, s);
}

cudaError_t run_bf16(const void* x, const void* g, const void* b, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* ln, void* hidden, void* out, int M, int D, int Hd, float eps,
                     cudaStream_t s) {
  if (D % 8 != 0 || Hd % 8 != 0) return cudaErrorInvalidValue;
  cudaError_t e = sa::launch_ln_rows(x, g, b, ln, M, D, eps, s);
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
  out[0] = (M + sa::kLnRows - 1) / sa::kLnRows;
  out[1] = 32 * sa::kLnRows;
  geometry(M, Hd, out + 2);  // the two products' widths: hidden, then D
  geometry(M, D, out + 6);
  out[10] = THREADS;
  return cudaSuccess;
}
