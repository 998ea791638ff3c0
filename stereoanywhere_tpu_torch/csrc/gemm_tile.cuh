// The f32 bodies of the ViT products: one FMA-tiled matrix product with a
// fused prologue and epilogue, for K1 ln_dense, K3 dense_scale_residual and
// both halves of K4 vit_mlp in f32, the check type.  Their bf16 bodies are
// gemm_wgmma.cuh's; the Epilogue values below name the epilogues of both.
//
//   C[M, N] = epilogue( prologue(A)[M, K] @ W[N, K]^T )
//
// A and C are row-major tokens, W is in torch nn.Linear layout (out, in), so
// both operands are K-contiguous.  Sums are f32.
//
// Prologue PRO_LAYERNORM: each block first computes two-pass LayerNorm
// statistics of its rows (one warp per row at a time), then normalizes
// every A element as it stages the tile into shared memory.  Epilogues:
// + bias; + bias then exact-erf gelu; + bias then resid + gamma * y
// (LayerScale and residual).
//
// FP32 FMA, 64x64 output tile per 256-thread block, each thread a 4x4
// register tile.  It keeps full f32 products, which tensor cores (TF32)
// would not.
#pragma once

#include "common.cuh"

namespace sa {

enum Prologue { PRO_NONE = 0, PRO_LAYERNORM = 1 };
enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_SCALE_RESIDUAL = 2 };

template <int EPI>
__device__ __forceinline__ void store_output(float* C, const float* bias, const float* resid, const float* gamma, int N,
                                             int m, int n, float acc) {
  const size_t idx = static_cast<size_t>(m) * N + n;
  float y = acc + bias[n];
  if (EPI == EPI_BIAS_GELU) y = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
  if (EPI == EPI_BIAS_SCALE_RESIDUAL) y = resid[idx] + gamma[n] * y;
  C[idx] = y;
}

// Two-pass f32 LayerNorm statistics of rows [m0, m0 + rows), one warp per
// row at a time; rows past M get (0, 0).
__device__ __forceinline__ void row_stats(const float* A, int M, int K, float eps, int m0, int rows, float* s_mean,
                                          float* s_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = warp; r < rows; r += nwarps) {
    const int m = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (m < M) {
      const float* row = A + static_cast<size_t>(m) * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += row[k];
      mean = warp_sum(s) / K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) v += (row[k] - mean) * (row[k] - mean);
      rstd = rsqrtf(warp_sum(v) / K + eps);
    }
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
    }
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 256;

template <int PRO, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel_f32(
    const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b, float eps,
    const float* __restrict__ resid, const float* __restrict__ gamma,
    float* __restrict__ C, int M, int K, int N) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Ws[kBK][kBN + 4];
  __shared__ float s_mean[kBM], s_rstd[kBM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  if (PRO == PRO_LAYERNORM) {
    row_stats(A, M, K, eps, m0, kBM, s_mean, s_rstd);
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        v = A[static_cast<size_t>(m) * K + k];
        if (PRO == PRO_LAYERNORM) v = (v - s_mean[r]) * s_rstd[r] * ln_g[k] + ln_b[k];
      }
      As[kk][r] = v;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int c = e / kBK, kk = e % kBK;
      const int n = n0 + c, k = k0 + kk;
      Ws[kk][c] = (n < N && k < K) ? W[static_cast<size_t>(n) * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) store_output<EPI>(C, bias, resid, gamma, N, m, n, acc[i][j]);
    }
  }
}

template <int PRO, int EPI>
cudaError_t launch_gemm(const void* A, const void* W, const void* bias, const void* ln_g, const void* ln_b,
                        float eps, const void* resid, const void* gamma, void* C, int M, int K, int N,
                        cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel_f32<PRO, EPI><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(W), static_cast<const float*>(bias),
      static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), eps, static_cast<const float*>(resid),
      static_cast<const float*>(gamma), static_cast<float*>(C), M, K, N);
  return cudaGetLastError();
}

}  // namespace sa
