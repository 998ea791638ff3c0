// One tiled matrix product with a fused prologue and epilogue: K3
// dense_scale_residual in both dtypes, and the f32 bodies of K1 ln_dense and
// of both halves of K4 vit_mlp (their bf16 bodies are gemm_wgmma.cuh's).
//
//   C[M, N] = epilogue( prologue(A)[M, K] @ W[N, K]^T )
//
// A and C are row-major tokens, W is in torch nn.Linear layout (out, in), so
// both operands are K-contiguous.  Sums are f32 for both dtypes.
//
// Prologue PRO_LAYERNORM (f32 only): each block first computes two-pass
// LayerNorm statistics of its rows (one warp per row at a time), then
// normalizes every A element as it stages the tile into shared memory.
// Epilogues: + bias; + bias then exact-erf gelu; + bias then
// resid + gamma * y (LayerScale and residual).
//
// Two bodies, picked by T:
// - bf16 (K3, the deployed type): tensor cores through mma.sync m16n8k16
//   with f32 accumulators.  128x128 output tile per 256-thread block (8
//   warps, 2 x 4, each 64x32 = 4 x 4 mma tiles), K in steps of 64 through a
//   ring of 3 shared-memory stages filled by cp.async, so two steps are in
//   flight while one multiplies; fragments come out with ldmatrix.  The
//   epilogue works straight from the accumulators.  At most 128 registers a
//   thread, so two blocks share an SM.  Needs K % 8 == 0 (16-byte rows).
// - f32: FP32 FMA, 64x64 output tile per 256-thread block, each thread a 4x4
//   register tile.  It keeps full f32 products, which tensor cores (TF32)
//   would not.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sa {

enum Prologue { PRO_NONE = 0, PRO_LAYERNORM = 1 };
enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_SCALE_RESIDUAL = 2 };

template <typename T, int EPI>
__device__ __forceinline__ void store_output(T* C, const T* bias, const T* resid, const T* gamma, int N, int m,
                                             int n, float acc) {
  const size_t idx = static_cast<size_t>(m) * N + n;
  float y = acc + to_f(bias[n]);
  if (EPI == EPI_BIAS_GELU) y = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
  if (EPI == EPI_BIAS_SCALE_RESIDUAL) y = to_f(resid[idx]) + to_f(gamma[n]) * y;
  C[idx] = from_f<T>(y);
}

// store_output for columns n, n + 1 at once (n even, N even): bf16x2 loads and store
template <int EPI>
__device__ __forceinline__ void store_pair(__nv_bfloat16* C, const __nv_bfloat16* bias, const __nv_bfloat16* resid,
                                           const __nv_bfloat16* gamma, int N, int m, int n, float a0, float a1) {
  const size_t idx = static_cast<size_t>(m) * N + n;
  const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n));
  float y0 = a0 + bb.x, y1 = a1 + bb.y;
  if (EPI == EPI_BIAS_GELU) {
    y0 = 0.5f * y0 * (1.f + erff(y0 * 0.70710678118654752f));
    y1 = 0.5f * y1 * (1.f + erff(y1 * 0.70710678118654752f));
  }
  if (EPI == EPI_BIAS_SCALE_RESIDUAL) {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + idx));
    const float2 gm = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gamma + n));
    y0 = r.x + gm.x * y0;
    y1 = r.y + gm.y * y1;
  }
  *reinterpret_cast<__nv_bfloat162*>(C + idx) = __floats2bfloat162_rn(y0, y1);
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

// ---------------------------------------------------------------------------
// f32: FMA tiles

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
      if (n < N) store_output<float, EPI>(C, bias, resid, gamma, N, m, n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core tiles

namespace tc {
constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256, STAGES = 3;
constexpr int LD = BK + 8;       // smem row pitch in bf16 (144 bytes): conflict-free ldmatrix
constexpr int WM = 64, WN = 32;  // warp tile; warps laid out 2 (M) x 4 (N)
constexpr int MI = WM / 16, NI = WN / 8;       // m16n8k16 tiles of a warp: 4 x 4
constexpr int CHUNKS = BM * BK / 8 / THREADS;  // 16-byte copies per thread per operand tile (4)
constexpr int TILE = BM * LD;                  // one operand tile, in bf16 (BM == BN)
constexpr size_t SMEM_BYTES = STAGES * 2 * static_cast<size_t>(TILE) * sizeof(__nv_bfloat16);  // A, W per stage
}  // namespace tc

template <int EPI>
__global__ void __launch_bounds__(tc::THREADS, 2) gemm_kernel_bf16(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
    const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ resid,
    const __nv_bfloat16* __restrict__ gamma, __nv_bfloat16* __restrict__ C, int M, int K, int N) {
  using namespace tc;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // stage s: A at 2s * TILE, W at (2s + 1) * TILE

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;  // ldmatrix lanes, A operand
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;  // ldmatrix lanes, B operand
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  // copy c of a tile: row c / (BK / 8), columns (c % (BK / 8)) * 8 .. +8; rows past M / N
  // and columns past K are zero-filled (K % 8 == 0, so a copy is all in or out)
  auto issue = [&](int kt) {
    if (kt < nk) {
      __nv_bfloat16* As = tiles + (kt % STAGES) * 2 * TILE;
      __nv_bfloat16* Ws = As + TILE;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int c = tid + i * THREADS, r = c / (BK / 8), kc = (c % (BK / 8)) * 8, k = kt * BK + kc;
        const int m = min(m0 + r, M - 1), n = min(n0 + r, N - 1), kk = min(k, K - 8);
        cp_async16(As + r * LD + kc, A + static_cast<size_t>(m) * K + kk, (m0 + r < M && k < K) ? 16 : 0);
        cp_async16(Ws + r * LD + kc, W + static_cast<size_t>(n) * K + kk, (n0 + r < N && k < K) ? 16 : 0);
      }
    }
    cp_async_commit();  // one group per k-step, empty past the end
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // the group of k-step kt has landed
    __syncthreads();              // ... for every thread, and step kt - 1's stage is free
    const __nv_bfloat16* As = tiles + (kt % STAGES) * 2 * TILE;
    const __nv_bfloat16* Ws = As + TILE;
    issue(kt + STAGES - 1);  // refill the stage step kt - 1 used

    const __nv_bfloat16* a_tile = As + (wm * WM) * LD;
    const __nv_bfloat16* w_tile = Ws + (wn * WN) * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4(af[i], a_tile + (i * 16 + a_row) * LD + kk + a_col);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        unsigned r4[4];
        ldmatrix_x4(r4, w_tile + (j * 8 + b_row) * LD + kk + b_col);
        bf[j][0] = r4[0];
        bf[j][1] = r4[1];
        bf[j + 1][0] = r4[2];
        bf[j + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue straight from the accumulators: (row g, cols 2t, 2t+1) and row g + 8
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * t;
        if (n + 1 < N && N % 2 == 0) {
          store_pair<EPI>(C, bias, resid, gamma, N, m, n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (n < N) store_output<__nv_bfloat16, EPI>(C, bias, resid, gamma, N, m, n, acc[i][j][2 * h]);
          if (n + 1 < N) store_output<__nv_bfloat16, EPI>(C, bias, resid, gamma, N, m, n + 1, acc[i][j][2 * h + 1]);
        }
      }
    }
}

template <typename T, int PRO, int EPI>
cudaError_t launch_gemm(const void* A, const void* W, const void* bias, const void* ln_g, const void* ln_b,
                        float eps, const void* resid, const void* gamma, void* C, int M, int K, int N,
                        cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(PRO == PRO_NONE, "the bf16 tile has no prologue: LayerNorm runs in ln_rows.cuh");
    if (K % 8 != 0) return cudaErrorInvalidValue;
    auto kernel = gemm_kernel_bf16<EPI>;
    cudaError_t e = smem_limit_once(reinterpret_cast<const void*>(kernel), tc::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    const dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM);
    kernel<<<grid, tc::THREADS, tc::SMEM_BYTES, stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(W), static_cast<const T*>(bias),
        static_cast<const T*>(resid), static_cast<const T*>(gamma), static_cast<T*>(C), M, K, N);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_kernel_f32<PRO, EPI><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(W), static_cast<const T*>(bias),
        static_cast<const T*>(ln_g), static_cast<const T*>(ln_b), eps, static_cast<const T*>(resid),
        static_cast<const T*>(gamma), static_cast<T*>(C), M, K, N);
  }
  return cudaGetLastError();
}

}  // namespace sa
