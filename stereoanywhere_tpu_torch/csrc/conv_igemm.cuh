// Stride-1 "same" convolution over NHWC tensors as an implicit GEMM on
// mma.sync (bf16) or FMA (f32) tiles: the body of K7 flow head's conv1 in
// both dtypes, and of K8 motion encoder and K9 ConvGRU in f32
// (ops/cuda/step_fused.py).  K7 is the last bf16 user: the bf16 3x3 convs
// of K8 and K9 run on conv_wgmma.cuh's TMA + wgmma core, and K7 is to move
// onto it.
//
//   C[m, n] = epilogue( sum_k A[m, k] W[n, k] ),  m = (b, y, x) pixel,
//   k = (tap, input channel),  A[m, (tap, c)] = in[b, y + dy, x + dx, c]
//
// The input is the channel concatenation of up to three NHWC tensors
// ("segments", e.g. [h, x1, x2] of a ConvGRU): the concat is never built,
// each K-step reads from the one segment its channels lie in.  The 3x3 (or
// k x k) taps are k*k shifted K-slices; the zero padding is a predicated
// load (a copy of 0 bytes zero-fills its shared-memory slot).  W is packed
// (N, k*k, Cin) so that its K index is tap * Cin + c, K-contiguous.
// Grouped form (groups > 1, one segment; f32 only): output block n0 reads
// only the input channels of its group, as a block-diagonal weight would.
//
// Every segment's channel count is a multiple of BK = 32 (a K-step never
// straddles two segments or taps) and every segment is 16-byte aligned.
//
// Two bodies, picked by T:
// - bf16 (the deployed type; built for the ReLU epilogue only, ungrouped:
//   conv_wgmma.cuh serves the others): tensor cores through mma.sync m16n8k16 with
//   f32 accumulators; a 128 x BN output tile per 256-thread block (BN 128:
//   warps 2 x 4 of 64 x 32; BN 64: warps 4 x 2 of 32 x 32); K in steps of 32
//   through a 3-stage cp.async ring; fragments by ldmatrix.
// - f32 (checks only): FP32 FMA, 64 x 64 tile, 4 x 4 a thread; full f32
//   products, which tensor cores (TF32) would not keep.
// The epilogue acts on each f32 accumulator: bias, then ReLU, the ConvGRU
// gates and blend, or the motion encoder's [out | flow-x | 0] lanes.
#pragma once

#include "common.cuh"

namespace sa {
namespace conv {

constexpr int MAX_SEGS = 3;
constexpr int BK = 32;

enum Epi {
  EPI_RELU = 0,    // out[m, n] = relu(acc + bias)
  EPI_GRU_ZR = 1,  // n < hd: z = sigmoid(acc + b + cz) -> out; else rh = sigmoid(acc + b + cr) * h -> out2
  EPI_GRU_Q = 2,   // q = tanh(acc + b + cq); out = (1 - z) h + z q
  EPI_MOTION = 3,  // n < N-2: relu(acc + b); n == N-2: flow-x = coords - x (rounded to T); n == N-1: 0
};

struct Args {
  const void* seg[MAX_SEGS];  // NHWC inputs, pixel stride seg_c
  int seg_c[MAX_SEGS];
  int nseg;
  int B, H, W;
  int ks;       // kernel size, odd; padding ks / 2
  int groups;   // > 1 only with nseg == 1
  const void* w;      // (N, ks*ks, cin_g) in T
  const float* bias;  // (N)
  int N;
  void* out;    // (M, N): RELU, MOTION; (M, hd): z (GRU_ZR), h' (GRU_Q)
  void* out2;   // (M, hd): r*h (GRU_ZR)
  const void* h;  // (M, hd): hidden state (GRU_ZR, GRU_Q)
  const void* z;  // (M, hd): update gate (GRU_Q)
  const void* inj_z;  // context injections, row stride inj_ld
  const void* inj_r;
  const void* inj_q;
  int inj_ld;
  int hd;
  const float* coords;  // (M) f32 (MOTION)
};

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T, int EPI>
__device__ __forceinline__ void epilogue(const Args& a, int m, int n, float acc) {
  if (n >= a.N) return;
  const size_t mm = static_cast<size_t>(m);
  float v = acc + a.bias[n];
  if constexpr (EPI == EPI_RELU) {
    static_cast<T*>(a.out)[mm * a.N + n] = from_f<T>(fmaxf(v, 0.f));
  } else if constexpr (EPI == EPI_MOTION) {
    if (n == a.N - 2) {
      v = to_f(from_f<T>(a.coords[m] - static_cast<float>(m % a.W)));
    } else if (n == a.N - 1) {
      v = 0.f;
    } else {
      v = fmaxf(v, 0.f);
    }
    static_cast<T*>(a.out)[mm * a.N + n] = from_f<T>(v);
  } else if constexpr (EPI == EPI_GRU_ZR) {
    const int hd = a.hd;
    if (n < hd) {
      v += to_f(static_cast<const T*>(a.inj_z)[mm * a.inj_ld + n]);
      static_cast<T*>(a.out)[mm * hd + n] = from_f<T>(sigmoidf(v));
    } else {
      const int c = n - hd;
      v += to_f(static_cast<const T*>(a.inj_r)[mm * a.inj_ld + c]);
      const float hv = to_f(static_cast<const T*>(a.h)[mm * hd + c]);
      static_cast<T*>(a.out2)[mm * hd + c] = from_f<T>(sigmoidf(v) * hv);
    }
  } else {  // EPI_GRU_Q
    const int hd = a.hd;
    v += to_f(static_cast<const T*>(a.inj_q)[mm * a.inj_ld + n]);
    const float q = tanhf(v);
    const float zv = to_f(static_cast<const T*>(a.z)[mm * hd + n]);
    const float hv = to_f(static_cast<const T*>(a.h)[mm * hd + n]);
    static_cast<T*>(a.out)[mm * hd + n] = from_f<T>((1.f - zv) * hv + zv * q);
  }
}

// Input channels a group reads, and the K depth of the product.
__device__ __forceinline__ int cin_group(const Args& a) {
  if (a.groups > 1) return a.seg_c[0] / a.groups;
  int c = 0;
  for (int s = 0; s < a.nseg; ++s) c += a.seg_c[s];
  return c;
}

// K-step kt -> tap offset (dy, dx), segment s, channel offset c in it
__device__ __forceinline__ void kstep(const Args& a, int cin_g, int kt, int& dy, int& dx, int& s, int& c) {
  const int csteps = cin_g / BK;
  const int tap = kt / csteps;
  int cc = (kt - tap * csteps) * BK;
  dy = tap / a.ks - a.ks / 2;
  dx = tap % a.ks - a.ks / 2;
  s = 0;
  while (s + 1 < a.nseg && cc >= a.seg_c[s]) {
    cc -= a.seg_c[s];
    ++s;
  }
  c = cc;
}

// pixel m -> (b, y, x); m past M is clamped (its loads are predicated off)
struct Pix {
  int b, y, x;
  bool ok;
};
__device__ __forceinline__ Pix pixel(const Args& a, int m, int M) {
  Pix p;
  p.ok = m < M;
  const int mm = min(m, M - 1);
  p.x = mm % a.W;
  const int t = mm / a.W;
  p.y = t % a.H;
  p.b = t / a.H;
  return p;
}

// Offset (in elements) of channel c of the tap-shifted pixel, or -1 outside the image
__device__ __forceinline__ long long tap_offset(const Args& a, const Pix& p, int dy, int dx, int sc, int c) {
  const int yy = p.y + dy, xx = p.x + dx;
  if (!p.ok || yy < 0 || yy >= a.H || xx < 0 || xx >= a.W) return -1;
  return (static_cast<long long>(p.b * a.H + yy) * a.W + xx) * sc + c;
}

// ---------------------------------------------------------------------------
// f32: FMA tiles

namespace f32 {
constexpr int BM = 64, BN = 64, THREADS = 256, ROWS = BM * BK / THREADS;  // 8 rows a thread
}

template <int EPI>
__global__ void __launch_bounds__(f32::THREADS) conv_kernel_f32(const Args a) {
  using namespace f32;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Ws[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = a.B * a.H * a.W;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int cin_g = cin_group(a);
  const int goff = a.groups > 1 ? (n0 / (a.N / a.groups)) * cin_g : 0;
  const int kdim = a.ks * a.ks * cin_g, nk = kdim / BK;
  // each thread stages column kk = tid % BK of rows tid / BK + 8 i
  const int kk = tid % BK, r0 = tid / BK;
  Pix pix[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) pix[i] = pixel(a, m0 + r0 + 8 * i, M);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    int dy, dx, s, c;
    kstep(a, cin_g, kt, dy, dx, s, c);
    const float* src = static_cast<const float*>(a.seg[s]);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long off = tap_offset(a, pix[i], dy, dx, a.seg_c[s], goff + c + kk);
      As[kk][r0 + 8 * i] = off >= 0 ? src[off] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int n = n0 + r0 + 8 * i;
      Ws[kk][r0 + 8 * i] = n < a.N ? static_cast<const float*>(a.w)[static_cast<size_t>(n) * kdim + kt * BK + kk]
                                   : 0.f;
    }
    __syncthreads();
    // a partial sum per K-step, then into the total: two-level summation
    // keeps the rounding of a 3456-term ConvGRU sum near a blocked one's
    float part[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(ar[i], br[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) epilogue<float, EPI>(a, m, n0 + tx * 4 + j, acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core tiles

namespace tc {
constexpr int BM = 128, THREADS = 256, STAGES = 3;
constexpr int LD = BK + 8;  // smem row pitch in bf16 (80 bytes): conflict-free ldmatrix
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 16-byte copies a thread per A tile (2)
template <int BN>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(STAGES) * (BM + BN) * LD * sizeof(__nv_bfloat16);
}
}  // namespace tc

template <int EPI, int BN>
__global__ void __launch_bounds__(tc::THREADS) conv_kernel_bf16(const Args a) {
  using namespace tc;
  constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N, WM = BM / WARPS_M, MI = WM / 16, NI = 4;
  constexpr int W_CHUNKS = BN * BK / 8 / THREADS;
  constexpr int TILE = (BM + BN) * LD;  // one stage: A then W
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;  // ldmatrix lanes, A operand
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;  // ldmatrix lanes, B operand
  const int M = a.B * a.H * a.W;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int cin = cin_group(a);
  const int kdim = a.ks * a.ks * cin, nk = kdim / BK;
  const auto* wmat = static_cast<const __nv_bfloat16*>(a.w);

  // copy c of a tile: row c / 4, channels (c % 4) * 8 .. + 8
  Pix pix[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) pix[i] = pixel(a, m0 + (tid + i * THREADS) / 4, M);

  auto issue = [&](int kt) {
    if (kt < nk) {
      int dy, dx, s, c;
      kstep(a, cin, kt, dy, dx, s, c);
      const auto* src = static_cast<const __nv_bfloat16*>(a.seg[s]);
      __nv_bfloat16* As = tiles + (kt % STAGES) * TILE;
      __nv_bfloat16* Ws = As + BM * LD;
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        const int cidx = tid + i * THREADS, r = cidx / 4, kc = (cidx % 4) * 8;
        const long long off = tap_offset(a, pix[i], dy, dx, a.seg_c[s], c + kc);
        cp_async16(As + r * LD + kc, off >= 0 ? src + off : src, off >= 0 ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < W_CHUNKS; ++i) {
        const int cidx = tid + i * THREADS, r = cidx / 4, kc = (cidx % 4) * 8, n = n0 + r;
        cp_async16(Ws + r * LD + kc, wmat + static_cast<size_t>(min(n, a.N - 1)) * kdim + kt * BK + kc,
                   n < a.N ? 16 : 0);
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
    issue(kt + STAGES - 1);
    const __nv_bfloat16* As = tiles + (kt % STAGES) * TILE;
    const __nv_bfloat16* a_tile = As + (wm * WM) * LD;
    const __nv_bfloat16* w_tile = As + BM * LD + (wn * 32) * LD;
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

  // epilogue from the accumulators: (row g, cols 2t, 2t+1) and row g + 8
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        epilogue<__nv_bfloat16, EPI>(a, m, n, acc[i][j][2 * h]);
        epilogue<__nv_bfloat16, EPI>(a, m, n + 1, acc[i][j][2 * h + 1]);
      }
    }
}

template <int EPI, int BN>
cudaError_t launch_bf16(const Args& a, int M, cudaStream_t stream) {
  auto kernel = conv_kernel_bf16<EPI, BN>;
  constexpr size_t smem = tc::smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + BN - 1) / BN, (M + tc::BM - 1) / tc::BM);
  kernel<<<grid, tc::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Checks the shape rules, then launches.  bf16: BN 64 is taken where
// 128-wide tiles would leave fewer than two blocks per SM of the card's 132.
template <int EPI>
cudaError_t launch(const Args& a, int dtype, cudaStream_t stream) {
  const long long M = static_cast<long long>(a.B) * a.H * a.W;
  if (M <= 0 || M > (1LL << 30) || a.nseg < 1 || a.nseg > MAX_SEGS || a.ks < 1 || a.ks % 2 == 0 || a.groups < 1)
    return cudaErrorInvalidValue;
  if (a.groups > 1 && (a.nseg != 1 || a.seg_c[0] % a.groups || a.N % a.groups || (a.N / a.groups) % 64))
    return cudaErrorInvalidValue;
  for (int s = 0; s < a.nseg; ++s)
    if (a.seg_c[s] <= 0 || a.seg_c[s] % BK || (a.groups > 1 && (a.seg_c[s] / a.groups) % BK))
      return cudaErrorInvalidValue;
  if (dtype == SA_F32) {
    const dim3 grid((a.N + f32::BN - 1) / f32::BN, static_cast<unsigned>((M + f32::BM - 1) / f32::BM));
    conv_kernel_f32<EPI><<<grid, f32::THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  // bf16: K7's conv1 only (K8 and K9 run on conv_wgmma.cuh), so only the ReLU tiles are built
  if constexpr (EPI == EPI_RELU) {
    if (dtype != SA_BF16 || a.groups > 1) return cudaErrorInvalidValue;
    const long long blocks128 = ((M + tc::BM - 1) / tc::BM) * ((a.N + 127) / 128);
    const bool narrow = a.N % 64 == 0 && blocks128 < 2 * 132;
    return narrow ? launch_bf16<EPI, 64>(a, static_cast<int>(M), stream)
                  : launch_bf16<EPI, 128>(a, static_cast<int>(M), stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace conv
}  // namespace sa
