// Stride-1 "same" convolution over NHWC f32 tensors as an implicit GEMM on
// FMA tiles: the f32 bodies of K7 flow head's conv1, K8 motion encoder and
// K9 ConvGRU (ops/cuda/step_fused.py), the checks of the bf16 bodies, which
// run on conv_wgmma.cuh's TMA + wgmma core.
//
//   C[m, n] = epilogue( sum_k A[m, k] W[n, k] ),  m = (b, y, x) pixel,
//   k = (tap, input channel),  A[m, (tap, c)] = in[b, y + dy, x + dx, c]
//
// The input is the channel concatenation of up to three NHWC tensors
// ("segments", e.g. [h, x1, x2] of a ConvGRU): the concat is never built,
// each K-step reads from the one segment its channels lie in.  The 3x3 (or
// k x k) taps are k*k shifted K-slices; the zero padding is a predicated
// load.  W is packed (N, k*k, Cin) so that its K index is tap * Cin + c,
// K-contiguous.  Grouped form (groups > 1, one segment): output block n0
// reads only the input channels of its group, as a block-diagonal weight
// would.
//
// Every segment's channel count is a multiple of BK = 32 (a K-step never
// straddles two segments or taps).  The tile: 64 x 64 outputs a 256-thread
// block, 4 x 4 a thread, full f32 products, which tensor cores (TF32) would
// not keep.  The epilogue acts on each f32 accumulator: bias, then ReLU, the
// ConvGRU gates and blend, or the motion encoder's [out | flow-x | 0] lanes.
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
  EPI_MOTION = 3,  // n < N-2: relu(acc + b); n == N-2: flow-x = coords - x (rounded to the dtype); n == N-1: 0
  EPI_FLOWHEAD = 4,  // conv_wgmma.cuh only: fh1 = relu(acc + b), its 9 tap columns z9 = fh1 . w2[tap]
};

struct Args {
  const void* seg[MAX_SEGS];  // NHWC inputs, pixel stride seg_c
  int seg_c[MAX_SEGS];
  int nseg;
  int B, H, W;
  int ks;       // kernel size, odd; padding ks / 2
  int groups;   // > 1 only with nseg == 1
  const void* w;      // (N, ks*ks, cin_g)
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

template <int EPI>
__device__ __forceinline__ void epilogue(const Args& a, int m, int n, float acc) {
  if (n >= a.N) return;
  const size_t mm = static_cast<size_t>(m);
  auto* out = static_cast<float*>(a.out);
  float v = acc + a.bias[n];
  if constexpr (EPI == EPI_RELU) {
    out[mm * a.N + n] = fmaxf(v, 0.f);
  } else if constexpr (EPI == EPI_MOTION) {
    if (n == a.N - 2) {
      v = a.coords[m] - static_cast<float>(m % a.W);
    } else if (n == a.N - 1) {
      v = 0.f;
    } else {
      v = fmaxf(v, 0.f);
    }
    out[mm * a.N + n] = v;
  } else if constexpr (EPI == EPI_GRU_ZR) {
    const int hd = a.hd;
    if (n < hd) {
      v += static_cast<const float*>(a.inj_z)[mm * a.inj_ld + n];
      out[mm * hd + n] = sigmoidf(v);
    } else {
      const int c = n - hd;
      v += static_cast<const float*>(a.inj_r)[mm * a.inj_ld + c];
      const float hv = static_cast<const float*>(a.h)[mm * hd + c];
      static_cast<float*>(a.out2)[mm * hd + c] = sigmoidf(v) * hv;
    }
  } else {  // EPI_GRU_Q
    const int hd = a.hd;
    v += static_cast<const float*>(a.inj_q)[mm * a.inj_ld + n];
    const float q = tanhf(v);
    const float zv = static_cast<const float*>(a.z)[mm * hd + n];
    const float hv = static_cast<const float*>(a.h)[mm * hd + n];
    out[mm * hd + n] = (1.f - zv) * hv + zv * q;
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
    for (int j = 0; j < 4; ++j) epilogue<EPI>(a, m, n0 + tx * 4 + j, acc[i][j]);
  }
}

// Checks the shape rules, then launches the f32 tile.
template <int EPI>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long M = static_cast<long long>(a.B) * a.H * a.W;
  if (M <= 0 || M > (1LL << 30) || a.nseg < 1 || a.nseg > MAX_SEGS || a.ks < 1 || a.ks % 2 == 0 || a.groups < 1)
    return cudaErrorInvalidValue;
  if (a.groups > 1 && (a.nseg != 1 || a.seg_c[0] % a.groups || a.N % a.groups || (a.N / a.groups) % 64))
    return cudaErrorInvalidValue;
  for (int s = 0; s < a.nseg; ++s)
    if (a.seg_c[s] <= 0 || a.seg_c[s] % BK || (a.groups > 1 && (a.seg_c[s] / a.groups) % BK))
      return cudaErrorInvalidValue;
  const dim3 grid((a.N + f32::BN - 1) / f32::BN, static_cast<unsigned>((M + f32::BM - 1) / f32::BM));
  conv_kernel_f32<EPI><<<grid, f32::THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace sa
