// The 3-D hourglass's convolution blocks (models/hourglass.py `Hourglass`)
// as fused kernels over NDHWC volumes.  Replaces no TPU kernel: the JAX
// package leaves the hourglass to XLA's convolutions.  Design, bound and
// the Python side: ops/cuda/hourglass3d.py.
//
// A `BasicConv` is conv -> instance norm -> LeakyReLU(0.01), and a
// `DoubleFeatureAtt` gate may follow it.  Here a convolution reads its
// producer's RAW output (the conv result before the norm) and applies, on
// load, the producer's instance norm from the f32 sums of its output,
// the LeakyReLU and the gate sigmoid(left)[b,c,h,w2] * sigmoid(right)[b,c,
// h,w3] (a rank-1 factor read from two small channel-last maps); it stores
// its own raw output and gathers Σx and Σx² of the stored values per (b,
// c).  So a normalised or gated volume is never written, only where it must
// exist (finalize_kernel).  Where the depth features' grid is not the
// volume's, the module resizes the gate (trilinear, align corners); the
// resized gate is then a sum of two such factors, one for each of the two
// source rows along H (gl2, gr2).
//
// - conv3_kernel: 3x3x3, stride 1 or 2, padding 1, as an implicit GEMM on
//   the tensor cores (mma.sync m16n8k8, f32 sums), M = output voxels, N =
//   Cout, K = (input chunk of 8 channels, tap, channel).  A block walks
//   output tiles of TD x TH x 16 voxels (persistent grid); for each chunk
//   of 8 input channels it stages the tile's input halo into shared memory
//   once, transformed (norm, LeakyReLU, gate), and the 27 taps are shifted
//   reads of it.  The operands are TF32, rounded to nearest, where cuDNN
//   may use TF32; otherwise (PRECISE) each f32 operand is split into a TF32
//   head and a TF32 tail and a product is three (tail x head, head x tail,
//   head x head): full f32 precision, as cuDNN's f32 convolution has.  bf16
//   volumes are stored in bf16 and multiplied on the TF32 units: a bf16
//   value is exact in TF32, so the products are the bf16 products, summed
//   in f32 as a bf16 tensor-core product sums them.
// - conv1_kernel: 1x1x1 over [a direct segment, an upsampled one] (the
//   channel concatenation is never built), on the CUDA cores in full f32,
//   one thread a voxel.  The direct segment is the hourglass's input (NCDHW,
//   as it is) or a raw NDHWC volume with its norm and gate; the upsampled
//   segment's share of the product, taken at its low resolution by
//   finalize_proj_kernel, is interpolated on load (trilinear, align
//   corners, along D then H then W as ops/interp.py's matrices) and added.
// - finalize_kernel / finalize_proj_kernel: a raw volume normalised,
//   activated and gated, written once: NCDHW f32 (the hourglass's output),
//   or projected through the 1x1x1 weight columns that read it, NDHWC f32
//   (a volume that is upsampled).
//
// Statistics are deterministic: each block writes its partial sums, and
// the last block to finish (a counter that it resets) adds them in a fixed
// order, so a replayed CUDA graph computes what the eager call did, bit
// for bit.
#include <type_traits>

#include "common.cuh"

namespace sa {
namespace hg {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 528;  // 4 a SM of an H100; fixed, so the statistics' order is the same everywhere
constexpr float SLOPE = 0.01f;
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float tf32r(float v) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

// d += a b for one m16n8k8 tile: TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as a TF32 head and the TF32 rounding of what is left: head + tail is
// x to within 2^-22 of it
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& head, unsigned& tail) {
  const float f = __uint_as_float(x), hf = tf32r(f);
  head = __float_as_uint(hf);
  tail = __float_as_uint(tf32r(f - hf));
}

// A volume as a consumer reads it: the raw values, and optionally the
// instance norm + LeakyReLU (stats) and the gate (gl, gr) to apply on load.
struct Vol {
  const void* x;       // NDHWC (B, D, H, W, C), or NCDHW (B, C, D, H, W) where said
  int bf16;            // x's storage type
  const float* stats;  // (B, 2, C): Σx, Σx² over the volume, or null: x is taken as it is
  float inv_n;         // 1 / (D H W)
  const float* gl;     // (B, H, W, C) f32: sigmoid of the left attention, or null (no gate)
  const float* gr;     // (B, H, D, C) f32: sigmoid of the right attention
  const float* gl2;    // a resized gate's second factors, as gl and gr, or null
  const float* gr2;
  int C, D, H, W;
};

// Where a kernel leaves the statistics of its output: per-block partial
// sums (nblk, B, 2 C) and the final (B, 2, C); the counter starts at 0 and
// is reset by the last block.
struct Stats {
  float* part;
  float* out;
  unsigned* counter;
};

// mean and 1/sqrt(var + eps) of channels [0, C) of batch b into shared
// memory, as layers.instance_norm computes them (mean = Σx / n, var =
// Σx² / n - mean²), rounded to bf16 for a bf16 volume (it applies them in
// the volume's dtype)
__device__ __forceinline__ void norm_consts(const Vol& v, int b, float* mean_s, float* inv_s) {
  if (v.stats == nullptr) return;
  for (int c = threadIdx.x; c < v.C; c += blockDim.x) {
    const float s1 = v.stats[(b * 2) * v.C + c], s2 = v.stats[(b * 2 + 1) * v.C + c];
    const float mean = s1 * v.inv_n;
    const float var = s2 * v.inv_n - mean * mean;
    const float inv = rsqrtf(var + EPS);
    mean_s[c] = v.bf16 ? bf16r(mean) : mean;
    inv_s[c] = v.bf16 ? bf16r(inv) : inv;
  }
}

// Channels c0 .. c0+7 of voxel (b, d, h, w) of an NDHWC volume as its
// consumer reads them: raw -> (x - mean) * inv -> LeakyReLU, in bf16
// arithmetic for a bf16 volume -> gate * x in f32 (GATE: where v may have
// a gate; a kernel that never reads one leaves its code out).
template <bool GATE = true>
__device__ __forceinline__ void load_act8(const Vol& v, int b, int d, int h, int w, int c0, const float* mean_s,
                                          const float* inv_s, float (&o)[8]) {
  const size_t off = ((static_cast<size_t>(b) * v.D + d) * v.H + h) * static_cast<size_t>(v.W) * v.C +
                     static_cast<size_t>(w) * v.C + c0;
  if (v.bf16)
    load8(static_cast<const __nv_bfloat16*>(v.x) + off, o);
  else
    load8(static_cast<const float*>(v.x) + off, o);
  if (v.stats != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (v.bf16) {
        const float y = bf16r(bf16r(o[j] - mean_s[c0 + j]) * inv_s[c0 + j]);
        o[j] = y > 0.f ? y : bf16r(y * SLOPE);
      } else {
        const float y = (o[j] - mean_s[c0 + j]) * inv_s[c0 + j];
        o[j] = y > 0.f ? y : y * SLOPE;
      }
    }
  }
  if (GATE && v.gl != nullptr) {
    const size_t li = ((static_cast<size_t>(b) * v.H + h) * v.W + w) * v.C + c0;
    const size_t ri = ((static_cast<size_t>(b) * v.H + h) * v.D + d) * v.C + c0;
    float a[8], r[8];
    load8(v.gl + li, a);
    load8(v.gr + ri, r);
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] *= r[j];
    if (v.gl2 != nullptr) {
      float s[8];
      load8(v.gl2 + li, r);
      load8(v.gr2 + ri, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] += r[j] * s[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = a[j] * o[j];
  }
}

// Channel c of voxel (b, d, h, w) of an NCDHW volume, taken as it is.
__device__ __forceinline__ float load_ncdhw(const Vol& v, int b, int c, int d, int h, int w) {
  const size_t off = ((static_cast<size_t>(b) * v.C + c) * v.D + d) * static_cast<size_t>(v.H) * v.W +
                     static_cast<size_t>(h) * v.W + w;
  return v.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v.x)[off]) : static_cast<const float*>(v.x)[off];
}

// The block's column sums red_s (WARPS, ncol) -> its partial; the last
// block of the grid adds every block's partial in block order into the
// (B, ncol) statistics and resets the counter.  Called by every thread.
__device__ void finish_stats(const float* red_s, int ncol, const Stats& st, int b, int blk, int nblk, int B,
                             float* scratch_s) {
  __shared__ int last;
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < ncol) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red_s[w * ncol + tid];
    st.part[(static_cast<size_t>(blk) * B + b) * ncol + tid] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(st.counter, 1u) == static_cast<unsigned>(B * nblk - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int pairs = B * ncol;
  if (pairs >= THREADS) {
    for (int p = tid; p < pairs; p += THREADS) {
      float s = 0.f;
      for (int k = 0; k < nblk; ++k) s += __ldcg(st.part + static_cast<size_t>(k) * pairs + p);
      st.out[p] = s;
    }
  } else {
    int G = 1;
    while (2 * G * pairs <= THREADS) G *= 2;
    const int p = tid / G, j = tid % G;
    float s = 0.f;
    if (p < pairs)
      for (int k = j; k < nblk; k += G) s += __ldcg(st.part + static_cast<size_t>(k) * pairs + p);
    scratch_s[tid] = s;
    __syncthreads();
    for (int half = G / 2; half > 0; half >>= 1) {
      if (j < half) scratch_s[tid] += scratch_s[tid + half];
      __syncthreads();
    }
    if (p < pairs && j == 0) st.out[p] = scratch_s[tid];
  }
  if (tid == 0) *st.counter = 0u;
}

// ---------------------------------------------------------------------------
// 3x3x3 convolution

template <int S, int NT, bool PRECISE = false>
struct Tile {
  static constexpr int MI = S == 1 ? 2 : 1;  // m16 row blocks (lines of 16 voxels along W) a warp
  static constexpr int TW = 16, TH = 4, TD = S == 1 ? 4 : 2;  // TD x TH = 8 MI lines
  static constexpr int HD = (TD - 1) * S + 3, HH = (TH - 1) * S + 3, HW = (TW - 1) * S + 3;
  static constexpr int HV = HD * HH * HW;  // input voxels of a tile's halo
  static constexpr int PER = (HV + THREADS - 1) / THREADS;  // halo voxels a thread stages
  // shared-memory stride of a staged voxel (8 channels), conflict-free for
  // fragment rows S voxels apart: 12 (48-byte ldmatrix rows), 10 (stride 2:
  // scalar loads at 20 g + t)
  static constexpr int CS = S == 1 ? 12 : 10;
  static constexpr int IN_FLOATS = (HV * CS + 3) / 4 * 4;  // the weights that follow start 16-byte aligned
  // blocks an SM keeps (the registers' bound): the big volumes' convolutions
  // (N 8 or 16) wait on their staging loads, and more resident blocks hide them
  // (PRECISE: the heads and tails take registers; its time does not count)
  static constexpr int MIN_BLOCKS = PRECISE ? 2 : S == 1 && NT == 1 ? 4 : S == 1 && NT == 2 ? 3 : 2;
};

template <int CIN, int COUT>
struct Wt {
  static constexpr int NCH = CIN / 8, NT = COUT / 8;
  // a chunk's weights in shared memory: [tap][n][k], a row of 8 k padded to
  // 12 floats (16-byte rows for ldmatrix, conflict-free: 12 n + 4 k-half)
  static constexpr int WK = 12;
  static constexpr int CHUNK = 27 * COUT * WK;  // floats of one input chunk's weights
  static constexpr bool RESIDENT = NCH * CHUNK * 4 <= 48 * 1024;
  static constexpr int FLOATS = RESIDENT ? NCH * CHUNK : CHUNK;
};

template <int CIN, int COUT, int S>
constexpr int conv3_smem() {
  using T = Tile<S, COUT / 8>;
  return (T::IN_FLOATS + Wt<CIN, COUT>::FLOATS) * 4;
}

struct Conv3Args {
  Vol in;  // NDHWC with its norm and gate, or NCDHW taken as it is (ncdhw)
  const void* w;  // (COUT, CIN, 3, 3, 3), f32 or bf16 (w_bf16)
  int w_bf16;
  int round_w_bf16;  // the block runs in bf16: weights rounded to bf16, as conv_in_dtype casts them
  void* out;  // raw (B, Do, Ho, Wo, COUT), TOut
  int B, Do, Ho, Wo;
  int tiles_d, tiles_h, tiles_w, nblk;
  Stats st;
};

// chunk ch's weights (27 taps x COUT x 8 channels) into w_s as [tap][n][k],
// TF32 (PRECISE: f32, split at the product)
template <int CIN, int COUT, bool PRECISE>
__device__ __forceinline__ void stage_weights(const Conv3Args& a, int ch, float* w_s) {
  using WT = Wt<CIN, COUT>;
  for (int e = threadIdx.x; e < 27 * 8 * COUT; e += THREADS) {
    const int k = e % 8, n = (e / 8) % COUT, tap = e / (8 * COUT);
    const size_t src = (static_cast<size_t>(n) * CIN + ch * 8 + k) * 27 + tap;
    float v = a.w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.w)[src]) : static_cast<const float*>(a.w)[src];
    if (a.round_w_bf16) v = bf16r(v);
    w_s[(tap * COUT + n) * WT::WK + k] = PRECISE ? v : tf32r(v);
  }
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

template <typename TOut, int CIN, int COUT, int S, bool NCDHW, bool PRECISE, bool GATED>
__global__ void __launch_bounds__(THREADS, (Tile<S, COUT / 8, PRECISE>::MIN_BLOCKS)) conv3_kernel(const Conv3Args a) {
  using WT = Wt<CIN, COUT>;
  constexpr int NT = WT::NT;
  using T = Tile<S, NT, PRECISE>;
  constexpr int MI = T::MI;
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;
  float* w_s = smem + T::IN_FLOATS;
  __shared__ float mean_s[CIN], inv_s[CIN];
  __shared__ float red_s[WARPS * 2 * COUT];
  __shared__ float scratch_s[THREADS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, blk = blockIdx.x;
  const Vol& v = a.in;
  norm_consts(v, b, mean_s, inv_s);
  if (WT::RESIDENT)
    for (int ch = 0; ch < WT::NCH; ++ch) stage_weights<CIN, COUT, PRECISE>(a, ch, w_s + ch * WT::CHUNK);

  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;

  // the halo voxel of (od * S, oh * S, 0) for each of this warp's lines
  int line_vox[MI], line_od[MI], line_oh[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int line = warp * MI + mi;
    line_od[mi] = line / T::TH;
    line_oh[mi] = line % T::TH;
    line_vox[mi] = (line_od[mi] * S * T::HH + line_oh[mi] * S) * T::HW;
  }

  // work items: (tile, input chunk) pairs, chunks innermost; a block takes
  // tiles blk, blk + nblk, ...
  const int ntiles = a.tiles_d * a.tiles_h * a.tiles_w;
  const int nitems = (ntiles - blk + a.nblk - 1) / a.nblk * WT::NCH;
  auto origin = [&](int item, int& d0, int& h0, int& w0) {
    const int tile = blk + item / WT::NCH * a.nblk;
    const int tw = tile % a.tiles_w, th = (tile / a.tiles_w) % a.tiles_h, td = tile / (a.tiles_w * a.tiles_h);
    d0 = td * T::TD;
    h0 = th * T::TH;
    w0 = tw * T::TW;
  };
  // halo voxel p of this thread for the item at (d0, h0, w0): its input
  // coordinates, and whether it lies inside the volume (else it is padding)
  auto halo = [&](int p, int d0, int h0, int w0, int& d, int& h, int& w) {
    const int i = threadIdx.x + p * THREADS;
    const int zw = i % T::HW, zh = (i / T::HW) % T::HH, zd = i / (T::HW * T::HH);
    d = d0 * S - 1 + zd;
    h = h0 * S - 1 + zh;
    w = w0 * S - 1 + zw;
    return i < T::HV && d >= 0 && d < v.D && h >= 0 && h < v.H && w >= 0 && w < v.W;
  };
  // the item's halo, normalised, activated, gated and rounded to TF32
  // (PRECISE: kept in f32), into in_s
  auto stage = [&](int item) {
    int d0, h0, w0, d, h, w;
    origin(item, d0, h0, w0);
    const int c0 = item % WT::NCH * 8;
#pragma unroll
    for (int p = 0; p < T::PER; ++p) {
      const int i = tid + p * THREADS;
      if (i >= T::HV) break;
      float x[8];
      if (halo(p, d0, h0, w0, d, h, w)) {
        if (NCDHW) {
#pragma unroll
          for (int j = 0; j < 8; ++j) x[j] = load_ncdhw(v, b, c0 + j, d, h, w);
        } else {
          load_act8<GATED>(v, b, d, h, w, c0, mean_s, inv_s, x);
        }
        if (!PRECISE) {
#pragma unroll
          for (int j = 0; j < 8; ++j) x[j] = tf32r(x[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = 0.f;
      }
      float* dst = in_s + i * T::CS;
      if (T::CS % 4 == 0) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) reinterpret_cast<float2*>(dst)[j] = make_float2(x[2 * j], x[2 * j + 1]);
      }
    }
  };

  // ldmatrix row addresses of this lane: A (stride 1) row lrow (+ 8) of a
  // line at channels 0-3 (4-7); B row n = lrow of an n-tile at k 0-3 (4-7)
  const int lrow = lane & 7, lmat = lane >> 3;
  const int a_lane = (lrow + 8 * (lmat & 1)) * T::CS + 4 * (lmat >> 1);
  const int b_lane = lrow * WT::WK + 4 * (lmat & 1);

  int d0 = 0, h0 = 0, w0 = 0;
  float acc[MI][NT][4];
  for (int item = 0; item < nitems; ++item) {
    const int ch = item % WT::NCH;
    if (ch == 0) {
      origin(item, d0, h0, w0);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
    }
    __syncthreads();  // the previous item's products are done with in_s (and w_s)
    stage(item);
    if (!WT::RESIDENT) stage_weights<CIN, COUT, PRECISE>(a, ch, w_s);
    __syncthreads();

    const float* wc = WT::RESIDENT ? w_s + ch * WT::CHUNK : w_s;
#pragma unroll 3
    for (int tap = 0; tap < 27; ++tap) {
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      const int toff = (kd * T::HH + kh) * T::HW + kw;
      unsigned bf[NT][2], bt[NT][2];  // bt: PRECISE's tails
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        ldmatrix_x2(bf[j], wc + (tap * COUT + j * 8) * WT::WK + b_lane);
        if (PRECISE) {
          split_tf32(bf[j][0], bf[j][0], bt[j][0]);
          split_tf32(bf[j][1], bf[j][1], bt[j][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        unsigned af[4];
        if (S == 1) {
          ldmatrix_x4(af, in_s + (line_vox[mi] + toff) * T::CS + a_lane);
        } else {  // rows two voxels apart: 40-byte rows, no ldmatrix
          const float* r0 = in_s + (line_vox[mi] + toff + S * g) * T::CS;
          const float* r1 = r0 + 8 * S * T::CS;
          af[0] = __float_as_uint(r0[t]);
          af[1] = __float_as_uint(r1[t]);
          af[2] = __float_as_uint(r0[t + 4]);
          af[3] = __float_as_uint(r1[t + 4]);
        }
        if (PRECISE) {
          unsigned at[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(af[q], af[q], at[q]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_tf32(acc[mi][j], at, bf[j][0], bf[j][1]);
            mma_tf32(acc[mi][j], af, bt[j][0], bt[j][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[mi][j], af, bf[j][0], bf[j][1]);
      }
    }
    if (ch != WT::NCH - 1) continue;

    // epilogue: the raw output, and its sums over the stored values
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int od = d0 + line_od[mi], oh = h0 + line_oh[mi];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = w0 + g + 8 * half;
        if (od >= a.Do || oh >= a.Ho || ow >= a.Wo) continue;
        const size_t base = (((static_cast<size_t>(b) * a.Do + od) * a.Ho + oh) * a.Wo + ow) * COUT;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float y0 = acc[mi][j][2 * half], y1 = acc[mi][j][2 * half + 1];
          const int n = j * 8 + 2 * t;
          if constexpr (sizeof(TOut) == 2) {
            const __nv_bfloat162 p = __floats2bfloat162_rn(y0, y1);
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + base + n) = p;
            y0 = __low2float(p);
            y1 = __high2float(p);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + n) = make_float2(y0, y1);
          }
          s1[j][0] += y0;
          s1[j][1] += y1;
          s2[j][0] += y0 * y0;
          s2[j][1] += y1 * y1;
        }
      }
    }
  }

  // column sums: over the 8 row groups of a warp (lanes t, t + 4, ...), then the warps
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1[j][q] += __shfl_xor_sync(0xffffffffu, s1[j][q], o);
        s2[j][q] += __shfl_xor_sync(0xffffffffu, s2[j][q], o);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        red_s[warp * 2 * COUT + j * 8 + 2 * t + q] = s1[j][q];
        red_s[warp * 2 * COUT + COUT + j * 8 + 2 * t + q] = s2[j][q];
      }
  }
  finish_stats(red_s, 2 * COUT, a.st, b, blk, a.nblk, a.B, scratch_s);
}

// ---------------------------------------------------------------------------
// 1x1x1 convolution over [direct segment, upsampled segment]
//
// The convolution is linear and so is the trilinear resize, whose weights
// sum to 1 along each axis: W_up . resize(u) = resize(W_up . u).  So the
// upsampled segment's share is taken at the low resolution, where the
// volume that is upsampled is written (finalize_kernel's projection), and
// the full-resolution kernel reads and interpolates COUT channels of it
// instead of the segment's, and adds them.

enum SegKind { SEG_NCDHW = 0, SEG_RAW = 1 };

struct Conv1Args {
  Vol seg;        // the direct segment at the output's volume: NCDHW as it is, or raw NDHWC with its norm and gate
  int kind;
  const float* up;  // (B, Ds, Hs, Ws, COUT) f32: the upsampled segment's share, at the low resolution
  int Ds, Hs, Ws;
  float sd, sh, sw;  // align-corners scales (in - 1) / (out - 1) along D, H, W
  const void* w;     // (COUT, w_ld) f32 or bf16 (w_bf16); the direct segment's columns from w_off
  int w_bf16, w_ld, w_off;
  float* out;        // raw (B, D, H, W, COUT) f32
  int B, D, H, W;
  int nblk;
  Stats st;
};

// align-corners source of output index i: lower index, upper index, weight
__device__ __forceinline__ void src_index(int i, int n_in, float scale, int& i0, int& i1, float& f) {
  const float s = static_cast<float>(i) * scale;
  i0 = min(max(static_cast<int>(floorf(s)), 0), n_in - 1);
  i1 = min(i0 + 1, n_in - 1);
  f = s - static_cast<float>(i0);
}

// y[0 .. C) += the trilinear resize (align corners; along D, then H, then
// W, as ops/interp.py's matrices) of u (B, Ds, Hs, Ws, C) at (b, d, h, w)
template <int C>
__device__ __forceinline__ void add_upsampled(const Conv1Args& a, int b, int d, int h, int w, float* y) {
  int d0, d1, h0, h1, w0, w1;
  float fd, fh, fw;
  src_index(d, a.Ds, a.sd, d0, d1, fd);
  src_index(h, a.Hs, a.sh, h0, h1, fh);
  src_index(w, a.Ws, a.sw, w0, w1, fw);
  const int hh[2] = {h0, h1}, ww[2] = {w0, w1};
  const size_t plane = static_cast<size_t>(a.Hs) * a.Ws;
  const float* u0 = a.up + (static_cast<size_t>(b) * a.Ds + d0) * plane * C;
  const float* u1 = a.up + (static_cast<size_t>(b) * a.Ds + d1) * plane * C;
#pragma unroll
  for (int c0 = 0; c0 < C; c0 += 8) {
    float wl[2][8];  // along H, for each W corner
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
      float hl[2][8];  // along D, for each H corner
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float p0[8], p1[8];
        const size_t r = (static_cast<size_t>(hh[hi]) * a.Ws + ww[wi]) * C + c0;
        load8(u0 + r, p0);
        load8(u1 + r, p1);
#pragma unroll
        for (int j = 0; j < 8; ++j) hl[hi][j] = (1.f - fd) * p0[j] + fd * p1[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) wl[wi][j] = (1.f - fh) * hl[0][j] + fh * hl[1][j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) y[c0 + j] += (1.f - fw) * wl[0][j] + fw * wl[1][j];
  }
}

template <int CD, int COUT>
__global__ void __launch_bounds__(THREADS) conv1_kernel(const Conv1Args a) {
  __shared__ float w_s[CD * COUT];
  __shared__ float mean_s[CD], inv_s[CD];
  __shared__ float red_s[WARPS * 2 * COUT];
  __shared__ float scratch_s[THREADS];
  const int tid = threadIdx.x, b = blockIdx.y, blk = blockIdx.x;
  for (int e = tid; e < CD * COUT; e += THREADS) {
    const int n = e / CD, k = e % CD;
    const size_t src = static_cast<size_t>(n) * a.w_ld + a.w_off + k;
    w_s[k * COUT + n] = a.w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.w)[src])
                                 : static_cast<const float*>(a.w)[src];
  }
  if (a.kind == SEG_RAW) norm_consts(a.seg, b, mean_s, inv_s);
  __syncthreads();

  float s1[COUT], s2[COUT];
#pragma unroll
  for (int n = 0; n < COUT; ++n) s1[n] = s2[n] = 0.f;
  const int nvox = a.D * a.H * a.W;
  for (int base = blk * THREADS; base < nvox; base += a.nblk * THREADS) {
    const int m = base + tid;
    if (m >= nvox) continue;
    const int w = m % a.W, h = (m / a.W) % a.H, d = m / (a.W * a.H);
    float x[CD];
    if (a.kind == SEG_NCDHW) {
#pragma unroll
      for (int c = 0; c < CD; ++c) x[c] = load_ncdhw(a.seg, b, c, d, h, w);
    } else {
#pragma unroll
      for (int c0 = 0; c0 < CD; c0 += 8) {
        float o[8];
        load_act8(a.seg, b, d, h, w, c0, mean_s, inv_s, o);
#pragma unroll
        for (int j = 0; j < 8; ++j) x[c0 + j] = o[j];
      }
    }
    float y[COUT];
#pragma unroll
    for (int n = 0; n < COUT; ++n) y[n] = 0.f;
#pragma unroll
    for (int k = 0; k < CD; ++k)
#pragma unroll
      for (int n = 0; n < COUT; ++n) y[n] += w_s[k * COUT + n] * x[k];
    add_upsampled<COUT>(a, b, d, h, w, y);
    float* o = a.out + (static_cast<size_t>(b) * nvox + m) * COUT;
#pragma unroll
    for (int n = 0; n < COUT; n += 4) reinterpret_cast<float4*>(o)[n / 4] = make_float4(y[n], y[n + 1], y[n + 2], y[n + 3]);
#pragma unroll
    for (int n = 0; n < COUT; ++n) {
      s1[n] += y[n];
      s2[n] += y[n] * y[n];
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int n = 0; n < COUT; ++n) {
    const float a1 = warp_sum(s1[n]), a2 = warp_sum(s2[n]);
    if (lane == 0) {
      red_s[warp * 2 * COUT + n] = a1;
      red_s[warp * 2 * COUT + COUT + n] = a2;
    }
  }
  finish_stats(red_s, 2 * COUT, a.st, b, blk, a.nblk, a.B, scratch_s);
}

// ---------------------------------------------------------------------------
// finalize: a raw f32 NDHWC volume normalised, activated and gated

// written NCDHW f32: the hourglass's output
__global__ void __launch_bounds__(THREADS) finalize_kernel(const Vol v, float* out) {
  __shared__ float mean_s[64], inv_s[64];
  const int b = blockIdx.y;
  norm_consts(v, b, mean_s, inv_s);
  __syncthreads();
  const int nvox = v.D * v.H * v.W;
  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= nvox) return;
  const int w = m % v.W, h = (m / v.W) % v.H, d = m / (v.W * v.H);
  for (int c0 = 0; c0 < v.C; c0 += 8) {
    float o[8];
    load_act8(v, b, d, h, w, c0, mean_s, inv_s, o);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(static_cast<size_t>(b) * v.C + c0 + j) * nvox + m] = o[j];
  }
}

// projected through NP columns of a 1x1x1 convolution's weight, written
// NDHWC (B, D, H, W, NP) f32: a volume that is upsampled (see conv1_kernel)
template <int C, int NP>
__global__ void __launch_bounds__(THREADS) finalize_proj_kernel(const Vol v, const void* w, int w_bf16, int w_ld,
                                                                 int w_off, float* out) {
  __shared__ float mean_s[C], inv_s[C], w_s[C * NP];
  const int b = blockIdx.y;
  norm_consts(v, b, mean_s, inv_s);
  for (int e = threadIdx.x; e < C * NP; e += THREADS) {
    const int n = e / C, k = e % C;
    const size_t src = static_cast<size_t>(n) * w_ld + w_off + k;
    w_s[k * NP + n] = w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[src])
                             : static_cast<const float*>(w)[src];
  }
  __syncthreads();
  const int nvox = v.D * v.H * v.W;
  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= nvox) return;
  const int ww = m % v.W, h = (m / v.W) % v.H, d = m / (v.W * v.H);
  float y[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) y[n] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < C; c0 += 8) {
    float o[8];
    load_act8(v, b, d, h, ww, c0, mean_s, inv_s, o);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int n = 0; n < NP; ++n) y[n] += w_s[(c0 + j) * NP + n] * o[j];
  }
  float* p = out + (static_cast<size_t>(b) * nvox + m) * NP;
#pragma unroll
  for (int n = 0; n < NP; n += 4) reinterpret_cast<float4*>(p)[n / 4] = make_float4(y[n], y[n + 1], y[n + 2], y[n + 3]);
}

// ---------------------------------------------------------------------------
// launchers

// persistent grid: at most MAX_BLOCKS in all, every block the same count of work items
inline int persistent_blocks(int items, int B) {
  const int cap = max(1, MAX_BLOCKS / B);
  const int per = (items + cap - 1) / cap;
  return (items + per - 1) / per;
}

template <typename TOut, int CIN, int COUT, int S, bool NCDHW, bool PRECISE, bool GATED>
cudaError_t launch_conv3(Conv3Args a, cudaStream_t s) {
  using T = Tile<S, COUT / 8, PRECISE>;
  auto kernel = conv3_kernel<TOut, CIN, COUT, S, NCDHW, PRECISE, GATED>;
  constexpr int smem = conv3_smem<CIN, COUT, S>();
  cudaError_t e = smem_limit_once(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  a.tiles_d = (a.Do + T::TD - 1) / T::TD;
  a.tiles_h = (a.Ho + T::TH - 1) / T::TH;
  a.tiles_w = (a.Wo + T::TW - 1) / T::TW;
  a.nblk = persistent_blocks(a.tiles_d * a.tiles_h * a.tiles_w, a.B);
  kernel<<<dim3(a.nblk, a.B), THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int CD, int COUT>
cudaError_t launch_conv1(Conv1Args a, cudaStream_t s) {
  a.nblk = persistent_blocks((a.D * a.H * a.W + THREADS - 1) / THREADS, a.B);
  conv1_kernel<CD, COUT><<<dim3(a.nblk, a.B), THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace hg
}  // namespace sa

using sa::hg::Vol;

namespace {

Vol make_vol(const void* x, int bf16, const void* stats, const void* const* gate, int C, int D, int H, int W) {
  Vol v;
  v.x = x;
  v.bf16 = bf16;
  v.stats = static_cast<const float*>(stats);
  v.inv_n = 1.0f / static_cast<float>(static_cast<long long>(D) * H * W);
  v.gl = static_cast<const float*>(gate[0]);
  v.gr = static_cast<const float*>(gate[1]);
  v.gl2 = static_cast<const float*>(gate[2]);
  v.gr2 = static_cast<const float*>(gate[3]);
  v.C = C;
  v.D = D;
  v.H = H;
  v.W = W;
  return v;
}

}  // namespace

// 3x3x3 convolution, padding 1, stride 1 or 2.  x: NDHWC (B, Di, Hi, Wi,
// cin) raw, with its sums `stats` (B, 2, cin) or null, its gate gl (B, Hi,
// Wi, cin) / gr (B, Hi, Di, cin) or null, a resized gate's second factors
// gl2 / gr2 or null; or, with ncdhw, the hourglass's input (B, cin, Di, Hi,
// Wi) taken as it is.  w (cout, cin, 3, 3, 3) -> out (B, Do, Ho, Wo, cout)
// raw in out_bf16's type, its sums into stats_out (B, 2, cout); part /
// counter as Stats says.  precise: f32 operands in full f32 (3 TF32
// products each), else TF32.
extern "C" int sa_hg_conv3(const void* x, const void* stats, const void* gl, const void* gr, const void* gl2,
                           const void* gr2, const void* w, void* out, void* stats_out, void* part, void* counter, int B,
                           int Di, int Hi, int Wi, int cin, int cout, int stride, int ncdhw, int x_bf16, int w_bf16,
                           int out_bf16, int precise, void* stream) {
  using namespace sa::hg;
  Conv3Args a;
  const void* gate[4] = {gl, gr, gl2, gr2};
  a.in = make_vol(x, x_bf16, stats, gate, cin, Di, Hi, Wi);
  a.w = w;
  a.w_bf16 = w_bf16;
  a.round_w_bf16 = out_bf16;
  a.out = out;
  a.B = B;
  a.Do = (Di - 1) / stride + 1;
  a.Ho = (Hi - 1) / stride + 1;
  a.Wo = (Wi - 1) / stride + 1;
  a.st = Stats{static_cast<float*>(part), static_cast<float*>(stats_out), static_cast<unsigned*>(counter)};
  auto s = static_cast<cudaStream_t>(stream);
  if (ncdhw && (stats != nullptr || gl != nullptr)) return cudaErrorInvalidValue;
  if (out_bf16 && (!x_bf16 || gl != nullptr)) return cudaErrorInvalidValue;  // a gate promotes to f32
  if (gl == nullptr && gl2 != nullptr) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  // a bf16 block's operands are exact in TF32: precise changes nothing there
  const int p = precise && !out_bf16, gated = gl != nullptr;
  const int key = (cin << 16) | (cout << 8) | (stride << 4) | (ncdhw << 3) | (gated << 2) | (p << 1) | out_bf16;
#define SA_HG_CONV3(CI, CO, ST, NC, G, P, OB)                                                    \
  case (CI << 16) | (CO << 8) | (ST << 4) | (NC << 3) | (G << 2) | (P << 1) | OB:                \
    return launch_conv3<std::conditional_t<OB, bf, float>, CI, CO, ST, NC, P, G>(a, s);
#define SA_HG_CONV3_F32(CI, CO, ST, NC, G) SA_HG_CONV3(CI, CO, ST, NC, G, 0, 0) SA_HG_CONV3(CI, CO, ST, NC, G, 1, 0)
  switch (key) {
    SA_HG_CONV3(8, 16, 2, 1, 0, 0, 1)   // down_layers[0][0], bf16 volume
    SA_HG_CONV3(16, 16, 1, 0, 0, 0, 1)  // down_layers[0][1], bf16
    SA_HG_CONV3_F32(8, 16, 2, 1, 0)     // down_layers[0][0], f32 volume
    SA_HG_CONV3_F32(16, 16, 1, 0, 0)    // down_layers[0][1] f32; agg_layers[-1][1:]
    SA_HG_CONV3_F32(16, 32, 2, 0, 1)    // down_layers[1][0], reading the gated down[0]
    SA_HG_CONV3_F32(16, 32, 2, 0, 0)
    SA_HG_CONV3_F32(32, 32, 1, 0, 0)    // down_layers[1][1]
    SA_HG_CONV3_F32(32, 48, 2, 0, 1)    // down_layers[2][0], reading the gated down[1]
    SA_HG_CONV3_F32(32, 48, 2, 0, 0)
    SA_HG_CONV3_F32(48, 48, 1, 0, 0)    // down_layers[2][1]
    SA_HG_CONV3_F32(8, 8, 1, 0, 0)      // final_agg[1:]
    default:
      return cudaErrorInvalidValue;
  }
#undef SA_HG_CONV3_F32
#undef SA_HG_CONV3
}

// 1x1x1 convolution: out (B, D, H, W, cout) raw f32, its sums into
// stats_out, = the direct segment x (cd channels: kind 0 the hourglass's
// input (B, cd, D, H, W) as it is; kind 1 a raw NDHWC volume with its stats
// and gate, as sa_hg_conv3's x) through columns [w_off, w_off + cd) of w
// (cout, w_ld), plus `up` (B, Ds, Hs, Ws, cout) f32 (sa_hg_finalize's
// projection of the other segment) resized to (D, H, W), align corners.
extern "C" int sa_hg_conv1(const void* x, const void* stats, const void* gl, const void* gr, const void* gl2,
                           const void* gr2, const void* up, const void* w, void* out, void* stats_out, void* part,
                           void* counter, int B, int D, int H, int W, int cd, int kind, int x_bf16, int Ds, int Hs,
                           int Ws, int cout, int w_bf16, int w_ld, int w_off, void* stream) {
  using namespace sa::hg;
  if (kind == SEG_NCDHW && (stats != nullptr || gl != nullptr)) return cudaErrorInvalidValue;
  if (gl == nullptr && gl2 != nullptr) return cudaErrorInvalidValue;
  Conv1Args a;
  const void* gate[4] = {gl, gr, gl2, gr2};
  a.seg = make_vol(x, x_bf16, stats, gate, cd, D, H, W);
  a.kind = kind;
  a.up = static_cast<const float*>(up);
  a.Ds = Ds;
  a.Hs = Hs;
  a.Ws = Ws;
  auto scale = [](int n_in, int n_out) {
    return n_out == 1 ? 0.f : static_cast<float>(static_cast<double>(n_in - 1) / (n_out - 1));
  };
  a.sd = scale(Ds, D);
  a.sh = scale(Hs, H);
  a.sw = scale(Ws, W);
  a.w = w;
  a.w_bf16 = w_bf16;
  a.w_ld = w_ld;
  a.w_off = w_off;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.D = D;
  a.H = H;
  a.W = W;
  a.st = Stats{static_cast<float*>(part), static_cast<float*>(stats_out), static_cast<unsigned*>(counter)};
  auto s = static_cast<cudaStream_t>(stream);
  if (cd == 16 && cout == 16 && kind == SEG_RAW) return launch_conv1<16, 16>(a, s);   // agg_layers[-1][0]
  if (cd == 8 && cout == 8 && kind == SEG_NCDHW) return launch_conv1<8, 8>(a, s);     // final_agg[0]
  return cudaErrorInvalidValue;
}

// gate * LeakyReLU(instance norm(x)) of a raw f32 NDHWC (B, D, H, W, c)
// volume (the gate as sa_hg_conv3's): written NCDHW (w null; c a multiple
// of 8, at most 64), or projected through columns [w_off, w_off + c) of a
// 1x1x1 weight (np, w_ld) and written NDHWC (B, D, H, W, np).
extern "C" int sa_hg_finalize(const void* x, const void* stats, const void* gl, const void* gr, const void* gl2,
                              const void* gr2, const void* w, void* out, int B, int D, int H, int W, int c, int np,
                              int w_bf16, int w_ld, int w_off, void* stream) {
  using namespace sa::hg;
  if (stats == nullptr || (gl == nullptr && gl2 != nullptr)) return cudaErrorInvalidValue;
  const void* gate[4] = {gl, gr, gl2, gr2};
  const Vol v = make_vol(x, 0, stats, gate, c, D, H, W);
  const dim3 grid((D * H * W + THREADS - 1) / THREADS, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  if (w == nullptr) {
    if (c % 8 != 0 || c > 64) return cudaErrorInvalidValue;
    finalize_kernel<<<grid, THREADS, 0, s>>>(v, o);
  } else if (c == 32 && np == 16) {  // down[1], upsampled into agg_layers[-1][0]
    finalize_proj_kernel<32, 16><<<grid, THREADS, 0, s>>>(v, w, w_bf16, w_ld, w_off, o);
  } else if (c == 16 && np == 8) {  // the aggregation level's output, upsampled into final_agg[0]
    finalize_proj_kernel<16, 8><<<grid, THREADS, 0, s>>>(v, w, w_bf16, w_ld, w_off, o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
