// K2 vit_attention: flash-style multi-head attention on the fused QKV layout.
// Replaces stereoanywhere_tpu/ops/pallas/vit_attention.py (vit_attention).
// Design and bound: ops/cuda/vit_attention.py.
//
// Both bodies give each block 64 query rows of one (batch, head), stream the
// keys and values through shared memory in 64-row tiles and keep an online
// softmax (running max m, running sum l), so the (T, T) scores never reach
// device memory.  Keys past T score -inf; query rows past T are computed on
// zeros and never written.
//
// bf16 (the deployed type): tensor cores through mma.sync m16n8k16, 4 warps
// of 16 query rows each, FlashAttention-2 style.  K and V tiles stream into
// shared memory with cp.async, two stages deep, the next tile in flight
// while the current one multiplies; fragments come out of shared memory with
// ldmatrix (V transposed on the way).  Scores, P and the running output stay
// in registers: the accumulator layout of Q K^T is the A-operand layout of
// P V.  The softmax runs in log2 units (exp2f with the scale folded in).
//
// f32: FP32 FMA, 256 threads; each thread owns 4 query rows x 4 key columns
// of a score tile (rows ty + 16i, columns tx + 16j) and 4 rows x HD/16 output
// dims.  K is stored transposed and padded, so the reads are conflict-free;
// the row max and row sum are reduced across the 16 threads of a row by
// shuffles and P goes through shared memory.
#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBKV = 64;

// ---------------------------------------------------------------------------
// f32: FMA tiles

constexpr int kThreads = 256;

template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + HD * (kBKV + 1) + kBKV * HD + kBQ * (kBKV + 1);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) attn_kernel_f32(const float* __restrict__ qkv, float* __restrict__ out,
                                                            int Tn, int H, float scale) {
  constexpr int DPT = HD / 16;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [BQ][HD]
  float* Kt = Qs + kBQ * HD;             // [HD][BKV + 1]
  float* Vs = Kt + HD * (kBKV + 1);      // [BKV][HD]
  float* Ps = Vs + kBKV * HD;            // [BQ][BKV + 1]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const float* base = qkv + static_cast<size_t>(b) * Tn * row_stride + static_cast<size_t>(h) * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int q = q0 + r;
    Qs[e] = q < Tn ? base[q * row_stride + d] : 0.f;
  }

  float m_i[4], l_i[4], o[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kBKV) {
    __syncthreads();  // previous tile fully consumed (and Qs written, first time)
    for (int e = tid; e < kBKV * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int kv = k0 + c;
      float kval = 0.f, vval = 0.f;
      if (kv < Tn) {
        const float* row = base + kv * row_stride;
        kval = row[D + d];
        vval = row[2 * D + d];
      }
      Kt[d * (kBKV + 1) + c] = kval;
      Vs[e] = vval;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * (kBKV + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < Tn) ? s[i][j] * scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = half_warp_max(rmax);
      const float m_new = fmaxf(m_i[i], rmax);
      const float corr = expf(m_i[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (kBKV + 1) + tx + 16 * j] = p;
        rsum += p;
      }
      l_i[i] = l_i[i] * corr + half_warp_sum(rsum);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) o[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBKV + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float v = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], v, o[i][j]);
      }
    }
  }

  float* obase = out + static_cast<size_t>(b) * Tn * D + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Tn) continue;
    const float inv = 1.f / l_i[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j) obase[static_cast<size_t>(q) * D + tx + 16 * j] = o[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tiles, scores and output in registers

constexpr int kWarpsTC = 4;  // 16 query rows each
constexpr int kThreadsTC = 32 * kWarpsTC;

template <int HD>
struct TcLayout {
  static constexpr int LD = HD + 8;      // bf16 pitch: 16-byte rows, conflict-free ldmatrix
  static constexpr int TILE = kBQ * LD;  // one 64-row tile (kBQ == kBKV)
  static constexpr size_t BYTES = 5 * static_cast<size_t>(TILE) * sizeof(__nv_bfloat16);  // Q; K, V x 2 stages
};

// rows [r0, r0 + 64) of one head's HD columns (column offset col) into a
// [64][LD] tile, 16 bytes a copy; rows past Tn are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* base, size_t row_stride,
                                                int col, int r0, int Tn) {
  constexpr int PER_ROW = HD / 8;
  for (int c = threadIdx.x; c < kBQ * PER_ROW; c += kThreadsTC) {
    const int r = c / PER_ROW, d = (c % PER_ROW) * 8;
    const int row = min(r0 + r, Tn - 1);  // a valid address even where nothing is read
    cp_async16(dst + r * TcLayout<HD>::LD + d, base + row * row_stride + col + d, r0 + r < Tn ? 16 : 0);
  }
}

// Fragment layout of mma.m16n8k16 (PTX ISA): lane = 4 g + t.  An f32
// accumulator tile holds (row g, cols 2t, 2t+1) in [0], [1] and (row g + 8,
// same cols) in [2], [3]; an A operand holds rows g and g + 8 at columns
// 2t, 2t+1 and 2t+8, 2t+9.  So a score tile's accumulators are already the
// P operand of the next product once packed to bf16, as in FlashAttention-2.
template <int HD>
__global__ void __launch_bounds__(kThreadsTC) attn_kernel_bf16(const __nv_bfloat16* __restrict__ qkv,
                                                               __nv_bfloat16* __restrict__ out, int Tn, int H,
                                                               float scale_log2) {
  using L = TcLayout<HD>;
  constexpr int NS = kBKV / 8;  // score n-tiles of a warp (8)
  constexpr int NO = HD / 8;    // output n-tiles (8 or 16)
  constexpr int KQ = HD / 16;   // k-steps of Q K^T (4 or 8)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  auto* Ks = Qs + L::TILE;                                // [2][64][LD]
  auto* Vs = Ks + 2 * L::TILE;                            // [2][64][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // ldmatrix: lanes 8i .. 8i+7 address the rows of 8x8 matrix i
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;  // Q (A operand), V (.trans)
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;  // K (B operand)
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * Tn * row_stride;
  const int n_tiles = (Tn + kBKV - 1) / kBKV;

  load_tile_async<HD>(Qs, base, row_stride, h * HD, q0, Tn);
  load_tile_async<HD>(Ks, base, row_stride, D + h * HD, 0, Tn);
  load_tile_async<HD>(Vs, base, row_stride, 2 * D + h * HD, 0, Tn);
  cp_async_commit();

  unsigned qf[KQ][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8; log2 units

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next K/V tile streams in while this one multiplies
      load_tile_async<HD>(Ks + (buf ^ 1) * L::TILE, base, row_stride, D + h * HD, (it + 1) * kBKV, Tn);
      load_tile_async<HD>(Vs + (buf ^ 1) * L::TILE, base, row_stride, 2 * D + h * HD, (it + 1) * kBKV, Tn);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group landed: this tile (and Q)
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) ldmatrix_x4(qf[kq], Qs + (warp * 16 + a_row) * L::LD + kq * 16 + a_col);
    }
    const __nv_bfloat16* Kt = Ks + buf * L::TILE;
    const __nv_bfloat16* Vt = Vs + buf * L::TILE;

    // S = Q K^T: 16 x 64 per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        unsigned kf[4];
        ldmatrix_x4(kf, Kt + (j * 8 + b_row) * L::LD + kq * 16 + b_col);
        mma_bf16(s[j], qf[kq], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[kq], kf[2], kf[3]);
      }

    // online softmax; a row's 64 scores lie in the 4 lanes of its quad
    const int kv0 = it * kBKV;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = kv0 + j * 8 + 2 * t + (e & 1) < Tn ? s[j][e] * scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      corr[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    unsigned pf[NS / 2][4];  // P as the A operand, one per 16 keys
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[j][e] - m_run[e / 2]);
        l_run[e / 2] += p[e];
      }
      pf[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + a_row) * L::LD + n * 8 + a_col);
        mma_bf16(o[n], pf[kk], vf[0], vf[1]);
        mma_bf16(o[n + 1], pf[kk], vf[2], vf[3]);
      }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const int q = q0 + warp * 16 + g + 8 * i;
    if (q < Tn) {
      const float inv = 1.f / l_run[i];
      __nv_bfloat16* orow = out + (static_cast<size_t>(b) * Tn + q) * D + h * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<unsigned*>(orow + n * 8) = pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch_f32(const void* qkv, void* out, int B, int Tn, int H, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(attn_kernel_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((Tn + kBQ - 1) / kBQ, H, B);
  attn_kernel_f32<HD><<<grid, kThreads, bytes, stream>>>(static_cast<const float*>(qkv), static_cast<float*>(out),
                                                         Tn, H, 1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int Tn, int H, cudaStream_t stream) {
  constexpr size_t bytes = TcLayout<HD>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(attn_kernel_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((Tn + kBQ - 1) / kBQ, H, B);
  attn_kernel_bf16<HD><<<grid, kThreadsTC, bytes, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                                            static_cast<__nv_bfloat16*>(out), Tn, H,
                                                            1.4426950408889634f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace

extern "C" int sa_vit_attention(const void* qkv, void* out, int B, int Tn, int H, int HD, int dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (HD != 64 && HD != 128) return cudaErrorInvalidValue;
  if (dtype == SA_F32) return HD == 64 ? launch_f32<64>(qkv, out, B, Tn, H, s) : launch_f32<128>(qkv, out, B, Tn, H, s);
  if (dtype == SA_BF16)
    return HD == 64 ? launch_bf16<64>(qkv, out, B, Tn, H, s) : launch_bf16<128>(qkv, out, B, Tn, H, s);
  return cudaErrorInvalidValue;
}
