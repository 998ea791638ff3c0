// K2 vit_attention: flash-style multi-head attention on the fused QKV layout.
// Replaces stereoanywhere_tpu/ops/pallas/vit_attention.py (vit_attention).
// Design and bound: ops/cuda/vit_attention.py.
//
// Both bodies give each block the query rows of one (batch, head), stream
// the keys and values through shared memory in tiles and keep an online
// softmax (running max m, running sum l), so the (T, T) scores never reach
// device memory.  Keys past T score -inf; query rows past T are computed on
// zeros and never written.  The wrapper picks the body by dtype.
//
// bf16 (the deployed type): FlashAttention-3 shape on Hopper's TMA and
// wgmma, 128 query rows and 128-key tiles, a producer warpgroup and two
// consumer warpgroups that take turns at the tensor cores (the note above
// attn_kernel_wgmma).
//
// f32 (the check type): FP32 FMA, 64 query rows and 64-key tiles, 256
// threads; each thread owns 4 query rows x 4 key columns
// of a score tile (rows ty + 16i, columns tx + 16j) and 4 rows x HD/16 output
// dims.  K is stored transposed and padded, so the reads are conflict-free;
// the row max and row sum are reduced across the 16 threads of a row by
// shuffles and P goes through shared memory.
#include "sm90.cuh"

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
// bf16: wgmma + TMA, one producer warpgroup and two consumer warpgroups

namespace wgattn {

constexpr int BQ = 128, BKV = 128;  // query rows a block (64 a consumer warpgroup), keys a tile
constexpr int THREADS = 384;        // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int BAR_TURN = 1;         // named barriers 1 and 2: warpgroup 0's and 1's turn to issue

template <int HD>
struct Cfg {
  static constexpr int PANELS = HD / 64;  // 64-column panels of a tile, one 128-byte swizzle row each
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int Q_PANEL = BQ * 128, KV_PANEL = BKV * 128;  // bytes
  static constexpr int Q_BYTES = PANELS * Q_PANEL, KV_BYTES = PANELS * KV_PANEL;
  // alignment slack, Q, the ring of (K, V) stages, mbarriers: full and empty a stage, Q's
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + (2 * STAGES + 1) * 8;
};

}  // namespace wgattn

// The TMA map is 3-D over qkv (B, T, 3D), box (1, 128 rows, 64 columns):
// q, k and v of head h are the boxes at columns h HD, D + h HD, 2D + h HD
// (+ 64 for hd 128's second panel), and rows past T arrive as zeros from
// within the batch, never from batch b + 1.
//
// Each consumer warpgroup owns 64 query rows.  For key tile j it issues
// S = Q K_j^T (wgmma.m64n128k16, both operands K-major in shared memory) and,
// in the same turn, O += P_{j-1} V_{j-1} (wgmma.m64n64k16 per 64-column
// panel of V: P from registers, V MN-major, the transpose bit set); then it
// runs tile j's softmax while that PV product, and the other warpgroup's
// turn, keep the tensor cores busy.  The turns alternate through named
// barriers, so one warpgroup's exp2 overlaps the other's products.  S's
// accumulators become P in place: the accumulator layout of one k16 slice
// of S is wgmma's register A-fragment layout.  Keys past T score -inf
// (zero-filled keys would score 0).  The softmax runs in log2 units with
// the scale folded into one FMA; the row sums are taken from the f32 P
// before it is rounded to bf16 for the PV product (the TPU kernel sums the
// rounded P); both stay within the bf16 tolerance.
template <int HD>
__global__ void __launch_bounds__(wgattn::THREADS, 1) attn_kernel_wgmma(const __grid_constant__ CUtensorMap map,
                                                                        __nv_bfloat16* __restrict__ out, int Tn,
                                                                        int H, float scale_log2) {
  using namespace wgattn;
  using namespace sm90;
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(align1024(smem_raw));
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage s: K at sKV + 2 s KV_BYTES, V after it
  const uint32_t full0 = sKV + 2 * C::STAGES * C::KV_BYTES, empty0 = full0 + 8 * C::STAGES;
  const uint32_t qbar = empty0 + 8 * C::STAGES;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, D = H * HD;
  const int n_tiles = (Tn + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p) tma_load_3d(sQ + p * C::Q_PANEL, &map, qbar, h * HD + 64 * p, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::STAGES;
        mbar_wait(empty0 + 8 * s, ((j / C::STAGES) & 1) ^ 1);  // the first round passes at once
        const uint32_t k = sKV + 2 * s * C::KV_BYTES, full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_3d(k + p * C::KV_PANEL, &map, full, D + h * HD + 64 * p, j * BKV, b);
          tma_load_3d(k + C::KV_BYTES + p * C::KV_PANEL, &map, full, 2 * D + h * HD + 64 * p, j * BKV, b);
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const uint32_t qa = sQ + wg * 64 * 128;  // this warpgroup's 64 rows of each Q panel
    // accumulator layout (wgmma m64nN): x[4 jb + 2 i + c] is row 16 warp + g + 8 i,
    // column 8 jb + 2 t + c
    float s[BKV / 2], o[C::PANELS][32];
    unsigned pf[BKV / 16][4];  // P of the previous tile, the A fragment of each 16 keys
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) s[e] = 0.f;
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) pf[kk][0] = pf[kk][1] = pf[kk][2] = pf[kk][3] = 0u;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8; log2 units
    const int my_turn = BAR_TURN + wg, other_turn = BAR_TURN + (wg ^ 1);

    // A turn at the tensor cores: wait for it, issue, hand it to the other
    // warpgroup.  Turn 0 issues S_0; turn j (0 < j < n) S_j and P_{j-1} V_{j-1};
    // turn n P_{n-1} V_{n-1}.  Each path has a fixed sequence of wgmma groups,
    // so ptxas can see which group a wait retires.
    auto turn_begin = [&] {
      named_bar_sync(my_turn, 256);
      fence_regs(s);
      fence_regs(pf);
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p) fence_regs(o[p]);
      wgmma_fence();
    };
    auto issue_s = [&](int j) {
      const int st = j % C::STAGES;
      mbar_wait(full0 + 8 * st, (j / C::STAGES) & 1);
      const uint32_t k = sKV + 2 * st * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // panel kk / 4, 32 bytes a k16 step inside its rows
        wgmma_m64n128k16_ss(s, smem_desc(qa + (kk / 4) * C::Q_PANEL + (kk % 4) * 32, 16, 1024),
                            smem_desc(k + (kk / 4) * C::KV_PANEL + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const uint32_t v = sKV + (2 * (j % C::STAGES) + 1) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
          wgmma_m64n64k16_rs_mn(o[p], pf[kk], smem_desc(v + p * C::KV_PANEL + kk * 16 * 128, 1024, 1024));
      wgmma_commit();
    };
    // tile j's softmax on S (done): P in place in s, the running max, the
    // rescale factor of O and l, and P's row sums
    auto softmax = [&](int j, float (&corr)[2], float (&rsum)[2]) {
      fence_regs(s);
      const int kv0 = j * BKV;
      if (kv0 + BKV > Tn) {  // the ragged key tail
#pragma unroll
        for (int jb = 0; jb < BKV / 8; ++jb)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (kv0 + 8 * jb + 2 * t + c >= Tn) s[4 * jb + c] = s[4 * jb + 2 + c] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i] * scale_log2);
        corr[i] = exp2f(m_run[i] - m_new);
        m_run[i] = m_new;
        rsum[i] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        const int i = (e / 2) % 2;
        s[e] = exp2f(fmaf(s[e], scale_log2, -m_run[i]));
        rsum[i] += s[e];
      }
    };
    // P V of tile j is done: its K and V may be refilled
    auto retire_pv = [&](int j) {
      fence_regs(pf);
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p) fence_regs(o[p]);
      if (lane == 0) mbar_arrive(empty0 + 8 * (j % C::STAGES));
    };
    auto rescale_and_pack = [&](const float (&corr)[2], const float (&rsum)[2]) {
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[p][e] *= corr[(e / 2) % 2];
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * corr[i] + rsum[i];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);  // row g, keys 2t, 2t + 1
        pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row g + 8
        pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);  // row g, keys 8 + 2t, 9 + 2t
        pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);  // row g + 8
      }
    };

    float corr[2], rsum[2];
    if (wg == 1) named_bar_arrive(other_turn, 256);  // warpgroup 0 takes the first turn
    mbar_wait(qbar, 0);
    turn_begin();
    issue_s(0);
    named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    softmax(0, corr, rsum);
    rescale_and_pack(corr, rsum);
    for (int j = 1; j < n_tiles; ++j) {
      turn_begin();
      issue_s(j);
      issue_pv(j - 1);
      named_bar_arrive(other_turn, 256);
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} runs under the softmax
      softmax(j, corr, rsum);
      wgmma_wait<0>();
      retire_pv(j - 1);
      rescale_and_pack(corr, rsum);
    }
    turn_begin();
    issue_pv(n_tiles - 1);
    if (wg == 0) named_bar_arrive(other_turn, 256);  // warpgroup 1 takes the last turn
    wgmma_wait<0>();
    retire_pv(n_tiles - 1);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
      const int q = q0 + wg * 64 + warp * 16 + g + 8 * i;
      if (q < Tn) {
        const float inv = 1.f / l_run[i];
        __nv_bfloat16* orow = out + (static_cast<size_t>(b) * Tn + q) * D + h * HD + 2 * t;
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
#pragma unroll
          for (int jb = 0; jb < 8; ++jb)
            *reinterpret_cast<unsigned*>(orow + 64 * p + 8 * jb) =
                pack_bf16(o[p][4 * jb + 2 * i] * inv, o[p][4 * jb + 2 * i + 1] * inv);
      }
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
cudaError_t set_smem_limit_bf16() {
  return cudaFuncSetAttribute(attn_kernel_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(wgattn::Cfg<HD>::SMEM));
}

dim3 grid_of(int B, int Tn, int H) { return dim3((Tn + wgattn::BQ - 1) / wgattn::BQ, H, B); }

template <int HD>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int Tn, int H, cudaStream_t stream) {
  const cuuint64_t d3 = 3ull * H * HD;
  const cuuint64_t dims[3] = {d3, static_cast<cuuint64_t>(Tn), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {2 * d3, 2 * d3 * Tn};
  const cuuint32_t box[3] = {64, wgattn::BQ, 1};  // BQ == BKV: one map for q, k and v
  CUtensorMap map;
  cudaError_t e = sm90::make_map_bf16(&map, qkv, 3, dims, strides, box);
  if (e == cudaSuccess) e = set_smem_limit_bf16<HD>();
  if (e != cudaSuccess) return e;
  attn_kernel_wgmma<HD><<<grid_of(B, Tn, H), wgattn::THREADS, wgattn::Cfg<HD>::SMEM, stream>>>(
      map, static_cast<__nv_bfloat16*>(out), Tn, H, 1.4426950408889634f / sqrtf(static_cast<float>(HD)));
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

// The bf16 body's launch geometry: out[0..5] = grid (x, y, z), threads,
// dynamic shared memory in bytes, and the blocks the card keeps resident on
// one SM (the occupancy query, at that shared memory).
extern "C" int sa_vit_attention_geometry(int B, int Tn, int H, int HD, int* out) {
  if (HD != 64 && HD != 128) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(B, Tn, H);
  const size_t smem = HD == 64 ? wgattn::Cfg<64>::SMEM : wgattn::Cfg<128>::SMEM;
  cudaError_t e = HD == 64 ? set_smem_limit_bf16<64>() : set_smem_limit_bf16<128>();
  int per_sm = 0;
  if (e == cudaSuccess)
    e = HD == 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_kernel_wgmma<64>, wgattn::THREADS, smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_kernel_wgmma<128>, wgattn::THREADS,
                                                                 smem);
  const int v[6] = {static_cast<int>(grid.x), static_cast<int>(grid.y), static_cast<int>(grid.z), wgattn::THREADS,
                    static_cast<int>(smem), per_sm};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return e;
}
