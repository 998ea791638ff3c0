// The bf16 3x3 convolutions of the refinement step on Hopper's TMA and
// wgmma: a stride-1 "same" 3x3 convolution over NHWC inputs as an implicit
// GEMM, with the epilogue of its caller: the ConvGRU of K9 (and of K6
// through it), its gates and blend; K8's convc2/convf2 (one 3-group conv,
// ReLU) and merge conv (ReLU and the [out | flow-x | 0] lanes); and K7's
// conv1, whose ReLU output goes no further than the epilogue: there it is
// projected on conv2's x row, each pixel's 9 tap columns (launch_flowhead).
//
//   C[m, n] = epilogue( sum_k A[m, k] W[n, k] ),  m = (b, y, x) pixel,
//   k = (tap, segment, channel),  A[m, (tap, s, c)] = seg_s[b, y + dy, x + dx, c]
//
// Replaces stereoanywhere_tpu/ops/pallas/step_fused.py (fused_step_gru's
// _gru_kernel, the 3x3 stages of fused_step_motion's _motion_kernel, the
// conv1 and tap columns of fused_step_head's _fh_kernel) and
// ops/pallas/gru_fused.py (gru_fused's _zr_kernel and _q_kernel); the f32
// bodies stay on conv_igemm.cuh's FMA tile.
//
// Bound: at the 512^2 request the three GRU scales do 56 GFLOP, gru08 43.5
// of them for 32 MB moved, and K8's two 3x3 stages 10.9 GFLOP for 13 MB,
// hundreds of FLOP a byte against the card's ridge of 295, so the tensor
// cores bound them.  The design keeps them fed without any gather code:
// - the M tile is a BW x BH patch of pixels of one image (BW x BH = BM, 128
//   or 64); BW is the power of two that covers the plane with the fewest
//   patches, so a 32- or 80-wide plane does not waste half of every load;
// - A comes per K-step by one TMA load from a 4-D tensor map over
//   (C, W, H, B) with box (64 channels, BW, BH, 1) at (c0, x0 + dx, y0 + dy,
//   b): a tap is a coordinate offset, coordinates outside the image
//   (negative ones too) arrive as zeros, which is the convolution's zero
//   padding, and the batch is its own coordinate, so a tap never reads
//   another image.  64 bf16 channels are 128 bytes: the 128-byte swizzle
//   rows wgmma reads;
// - the [h, x1, x2] concatenation is never built: each segment has its own
//   map and the K loop runs tap x segment x 64-channel chunk (9 x 6 = 54
//   steps at gru08, 27 at K8's merge conv).  A chunk past a segment's
//   channels reads zeros in A, so the weights it meets there add nothing;
// - grouped form (K8's convc2 on both correlation streams and convf2, 3
//   groups of 64 over one 192-channel input): a tile's BN output channels
//   lie in one group, whose 64 input channels its A loads start at, so a
//   tile does 9 K-steps and none of the block-diagonal dense form's zero
//   products; pick_plan takes only tiles whose BN divides the group's width;
// - W, packed (N, 9, Cin) (grouped: Cin a group's), is K-major already: a
//   3-D map over (Cin, 9, N), box (64, 1, BN);
// - warp roles as in gemm_wgmma.cuh: a producer warpgroup (one thread keeps
//   the mbarrier full/empty ring filled), BM / 64 consumer warpgroups
//   issuing four wgmma.m64nBNk16 a stage, a persistent grid of at most one
//   block an SM, launched as a programmatic dependent of the kernel before;
// - the epilogue goes through a padded f32 shared tile, 64 columns at a
//   time, then works in 16-byte pieces along the channels: 8 accumulators,
//   8 bias values, the 16-byte injection, h and z pieces, sigmoid / tanh /
//   blend, one 16-byte store (K8: bias, ReLU, flow-x in lane N - 2; K7:
//   bias, ReLU, rounded to bf16 as the TPU kernel's fh1 slab, then 8
//   channels' share of the 9 tap-column dots, summed over the 8 threads of a
//   row by shuffles).  Pixels of a patch outside the image are not stored.
// The tile (BM x BN of 128 x 256, 128 x 128, 64 x 128, 64 x 64 or 128 x 64)
// is picked per launch by the fewest rounds of tiles over the SMs, each
// round costing its products plus a fixed overhead measured on the card
// (pick_plan):
// 128 x 256 / 128 x 128 for the z/r and q launches of the 128 x 128 and
// 96 x 320 planes, 64-row tiles on the small planes, where 128-row ones
// left most of the 132 SMs idle; K8's grouped stage takes 128 x 64.
//
// K9: two launches a call (z/r, then q): q's convolution reads r*h of the
// neighbouring pixels, which another block computes.  Rounding points are
// the TPU kernel's: z and r*h rounded to bf16 in device-memory scratch,
// then h' rounded once.  K8: launch_motion.  Needs every channel count and
// the injections' row stride a multiple of 8 (16-byte rows) and 16-byte
// aligned operands.
// The host's share of a call is kept small: the 3-4 maps of a launch come
// from sm90.cuh's cache of encoded maps, and a kernel's shared-memory limit
// is raised once.
#pragma once

#include <algorithm>

#include "conv_igemm.cuh"  // sa::conv::Epi, sigmoidf
#include "sm90.cuh"

namespace sa::cw {

constexpr int BK = 64, TAPS = 9, MAX_SEGS = sa::conv::MAX_SEGS;
constexpr int SMEM_LIMIT = 232448, MAX_STAGES = 6;
constexpr int PITCH = 72;  // floats a row of a warpgroup's 64-column f32 chunk: 8 mod 32 banks
// K7: conv1's 256 outputs, and conv2's x row (9 taps x 256, bf16) kept in shared memory as f32
constexpr int FH_N = 256, FH_W2_BYTES = TAPS * FH_N * 4;

template <int BM, int BN>
struct Tile {
  static constexpr int WGS = BM / 64;  // consumer warpgroups; the producer is warpgroup WGS
  static constexpr int THREADS = 128 * (WGS + 1);
  static constexpr int A_BYTES = BM * BK * 2, STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr int OUT_BYTES = WGS * 64 * PITCH * 4;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - OUT_BYTES) / (STAGE_BYTES + 16);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  // alignment slack, ring, f32 chunks, mbarriers
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "the ring does not fit");
};

// One launch's TMA maps: each input segment over (C, W, H, B), box (64, BW,
// BH, 1); W over (Cin, 9, N), box (64, 1, BN)
struct Maps {
  CUtensorMap a[MAX_SEGS];
  CUtensorMap w;
};

struct Args {
  int B, H, W, N;
  int bw, bh;  // a tile's pixel patch, BW x BH = BM
  int nseg;
  int seg_c[MAX_SEGS];    // channels of each input segment
  int seg_off[MAX_SEGS];  // its first channel in W's Cin
  int groups;             // > 1 only with nseg == 1: group g of the outputs reads input group g
  int hd, inj_ld;
  const float* bias;          // (N)
  const __nv_bfloat16* h;     // (M, hd)
  const __nv_bfloat16* z;     // (M, hd): the update gate (q launch)
  const __nv_bfloat16* inj0;  // z/r: cz; q: cq (row stride inj_ld)
  const __nv_bfloat16* inj1;  // z/r: cr
  const float* coords;        // (M): x-coordinates (EPI_MOTION)
  __nv_bfloat16* out;         // z/r: z; q: h'; EPI_RELU, EPI_MOTION: (M, N)
  __nv_bfloat16* out2;        // z/r: r*h
  const __nv_bfloat16* w2;    // (9, FH_N): conv2's x row, tap-major (EPI_FLOWHEAD)
  float* z9;                  // (N / BN, 9, M): partial tap columns, one set a tile column (EPI_FLOWHEAD)
};

// input channels the K loop walks in segment s: a group's, or all of them
__host__ __device__ __forceinline__ int k_channels(const Args& a, int s) {
  return a.groups > 1 ? a.seg_c[0] / a.groups : a.seg_c[s];
}

// 8 channels n..n+7 of pixel m from their f32 sums: ReLU; ReLU and K8's
// last two lanes (flow-x, 0); the gates (z/r launch); or q and the blend (q
// launch); the arithmetic of conv_igemm.cuh's epilogue
template <int EPI>
__device__ __forceinline__ void piece(const Args& a, size_t m, int n, float (&v)[8]) {
  using sa::conv::sigmoidf;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] += __ldg(a.bias + n + j);
  if constexpr (EPI == sa::conv::EPI_RELU || EPI == sa::conv::EPI_MOTION) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j], 0.f);
    if (EPI == sa::conv::EPI_MOTION && n + 8 == a.N) {  // lanes N - 2, N - 1: flow-x (no ReLU), 0
      v[6] = __ldg(a.coords + m) - static_cast<float>(static_cast<int>(m % a.W));
      v[7] = 0.f;
    }
    store8(a.out + m * a.N + n, v);  // flow-x rounded to bf16 once, here
  } else if constexpr (EPI == sa::conv::EPI_GRU_ZR) {
    float u[8], hv[8];
    if (n < a.hd) {
      load8(a.inj0 + m * a.inj_ld + n, u);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = sigmoidf(v[j] + u[j]);
      store8(a.out + m * a.hd + n, v);
    } else {
      const int c = n - a.hd;
      load8(a.inj1 + m * a.inj_ld + c, u);
      load8(a.h + m * a.hd + c, hv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = sigmoidf(v[j] + u[j]) * hv[j];
      store8(a.out2 + m * a.hd + c, v);
    }
  } else {
    float u[8], hv[8], zv[8];
    load8(a.inj0 + m * a.inj_ld + n, u);
    load8(a.z + m * a.hd + n, zv);
    load8(a.h + m * a.hd + n, hv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float q = tanhf(v[j] + u[j]);
      v[j] = (1.f - zv[j]) * hv[j] + zv[j] * q;
    }
    store8(a.out + m * a.hd + n, v);
  }
}

template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS, 1)
    conv_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using namespace sm90;
  using T = Tile<BM, BN>;
  constexpr int STAGES = T::STAGES, WGS = T::WGS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ring = smem_u32(smem);  // stage s: A at s * STAGE_BYTES, W after it
  float* out_tile = reinterpret_cast<float*>(smem + STAGES * T::STAGE_BYTES);
  const uint32_t full0 = ring + STAGES * T::STAGE_BYTES + T::OUT_BYTES, empty0 = full0 + 8 * STAGES;
  const int tiles_x = (a.W + a.bw - 1) / a.bw, per_image = tiles_x * ((a.H + a.bh - 1) / a.bh);
  const int m_tiles = a.B * per_image, tiles = m_tiles * ((a.N + BN - 1) / BN);
  // Segment loops run over MAX_SEGS unrolled, so that every index into a
  // and maps is a constant: a runtime index copies the parameters to local
  // memory, read again at every stage behind the barrier waits' clobbers.
  int chunks = 0;  // 64-channel chunks a tap
#pragma unroll
  for (int s = 0; s < MAX_SEGS; ++s)
    if (s < a.nseg) chunks += (k_channels(a, s) + BK - 1) / BK;
  const int nk = TAPS * chunks;
  const int wg = threadIdx.x / 128;
  // tile -> image b, patch origin (x0, y0), first output channel n0 (pixel tiles fastest)
  auto origin = [&](int tile, int& b, int& x0, int& y0, int& n0) {
    const int mt = tile % m_tiles;
    n0 = (tile / m_tiles) * BN;
    b = mt / per_image;
    y0 = ((mt % per_image) / tiles_x) * a.bh;
    x0 = (mt % tiles_x) * a.bw;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * WGS);  // lane 0 of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();
  // launched as a dependent of the kernel before it: wait for its writes
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // K7: conv2's x row as f32, behind the mbarriers
  float* w2s = reinterpret_cast<float*>(smem + T::SMEM - 1024);
  if constexpr (EPI == sa::conv::EPI_FLOWHEAD) {
    for (int i = threadIdx.x; i < TAPS * FH_N; i += T::THREADS) w2s[i] = __bfloat162float(a.w2[i]);
    __syncthreads();
  }

  if (wg == WGS) {  // producer
    if constexpr (WGS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == WGS * 128) {
      int it = 0;  // stages filled so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, x0, y0, n0;
        origin(tile, b, x0, y0, n0);
        // grouped: the first input channel of the group the tile's outputs lie in
        const int cg = a.groups > 1 ? n0 / (a.N / a.groups) * k_channels(a, 0) : 0;
        for (int tap = 0; tap < TAPS; ++tap) {
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
          for (int s = 0; s < MAX_SEGS; ++s) {
            if (s >= a.nseg) break;
            const int kc = k_channels(a, s), off = a.seg_off[s];
            for (int c0 = 0; c0 < kc; c0 += BK, ++it) {
              const int st = it % STAGES;
              mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);  // the first round passes at once
              const uint32_t dst = ring + st * T::STAGE_BYTES, full = full0 + 8 * st;
              mbar_expect_tx(full, T::STAGE_BYTES);
              tma_load_4d(dst, &maps.a[s], full, cg + c0, x0 + dx, y0 + dy, b);
              tma_load_3d(dst + T::A_BYTES, &maps.w, full, off + c0, tap, n0);
            }
          }
        }
      }
    }
  } else {  // consumers
    if constexpr (WGS == 2) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];  // 64 x BN a warpgroup: acc[4 jb + 2 i + c] is row 16 warp + lane / 4 + 8 i,
                        // column 8 jb + 2 (lane % 4) + c
    float* chunk = out_tile + wg * 64 * PITCH;
    int it = 0;  // stages consumed so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int b, x0, y0, n0;
      origin(tile, b, x0, y0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const uint32_t st = ring + s * T::STAGE_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<BN>(acc, smem_desc(st + wg * 64 * 128 + 32 * kk, 16, 1024),
                       smem_desc(st + T::A_BYTES + 32 * kk, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: free it
        fence_regs(acc);
        if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));  // the tile's last stage

      // epilogue, 64 columns at a time through this warpgroup's f32 chunk
      const int g = lane / 4, t = lane % 4;
      // K7: thread tid takes channels 8 (tid % 8) .. + 7 of a chunk in rows
      // tid / 8 + 16 k, and sums their share of each row's 9 tap columns
      float zp[4][TAPS];
      if constexpr (EPI == sa::conv::EPI_FLOWHEAD) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int tap = 0; tap < TAPS; ++tap) zp[k][tap] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) {
        named_bar_sync(1 + wg, 128);  // the chunk before is read
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(chunk + (warp * 16 + g + 8 * i) * PITCH + 8 * jb + 2 * t) =
                make_float2(acc[4 * (8 * j + jb) + 2 * i], acc[4 * (8 * j + jb) + 2 * i + 1]);
        named_bar_sync(1 + wg, 128);
        // 8 threads a row, one 8-channel piece each; pieces 4..7 read their
        // upper half first: the 8 threads then hit 32 distinct banks
        auto read_piece = [&](int r, int p, float (&v)[8]) {
          const float* src = chunk + r * PITCH + 8 * p;
          const int h0 = (p >> 2) * 4;
          const float4 first = *reinterpret_cast<const float4*>(src + h0);
          const float4 second = *reinterpret_cast<const float4*>(src + 4 - h0);
          const float4 lo = h0 ? second : first, hi = h0 ? first : second;
          v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
        };
        if constexpr (EPI == sa::conv::EPI_FLOWHEAD) {
          // fh1 = relu(acc + b1), rounded to bf16; every row, inside the image or not (only stores are masked)
          const int p = tid % 8, n = n0 + 64 * j + 8 * p;
          float fh[4][8], bias[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) bias[e] = __ldg(a.bias + n + e);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            read_piece(tid / 8 + 16 * k, p, fh[k]);
#pragma unroll
            for (int e = 0; e < 8; ++e) fh[k][e] = __bfloat162float(__float2bfloat16(fmaxf(fh[k][e] + bias[e], 0.f)));
          }
#pragma unroll
          for (int tap = 0; tap < TAPS; ++tap) {
            const float4 w0 = *reinterpret_cast<const float4*>(w2s + tap * FH_N + n);
            const float4 w1 = *reinterpret_cast<const float4*>(w2s + tap * FH_N + n + 4);
            const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int e = 0; e < 8; ++e) zp[k][tap] = fmaf(fh[k][e], w[e], zp[k][tap]);
          }
        } else {
          for (int c = tid; c < 64 * 8; c += 128) {
            const int r = c / 8, p = c % 8, px = wg * 64 + r;
            const int y = y0 + px / a.bw, x = x0 + px % a.bw, n = n0 + 64 * j + 8 * p;
            if (y >= a.H || x >= a.W || n >= a.N) continue;
            float v[8];
            read_piece(r, p, v);
            piece<EPI>(a, (static_cast<size_t>(b) * a.H + y) * a.W + x, n, v);
          }
        }
      }
      if constexpr (EPI == sa::conv::EPI_FLOWHEAD) {
        // the 8 threads of a row (lanes 8 q .. 8 q + 7) sum their shares; lane
        // 8 q + p stores tap p (and p = 0 tap 8) of the tile column's set
        const int p = tid % 8;
        const size_t M = static_cast<size_t>(a.B) * a.H * a.W;
        float* z9 = a.z9 + static_cast<size_t>(n0 / BN) * TAPS * M;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) zp[k][tap] += __shfl_xor_sync(0xffffffffu, zp[k][tap], o);
          const int px = wg * 64 + tid / 8 + 16 * k, y = y0 + px / a.bw, x = x0 + px % a.bw;
          if (y >= a.H || x >= a.W) continue;
          const size_t m = (static_cast<size_t>(b) * a.H + y) * a.W + x;
#pragma unroll
          for (int tap = 0; tap < TAPS; ++tap)
            if (tap % 8 == p) z9[tap * M + m] = zp[k][tap];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: tile choice, maps, launches

struct Plan {
  int bm, bn, bw, bh, tiles, blocks, stages, threads, smem;
};

// a BW x BH patch of bm pixels: the power of two BW (bm down to 8) that
// covers the plane with the fewest patches, the wider on a tie
inline void pick_patch(int bm, int H, int W, int& bw, int& bh, int& patches) {
  patches = 0;
  for (int w = bm; w >= 8; w /= 2) {
    const int h = bm / w, n = ((W + w - 1) / w) * ((H + h - 1) / h);
    if (patches == 0 || n < patches) bw = w, bh = h, patches = n;
  }
}

template <int BM, int BN>
Plan plan_of(int B, int H, int W, int N) {
  using T = Tile<BM, BN>;
  Plan p{};
  int patches = 0;
  pick_patch(BM, H, W, p.bw, p.bh, patches);
  p.bm = BM;
  p.bn = BN;
  p.tiles = B * patches * ((N + BN - 1) / BN);
  p.blocks = std::min(p.tiles, sm90::sm_count());
  p.stages = T::STAGES;
  p.threads = T::THREADS;
  p.smem = static_cast<int>(T::SMEM);
  return p;
}

constexpr int CANDIDATES = 5;
// what a tile costs beyond its products (filling the ring, the epilogue), in
// output elements: on the H100 a round of tiles took about 12 + 0.0015 BM BN
// us at the 512^2 request's gru08 plane (128x256 61.6, 128x128 36, 64x128
// 26.5, 64x64 18.4 us), so a 64 x 64 tile runs at 42% of a 128 x 256 one's rate
constexpr long long TILE_OVERHEAD = 8192;

// the tile with the fewest rounds of tiles over the SMs times (BM BN +
// TILE_OVERHEAD), the first in this list on a tie, among the tiles whose
// BN divides a group's N / groups output channels (grouped launches); tile
// 1..CANDIDATES forces that candidate instead (the forced-tile entry points
// of step_fused.cu, diagnostics)
inline Plan pick_plan(int B, int H, int W, int N, int tile = 0, int groups = 1) {
  const Plan cands[CANDIDATES] = {plan_of<128, 256>(B, H, W, N), plan_of<128, 128>(B, H, W, N),
                                  plan_of<64, 128>(B, H, W, N), plan_of<64, 64>(B, H, W, N),
                                  plan_of<128, 64>(B, H, W, N)};
  if (tile >= 1 && tile <= CANDIDATES) return cands[tile - 1];
  const long long sms = sm90::sm_count();
  Plan best = cands[3];  // 64 x 64: any group width a multiple of 64 takes it
  long long best_cost = -1;
  for (const Plan& p : cands) {
    if (groups > 1 && (N / groups) % p.bn) continue;
    const long long cost = (p.tiles + sms - 1) / sms * (static_cast<long long>(p.bm) * p.bn + TILE_OVERHEAD);
    if (best_cost < 0 || cost < best_cost) best = p, best_cost = cost;
  }
  return best;
}

inline cudaError_t make_maps(Maps& m, const Args& a, const void* const* seg, const void* w, int bn) {
  int cin = 0;  // W's input channels
  for (int s = 0; s < a.nseg; ++s) {
    const cuuint64_t c = a.seg_c[s];
    const cuuint64_t dims[4] = {c, static_cast<cuuint64_t>(a.W), static_cast<cuuint64_t>(a.H),
                                static_cast<cuuint64_t>(a.B)};
    const cuuint64_t strides[3] = {c * 2, c * 2 * a.W, c * 2 * a.W * a.H};
    const cuuint32_t box[4] = {BK, static_cast<cuuint32_t>(a.bw), static_cast<cuuint32_t>(a.bh), 1};
    const cudaError_t e = sm90::make_map_bf16(&m.a[s], seg[s], 4, dims, strides, box);
    if (e != cudaSuccess) return e;
    cin += k_channels(a, s);
  }
  const cuuint64_t dims_w[3] = {static_cast<cuuint64_t>(cin), TAPS, static_cast<cuuint64_t>(a.N)};
  const cuuint64_t strides_w[2] = {static_cast<cuuint64_t>(cin) * 2, static_cast<cuuint64_t>(cin) * 2 * TAPS};
  const cuuint32_t box_w[3] = {BK, 1, static_cast<cuuint32_t>(bn)};
  return sm90::make_map_bf16(&m.w, w, 3, dims_w, strides_w, box_w);
}

template <int BM, int BN, int EPI>
cudaError_t launch_tiles(const Maps& maps, const Args& a, int blocks, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  // K7's epilogue keeps conv2's x row behind the mbarriers
  constexpr size_t smem = T::SMEM + (EPI == sa::conv::EPI_FLOWHEAD ? FH_W2_BYTES : 0);
  static_assert(smem <= SMEM_LIMIT, "the tile and its epilogue's data do not fit");
  auto kernel = conv_wgmma_kernel<BM, BN, EPI>;
  cudaError_t e = smem_limit_once(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  // programmatic dependent launch: the grid is set up while the kernel before it finishes
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// one convolution launch over the segments seg[0 .. a.nseg) with W packed
// (N, 9, Cin).  Each epilogue is built with the tiles its launches may take:
// K9's and K7's with all, K8's grouped ReLU with BN 64, its merge conv (N
// 128) with BN <= 128; another forced tile is refused.
template <int EPI>
cudaError_t launch_conv(const void* const* seg, const void* w, Args a, int tile, cudaStream_t stream) {
  if (a.groups < 1 || (a.groups > 1 && (a.nseg != 1 || a.seg_c[0] % a.groups || a.N % a.groups)))
    return cudaErrorInvalidValue;
  const Plan p = pick_plan(a.B, a.H, a.W, a.N, tile, a.groups);
  if (a.groups > 1 && (a.N / a.groups) % p.bn) return cudaErrorInvalidValue;  // a tile in two groups
  a.bw = p.bw;
  a.bh = p.bh;
  for (int s = 0, off = 0; s < a.nseg; off += k_channels(a, s), ++s) a.seg_off[s] = off;
  Maps maps{};
  const cudaError_t e = make_maps(maps, a, seg, w, p.bn);
  if (e != cudaSuccess) return e;
  if (p.bn == 64) return p.bm == 128 ? launch_tiles<128, 64, EPI>(maps, a, p.blocks, stream)
                                     : launch_tiles<64, 64, EPI>(maps, a, p.blocks, stream);
  if constexpr (EPI != sa::conv::EPI_RELU) {
    if (p.bn == 128) return p.bm == 128 ? launch_tiles<128, 128, EPI>(maps, a, p.blocks, stream)
                                        : launch_tiles<64, 128, EPI>(maps, a, p.blocks, stream);
    if constexpr (EPI != sa::conv::EPI_MOTION) return launch_tiles<128, 256, EPI>(maps, a, p.blocks, stream);
  }
  return cudaErrorInvalidValue;
}

// K9's bf16 body: z = sigmoid(conv_z([h, x1, x2]) + cz), r*h = sigmoid(conv_r(..) + cr) h
// (one launch, N = 2 hd), then h' = (1 - z) h + z tanh(conv_q([r*h, x1, x2]) + cq)
// (N = hd).  x2 null with c2 = 0; tile 0 picks each launch's tile (pick_plan).
inline cudaError_t launch_gru(const void* h, const void* x1, const void* x2, const void* cz, const void* cr,
                              const void* cq, const void* w_zr, const void* b_zr, const void* w_q, const void* b_q,
                              void* z, void* rh, void* out, int B, int H, int W, int hd, int c1, int c2, int inj_ld,
                              int tile, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || static_cast<long long>(B) * H * W > (1LL << 30) || hd <= 0 || c1 <= 0 ||
      c2 < 0 || hd % 8 || c1 % 8 || c2 % 8 || inj_ld % 8)
    return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  Args a{};
  a.B = B;
  a.H = H;
  a.W = W;
  a.groups = 1;
  a.hd = hd;
  a.inj_ld = inj_ld;
  a.nseg = c2 > 0 ? 3 : 2;
  a.seg_c[0] = hd;
  a.seg_c[1] = c1;
  a.seg_c[2] = c2;
  const void* seg[MAX_SEGS] = {h, x1, x2};
  a.N = 2 * hd;
  a.bias = static_cast<const float*>(b_zr);
  a.h = static_cast<const T*>(h);
  a.inj0 = static_cast<const T*>(cz);
  a.inj1 = static_cast<const T*>(cr);
  a.out = static_cast<T*>(z);
  a.out2 = static_cast<T*>(rh);
  const cudaError_t e = launch_conv<sa::conv::EPI_GRU_ZR>(seg, w_zr, a, tile, stream);
  if (e != cudaSuccess) return e;
  seg[0] = rh;
  a.N = hd;
  a.bias = static_cast<const float*>(b_q);
  a.z = static_cast<const T*>(z);
  a.inj0 = static_cast<const T*>(cq);
  a.inj1 = nullptr;
  a.out = static_cast<T*>(out);
  a.out2 = nullptr;
  return launch_conv<sa::conv::EPI_GRU_Q>(seg, w_q, a, tile, stream);
}

// K8's 3x3 stages (bf16) on a1 = [c1(corr_a) | c1(corr_b) | f1(flow-x)], (M, c)
// with c = 3 x 64: a2 = relu(conv(a1) + b_c2f2), one 3-group conv with w_c2f2
// (c, 9, c / 3) = [convc2; convc2; convf2]; then out = [relu(mc(a2) +
// b_mc)[..., :n - 2] | flow-x | 0], (M, n), with w_mc (n, 9, c).  tile2, tile3:
// 0 picks each launch's tile (pick_plan), 1..CANDIDATES forces one.
inline cudaError_t launch_motion(const void* a1, const void* w_c2f2, const void* b_c2f2, const void* w_mc,
                                 const void* b_mc, const float* coords, void* a2, void* out, int B, int H, int W,
                                 int c, int n, int tile2, int tile3, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || static_cast<long long>(B) * H * W > (1LL << 30) || c % 24 || n % 8 || n < 8)
    return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  Args a{};
  a.B = B;
  a.H = H;
  a.W = W;
  a.nseg = 1;
  a.seg_c[0] = c;
  a.groups = 3;
  a.N = c;
  a.bias = static_cast<const float*>(b_c2f2);
  a.out = static_cast<T*>(a2);
  const void* seg[MAX_SEGS] = {a1};
  const cudaError_t e = launch_conv<sa::conv::EPI_RELU>(seg, w_c2f2, a, tile2, stream);
  if (e != cudaSuccess) return e;
  seg[0] = a2;
  a.groups = 1;
  a.N = n;
  a.bias = static_cast<const float*>(b_mc);
  a.coords = coords;
  a.out = static_cast<T*>(out);
  return launch_conv<sa::conv::EPI_MOTION>(seg, w_mc, a, tile3, stream);
}

// K7's bf16 conv1 and tap columns, one launch: z9[s, tap, m] = the sum over
// the FH_N / sets output channels n of tile column s of bf16(relu(conv1(h)[m,
// n] + b1[n])) w2[tap, n], with h (M, c), w1 (FH_N, 9, c), w2 (9, FH_N) bf16.
// *sets is FH_N / BN of the tile taken: the caller's tap sum adds the sets.
// tile 0 picks it (pick_plan), 1..CANDIDATES forces one.
inline cudaError_t launch_flowhead(const void* h, const void* w1, const void* b1, const void* w2, float* z9, int B,
                                   int H, int W, int c, int tile, int* sets, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || static_cast<long long>(B) * H * W > (1LL << 30) || c <= 0 || c % 8)
    return cudaErrorInvalidValue;
  Args a{};
  a.B = B;
  a.H = H;
  a.W = W;
  a.groups = 1;
  a.nseg = 1;
  a.seg_c[0] = c;
  a.N = FH_N;
  a.bias = static_cast<const float*>(b1);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.z9 = z9;
  const void* seg[MAX_SEGS] = {h};
  *sets = FH_N / pick_plan(B, H, W, FH_N, tile).bn;
  return launch_conv<sa::conv::EPI_FLOWHEAD>(seg, w1, a, tile, stream);
}

}  // namespace sa::cw
