// The bf16 matrix product on Hopper's TMA and wgmma, the body of K4
// vit_mlp's two products (K1, K3 and the conv tiles still use
// gemm_tile.cuh's mma.sync tile).
//
//   C[M, N] = epilogue( A[M, K] @ W[N, K]^T )
//
// A is row-major tokens and W is in torch nn.Linear layout (out, in), so
// both operands are K-major, as wgmma reads them from shared memory.  Sums
// are f32.  Epilogues (sa::Epilogue): + bias; + bias then gelu; the result
// is rounded to bf16 once.
//
// Bound: the products are far above the card's ridge, so the design keeps
// the tensor cores busy on every SM.  A block owns a 128 x BN output tile,
// one block an SM:
// - warpgroup 2 produces: one thread keeps a ring of stages 64 deep (A
//   128 x 64, W BN x 64) filled by TMA loads with 128-byte swizzle, each
//   stage guarded by a full and an empty mbarrier; rows past M or N and
//   columns past K arrive as zeros.  It gives its registers to the
//   consumers (setmaxnreg);
// - warpgroups 0 and 1 consume, 64 tile rows each: four wgmma.m64nBNk16 a
//   stage, one stage's products kept in flight (wait_group 1) before the
//   stage before is freed.  So the consumers hold two stages and the loads
//   run STAGES - 2 stages ahead; the ring has as many 64-deep stages as fit
//   beside the output tile (on the H100, 4 stages against 3 took the ViT-L
//   512^2 second product from 43 to 36 us; 32-deep stages, twice as many,
//   were slower, two wgmmas a group leaving the tensor cores short of work);
// - the epilogue works from the f32 accumulators, writes bf16 pairs into a
//   shared tile whose rows are padded so that the eight rows a warp writes
//   fall on distinct banks, then copies it out in 16-byte pieces along the
//   rows, the ragged edge masked (stored straight from the accumulators, a
//   warp instruction writes 16 bytes on each of 8 rows);
// - the grid is persistent: one block an SM walks the tiles, M fastest, so
//   the blocks in flight share W's tiles in L2, and the producer loads the
//   next tile while the consumers run the epilogue of this one;
// - it is launched as a programmatic dependent of the kernel before it
//   (the LN pass, or the first product): its blocks start and set up their
//   barriers while that kernel finishes, and wait for its writes before
//   the first load (on the H100, 3.5 us off K4's 0.095 ms at ViT-L 512^2).
// BN is 256, 208 or 176, picked per product to balance the SMs: the width
// with the fewest rounds of tiles times BN (the larger on a tie).  At the
// ViT-L 512^2 request the second product (N 1024, 22 row bands) has 132
// tiles of 176, one for each SM, where 256 gave 88 and left 44 SMs idle.
// The gelu's erf is the Abramowitz-Stegun 7.1.26 polynomial the TPU kernel
// uses (absolute error 1.5e-7, far below bf16's resolution): one
// reciprocal and one exponential.  Needs K % 8 == 0 and N % 8 == 0
// (16-byte rows) and 16-byte aligned operands.
#pragma once

#include <algorithm>

#include "gemm_tile.cuh"  // sa::Epilogue
#include "sm90.cuh"

namespace sa::wg {

constexpr int BM = 128, BK = 64;
constexpr int THREADS = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int WIDTHS[3] = {256, 208, 176};

template <int BN>
struct Tile {
  static constexpr int STAGES = BN == 256 ? 3 : 4;  // as many as fit beside the output tile
  static constexpr int A_BYTES = BM * BK * 2, STAGE_BYTES = A_BYTES + BN * BK * 2;
  // words a row of the bf16 output tile: 4 mod 8, so rows r and r + 1..7 start 4, 8, .. 28 banks apart
  static constexpr int PITCH = BN / 2 + 4 + ((BN / 2 + 4) % 8 == 0 ? 4 : 0);
  static constexpr int OUT_BYTES = BM * PITCH * 4;
  // alignment slack, ring, output tile, mbarriers
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ float gelu_as(float y) {
  const float z = y * 0.70710678118654752f, az = fabsf(z);
  const float t = __fdividef(1.f, fmaf(0.3275911f, az, 1.f));
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = copysignf(1.f - poly * __expf(-az * az), z);
  return 0.5f * y * (1.f + erf);
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1) wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                                                                const __grid_constant__ CUtensorMap map_w,
                                                                const __nv_bfloat16* __restrict__ bias,
                                                                __nv_bfloat16* __restrict__ C, int M, int K, int N) {
  using namespace sm90;
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ring = smem_u32(smem);  // stage s: A at s * STAGE_BYTES, W after it
  unsigned* out_tile = reinterpret_cast<unsigned*>(smem + STAGES * T::STAGE_BYTES);
  const uint32_t full0 = ring + STAGES * T::STAGE_BYTES + T::OUT_BYTES, empty0 = full0 + 8 * STAGES;
  const int m_tiles = (M + BM - 1) / BM, tiles = m_tiles * ((N + BN - 1) / BN);
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();
  // launched as a dependent of the kernel before it: wait for that kernel's writes (A)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;  // stages filled so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);  // the first round passes at once
          const uint32_t a = ring + s * T::STAGE_BYTES, full = full0 + 8 * s;
          mbar_expect_tx(full, T::STAGE_BYTES);
          tma_load_2d(a, &map_a, full, kt * BK, m0);
          tma_load_2d(a + T::A_BYTES, &map_w, full, kt * BK, n0);
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];  // 64 x BN a warpgroup: acc[4 jb + 2 i + c] is row 16 warp + lane / 4 + 8 i,
                        // column 8 jb + 2 (lane % 4) + c
    int it = 0;         // stages consumed so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const uint32_t a = ring + s * T::STAGE_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<BN>(acc, smem_desc(a + wg * 64 * 128 + 32 * kk, 16, 1024),
                       smem_desc(a + T::A_BYTES + 32 * kk, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: free it
        fence_regs(acc);
        if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));  // the tile's last stage

      // this warpgroup's 64 rows of the output tile; the previous tile's copy is done
      unsigned* rows = out_tile + wg * 64 * T::PITCH;
      named_bar_sync(1 + wg, 128);
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int n = n0 + 8 * jb + 2 * t;
        const float2 bb = n < N ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n))
                                : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float y0 = acc[4 * jb + 2 * i] + bb.x, y1 = acc[4 * jb + 2 * i + 1] + bb.y;
          if (EPI == EPI_BIAS_GELU) {
            y0 = gelu_as(y0);
            y1 = gelu_as(y1);
          }
          rows[(warp * 16 + g + 8 * i) * T::PITCH + 4 * jb + t] = pack_bf16(y0, y1);
        }
      }
      named_bar_sync(1 + wg, 128);
      constexpr int CHUNKS = BN / 8;  // 16-byte pieces of a row
      for (int c = tid; c < 64 * CHUNKS; c += 128) {
        const int r = c / CHUNKS, m = m0 + wg * 64 + r, n = n0 + (c % CHUNKS) * 8;
        if (m < M && n < N)
          *reinterpret_cast<uint4*>(C + static_cast<size_t>(m) * N + n) =
              *reinterpret_cast<const uint4*>(rows + r * T::PITCH + (c % CHUNKS) * 4);
      }
    }
  }
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

inline int tile_count(int M, int N, int bn) { return ((M + BM - 1) / BM) * ((N + bn - 1) / bn); }
inline int grid_size(int M, int N, int bn) { return std::min(tile_count(M, N, bn), sm_count()); }

// the width with the fewest rounds of tiles over the SMs times BN, the larger on a tie
inline int pick_bn(int M, int N) {
  int best = WIDTHS[0], best_cost = 0;
  for (int bn : WIDTHS) {
    const int cost = (tile_count(M, N, bn) + sm_count() - 1) / sm_count() * bn;
    if (bn == WIDTHS[0] || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

template <int BN, int EPI>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(wgmma_gemm_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Tile<BN>::SMEM));
}

template <int BN, int EPI>
cudaError_t launch_tiles(const void* A, const void* W, const void* bias, void* C, int M, int K, int N,
                         cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t dims_w[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box_a[2] = {BK, BM}, box_w[2] = {BK, BN};
  cudaError_t e = sm90::make_map_bf16(&map_a, A, 2, dims_a, stride, box_a);
  if (e == cudaSuccess) e = sm90::make_map_bf16(&map_w, W, 2, dims_w, stride, box_w);
  if (e == cudaSuccess) e = set_smem_limit<BN, EPI>();
  if (e != cudaSuccess) return e;
  // programmatic dependent launch: the grid is set up while the kernel before it finishes
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_size(M, N, BN));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<BN>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wgmma_gemm_kernel<BN, EPI>, map_a, map_w, static_cast<const __nv_bfloat16*>(bias),
                         static_cast<__nv_bfloat16*>(C), M, K, N);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int EPI>
cudaError_t launch_wgmma_gemm(const void* A, const void* W, const void* bias, void* C, int M, int K, int N,
                              cudaStream_t stream) {
  if (K % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
  switch (pick_bn(M, N)) {
    case 256: return launch_tiles<256, EPI>(A, W, bias, C, M, K, N, stream);
    case 208: return launch_tiles<208, EPI>(A, W, bias, C, M, K, N, stream);
    default: return launch_tiles<176, EPI>(A, W, bias, C, M, K, N, stream);
  }
}

}  // namespace sa::wg
