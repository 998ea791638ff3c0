// K5: the dual correlation-pyramid lookup.  Replaces every Pallas variant
// of the same function in stereoanywhere_tpu/ops/pallas/ (corr_kernel.py
// dual_lookup_pallas, corr_tent.py dual_lookup_tent, corr_gather.py
// dual_lookup_windowed, corr_lagged.py dual_lookup_lagged, corr_mxu.py
// dual_lookup_mxu, corr_barrel.py lookup_packed_pair / dual_lookup_barrel,
// step_fused.py _lookup_level_call) and the JAX package's XLA lookups.
// Bound: ops/cuda/corr_lookup.py.
//
// It moves bytes and does almost no arithmetic, so the design is about how
// the window reads and the output writes reach memory:
// - A block takes PIX consecutive pixels and every (pyramid, level) of
//   them: warp w reads level w % nl of pyramid w / nl, lane i the row of
//   pixel m0 + i.  A warp's 32 rows are neighbours in memory.
// - A lane reads the window of its row, the 2R+2 entries [b, b + 2R + 1]
//   around b = floor(c / 2^l) - R, as 16-byte chunks aligned in the level
//   (3 in bf16, 4 in f32 at R = 4; only the chunks that overlap the row's
//   [0, Wl - 1]).  The alignment comes from the row's address, so rows
//   whose stride is no multiple of 16 bytes (Wl = 5, 10, 20 in bf16) take
//   the same path; a chunk that would run past the level's end is read
//   entry by entry.  A barrel shift in registers lines the window up,
//   entries outside [0, Wl - 1] (and the neighbouring rows' entries a
//   chunk holds) become zero, and the 2R+1 taps are formed from registers.
// - The rounding is the plain gather's (ops/corr_lookup.py _lookup_level)
//   and the JAX package's gather: per tap pos = c / 2^l + t and
//   f = pos - floor(pos) in f32; in bf16 f and 1 - f are rounded to bf16,
//   each product is rounded to bf16 and their f32 sum is rounded once; in
//   f32 the same operations without contraction.  So for finite
//   coordinates K5 gives the plain version's values bit for bit.
// - The block's 2 x PIX x nl(2R+1) outputs are gathered in shared memory
//   and leave as the two contiguous spans they are in each pyramid's
//   output, in 16-byte stores.
// - It is launched as a programmatic dependent (griddepcontrol.wait before
//   the first read of the coordinates), so its launch overlaps the tail
//   of the kernel before it.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_RADIUS = 8;
constexpr int PIX = 32;  // pixels a block, one a lane

struct Levels {
  const void* p[2][MAX_LEVELS];  // [pyramid][level], each (M, wl[level])
  int wl[MAX_LEVELS];
};

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// u[k] <- u[k + s] for a shift s in [0, 2^BITS), zeros shifted in: BITS
// steps of selects whose indices are all known at compile time, so u
// stays in registers whatever s is
template <int N, int BITS>
__device__ __forceinline__ void shift_down(uint32_t (&u)[N], int s) {
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const int d = 1 << b;
    const bool take = (s >> b) & 1;
#pragma unroll
    for (int k = 0; k < N; ++k) u[k] = take ? (k + d < N ? u[k + d] : 0u) : u[k];
  }
}

// The window w[j] = level[row + b + j], j in [0, 2R+2), of the row that
// starts at flat index `row` of a level of width wl: zero where b + j lies
// outside [0, wl - 1], which the window meets; w[2R+2] = 0.  total: the
// level's entry count.
template <typename T, int R>
__device__ __forceinline__ void load_window(const T* __restrict__ level, long long total, long long row, int b,
                                            int wl, float (&w)[2 * R + 3]) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // entries a 16-byte chunk
  constexpr int EW = 2 * R + 2;                         // entries of the window
  constexpr int NC = (V - 1 + EW + V - 1) / V;          // chunks that hold it, wherever it starts
  constexpr int EPW = 4 / static_cast<int>(sizeof(T));  // entries a 32-bit word
  const long long e = row + b;                          // flat index of w[0]
  const long long lo = row + max(b, 0), hi = row + min(b + EW - 1, wl - 1);
  uint32_t u[4 * NC];
  const long long cb = e >= 0 ? e / V : -((-e + V - 1) / V);  // chunk of w[0], rounded down
  const int o = static_cast<int>(e - cb * V);                 // w[0]'s entry in that chunk
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const long long c0 = (cb + k) * V;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + V - 1 >= lo && c0 <= hi) {  // then c0 >= 0: lo >= 0 and c0 is a multiple of V
      if (c0 + V <= total) {
        q = __ldg(reinterpret_cast<const uint4*>(level + c0));
      } else {  // the level's last chunk, cut: entry by entry
        union {
          uint4 v;
          T e[V];
        } part;
#pragma unroll
        for (int j = 0; j < V; ++j) part.e[j] = c0 + j < total ? level[c0 + j] : from_f<T>(0.f);
        q = part.v;
      }
    }
    u[4 * k] = q.x;
    u[4 * k + 1] = q.y;
    u[4 * k + 2] = q.z;
    u[4 * k + 3] = q.w;
  }
  shift_down<4 * NC, 2>(u, o / EPW);  // a chunk is 4 words
  if (EPW == 2 && (o & 1)) {          // bf16 starting at a word's upper half
#pragma unroll
    for (int k = 0; k + 1 < 4 * NC; ++k) u[k] = __funnelshift_r(u[k], u[k + 1], 16);
  }
  const int jlo = max(-b, 0), jhi = wl - 1 - b;  // the entries inside the row
#pragma unroll
  for (int j = 0; j < EW; ++j) {
    const float v = EPW == 2 ? __uint_as_float(((u[j / 2] >> (16 * (j % 2))) & 0xffffu) << 16) : __uint_as_float(u[j]);
    w[j] = j >= jlo && j <= jhi ? v : 0.f;
  }
  w[EW] = 0.f;
}

// one tap: v0 (1 - f) + v1 f, rounded where the plain gather rounds
template <typename T> __device__ __forceinline__ float lerp_tap(float v0, float v1, float f);
template <> __device__ __forceinline__ float lerp_tap<float>(float v0, float v1, float f) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.f, f)), __fmul_rn(v1, f));
}
template <> __device__ __forceinline__ float lerp_tap<__nv_bfloat16>(float v0, float v1, float f) {
  const float wf = bf16_round(f), w0 = bf16_round(__fsub_rn(1.f, wf));
  return __fadd_rn(bf16_round(__fmul_rn(v0, w0)), bf16_round(__fmul_rn(v1, wf)));
}

// blockDim 64 nl: a warp a (pyramid, level); out (2, M, nl (2R+1))
template <typename T, int R>
__global__ void __launch_bounds__(64 * MAX_LEVELS) dual_lookup_kernel(const Levels lv, int nl,
                                                                      const float* __restrict__ coords,
                                                                      T* __restrict__ out, int M) {
  constexpr int K = 2 * R + 1;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [2][PIX][nl K]
  const int row_len = nl * K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = warp / nl, l = warp - p * nl;
  const int m0 = blockIdx.x * PIX;
  const int npix = min(PIX, M - m0);
  const int m = m0 + lane;

  // the coordinates (and the levels) are the work of earlier kernels
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // the warp's level, by a select over the table: a runtime index into the
  // kernel's arguments would make a local copy of them
  const void* level = nullptr;
  int wl = 1;
#pragma unroll
  for (int i = 0; i < MAX_LEVELS; ++i) {
    if (i == l) {
      level = p ? lv.p[1][i] : lv.p[0][i];
      wl = lv.wl[i];
    }
  }

  if (lane < npix) {
    const float cl = __fdiv_rn(__ldg(coords + m), static_cast<float>(1 << l));
    const float fb = floorf(cl) - static_cast<float>(R);  // window's first entry, exact while in range
    float w[2 * R + 3];
    // a window that meets [0, Wl - 1] (false for a NaN coordinate)
    if (fb > static_cast<float>(-(2 * R + 2)) && fb < static_cast<float>(wl)) {
      load_window<T, R>(static_cast<const T*>(level), static_cast<long long>(M) * wl,
                        static_cast<long long>(m) * wl, static_cast<int>(fb), wl, w);
    } else {
#pragma unroll
      for (int j = 0; j < 2 * R + 3; ++j) w[j] = 0.f;
    }
    T* dst = tile + (p * PIX + lane) * row_len + l * K;
#pragma unroll
    for (int t = -R; t <= R; ++t) {
      const int j = t + R;
      const float pos = __fadd_rn(cl, static_cast<float>(t));
      const float x0 = floorf(pos);
      // c + t rounded up to the next integer: then f = 0 and the tap is
      // that entry alone
      const bool up = x0 != fb + static_cast<float>(j);
      const float v0 = up ? w[j + 1] : w[j];
      const float v1 = up ? w[j + 2] : w[j + 1];
      dst[j] = from_f<T>(lerp_tap<T>(v0, v1, __fsub_rn(pos, x0)));
    }
  }
  __syncthreads();

  // the block's share of each pyramid's output is one contiguous span
  const int span = npix * row_len;
  const int nvec = span / V;
  for (int q = 0; q < 2; ++q) {
    const T* src = tile + q * PIX * row_len;
    T* o = out + (static_cast<size_t>(q) * M + m0) * row_len;
    if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      for (int i = threadIdx.x; i < nvec; i += blockDim.x)
        reinterpret_cast<uint4*>(o)[i] = reinterpret_cast<const uint4*>(src)[i];
      for (int i = nvec * V + threadIdx.x; i < span; i += blockDim.x) o[i] = src[i];
    } else {  // bf16 with an odd pixel count: the second span starts mid-chunk
      for (int i = threadIdx.x; i < span; i += blockDim.x) o[i] = src[i];
    }
  }
}

template <typename T, int R>
cudaError_t launch(const Levels& lv, int nl, const float* coords, T* out, int M, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((M + PIX - 1) / PIX));
  cfg.blockDim = dim3(64 * nl);
  cfg.dynamicSmemBytes = 2 * PIX * nl * (2 * R + 1) * sizeof(T);  // at most 34,816 bytes
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, dual_lookup_kernel<T, R>, lv, nl, coords, out, M);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_radius(const Levels& lv, int nl, const float* coords, T* out, int M, int radius,
                          cudaStream_t s) {
  switch (radius) {
    case 0: return launch<T, 0>(lv, nl, coords, out, M, s);
    case 1: return launch<T, 1>(lv, nl, coords, out, M, s);
    case 2: return launch<T, 2>(lv, nl, coords, out, M, s);
    case 3: return launch<T, 3>(lv, nl, coords, out, M, s);
    case 4: return launch<T, 4>(lv, nl, coords, out, M, s);
    case 5: return launch<T, 5>(lv, nl, coords, out, M, s);
    case 6: return launch<T, 6>(lv, nl, coords, out, M, s);
    case 7: return launch<T, 7>(lv, nl, coords, out, M, s);
    case 8: return launch<T, 8>(lv, nl, coords, out, M, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// levels_a / levels_b: host arrays of nl device pointers, each (M, wl[l])
// in the dtype and 16-byte aligned; coords (M) f32; out (2, M, nl (2r+1)).
extern "C" int sa_dual_lookup(const void* const* levels_a, const void* const* levels_b, const int* wl,
                              const void* coords, void* out, int nl, int M, int radius, int dtype, void* stream) {
  if (nl < 1 || nl > MAX_LEVELS || M <= 0 || radius < 0 || radius > MAX_RADIUS) return cudaErrorInvalidValue;
  Levels lv{};
  for (int l = 0; l < nl; ++l) {
    if (wl[l] <= 0) return cudaErrorInvalidValue;
    lv.p[0][l] = levels_a[l];
    lv.p[1][l] = levels_b[l];
    lv.wl[l] = wl[l];
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* cf = static_cast<const float*>(coords);
  if (dtype == SA_F32) return launch_radius(lv, nl, cf, static_cast<float*>(out), M, radius, s);
  if (dtype == SA_BF16) return launch_radius(lv, nl, cf, static_cast<__nv_bfloat16*>(out), M, radius, s);
  return cudaErrorInvalidValue;
}
