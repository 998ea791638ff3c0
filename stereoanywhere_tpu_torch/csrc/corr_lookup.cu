// K5: the dual correlation-pyramid lookup.  Replaces every Pallas variant
// of the same function in stereoanywhere_tpu/ops/pallas/ (corr_kernel.py
// dual_lookup_pallas, corr_tent.py dual_lookup_tent, corr_gather.py
// dual_lookup_windowed, corr_lagged.py dual_lookup_lagged, corr_mxu.py
// dual_lookup_mxu, corr_barrel.py lookup_packed_pair / dual_lookup_barrel,
// step_fused.py _lookup_level_call).  Design and bound:
// ops/cuda/corr_lookup.py.
//
// One thread per (pixel, pyramid, level): it reads the 2r+2 entries of the
// level row around coords / 2^level (both taps of each of the 2r+1 linear
// interpolations; entries outside [0, Wl-1] count as zero), sums in f32 and
// writes 2r+1 values.  The TPU kernels' tent products over the whole Wl
// row, their lane packing and barrel rotates have no counterpart here.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;

struct Levels {
  const void* a[MAX_LEVELS];
  const void* b[MAX_LEVELS];
  int wl[MAX_LEVELS];
};

template <typename T>
__global__ void __launch_bounds__(256) dual_lookup_kernel(const Levels lv, int nl, const float* __restrict__ coords,
                                                          T* __restrict__ out, int M, int radius) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(M) * 2 * nl) return;
  const int l = static_cast<int>(idx % nl);
  const int s = static_cast<int>((idx / nl) % 2);
  const int m = static_cast<int>(idx / (2 * nl));
  const int wl = lv.wl[l], k = 2 * radius + 1;
  const T* row = static_cast<const T*>(s ? lv.b[l] : lv.a[l]) + static_cast<size_t>(m) * wl;
  const float c = coords[m] / static_cast<float>(1 << l);
  T* o = out + (static_cast<size_t>(s) * M + m) * nl * k + l * k;
  for (int t = -radius; t <= radius; ++t) {
    const float pos = c + static_cast<float>(t);
    const float x0 = floorf(pos);
    const float f = pos - x0;
    float v = 0.f;
    if (x0 >= -1.f && x0 <= static_cast<float>(wl - 1)) {  // at least one of the two entries is inside
      const int i0 = static_cast<int>(x0);
      if (i0 >= 0) v += to_f(row[i0]) * (1.f - f);
      if (i0 + 1 <= wl - 1) v += to_f(row[i0 + 1]) * f;
    }
    o[t + radius] = from_f<T>(v);
  }
}

}  // namespace

// levels_a / levels_b: host arrays of nl device pointers, each (M, wl[l])
// in the dtype; coords (M) f32; out (2, M, nl * (2r+1)).
extern "C" int sa_dual_lookup(const void* const* levels_a, const void* const* levels_b, const int* wl,
                              const void* coords, void* out, int nl, int M, int radius, int dtype, void* stream) {
  if (nl < 1 || nl > MAX_LEVELS || M <= 0 || radius < 0) return cudaErrorInvalidValue;
  Levels lv{};
  for (int l = 0; l < nl; ++l) {
    if (wl[l] <= 0) return cudaErrorInvalidValue;
    lv.a[l] = levels_a[l];
    lv.b[l] = levels_b[l];
    lv.wl[l] = wl[l];
  }
  const long long n = static_cast<long long>(M) * 2 * nl;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* cf = static_cast<const float*>(coords);
  if (dtype == SA_F32)
    dual_lookup_kernel<float><<<blocks, 256, 0, s>>>(lv, nl, cf, static_cast<float*>(out), M, radius);
  else if (dtype == SA_BF16)
    dual_lookup_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(lv, nl, cf, static_cast<__nv_bfloat16*>(out), M,
                                                             radius);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
