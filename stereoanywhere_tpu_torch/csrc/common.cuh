// Shared helpers of the port's CUDA kernels: dtype conversion, 16-byte
// loads and stores of 8 values, warp sums, the sm_80+ tensor-core
// primitives (mma.sync, ldmatrix) as inline PTX, the error-string export
// every library carries, and the host's one-time shared-memory limit of a
// kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <utility>
#include <vector>

// dtype codes passed from Python (ops/cuda/build.py DTYPE_CODES)
enum SaDtype { SA_F32 = 0, SA_BF16 = 1 };

extern "C" const char* sa_error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// out[0..2]: the CUDA runtime the library was built with, the runtime it
// runs with, and the driver's CUDA version (1000 * major + 10 * minor)
extern "C" int sa_cuda_versions(int* out) {
  out[0] = CUDART_VERSION;
  cudaError_t e = cudaRuntimeGetVersion(&out[1]);
  return e != cudaSuccess ? e : cudaDriverGetVersion(&out[2]);
}

// A captured CUDA graph's dependency edges by type: counts[0] all of them,
// counts[1] programmatic ones (what a launch with programmatic stream
// serialisation becomes under capture), counts[2] those leaving a kernel's
// launch-completion port.  Typed edges came with CUDA 12.3.
extern "C" int sa_graph_edge_types(void* graph, long long* counts) {
#if CUDART_VERSION >= 12030
  auto g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
  e = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n);
  if (e != cudaSuccess) return e;
  counts[0] = static_cast<long long>(n);
  counts[1] = counts[2] = 0;
  for (size_t i = 0; i < n; ++i) {
    counts[1] += data[i].type == cudaGraphDependencyTypeProgrammatic;
    counts[2] += data[i].from_port == cudaGraphKernelNodePortLaunchCompletion;
  }
  return cudaSuccess;
#else
  return cudaErrorNotSupported;
#endif
}

namespace {
// Raises a kernel's dynamic shared-memory limit to `bytes` on the current
// device once: the (kernel, device) pairs raised are kept, so later
// launches skip the runtime call.  In an unnamed namespace, so that each
// library keeps its own list: a static of an inline function is one object
// across all the libraries loaded, and a kernel of one library would pass
// for raised once the same template's kernel of another was.
inline cudaError_t smem_limit_once(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& r : raised)
    if (r.first == kernel && r.second == dev) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) raised.emplace_back(kernel, dev);
  return e;
}
}  // namespace

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// 8 consecutive values as f32 (16-byte aligned; bf16 one 16-byte load, f32 two)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// 8 values rounded to bf16, one 16-byte store (16-byte aligned)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --- tensor-core primitives (bf16 paths)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, lo in the low half (the lower column of a fragment)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
