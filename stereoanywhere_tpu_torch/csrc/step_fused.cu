// K7 flow head + coordinate update, K8 motion encoder, K9 ConvGRU (and K6
// through K9): the quarter-resolution plane of one rotated refinement step.
// Replaces stereoanywhere_tpu/ops/pallas/step_fused.py (fused_step_head's
// flow-head call, fused_step_motion, fused_step_gru) and
// ops/pallas/gru_fused.py (gru_fused).  Design and bound:
// ops/cuda/step_fused.py.
//
// The convolutions are implicit GEMMs (conv_igemm.cuh).  Two small stages
// with too few output channels for a tensor-core tile run on the CUDA cores
// here: the flow head's 256 -> 1 conv (one warp a pixel) and the motion
// encoder's 1x1 correlation conv plus 7x7 flow conv (one thread an output
// channel).  Intermediates the TPU kernels kept in VMEM slabs (fh1, the
// encoder's c1/f1 and c2/f2 planes, z and r*h) go through device-memory
// scratch that the wrapper allocates, rounded to the compute dtype as the
// slabs are.
#include "conv_igemm.cuh"

using sa::conv::Args;

namespace {

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

// Flow head conv2 (3x3, 256 -> 1; the x output only) + coordinate update:
// coords'[m] = coords[m] + (sum_{tap, c} fh1[m + tap, c] w2[tap, c] + b2).
// One warp a pixel, 8 channels a lane.
constexpr int FH_HID = 256;

template <typename T>
__global__ void __launch_bounds__(256) flow_delta_kernel(const T* __restrict__ fh1, const T* __restrict__ w2,
                                                         const float* __restrict__ b2,
                                                         const float* __restrict__ coords, float* __restrict__ out,
                                                         int B, int H, int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int M = B * H * W;
  const int m = blockIdx.x * 8 + warp;
  if (m >= M) return;
  const int x = m % W, y = (m / W) % H, b = m / (W * H);
  float acc = 0.f;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    float v[8], w[8];
    load8(fh1 + (static_cast<size_t>(b * H + yy) * W + xx) * FH_HID + lane * 8, v);
    load8(w2 + tap * FH_HID + lane * 8, w);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(v[j], w[j], acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[m] = coords[m] + (acc + b2[0]);
}

// Motion encoder, first stage: out[m] = [relu(c1(corr_a)) | relu(c1(corr_b)) | relu(f1(flow-x))]
// (192 channels, in the dtype).  c1 is the shared 1x1 conv (KC -> 64) of the
// two correlation streams, f1 the 7x7 conv (1 -> 64) of flow-x = coords - x,
// rounded to the dtype and zero outside the image.  A block takes 32 pixels
// of one row; thread c computes output channel c, its weights in registers.
constexpr int C1_PX = 32, C1_CO = 64, C1_OUT = 3 * C1_CO;

template <typename T, int KC>
__global__ void __launch_bounds__(C1_OUT) motion_c1f1_kernel(const T* __restrict__ corr_a,
                                                             const T* __restrict__ corr_b,
                                                             const float* __restrict__ coords,
                                                             const T* __restrict__ w_c1, const float* __restrict__ b_c1,
                                                             const T* __restrict__ w_f1, const float* __restrict__ b_f1,
                                                             T* __restrict__ out, int H, int W) {
  __shared__ float s_corr[2][C1_PX][KC];
  __shared__ float s_flow[7][C1_PX + 6];
  const int c = threadIdx.x;
  const int x0 = blockIdx.x * C1_PX, y = blockIdx.y, b = blockIdx.z;
  const int npx = min(C1_PX, W - x0);
  const size_t m0 = static_cast<size_t>(b * H + y) * W + x0;
  for (int e = c; e < 2 * C1_PX * KC; e += C1_OUT) {
    const int s = e / (C1_PX * KC), p = (e / KC) % C1_PX, k = e % KC;
    s_corr[s][p][k] = p < npx ? to_f((s ? corr_b : corr_a)[(m0 + p) * KC + k]) : 0.f;
  }
  for (int e = c; e < 7 * (C1_PX + 6); e += C1_OUT) {
    const int dy = e / (C1_PX + 6), j = e % (C1_PX + 6), yy = y + dy - 3, xx = x0 + j - 3;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = to_f(from_f<T>(coords[static_cast<size_t>(b * H + yy) * W + xx] - static_cast<float>(xx)));
    s_flow[dy][j] = v;
  }
  float wr[49];
  float bias;
  if (c < 2 * C1_CO) {
#pragma unroll
    for (int k = 0; k < KC; ++k) wr[k] = to_f(w_c1[(c % C1_CO) * KC + k]);
    bias = b_c1[c % C1_CO];
  } else {
#pragma unroll
    for (int k = 0; k < 49; ++k) wr[k] = to_f(w_f1[(c - 2 * C1_CO) * 49 + k]);
    bias = b_f1[c - 2 * C1_CO];
  }
  __syncthreads();
  for (int p = 0; p < npx; ++p) {
    float acc = 0.f;
    if (c < 2 * C1_CO) {
      const int s = c / C1_CO;
#pragma unroll
      for (int k = 0; k < KC; ++k) acc = fmaf(wr[k], s_corr[s][p][k], acc);
    } else {
#pragma unroll
      for (int dy = 0; dy < 7; ++dy)
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) acc = fmaf(wr[dy * 7 + dx], s_flow[dy][p + dx], acc);
    }
    out[(m0 + p) * C1_OUT + c] = from_f<T>(fmaxf(acc + bias, 0.f));
  }
}

Args base_args(int B, int H, int W, int ks) {
  Args a{};
  a.B = B;
  a.H = H;
  a.W = W;
  a.ks = ks;
  a.groups = 1;
  return a;
}

}  // namespace

// K7.  h (M, 128), w1 (256, 9, 128), b1 (256) f32, w2 (9, 256), b2 (1) f32,
// coords (M) f32 -> coords_out (M) f32; fh1 scratch (M, 256).
extern "C" int sa_flow_head(const void* h, const void* w1, const void* b1, const void* w2, const void* b2,
                            const void* coords, void* fh1, void* coords_out, int B, int H, int W, int C, int dtype,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  Args a = base_args(B, H, W, 3);
  a.seg[0] = h;
  a.seg_c[0] = C;
  a.nseg = 1;
  a.w = w1;
  a.bias = static_cast<const float*>(b1);
  a.N = FH_HID;
  a.out = fh1;
  cudaError_t e = sa::conv::launch<sa::conv::EPI_RELU>(a, dtype, s);
  if (e != cudaSuccess) return e;
  const int M = B * H * W;
  const unsigned blocks = static_cast<unsigned>((M + 7) / 8);
  const auto* bb = static_cast<const float*>(b2);
  const auto* cf = static_cast<const float*>(coords);
  auto* co = static_cast<float*>(coords_out);
  if (dtype == SA_F32)
    flow_delta_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(fh1), static_cast<const float*>(w2),
                                                    bb, cf, co, B, H, W);
  else
    flow_delta_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(fh1),
                                                            static_cast<const __nv_bfloat16*>(w2), bb, cf, co, B, H,
                                                            W);
  return cudaGetLastError();
}

// K8.  corr_a, corr_b (M, 36), coords (M) f32 -> out (M, 128) =
// [126 encoder channels | flow-x | 0].  w_c1 (64, 36), w_f1 (64, 49),
// w_c2f2 (192, 9, 64) [convc2; convc2; convf2], w_mc (128, 9, 192) (rows
// 126, 127 zero); biases f32.  Scratch a1, a2 (M, 192).
extern "C" int sa_motion(const void* corr_a, const void* corr_b, const void* coords, const void* w_c1,
                         const void* b_c1, const void* w_f1, const void* b_f1, const void* w_c2f2,
                         const void* b_c2f2, const void* w_mc, const void* b_mc, void* a1, void* a2, void* out, int B,
                         int H, int W, int kc, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kc != 36 || (dtype != SA_F32 && dtype != SA_BF16)) return cudaErrorInvalidValue;
  const dim3 grid((W + C1_PX - 1) / C1_PX, H, B);
  const auto* cf = static_cast<const float*>(coords);
  if (dtype == SA_F32)
    motion_c1f1_kernel<float, 36><<<grid, C1_OUT, 0, s>>>(
        static_cast<const float*>(corr_a), static_cast<const float*>(corr_b), cf, static_cast<const float*>(w_c1),
        static_cast<const float*>(b_c1), static_cast<const float*>(w_f1), static_cast<const float*>(b_f1),
        static_cast<float*>(a1), H, W);
  else
    motion_c1f1_kernel<__nv_bfloat16, 36><<<grid, C1_OUT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(corr_a), static_cast<const __nv_bfloat16*>(corr_b), cf,
        static_cast<const __nv_bfloat16*>(w_c1), static_cast<const float*>(b_c1),
        static_cast<const __nv_bfloat16*>(w_f1), static_cast<const float*>(b_f1), static_cast<__nv_bfloat16*>(a1),
        H, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // convc2 on both correlation streams and convf2: one grouped 3x3 conv
  Args a = base_args(B, H, W, 3);
  a.seg[0] = a1;
  a.seg_c[0] = C1_OUT;
  a.nseg = 1;
  a.groups = 3;
  a.w = w_c2f2;
  a.bias = static_cast<const float*>(b_c2f2);
  a.N = C1_OUT;
  a.out = a2;
  e = sa::conv::launch<sa::conv::EPI_RELU>(a, dtype, s);
  if (e != cudaSuccess) return e;

  // the 192 -> 126 merge conv and the [out | flow-x | 0] lanes
  Args m = base_args(B, H, W, 3);
  m.seg[0] = a2;
  m.seg_c[0] = C1_OUT;
  m.nseg = 1;
  m.w = w_mc;
  m.bias = static_cast<const float*>(b_mc);
  m.N = 128;
  m.out = out;
  m.coords = cf;
  return sa::conv::launch<sa::conv::EPI_MOTION>(m, dtype, s);
}

// K9 (and K6).  h (M, hd); x1 (M, c1), x2 (M, c2) or null (c2 = 0);
// injections cz/cr/cq with row stride inj_ld; w_zr (2 hd, 9, hd + c1 + c2),
// w_q (hd, 9, hd + c1 + c2), biases f32 -> out (M, hd).  Scratch z, rh (M, hd).
extern "C" int sa_conv_gru(const void* h, const void* x1, const void* x2, const void* cz, const void* cr,
                           const void* cq, const void* w_zr, const void* b_zr, const void* w_q, const void* b_q,
                           void* z, void* rh, void* out, int B, int H, int W, int hd, int c1, int c2, int inj_ld,
                           int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  Args a = base_args(B, H, W, 3);
  a.seg[0] = h;
  a.seg_c[0] = hd;
  a.seg[1] = x1;
  a.seg_c[1] = c1;
  a.nseg = 2;
  if (c2 > 0) {
    a.seg[2] = x2;
    a.seg_c[2] = c2;
    a.nseg = 3;
  }
  a.hd = hd;
  a.h = h;
  a.inj_z = cz;
  a.inj_r = cr;
  a.inj_q = cq;
  a.inj_ld = inj_ld;
  a.w = w_zr;
  a.bias = static_cast<const float*>(b_zr);
  a.N = 2 * hd;
  a.out = z;
  a.out2 = rh;
  cudaError_t e = sa::conv::launch<sa::conv::EPI_GRU_ZR>(a, dtype, s);
  if (e != cudaSuccess) return e;

  Args q = a;
  q.seg[0] = rh;
  q.w = w_q;
  q.bias = static_cast<const float*>(b_q);
  q.N = hd;
  q.out = out;
  q.out2 = nullptr;
  q.z = z;
  return sa::conv::launch<sa::conv::EPI_GRU_Q>(q, dtype, s);
}
