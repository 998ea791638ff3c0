// K7 flow head + coordinate update, K8 motion encoder, K9 ConvGRU (and K6
// through K9): the quarter-resolution plane of one rotated refinement step.
// Replaces stereoanywhere_tpu/ops/pallas/step_fused.py (fused_step_head's
// flow-head call, fused_step_motion, fused_step_gru) and
// ops/pallas/gru_fused.py (gru_fused).  Design and bound:
// ops/cuda/step_fused.py.
//
// The convolutions are implicit GEMMs: the bf16 3x3 convs of K7, K8 and K9
// on TMA + wgmma (conv_wgmma.cuh), the f32 bodies on FMA tiles
// (conv_igemm.cuh).  Small stages are here: the flow head's tap sum (and,
// in f32, its tap columns) and the motion encoder's 1x1 correlation conv
// plus 7x7 flow conv (bf16: mma.sync products over 64 pixels; f32: one
// thread an output channel).  Intermediates the TPU kernels kept in VMEM
// slabs (the flow head's tap columns z9, the encoder's c1/f1 and c2/f2
// planes, z and r*h) go through device-memory scratch that the wrapper
// allocates, rounded to the compute dtype as the slabs are (z9 f32).  The
// bf16 flow head keeps its fh1 slab out of device memory: conv1's epilogue
// projects it on conv2's x row.
#include "conv_wgmma.cuh"

using sa::conv::Args;

namespace {

// Flow head conv2 (3x3, 256 -> 1; the x output only) as the TPU kernel
// computes it: tap columns z9[tap, m] = fh1[m] . w2[tap] (conv_wgmma.cuh's
// EPI_FLOWHEAD in bf16, flow_z9_kernel in f32), then
// coords'[m] = coords[m] + (sum_tap z9[tap, m + off_tap] + b2), z9 zero
// outside the plane, the taps summed in order (flow_tapsum_kernel).
using sa::cw::FH_N;

// f32 tap columns from fh1 (M, FH_N): one warp a pixel, 8 channels a lane
__global__ void __launch_bounds__(256) flow_z9_kernel(const float* __restrict__ fh1, const float* __restrict__ w2,
                                                      float* __restrict__ z9, int M) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * 8 + warp;
  if (m >= M) return;
  float v[8], w[8];
  load8(fh1 + static_cast<size_t>(m) * FH_N + lane * 8, v);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    load8(w2 + tap * FH_N + lane * 8, w);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(v[j], w[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) z9[static_cast<size_t>(tap) * M + m] = acc;
  }
}

// the tap sum and the coordinate update, a thread a pixel; z9 holds `sets`
// partial sets (9, M), added per tap.  Its inputs (0.6 MB a set at the
// 512^2 request's plane) are in L2, written by the launch before.
__global__ void __launch_bounds__(256) flow_tapsum_kernel(const float* __restrict__ z9, int sets,
                                                          const float* __restrict__ b2,
                                                          const float* __restrict__ coords, float* __restrict__ out,
                                                          int B, int H, int W) {
  const size_t M = static_cast<size_t>(B) * H * W;
  const size_t m = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int x = static_cast<int>(m % W), y = static_cast<int>((m / W) % H);
  float delta = 0.f;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    if (y + dy < 0 || y + dy >= H || x + dx < 0 || x + dx >= W) continue;
    const float* col = z9 + tap * M + static_cast<ptrdiff_t>(m) + dy * W + dx;
    float v = col[0];
    for (int s = 1; s < sets; ++s) v += col[s * 9 * M];
    delta += v;
  }
  out[m] = coords[m] + (delta + b2[0]);
}

// Motion encoder, first stage: out[m] = [relu(c1(corr_a)) | relu(c1(corr_b)) | relu(f1(flow-x))]
// (192 channels, in the dtype).  The f32 body (the bf16 one is
// motion_c1f1_mma_kernel below).  c1 is the shared 1x1 conv (KC -> 64) of the
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

// The first stage in bf16, on the tensor cores (mma.sync m16n8k16, f32
// sums): c1 and f1 as three small products over 64 pixels of one row,
// [corr_a; corr_b] (2 x 64 x 36, K padded to 48) x w_c1^T and the flow-x
// im2col (64 x 49 taps, K padded to 64) x w_f1^T.  0.25 GFLOP at the 512^2
// request, but on the H100's CUDA cores, one thread an output channel, it
// held 31% of K8's device time once the 3x3 stages ran on wgmma.  The
// correlation rows (72 bytes, so no TMA row) come in as 4-byte words; the
// im2col is built in shared memory from a 7-row flow-x tile rounded to
// bf16 (zero outside the image); the 64 x 192 output goes through shared
// memory and out in 16-byte pieces, the block's rows being one contiguous
// run.  Six warps: warp w takes 32 pixels (w % 2) of product w / 2 (c1 on
// corr_a, c1 on corr_b, f1), all 64 output channels.  Rounding: a1 once,
// to bf16, as the TPU kernel's slabs.
namespace tc1 {
constexpr int PX = 64, KA = 48, KF = 64, TAPS = 49, FLW = PX + 6;
// bf16 pitches: the 8 rows an ldmatrix reads (and the output rows a warp writes) fall on distinct banks
constexpr int LDA = KA + 8, LDF = KF + 8, LDO = C1_OUT + 8;
// shared-memory layout in bf16 elements; the output tile [PX][LDO] reuses it from 0 once the products are done
constexpr int A_C = 0;                   // [2][PX][LDA]: the correlation rows of both streams
constexpr int A_F = A_C + 2 * PX * LDA;  // [PX][LDF]: f1's im2col
constexpr int W_C = A_F + PX * LDF;      // [C1_CO][LDA]: w_c1
constexpr int W_F = W_C + C1_CO * LDA;   // [C1_CO][LDF]: w_f1
constexpr int FLOW = W_F + C1_CO * LDF;  // [7][FLW]: flow-x rows y - 3 .. y + 3, columns x0 - 3 ..
constexpr int ELEMS = FLOW + 7 * FLW;
static_assert(PX * LDO <= ELEMS && ELEMS * 2 <= 48 * 1024, "shared-memory layout");
}  // namespace tc1

// three blocks an SM (at most 112 registers a thread): the 375x1242 request's plane has 480 blocks
template <int KC>
__global__ void __launch_bounds__(C1_OUT, 3) motion_c1f1_mma_kernel(const __nv_bfloat16* __restrict__ corr_a,
                                                                 const __nv_bfloat16* __restrict__ corr_b,
                                                                 const float* __restrict__ coords,
                                                                 const __nv_bfloat16* __restrict__ w_c1,
                                                                 const float* __restrict__ b_c1,
                                                                 const __nv_bfloat16* __restrict__ w_f1,
                                                                 const float* __restrict__ b_f1,
                                                                 __nv_bfloat16* __restrict__ out, int H, int W) {
  using namespace tc1;
  static_assert(KC % 2 == 0 && KC <= KA, "correlation rows of KC channels as 4-byte words");
  __shared__ __align__(16) __nv_bfloat16 sm[ELEMS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int x0 = blockIdx.x * PX, y = blockIdx.y, b = blockIdx.z;
  const int npx = min(PX, W - x0);
  const size_t m0 = static_cast<size_t>(b * H + y) * W + x0;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  // Every global load of a thread first, into registers, then the stores to
  // shared memory: a loop that stored each value before loading the next
  // waited out one memory latency a step, 12-37 of them a thread.  Values
  // in pairs where the counts are even (w_c1: 64 x 36, w_f1: 64 x 49).
  constexpr int CWORDS = 2 * PX * (KC / 2), WC = C1_CO * KC / 2, WW = WC + C1_CO * TAPS / 2, NFL = 7 * FLW;
  constexpr int RC = (CWORDS + C1_OUT - 1) / C1_OUT, RW = (WW + C1_OUT - 1) / C1_OUT, RF = (NFL + C1_OUT - 1) / C1_OUT;
  static_assert(C1_CO * TAPS % 2 == 0, "w_f1 as 4-byte words");
  unsigned cw[RC];  // correlation channel pairs: stream, pixel, pair
  unsigned wv[RW];  // w_c1, then w_f1, in pairs in their device-memory order
  float fv[RF];     // flow-x, rows y - 3 .. y + 3, columns x0 - 3 ..
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int e = tid + i * C1_OUT, s = e / (PX * (KC / 2)), p = (e / (KC / 2)) % PX;
    cw[i] = e < CWORDS && p < npx
                ? reinterpret_cast<const unsigned*>((s ? corr_b : corr_a) + (m0 + p) * KC)[e % (KC / 2)]
                : 0u;  // zero past the plane
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int e = tid + i * C1_OUT;
    wv[i] = e < WC ? reinterpret_cast<const unsigned*>(w_c1)[e]
                   : e < WW ? reinterpret_cast<const unsigned*>(w_f1)[e - WC] : 0u;
  }
#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int e = tid + i * C1_OUT, dy = e / FLW, xx = x0 + e % FLW - 3, yy = y + dy - 3;
    fv[i] = e < NFL && yy >= 0 && yy < H && xx >= 0 && xx < W
                ? coords[static_cast<size_t>(b * H + yy) * W + xx] - static_cast<float>(xx)
                : 0.f;
  }
  unsigned* ac = reinterpret_cast<unsigned*>(sm + A_C);  // [2][PX][LDA / 2] channel pairs
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int e = tid + i * C1_OUT, sp = e / (KC / 2);  // stream * PX + pixel
    if (e < CWORDS) ac[sp * (LDA / 2) + e % (KC / 2)] = cw[i];
  }
  for (int e = tid; e < 2 * PX * (LDA - KC) / 2; e += C1_OUT)  // K's padding
    ac[e / ((LDA - KC) / 2) * (LDA / 2) + KC / 2 + e % ((LDA - KC) / 2)] = 0u;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int e = tid + i * C1_OUT;
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&wv[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * e + h, f = 2 * (e - WC) + h;  // element of w_c1, of w_f1
      const __nv_bfloat16 v = h ? pair.y : pair.x;
      if (e < WC)
        sm[W_C + c / KC * LDA + c % KC] = v;
      else if (e < WW)
        sm[W_F + f / TAPS * LDF + f % TAPS] = v;
    }
  }
  for (int e = tid; e < C1_CO * (LDA - KC); e += C1_OUT) sm[W_C + e / (LDA - KC) * LDA + KC + e % (LDA - KC)] = zero;
  for (int e = tid; e < C1_CO * (LDF - TAPS); e += C1_OUT)
    sm[W_F + e / (LDF - TAPS) * LDF + TAPS + e % (LDF - TAPS)] = zero;
#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int e = tid + i * C1_OUT;
    if (e < NFL) sm[FLOW + e] = __float2bfloat16(fv[i]);
  }
  __syncthreads();
  // im2col: row p, column dy * 7 + dx = flow-x at (y + dy - 3, x0 + p + dx - 3)
  for (int e = tid; e < PX * LDF; e += C1_OUT) {
    const int p = e / LDF, t = e % LDF;
    sm[A_F + e] = t < TAPS ? sm[FLOW + t / 7 * FLW + p + t % 7] : zero;
  }
  __syncthreads();

  const int grp = warp / 2, half = warp % 2, ld = grp < 2 ? LDA : LDF, kdim = grp < 2 ? KA : KF;
  const __nv_bfloat16* a_tile = sm + (grp < 2 ? A_C + grp * PX * LDA : A_F) + 32 * half * ld;
  const __nv_bfloat16* w_tile = sm + (grp < 2 ? W_C : W_F);
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;  // ldmatrix lanes, A operand
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;  // ldmatrix lanes, B operand
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  for (int kk = 0; kk < kdim; kk += 16) {
    unsigned af[2][4], bf[8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a_tile + (i * 16 + a_row) * ld + kk + a_col);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      unsigned r4[4];
      ldmatrix_x4(r4, w_tile + (j * 8 + b_row) * ld + kk + b_col);
      bf[j][0] = r4[0];
      bf[j][1] = r4[1];
      bf[j + 1][0] = r4[2];
      bf[j + 1][1] = r4[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
  }
  __syncthreads();  // every warp's operands are read: the output tile may overwrite them

  // bias, ReLU, bf16 pairs into the output tile: (row g, columns 2t, 2t + 1) and row g + 8
  const float* bias = grp < 2 ? b_c1 : b_f1;
  unsigned* o = reinterpret_cast<unsigned*>(sm);  // [PX][LDO / 2]
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = j * 8 + 2 * t;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        o[(32 * half + i * 16 + g + 8 * h) * (LDO / 2) + (grp * C1_CO + n) / 2] =
            pack_bf16(fmaxf(acc[i][j][2 * h] + b0, 0.f), fmaxf(acc[i][j][2 * h + 1] + b1, 0.f));
  }
  __syncthreads();
  constexpr int PIECES = C1_OUT / 8;  // 16-byte pieces of an output row
  for (int e = tid; e < npx * PIECES; e += C1_OUT) {
    const int p = e / PIECES, q = e % PIECES;
    *reinterpret_cast<uint4*>(out + (m0 + p) * C1_OUT + 8 * q) = *reinterpret_cast<const uint4*>(sm + p * LDO + 8 * q);
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

// K8 (tile2, tile3: the bf16 3x3 stages' tiles, 0 = picked; see sa_motion)
cudaError_t run_motion(const void* corr_a, const void* corr_b, const void* coords, const void* w_c1, const void* b_c1,
                       const void* w_f1, const void* b_f1, const void* w_c2f2, const void* b_c2f2, const void* w_mc,
                       const void* b_mc, void* a1, void* a2, void* out, int B, int H, int W, int kc, int dtype,
                       int tile2, int tile3, cudaStream_t s) {
  if (kc != 36 || (dtype != SA_F32 && dtype != SA_BF16)) return cudaErrorInvalidValue;
  const auto* cf = static_cast<const float*>(coords);
  if (dtype == SA_F32)
    motion_c1f1_kernel<float, 36><<<dim3((W + C1_PX - 1) / C1_PX, H, B), C1_OUT, 0, s>>>(
        static_cast<const float*>(corr_a), static_cast<const float*>(corr_b), cf, static_cast<const float*>(w_c1),
        static_cast<const float*>(b_c1), static_cast<const float*>(w_f1), static_cast<const float*>(b_f1),
        static_cast<float*>(a1), H, W);
  else
    motion_c1f1_mma_kernel<36><<<dim3((W + tc1::PX - 1) / tc1::PX, H, B), C1_OUT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(corr_a), static_cast<const __nv_bfloat16*>(corr_b), cf,
        static_cast<const __nv_bfloat16*>(w_c1), static_cast<const float*>(b_c1),
        static_cast<const __nv_bfloat16*>(w_f1), static_cast<const float*>(b_f1), static_cast<__nv_bfloat16*>(a1),
        H, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (dtype == SA_BF16)
    return sa::cw::launch_motion(a1, w_c2f2, b_c2f2, w_mc, b_mc, cf, a2, out, B, H, W, C1_OUT, 128, tile2, tile3, s);

  // f32: convc2 on both correlation streams and convf2, one grouped 3x3 conv
  Args a = base_args(B, H, W, 3);
  a.seg[0] = a1;
  a.seg_c[0] = C1_OUT;
  a.nseg = 1;
  a.groups = 3;
  a.w = w_c2f2;
  a.bias = static_cast<const float*>(b_c2f2);
  a.N = C1_OUT;
  a.out = a2;
  e = sa::conv::launch<sa::conv::EPI_RELU>(a, s);
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
  return sa::conv::launch<sa::conv::EPI_MOTION>(m, s);
}

// K7 (tile: conv1's bf16 tile, 0 = picked; see sa_flow_head)
cudaError_t run_flow_head(const void* h, const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* coords, void* fh1, void* z9, void* coords_out, int B, int H, int W, int C,
                          int dtype, int tile, cudaStream_t s) {
  const long long M = static_cast<long long>(B) * H * W;
  if ((dtype != SA_F32 && dtype != SA_BF16) || M <= 0 || M > (1LL << 30)) return cudaErrorInvalidValue;
  auto* zf = static_cast<float*>(z9);
  int sets = 1;
  cudaError_t e;
  if (dtype == SA_BF16) {
    e = sa::cw::launch_flowhead(h, w1, b1, w2, zf, B, H, W, C, tile, &sets, s);
  } else {
    Args a = base_args(B, H, W, 3);
    a.seg[0] = h;
    a.seg_c[0] = C;
    a.nseg = 1;
    a.w = w1;
    a.bias = static_cast<const float*>(b1);
    a.N = FH_N;
    a.out = fh1;
    e = sa::conv::launch<sa::conv::EPI_RELU>(a, s);
    if (e == cudaSuccess) {
      flow_z9_kernel<<<static_cast<unsigned>((M + 7) / 8), 256, 0, s>>>(
          static_cast<const float*>(fh1), static_cast<const float*>(w2), zf, static_cast<int>(M));
      e = cudaGetLastError();
    }
  }
  if (e != cudaSuccess) return e;
  flow_tapsum_kernel<<<static_cast<unsigned>((M + 255) / 256), 256, 0, s>>>(
      zf, sets, static_cast<const float*>(b2), static_cast<const float*>(coords), static_cast<float*>(coords_out), B,
      H, W);
  return cudaGetLastError();
}

}  // namespace

// K7.  h (M, C), w1 (256, 9, C), b1 (256) f32, w2 (9, 256), b2 (1) f32,
// coords (M) f32 -> coords_out (M) f32.  Scratch z9 (4, 9, M) f32: the tap
// columns, one partial set a 256 / 4 = 64-channel tile column at most; f32
// also fh1 (M, 256), null in bf16.  Two launches in bf16 (conv1 with its
// tap columns on conv_wgmma.cuh, the tap sum), three in f32 (conv1 on
// conv_igemm.cuh's FMA tile, the tap columns, the tap sum).
extern "C" int sa_flow_head(const void* h, const void* w1, const void* b1, const void* w2, const void* b2,
                            const void* coords, void* fh1, void* z9, void* coords_out, int B, int H, int W, int C,
                            int dtype, void* stream) {
  return run_flow_head(h, w1, b1, w2, b2, coords, fh1, z9, coords_out, B, H, W, C, dtype, 0,
                       static_cast<cudaStream_t>(stream));
}

// Diagnostic, not a path of the model: K7's bf16 body with tile candidate
// 1..5 (sa::cw::pick_plan's list) forced on conv1.  Arguments as
// sa_flow_head's, bf16 only.
extern "C" int sa_flow_head_forced_tile(const void* h, const void* w1, const void* b1, const void* w2, const void* b2,
                                        const void* coords, void* z9, void* coords_out, int B, int H, int W, int C,
                                        int tile, void* stream) {
  if (tile < 1 || tile > sa::cw::CANDIDATES) return cudaErrorInvalidValue;
  return run_flow_head(h, w1, b1, w2, b2, coords, nullptr, z9, coords_out, B, H, W, C, SA_BF16, tile,
                       static_cast<cudaStream_t>(stream));
}

// K7's bf16 conv1 launch geometry at one plane, out[0 .. 8] as
// sa_conv_gru_geometry's; the shared memory includes conv2's x row.
extern "C" int sa_flow_head_geometry(int B, int H, int W, int* out) {
  const sa::cw::Plan p = sa::cw::pick_plan(B, H, W, FH_N);
  const int v[9] = {p.bm, p.bn, p.bw, p.bh, p.tiles, p.blocks, p.stages, p.threads, p.smem + sa::cw::FH_W2_BYTES};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
  return cudaSuccess;
}

// K8.  corr_a, corr_b (M, 36), coords (M) f32 -> out (M, 128) =
// [126 encoder channels | flow-x | 0].  w_c1 (64, 36), w_f1 (64, 49),
// w_c2f2 (192, 9, 64) [convc2; convc2; convf2], w_mc (128, 9, 192) (rows
// 126, 127 zero); biases f32.  Scratch a1, a2 (M, 192).  Three launches:
// c1/f1 on the CUDA cores, then the two 3x3 stages (bf16: conv_wgmma.cuh's
// launch_motion; f32: conv_igemm.cuh's FMA tiles).
extern "C" int sa_motion(const void* corr_a, const void* corr_b, const void* coords, const void* w_c1,
                         const void* b_c1, const void* w_f1, const void* b_f1, const void* w_c2f2,
                         const void* b_c2f2, const void* w_mc, const void* b_mc, void* a1, void* a2, void* out, int B,
                         int H, int W, int kc, int dtype, void* stream) {
  return run_motion(corr_a, corr_b, coords, w_c1, b_c1, w_f1, b_f1, w_c2f2, b_c2f2, w_mc, b_mc, a1, a2, out, B, H, W,
                    kc, dtype, 0, 0, static_cast<cudaStream_t>(stream));
}

// Diagnostic, not a path of the model: K8's bf16 body with tile candidate
// 1..5 (sa::cw::pick_plan's list) forced on its grouped stage (tile2; only
// BN 64: 4 or 5) or its merge conv (tile3; not 1), 0 picking as sa_motion
// does, to time the candidates against each other.  Arguments as
// sa_motion's, bf16 only.
extern "C" int sa_motion_forced_tile(const void* corr_a, const void* corr_b, const void* coords, const void* w_c1,
                                     const void* b_c1, const void* w_f1, const void* b_f1, const void* w_c2f2,
                                     const void* b_c2f2, const void* w_mc, const void* b_mc, void* a1, void* a2,
                                     void* out, int B, int H, int W, int kc, int tile2, int tile3, void* stream) {
  if (tile2 < 0 || tile2 > sa::cw::CANDIDATES || tile3 < 0 || tile3 > sa::cw::CANDIDATES)
    return cudaErrorInvalidValue;
  return run_motion(corr_a, corr_b, coords, w_c1, b_c1, w_f1, b_f1, w_c2f2, b_c2f2, w_mc, b_mc, a1, a2, out, B, H, W,
                    kc, SA_BF16, tile2, tile3, static_cast<cudaStream_t>(stream));
}

// K8's bf16 launch geometry at one plane: out[9 i .. 9 i + 8] for the
// grouped 3x3 stage (i = 0, N 192 in 3 groups) and the merge conv (i = 1,
// N 128), as sa_conv_gru_geometry's.
extern "C" int sa_motion_geometry(int B, int H, int W, int* out) {
  const sa::cw::Plan plans[2] = {sa::cw::pick_plan(B, H, W, C1_OUT, 0, 3), sa::cw::pick_plan(B, H, W, 128)};
  for (int i = 0; i < 2; ++i) {
    const sa::cw::Plan& p = plans[i];
    const int v[9] = {p.bm, p.bn, p.bw, p.bh, p.tiles, p.blocks, p.stages, p.threads, p.smem};
    for (int k = 0; k < 9; ++k) out[9 * i + k] = v[k];
  }
  return cudaSuccess;
}

// K9 (and K6).  h (M, hd); x1 (M, c1), x2 (M, c2) or null (c2 = 0);
// injections cz/cr/cq with row stride inj_ld; w_zr (2 hd, 9, hd + c1 + c2),
// w_q (hd, 9, hd + c1 + c2), biases f32 -> out (M, hd).  Scratch z, rh (M, hd).
extern "C" int sa_conv_gru(const void* h, const void* x1, const void* x2, const void* cz, const void* cr,
                           const void* cq, const void* w_zr, const void* b_zr, const void* w_q, const void* b_q,
                           void* z, void* rh, void* out, int B, int H, int W, int hd, int c1, int c2, int inj_ld,
                           int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SA_BF16)
    return sa::cw::launch_gru(h, x1, x2, cz, cr, cq, w_zr, b_zr, w_q, b_q, z, rh, out, B, H, W, hd, c1, c2, inj_ld,
                              0, s);
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
  cudaError_t e = sa::conv::launch<sa::conv::EPI_GRU_ZR>(a, s);
  if (e != cudaSuccess) return e;

  Args q = a;
  q.seg[0] = rh;
  q.w = w_q;
  q.bias = static_cast<const float*>(b_q);
  q.N = hd;
  q.out = out;
  q.out2 = nullptr;
  q.z = z;
  return sa::conv::launch<sa::conv::EPI_GRU_Q>(q, s);
}

// Diagnostic, not a path of the model: K9's bf16 body with tile candidate
// 1..5 (128x256, 128x128, 64x128, 64x64, 128x64; sa::cw::pick_plan) forced on
// both launches, to time the candidates against each other.  Arguments as
// sa_conv_gru's, bf16 only.
extern "C" int sa_conv_gru_forced_tile(const void* h, const void* x1, const void* x2, const void* cz,
                                       const void* cr, const void* cq, const void* w_zr, const void* b_zr,
                                       const void* w_q, const void* b_q, void* z, void* rh, void* out, int B, int H,
                                       int W, int hd, int c1, int c2, int inj_ld, int tile, void* stream) {
  if (tile < 1 || tile > sa::cw::CANDIDATES) return cudaErrorInvalidValue;
  return sa::cw::launch_gru(h, x1, x2, cz, cr, cq, w_zr, b_zr, w_q, b_q, z, rh, out, B, H, W, hd, c1, c2, inj_ld,
                            tile, static_cast<cudaStream_t>(stream));
}

// K9's bf16 launch geometry at one plane: out[9 i .. 9 i + 8] for the z/r
// (i = 0, N = 2 hd) and q (i = 1, N = hd) launches = tile rows BM, tile width
// BN, patch width BW and height BH, tiles, blocks (the persistent grid),
// ring stages, threads, dynamic shared memory in bytes.
extern "C" int sa_conv_gru_geometry(int B, int H, int W, int hd, int* out) {
  for (int i = 0; i < 2; ++i) {
    const sa::cw::Plan p = sa::cw::pick_plan(B, H, W, (2 - i) * hd);
    const int v[9] = {p.bm, p.bn, p.bw, p.bh, p.tiles, p.blocks, p.stages, p.threads, p.smem};
    for (int k = 0; k < 9; ++k) out[9 * i + k] = v[k];
  }
  return cudaSuccess;
}
