// The conv kernel family with the BN prologue and the stat epilogue in the
// kernel (K5-K8) for Hopper (sm_90a), CUDA C++.
//
// Replaces paddle_tpu/ops/_pallas/conv.py:
//   K5 conv1x1_kernel        <- _mm_kernel (:142, pallas_call in _mm at :186);
//      in 16 bits conv1x1_tc_kernel
//   K6 conv1x1_wgrad_kernel  <- _mm_wgrad_kernel (:221, _mm_wgrad at :254);
//      in 16 bits conv1x1_wgrad_tc_kernel
//   K7 conv3x3_kernel        <- _c3_kernel (:311, _c3 at :364), and the 3x3
//      input gradient of conv2d_dgrad (:513-556); in 16 bits
//      conv3x3_tc_kernel, the stride-2 input gradient by output phase
//   K8 conv3x3_wgrad_kernel  <- _c3_wgrad_kernel (:401, _c3_wgrad at :441);
//      in 16 bits conv3x3_wgrad_tc_kernel
// and, through paddle_fused_matmul_bn_fwd, K9 of fused_matmul_bn.py (its body
// is K5's function on [M, Cin] rows, and runs K5's kernels; see that entry).
//
// What they compute. x is an NHWC activation [N, H, W, C]; a = act(x * scale
// + shift) is the previous BatchNorm's apply (and ReLU) as a prologue, or x
// itself. The prologue rounds where the TPU kernels round (:148, :289): scale
// and shift are rounded to x's type, the product to x's type, then the sum,
// then ReLU. Outside the image (the zero padding of a 3x3 conv) a is 0, not
// act(0 * scale + shift) (_c3_prologue, :282-297). For output pixel (n, ho,
// wo) and tap (dh, dw) the input pixel is (ho * stride + dh - pad, wo * stride
// + dw - pad): pad 0 and one tap for 1x1, pad 1 and nine taps for 3x3, so a
// strided 1x1 reads x[:, ::2, ::2] in place and the 3x3 reads the padded image
// without it being written out.
//   K5, K7:  acc[m, k] = sum_{tap, c} a[pixel(m, tap), c] * wt[tap, c, k]  (f32)
//            y = acc rounded to x's type, and per output channel the f32
//            (sum acc, sum acc^2) over all M = N * Ho * Wo rows, taken from
//            acc before y is rounded (:161-162, :332-333).
//   K6, K8:  dw[tap, c, k] = sum_m a[pixel(m, tap), c] * dy[m, k]           (f32)
// With no prologue and no stats, K5 is the 1x1 input gradient (dy times w as
// [Cout, Cin]) and K7 the 3x3 input gradient (the stride-1 conv of the zero-
// dilated, padded dy with the 180-degree-rotated taps), built by the wrapper
// as conv.py builds them (:531, :538-556); in 16 bits K7 takes the stride-2
// input gradient by output phase instead (conv3x3_tc_kernel's note), the
// same function without the dilation's zero products.
//
// What the TPU relies on that Hopper lacks. The TPU runs the grid in order on
// one core, so the Pallas kernels carry the stats and the weight gradient in
// VMEM scratch from one grid step to the next (:156-167, :231-240, :327-338,
// :413-423). Here blocks run in parallel and in no order, and no atomics are
// used, so every result repeats bit for bit:
// - Stats: each K5/K7 block sums its rows (128 in f32; K5 in 16 bits its
//   row tile, conv.py's k5_plan; K7 in 16 bits its band's pixels) per
//   output channel in a fixed order and writes the partial
//   (sum, sum of squares) to its own row of a [blocks or bands, 2K] f32
//   scratch; reduce_rows_kernel then sums the rows in a fixed order, 256
//   rows a pass (two passes for M = 802,816). The scratch costs 16 bytes
//   per row and channel written and read: 3.2 MB at M = 802,816, K = 64,
//   against 103 MB of y.
// - Weight gradients: the sum runs over M (up to 802,816 rows) while dw has
//   only Cin x Cout (x 9) entries, so one block per output tile would leave
//   most of the 132 SMs idle. K6/K8 split M into S ranges (split-K), each
//   block writes an f32 partial dw of its range, and reduce_rows_kernel sums
//   the S partials in a fixed order. K6 in f32 picks S so that about 1,024
//   blocks run, in 16 bits so that about one wave of its larger tiles runs
//   (conv.py's k6_plan); K8 (16-bit) cuts M into bands of whole output rows
//   and S so that about two waves of 132 blocks run (conv.py's
//   wgrad_bands). The split costs 8 * S * Cin * Cout (* 9) bytes written
//   and read: 38 MB for the 3x3 64 -> 64 conv at 56^2 (S = 256), against
//   206 MB of x and dy read.
//
// Design. Each kernel is a tiled implicit GEMM, one body per kind shared by
// its 1x1 and 3x3 forms (TAPS = 1 or 9). K5 and K7 in f32: a block of 256
// threads owns 128 output rows x 64 output channels and walks the taps and
// the input channels, loading the A tile (prologue applied, padding zeroed)
// and the weight tile into shared memory while the next tiles' global loads
// are in flight. K6 in f32 (and K8 in f32): a block owns 64 input channels
// of one tap x 64 output channels and walks its range of rows. K5 in 16
// bits (conv1x1_tc_kernel) owns tiles of up to 256 x 64, 256 x 128 or 128 x
// 256 rows x output channels, so that x is read and prologued about once,
// fed by a four-stage cp.async ring with A by ldmatrix and wt by
// ldmatrix.trans, and writes y staged through shared memory. K7 in 16
// bits (conv3x3_tc_kernel, below) is shaped like _c3_kernel: persistent
// blocks walk bands of output pixels, copy warps bring each band's x
// window in once a channel step by cp.async and apply the prologue once per
// element, and product warps take each tap's A from that window by
// ldmatrix at the tap's pixel offset; its stride-2 input gradient runs by
// output phase. K6 in 16 bits (conv1x1_wgrad_tc_kernel) owns dw tiles of up
// to 256 x 64 or 128 x 128 channels, fed by a four-stage cp.async ring with
// both fragments read by ldmatrix.trans. K8 in 16 bits
// (conv3x3_wgrad_tc_kernel, below) is shaped like _c3_wgrad_kernel: a block
// owns 64 x 64 channels of all nine taps and walks bands of whole output
// rows, loading each band's x window once with its halo, applying the
// prologue once per element, and taking the nine taps' A operands from the
// one window by ldmatrix.trans at each tap's pixel offset (its note says
// why the band and the split are what they are). Sizes need not be
// multiples of the tiles: ragged edges are masked. In bf16 and float16 (the
// training path) the products run on the tensor cores, mma.sync m16n8k16
// with f32 accumulation, 32 channels or rows a step in 16-bit tiles, of
// either type (mma.cuh's trait: the prologue rounds to x's type, as the TPU
// kernel rounds in x.dtype); in f32 they run on the CUDA cores (FMA, each
// thread 8 x 4 or 4 x 4 outputs, 16 a step), as K1-K4 do.
//
// What bounds them on an H100. At ResNet-50's 56 x 56 shapes at B = 256 in
// bf16 (chip_smoke.py times them): K5 256 -> 64 reads x (411 MB) and writes
// y (103 MB) for 2.6e10 FLOPs: bytes bound it (0.153 ms at 3.35 TB/s); K7
// 64 -> 64 moves 206 MB for 5.9e10 FLOPs, bytes first with the FLOPs close
// (0.061 against 0.060 ms at 989 TFLOP/s); K8 64 -> 64 the same bytes and
// FLOPs (0.061 ms). The f32 bodies (and the 16-bit yardsticks that keep the
// earlier bodies) feed their products from shared memory without ldmatrix
// or asynchronous copies and stay far from both. K8's nine-tap body reads, per 16 output pixels and warp, 4 ldmatrix
// of dy and 3 of a for 24 products: shared-memory reads, the mma.sync issue
// rate and the phases a band runs in turn (copies, the prologue, the
// products), not the bytes, bound it. K7's, K6's and K5's 16-bit bodies:
// their notes below. Their times stand in PERF.md. wgmma fed by TMA is a later
// change's work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
// K5/K7 tile: rows x output channels x input channels a step
constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kLdA = kBM + 4;   // padded row stride of the transposed A tile
constexpr int kLdB = kBN + 4;
// K6/K8 tile: input channels x output channels x rows a step
constexpr int kWM = 64;
constexpr int kWN = 64;
constexpr int kWK = 16;
constexpr int kLdW = 64 + 4;
// the bf16 tensor-core tiles take 32 input channels (K5/K7) or rows
// (K6/K8) a step, two m16n8k16 products deep, in rows of 40 bf16 (80 bytes:
// the fragment loads of a warp hit 32 different banks)
constexpr int kTK = 32;
constexpr int kLdT = kTK + 8;
// rows of partials one reduce_rows_kernel block sums
constexpr int kReduceChunk = 256;

struct ConvParams {
  const void* x;        // [N, H, W, C]
  const void* w;        // K5/K7: taps [TAPS, C, K]; K6/K8: dy [M, K]
  const float* scale;   // [C] or null
  const float* shift;
  void* y;              // K5/K7: [M, K] in x's type; K6/K8: f32 [S, TAPS*C, K]
  float* partial;       // K5/K7 stats: [gridDim.x, 2K] f32, or null
  int N, H, W, C;
  int Ho, Wo, K;
  int stride, pad;
  int M;                // N * Ho * Wo
  int rows_per_split;   // K6/K8: rows of M per blockIdx.z, a multiple of kTK
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half(v);
}

// v rounded to T and back: the points where the TPU kernels cast
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// act(x * scale + shift) in T's arithmetic: each operand and each result
// rounded to T (no fused multiply-add, which would skip the product's rounding)
template <typename T, bool RELU>
__device__ __forceinline__ float prologue(float v, float sc, float sh) {
  float a = round_to<T>(__fmul_rn(v, round_to<T>(sc)));
  a = round_to<T>(__fadd_rn(a, round_to<T>(sh)));
  return RELU ? fmaxf(a, 0.f) : a;
}

// Output row m -> (n, first input row, first input column) of its window
struct RowOrigin {
  long long img;   // n * H * W
  int hi, wi;      // ho * stride - pad, wo * stride - pad
  bool valid;      // m < M
};

__device__ __forceinline__ RowOrigin row_origin(const ConvParams& p, int m) {
  RowOrigin o;
  o.valid = m < p.M;
  const int mm = o.valid ? m : 0;
  const int hw = p.Ho * p.Wo;
  const int n = mm / hw;
  const int r = mm - n * hw;
  const int ho = r / p.Wo;
  const int wo = r - ho * p.Wo;
  o.img = static_cast<long long>(n) * p.H * p.W;
  o.hi = ho * p.stride - p.pad;
  o.wi = wo * p.stride - p.pad;
  return o;
}

// Offset of pixel (origin + tap) in x in elements, or -1 outside the image
__device__ __forceinline__ long long pixel(const ConvParams& p,
                                           const RowOrigin& o, int dh,
                                           int dw) {
  const int hi = o.hi + dh;
  const int wi = o.wi + dw;
  if (!o.valid || hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) return -1;
  return (o.img + static_cast<long long>(hi) * p.W + wi) * p.C;
}

// a[pixel, c] in f32: 0 outside the image or past C, the prologue applied
template <typename T, bool PRO, bool RELU>
__device__ __forceinline__ float load_a(const ConvParams& p, const T* x,
                                        long long pix, int c) {
  if (pix < 0 || c >= p.C) return 0.f;
  const float v = to_float(x[pix + c]);
  if (!PRO) return v;
  return prologue<T, RELU>(v, __ldg(p.scale + c), __ldg(p.shift + c));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Whether 8 consecutive bf16 at an offset that is a multiple of 8 elements
// can be read as one 16-byte load from base
__device__ __forceinline__ bool vec8(const void* base, int row_len) {
  return row_len % 8 == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

// The 8 16-bit values at base + off (a multiple of 8 elements), as packed
// pairs
template <typename T>
__device__ __forceinline__ uint4 ld8(const T* base, long long off) {
  return __ldg(reinterpret_cast<const uint4*>(base + off));
}

// a[pixel, c .. c + 7] in f32 (c a multiple of 8) of a 16-bit x: one 16-byte
// load where the 8 channels lie inside x and vec holds (see vec8), else
// load_a's
template <typename T, bool PRO, bool RELU>
__device__ __forceinline__ void load_a8(const ConvParams& p, const T* x,
                                        long long pix, int c, bool vec,
                                        float (&v)[8]) {
  if (vec && pix >= 0 && c + 8 <= p.C) {
    const uint4 u = ld8(x, pix + c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2<T>(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
    if (PRO) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = prologue<T, RELU>(v[j], __ldg(p.scale + c + j),
                                 __ldg(p.shift + c + j));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = load_a<T, PRO, RELU>(p, x, pix, c + j);
}

// The products run mma.cuh's mma_16816<T> (m16n8k16, f32 accumulation), in
// the PTX ISA's fragment layout (lane = 4 g + t):
// a = {A[g][2t, 2t+1], A[g+8][2t, 2t+1], A[g][2t+8, 2t+9], A[g+8][2t+8, 2t+9]},
// b = {B[2t, 2t+1][g], B[2t+8, 2t+9][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}

// ---------------------------------------------------------------------------
// K5 / K7: y = a @ wt over the taps, with the stats epilogue
// ---------------------------------------------------------------------------

template <typename T, int TAPS, bool PRO, bool RELU, bool STATS>
__device__ __forceinline__ void conv_fwd_body(const ConvParams& p) {
  __shared__ __align__(16) float As[kBK][kLdA];   // a, transposed: [c][row]
  __shared__ __align__(16) float Bs[kBK][kLdB];   // wt: [c][k]
  __shared__ float red[2][kThreads / 16][kBN];    // stats across row groups
  const T* x = static_cast<const T*>(p.x);
  const T* wt = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: one row, 8 consecutive channels of the 16 a step
  const int a_row = tid % kBM;
  const int a_c = (tid / kBM) * 8;
  const RowOrigin origin = row_origin(p, m0 + a_row);
  // B loader: one channel row, 4 consecutive output channels
  const int b_row = tid / 16;
  const int b_n = (tid % 16) * 4;
  // compute: 8 rows x 4 output channels
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int c_steps = (p.C + kBK - 1) / kBK;
  const int steps = TAPS * c_steps;
  float ra[8], rb[4];

  auto load = [&](int step) {
    const int tap = step / c_steps;
    const int c0 = (step - tap * c_steps) * kBK;
    const int dh = TAPS == 9 ? tap / 3 : 0;
    const int dw = TAPS == 9 ? tap % 3 : 0;
    const long long pix = pixel(p, origin, dh, dw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ra[j] = load_a<T, PRO, RELU>(p, x, pix, c0 + a_c + j);
    const int c = c0 + b_row;
    const long long wrow = (static_cast<long long>(tap) * p.C + c) * p.K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + b_n + j;
      rb[j] = (c < p.C && n < p.K) ? to_float(wt[wrow + n]) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) As[a_c + j][a_row] = ra[j];
    *reinterpret_cast<float4*>(&Bs[b_row][b_n]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  load(0);
  store();
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (step + 1 < steps) {
      store();
      __syncthreads();
    }
  }

  T* y = static_cast<T*>(p.y);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.K) continue;
      y[static_cast<long long>(m) * p.K + n] = from_float<T>(acc[i][j]);
      s[j] += acc[i][j];
      ss[j] += acc[i][j] * acc[i][j];
    }
  }
  if (!STATS) return;
  // the block's partial sums: its 16 row groups in order, one thread a channel
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = s[j];
    red[1][ty][tx * 4 + j] = ss[j];
  }
  __syncthreads();
  if (tid < kBN) {
    const int n = n0 + tid;
    if (n < p.K) {
      float ts = 0.f, tss = 0.f;
      for (int g = 0; g < kThreads / 16; ++g) {
        ts += red[0][g][tid];
        tss += red[1][g][tid];
      }
      float* row = p.partial + static_cast<long long>(blockIdx.x) * 2 * p.K;
      row[n] = ts;
      row[p.K + n] = tss;
    }
  }
}

// The bf16 form of conv_fwd_body on the tensor cores (mma.sync, f32
// accumulation): the same tile of 128 rows x 64 output channels, 32 input
// channels a step, a and wt in shared memory in bf16 (the prologue's output
// is bf16 already, so nothing is rounded that the CUDA-core form keeps).
// The 8 warps own 32 rows x 32 channels each: 2 x 4 m16n8 products a k16.
// The stats sum each column over the warp's rows by a butterfly of
// shuffles (every lane ends with the same bits) and over the 4 row warps in
// order, so they repeat bit for bit.
template <typename T, int TAPS, bool PRO, bool RELU, bool STATS>
__device__ __forceinline__ void conv_fwd_body_tc(const ConvParams& p) {
  // the tiles hold T's 16-bit values
  __shared__ __align__(16) unsigned short As[kBM][kLdT];   // a: [row][c]
  __shared__ __align__(16) unsigned short Bs[kBN][kLdT];   // wt^T: [k][c]
  __shared__ float red[2][4][kBN];               // stats across row warps
  const T* x = static_cast<const T*>(p.x);
  const T* wt = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 1;   // rows wm * 32 .. + 31
  const int wn = warp & 1;    // output channels wn * 32 .. + 31
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: one row, 16 consecutive channels of the 32 a step
  const int a_row = tid >> 1;
  const int a_c = (tid & 1) * 16;
  const RowOrigin origin = row_origin(p, m0 + a_row);
  // B loader: one input channel (a lane), 8 consecutive output channels
  // (a warp), so the transposed stores of a warp fill one row of Bs
  const int b_c = tid & 31;
  const int b_n = (tid >> 5) * 8;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int c_steps = (p.C + kTK - 1) / kTK;
  const int steps = TAPS * c_steps;
  const bool vec_x = vec8(x, p.C);
  const bool vec_w = vec8(wt, p.K);
  uint32_t ra[8];
  uint32_t rb[4];   // wt's 8 output channels, packed pairs

  auto load = [&](int step) {
    const int tap = step / c_steps;
    const int c0 = (step - tap * c_steps) * kTK;
    const int dh = TAPS == 9 ? tap / 3 : 0;
    const int dw = TAPS == 9 ? tap % 3 : 0;
    const long long pix = pixel(p, origin, dh, dw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];
      load_a8<T, PRO, RELU>(p, x, pix, c0 + a_c + 8 * h, vec_x, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[4 * h + i] = pack2<T>(v[2 * i], v[2 * i + 1]);
    }
    const int c = c0 + b_c;
    const int nb = n0 + b_n;
    const long long wrow = (static_cast<long long>(tap) * p.C + c) * p.K;
    if (vec_w && c < p.C && nb + 8 <= p.K) {
      const uint4 u = ld8(wt, wrow + nb);
      rb[0] = u.x;
      rb[1] = u.y;
      rb[2] = u.z;
      rb[3] = u.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nb + 2 * i;
        const bool ok = c < p.C;
        rb[i] = pack2<T>(ok && n < p.K ? to_float(wt[wrow + n]) : 0.f,
                         ok && n + 1 < p.K ? to_float(wt[wrow + n + 1])
                                           : 0.f);
      }
    }
  };
  auto store = [&]() {
    uint4* dst = reinterpret_cast<uint4*>(&As[a_row][a_c]);
    dst[0] = make_uint4(ra[0], ra[1], ra[2], ra[3]);
    dst[1] = make_uint4(ra[4], ra[5], ra[6], ra[7]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Bs[b_n + 2 * i][b_c] = static_cast<unsigned short>(rb[i] & 0xffffu);
      Bs[b_n + 2 * i + 1][b_c] = static_cast<unsigned short>(rb[i] >> 16);
    }
  };

  load(0);
  store();
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1);   // in flight during the products
#pragma unroll
    for (int kb = 0; kb < kTK; kb += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = lds32(&As[r][kb + 2 * t]);
        af[mi][1] = lds32(&As[r + 8][kb + 2 * t]);
        af[mi][2] = lds32(&As[r][kb + 2 * t + 8]);
        af[mi][3] = lds32(&As[r + 8][kb + 2 * t + 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = wn * 32 + nj * 8 + g;
        bfr[nj][0] = lds32(&Bs[n][kb + 2 * t]);
        bfr[nj][1] = lds32(&Bs[n][kb + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_16816<T>(acc[mi][nj], af[mi], bfr[nj][0], bfr[nj][1]);
    }
    __syncthreads();
    if (step + 1 < steps) {
      store();
      __syncthreads();
    }
  }

  T* y = static_cast<T*>(p.y);
  // a thread's two adjacent output channels go out as one 4-byte store
  const bool pair_y = p.K % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0;
  float s[4][2], ss[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) s[nj][e] = ss[nj][e] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mi * 16 + g + h * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = n0 + wn * 32 + nj * 8 + 2 * t;
        const float v0 = acc[mi][nj][2 * h];
        const float v1 = acc[mi][nj][2 * h + 1];
        T* dst = y + static_cast<long long>(m) * p.K + n;
        if (pair_y && n + 1 < p.K) {
          *reinterpret_cast<uint32_t*>(dst) = pack2<T>(v0, v1);
        } else {
          if (n < p.K) dst[0] = from_float<T>(v0);
          if (n + 1 < p.K) dst[1] = from_float<T>(v1);
        }
        if (n < p.K) {
          s[nj][0] += v0;
          ss[nj][0] += v0 * v0;
        }
        if (n + 1 < p.K) {
          s[nj][1] += v1;
          ss[nj][1] += v1 * v1;
        }
      }
    }
  if (!STATS) return;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[nj][e] += __shfl_xor_sync(0xffffffffu, s[nj][e], off);
        ss[nj][e] += __shfl_xor_sync(0xffffffffu, ss[nj][e], off);
      }
  if (g == 0) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[0][wm][wn * 32 + nj * 8 + 2 * t + e] = s[nj][e];
        red[1][wm][wn * 32 + nj * 8 + 2 * t + e] = ss[nj][e];
      }
  }
  __syncthreads();
  if (tid < kBN) {
    const int n = n0 + tid;
    if (n < p.K) {
      float ts = 0.f, tss = 0.f;
      for (int w = 0; w < 4; ++w) {
        ts += red[0][w][tid];
        tss += red[1][w][tid];
      }
      float* row = p.partial + static_cast<long long>(blockIdx.x) * 2 * p.K;
      row[n] = ts;
      row[p.K + n] = tss;
    }
  }
}

// K5: 1x1 conv as a matmul (and the 1x1 input gradient) in f32 on the CUDA
// cores; in bf16 and float16 the body K5 had before conv1x1_tc_kernel, which
// chip_smoke.py times beside it and no path runs
template <typename T, bool PRO, bool RELU, bool STATS>
__global__ void __launch_bounds__(kThreads) conv1x1_kernel(ConvParams p) {
  if constexpr (sizeof(T) == 2)
    conv_fwd_body_tc<T, 1, PRO, RELU, STATS>(p);
  else
    conv_fwd_body<T, 1, PRO, RELU, STATS>(p);
}

// K7: NHWC 3x3 conv, stride 1 or 2, implicit im2col (and the 3x3 input
// gradient)
template <typename T, bool PRO, bool RELU, bool STATS>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(ConvParams p) {
  if constexpr (sizeof(T) == 2)
    conv_fwd_body_tc<T, 9, PRO, RELU, STATS>(p);
  else
    conv_fwd_body<T, 9, PRO, RELU, STATS>(p);
}

// ---------------------------------------------------------------------------
// K6 / K8: dw = a^T @ dy per tap over one range of rows (split-K)
// ---------------------------------------------------------------------------

template <typename T, int TAPS, bool PRO, bool RELU>
__device__ __forceinline__ void conv_wgrad_body(const ConvParams& p) {
  __shared__ __align__(16) float As[kWK][kLdW];   // a: [row][c]
  __shared__ __align__(16) float Bs[kWK][kLdW];   // dy: [row][k]
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int c_tiles = (p.C + kWM - 1) / kWM;
  const int tap = blockIdx.x / c_tiles;
  const int c0 = (blockIdx.x - tap * c_tiles) * kWM;
  const int n0 = blockIdx.y * kWN;
  const int dh = TAPS == 9 ? tap / 3 : 0;
  const int dw = TAPS == 9 ? tap % 3 : 0;
  const int m_begin = blockIdx.z * p.rows_per_split;
  const int m_end = min(p.M, m_begin + p.rows_per_split);

  // loaders: one row, 4 consecutive channels of each tile
  const int l_row = tid / 16;
  const int l_c = (tid % 16) * 4;
  // compute: 4 input channels x 4 output channels
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  auto load = [&](int mb) {
    const int m = mb + l_row;
    RowOrigin o = row_origin(p, m);
    o.valid = o.valid && m < m_end;
    const long long pix = pixel(p, o, dh, dw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ra[j] = load_a<T, PRO, RELU>(p, x, pix, c0 + l_c + j);
    const bool row_ok = m < m_end;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + l_c + j;
      rb[j] = (row_ok && n < p.K)
                  ? to_float(dy[static_cast<long long>(m) * p.K + n])
                  : 0.f;
    }
  };
  auto store = [&]() {
    *reinterpret_cast<float4*>(&As[l_row][l_c]) =
        make_float4(ra[0], ra[1], ra[2], ra[3]);
    *reinterpret_cast<float4*>(&Bs[l_row][l_c]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  if (m_begin < m_end) {
    load(m_begin);
    store();
    __syncthreads();
    for (int mb = m_begin; mb < m_end; mb += kWK) {
      const bool more = mb + kWK < m_end;
      if (more) load(mb + kWK);
#pragma unroll
      for (int r = 0; r < kWK; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
      if (more) {
        store();
        __syncthreads();
      }
    }
  }

  // this split's partial dw: [split][tap * C + c][k], zeros for an empty range
  float* out = static_cast<float*>(p.y) +
               static_cast<long long>(blockIdx.z) * TAPS * p.C * p.K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= p.C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.K)
        out[(static_cast<long long>(tap) * p.C + c) * p.K + n] = acc[i][j];
    }
  }
}

// The bf16 form of conv_wgrad_body on the tensor cores: the same tile of 64
// input channels of one tap x 64 output channels, 32 rows a step, a and dy
// in shared memory in bf16 and transposed (rows along the reduction). The 8
// warps own 16 channels x 32 output channels each: 4 m16n8 products a k16.
template <typename T, int TAPS, bool PRO, bool RELU>
__device__ __forceinline__ void conv_wgrad_body_tc(const ConvParams& p) {
  __shared__ __align__(16) T As[kWM][kLdT];   // a, transposed: [c][row]
  __shared__ __align__(16) T Bs[kWN][kLdT];   // dy, transposed: [k][row]
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wc = warp >> 1;   // input channels wc * 16 .. + 15
  const int wn = warp & 1;    // output channels wn * 32 .. + 31
  const int c_tiles = (p.C + kWM - 1) / kWM;
  const int tap = blockIdx.x / c_tiles;
  const int c0 = (blockIdx.x - tap * c_tiles) * kWM;
  const int n0 = blockIdx.y * kWN;
  const int dh = TAPS == 9 ? tap / 3 : 0;
  const int dw = TAPS == 9 ? tap % 3 : 0;
  const int m_begin = blockIdx.z * p.rows_per_split;
  const int m_end = min(p.M, m_begin + p.rows_per_split);

  // loaders: one row (a lane), 8 consecutive channels of each tile (a
  // warp), so the transposed stores of a warp fill one row of As and Bs
  const int l_row = tid & 31;
  const int l_c = (tid >> 5) * 8;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const bool vec_x = vec8(x, p.C);
  const bool vec_dy = vec8(dy, p.K);
  float ra[8], rb[8];
  auto load = [&](int mb) {
    const int m = mb + l_row;
    RowOrigin o = row_origin(p, m);
    o.valid = o.valid && m < m_end;
    load_a8<T, PRO, RELU>(p, x, pixel(p, o, dh, dw), c0 + l_c, vec_x, ra);
    const bool row_ok = m < m_end;
    const int nb = n0 + l_c;
    const long long off = static_cast<long long>(m) * p.K + nb;
    if (vec_dy && row_ok && nb + 8 <= p.K) {
      const uint4 u = ld8(dy, off);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack2<T>(w[i]);
        rb[2 * i] = f.x;
        rb[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rb[j] = row_ok && nb + j < p.K ? to_float(dy[off + j]) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      As[l_c + j][l_row] = from_float<T>(ra[j]);
      Bs[l_c + j][l_row] = from_float<T>(rb[j]);
    }
  };

  if (m_begin < m_end) {
    load(m_begin);
    store();
    __syncthreads();
    for (int mb = m_begin; mb < m_end; mb += kTK) {
      const bool more = mb + kTK < m_end;
      if (more) load(mb + kTK);
#pragma unroll
      for (int kb = 0; kb < kTK; kb += 16) {
        const int r = wc * 16 + g;
        const uint32_t af[4] = {lds32(&As[r][kb + 2 * t]),
                                lds32(&As[r + 8][kb + 2 * t]),
                                lds32(&As[r][kb + 2 * t + 8]),
                                lds32(&As[r + 8][kb + 2 * t + 8])};
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int n = wn * 32 + nj * 8 + g;
          const uint32_t bfr[2] = {lds32(&Bs[n][kb + 2 * t]),
                                   lds32(&Bs[n][kb + 2 * t + 8])};
          mma_16816<T>(acc[nj], af, bfr[0], bfr[1]);
        }
      }
      __syncthreads();
      if (more) {
        store();
        __syncthreads();
      }
    }
  }

  float* out = static_cast<float*>(p.y) +
               static_cast<long long>(blockIdx.z) * TAPS * p.C * p.K;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + wc * 16 + g + h * 8;
    if (c >= p.C) continue;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn * 32 + nj * 8 + 2 * t + e;
        if (n < p.K)
          out[(static_cast<long long>(tap) * p.C + c) * p.K + n] =
              acc[nj][2 * h + e];
      }
  }
}

// K6: the 1x1 weight gradient; bf16 and float16 on the tensor cores
template <typename T, bool PRO, bool RELU>
__global__ void __launch_bounds__(kThreads) conv1x1_wgrad_kernel(ConvParams p) {
  if constexpr (sizeof(T) == 2)
    conv_wgrad_body_tc<T, 1, PRO, RELU>(p);
  else
    conv_wgrad_body<T, 1, PRO, RELU>(p);
}

// K8 in float32 (CUDA cores, one block per tap), and in bf16 the body K8 had
// before conv3x3_wgrad_tc_kernel below (one block per tap on the tensor
// cores), which chip_smoke.py times beside it and no path runs
template <typename T, bool PRO, bool RELU>
__global__ void __launch_bounds__(kThreads) conv3x3_wgrad_kernel(ConvParams p) {
  if constexpr (sizeof(T) == 2)
    conv_wgrad_body_tc<T, 9, PRO, RELU>(p);
  else
    conv_wgrad_body<T, 9, PRO, RELU>(p);
}

// ---------------------------------------------------------------------------
// K8 on the tensor cores, all nine taps in one block (bf16 and float16)
// ---------------------------------------------------------------------------
//
// A block owns 64 input channels x 64 output channels of dw for all nine
// taps, [9][64][64] f32 in registers (12 warps: warp w owns channels
// 16 (w & 3) .. + 15 of taps 3 (w >> 2) .. + 2, the row dh = w >> 2, and
// all 64 output channels, 96 accumulators a thread), and walks a range of
// bands. A band is band_n
// images x band_h output rows x band_w output columns (at most 256 output
// pixels; band_n > 1 only for whole small images). For each band the block
// copies the window of x under each of its images, with its halo
// ((band_h - 1) s + 3 rows x (band_w - 1) s + 3 columns, the padding
// zero-filled), and the band's dy rows into shared memory by cp.async,
// applies the prologue once to each x element of the window (padding stays
// 0, as in _c3_prologue; two channels an instruction, in x's type), and then
// for each 16 output pixels of the band reads dy's B fragments once and each
// tap's A fragments (a^T at pixel offset (dh, dw)) by ldmatrix.trans: a lane
// gives the address of its own pixel, so the tap's gather costs nothing. At
// stride 2 the window's even and odd columns are kept as two runs, so that
// the 8 pixels of an ldmatrix read are adjacent in shared memory (distinct
// banks) for every tap. Two buffers: the next band's copies are in flight
// during this band's products.
//
// Why these sizes. One block runs an SM (its shared memory and
// registers). 12 warps of 96 accumulators ran 5-15% faster than 8 warps of
// 144 (all nine taps, 32 output channels a warp) at every ResNet-50 shape,
// the same ldmatrix reads a step for the block (a warp: 4 of dy, 3 of a,
// for 24 products) and more warps to hide their latency. The bands are as
// large as two buffers allow under 200 KB (conv.py's wgrad_bands), which
// amortises the halo (a 56^2 band of 4 rows reads 6 rows of x) and the
// per-band barriers over up to 16 steps of 16 pixels; small images go
// several to a band. The split gives at most two waves of these blocks.

constexpr int kFC = 64;         // input channels of a K8 block
constexpr int kFK = 64;         // output channels of a K8 block
constexpr int kFLd = 72;        // padded pixel row in smem, in 16-bit values
constexpr int kFMaxPix = 256;   // output pixels a band may hold

struct BandParams {
  int band_n, band_h, band_w;   // images, output rows, columns of a band
  int n_bn, n_bh, n_bw;         // bands across the batch, down, across
  int bands;                    // n_bn * n_bh * n_bw
  int per_split;                // consecutive bands a split walks
  int win_h, win_w;             // one image's window under a full band
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// one buffer: the windows' pixels, then the band's dy rows, kFLd values each
__host__ __device__ inline int band_buffer_values(const BandParams& b) {
  return (b.band_n * b.win_h * b.win_w +
          round16(b.band_n * b.band_h * b.band_w)) * kFLd;
}

// two buffers, then the prologue's scale and shift: f32 [64] each and as
// packed pairs [32] each
__host__ inline size_t band_smem_bytes(const BandParams& b) {
  return 2 * sizeof(unsigned short) * band_buffer_values(b) +
         2 * kFC * sizeof(float) + kFC * sizeof(unsigned);
}

// smem pixel index of window pixel (r, c): at stride 2 the even columns,
// then the odd ones, of each window row
__device__ __forceinline__ int win_index(int r, int c, int win_w, int stride) {
  return r * win_w + (stride == 2 ? (c & 1) * ((win_w + 1) >> 1) + (c >> 1)
                                  : c);
}

// act(w * sc + sh) on a pair of T values, each operation rounded to T (the
// product of two T values is exact in f32, so one rounding of it equals
// prologue()'s two), as prologue() computes each. The _rn forms: a plain
// mul and add of pairs may be contracted into one fma, which rounds once
// where the TPU kernel rounds twice (a quarter of the values differ).
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct Pair<__half> {
  using type = __half2;
};

template <typename T, bool RELU>
__device__ __forceinline__ unsigned prologue2(unsigned w, unsigned sc,
                                              unsigned sh) {
  using P = typename Pair<T>::type;
  P x, a, b;
  *reinterpret_cast<unsigned*>(&x) = w;
  *reinterpret_cast<unsigned*>(&a) = sc;
  *reinterpret_cast<unsigned*>(&b) = sh;
  P y = __hadd2_rn(__hmul2_rn(x, a), b);
  if (RELU) {
    P z;
    *reinterpret_cast<unsigned*>(&z) = 0u;
    y = __hmax2(y, z);
  }
  return *reinterpret_cast<unsigned*>(&y);
}

constexpr int kFThreads = 384;   // 12 warps: 3 tap groups x 4 channel tiles

template <typename T, bool PRO, bool RELU>
__global__ void __launch_bounds__(kFThreads, 1)
    conv3x3_wgrad_tc_kernel(const ConvParams p, const BandParams bp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned short* sbuf = reinterpret_cast<unsigned short*>(smem_raw);
  const int buf_vals = band_buffer_values(bp);
  float* sScale = reinterpret_cast<float*>(sbuf + 2 * buf_vals);   // [64]
  float* sShift = sScale + kFC;                                     // [64]
  unsigned* sSc2 = reinterpret_cast<unsigned*>(sShift + kFC);       // [32]
  unsigned* sSh2 = sSc2 + kFC / 2;                                  // [32]
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wc = warp & 3;    // channels wc * 16 .. + 15 of the tile
  const int tg = warp >> 2;   // taps 3 tg .. 3 tg + 2
  const int c0 = blockIdx.x * kFC;
  const int k0 = blockIdx.y * kFK;
  const int s = p.stride;
  const int img_px = bp.win_h * bp.win_w;   // one image's window
  const bool vec_x = vec8(x, p.C);
  const bool vec_dy = vec8(dy, p.K);
  const int band0 = blockIdx.z * bp.per_split;
  const int n_bands = max(0, min(bp.bands, band0 + bp.per_split) - band0);

  if (PRO) {
    for (int i = tid; i < kFC; i += kFThreads) {
      const bool in = c0 + i < p.C;
      sScale[i] = in ? p.scale[c0 + i] : 0.f;
      sShift[i] = in ? p.shift[c0 + i] : 0.f;
    }
    for (int i = tid; i < kFC / 2; i += kFThreads) {
      const int c = c0 + 2 * i;
      sSc2[i] = pack2<T>(c < p.C ? p.scale[c] : 0.f,
                         c + 1 < p.C ? p.scale[c + 1] : 0.f);
      sSh2[i] = pack2<T>(c < p.C ? p.shift[c] : 0.f,
                         c + 1 < p.C ? p.shift[c + 1] : 0.f);
    }
  }

  // band b's first image, row and column, and its size
  struct Band {
    int n0, nn, ho0, wo0, bh, bw;
  };
  auto band_of = [&](int b) {
    Band r;
    const int per_n = bp.n_bh * bp.n_bw;
    const int bn = b / per_n;
    const int rem = b - bn * per_n;
    const int hb = rem / bp.n_bw;
    r.n0 = bn * bp.band_n;
    r.nn = min(bp.band_n, p.N - r.n0);
    r.ho0 = hb * bp.band_h;
    r.wo0 = (rem - hb * bp.n_bw) * bp.band_w;
    r.bh = min(bp.band_h, p.Ho - r.ho0);
    r.bw = min(bp.band_w, p.Wo - r.wo0);
    return r;
  };
  // A thread walks the window pixels tid / 8, then every 32nd (its 8
  // channels fixed, (tid & 7) * 8), and the dy rows the same way: the
  // (image, row, column) of each by steps, with no division in the loop.
  constexpr int kStep = kFThreads / 8;
  struct Cursor {
    int ni, r, c;
  };
  auto cursor = [&](int i, int cols, int per_img) {
    Cursor q;
    q.ni = i / per_img;
    const int pi = i - q.ni * per_img;
    q.r = pi / cols;
    q.c = pi - q.r * cols;
    return q;
  };
  auto advance = [&](Cursor& q, int cols, int rows, int step) {
    q.c += step;
    while (q.c >= cols) {
      q.c -= cols;
      if (++q.r == rows) {
        q.r = 0;
        ++q.ni;
      }
    }
  };
  // the window pixel at q of band bd: its x offset (elements), or -1
  // outside x; its smem pixel index
  auto win_src = [&](const Band& bd, const Cursor& q, int& at) -> long long {
    at = q.ni * img_px + win_index(q.r, q.c, bp.win_w, s);
    const int hi = bd.ho0 * s - 1 + q.r;
    const int wi = bd.wo0 * s - 1 + q.c;
    if (q.ni >= bd.nn || hi < 0 || hi >= p.H || wi < 0 || wi >= p.W)
      return -1;
    return ((static_cast<long long>(bd.n0 + q.ni) * p.H + hi) * p.W + wi) *
           p.C;
  };
  // band bd's x windows and dy rows into buffer buf: cp.async where the rows
  // allow 16-byte copies (the prologue follows in apply_prologue), else
  // element by element with the prologue applied here
  auto load_band = [&](const Band& bd, int buf) {
    unsigned short* sX = sbuf + buf * buf_vals;
    unsigned short* sDy = sX + bp.band_n * img_px * kFLd;
    const int ch = (tid & 7) * 8;
    Cursor q = cursor(tid >> 3, bp.win_w, img_px);
    for (int px = tid >> 3; px < bd.nn * img_px;
         px += kStep, advance(q, bp.win_w, bp.win_h, kStep)) {
      int at;
      const long long off = win_src(bd, q, at);
      unsigned short* dst = sX + at * kFLd + ch;
      const int cc = c0 + ch;
      if (vec_x) {
        const bool in = off >= 0 && cc < p.C;
        cp_async16(dst, in ? static_cast<const void*>(x + off + cc) : x, in);
      } else {
        unsigned w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ce = cc + 2 * j + e;
            v[e] = 0.f;
            if (off >= 0 && ce < p.C) {
              v[e] = to_float(x[off + ce]);
              if (PRO)
                v[e] = prologue<T, RELU>(v[e], sScale[ce - c0],
                                         sShift[ce - c0]);
            }
          }
          w[j] = pack2<T>(v[0], v[1]);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    const int img_rows = bd.bh * bd.bw;
    const int rows = bd.nn * img_rows;
    Cursor d = cursor(tid >> 3, bd.bw, img_rows);
    for (int m = tid >> 3; m < round16(rows);
         m += kStep, advance(d, bd.bw, bd.bh, kStep)) {
      unsigned short* dst = sDy + m * kFLd + ch;
      const int kk = k0 + ch;
      long long off = -1;
      if (m < rows)
        off = ((static_cast<long long>(bd.n0 + d.ni) * p.Ho + bd.ho0 + d.r) *
                   p.Wo + bd.wo0 + d.c) * p.K;
      if (vec_dy) {
        const bool in = off >= 0 && kk < p.K;
        cp_async16(dst, in ? static_cast<const void*>(dy + off + kk) : dy, in);
      } else {
        unsigned w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k1 = kk + 2 * j;
          w[j] = pack2<T>(off >= 0 && k1 < p.K ? to_float(dy[off + k1]) : 0.f,
                          off >= 0 && k1 + 1 < p.K ? to_float(dy[off + k1 + 1])
                                                   : 0.f);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    cp_async_commit();
  };
  // the prologue, once per x element of the windows (cp.async path): the
  // padding and the channels past C stay 0
  auto apply_prologue = [&](const Band& bd, int buf) {
    unsigned short* sX = sbuf + buf * buf_vals;
    const int ch = (tid & 7) * 8;
    if (c0 + ch >= p.C) return;
    const int q2 = ch / 2;
    Cursor q = cursor(tid >> 3, bp.win_w, img_px);
    for (int px = tid >> 3; px < bd.nn * img_px;
         px += kStep, advance(q, bp.win_w, bp.win_h, kStep)) {
      int at;
      if (win_src(bd, q, at) < 0) continue;
      uint4* ptr = reinterpret_cast<uint4*>(sX + at * kFLd + ch);
      const uint4 u = *ptr;
      *ptr = make_uint4(prologue2<T, RELU>(u.x, sSc2[q2], sSh2[q2]),
                        prologue2<T, RELU>(u.y, sSc2[q2 + 1], sSh2[q2 + 1]),
                        prologue2<T, RELU>(u.z, sSc2[q2 + 2], sSh2[q2 + 2]),
                        prologue2<T, RELU>(u.w, sSc2[q2 + 3], sSh2[q2 + 3]));
    }
  };

  float acc[3][8][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  // the warp's taps' pixel offsets in the window layout
  int tap_off[3];
#pragma unroll
  for (int t = 0; t < 3; ++t)
    tap_off[t] = win_index(tg, t, bp.win_w, s);

  if (PRO) __syncthreads();   // the scale and shift tables are whole
  if (n_bands > 0) load_band(band_of(band0), 0);
  for (int it = 0; it < n_bands; ++it) {
    const Band bd = band_of(band0 + it);
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();   // band it has landed; every warp is done with it - 1
    if (PRO && vec_x) {
      apply_prologue(bd, buf);
      __syncthreads();
    }
    if (it + 1 < n_bands) load_band(band_of(band0 + it + 1), buf ^ 1);

    const unsigned short* sX = sbuf + buf * buf_vals;
    const unsigned short* sDy = sX + bp.band_n * img_px * kFLd;
    const int img_rows = bd.bh * bd.bw;
    const int rows = bd.nn * img_rows;
    // the lane's pixel of the A fragments, 16 further at each step
    Cursor am = cursor((lane >> 4) * 8 + (lane & 7), bd.bw, img_rows);
    for (int m0 = 0; m0 < rows; m0 += 16, advance(am, bd.bw, bd.bh, 16)) {
      // dy's B fragments: 16 pixels x the 64 output channels
      unsigned bq[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldmatrix_x4_trans(
            bq[np], sDy + (m0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kFLd +
                        np * 16 + (lane >> 4) * 8);
      // (a row past the band reads pixel 0, finite, against dy's zero
      // rows)
      const int base = m0 + (lane >> 4) * 8 + (lane & 7) < rows
                           ? am.ni * img_px + am.r * s * bp.win_w + am.c
                           : 0;
      const unsigned short* arow =
          sX + base * kFLd + wc * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        unsigned a[4];
        ldmatrix_x4_trans(a, arow + tap_off[t] * kFLd);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_16816<T>(acc[t][nt], a, bq[nt >> 1][2 * (nt & 1)],
                       bq[nt >> 1][2 * (nt & 1) + 1]);
      }
    }
  }

  // this split's partial dw: [split][tap][C][K] (dw itself for one split)
  float* out = static_cast<float*>(p.y) +
               static_cast<long long>(blockIdx.z) * 9 * p.C * p.K;
  const bool pair = (p.K & 1) == 0;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wc * 16 + g + 8 * h;
      if (c >= p.C) continue;
      float* row = out + (static_cast<long long>(3 * tg + t) * p.C + c) * p.K;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = k0 + nt * 8 + 2 * tq;
        const float v0 = acc[t][nt][2 * h];
        const float v1 = acc[t][nt][2 * h + 1];
        if (pair && n + 1 < p.K) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < p.K) row[n] = v0;
          if (n + 1 < p.K) row[n + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------------
// K7 on the tensor cores: bands of output pixels under one window (bf16 and
// float16)
// ---------------------------------------------------------------------------
//
// Replaces _c3_kernel (:311, launched by _c3 at :364) in 16 bits, and the
// stride-2 dgrad that conv2d_dgrad (:513-556) runs through it on the zero-
// dilated dy. It is _c3's band the other way round from K8: a block owns a
// band of output pixels (band_n images x band_h rows x band_w columns, at
// most 256 pixels; band_n > 1 only for whole small images) x 64 output
// channels, and walks the input channels 32 a step. The blocks are
// persistent (one an SM) and walk the items (band, channel tile) in turn;
// each item is summed by one block in a fixed order, whatever the grid, so
// the results repeat bit for bit. A block's warps split into two roles,
// which hand two buffers to each other through named barriers:
// - 4 copy warps copy, by cp.async in 16-byte pieces, each step's window of
//   x under the band with its halo (the padding zero-filled) and its tap
//   slices of wt ([tap][32][64]) into a free buffer, then apply the
//   prologue once to each x element they copied (two channels an
//   instruction in x's type, the _rn forms; the padding stays 0, as in
//   _c3_prologue), and mark the buffer full;
// - the product warps (64 pixels x kCWarpN channels each) read, for each
//   tap, the A fragments by ldmatrix, each lane giving the address of its
//   own pixel at the tap's offset in the window (so the tap's gather costs
//   nothing), and the weights' B fragments by ldmatrix.trans, the next
//   k-step's fragments while this one's products run; after an item's
//   last step they write y rounded from the f32 accumulator and, for the
//   forward, the band's per-channel (sum, sumsq) of the accumulator (the
//   warp butterfly, then the 4 pixel warps in order) into its row of
//   partial, for reduce_rows.
// So the copies, the prologue and the epilogue of one step run beside the
// products of another. At stride 2 the window's even and odd columns are
// kept as two runs (win_index), so the 8 pixels of an ldmatrix read lie in
// distinct banks.
//
// The stride-2 dgrad by phases (phases == 4). dx pixel (i, j) of phase (ph,
// pw) = (i & 1, j & 1) meets a nonzero entry of the dilated dy only at the
// taps dh = 1 (ph = 0) or dh in {0, 2} (ph = 1), and likewise dw: 1, 2, 2 or
// 4 taps, 9 a 2 x 2 block of pixels where the dilated form takes 36. Phase
// (ph, pw) is a stride-1 window over dy itself: its pixel (a, b) = dx pixel
// (2a + ph, 2b + pw) sums dy[a + jr, b + jc] x wt[3 dh + dw] over its taps
// (jr, jc) in the dilated form's order (dh = ph ? 2 jr : 1). The four phases
// are items of one launch (the 4-tap phase first), so no dilated dy is
// built; rows and columns of a phase past dy are the dilated form's zero
// padding, and a phase of a 1-row (1-column) dx is empty.
//
// What bounds it. At ResNet-50's 3x3 shapes (B = 256) the work is 5.9e10
// FLOPs a launch against 0.06-0.2 GB: the FLOPs bound it (0.06 ms at 989
// TFLOP/s), except at 56^2 where the bytes are as large. mma.sync reaches a
// part of that rate only. A product warp reads 4 ldmatrix of A and 4 of B
// for 32 products (64 x 64 channels, 128 accumulators: 4 warps of 64 x 64
// ran faster than 8 of 64 x 32 at every ResNet-50 shape); the copy warps'
// prologue pass slows the products beside it (the same body ran faster
// with no prologue), though neither role waits on the other; the epilogue
// stands between an item's products and the next (a large share at 56^2,
// where an item is two steps); and whole-row bands leave part of the
// 256-pixel tile empty (196 pixels at 14^2 and at stride 2).

constexpr int kCN = 64;          // output channels of a block
constexpr int kCWarpN = 64;      // output channels a product warp
constexpr int kCNT = kCWarpN / 8;           // its m16n8 tiles across
constexpr int kCWarpsN = kCN / kCWarpN;     // product warps across
constexpr int kCConsumers = 4 * kCWarpsN * 32;   // 4 product warps, one a
                                                 // 64-pixel group
constexpr int kCProducers = 128;   // 4 copy warps
constexpr int kCThreads = kCConsumers + kCProducers;
constexpr int kCPix = 256;       // output pixels a band may hold
constexpr int kCK = 32;          // input channels a step
constexpr int kCLdX = kCK + 8;   // padded window pixel: 80 bytes
constexpr int kCLdW = kCN + 8;   // padded weight row: 144 bytes
constexpr int kCWVals = 9 * kCK * kCLdW;   // a buffer's nine tap slices
constexpr int kCRedBytes = 2 * 4 * kCN * sizeof(float);
// named barriers (0 is __syncthreads): buffer b full, buffer b empty, and
// the product warps' own for the stats
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;
constexpr int kBarStats = 5;
static_assert(kCK * 8 == 2 * kCProducers, "two weight pieces a copy thread");

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

struct WinParams {
  const void* x;        // the window's source [N, H, W, C]: x, or dy
  const void* w;        // taps [9, C, K]
  const float* scale;   // [C] or null
  const float* shift;
  void* y;              // [N, Hy, Wy, K]
  float* partial;       // stats: [bands, 2K] f32, or null
  int N, H, W, C;
  int K;
  int Hy, Wy;
  int stride;           // the forward's stride; 2 with phases == 4
  int phases;           // 1: the forward (nine taps, padding 1); 4: by phase
  int band_n, band_h, band_w;   // a band: images, rows, columns
  int n_bn, n_bh, n_bw;         // bands across the batch, down, across
  int bands;
  int win_h, win_w;     // one image's window under a full band
  int n_tiles;          // ceil(K / 64)
  int items;            // phases * bands * n_tiles
};

__host__ __device__ inline int win_buffer_values(const WinParams& w) {
  return kCWVals + w.band_n * w.win_h * w.win_w * kCLdX;
}

// two buffers of tap slices and windows, then the stats' cross-warp sums
__host__ inline size_t win_smem_bytes(const WinParams& w) {
  return 2 * sizeof(unsigned short) * win_buffer_values(w) + kCRedBytes;
}

// One item of the K7 walk: phase (ph, pw), the band's images, rows and
// columns (clipped to the phase's grid), its output channel tile
struct WinItem {
  int ph, pw, n0, nn, ho0, bh, wo0, bw, k0, band;
};

// item i of the walk: phase-major (the 4-tap phase first), then band, then
// channel tile; false for a band past its phase's grid
__device__ __forceinline__ bool win_item(const WinParams& p, int i,
                                         WinItem& it) {
  const bool phased = p.phases == 4;
  const int per_phase = p.bands * p.n_tiles;
  const int pi = i / per_phase;
  const int rem = i - pi * per_phase;
  it.band = rem / p.n_tiles;
  it.k0 = (rem - it.band * p.n_tiles) * kCN;
  const int phase = phased ? 3 - pi : 0;
  it.ph = phase >> 1;
  it.pw = phase & 1;
  const int per_n = p.n_bh * p.n_bw;
  const int bn = it.band / per_n;
  const int r2 = it.band - bn * per_n;
  const int hb = r2 / p.n_bw;
  it.n0 = bn * p.band_n;
  it.nn = min(p.band_n, p.N - it.n0);
  it.ho0 = hb * p.band_h;
  it.wo0 = (r2 - hb * p.n_bw) * p.band_w;
  const int hp = phased ? (p.Hy - it.ph + 1) >> 1 : p.Hy;
  const int wp = phased ? (p.Wy - it.pw + 1) >> 1 : p.Wy;
  it.bh = min(p.band_h, hp - it.ho0);
  it.bw = min(p.band_w, wp - it.wo0);
  return it.bh > 0 && it.bw > 0;
}

// the block's first item at or after i (its items are i, i + gridDim.x, ...)
__device__ __forceinline__ int win_next(const WinParams& p, int i,
                                        WinItem& it) {
  while (i < p.items && !win_item(p, i, it)) i += gridDim.x;
  return i;
}

// The copy warps: each step's tap slices and windows into a free buffer by
// cp.async (element by element, the prologue applied, where rows do not
// allow 16-byte copies), then the prologue once per x element on the pieces
// the thread copied, then the buffer is handed to the product warps
template <typename T, bool PRO, bool RELU>
__device__ __forceinline__ void win_producer(const WinParams& p,
                                             unsigned short* sbuf,
                                             int buf_vals) {
  const T* x = static_cast<const T*>(p.x);
  const T* wt = static_cast<const T*>(p.w);
  const int ptid = threadIdx.x - kCConsumers;
  const bool phased = p.phases == 4;
  const int s = phased ? 1 : p.stride;
  const int pad = phased ? 0 : 1;
  const int img_px = p.win_h * p.win_w;
  const int n_chunks = (p.C + kCK - 1) / kCK;
  const bool vec_x = vec8(x, p.C);
  const bool vec_w = vec8(wt, p.K);
  // the thread's 8 window channels of a step, and its pixels: a warp takes
  // 8 consecutive pixels x the 4 parts, lane & 7 the pixel, so the 8 16-byte
  // pieces of a quarter-warp lie in distinct banks (80-byte pixel rows);
  // then every 32nd pixel, walked by (image, row, column) steps
  const int part = (ptid >> 3) & 3;
  const int px0 = ((ptid >> 5) << 3) | (ptid & 7);
  constexpr int kStep = kCProducers / 4;
  struct Cursor {
    int ni, r, c;
  };
  auto cursor = [&](int i) {
    Cursor q;
    q.ni = i / img_px;
    const int pi = i - q.ni * img_px;
    q.r = pi / p.win_w;
    q.c = pi - q.r * p.win_w;
    return q;
  };
  auto advance = [&](Cursor& q) {
    q.c += kStep;
    while (q.c >= p.win_w) {
      q.c -= p.win_w;
      if (++q.r == p.win_h) {
        q.r = 0;
        ++q.ni;
      }
    }
  };

  WinItem it;
  int ci = win_next(p, blockIdx.x, it);
  int cb = 0;
  int step = 0;
  while (ci < p.items) {
    const int b = step & 1;
    // buffer b is free once the product warps are done with step - 2
    if (step >= 2) named_sync(kBarEmpty + b, kCThreads);
    unsigned short* sW = sbuf + b * buf_vals;
    unsigned short* sX = sW + kCWVals;
    const int c0 = cb * kCK;
    // the tap slices: slot j (in the item's tap order), input channel row
    // r, 8 output channels
    const int nc = phased ? 1 + it.pw : 3;
    const int ntaps = phased ? (1 + it.ph) * nc : 9;
    for (int q = ptid; q < ntaps * kCK * 8; q += kCProducers) {
      const int j = q >> 8;
      const int r = (q >> 3) & (kCK - 1);
      const int wpart = q & 7;
      const int jr = j / nc;
      const int jc = j - jr * nc;
      const int dh = phased ? (it.ph ? 2 * jr : 1) : jr;
      const int dw = phased ? (it.pw ? 2 * jc : 1) : jc;
      const int c = c0 + r;
      const int n = it.k0 + wpart * 8;
      unsigned short* dst = sW + (j * kCK + r) * kCLdW + wpart * 8;
      const long long off =
          (static_cast<long long>(dh * 3 + dw) * p.C + c) * p.K + n;
      if (vec_w) {
        const bool in = c < p.C && n < p.K;
        cp_async16(dst, in ? static_cast<const void*>(wt + off) : wt, in);
      } else {
        unsigned w4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n1 = n + 2 * e;
          const bool ok = c < p.C;
          w4[e] = pack2<T>(ok && n1 < p.K ? to_float(wt[off + 2 * e]) : 0.f,
                           ok && n1 + 1 < p.K ? to_float(wt[off + 2 * e + 1])
                                              : 0.f);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w4[0], w4[1], w4[2],
                                                    w4[3]);
      }
    }
    // the windows (padding and channels past C zero-filled)
    const int cc = c0 + part * 8;
    const int row0 = it.ho0 * s - pad;
    const int col0 = it.wo0 * s - pad;
    Cursor q = cursor(px0);
    for (int px = px0; px < it.nn * img_px; px += kStep, advance(q)) {
      unsigned short* dst =
          sX + (q.ni * img_px + win_index(q.r, q.c, p.win_w, s)) * kCLdX +
          part * 8;
      const int hi = row0 + q.r;
      const int wi = col0 + q.c;
      const bool pix = hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
      const long long off =
          ((static_cast<long long>(it.n0 + q.ni) * p.H + hi) * p.W + wi) *
          p.C;
      if (vec_x) {
        const bool in = pix && cc < p.C;
        cp_async16(dst, in ? static_cast<const void*>(x + off + cc) : x, in);
      } else {
        unsigned w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ce = cc + 2 * j + e;
            v[e] = 0.f;
            if (pix && ce < p.C) {
              v[e] = to_float(x[off + ce]);
              if (PRO)
                v[e] = prologue<T, RELU>(v[e], __ldg(p.scale + ce),
                                         __ldg(p.shift + ce));
            }
          }
          w4[j] = pack2<T>(v[0], v[1]);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w4[0], w4[1], w4[2],
                                                    w4[3]);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    if (PRO && vec_x && cc < p.C) {
      // the prologue on the pieces this thread copied: the padding and
      // channels past C stay 0
      unsigned sc2[4], sh2[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc2[e] = pack2<T>(__ldg(p.scale + cc + 2 * e),
                          __ldg(p.scale + cc + 2 * e + 1));
        sh2[e] = pack2<T>(__ldg(p.shift + cc + 2 * e),
                          __ldg(p.shift + cc + 2 * e + 1));
      }
      Cursor q2 = cursor(px0);
      for (int px = px0; px < it.nn * img_px; px += kStep, advance(q2)) {
        const int hi = row0 + q2.r;
        const int wi = col0 + q2.c;
        if (hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) continue;
        uint4* ptr = reinterpret_cast<uint4*>(
            sX + (q2.ni * img_px + win_index(q2.r, q2.c, p.win_w, s)) *
                     kCLdX +
            part * 8);
        const uint4 u = *ptr;
        *ptr = make_uint4(prologue2<T, RELU>(u.x, sc2[0], sh2[0]),
                          prologue2<T, RELU>(u.y, sc2[1], sh2[1]),
                          prologue2<T, RELU>(u.z, sc2[2], sh2[2]),
                          prologue2<T, RELU>(u.w, sc2[3], sh2[3]));
      }
    }
    named_arrive(kBarFull + b, kCThreads);
    ++step;
    if (++cb == n_chunks) {
      cb = 0;
      ci = win_next(p, ci + gridDim.x, it);
    }
  }
  // match the product warps' last two arrivals on the empty barriers
  for (int j = max(step, 2); j < step + 2; ++j)
    named_sync(kBarEmpty + (j & 1), kCThreads);
}

// The product warps: for each step and tap, A by ldmatrix at the lane's
// pixel plus the tap's offset, B by ldmatrix.trans, m16n8k16 products into
// 64 pixels x 32 channels a warp; after an item's last step, y and the
// stats
template <typename T, bool STATS>
__device__ __forceinline__ void win_consumer(const WinParams& p,
                                             unsigned short* sbuf,
                                             int buf_vals, float* red) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wm = warp / kCWarpsN;   // band pixels wm * 64 .. + 63
  const int wn = warp - wm * kCWarpsN;   // output channels wn * kCWarpN ..
  const bool phased = p.phases == 4;
  const int s = phased ? 1 : p.stride;
  const int os = phased ? 2 : 1;   // y's step an output pixel
  const int img_px = p.win_h * p.win_w;
  const int half = (p.win_w + 1) >> 1;
  const int n_chunks = (p.C + kCK - 1) / kCK;

  float acc[4][kCNT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < kCNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
  // two sets of fragments: a k-step's are read while the last one's
  // products run
  unsigned af[2][4][4], bq[2][kCNT / 2][4];
  // the lane's A pixel of each 16-pixel group as a window index (a pixel
  // past the band reads pixel 0 of the window: finite)
  int abase[4];

  WinItem it;
  int ci = win_next(p, blockIdx.x, it);
  int cb = 0;
  int step = 0;
  while (ci < p.items) {
    const int img_rows = it.bh * it.bw;
    const int bpx = it.nn * img_rows;
    if (cb == 0) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int pm = wm * 64 + mi * 16 + (lane & 15);
        abase[mi] = 0;
        if (pm < bpx) {
          const int ni = pm / img_rows;
          const int r2 = pm - ni * img_rows;
          const int rr = r2 / it.bw;
          abase[mi] = ni * img_px + rr * s * p.win_w + (r2 - rr * it.bw);
        }
      }
    }
    const int b = step & 1;
    named_sync(kBarFull + b, kCThreads);
    const unsigned short* sW = sbuf + b * buf_vals;
    const unsigned short* sX = sW + kCWVals;
    const int nc = phased ? 1 + it.pw : 3;
    const int ntaps = phased ? (1 + it.ph) * nc : 9;
    // set `set` of fragments for tap slot j at window offset toff, k-step
    // kb: A at the lane's pixel + toff, B from the slot's [c][n] rows
    auto load_frags = [&](int set, int j, int toff, int kb) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[set][mi], sX + (abase[mi] + toff) * kCLdX + kb +
                                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kCNT / 2; ++np)
        ldmatrix_x4_trans(
            bq[set][np], sW + (j * kCK + kb + ((lane >> 3) & 1) * 8 +
                               (lane & 7)) * kCLdW +
                             wn * kCWarpN + np * 16 + (lane >> 4) * 8);
    };
    auto mma_frags = [&](int set) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nt = 0; nt < kCNT; ++nt)
          mma_16816<T>(acc[mi][nt], af[set][mi],
                       bq[set][nt >> 1][2 * (nt & 1)],
                       bq[set][nt >> 1][2 * (nt & 1) + 1]);
    };
    static_assert(kCK == 32, "two k-steps a tap");
    int jr = 0, jc = 0, toff = 0;
    load_frags(0, 0, 0, 0);
#pragma unroll 1
    for (int j = 0; j < ntaps; ++j) {
      load_frags(1, j, toff, 16);
      mma_frags(0);
      if (++jc == nc) {
        jc = 0;
        ++jr;
      }
      toff = jr * p.win_w + (s == 2 ? (jc & 1) * half + (jc >> 1) : jc);
      if (j + 1 < ntaps) load_frags(0, j + 1, toff, 0);
      mma_frags(1);
    }
    named_arrive(kBarEmpty + b, kCThreads);
    ++step;
    if (cb == n_chunks - 1) {
      // y rounded from the f32 accumulator, and the band's stats row
      T* y = static_cast<T*>(p.y);
      const bool pair_y =
          p.K % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0;
      float sm[kCNT][2], sq[kCNT][2];
#pragma unroll
      for (int nt = 0; nt < kCNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sm[nt][e] = sq[nt][e] = 0.f;
      // the thread's pixels wm * 64 + g + 8 i, i = 2 mi + h, by steps of 8
      int ni = (wm * 64 + g) / img_rows;
      int rr = (wm * 64 + g - ni * img_rows) / it.bw;
      int cc = wm * 64 + g - ni * img_rows - rr * it.bw;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pm = wm * 64 + mi * 16 + g + 8 * h;
          if (pm > wm * 64 + g) {
            cc += 8;
            while (cc >= it.bw) {
              cc -= it.bw;
              if (++rr == it.bh) {
                rr = 0;
                ++ni;
              }
            }
          }
          if (pm >= bpx) continue;
          const long long row =
              (static_cast<long long>(it.n0 + ni) * p.Hy +
               (it.ho0 + rr) * os + it.ph) * p.Wy + (it.wo0 + cc) * os +
              it.pw;
#pragma unroll
          for (int nt = 0; nt < kCNT; ++nt) {
            const int n = it.k0 + wn * kCWarpN + nt * 8 + 2 * tq;
            const float v0 = acc[mi][nt][2 * h];
            const float v1 = acc[mi][nt][2 * h + 1];
            T* dst = y + row * p.K + n;
            if (pair_y && n + 1 < p.K) {
              *reinterpret_cast<uint32_t*>(dst) = pack2<T>(v0, v1);
            } else {
              if (n < p.K) dst[0] = from_float<T>(v0);
              if (n + 1 < p.K) dst[1] = from_float<T>(v1);
            }
            if (STATS) {
              if (n < p.K) {
                sm[nt][0] += v0;
                sq[nt][0] += v0 * v0;
              }
              if (n + 1 < p.K) {
                sm[nt][1] += v1;
                sq[nt][1] += v1 * v1;
              }
            }
          }
        }
      if (STATS) {
#pragma unroll
        for (int nt = 0; nt < kCNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              sm[nt][e] += __shfl_xor_sync(0xffffffffu, sm[nt][e], off);
              sq[nt][e] += __shfl_xor_sync(0xffffffffu, sq[nt][e], off);
            }
        // (the last item's reads of red came before this step's full
        // barrier)
        if (g == 0) {
#pragma unroll
          for (int nt = 0; nt < kCNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = wn * kCWarpN + nt * 8 + 2 * tq + e;
              red[wm * kCN + col] = sm[nt][e];
              red[(4 + wm) * kCN + col] = sq[nt][e];
            }
        }
        named_sync(kBarStats, kCConsumers);
        if (tid < kCN) {
          const int n = it.k0 + tid;
          if (n < p.K) {
            float ts = 0.f, tss = 0.f;
            for (int w = 0; w < 4; ++w) {
              ts += red[w * kCN + tid];
              tss += red[(4 + w) * kCN + tid];
            }
            float* prow =
                p.partial + static_cast<long long>(it.band) * 2 * p.K;
            prow[n] = ts;
            prow[p.K + n] = tss;
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nt = 0; nt < kCNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    }
    if (++cb == n_chunks) {
      cb = 0;
      ci = win_next(p, ci + gridDim.x, it);
    }
  }
}

template <typename T, bool PRO, bool RELU, bool STATS>
__global__ void __launch_bounds__(kCThreads, 1)
    conv3x3_tc_kernel(const WinParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned short* sbuf = reinterpret_cast<unsigned short*>(smem_raw);
  const int buf_vals = win_buffer_values(p);
  float* red = reinterpret_cast<float*>(sbuf + 2 * buf_vals);   // [2][4][64]
  if (threadIdx.x >= kCConsumers)
    win_producer<T, PRO, RELU>(p, sbuf, buf_vals);
  else
    win_consumer<T, STATS>(p, sbuf, buf_vals, red);
}

// ---------------------------------------------------------------------------
// K6 on the tensor cores: dw tiles that read each byte about once (bf16 and
// float16)
// ---------------------------------------------------------------------------
//
// Replaces _mm_wgrad_kernel (:221, launched by _mm_wgrad at :254) in 16
// bits: dw [C, K] f32 = sum_m a[m, c] dy[m, k] over one range of rows (the
// split-K of the parent body, reduced in a fixed order by reduce_rows). A
// block owns a tile of 64 warps_c input channels x 32 warps_k output
// channels (256 x 64, 128 x 128, 64 x 256, ...: conv.py's k6_plan picks the
// tile that wastes least and reads least, so that x and dy are read about
// once per shape, not C / 64 or K / 64 times as with the parent's 64 x 64),
// one warp a 64 x 32 sub-tile. It walks its rows 32 a stage through a ring
// of four stages: x and dy stay row-major ([row][c], [row][k]) and come in
// by cp.async in 16-byte pieces; the prologue is applied once to each x
// element in shared memory (the _rn pair forms), on the pieces the thread
// copied, before the stage's one barrier; both fragments, whose reduction
// runs over rows, are read by ldmatrix.trans (4 of x and 2 of dy for a
// warp's 16 products), so no value is transposed by scalar stores.
//
// What bounds it. At ResNet-50's 1x1 weight-gradient shapes (B = 256) the
// 56^2 shapes are bound by their bytes (256 -> 64: 514 MB, 0.153 ms at 3.35
// TB/s) and the 7^2 and 14^2 ones by their FLOPs; with two blocks an SM the
// four-stage ring keeps about 130 KB of copies in flight on each SM, and the
// split gives about one wave of blocks.

constexpr int kW1Rows = 32;     // rows of a stage
constexpr int kW1Stages = 4;    // stages in the ring

__host__ __device__ inline int w1_stage_values(int tc, int tk) {
  return kW1Rows * (tc + 8 + tk + 8);
}

__host__ inline size_t w1_smem_bytes(int tc, int tk) {
  return kW1Stages * sizeof(unsigned short) * w1_stage_values(tc, tk);
}

template <typename T, bool PRO, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
    conv1x1_wgrad_tc_kernel(const ConvParams p, int warps_c, int warps_k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned short* sbuf = reinterpret_cast<unsigned short*>(smem_raw);
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.w);
  const int tc = 64 * warps_c;
  const int tk = 32 * warps_k;
  const int ldx = tc + 8;   // 16 bytes of padding: 8 rows in distinct banks
  const int ldd = tk + 8;
  const int stage_vals = w1_stage_values(tc, tk);
  const int nthreads = 32 * warps_c * warps_k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wc = warp / warps_k;   // input channels wc * 64 .. + 63
  const int wk = warp - wc * warps_k;   // output channels wk * 32 .. + 31
  const int c0 = blockIdx.x * tc;
  const int k0 = blockIdx.y * tk;
  const int m_begin = blockIdx.z * p.rows_per_split;
  const int m_end = min(p.M, m_begin + p.rows_per_split);
  const int steps = max(0, (m_end - m_begin + kW1Rows - 1) / kW1Rows);
  const bool vec_x = vec8(x, p.C);
  const bool vec_dy = vec8(dy, p.K);
  // a thread's pieces: one 8-channel part of x (and of dy), fixed, in every
  // (4 warps_k)-th (8 warps_c-th) row of a stage
  const int xparts = tc / 8;
  const int xpart = tid % xparts;
  const int xrow0 = tid / xparts;
  const int xrow_step = nthreads / xparts;
  const int dparts = tk / 8;
  const int dpart = tid % dparts;
  const int drow0 = tid / dparts;
  const int drow_step = nthreads / dparts;
  const int cx = c0 + xpart * 8;
  const int kd = k0 + dpart * 8;

  // the x offset of row m (< M), in elements
  auto x_off = [&](int m) -> long long {
    if (p.stride == 1) return static_cast<long long>(m) * p.C;
    const RowOrigin o = row_origin(p, m);
    return (o.img + static_cast<long long>(o.hi) * p.W + o.wi) * p.C;
  };
  auto load = [&](int st) {
    unsigned short* sX = sbuf + (st % kW1Stages) * stage_vals;
    unsigned short* sD = sX + kW1Rows * ldx;
    const int mb = m_begin + st * kW1Rows;
    for (int r = xrow0; r < kW1Rows; r += xrow_step) {
      const int m = mb + r;
      unsigned short* dst = sX + r * ldx + xpart * 8;
      const bool row_in = m < m_end;
      const long long off = row_in ? x_off(m) : 0;
      if (vec_x) {
        const bool in = row_in && cx < p.C;
        cp_async16(dst, in ? static_cast<const void*>(x + off + cx) : x, in);
      } else {
        unsigned w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ce = cx + 2 * j + e;
            v[e] = 0.f;
            if (row_in && ce < p.C) {
              v[e] = to_float(x[off + ce]);
              if (PRO)
                v[e] = prologue<T, RELU>(v[e], __ldg(p.scale + ce),
                                         __ldg(p.shift + ce));
            }
          }
          w4[j] = pack2<T>(v[0], v[1]);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w4[0], w4[1], w4[2],
                                                    w4[3]);
      }
    }
    for (int r = drow0; r < kW1Rows; r += drow_step) {
      const int m = mb + r;
      unsigned short* dst = sD + r * ldd + dpart * 8;
      const bool row_in = m < m_end;
      const long long off = static_cast<long long>(m) * p.K + kd;
      if (vec_dy) {
        const bool in = row_in && kd < p.K;
        cp_async16(dst, in ? static_cast<const void*>(dy + off) : dy, in);
      } else {
        unsigned w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k1 = kd + 2 * j;
          w4[j] = pack2<T>(row_in && k1 < p.K ? to_float(dy[off + 2 * j])
                                              : 0.f,
                           row_in && k1 + 1 < p.K
                               ? to_float(dy[off + 2 * j + 1])
                               : 0.f);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w4[0], w4[1], w4[2],
                                                    w4[3]);
      }
    }
  };
  // the prologue on this thread's x pieces of stage st (cp.async path)
  auto apply_prologue = [&](int st, const unsigned (&sc2)[4],
                            const unsigned (&sh2)[4]) {
    unsigned short* sX = sbuf + (st % kW1Stages) * stage_vals;
    const int mb = m_begin + st * kW1Rows;
    for (int r = xrow0; r < kW1Rows && mb + r < m_end; r += xrow_step) {
      uint4* ptr = reinterpret_cast<uint4*>(sX + r * ldx + xpart * 8);
      const uint4 u = *ptr;
      *ptr = make_uint4(prologue2<T, RELU>(u.x, sc2[0], sh2[0]),
                        prologue2<T, RELU>(u.y, sc2[1], sh2[1]),
                        prologue2<T, RELU>(u.z, sc2[2], sh2[2]),
                        prologue2<T, RELU>(u.w, sc2[3], sh2[3]));
    }
  };

  unsigned sc2[4] = {0u, 0u, 0u, 0u}, sh2[4] = {0u, 0u, 0u, 0u};
  const bool pro_smem = PRO && vec_x && cx < p.C;
  if (pro_smem) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc2[e] = pack2<T>(__ldg(p.scale + cx + 2 * e),
                        __ldg(p.scale + cx + 2 * e + 1));
      sh2[e] = pack2<T>(__ldg(p.shift + cx + 2 * e),
                        __ldg(p.shift + cx + 2 * e + 1));
    }
  }

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  for (int st = 0; st < kW1Stages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kW1Stages - 2>();
    if (pro_smem) apply_prologue(st, sc2, sh2);
    // stage st has landed; every warp is done with stage st - 1's buffer
    __syncthreads();
    if (st + kW1Stages - 1 < steps) load(st + kW1Stages - 1);
    cp_async_commit();
    const unsigned short* sX = sbuf + (st % kW1Stages) * stage_vals;
    const unsigned short* sD = sX + kW1Rows * ldx;
#pragma unroll
    for (int kb = 0; kb < kW1Rows; kb += 16) {
      unsigned af[4][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], sX + (kb + (lane >> 4) * 8 + (lane & 7)) *
                                           ldx +
                                      wc * 64 + mi * 16 +
                                      ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bq[np], sD + (kb + ((lane >> 3) & 1) * 8 +
                                        (lane & 7)) * ldd +
                                      wk * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816<T>(acc[mi][nt], af[mi], bq[nt >> 1][2 * (nt & 1)],
                       bq[nt >> 1][2 * (nt & 1) + 1]);
    }
  }
  cp_async_wait<0>();

  // this split's partial dw: [split][C][K] (dw itself for one split)
  float* out = static_cast<float*>(p.y) +
               static_cast<long long>(blockIdx.z) * p.C * p.K;
  const bool pair = (p.K & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wc * 64 + mi * 16 + g + 8 * h;
      if (c >= p.C) continue;
      float* row = out + static_cast<long long>(c) * p.K;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = k0 + wk * 32 + nt * 8 + 2 * tq;
        const float v0 = acc[mi][nt][2 * h];
        const float v1 = acc[mi][nt][2 * h + 1];
        if (pair && n + 1 < p.K) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < p.K) row[n] = v0;
          if (n + 1 < p.K) row[n + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------------
// K5 on the tensor cores: tiles that read x about once (bf16 and float16)
// ---------------------------------------------------------------------------
//
// Replaces _mm_kernel (:142, launched by _mm at :186) in 16 bits, and the
// 1x1 input gradient of conv2d_dgrad (:531) that runs through it: y [M, K] =
// P(x)[:, ::s, ::s] @ wt with f32 accumulation, y rounded to x's type, and
// per output channel the f32 (sum, sum of squares) of the accumulator. A
// tile is 64 warps_m rows x 32 warps_n output channels of y (conv.py's
// k5_plan: 256 x 64 where K = 64, 128 x 128 where K = 128, 64 x 256 where
// K >= 256, so that one tile covers all of K up to 256 and x is read from
// device memory, and prologued, once; wider K re-reads it at most K / 256
// times, from L2, since the column tiles of a row tile are neighbours in the
// walk), one warp a 64 x 32 sub-tile. The blocks are persistent (as many as
// the SMs hold) and walk the tiles in turn; each tile is summed by one block
// in a fixed order, whatever the grid, so results repeat bit for bit. A
// block streams its tiles' input channels 32 a stage through one ring of
// `stages` stages that runs across its tiles: x ([row][c], 80-byte rows) and
// wt ([c][k]) come in by cp.async in 16-byte pieces, zero-filled past M, C
// and K (a strided row is another row address, found once a tile), so the
// next tile's first stages load while this tile's last ones compute and
// its epilogue runs. The prologue is applied once to each x element in
// shared memory, on the pieces the thread copied, before the stage's one
// barrier (scale and shift rounded to T once a block into a table; the _rn
// pair forms, as prologue() rounds). A is read by ldmatrix and wt by
// ldmatrix.trans: 4 + 2 reads for a warp's 16 products a k16. The epilogue
// stages y in shared memory of its own and writes it in 16-byte pieces (y
// is 20-80% of the bytes at ResNet-50's shapes); the stats come from the
// accumulators (a warp's butterfly, then the row warps in order) into the
// tile's row of partial, which reduce_rows sums in a fixed order.
//
// What bounds it. At ResNet-50's 1x1 shapes (B = 256) the 56^2 and 28^2
// ones are bound by their bytes (256 -> 64 at 56^2: 514 MB, 0.153 ms at
// 3.35 TB/s; arithmetic intensity 32-171 FLOP/byte) and the 14^2 and 7^2
// ones are close to their FLOPs (204-647). The ring keeps stages - 1 stages
// of copies in flight across tile boundaries, and two blocks of 8 warps
// share an SM (registers: 128 a thread, so 64 x 32 accumulators a warp;
// shared memory: a ring of three stages where four would leave one block
// an SM), so one block's epilogue runs beside the other's products.
// tools/k5_layouts.py times every layout and ring; PERF.md has the
// figures.

constexpr int kK5LdX = kTK + 8;   // padded x row: 40 values, 80 bytes
constexpr int kK5MaxXRows = 4;    // x rows a thread copies a stage (8 / warps_n)
constexpr int kK5MaxThreads = 256;

__host__ __device__ inline int k5_stage_bytes(int bm, int bn) {
  return 2 * (bm * kK5LdX + kTK * (bn + 8));
}

// the ring, the epilogue's staged y [bm][bn + 8] and its stats' cross-warp
// sums [2][bm / 64][bn] f32, then (with the prologue) scale and shift
// rounded to T, one value a channel, C rounded up to a stage
__host__ inline size_t k5_smem_bytes(int bm, int bn, int stages, int C,
                                     bool pro) {
  const int c_pad = (C + kTK - 1) / kTK * kTK;
  return static_cast<size_t>(stages) * k5_stage_bytes(bm, bn) +
         2 * static_cast<size_t>(bm) * (bn + 8) + 2 * 4 * (bm / 64) * bn +
         (pro ? 2 * sizeof(unsigned short) * static_cast<size_t>(c_pad) : 0);
}

template <typename T>
__device__ __forceinline__ unsigned short bits16(float v) {
  const T t = from_float<T>(v);
  return *reinterpret_cast<const unsigned short*>(&t);
}

template <typename T, bool PRO, bool RELU>
__global__ void __launch_bounds__(kK5MaxThreads, 2)
    conv1x1_tc_kernel(const ConvParams p, int warps_m, int warps_n,
                      int stages, int stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* x = static_cast<const T*>(p.x);
  const T* wt = static_cast<const T*>(p.w);
  const int bm = 64 * warps_m;
  const int bn = 32 * warps_n;
  const int ldw = bn + 8;
  const int ldy = bn + 8;
  const int nthreads = 32 * warps_m * warps_n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wm = warp / warps_n;        // rows wm * 64 .. + 63
  const int wn = warp - wm * warps_n;   // output channels wn * 32 .. + 31
  const int n_tiles = (p.K + bn - 1) / bn;
  const int tiles = (p.M + bm - 1) / bm * n_tiles;
  const int steps = (p.C + kTK - 1) / kTK;
  const int stage_bytes = k5_stage_bytes(bm, bn);
  unsigned short* sY =
      reinterpret_cast<unsigned short*>(smem_raw + stages * stage_bytes);
  float* red = reinterpret_cast<float*>(sY + bm * ldy);
  unsigned short* tsc = reinterpret_cast<unsigned short*>(red +
                                                          2 * warps_m * bn);
  unsigned short* tsh = tsc + steps * kTK;
  const bool vec_x = vec8(x, p.C);
  const bool vec_w = vec8(wt, p.K);
  const bool pro_smem = PRO && vec_x;
  // this block's tiles: blockIdx.x, + gridDim.x, ..., each `steps` stages
  const int mine = static_cast<int>(blockIdx.x) < tiles
                       ? (tiles - 1 - static_cast<int>(blockIdx.x)) /
                                 static_cast<int>(gridDim.x) +
                             1
                       : 0;
  const int total = mine * steps;

  // a thread's x pieces: channels 8 xpart .. + 7 of each stage, in rows
  // xrow0 + i xrow_step of the tile (8 / warps_n rows)
  const int xpart = tid & 3;
  const int xrow0 = tid >> 2;
  const int xrow_step = nthreads >> 2;
  const int xrows = bm / xrow_step;
  // its wt pieces: output channels 8 wpart .. + 7 of the tile in rows
  // wrow0 + i wrow_step of each stage's 32 (4 / warps_m rows); the same
  // split writes y's pieces in the epilogue
  const int wparts = bn / 8;
  const int wpart = tid % wparts;
  const int wrow0 = tid / wparts;
  const int wrow_step = nthreads / wparts;
  const int wrows = kTK / wrow_step;

  // tile j of this block: its first row and first output channel
  auto origin = [&](int j, int& m0, int& n0) {
    const int t = static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x);
    const int tm = t / n_tiles;
    m0 = tm * bm;
    n0 = (t - tm * n_tiles) * bn;
  };

  // the loader's cursor: the next stage to copy (ld of total), its stage
  // within its tile, the tile's first output channel, and each x row's
  // pixel (-1 past M), found when the tile's first stage is copied
  int ld = 0, ld_st = 0, ld_n0 = 0;
  int xpix[kK5MaxXRows];
  auto load_next = [&]() {
    if (ld_st == 0) {
      int m0;
      origin(ld / steps, m0, ld_n0);
#pragma unroll
      for (int i = 0; i < kK5MaxXRows; ++i) {
        const int m = m0 + xrow0 + i * xrow_step;
        xpix[i] = -1;
        if (i < xrows && m < p.M) {
          if (p.stride == 1) {
            xpix[i] = m;
          } else {
            const RowOrigin o = row_origin(p, m);
            xpix[i] = static_cast<int>(o.img + static_cast<long long>(o.hi) *
                                                   p.W + o.wi);
          }
        }
      }
    }
    unsigned short* sX = reinterpret_cast<unsigned short*>(
        smem_raw + (ld % stages) * stage_bytes);
    unsigned short* sW = sX + bm * kK5LdX;
    const int c0 = ld_st * kTK;
    const int cx = c0 + xpart * 8;
#pragma unroll
    for (int i = 0; i < kK5MaxXRows; ++i) {
      if (i >= xrows) break;
      unsigned short* dst = sX + (xrow0 + i * xrow_step) * kK5LdX + xpart * 8;
      const long long off =
          xpix[i] < 0 ? -1 : static_cast<long long>(xpix[i]) * p.C;
      if (vec_x) {
        const bool in = off >= 0 && cx < p.C;
        cp_async16(dst, in ? static_cast<const void*>(x + off + cx) : x, in);
      } else {
        float v[8];
        load_a8<T, PRO, RELU>(p, x, off, cx, false, v);
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]),
                       pack2<T>(v[4], v[5]), pack2<T>(v[6], v[7]));
      }
    }
    const int nw = ld_n0 + wpart * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= wrows) break;
      const int r = wrow0 + i * wrow_step;
      const int c = c0 + r;
      unsigned short* dst = sW + r * ldw + wpart * 8;
      const long long off = static_cast<long long>(c) * p.K + nw;
      if (vec_w) {
        const bool in = c < p.C && nw < p.K;
        cp_async16(dst, in ? static_cast<const void*>(wt + off) : wt, in);
      } else {
        unsigned w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nw + 2 * j;
          const bool ok = c < p.C;
          w4[j] = pack2<T>(ok && n < p.K ? to_float(wt[off + 2 * j]) : 0.f,
                           ok && n + 1 < p.K ? to_float(wt[off + 2 * j + 1])
                                             : 0.f);
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(w4[0], w4[1], w4[2], w4[3]);
      }
    }
    ++ld;
    if (++ld_st == steps) ld_st = 0;
  };
  // the prologue on this thread's x pieces of stage s (stage st of the tile
  // whose first row is m0; cp.async path); rows past M stay 0
  auto apply_prologue = [&](int s, int st, int m0) {
    unsigned short* sX = reinterpret_cast<unsigned short*>(
        smem_raw + (s % stages) * stage_bytes);
    const int cx = st * kTK + xpart * 8;
    const uint4 s4 = *reinterpret_cast<const uint4*>(tsc + cx);
    const uint4 h4 = *reinterpret_cast<const uint4*>(tsh + cx);
#pragma unroll
    for (int i = 0; i < kK5MaxXRows; ++i) {
      if (i >= xrows) break;
      const int r = xrow0 + i * xrow_step;
      if (m0 + r >= p.M) break;
      uint4* ptr = reinterpret_cast<uint4*>(sX + r * kK5LdX + xpart * 8);
      const uint4 u = *ptr;
      *ptr = make_uint4(prologue2<T, RELU>(u.x, s4.x, h4.x),
                        prologue2<T, RELU>(u.y, s4.y, h4.y),
                        prologue2<T, RELU>(u.z, s4.z, h4.z),
                        prologue2<T, RELU>(u.w, s4.w, h4.w));
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  // y and the stats of the tile just summed (m0, n0); its first barrier
  // parts the staging writes from the copy-out, and the next tile's first
  // stage barrier parts the copy-out from the next staging writes
  auto epilogue = [&](int m0, int n0) {
    float s[4][2], ss[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[nt][e] = ss[nt][e] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mi * 16 + g + 8 * h;
        const bool valid = m0 + r < p.M;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float v0 = acc[mi][nt][2 * h];
          const float v1 = acc[mi][nt][2 * h + 1];
          *reinterpret_cast<unsigned*>(sY + r * ldy + wn * 32 + nt * 8 +
                                       2 * tq) = pack2<T>(v0, v1);
          if (valid) {
            s[nt][0] += v0;
            ss[nt][0] += v0 * v0;
            s[nt][1] += v1;
            ss[nt][1] += v1 * v1;
          }
        }
      }
    if (stats) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s[nt][e] += __shfl_xor_sync(0xffffffffu, s[nt][e], off);
            ss[nt][e] += __shfl_xor_sync(0xffffffffu, ss[nt][e], off);
          }
      if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = wn * 32 + nt * 8 + 2 * tq + e;
            red[wm * bn + col] = s[nt][e];
            red[(warps_m + wm) * bn + col] = ss[nt][e];
          }
      }
    }
    __syncthreads();
    // y in 16-byte pieces: channels n0 + 8 wpart .. + 7, rows wrow0 + i
    // wrow_step
    T* y = static_cast<T*>(p.y);
    const bool vec_y = vec8(y, p.K);
    const int nw = n0 + wpart * 8;
    for (int r = wrow0; r < bm; r += wrow_step) {
      const int m = m0 + r;
      if (m >= p.M) break;
      const unsigned short* src = sY + r * ldy + wpart * 8;
      T* dst = y + static_cast<long long>(m) * p.K + nw;
      if (vec_y && nw + 8 <= p.K) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < 8 && nw + j < p.K; ++j)
          reinterpret_cast<unsigned short*>(dst)[j] = src[j];
      }
    }
    if (stats && tid < bn && n0 + tid < p.K) {
      float ts = 0.f, tss = 0.f;
      for (int w = 0; w < warps_m; ++w) {
        ts += red[w * bn + tid];
        tss += red[(warps_m + w) * bn + tid];
      }
      float* row = p.partial + static_cast<long long>(m0 / bm) * 2 * p.K;
      row[n0 + tid] = ts;
      row[p.K + n0 + tid] = tss;
    }
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (ld < total) load_next();
    cp_async_commit();
  }
  if (pro_smem) {
    // scale and shift rounded to T, 0 past C (so a zero-filled channel
    // stays 0 through the prologue)
    for (int c = tid; c < steps * kTK; c += nthreads) {
      const bool in = c < p.C;
      tsc[c] = bits16<T>(in ? __ldg(p.scale + c) : 0.f);
      tsh[c] = bits16<T>(in ? __ldg(p.shift + c) : 0.f);
    }
    __syncthreads();
  }
  int st = 0, m0 = 0, n0 = 0;
  if (total > 0) origin(0, m0, n0);
  for (int s = 0; s < total; ++s) {
    cp_async_wait(stages - 2);
    if (pro_smem) apply_prologue(s, st, m0);
    // stage s has landed; every warp is done with stage s - 1's buffer
    __syncthreads();
    if (ld < total) load_next();
    cp_async_commit();
    const unsigned short* sX = reinterpret_cast<const unsigned short*>(
        smem_raw + (s % stages) * stage_bytes);
    const unsigned short* sW = sX + bm * kK5LdX;
#pragma unroll
    for (int kb = 0; kb < kTK; kb += 16) {
      unsigned af[4][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], sX + (wm * 64 + mi * 16 + (lane & 15)) * kK5LdX +
                                kb + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bq[np], sW + (kb + ((lane >> 3) & 1) * 8 +
                                        (lane & 7)) * ldw +
                                      wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816<T>(acc[mi][nt], af[mi], bq[nt >> 1][2 * (nt & 1)],
                       bq[nt >> 1][2 * (nt & 1) + 1]);
    }
    if (++st == steps) {
      epilogue(m0, n0);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
      st = 0;
      if (s + 1 < total) origin((s + 1) / steps, m0, n0);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// The fixed-order sum of partials: out[g, l] = sum of in[r, l] over the rows
// r of group g (kReduceChunk rows), each thread a column and every 8th row,
// then the 8 row lanes in order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* in, int R, int L, float* out) {
  __shared__ float lanes[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * kReduceChunk;
  const int r1 = min(R, r0 + kReduceChunk);
  float acc = 0.f;
  if (col < L)
    for (int r = r0 + threadIdx.y; r < r1; r += 8)
      acc += in[static_cast<long long>(r) * L + col];
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < L) {
    float total = 0.f;
    for (int g = 0; g < 8; ++g) total += lanes[g][threadIdx.x];
    out[static_cast<long long>(blockIdx.y) * L + col] = total;
  }
}

// Sum the R rows of in [R, L] into out [L], kReduceChunk rows a pass. tmp
// holds ceil(R / kReduceChunk) rows; in is overwritten by later passes.
cudaError_t reduce_rows(float* in, int R, int L, float* out, float* tmp,
                        cudaStream_t stream) {
  float* src = in;
  float* spare[2] = {tmp, in};
  int which = 0;
  while (true) {
    const int groups = (R + kReduceChunk - 1) / kReduceChunk;
    float* dst = groups == 1 ? out : spare[which];
    dim3 grid((L + 31) / 32, groups);
    reduce_rows_kernel<<<grid, dim3(32, 8), 0, stream>>>(src, R, L, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || groups == 1) return err;
    src = dst;
    R = groups;
    which ^= 1;
  }
}

template <typename T, bool PRO, bool RELU, bool STATS>
void launch_fwd(const ConvParams& p, int taps, cudaStream_t stream) {
  dim3 grid((p.M + kBM - 1) / kBM, (p.K + kBN - 1) / kBN);
  if (taps == 9)
    conv3x3_kernel<T, PRO, RELU, STATS><<<grid, kThreads, 0, stream>>>(p);
  else
    conv1x1_kernel<T, PRO, RELU, STATS><<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
void fwd_by_flags(const ConvParams& p, int taps, bool pro, bool relu,
                  bool stats, cudaStream_t stream) {
  if (!pro) {
    if (stats) launch_fwd<T, false, false, true>(p, taps, stream);
    else launch_fwd<T, false, false, false>(p, taps, stream);
  } else if (!relu) {
    if (stats) launch_fwd<T, true, false, true>(p, taps, stream);
    else launch_fwd<T, true, false, false>(p, taps, stream);
  } else {
    if (stats) launch_fwd<T, true, true, true>(p, taps, stream);
    else launch_fwd<T, true, true, false>(p, taps, stream);
  }
}

template <typename T, bool PRO, bool RELU>
void launch_wgrad(const ConvParams& p, int taps, int splits,
                  cudaStream_t stream) {
  dim3 grid(taps * ((p.C + kWM - 1) / kWM), (p.K + kWN - 1) / kWN, splits);
  // float16's 3x3 runs conv3x3_wgrad_tc_kernel only (the entry refuses it)
  if constexpr (!std::is_same<T, __half>::value) {
    if (taps == 9) {
      conv3x3_wgrad_kernel<T, PRO, RELU><<<grid, kThreads, 0, stream>>>(p);
      return;
    }
  }
  conv1x1_wgrad_kernel<T, PRO, RELU><<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
void wgrad_by_flags(const ConvParams& p, int taps, int splits, bool pro,
                    bool relu, cudaStream_t stream) {
  if (!pro) launch_wgrad<T, false, false>(p, taps, splits, stream);
  else if (!relu) launch_wgrad<T, true, false>(p, taps, splits, stream);
  else launch_wgrad<T, true, true>(p, taps, splits, stream);
}

bool bad_geometry(int N, int H, int W, int C, int Ho, int Wo, int K, int taps,
                  int stride, int pad, int dtype) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1 || K < 1)
    return true;
  if ((taps != 1 && taps != 9) || stride < 1 || pad < 0 ||
      dtype < 0 || dtype > 2)
    return true;
  const long long M = static_cast<long long>(N) * Ho * Wo;
  return M >= (1LL << 31) - kBM ||
         static_cast<long long>(N) * H * W * C >= (1LL << 62) ||
         (K + kBN - 1) / kBN > 65535;
}

ConvParams make_params(const void* x, const void* w, const void* scale,
                       const void* shift, void* y, int N, int H, int W, int C,
                       int Ho, int Wo, int K, int stride, int pad) {
  ConvParams p;
  p.x = x;
  p.w = w;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.y = y;
  p.partial = nullptr;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ho = Ho;
  p.Wo = Wo;
  p.K = K;
  p.stride = stride;
  p.pad = pad;
  p.M = N * Ho * Wo;
  p.rows_per_split = 0;
  return p;
}

}  // namespace

// K5 (taps = 1) or K7 (taps = 9) in f32, and in 16 bits the bodies K5 and
// K7 had before paddle_conv1x1_tc's and paddle_conv3x3_tc's, which
// chip_smoke.py times beside them (mm_tiles64, c3_tap_gather). x [N, H, W,
// C], wt [taps, C, K] and y [N, Ho, Wo, K] dense in one type (dtype 0: f32,
// 1: bf16, 2: float16); scale, shift f32 [C]
// (null: no prologue; relu ignored without it). With want_stats, partial is
// f32 [ceil(M / 128), 2K], tmp f32 [ceil(ceil(M / 128) / 256), 2K] and stats
// f32 [2K] receives (sum, sum of squares) per output channel.
extern "C" int paddle_conv_fwd(const void* x, const void* wt,
                               const void* scale, const void* shift, void* y,
                               void* partial, void* tmp, void* stats, int N,
                               int H, int W, int C, int Ho, int Wo, int K,
                               int taps, int stride, int pad, int relu,
                               int want_stats, int dtype, void* stream) {
  if (bad_geometry(N, H, W, C, Ho, Wo, K, taps, stride, pad, dtype) ||
      (scale == nullptr) != (shift == nullptr) ||
      (want_stats && (partial == nullptr || tmp == nullptr ||
                      stats == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvParams p = make_params(x, wt, scale, shift, y, N, H, W, C, Ho, Wo, K,
                             stride, pad);
  p.partial = static_cast<float*>(partial);
  const bool pro = scale != nullptr;
  if (dtype == 0)
    fwd_by_flags<float>(p, taps, pro, relu != 0, want_stats != 0, st);
  else if (dtype == 1)
    fwd_by_flags<__nv_bfloat16>(p, taps, pro, relu != 0, want_stats != 0, st);
  else
    fwd_by_flags<__half>(p, taps, pro, relu != 0, want_stats != 0, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !want_stats) return static_cast<int>(err);
  err = reduce_rows(static_cast<float*>(partial), (p.M + kBM - 1) / kBM,
                    2 * K, static_cast<float*>(stats),
                    static_cast<float*>(tmp), st);
  return static_cast<int>(err);
}

// K6 (taps = 1) or K8 (taps = 9): dw [taps, C, K] f32 from x [N, H, W, C] and
// dy [N, Ho, Wo, K] (dense, one type; in f32, and in 16 bits the bodies that
// chip_smoke.py times beside paddle_conv1x1_wgrad_tc's and
// paddle_conv3x3_wgrad_tc's, which K6 and K8 run in 16 bits).
// rows_per_split rows of M per split
// (a multiple of 32); with splits == 1 the kernel writes dw itself, else
// partial f32 [splits, taps * C * K] holds the splits' sums and tmp f32
// [ceil(splits / 256), taps * C * K] the reduction's.
extern "C" int paddle_conv_wgrad(const void* x, const void* dy,
                                 const void* scale, const void* shift,
                                 void* dw, void* partial, void* tmp, int N,
                                 int H, int W, int C, int Ho, int Wo, int K,
                                 int taps, int stride, int pad, int relu,
                                 int splits, int rows_per_split, int dtype,
                                 void* stream) {
  if (bad_geometry(N, H, W, C, Ho, Wo, K, taps, stride, pad, dtype) ||
      (scale == nullptr) != (shift == nullptr) || splits < 1 ||
      splits > 65535 || rows_per_split < 1 || rows_per_split % kTK != 0 ||
      static_cast<long long>(splits) * rows_per_split <
          static_cast<long long>(N) * Ho * Wo ||
      (splits > 1 && (partial == nullptr || tmp == nullptr)) ||
      (taps == 9 && dtype == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvParams p = make_params(x, dy, scale, shift, splits == 1 ? dw : partial,
                             N, H, W, C, Ho, Wo, K, stride, pad);
  p.rows_per_split = rows_per_split;
  const bool pro = scale != nullptr;
  if (dtype == 0)
    wgrad_by_flags<float>(p, taps, splits, pro, relu != 0, st);
  else if (dtype == 1)
    wgrad_by_flags<__nv_bfloat16>(p, taps, splits, pro, relu != 0, st);
  else
    wgrad_by_flags<__half>(p, taps, splits, pro, relu != 0, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long L = static_cast<long long>(taps) * C * K;
  if (L >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  err = reduce_rows(static_cast<float*>(partial), splits,
                    static_cast<int>(L), static_cast<float*>(dw),
                    static_cast<float*>(tmp), st);
  return static_cast<int>(err);
}

namespace {

template <typename T, bool PRO, bool RELU>
cudaError_t launch_wgrad_tc(const ConvParams& p, const BandParams& bp,
                            int splits, cudaStream_t stream) {
  const size_t smem = band_smem_bytes(bp);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgrad_tc_kernel<T, PRO, RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.C + kFC - 1) / kFC, (p.K + kFK - 1) / kFK, splits);
  conv3x3_wgrad_tc_kernel<T, PRO, RELU>
      <<<grid, kFThreads, smem, stream>>>(p, bp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wgrad_tc_by_flags(const ConvParams& p, const BandParams& bp,
                              int splits, bool pro, bool relu,
                              cudaStream_t stream) {
  if (!pro) return launch_wgrad_tc<T, false, false>(p, bp, splits, stream);
  if (!relu) return launch_wgrad_tc<T, true, false>(p, bp, splits, stream);
  return launch_wgrad_tc<T, true, true>(p, bp, splits, stream);
}

}  // namespace

// K8's 16-bit body (conv3x3_wgrad_tc_kernel): dw [9, C, K] f32 from x [N, H,
// W, C] and dy [N, Ho, Wo, K] (dense, one type: dtype 1 bf16, 2 float16) of
// the 3x3 conv with padding 1 at stride 1 or 2. The output pixels are cut
// into bands of band_n images x band_h rows x band_w columns (at most 256
// pixels; band_n > 1 only with whole images), ceil(N / band_n) across the
// batch, ceil(Ho / band_h) down and ceil(Wo / band_w) across, in that order,
// and split z walks bands [z * per_split, (z + 1) * per_split). With splits
// == 1 the kernel writes dw itself, else partial f32 [splits, 9 * C * K] and
// tmp f32 [ceil(splits / 256), 9 * C * K] take the splits' sums, added in
// split order. conv.py's wgrad_bands picks the bands and the split.
extern "C" int paddle_conv3x3_wgrad_tc(const void* x, const void* dy,
                                       const void* scale, const void* shift,
                                       void* dw, void* partial, void* tmp,
                                       int N, int H, int W, int C, int Ho,
                                       int Wo, int K, int stride, int relu,
                                       int band_n, int band_h, int band_w,
                                       int per_split, int splits, int dtype,
                                       void* stream) {
  if (bad_geometry(N, H, W, C, Ho, Wo, K, 9, stride, 1, dtype) ||
      (dtype != 1 && dtype != 2) || (stride != 1 && stride != 2) ||
      (scale == nullptr) != (shift == nullptr) || band_n < 1 ||
      band_h < 1 || band_w < 1 || band_n > N || band_h > Ho ||
      band_w > Wo || (band_n > 1 && (band_h != Ho || band_w != Wo)) ||
      static_cast<long long>(band_n) * band_h * band_w > kFMaxPix ||
      per_split < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && (partial == nullptr || tmp == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  BandParams bp;
  bp.band_n = band_n;
  bp.band_h = band_h;
  bp.band_w = band_w;
  bp.n_bn = (N + band_n - 1) / band_n;
  bp.n_bh = (Ho + band_h - 1) / band_h;
  bp.n_bw = (Wo + band_w - 1) / band_w;
  const long long bands = static_cast<long long>(bp.n_bn) * bp.n_bh * bp.n_bw;
  if (bands >= (1LL << 31) ||
      static_cast<long long>(splits) * per_split < bands ||
      static_cast<long long>(splits - 1) * per_split >= bands)
    return static_cast<int>(cudaErrorInvalidValue);
  bp.bands = static_cast<int>(bands);
  bp.per_split = per_split;
  bp.win_h = (band_h - 1) * stride + 3;
  bp.win_w = (band_w - 1) * stride + 3;
  if (band_smem_bytes(bp) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvParams p = make_params(x, dy, scale, shift, splits == 1 ? dw : partial,
                             N, H, W, C, Ho, Wo, K, stride, 1);
  const bool pro = scale != nullptr;
  cudaError_t err =
      dtype == 1
          ? wgrad_tc_by_flags<__nv_bfloat16>(p, bp, splits, pro, relu != 0, st)
          : wgrad_tc_by_flags<__half>(p, bp, splits, pro, relu != 0, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long L = 9LL * C * K;
  if (L >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  err = reduce_rows(static_cast<float*>(partial), splits, static_cast<int>(L),
                    static_cast<float*>(dw), static_cast<float*>(tmp), st);
  return static_cast<int>(err);
}

// The shared memory a K8 block of these bands takes, in bytes (conv.py's
// k8_smem_bytes is its twin; chip_smoke.py holds the two equal)
extern "C" int paddle_conv3x3_wgrad_tc_smem(int band_n, int band_h,
                                            int band_w, int stride) {
  BandParams bp = {};
  bp.band_n = band_n;
  bp.band_h = band_h;
  bp.band_w = band_w;
  bp.win_h = (band_h - 1) * stride + 3;
  bp.win_w = (band_w - 1) * stride + 3;
  return static_cast<int>(band_smem_bytes(bp));
}

namespace {

// A K7 walk's geometry from its bands, checked; false if it cannot run
bool make_win(WinParams& w, int N, int H, int W, int C, int Hy, int Wy,
              int K, int stride, int phases, int band_n, int band_h,
              int band_w) {
  const bool phased = phases == 4;
  const int hg = phased ? (Hy + 1) / 2 : Hy;   // the band grid
  const int wg = phased ? (Wy + 1) / 2 : Wy;
  if (N < 1 || H < 1 || W < 1 || C < 1 || Hy < 1 || Wy < 1 || K < 1 ||
      (phases != 1 && phases != 4) || (stride != 1 && stride != 2) ||
      (phased && (stride != 2 || H != hg || W != wg)) || band_n < 1 ||
      band_h < 1 || band_w < 1 || band_n > N || band_h > hg ||
      band_w > wg || (band_n > 1 && (band_h != hg || band_w != wg)) ||
      static_cast<long long>(band_n) * band_h * band_w > kCPix ||
      static_cast<long long>(N) * H * W * C >= (1LL << 62) ||
      static_cast<long long>(N) * Hy * Wy * K >= (1LL << 62))
    return false;
  const int s = phased ? 1 : stride;
  const int ext = phased ? 2 : 3;   // window rows (columns) past a band's
  w.N = N;
  w.H = H;
  w.W = W;
  w.C = C;
  w.K = K;
  w.Hy = Hy;
  w.Wy = Wy;
  w.stride = stride;
  w.phases = phases;
  w.band_n = band_n;
  w.band_h = band_h;
  w.band_w = band_w;
  w.n_bn = (N + band_n - 1) / band_n;
  w.n_bh = (hg + band_h - 1) / band_h;
  w.n_bw = (wg + band_w - 1) / band_w;
  w.win_h = (band_h - 1) * s + ext;
  w.win_w = (band_w - 1) * s + ext;
  w.n_tiles = (K + kCN - 1) / kCN;
  const long long bands = static_cast<long long>(w.n_bn) * w.n_bh * w.n_bw;
  const long long items = bands * w.n_tiles * phases;
  if (items >= (1LL << 31)) return false;
  w.bands = static_cast<int>(bands);
  w.items = static_cast<int>(items);
  return win_smem_bytes(w) <= 232448;
}

template <typename T, bool PRO, bool RELU, bool STATS>
cudaError_t launch_c3_tc(const WinParams& w, cudaStream_t stream) {
  const size_t smem = win_smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_tc_kernel<T, PRO, RELU, STATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // persistent blocks, one an SM (each item is summed by one block, in one
  // order, whatever the grid)
  const int blocks = std::min(w.items, std::max(1, sms));
  conv3x3_tc_kernel<T, PRO, RELU, STATS>
      <<<blocks, kCThreads, smem, stream>>>(w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t c3_tc_by_flags(const WinParams& w, bool pro, bool relu,
                           bool stats, cudaStream_t stream) {
  if (!pro)
    return stats ? launch_c3_tc<T, false, false, true>(w, stream)
                 : launch_c3_tc<T, false, false, false>(w, stream);
  if (!relu)
    return stats ? launch_c3_tc<T, true, false, true>(w, stream)
                 : launch_c3_tc<T, true, false, false>(w, stream);
  return stats ? launch_c3_tc<T, true, true, true>(w, stream)
               : launch_c3_tc<T, true, true, false>(w, stream);
}

template <typename T, bool PRO, bool RELU>
cudaError_t launch_wgrad1_tc(const ConvParams& p, int warps_c, int warps_k,
                             int splits, cudaStream_t stream) {
  const int tc = 64 * warps_c;
  const int tk = 32 * warps_k;
  const size_t smem = w1_smem_bytes(tc, tk);
  cudaError_t err = cudaFuncSetAttribute(
      conv1x1_wgrad_tc_kernel<T, PRO, RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.C + tc - 1) / tc, (p.K + tk - 1) / tk, splits);
  conv1x1_wgrad_tc_kernel<T, PRO, RELU>
      <<<grid, 32 * warps_c * warps_k, smem, stream>>>(p, warps_c, warps_k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wgrad1_tc_by_flags(const ConvParams& p, int warps_c, int warps_k,
                               int splits, bool pro, bool relu,
                               cudaStream_t stream) {
  if (!pro)
    return launch_wgrad1_tc<T, false, false>(p, warps_c, warps_k, splits,
                                             stream);
  if (!relu)
    return launch_wgrad1_tc<T, true, false>(p, warps_c, warps_k, splits,
                                            stream);
  return launch_wgrad1_tc<T, true, true>(p, warps_c, warps_k, splits,
                                         stream);
}

template <typename T, bool PRO, bool RELU>
cudaError_t launch_k5_tc(const ConvParams& p, int warps_m, int warps_n,
                         int stages, int stats, cudaStream_t stream) {
  const int bm = 64 * warps_m;
  const int bn = 32 * warps_n;
  const int threads = 32 * warps_m * warps_n;
  const size_t smem = k5_smem_bytes(bm, bn, stages, p.C, PRO);
  auto kernel = conv1x1_tc_kernel<T, PRO, RELU>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  // persistent blocks, as many as the SMs hold (each tile is summed by one
  // block, in one order, whatever the grid)
  const long long tiles = static_cast<long long>((p.M + bm - 1) / bm) *
                          ((p.K + bn - 1) / bn);
  const long long blocks =
      std::min(tiles, static_cast<long long>(std::max(1, sms * per_sm)));
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      p, warps_m, warps_n, stages, stats);
  return cudaGetLastError();
}

template <typename T>
cudaError_t k5_tc_by_flags(const ConvParams& p, int warps_m, int warps_n,
                           int stages, bool pro, bool relu, int stats,
                           cudaStream_t stream) {
  if (!pro)
    return launch_k5_tc<T, false, false>(p, warps_m, warps_n, stages, stats,
                                         stream);
  if (!relu)
    return launch_k5_tc<T, true, false>(p, warps_m, warps_n, stages, stats,
                                        stream);
  return launch_k5_tc<T, true, true>(p, warps_m, warps_n, stages, stats,
                                     stream);
}

}  // namespace

// K7's 16-bit body (conv3x3_tc_kernel). phases == 1: the 3x3 conv with
// padding 1 at stride 1 or 2 of x [N, H, W, C] with the taps wt [9, C, K],
// y [N, Hy, Wy, K] (Hy, Wy the output size; rows and columns past x read
// zeros), the prologue when scale and shift are given (f32 [C]), and with
// want_stats the per-channel (sum, sum of squares) into stats f32 [2K]
// through partial f32 [bands, 2K] and tmp f32 [ceil(bands / 256), 2K]; also
// the stride-1 dgrad (x = dy, the rotated taps). phases == 4: the stride-2
// dgrad by phases, x = dy [N, ceil(Hy / 2), ceil(Wy / 2), C], wt the
// rotated taps [9, C, K] (dgrad_operands'), y = dx [N, Hy, Wy, K]; no
// prologue, no stats. Dense tensors of one type (dtype 1 bf16, 2
// float16). The output pixels (of phase (0, 0) with phases == 4) are cut
// into bands of band_n images x band_h rows x band_w columns (conv.py's
// c3_bands).
extern "C" int paddle_conv3x3_tc(const void* x, const void* wt,
                                 const void* scale, const void* shift,
                                 void* y, void* partial, void* tmp,
                                 void* stats, int N, int H, int W, int C,
                                 int Hy, int Wy, int K, int stride,
                                 int phases, int relu, int want_stats,
                                 int band_n, int band_h, int band_w,
                                 int dtype, void* stream) {
  WinParams w = {};
  if ((dtype != 1 && dtype != 2) ||
      (scale == nullptr) != (shift == nullptr) ||
      (phases == 4 && (scale != nullptr || want_stats)) ||
      (want_stats && (partial == nullptr || tmp == nullptr ||
                      stats == nullptr)) ||
      !make_win(w, N, H, W, C, Hy, Wy, K, stride, phases, band_n, band_h,
                band_w))
    return static_cast<int>(cudaErrorInvalidValue);
  w.x = x;
  w.w = wt;
  w.scale = static_cast<const float*>(scale);
  w.shift = static_cast<const float*>(shift);
  w.y = y;
  w.partial = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pro = scale != nullptr;
  cudaError_t err =
      dtype == 1
          ? c3_tc_by_flags<__nv_bfloat16>(w, pro, relu != 0, want_stats != 0,
                                          st)
          : c3_tc_by_flags<__half>(w, pro, relu != 0, want_stats != 0, st);
  if (err != cudaSuccess || !want_stats) return static_cast<int>(err);
  err = reduce_rows(static_cast<float*>(partial), w.bands, 2 * K,
                    static_cast<float*>(stats), static_cast<float*>(tmp), st);
  return static_cast<int>(err);
}

// The shared memory a K7 block of these bands takes, in bytes, or -1 if the
// walk cannot run (conv.py's k7_smem_bytes is its twin; chip_smoke.py holds
// the two equal)
extern "C" int paddle_conv3x3_tc_smem(int band_n, int band_h, int band_w,
                                      int stride, int phases) {
  const int s = phases == 4 ? 1 : stride;
  const int ext = phases == 4 ? 2 : 3;
  WinParams w = {};
  w.band_n = band_n;
  w.win_h = (band_h - 1) * s + ext;
  w.win_w = (band_w - 1) * s + ext;
  return static_cast<int>(win_smem_bytes(w));
}

// K6's 16-bit body (conv1x1_wgrad_tc_kernel): dw [C, K] f32 of the 1x1 conv
// at stride 1 or 2 from x [N, H, W, C] and dy [N, Ho, Wo, K] (dense, one
// type: dtype 1 bf16, 2 float16), the prologue recomputed when scale and
// shift are given. Tiles of 64 warps_c x 32 warps_k channels (warps_c in 1,
// 2, 4; warps_k in 1, 2, 4, 8; at most 8 warps), rows_per_split rows of M
// (a multiple of 32) a split; with splits == 1 the kernel writes dw itself,
// else partial f32 [splits, C * K] and tmp f32 [ceil(splits / 256), C * K]
// take the splits' sums, added in split order. conv.py's k6_plan picks the
// tile and the split.
extern "C" int paddle_conv1x1_wgrad_tc(const void* x, const void* dy,
                                       const void* scale, const void* shift,
                                       void* dw, void* partial, void* tmp,
                                       int N, int H, int W, int C, int Ho,
                                       int Wo, int K, int stride, int relu,
                                       int warps_c, int warps_k, int splits,
                                       int rows_per_split, int dtype,
                                       void* stream) {
  if (bad_geometry(N, H, W, C, Ho, Wo, K, 1, stride, 0, dtype) ||
      (dtype != 1 && dtype != 2) || (stride != 1 && stride != 2) ||
      Ho != (H - 1) / stride + 1 || Wo != (W - 1) / stride + 1 ||
      (scale == nullptr) != (shift == nullptr) ||
      (warps_c != 1 && warps_c != 2 && warps_c != 4) ||
      (warps_k != 1 && warps_k != 2 && warps_k != 4 && warps_k != 8) ||
      warps_c * warps_k > 8 || splits < 1 || splits > 65535 ||
      rows_per_split < 1 || rows_per_split % kW1Rows != 0 ||
      static_cast<long long>(splits) * rows_per_split <
          static_cast<long long>(N) * Ho * Wo ||
      static_cast<long long>(splits - 1) * rows_per_split >=
          static_cast<long long>(N) * Ho * Wo ||
      (K + 32 * warps_k - 1) / (32 * warps_k) > 65535 ||
      (splits > 1 && (partial == nullptr || tmp == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long L = static_cast<long long>(C) * K;
  if (L >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvParams p = make_params(x, dy, scale, shift, splits == 1 ? dw : partial,
                             N, H, W, C, Ho, Wo, K, stride, 0);
  p.rows_per_split = rows_per_split;
  const bool pro = scale != nullptr;
  cudaError_t err =
      dtype == 1 ? wgrad1_tc_by_flags<__nv_bfloat16>(p, warps_c, warps_k,
                                                     splits, pro, relu != 0,
                                                     st)
                 : wgrad1_tc_by_flags<__half>(p, warps_c, warps_k, splits,
                                              pro, relu != 0, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  err = reduce_rows(static_cast<float*>(partial), splits, static_cast<int>(L),
                    static_cast<float*>(dw), static_cast<float*>(tmp), st);
  return static_cast<int>(err);
}

// K5's 16-bit body (conv1x1_tc_kernel): y [N, Ho, Wo, K] of the 1x1 conv at
// stride 1 or 2 of x [N, H, W, C] with wt [C, K] (dense, one type: dtype 1
// bf16, 2 float16), the prologue when scale and shift are given (f32 [C]),
// and with want_stats the per-channel (sum, sum of squares) into stats f32
// [2K] through partial f32 [ceil(M / (64 warps_m)), 2K] and tmp f32
// [ceil(rows of partial / 256), 2K]; also the 1x1 input gradient (x = dy,
// wt = w as [K, C], no prologue, no stats). Tiles of 64 warps_m rows x 32
// warps_n output channels (warps_m in 1, 2, 4; warps_n in 2, 4, 8; at most
// 8 warps) through a ring of `stages` (2 to 8) stages of 32 input
// channels; conv.py's k5_plan picks them.
extern "C" int paddle_conv1x1_tc(const void* x, const void* wt,
                                 const void* scale, const void* shift,
                                 void* y, void* partial, void* tmp,
                                 void* stats, int N, int H, int W, int C,
                                 int Ho, int Wo, int K, int stride, int relu,
                                 int want_stats, int warps_m, int warps_n,
                                 int stages, int dtype, void* stream) {
  const bool pro = scale != nullptr;
  if (bad_geometry(N, H, W, C, Ho, Wo, K, 1, stride, 0, dtype) ||
      (dtype != 1 && dtype != 2) || (stride != 1 && stride != 2) ||
      Ho != (H - 1) / stride + 1 || Wo != (W - 1) / stride + 1 ||
      static_cast<long long>(N) * H * W >= (1LL << 31) ||
      (scale == nullptr) != (shift == nullptr) ||
      (warps_m != 1 && warps_m != 2 && warps_m != 4) ||
      (warps_n != 2 && warps_n != 4 && warps_n != 8) ||
      warps_m * warps_n * 32 > kK5MaxThreads || stages < 2 || stages > 8 ||
      (want_stats && (partial == nullptr || tmp == nullptr ||
                      stats == nullptr)) ||
      k5_smem_bytes(64 * warps_m, 32 * warps_n, stages, C, pro) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(N) * Ho * Wo;
  const long long row_tiles = (M + 64 * warps_m - 1) / (64 * warps_m);
  if (row_tiles * ((K + 32 * warps_n - 1) / (32 * warps_n)) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvParams p = make_params(x, wt, scale, shift, y, N, H, W, C, Ho, Wo, K,
                             stride, 0);
  p.partial = static_cast<float*>(partial);
  cudaError_t err =
      dtype == 1 ? k5_tc_by_flags<__nv_bfloat16>(p, warps_m, warps_n, stages,
                                                 pro, relu != 0, want_stats,
                                                 st)
                 : k5_tc_by_flags<__half>(p, warps_m, warps_n, stages, pro,
                                          relu != 0, want_stats, st);
  if (err != cudaSuccess || !want_stats) return static_cast<int>(err);
  err = reduce_rows(static_cast<float*>(partial), static_cast<int>(row_tiles),
                    2 * K, static_cast<float*>(stats),
                    static_cast<float*>(tmp), st);
  return static_cast<int>(err);
}

// The shared memory a K5 block of 64 warps_m x 32 warps_n and a ring of
// `stages` takes over C input channels, with the prologue's table or
// without (conv.py's k5_smem_bytes is its twin; chip_smoke.py holds the two
// equal)
extern "C" int paddle_conv1x1_tc_smem(int warps_m, int warps_n, int stages,
                                      int C, int pro) {
  return static_cast<int>(
      k5_smem_bytes(64 * warps_m, 32 * warps_n, stages, C, pro != 0));
}

// K9 (paddle_tpu/ops/_pallas/fused_matmul_bn.py:_fwd_kernel, :36, launched by
// _fwd at :76): y = P(x) @ w [M, Cout] and the f32 (sum, sumsq) of the f32
// product, for x [M, Cin] and w [Cin, Cout] (dense, one type). Its body
// computes what K5's does one pixel per row (the prologue's rounding, the f32
// product, y rounded, stats from the accumulator), so it runs K5's body on x
// as the 1x1 conv of a [1, 1, M, Cin] image: in 16 bits conv1x1_tc_kernel
// (paddle_conv1x1_tc, tiles of warps_m x warps_n warps and a ring of
// `stages` from conv.py's k5_plan), in f32 conv1x1_kernel (paddle_conv_fwd,
// 128-row blocks; warps_m, warps_n and stages unread); scale and shift null
// for the prologue "none", relu = 1 for "scale_shift_relu". partial, tmp
// and stats as those entries take them (M rows).
extern "C" int paddle_fused_matmul_bn_fwd(const void* x, const void* w,
                                          const void* scale, const void* shift,
                                          void* y, void* partial, void* tmp,
                                          void* stats, int M, int Cin,
                                          int Cout, int relu, int want_stats,
                                          int warps_m, int warps_n,
                                          int stages, int dtype,
                                          void* stream) {
  if (dtype == 0)
    return paddle_conv_fwd(x, w, scale, shift, y, partial, tmp, stats, 1, 1,
                           M, Cin, 1, M, Cout, 1, 1, 0, relu, want_stats,
                           dtype, stream);
  return paddle_conv1x1_tc(x, w, scale, shift, y, partial, tmp, stats, 1, 1,
                           M, Cin, 1, M, Cout, 1, relu, want_stats, warps_m,
                           warps_n, stages, dtype, stream);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
