// Flash attention at head dim 64 streamed over key (or query) tiles: the
// forward and the three backward kernels that K4 runs when the key sequence
// does not fit one tile, for Hopper (sm_90a), CUDA C++.
//
// They replace the streamed bodies of
// paddle_tpu/ops/_pallas/flash_attention_packed.py:
//   flash_packed_fwd_stream      _fwd_kernel             (:102, launched :267)
//                                (float32 only: bf16 runs on flash_fwd_tc.cu's
//                                tensor-core body, K1's at D = 64)
//   flash_packed_bwd_dq          _bwd_dq_kernel          (:297, launched :582)
//   flash_packed_bwd_dkv         _bwd_dkv_kernel         (:348, launched :652)
//                                (both float32 only: bf16 runs on K2's and
//                                K3's tensor-core bodies, flash_bwd_tc.cu)
//   flash_packed_bwd_dkv_direct  _bwd_dkv_kernel_direct  (:407, launched :626)
//                                (float32; in bf16 and float16 a yardstick
//                                that no path runs: 16 bits run K3's
//                                tensor-core body, which computes the same
//                                sums, through paddle_flash_bwd_dkv_tc)
// The JAX package runs them for d = 64 attention whose keys span more than one
// of its tiles (Sk > 512 at 12 heads: ERNIE at its own 2048-token context),
// and the dk/dv direct form when all the queries fit one tile while the keys
// do not (cross-attention of 512 queries over 2048 keys). Which body runs is
// decided in the wrapper by the JAX package's tile arithmetic; the tiles here
// are this card's own (64 queries by 64 keys).
//
// What they compute, per head, with the masks in the TPU kernels' order:
//   s   = scale * q k^T, then bottom-right causal (key j kept for query i when
//         j <= i + Sk - Sq), then segments (seg_q[i] == seg_k[j], else
//         NEG_INF), then + key_bias[j]                                  (f32)
// forward, over the key tiles in order with a running max m, sum l and f32 acc:
//   m'  = max(m, max_j s),  p = exp(s - m') * (s > NEG_INF / 2),
//   a   = exp(m - m'),  l = l a + sum p,  acc = acc a + (p rounded to v's type) v
//   o   = acc / max(l, 1e-30),  lse = m + log(max(l, 1e-30))
// (m starts at NEG_INF = -1e30, a finite number, so a row that finds its first
// key in a later tile gets a = exp(-1e30 - m') = 0, or 1 while it has none, and
// never NaN); backward, from lse and delta = rowsum(dO * O) (a torch op in the
// wrapper, as _bwd computes it at :531-533):
//   p   = exp(s - lse) * (s > NEG_INF / 2),  dp = dO v^T
//   ds  = p * (dp - delta) * scale, rounded to the input type
//   dq  = ds k                                   (flash_packed_bwd_dq)
//   dk  = ds^T q,  dv = (p rounded to dO's type)^T dO   (the dk/dv kernels)
// A row with no valid key gives o = 0, lse = -1e30 and dq = 0, and adds
// nothing to dk or dv. With attention-prob dropout (dropout.cuh: the hash of
// the flat query head b*H + h and the position) the forward's value product
// takes p * keep while l sums the undropped p (:140-150), and the backward
// scales dp by keep and takes (p * keep)^T dO for dv (:334, :388-392,
// :435-438). Key tiles wholly above the causal band are skipped
// (_fwd_kernel's in_band, :118-119), and so are query tiles wholly below it.
//
// Layout: q, dO [B, Sq, H, 64] and k, v [B, Sk, H, 64], read through their
// batch, sequence and head strides (the last dimension dense), so the views of
// q_proj/k_proj/v_proj go in without a copy. seg_q [B, Sq], seg_k [B, Sk]
// int32 and key_bias [B, Sk] f32 are dense or null. o, dq, dk, dv are written
// dense; lse and delta are dense [B, H, Sq] f32. Any Sq and Sk: both ragged
// edges are masked here (Sk = 640 is ten 64-key tiles).
//
// Design. As on the TPU, every kernel owns its output tile and loops over the
// other axis with f32 accumulators in registers: no atomics, no second pass,
// and the results repeat bit for bit. Blocks of 256 threads; each thread owns
// 2 rows and every eighth column of a 64 x 64 score tile, so the 8 threads of
// a row are adjacent lanes and reduce the row max and sum with shuffles.
// - forward: one block per (64-query tile, b*h) streams K and V tiles through
//   shared memory and keeps m, l and 2 x 8 of acc a thread in registers; p goes
//   through shared memory, rounded, to the value product.
// - dq: one block per (64-query tile, b*h) streams K and V, recomputes s and
//   dp, writes ds (rounded) to shared memory and adds ds k into registers.
// - dk/dv: one block per (64-key tile, b*h) streams Q and dO from the first
//   query tile that reaches it; s^T and dp^T are computed with keys as rows, so
//   that p^T and ds^T go to shared memory row by key and each thread adds to 2
//   key rows of both dk and dv.
// - dk/dv direct (Sq <= 512): the same product loop, with the whole query
//   range's lse, delta and segment ids staged in shared memory once per block
//   instead of once per query tile; it carries nothing between query tiles but
//   its two accumulators.
// Operand tiles hold f32 rows padded to 65 floats, so column reads hit
// distinct banks; each kernel's tiles take 66-106 KB of shared memory.
//
// What bounds them on an H100. At ERNIE's long shape (B = 16, S = 2048,
// H = 12, bf16, non-causal: 192 heads x 2048^2 pairs) the forward does
// 4 * 64 * pairs = 2.06e11 FLOPs against 203 MB, dq 6 * 64 * pairs = 3.09e11
// against 204 MB, dk/dv 8 * 64 * pairs = 4.12e11 against 254 MB, and dk/dv
// direct at 512 x 2048 1.03e11: all bound by operations at the 989 TFLOP/s
// bf16 tensor-core peak (0.21, 0.31, 0.42 and 0.10 ms). These bodies run
// their products on the CUDA cores in f32 (FMA), far from that bound; their
// times stand in PERF.md. In bf16 the forward, dq and dk/dv run on the
// tensor cores (flash_fwd_tc.cu, flash_bwd_tc.cu), and so does
// dk/dv-direct, on dk/dv's body.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "dropout.cuh"

namespace {

constexpr int kD = 64;              // head dim
constexpr int kTile = 64;           // query rows and keys per tile
constexpr int kLd = kD + 1;         // padded row stride of the operand tiles
constexpr int kThreads = 256;
constexpr int kMaxSqDirect = 512;   // the dk/dv direct form's query range
constexpr float kNegInf = -1e30f;   // NEG_INF of the TPU kernels

struct StreamParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;
  float* lse;          // forward: written; backward: read
  const float* delta;
  const int* seg_q;    // null: no segments
  const int* seg_k;
  const float* bias;   // null: no key bias
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  float scale;
  int causal;
  DropoutArgs drop;    // attention-prob dropout (dropout.cuh)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// x rounded to T and back: the points where the TPU kernels cast
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// rows [row0, row0 + 64) of a [*, 64] operand into a padded f32 tile; rows at
// or past n_rows are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row_stride, int row0,
                                          int n_rows, int tid) {
  for (int i = tid; i < kTile * kD; i += kThreads) {
    const int r = i / kD;
    const int c = i - r * kD;
    const int row = row0 + r;
    dst[r * kLd + c] =
        row < n_rows ? to_float(base[static_cast<long long>(row) * row_stride + c])
                     : 0.f;
  }
}

// the score after the TPU kernels' masks, in their order: causal, then
// segments, then the key bias (a masked score is NEG_INF + bias)
__device__ __forceinline__ float mask_score(const StreamParams& p, float s,
                                            int qi, int kj, int offset,
                                            int seg_q, int seg_k, float bias) {
  if (p.causal && kj > qi + offset) s = kNegInf;
  if (p.seg_q != nullptr && seg_q != seg_k) s = kNegInf;
  if (p.bias != nullptr) s += bias;
  return s;
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// key tiles a query tile at q0 needs: all, or on the causal path up to the
// diagonal of its last row (none when Sq > Sk leaves every row empty)
__device__ __forceinline__ int key_tiles(const StreamParams& p, int q0) {
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kTile + p.Sk - p.Sq);
  return kv_end > 0 ? (kv_end + kTile - 1) / kTile : 0;
}

// the per-key mask inputs of the key tile at k0 into shared memory
__device__ __forceinline__ void load_key_masks(const StreamParams& p, int b,
                                               int k0, float* sBias,
                                               int* sSegK, int tid) {
  for (int i = tid; i < kTile; i += kThreads) {
    const int kj = k0 + i;
    const bool in = kj < p.Sk;
    sBias[i] = in && p.bias ? p.bias[static_cast<long long>(b) * p.Sk + kj] : 0.f;
    sSegK[i] = in && p.seg_k ? p.seg_k[static_cast<long long>(b) * p.Sk + kj] : 0;
  }
}

constexpr size_t fwd_smem_bytes() {
  // sQ, sK, sV, sP [64][65] f32; sBias, sSegK [64]
  return sizeof(float) * (4 * kTile * kLd + 2 * kTile);
}

constexpr size_t dq_smem_bytes() {
  // sQ, sDO, sK, sV, sDS [64][65] f32; sBias, sSegK [64]
  return sizeof(float) * (5 * kTile * kLd + 2 * kTile);
}

constexpr size_t dkv_smem_bytes(bool direct) {
  // sK, sV, sQ, sDO, sP, sDS [64][65] f32; lse, delta, seg_q of one query
  // tile, or of all Sq <= 512 queries in the direct form
  return sizeof(float) * (6 * kTile * kLd + 3 * (direct ? kMaxSqDirect : kTile));
}

// ---------------------------------------------------------------------------
// flash_packed_fwd_stream. Grid (query tiles, B*H), 256 threads.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_packed_fwd_stream_kernel(const StreamParams p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sP = sV + kTile * kLd;    // p rounded to T, [query][key]
  float* sBias = sP + kTile * kLd;
  int* sSegK = reinterpret_cast<int*>(sBias + kTile);

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // key columns tx + 8j; d columns tx + 8jj
  const int ty = tid >> 3;  // query rows 2ty, 2ty+1
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * kTile;
  const int offset = p.Sk - p.Sq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<T>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + ty * 2 + i;
    segq[i] = qi < p.Sq && p.seg_q
                  ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;

  const int n_tiles = key_tiles(p, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // sQ is loaded; the last tile's readers are done
    load_tile<T>(sK, kb, p.k_ss, k0, p.Sk, tid);
    load_tile<T>(sV, vb, p.v_ss, k0, p.Sk, tid);
    load_key_masks(p, b, k0, sBias, sSegK, tid);
    __syncthreads();

    float s[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float a[2], bk[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = sQ[(ty * 2 + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = sK[(tx + 8 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        // a key past Sk does not exist: masked, and outside the bias
        s[i][j] = k0 + c < p.Sk
                      ? mask_score(p, s[i][j] * p.scale, q0 + r, k0 + c,
                                   offset, segq[i], sSegK[c], sBias[c])
                      : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(tmax));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        sum += e;
        // dropout: l sums the undropped p, the value product takes p * keep
        const float pv = p.drop.on && e != 0.f
                             ? e * dropout_keep(p.drop, bh, p.Sq, p.Sk, q0 + r,
                                                k0 + tx + 8 * j)
                             : e;
        sP[r * kLd + tx + 8 * j] = round_to<T>(pv);
      }
      l[i] = l[i] * alpha + row_sum8(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();  // every p of the tile is written

    const int n_keys = min(kTile, p.Sk - k0);
#pragma unroll 4
    for (int c = 0; c < n_keys; ++c) {
      float pr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) pr[i] = sP[(ty * 2 + i) * kLd + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float vv = sV[c * kLd + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 2; ++i) acc[i][jj] = fmaf(pr[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + ty * 2 + i;
    if (qi < p.Sq) {
      const float li = fmaxf(l[i], 1e-30f);
      T* orow = static_cast<T*>(p.o) +
                ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * kD;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        orow[tx + 8 * jj] = from_float<T>(acc[i][jj] / li);
      if (tx == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
            m[i] + logf(li);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_packed_bwd_dq. Grid (query tiles, B*H), 256 threads.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_packed_bwd_dq_kernel(const StreamParams p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * kLd;
  float* sK = sDO + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sDS = sV + kTile * kLd;   // ds rounded to T, [query][key]
  float* sBias = sDS + kTile * kLd;
  int* sSegK = reinterpret_cast<int*>(sBias + kTile);

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // key columns tx + 8j; d columns tx + 8jj
  const int ty = tid >> 3;  // query rows 2ty, 2ty+1
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * kTile;
  const int offset = p.Sk - p.Sq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_tile<T>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  load_tile<T>(sDO, dob, p.do_ss, q0, p.Sq, tid);
  float lse[2], delta[2];
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + ty * 2 + i;
    const bool in = qi < p.Sq;
    lse[i] = in ? p.lse[stat0 + qi] : 0.f;
    delta[i] = in ? p.delta[stat0 + qi] : 0.f;
    segq[i] = in && p.seg_q ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
  }

  float dq[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) dq[i][jj] = 0.f;

  const int n_tiles = key_tiles(p, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // sQ, sDO are loaded; the last tile's readers are done
    load_tile<T>(sK, kb, p.k_ss, k0, p.Sk, tid);
    load_tile<T>(sV, vb, p.v_ss, k0, p.Sk, tid);
    load_key_masks(p, b, k0, sBias, sSegK, tid);
    __syncthreads();

    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < kD; ++d) {
      float aq[2], ado[2], bk[8], bv[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        aq[i] = sQ[(ty * 2 + i) * kLd + d];
        ado[i] = sDO[(ty * 2 + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bk[j] = sK[(tx + 8 * j) * kLd + d];
        bv[j] = sV[(tx + 8 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ado[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        const int kj = k0 + c;
        const float sc = kj < p.Sk
                             ? mask_score(p, s[i][j] * p.scale, qi, kj, offset,
                                          segq[i], sSegK[c], sBias[c])
                             : kNegInf;
        const float pr = qi < p.Sq && sc > 0.5f * kNegInf
                             ? expf(sc - lse[i]) : 0.f;
        const float dpv = p.drop.on && pr != 0.f
                              ? dp[i][j] * dropout_keep(p.drop, bh, p.Sq, p.Sk,
                                                        qi, kj)
                              : dp[i][j];
        sDS[r * kLd + c] = round_to<T>(pr * (dpv - delta[i]) * p.scale);
      }
    }
    __syncthreads();  // every ds of the tile is written

    const int n_keys = min(kTile, p.Sk - k0);
#pragma unroll 4
    for (int c = 0; c < n_keys; ++c) {
      float dsr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsr[i] = sDS[(ty * 2 + i) * kLd + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float kv = sK[c * kLd + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 2; ++i) dq[i][jj] = fmaf(dsr[i], kv, dq[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + ty * 2 + i;
    if (qi < p.Sq) {
      T* row = static_cast<T*>(p.dq) +
               ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * kD;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) row[tx + 8 * jj] = from_float<T>(dq[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_packed_bwd_dkv (Direct = false) and flash_packed_bwd_dkv_direct
// (Direct = true, Sq <= 512). Grid (key tiles, B*H), 256 threads.
// ---------------------------------------------------------------------------

template <typename T, bool Direct>
__global__ void __launch_bounds__(kThreads)
    flash_packed_bwd_dkv_kernel(const StreamParams p) {
  constexpr int kStat = Direct ? kMaxSqDirect : kTile;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * kLd;
  float* sQ = sV + kTile * kLd;
  float* sDO = sQ + kTile * kLd;
  float* sP = sDO + kTile * kLd;     // p^T: [key][query], rounded to T
  float* sDS = sP + kTile * kLd;     // ds^T: [key][query], rounded to T
  float* sLse = sDS + kTile * kLd;   // by query: of the tile, or of all Sq
  float* sDelta = sLse + kStat;
  int* sSegQ = reinterpret_cast<int*>(sDelta + kStat);

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // query columns tx + 8j; d columns tx + 8jj
  const int ty = tid >> 3;  // key rows 2ty, 2ty+1
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * kTile;
  const int offset = p.Sk - p.Sq;
  const int nq = (p.Sq + kTile - 1) / kTile;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // the query rows' lse, delta and segment id from query q_first on, into
  // the shared arrays from index 0
  auto load_stats = [&](int q_first, int n) {
    for (int i = tid; i < n; i += kThreads) {
      const int qi = q_first + i;
      const bool in = qi < p.Sq;
      sLse[i] = in ? p.lse[stat0 + qi] : 0.f;
      sDelta[i] = in ? p.delta[stat0 + qi] : 0.f;
      sSegQ[i] = in && p.seg_q ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
    }
  };

  load_tile<T>(sK, kb, p.k_ss, k0, p.Sk, tid);
  load_tile<T>(sV, vb, p.v_ss, k0, p.Sk, tid);
  if (Direct) load_stats(0, p.Sq);
  float kbias[2];
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + ty * 2 + i;
    const bool in = kj < p.Sk;
    kbias[i] = in && p.bias ? p.bias[static_cast<long long>(b) * p.Sk + kj] : 0.f;
    kseg[i] = in && p.seg_k ? p.seg_k[static_cast<long long>(b) * p.Sk + kj] : 0;
  }

  float acc_dk[2][8], acc_dv[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      acc_dk[i][jj] = 0.f;
      acc_dv[i][jj] = 0.f;
    }

  // the first query tile with a row that reaches this key tile:
  // (qt+1)*64 - 1 + offset >= k0, as _bwd_dkv_kernel tests it
  const int x = k0 - offset;
  const int qt_first = p.causal && x > 0 ? x / kTile : 0;
  for (int qt = qt_first; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    const int st0 = Direct ? q0 : 0;   // this tile's first index in sLse...
    __syncthreads();  // sK, sV are loaded; the last tile's readers are done
    load_tile<T>(sQ, qb, p.q_ss, q0, p.Sq, tid);
    load_tile<T>(sDO, dob, p.do_ss, q0, p.Sq, tid);
    if (!Direct) load_stats(q0, kTile);
    __syncthreads();

    // s^T and dp^T, keys as rows
    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < kD; ++d) {
      float ak[2], av[2], bq[8], bdo[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ak[i] = sK[(ty * 2 + i) * kLd + d];
        av[i] = sV[(ty * 2 + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bq[j] = sQ[(tx + 8 * j) * kLd + d];
        bdo[j] = sDO[(tx + 8 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(ak[i], bq[j], s[i][j]);
          dp[i][j] = fmaf(av[i], bdo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = ty * 2 + i;
      const int kj = k0 + kr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = tx + 8 * j;
        const int qi = q0 + qc;
        const int si = st0 + qc;
        const float sc = mask_score(p, s[i][j] * p.scale, qi, kj, offset,
                                    qi < p.Sq ? sSegQ[si] : 0, kseg[i],
                                    kbias[i]);
        const bool live = qi < p.Sq && kj < p.Sk && sc > 0.5f * kNegInf;
        const float pr = live ? expf(sc - sLse[si]) : 0.f;
        const float keep = p.drop.on && live
                               ? dropout_keep(p.drop, bh, p.Sq, p.Sk, qi, kj)
                               : 1.f;
        sP[kr * kLd + qc] = round_to<T>(pr * keep);
        sDS[kr * kLd + qc] = round_to<T>(
            live ? pr * (dp[i][j] * keep - sDelta[si]) * p.scale : 0.f);
      }
    }
    __syncthreads();  // every p^T, ds^T of the tile is written

    // dv += p^T dO, dk += ds^T q over this tile's queries
    const int n_q = min(kTile, p.Sq - q0);
#pragma unroll 4
    for (int c = 0; c < n_q; ++c) {
      float pr[2], dsr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pr[i] = sP[(ty * 2 + i) * kLd + c];
        dsr[i] = sDS[(ty * 2 + i) * kLd + c];
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float qv = sQ[c * kLd + tx + 8 * jj];
        const float dov = sDO[c * kLd + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc_dv[i][jj] = fmaf(pr[i], dov, acc_dv[i][jj]);
          acc_dk[i][jj] = fmaf(dsr[i], qv, acc_dk[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + ty * 2 + i;
    if (kj < p.Sk) {
      const long long row =
          ((static_cast<long long>(b) * p.Sk + kj) * p.H + h) * kD;
      T* dk_row = static_cast<T*>(p.dk) + row;
      T* dv_row = static_cast<T*>(p.dv) + row;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        dk_row[tx + 8 * jj] = from_float<T>(acc_dk[i][jj]);
        dv_row[tx + 8 * jj] = from_float<T>(acc_dv[i][jj]);
      }
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const StreamParams& p,
                   cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

dim3 query_grid(const StreamParams& p) {
  return dim3((p.Sq + kTile - 1) / kTile, p.B * p.H);
}

dim3 key_grid(const StreamParams& p) {
  return dim3((p.Sk + kTile - 1) / kTile, p.B * p.H);
}

StreamParams make_params(const void* q, const void* k, const void* v,
                         const void* seg_q, const void* seg_k,
                         const void* bias, int B, int H, int Sq, int Sk,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal) {
  StreamParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.bias = static_cast<const float*>(bias);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  p.causal = causal;
  return p;
}

// the shapes every kernel here takes: MHA at D = 64, at least one query and
// one key, a grid that fits, segment ids both or neither
bool bad_shape(int B, int H, int HK, int Sq, int Sk, int D, const void* seg_q,
               const void* seg_k) {
  return B <= 0 || H <= 0 || HK != H || Sq <= 0 || Sk <= 0 || D != kD ||
         static_cast<long long>(B) * H > 65535 ||
         (seg_q == nullptr) != (seg_k == nullptr);
}

// the backward kernels' parameters: the forward's, plus dO, lse and delta
StreamParams make_bwd_params(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* seg_q,
                             const void* seg_k, const void* bias, int B, int H,
                             int Sq, int Sk, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_ss,
                             long long k_sh, long long v_sb, long long v_ss,
                             long long v_sh, long long do_sb, long long do_ss,
                             long long do_sh, float scale, int causal) {
  StreamParams p = make_params(q, k, v, seg_q, seg_k, bias, B, H, Sq, Sk,
                               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                               v_sh, scale, causal);
  p.dout = dout;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  return p;
}

// the streamed dk/dv in float32; dk/dv-direct in float32, bf16 or float16
template <bool Direct>
int launch_dkv(const StreamParams& p, int dtype, cudaStream_t s) {
  const size_t smem = dkv_smem_bytes(Direct);
  if (dtype == 0)
    return static_cast<int>(launch(flash_packed_bwd_dkv_kernel<float, Direct>,
                                   key_grid(p), smem, p, s));
  if constexpr (Direct) {
    if (dtype == 1)
      return static_cast<int>(
          launch(flash_packed_bwd_dkv_kernel<__nv_bfloat16, true>,
                 key_grid(p), smem, p, s));
    if (dtype == 2)
      return static_cast<int>(launch(flash_packed_bwd_dkv_kernel<__half, true>,
                                     key_grid(p), smem, p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// flash_packed_fwd_stream: o and lse. dtype must be 0 (float32; bf16 runs on
// flash_fwd_tc.cu's tensor-core body, paddle_flash_packed_fwd_stream_tc).
// Strides are in elements; seg_q, seg_k and bias may be null. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int paddle_flash_packed_fwd_stream(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg_q, const void* seg_k, const void* bias, int B, int H,
    int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int dtype, int dropout, unsigned drop_threshold, unsigned drop_seed,
    float drop_scale, void* stream) {
  if (bad_shape(B, H, HK, Sq, Sk, D, seg_q, seg_k))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamParams p = make_params(q, k, v, seg_q, seg_k, bias, B, H, Sq, Sk,
                               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                               v_sh, scale, causal);
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(flash_packed_fwd_stream_kernel<float>,
                                 query_grid(p), fwd_smem_bytes(), p, s));
}

// flash_packed_bwd_dq: dq from q, k, v, dout, the forward's lse and delta
// (dense [B, H, Sq] f32). dtype must be 0 (float32; bf16 runs on
// flash_bwd_tc.cu's paddle_flash_bwd_dq_tc). Otherwise as the forward.
extern "C" int paddle_flash_packed_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dq, int B, int H, int HK, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int dtype, int dropout, unsigned drop_threshold,
    unsigned drop_seed, float drop_scale, void* stream) {
  if (bad_shape(B, H, HK, Sq, Sk, D, seg_q, seg_k))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamParams p = make_bwd_params(q, k, v, dout, lse, delta, seg_q, seg_k,
                                   bias, B, H, Sq, Sk, q_sb, q_ss, q_sh, k_sb,
                                   k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss,
                                   do_sh, scale, causal);
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  p.dq = dq;
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(flash_packed_bwd_dq_kernel<float>,
                                 query_grid(p), dq_smem_bytes(), p,
                                 static_cast<cudaStream_t>(stream)));
}

// flash_packed_bwd_dkv: dk and dv, streamed over the query tiles. Arguments
// as flash_packed_bwd_dq, with dk and dv for dq; float32 only (bf16 runs on
// paddle_flash_packed_bwd_dkv_tc).
extern "C" int paddle_flash_packed_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dk, void* dv, int B, int H, int HK, int Sq, int Sk,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int dtype, int dropout, unsigned drop_threshold,
    unsigned drop_seed, float drop_scale, void* stream) {
  if (bad_shape(B, H, HK, Sq, Sk, D, seg_q, seg_k))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamParams p = make_bwd_params(q, k, v, dout, lse, delta, seg_q, seg_k,
                                   bias, B, H, Sq, Sk, q_sb, q_ss, q_sh, k_sb,
                                   k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss,
                                   do_sh, scale, causal);
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  p.dk = dk;
  p.dv = dv;
  return launch_dkv<false>(p, dtype, static_cast<cudaStream_t>(stream));
}

// flash_packed_bwd_dkv_direct: as flash_packed_bwd_dkv, for Sq <= 512, in
// float32 (dtype 0), bf16 (dtype 1) or float16 (dtype 2); the 16-bit forms
// are the yardstick chip_smoke.py times beside the tensor-core body.
extern "C" int paddle_flash_packed_bwd_dkv_direct(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dk, void* dv, int B, int H, int HK, int Sq, int Sk,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int dtype, int dropout, unsigned drop_threshold,
    unsigned drop_seed, float drop_scale, void* stream) {
  if (bad_shape(B, H, HK, Sq, Sk, D, seg_q, seg_k) || Sq > kMaxSqDirect)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamParams p = make_bwd_params(q, k, v, dout, lse, delta, seg_q, seg_k,
                                   bias, B, H, Sq, Sk, q_sb, q_ss, q_sh, k_sb,
                                   k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss,
                                   do_sh, scale, causal);
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  p.dk = dk;
  p.dv = dv;
  return launch_dkv<true>(p, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
