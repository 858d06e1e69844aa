// Flash attention at head dim 64 with the whole key sequence in one tile
// (K4a-direct forward, K4b-fused backward) for Hopper (sm_90a), CUDA C++.
//
// K4a-direct replaces paddle_tpu/ops/_pallas/flash_attention_packed.py:
// _fwd_kernel_direct (:165, launched by _fwd at :238) for float32 inputs (bf16
// inputs run its tensor-core body, flash_packed_tc.cu); K4b-fused replaces
// _bwd_fused_kernel (:448, launched by _bwd at :544). Both cover Sk <= 512,
// the case where the TPU puts every key of a head in one tile (BERT-base at
// S = 512). What they compute is what those kernels compute, per head:
//   s   = scale * q k^T, then bottom-right causal (key j kept for query i when
//         j <= i + Sk - Sq), then segments (seg_q[i] == seg_k[j], else
//         NEG_INF), then + key_bias[j]                               (f32)
//   m   = max_j s,  p = exp(s - m) * (s > NEG_INF / 2),  l = max(sum p, 1e-30)
//   o   = (p rounded to the input type) v / l,  lse = m + log l
// and, given lse and delta = rowsum(dO * O) (a torch op in the wrapper, as _bwd
// computes it at :530-532):
//   p   = exp(s - lse) * (s > NEG_INF / 2),  dp = dO v^T
//   ds  = p * (dp - delta) * scale, rounded to the input type
//   dq  = ds k,  dk = ds^T q,  dv = (p rounded to dO's type)^T dO
// A row with no valid key gives o = 0, lse = -1e30 and dq = 0, and adds
// nothing to dk/dv. With attention-prob dropout (dropout.cuh: the hash of the
// flat query head b*H + h, _flat_head :96-99, and the position) o takes
// (p * keep rounded to the input type) v / l with l from the undropped p
// (:186-196), and the backward dp * keep and (p * keep)^T dO (:490-496).
//
// The TPU packs G heads on its 128-lane axis to fill the vector registers;
// that layout is not carried over. Layout here: q, dO [B, Sq, H, 64], k, v
// [B, Sk, H, 64], read through their batch, sequence and head strides (the
// last dimension dense), so the views of q_proj/k_proj/v_proj go in without a
// copy. seg_q [B, Sq], seg_k [B, Sk] int32 and key_bias [B, Sk] f32 are dense
// or null. o, dq, dk, dv are written dense; lse, delta are dense [B, H, Sq].
//
// Design of the float32 forward. One block of 256 threads per (b*h, 64-query
// tile).
// The direct kernel's softmax takes its max over the whole key row before any
// exponential, so that p is rounded to the input type from its final value.
// The block keeps the whole row of scores, 64 x Sk f32 (128 KB at Sk = 512),
// in shared memory: pass 1 streams K through one 64-key tile and writes the
// masked scores, pass 2 turns them into p in place and sums l, pass 3 streams
// V through the same tile and adds p v into registers. Each thread owns 2 rows
// and every eighth column (the 8 threads of a row are adjacent lanes and
// reduce max and sum with shuffles), and reads back in pass 2 exactly the
// scores it wrote in pass 1. Causal tiles above the diagonal are skipped.
// The score block fills most of the shared memory, so one block runs per SM:
// 256 threads give it 8 warps to hide shared-memory latency (on an H100 at
// BERT-base's shape in bf16, before that dtype moved to the tensor cores: 7.8
// ms, against 9.4 ms at 128 threads, 4 rows a thread).
//
// Design of the backward. dq sums over keys and dk, dv over queries; on the
// TPU both fit one program because the whole key sequence is one tile. Here
// one block of 256 threads per (b*h) loops over the 64-key tiles and, for each,
// over the query tiles that reach it: dk and dv of the key tile stay in
// registers (keys as rows, 2 a thread), and each query tile's dq = ds k is
// added into a float32 buffer that only this block touches, in key-tile order,
// and written in the input type at the key tile that ends its sum. One launch
// makes all three gradients from one recompute of s and p, with no atomics, so
// the results repeat bit for bit. s^T and dp^T are computed with keys as rows,
// so that p^T and ds^T go to shared memory by key; dq reads ds^T by column.
//
// What bounds it on an H100. At BERT-base's shape (B = 64, S = 512, H = 12,
// bf16, non-causal: 768 heads x 512^2 pairs) the forward does 4 * 64 * pairs
// = 5.15e10 FLOPs against 203 MB (q, k, v, o, lse), so bytes bound it
// (0.061 ms at 3.35 TB/s against 0.052 ms at 989 TFLOP/s); the backward does
// 10 * 64 * pairs = 1.29e11 FLOPs against 355 MB, so operations bound it
// (0.130 ms). Like K1-K3, these kernels run their products on the CUDA cores
// in f32 (FMA), far from either bound; their times stand in PERF.md. The bf16
// forward keeps a head's K and V resident in shared memory and runs both
// products on the tensor cores (flash_packed_tc.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout.cuh"

namespace {

constexpr int kD = 64;              // head dim
constexpr int kTile = 64;           // query rows and keys per tile
constexpr int kLd = kD + 1;         // padded row stride of the operand tiles
constexpr int kMaxSk = 512;         // the single key tile of the TPU kernels
constexpr int kThreadsFwd = 256;
constexpr int kRowsFwd = kTile * 8 / kThreadsFwd;  // query rows a thread owns
constexpr int kThreadsBwd = 256;
constexpr float kNegInf = -1e30f;   // NEG_INF of the TPU kernels

struct PackedParams {
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
  float* dq_acc;       // f32 running sum of dq (may alias dq in f32)
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

// x rounded to T and back: the points where the TPU kernels cast
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// rows [row0, row0 + 64) of a [*, 64] operand into a padded f32 tile; rows at
// or past n_rows are zero
template <typename T, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row_stride, int row0,
                                          int n_rows, int tid) {
  for (int i = tid; i < kTile * kD; i += NT) {
    const int r = i / kD;
    const int c = i - r * kD;
    const int row = row0 + r;
    dst[r * kLd + c] =
        row < n_rows ? to_float(base[static_cast<long long>(row) * row_stride + c])
                     : 0.f;
  }
}

// the score after _fwd_kernel_direct's masks, in its order: causal, then
// segments, then the key bias (a masked score is NEG_INF + bias)
__device__ __forceinline__ float mask_score(const PackedParams& p, float s,
                                            int qi, int kj, int offset,
                                            int seg_q, int seg_k, float bias) {
  if (p.causal && kj > qi + offset) s = kNegInf;
  if (p.seg_q != nullptr && seg_q != seg_k) s = kNegInf;
  if (p.bias != nullptr) s += bias;
  return s;
}

size_t fwd_smem_bytes(int sk) {
  // sQ, sKV [64][65] f32; sS [64][n*64 + 1] f32; sBias, sSegK [n*64]; sSegQ [64]
  const int n = ((sk + kTile - 1) / kTile) * kTile;
  return sizeof(float) * (2 * kTile * kLd + kTile * (n + 1) + 2 * n + kTile);
}

constexpr size_t bwd_smem_bytes() {
  // sK, sV, sQ, sDO [64][65]; sP, sDS [64][65] (keys as rows); lse, delta,
  // seg_q, seg_k, bias [64]
  return sizeof(float) * (6 * kTile * kLd + 5 * kTile);
}

// ---------------------------------------------------------------------------
// K4a-direct. Grid (query tiles, B*H), 256 threads.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreadsFwd)
    flash_packed_fwd_kernel(const PackedParams p) {
  constexpr int NT = kThreadsFwd;
  extern __shared__ float smem[];
  const int n_all = (p.Sk + kTile - 1) / kTile;
  const int skp = n_all * kTile;
  const int lds = skp + 1;  // odd row stride: row reads hit distinct banks
  float* sQ = smem;
  float* sKV = sQ + kTile * kLd;
  float* sS = sKV + kTile * kLd;
  float* sBias = sS + kTile * lds;
  int* sSegK = reinterpret_cast<int*>(sBias + skp);
  int* sSegQ = sSegK + skp;

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // columns tx + 8j
  const int ty = tid >> 3;  // rows kRowsFwd * ty + i
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * kTile;
  const int offset = p.Sk - p.Sq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<T, NT>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  for (int i = tid; i < skp; i += NT) {
    const bool in = i < p.Sk;
    sBias[i] = in && p.bias ? p.bias[static_cast<long long>(b) * p.Sk + i] : 0.f;
    sSegK[i] = in && p.seg_k ? p.seg_k[static_cast<long long>(b) * p.Sk + i] : 0;
  }
  for (int i = tid; i < kTile; i += NT) {
    const int qi = q0 + i;
    sSegQ[i] = qi < p.Sq && p.seg_q
                   ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
  }

  // key tiles this query tile needs: all, or on the causal path up to the
  // diagonal of its last row (none when Sq > Sk leaves every row empty)
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kTile + offset);
  const int n_tiles = kv_end > 0 ? (kv_end + kTile - 1) / kTile : 0;

  // pass 1: masked scores into sS, running row max in registers
  float mx[kRowsFwd];
#pragma unroll
  for (int i = 0; i < kRowsFwd; ++i) mx[i] = kNegInf;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // sQ and the masks are loaded; the last tile is read
    load_tile<T, NT>(sKV, kb, p.k_ss, k0, p.Sk, tid);
    __syncthreads();
    float s[kRowsFwd][8];
#pragma unroll
    for (int i = 0; i < kRowsFwd; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float a[kRowsFwd], bk[8];
#pragma unroll
      for (int i = 0; i < kRowsFwd; ++i) a[i] = sQ[(ty * kRowsFwd + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = sKV[(tx + 8 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRowsFwd; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRowsFwd; ++i) {
      const int r = ty * kRowsFwd + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + tx + 8 * j;
        // a key past Sk does not exist: masked, and outside the bias
        const float v = c < p.Sk ? mask_score(p, s[i][j] * p.scale, q0 + r,
                                              c, offset, sSegQ[r], sSegK[c],
                                              sBias[c])
                                 : kNegInf;
        sS[r * lds + c] = v;
        mx[i] = fmaxf(mx[i], v);
      }
    }
  }

  // pass 2: p = exp(s - m) in place, rounded to T as the value product takes
  // it; l sums the unrounded p. Each thread reads back its own pass-1 columns.
  float l[kRowsFwd];
#pragma unroll
  for (int i = 0; i < kRowsFwd; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
    float* row = sS + (ty * kRowsFwd + i) * lds;
    float sum = 0.f;
    for (int c = tx; c < n_tiles * kTile; c += 8) {
      const float v = row[c];
      const float e = v > 0.5f * kNegInf ? expf(v - mx[i]) : 0.f;
      sum += e;
      // dropout: l sums the undropped p, the value product takes p * keep
      const float pv = p.drop.on && e != 0.f
                           ? e * dropout_keep(p.drop, bh, p.Sq, p.Sk,
                                              q0 + ty * kRowsFwd + i, c)
                           : e;
      row[c] = round_to<T>(pv);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    l[i] = fmaxf(sum, 1e-30f);
  }

  // pass 3: o = p v, V streamed through the same tile
  float acc[kRowsFwd][8];
#pragma unroll
  for (int i = 0; i < kRowsFwd; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // every p is written; the last V tile is read
    load_tile<T, NT>(sKV, vb, p.v_ss, k0, p.Sk, tid);
    __syncthreads();
    const int n_keys = min(kTile, p.Sk - k0);
#pragma unroll 4
    for (int c = 0; c < n_keys; ++c) {
      float pr[kRowsFwd];
#pragma unroll
      for (int i = 0; i < kRowsFwd; ++i)
        pr[i] = sS[(ty * kRowsFwd + i) * lds + k0 + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float vv = sKV[c * kLd + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < kRowsFwd; ++i) acc[i][jj] = fmaf(pr[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsFwd; ++i) {
    const int qi = q0 + ty * kRowsFwd + i;
    if (qi < p.Sq) {
      T* orow = static_cast<T*>(p.o) +
                ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * kD;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        orow[tx + 8 * jj] = from_float<T>(acc[i][jj] / l[i]);
      if (tx == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
            mx[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b-fused. Grid (B*H), 256 threads.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreadsBwd)
    flash_packed_bwd_kernel(const PackedParams p) {
  constexpr int NT = kThreadsBwd;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * kLd;
  float* sQ = sV + kTile * kLd;
  float* sDO = sQ + kTile * kLd;
  float* sP = sDO + kTile * kLd;     // p^T: [key][query], rounded to T
  float* sDS = sP + kTile * kLd;     // ds^T: [key][query], rounded to T
  float* sLse = sDS + kTile * kLd;
  float* sDelta = sLse + kTile;
  float* sBias = sDelta + kTile;
  int* sSegQ = reinterpret_cast<int*>(sBias + kTile);
  int* sSegK = sSegQ + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // query columns tx + 8j; d columns tx + 8jj
  const int ty = tid >> 3;  // key rows (and dq query rows) 2ty, 2ty+1
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int offset = p.Sk - p.Sq;
  const int nq = (p.Sq + kTile - 1) / kTile;
  const int nk = (p.Sk + kTile - 1) / kTile;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // the first query tile with a row that reaches key tile kt:
  // (qt+1)*64 - 1 + offset >= kt*64, as _bwd_dkv_kernel tests it
  auto qt_first = [&](int kt) {
    const int x = kt * kTile - offset;
    return p.causal && x > 0 ? x / kTile : 0;
  };
  // query tiles before qt_first(0) reach no key: their dq is 0
  for (int i = tid; i < min(qt_first(0) * kTile, p.Sq) * kD; i += NT) {
    const int qi = i / kD;
    static_cast<T*>(p.dq)[((static_cast<long long>(b) * p.Sq + qi) * p.H + h) *
                              kD + (i - qi * kD)] = from_float<T>(0.f);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last key tile's readers of sK, sV are done
    load_tile<T, NT>(sK, kb, p.k_ss, k0, p.Sk, tid);
    load_tile<T, NT>(sV, vb, p.v_ss, k0, p.Sk, tid);
    for (int i = tid; i < kTile; i += NT) {
      const int kj = k0 + i;
      const bool in = kj < p.Sk;
      sBias[i] = in && p.bias ? p.bias[static_cast<long long>(b) * p.Sk + kj] : 0.f;
      sSegK[i] = in && p.seg_k ? p.seg_k[static_cast<long long>(b) * p.Sk + kj] : 0;
    }

    float acc_dk[2][8], acc_dv[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        acc_dk[i][jj] = 0.f;
        acc_dv[i][jj] = 0.f;
      }

    for (int qt = qt_first(kt); qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the last query tile's readers are done
      load_tile<T, NT>(sQ, qb, p.q_ss, q0, p.Sq, tid);
      load_tile<T, NT>(sDO, dob, p.do_ss, q0, p.Sq, tid);
      for (int i = tid; i < kTile; i += NT) {
        const int qi = q0 + i;
        const bool in = qi < p.Sq;
        sLse[i] = in ? p.lse[stat0 + qi] : 0.f;
        sDelta[i] = in ? p.delta[stat0 + qi] : 0.f;
        sSegQ[i] = in && p.seg_q ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
      }
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
          const float sc = mask_score(p, s[i][j] * p.scale, qi, kj, offset,
                                      sSegQ[qc], sSegK[kr], sBias[kr]);
          const float pr = qi < p.Sq && kj < p.Sk && sc > 0.5f * kNegInf
                               ? expf(sc - sLse[qc]) : 0.f;
          const float keep = p.drop.on && pr != 0.f
                                 ? dropout_keep(p.drop, bh, p.Sq, p.Sk, qi, kj)
                                 : 1.f;
          sP[kr * kLd + qc] = round_to<T>(pr * keep);
          sDS[kr * kLd + qc] =
              round_to<T>(pr * (dp[i][j] * keep - sDelta[qc]) * p.scale);
        }
      }
      __syncthreads();

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

      // dq of query rows 2ty, 2ty+1 += ds k over this tile's keys
      float dqp[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) dqp[i][jj] = 0.f;
      const int n_k = min(kTile, p.Sk - k0);
#pragma unroll 4
      for (int c = 0; c < n_k; ++c) {
        float dsr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) dsr[i] = sDS[c * kLd + ty * 2 + i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float kv = sK[c * kLd + tx + 8 * jj];
#pragma unroll
          for (int i = 0; i < 2; ++i) dqp[i][jj] = fmaf(dsr[i], kv, dqp[i][jj]);
        }
      }
      // this query tile's sum runs over key tiles 0 .. kt_last: the last one
      // its rows reach (all of them without causal)
      const int kt_last = p.causal ? min(nk - 1, (q0 + kTile - 1 + offset) / kTile)
                                   : nk - 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + ty * 2 + i;
        if (qi >= p.Sq) continue;
        const long long row =
            ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * kD;
        float* accp = p.dq_acc + row;
        T* out = static_cast<T*>(p.dq) + row;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = tx + 8 * jj;
          // only this thread reads and writes these elements, in kt order
          const float v = kt == 0 ? dqp[i][jj] : accp[col] + dqp[i][jj];
          if (kt == kt_last)
            out[col] = from_float<T>(v);
          else
            accp[col] = v;
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
}

template <typename T>
cudaError_t launch_fwd(const PackedParams& p, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(p.Sk);
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_packed_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.B * p.H);
  flash_packed_fwd_kernel<T><<<grid, kThreadsFwd, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const PackedParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_packed_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_packed_bwd_kernel<T><<<p.B * p.H, kThreadsBwd, smem, stream>>>(p);
  return cudaGetLastError();
}

PackedParams make_params(const void* q, const void* k, const void* v,
                         const void* seg_q, const void* seg_k,
                         const void* bias, int B, int H, int Sq, int Sk,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal) {
  PackedParams p = {};
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

// the shapes both kernels take: MHA at D = 64, 1 <= Sk <= 512, segment ids
// both or neither
bool bad_shape(int B, int H, int HK, int Sq, int Sk, int D, const void* seg_q,
               const void* seg_k) {
  return B <= 0 || H <= 0 || HK != H || Sq <= 0 || Sk <= 0 || Sk > kMaxSk ||
         D != kD || (seg_q == nullptr) != (seg_k == nullptr);
}

}  // namespace

// K4a-direct's float32 body. dtype: 0 = float32 (bfloat16 runs
// paddle_flash_packed_fwd_tc). Strides are in elements; seg_q, seg_k and bias
// may be null. Returns the cudaError_t of the launch (0 = launched).
extern "C" int paddle_flash_packed_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg_q, const void* seg_k, const void* bias, int B, int H,
    int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int dtype, int dropout, unsigned drop_threshold, unsigned drop_seed,
    float drop_scale, void* stream) {
  if (bad_shape(B, H, HK, Sq, Sk, D, seg_q, seg_k))
    return static_cast<int>(cudaErrorInvalidValue);
  PackedParams p = make_params(q, k, v, seg_q, seg_k, bias, B, H, Sq, Sk,
                               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                               v_sh, scale, causal);
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_fwd<float>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4b-fused: dq, dk, dv in one launch from q, k, v, dout, the forward's lse
// and delta (dense [B, H, Sq] f32). dq_acc is an f32 [B, Sq, H, 64] buffer
// (dq itself in float32). Otherwise as the forward.
extern "C" int paddle_flash_packed_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dq, void* dk, void* dv, void* dq_acc, int B, int H,
    int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, int causal, int dtype,
    int dropout, unsigned drop_threshold, unsigned drop_seed,
    float drop_scale, void* stream) {
  if (bad_shape(B, H, HK, Sq, Sk, D, seg_q, seg_k))
    return static_cast<int>(cudaErrorInvalidValue);
  PackedParams p = make_params(q, k, v, seg_q, seg_k, bias, B, H, Sq, Sk,
                               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                               v_sh, scale, causal);
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  p.dout = dout;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dq_acc = static_cast<float*>(dq_acc);
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_bwd<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch_bwd<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
