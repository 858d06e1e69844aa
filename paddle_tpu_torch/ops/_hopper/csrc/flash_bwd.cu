// Flash-attention backward (K2: dq, K3: dk and dv) for Hopper (sm_90a),
// CUDA C++.
//
// K2 replaces paddle_tpu/ops/_pallas/flash_attention.py:_bwd_dq_kernel (:431,
// launched by _bwd at :628); K3 replaces _bwd_dkv_kernel (:502, launched by
// _bwd at :736). What they compute is what _bwd computes, given K1's lse and
// delta = rowsum(dO * O) - dlse (a torch op in the wrapper, as _bwd computes it
// in jnp outside its kernels):
//   s  = scale * q k^T, masked to NEG_INF, + bias  (f32)
//   p  = exp(s - lse) * (s > NEG_INF / 2)           (a row with no valid key,
//                                                    lse = NEG_INF, gives 0)
//   dp = dO v^T                                     (f32)
//   ds = p * (dp - delta) * scale, rounded to the input type
//   dq = ds k                 (K2, f32 sums, one query tile per block)
//   dk = ds^T q, dv = p^T dO  (K3, p rounded to dO's type, one key tile per
//                              block, summed over every query head of its
//                              grouped-query group)
// with the same conventions as K1: bottom-right causal masking (key j is kept
// for query i when j <= i + Sk - Sq), grouped-query KV (query head h reads KV
// head h / (H / HK)), any Sq and Sk (both ragged edges masked here), and K1's
// masks in K1's order: causal, then segments (seg_q[b, i] == seg_k[b, j], else
// NEG_INF), then the f32 key bias (_bwd_dq_kernel :466-471, _bwd_dkv_kernel
// :557-562), read per batch row for every head. The bias is a mask and gets
// no gradient (_flash_bwd_rule :808-809). With
// attention-prob dropout (dropout.cuh: the mask K1 drew, regenerated from the
// query head b*H + h and the position) dp is scaled by keep before ds, and
// dv takes p * keep (_bwd_dq_kernel :474-479, _bwd_dkv_kernel :566-569, with
// K3's query head as query_bh :529-540 numbers it).
//
// Layout: q and dO [B, Sq, H, D], k and v [B, Sk, HK, D], read through their
// batch, sequence and head strides (the last dimension dense), so the strided
// views of the fused QKV projection go in without a copy. lse and delta are
// dense [B, H, Sq] f32; seg_q [B, Sq], seg_k [B, Sk] int32 and bias [B, Sk] f32
// dense or null. dq [B, Sq, H, D] and dk, dv [B, Sk, HK, D] are written dense
// in the input type.
//
// Design. As on the TPU there are two kernels, and each block owns its output
// tile and loops over the other axis with f32 accumulators, so there are no
// atomics, no second pass, and the results repeat bit for bit. K2: one block of
// 256 threads per (b*h, query tile) loops over key tiles up to the diagonal;
// it recomputes s and dp, writes ds to shared memory and adds ds k into a
// register accumulator (2 rows x D/8 columns a thread at D <= 128). K3: one
// block of 256 threads per (b*hk, key tile) loops over the query heads of its
// group and, for each, over the query tiles from the first one that reaches the
// key tile ((qi+1)*bq - 1 + Sk - Sq >= kj*bk, as _bwd_dkv_kernel tests it) to
// the last; it computes s^T and dp^T with keys as rows, so that p^T and ds^T go
// to shared memory row by key and each thread adds to 2 key rows of both dk
// and dv. Its two accumulators are what limits K3 (the likely trouble spot of
// this port): 256 threads instead of K1's 128 keep them at 64 registers a
// thread at D = 128. Both kernels take one block per SM (their tiles fill
// most of the shared memory), so 8 warps, not 4, are there to hide the
// shared-memory latency (at the training shape K2 ran at 6.0 TFLOP/s with
// 128 threads, K3 at 17.3 with 256). Tiles are 64 x 64 up to D = 128 and
// 32 x 32 at D = 256, where four 64-row f32 operand tiles would exceed the
// 227 KB of shared memory a block may take. Operand rows are padded to D + 1
// floats so that column reads hit distinct banks.
//
// Since the tensor-core bodies of flash_bwd_tc.cu took bf16 and float16 at
// D = 64 and 128, these bodies run float32 at every head dim and bf16 and
// float16 at D = 256 only, and refuse 16-bit types at 64 and 128 (no
// instantiation exists for them).
//
// What bounds it on an H100. At the training shape (B=4, S=2048, H=16, D=128,
// causal, bf16) K2 does 6 * D * pairs * B * H = 1.03e11 FLOPs and K3
// 8 * D * pairs * B * H = 1.38e11 (pairs = S(S+1)/2), against 169 MB and
// 202 MB of bytes (each input read once, each output written once): both are
// bound by operations (0.10 and 0.14 ms at the 989 TFLOP/s bf16 tensor-core
// peak, 0.05 and 0.06 ms of bytes at 3.35 TB/s). Like K1, this first
// version runs every product on the CUDA cores in f32 (FMA), far from that
// bound; its times stand in PERF.md beside it. Moving the products to wgmma
// fed by TMA is a later change's work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "dropout.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels
constexpr int kThreadsDq = 256;
constexpr int kThreadsDkv = 256;

struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* seg_q;   // null: no segments
  const int* seg_k;
  const float* bias;  // null: no key bias
  void* dq;
  void* dk;
  void* dv;
  int B, H, HK, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  float scale;
  int causal;
  DropoutArgs drop;  // attention-prob dropout (dropout.cuh)
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

// x rounded to T and back: the points where _bwd casts to the input type
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// rows per tile: 64 up to D = 128, 32 at D = 256 (shared memory)
template <int D>
struct Tile {
  static constexpr int kRows = D <= 128 ? 64 : 32;
};

// rows [row0, row0 + ROWS) of a [*, D] operand into a padded f32 tile; rows
// at or past n_rows are zero
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row_stride, int row0,
                                          int n_rows, int tid) {
  constexpr int LD = D + 1;
  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = row0 + r;
    dst[r * LD + c] =
        row < n_rows ? to_float(base[static_cast<long long>(row) * row_stride + c])
                     : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sDO [BM][D+1], sK, sV [BN][D+1], sDS [BM][BN+1], all f32; the key
  // tile's sSegK and sBias [BN]
  constexpr int R = Tile<D>::kRows;
  return sizeof(float) *
         static_cast<size_t>(4 * R * (D + 1) + R * (R + 1) + 2 * R);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV [BN][D+1], sQ, sDO [BM][D+1], sP, sDS [BN][BM+1], lse, delta and
  // the query tile's sSegQ [BM]
  constexpr int R = Tile<D>::kRows;
  return sizeof(float) *
         static_cast<size_t>(4 * R * (D + 1) + 2 * R * (R + 1) + 3 * R);
}

// the score of query qi and key kj after K1's masks, in its order: causal,
// then segments, then the key bias (a masked score is NEG_INF + bias); a
// query past Sq or a key past Sk does not exist: masked, outside the bias
__device__ __forceinline__ float mask_score(const FlashBwdParams& p, float s,
                                            int qi, int kj, int offset,
                                            int seg_q, int seg_k, float bias) {
  if (qi >= p.Sq || kj >= p.Sk) return kNegInf;
  if (p.causal && kj > qi + offset) s = kNegInf;
  if (p.seg_q != nullptr && seg_q != seg_k) s = kNegInf;
  if (p.bias != nullptr) s += bias;
  return s;
}

// p = exp(s - lse), 0 where the score is masked (a row with no valid key has
// lse = NEG_INF + log(1e-30), so its p is 0 too)
__device__ __forceinline__ float prob(float s, float lse) {
  return s > 0.5f * kNegInf ? expf(s - lse) : 0.f;
}

// ---------------------------------------------------------------------------
// K2: dq. Grid (query tiles, B*H).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsDq)
    flash_bwd_dq_kernel(const FlashBwdParams p) {
  constexpr int NT = kThreadsDq;
  constexpr int BM = Tile<D>::kRows;  // queries per block
  constexpr int BN = Tile<D>::kRows;  // keys per tile
  constexpr int RM = BM / (NT / 8);   // rows a thread owns
  constexpr int CN = BN / 8;          // score columns a thread owns
  constexpr int DT = D / 8;           // dq columns a thread owns
  constexpr int LD = D + 1;
  constexpr int LDS = BN + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BM * LD;
  float* sK = sDO + BM * LD;
  float* sV = sK + BN * LD;
  float* sDS = sV + BN * LD;
  float* sBias = sDS + BM * LDS;
  int* sSegK = reinterpret_cast<int*>(sBias + BN);

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // score columns tx + 8j, dq columns tx + 8jj
  const int ty = tid >> 3;  // rows ty*RM .. ty*RM + RM-1
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.HK);
  const int q0 = blockIdx.x * BM;
  const int offset = p.Sk - p.Sq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, D, BM, NT>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  load_tile<T, D, BM, NT>(sDO, dob, p.do_ss, q0, p.Sq, tid);

  const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
  float lse_r[RM], delta_r[RM], acc[RM][DT];
  int segq_r[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    lse_r[i] = qi < p.Sq ? p.lse[stat0 + qi] : 0.f;
    delta_r[i] = qi < p.Sq ? p.delta[stat0 + qi] : 0.f;
    segq_r[i] = qi < p.Sq && p.seg_q != nullptr
                    ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) acc[i][jj] = 0.f;
  }

  // keys this tile needs: all, or on the causal path up to the diagonal of
  // its last row (none when Sq > Sk leaves every row empty)
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + BM + offset);
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the last tile's readers of sK and sDS are done
    load_tile<T, D, BN, NT>(sK, kb, p.k_ss, k0, p.Sk, tid);
    load_tile<T, D, BN, NT>(sV, vb, p.v_ss, k0, p.Sk, tid);
    for (int i = tid; i < BN; i += NT) {
      const int kj = k0 + i;
      const bool in = kj < p.Sk;
      sSegK[i] = in && p.seg_k != nullptr
                     ? p.seg_k[static_cast<long long>(b) * p.Sk + kj] : 0;
      sBias[i] = in && p.bias != nullptr
                     ? p.bias[static_cast<long long>(b) * p.Sk + kj] : 0.f;
    }
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[RM], g[RM], bk[CN], bv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = sQ[(ty * RM + i) * LD + d];
        g[i] = sDO[(ty * RM + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        bk[j] = sK[(tx + 8 * j) * LD + d];
        bv[j] = sV[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 8 * j;
        const int kj = k0 + c;
        const float pr = prob(mask_score(p, s[i][j] * p.scale, qi, kj, offset,
                                         segq_r[i], sSegK[c], sBias[c]),
                              lse_r[i]);
        float dpv = dp[i][j];
        if (p.drop.on && pr != 0.f)
          dpv *= dropout_keep(p.drop, bh, p.Sq, p.Sk, qi, kj);
        sDS[(ty * RM + i) * LDS + tx + 8 * j] =
            round_to<T>(pr * (dpv - delta_r[i]) * p.scale);
      }
    }
    __syncthreads();

    const int n_keys = min(BN, p.Sk - k0);
#pragma unroll 4
    for (int c = 0; c < n_keys; ++c) {
      float dsr[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsr[i] = sDS[(ty * RM + i) * LDS + c];
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) {
        const float kv = sK[c * LD + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][jj] = fmaf(dsr[i], kv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi < p.Sq) {
      T* row = static_cast<T*>(p.dq) +
               ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * D;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) row[tx + 8 * jj] = from_float<T>(acc[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dk and dv. Grid (key tiles, B*HK).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsDkv)
    flash_bwd_dkv_kernel(const FlashBwdParams p) {
  constexpr int NT = kThreadsDkv;
  constexpr int BN = Tile<D>::kRows;  // keys per block
  constexpr int BM = Tile<D>::kRows;  // queries per tile
  constexpr int RM = BN / (NT / 8);   // key rows a thread owns
  constexpr int CN = BM / 8;          // score columns (queries) a thread owns
  constexpr int DT = D / 8;           // dk and dv columns a thread owns
  constexpr int LD = D + 1;
  constexpr int LDP = BM + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;
  float* sDO = sQ + BM * LD;
  float* sP = sDO + BM * LD;
  float* sDS = sP + BN * LDP;
  float* sLse = sDS + BN * LDP;
  float* sDelta = sLse + BM;
  int* sSegQ = reinterpret_cast<int*>(sDelta + BM);

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // score columns tx + 8j, dk/dv columns tx + 8jj
  const int ty = tid >> 3;  // key rows ty*RM .. ty*RM + RM-1
  const int bhk = blockIdx.y;
  const int b = bhk / p.HK;
  const int hk = bhk - b * p.HK;
  const int rep = p.H / p.HK;
  const int k0 = blockIdx.x * BN;
  const int offset = p.Sk - p.Sq;

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, D, BN, NT>(sK, kb, p.k_ss, k0, p.Sk, tid);
  load_tile<T, D, BN, NT>(sV, vb, p.v_ss, k0, p.Sk, tid);

  // this thread's key rows' segment and bias, read once for every head
  int segk_r[RM];
  float bias_r[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + ty * RM + i;
    const bool in = kj < p.Sk;
    segk_r[i] = in && p.seg_k != nullptr
                    ? p.seg_k[static_cast<long long>(b) * p.Sk + kj] : 0;
    bias_r[i] = in && p.bias != nullptr
                    ? p.bias[static_cast<long long>(b) * p.Sk + kj] : 0.f;
  }

  float acc_dk[RM][DT], acc_dv[RM][DT];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) {
      acc_dk[i][jj] = 0.f;
      acc_dv[i][jj] = 0.f;
    }

  // the first query tile with a row that reaches this key tile:
  // (qi+1)*BM - 1 + offset >= k0
  int qt_first = 0;
  if (p.causal && k0 - offset > 0) qt_first = (k0 - offset) / BM;
  const int n_qt = (p.Sq + BM - 1) / BM;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the last tile's readers of sQ, sDO, sP, sDS are done
      load_tile<T, D, BM, NT>(sQ, qb, p.q_ss, q0, p.Sq, tid);
      load_tile<T, D, BM, NT>(sDO, dob, p.do_ss, q0, p.Sq, tid);
      for (int i = tid; i < BM; i += NT) {
        const int qi = q0 + i;
        sLse[i] = qi < p.Sq ? p.lse[stat0 + qi] : 0.f;
        sDelta[i] = qi < p.Sq ? p.delta[stat0 + qi] : 0.f;
        sSegQ[i] = qi < p.Sq && p.seg_q != nullptr
                       ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
      }
      __syncthreads();

      float s[RM][CN], dp[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float ak[RM], av[RM], bq[CN], bdo[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          ak[i] = sK[(ty * RM + i) * LD + d];
          av[i] = sV[(ty * RM + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          bq[j] = sQ[(tx + 8 * j) * LD + d];
          bdo[j] = sDO[(tx + 8 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            s[i][j] = fmaf(ak[i], bq[j], s[i][j]);
            dp[i][j] = fmaf(av[i], bdo[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kj = k0 + ty * RM + i;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int qc = tx + 8 * j;
          const int qi = q0 + qc;
          const float pr =
              prob(mask_score(p, s[i][j] * p.scale, qi, kj, offset, sSegQ[qc],
                              segk_r[i], bias_r[i]),
                   sLse[qc]);
          const float keep = p.drop.on && pr != 0.f
                                 ? dropout_keep(p.drop, b * p.H + h, p.Sq,
                                                p.Sk, qi, kj)
                                 : 1.f;
          sP[(ty * RM + i) * LDP + qc] = round_to<T>(pr * keep);
          sDS[(ty * RM + i) * LDP + qc] =
              round_to<T>(pr * (dp[i][j] * keep - sDelta[qc]) * p.scale);
        }
      }
      __syncthreads();

      const int n_q = min(BM, p.Sq - q0);
#pragma unroll 4
      for (int c = 0; c < n_q; ++c) {
        float pr[RM], dsr[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pr[i] = sP[(ty * RM + i) * LDP + c];
          dsr[i] = sDS[(ty * RM + i) * LDP + c];
        }
#pragma unroll
        for (int jj = 0; jj < DT; ++jj) {
          const float qv = sQ[c * LD + tx + 8 * jj];
          const float dov = sDO[c * LD + tx + 8 * jj];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc_dv[i][jj] = fmaf(pr[i], dov, acc_dv[i][jj]);
            acc_dk[i][jj] = fmaf(dsr[i], qv, acc_dk[i][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + ty * RM + i;
    if (kj < p.Sk) {
      const long long row =
          ((static_cast<long long>(b) * p.Sk + kj) * p.HK + hk) * D;
      T* dk_row = static_cast<T*>(p.dk) + row;
      T* dv_row = static_cast<T*>(p.dv) + row;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) {
        dk_row[tx + 8 * jj] = from_float<T>(acc_dk[i][jj]);
        dv_row[tx + 8 * jj] = from_float<T>(acc_dv[i][jj]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const FlashBwdParams& p, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int BM = Tile<D>::kRows;
  const dim3 grid((p.Sq + BM - 1) / BM, p.B * p.H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreadsDq, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const FlashBwdParams& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int BN = Tile<D>::kRows;
  const dim3 grid((p.Sk + BN - 1) / BN, p.B * p.HK);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreadsDkv, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch_d(const FlashBwdParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 64:
      return kDq ? launch_dq<T, 64>(p, stream) : launch_dkv<T, 64>(p, stream);
    case 128:
      return kDq ? launch_dq<T, 128>(p, stream) : launch_dkv<T, 128>(p, stream);
    case 256:
      return kDq ? launch_dq<T, 256>(p, stream) : launch_dkv<T, 256>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int run(const FlashBwdParams& p, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.B <= 0 || p.H <= 0 || p.HK <= 0 || p.H % p.HK || p.Sq <= 0 ||
      p.Sk <= 0 || (p.seg_q == nullptr) != (p.seg_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(dispatch_d<float, kDq>(p, D, s));
  // bf16 and float16 at D = 64 and 128 run on flash_bwd_tc.cu's tensor-core
  // bodies
  if (dtype == 1 && D == 256)
    return static_cast<int>(kDq ? launch_dq<__nv_bfloat16, 256>(p, s)
                                : launch_dkv<__nv_bfloat16, 256>(p, s));
  if (dtype == 2 && D == 256)
    return static_cast<int>(kDq ? launch_dq<__half, 256>(p, s)
                                : launch_dkv<__half, 256>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

FlashBwdParams make_params(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* seg_q,
                           const void* seg_k, const void* bias, int B, int H,
                           int HK, int Sq,
                           int Sk, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, long long do_sb, long long do_ss,
                           long long do_sh, float scale, int causal) {
  FlashBwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.bias = static_cast<const float*>(bias);
  p.dq = nullptr;
  p.dk = nullptr;
  p.dv = nullptr;
  p.B = B;
  p.H = H;
  p.HK = HK;
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
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// K2. dtype: 0 = float32 (D 64, 128 or 256), 1 = bfloat16 or 2 = float16
// (D 256 only: flash_bwd_tc.cu takes them at 64 and 128). Strides are in
// elements; seg_q, seg_k (both or neither) and bias may be null. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int paddle_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dq, int B, int H, int HK, int Sq,
    int Sk, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, int causal, int dtype, int dropout,
    unsigned drop_threshold, unsigned drop_seed, float drop_scale,
    void* stream) {
  FlashBwdParams p = make_params(q, k, v, dout, lse, delta, seg_q, seg_k,
                                 bias, B, H, HK, Sq, Sk,
                                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                 v_ss, v_sh, do_sb, do_ss, do_sh, scale,
                                 causal);
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  p.dq = dq;
  return run<true>(p, D, dtype, stream);
}

// K3, with the same arguments as K2 but the two outputs dk and dv.
extern "C" int paddle_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dk, void* dv, int B, int H,
    int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, int causal, int dtype,
    int dropout, unsigned drop_threshold, unsigned drop_seed,
    float drop_scale, void* stream) {
  FlashBwdParams p = make_params(q, k, v, dout, lse, delta, seg_q, seg_k,
                                 bias, B, H, HK, Sq, Sk,
                                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                 v_ss, v_sh, do_sb, do_ss, do_sh, scale,
                                 causal);
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  p.dk = dk;
  p.dv = dv;
  return run<false>(p, D, dtype, stream);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
