// K4a-direct on the tensor cores: flash attention at head dim 64 with the
// whole key sequence in one tile, bf16 or float16, for Hopper (sm_90a), CUDA
// C++.
//
// Replaces paddle_tpu/ops/_pallas/flash_attention_packed.py:_fwd_kernel_direct
// (:165, launched by _fwd at :238) for 16-bit inputs (bf16 is written below;
// float16 is the same template over the element type, mma.cuh, rounding
// where bf16 rounds, as JAX's kernel does); flash_packed.cu keeps the
// CUDA-core body of the same kernel for float32 (on the tensor cores float32
// would mean TF32, which is not the function the reference computes). The
// wrapper picks the body by dtype and counts their launches apart.
//
// What it computes is what _fwd_kernel_direct computes, per head, rounded where
// it rounds:
//   s   = scale * q k^T (bf16 products, f32 sums), then bottom-right causal
//         (key j kept for query i when j <= i + Sk - Sq), then segments
//         (seg_q[b, i] == seg_k[b, j], else NEG_INF), then + key_bias[b, j]
//   m   = max over all keys of s (taken before any exponential, from NEG_INF)
//   p   = exp(s - m) * (s > NEG_INF / 2),  l = max(sum p, 1e-30)  (f32)
//   o   = ((p * keep) rounded to bf16) v / l, rounded to bf16
//   lse = m + log l
// keep is the attention-prob dropout factor of dropout.cuh (the hash of the
// flat query head b*H + h and the position), 1 without dropout; l sums the
// undropped p. A row with no valid key gives o = 0 and lse = -1e30 + log 1e-30.
// An online softmax that rescales a running sum would round p from a max that
// is not final yet: that is not the TPU kernel's function, so this kernel
// makes two passes over the resident keys instead.
//
// Layout: q [B, Sq, H, 64], k and v [B, Sk, H, 64] bf16, read through their
// batch, sequence and head strides (the last dimension dense, every row 16-byte
// aligned: the views of a fused QKV projection go in without a copy). seg_q
// [B, Sq], seg_k [B, Sk] int32 and bias [B, Sk] f32 are dense or null. o is
// written dense [B, Sq, H, 64] and lse dense [B, H, Sq] f32. Sk <= 512.
//
// Design. One block of 8 warps per head (b, h) keeps the head's K and V in
// shared memory as bf16 (2 x 64 KB at Sk = 512, rows padded to 72 values so
// that ldmatrix's eight row reads hit distinct banks) and walks the head's
// 256-query tiles; each warp owns 32 query rows (two 16-row m-tiles, so each
// K or V fragment read from shared memory feeds two products). K and V arrive
// by cp.async in 64-key groups behind the first query tile, so the first
// tile's products on a group wait only for that group; the next query tile
// is fetched while the current one computes. Both products run on the tensor
// cores as mma.sync.m16n8k16 (bf16 in, f32 accumulate), fed by ldmatrix:
//   pass 1: S = Q K^T in 32-key chunks (Q's fragments stay in registers for
//           the whole tile), the masks, and the row max in registers;
//   pass 2: S recomputed chunk by chunk, p = exp(s - m) with the final max,
//           l summed in f32, the dropout keep applied, and p converted to bf16
//           straight into the A-operand registers of O += P V (V^T's fragments
//           by ldmatrix.trans). No score goes to shared memory.
// A row of 512 f32 scores for 128 queries is 256 KB, more than the registers
// or the shared memory hold, so S is computed twice rather than kept: 1.5x the
// forward's product FLOPs (7.7e10 at BERT-base's shape). The work per score
// outside the products, not the products, is what set this kernel's speed on
// an H100 (a first version with 16 rows a warp and every mask tested at run
// time took 0.89 ms at BERT-base's shape, mostly in that work): the key bias
// lives in shared memory with -inf past Sk, so a score is one FMA when there
// are no causal masks or segments, the masked and dropout forms are separate
// instantiations (kMasked, kDrop), and a row with no valid key takes its max
// as +inf in pass 2 instead of testing every score (exp(s - inf) = 0, as the
// TPU kernel's (s > NEG_INF / 2) factor gives). On the causal path a warp
// skips the key chunks past its last row's diagonal.
//
// What bounds it on an H100. At BERT-base's shape (B = 64, S = 512, H = 12,
// key bias) the function moves 203 MB (q, k, v, o, lse) for 5.15e10 FLOPs:
// bytes bound it (0.061 ms at 3.35 TB/s, 0.052 ms of operations at 989
// TFLOP/s). With the recompute the tensor cores do 7.7e10 FLOPs (0.078 ms at
// peak). The shared memory (184 KB at Sk = 512) allows one block per SM, so
// the cp.async groups and the 8 warps are what hide the loads. mma.sync
// reaches part of the peak that wgmma reaches; wgmma with TMA loads is the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "dropout.cuh"
#include "mma.cuh"

namespace {

constexpr int kD = 64;                   // head dim
constexpr int kMaxSk = 512;              // the single key tile of the TPU kernel
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsW = 32;               // query rows a warp owns: two m-tiles
constexpr int kTileQ = kRowsW * kWarps;  // query rows per tile
constexpr int kGroup = 64;               // keys per cp.async group of K or V
constexpr int kChunk = 32;               // keys per chunk of a pass
constexpr int kLd = kD + 8;              // padded row of K, V and Q in smem
constexpr int kSegs = kD * 2 / 16;       // 16-byte pieces of a row
constexpr float kNegInf = -1e30f;        // NEG_INF of the TPU kernels

template <typename T>
struct TcParams {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;
  const int* seg_q;    // null: no segments
  const int* seg_k;
  const float* bias;   // null: no key bias
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
  DropoutArgs drop;    // attention-prob dropout (dropout.cuh)
};

// rows [row0, row0 + n) of a [*, 64] bf16 operand into the padded smem rows
// from dst on, by cp.async; rows at or past n_rows are zero
template <typename T>
__device__ __forceinline__ void issue_rows(T* dst, const T* base,
                                           long long row_stride, int row0,
                                           int n, int n_rows, int tid) {
  for (int i = tid; i < n * kSegs; i += kThreads) {
    const int r = i / kSegs;
    const int seg = i - r * kSegs;
    const int row = row0 + r;
    const bool in = row < n_rows;
    const T* src =
        in ? base + static_cast<long long>(row) * row_stride + seg * 8 : base;
    cp_async16(dst + r * kLd + seg * 8, src, in);
  }
}

// The thread's four scores of one 16 x 8 accumulator tile (rows qi0 and qi1,
// keys kj0 and kj0 + 1, in acc's order) after _fwd_kernel_direct's masks, in
// its order: scale, then causal, then segments (a masked score is NEG_INF),
// then + bias. sBias holds the key bias (0 without one) and -inf past Sk, so
// a key that does not exist is masked with no test. Without causal masks or
// segments (kMasked false) a score is one FMA.
template <bool kMasked, typename T>
__device__ __forceinline__ void score_tile(const TcParams<T>& p,
                                           float (&acc)[4],
                                           int qi0, int qi1, int kj0,
                                           int offset, int segq0, int segq1,
                                           const int* sSegK,
                                           const float* sBias) {
  // kj0 is even: one 8-byte read gives both keys' bias or segments
  const float2 bias = *reinterpret_cast<const float2*>(sBias + kj0);
  int2 segk = make_int2(0, 0);
  if (kMasked && p.seg_q != nullptr)
    segk = *reinterpret_cast<const int2*>(sSegK + kj0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float b = (e & 1) ? bias.y : bias.x;
    float s = fmaf(acc[e], p.scale, b);
    if (kMasked) {
      const int qi = (e >> 1) ? qi1 : qi0;
      const int kj = kj0 + (e & 1);
      const bool out =
          (p.causal && kj > qi + offset) ||
          (p.seg_q != nullptr &&
           ((e >> 1) ? segq1 : segq0) != ((e & 1) ? segk.y : segk.x));
      if (out) s = kNegInf + b;
    }
    acc[e] = s;
  }
}

size_t smem_bytes(int sk) {
  // sK, sV [skp][72] and sQ [256][72] bf16; sBias [skp] f32, sSegK [skp]
  const size_t skp = static_cast<size_t>((sk + kGroup - 1) / kGroup) * kGroup;
  return sizeof(__nv_bfloat16) * (2 * skp + kTileQ) * kLd +
         (sizeof(float) + sizeof(int)) * skp;
}

// S = Q K^T for the warp's 32 rows (two m-tiles) and the 32 keys of chunk c:
// acc[mt][j] holds m-tile mt's keys c*32 + 8j .. 8j+7 in mma.sync's
// accumulator layout; each K fragment feeds both m-tiles
template <typename T>
__device__ __forceinline__ void chunk_scores(float (&acc)[2][4][4],
                                             const unsigned (&qf)[2][4][4],
                                             const T* sK, int c, int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  // lane's ldmatrix row: key (lane >> 4) * 8 + (lane & 7) of a 16-key pair of
  // n-tiles, d half ((lane >> 3) & 1) of a 16-wide k-step
  const T* kb = sK + (c * kChunk + (lane >> 4) * 8 + (lane & 7)) *
                                     kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      unsigned b[4];
      ldmatrix_x4(b, kb + jp * 16 * kLd + kk * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_16816<T>(acc[mt][2 * jp], qf[mt][kk], b[0], b[1]);
        mma_16816<T>(acc[mt][2 * jp + 1], qf[mt][kk], b[2], b[3]);
      }
    }
}

// ---------------------------------------------------------------------------
// Grid (B*H), 256 threads. kMasked: causal or segments; kDrop: dropout.
// ---------------------------------------------------------------------------

template <typename T, bool kMasked, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    flash_packed_fwd_tc_kernel(const TcParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_groups = (p.Sk + kGroup - 1) / kGroup;
  const int skp = n_groups * kGroup;
  const int n_chunks = (p.Sk + kChunk - 1) / kChunk;
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + skp * kLd;
  T* sQ = sV + skp * kLd;
  float* sBias = reinterpret_cast<float*>(sQ + kTileQ * kLd);
  int* sSegK = reinterpret_cast<int*>(sBias + skp);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator rows g and g + 8 of an m-tile
  const int tq = lane & 3;   // accumulator columns 2 tq, 2 tq + 1
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int offset = p.Sk - p.Sq;
  const int n_qt = (p.Sq + kTileQ - 1) / kTileQ;

  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + h * p.k_sh;
  const T* vb = p.v + b * p.v_sb + h * p.v_sh;

  // cp.async groups, in order: the first query tile, then K by 64-key group,
  // then V by group; the masks by plain loads
  issue_rows(sQ, qb, p.q_ss, 0, kTileQ, p.Sq, tid);
  cp_async_commit();
  for (int gi = 0; gi < n_groups; ++gi) {
    issue_rows(sK + gi * kGroup * kLd, kb, p.k_ss, gi * kGroup, kGroup, p.Sk,
               tid);
    cp_async_commit();
  }
  for (int gi = 0; gi < n_groups; ++gi) {
    issue_rows(sV + gi * kGroup * kLd, vb, p.v_ss, gi * kGroup, kGroup, p.Sk,
               tid);
    cp_async_commit();
  }
  for (int i = tid; i < skp; i += kThreads) {
    const bool in = i < p.Sk;
    const long long at = static_cast<long long>(b) * p.Sk + i;
    sBias[i] = !in ? -INFINITY : (p.bias != nullptr ? p.bias[at] : 0.f);
    sSegK[i] = in && p.seg_k != nullptr ? p.seg_k[at] : 0;
  }

  // a lane's ldmatrix.trans row of V: key ((lane >> 3) & 1) * 8 + (lane & 7)
  // of a 16-key k-step, d half (lane >> 4) of a 16-wide pair of n-tiles
  const T* vrow =
      sV + (((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + (lane >> 4) * 8;

  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTileQ;
    const bool first = qt == 0;
    const int more = qt + 1 < n_qt ? 1 : 0;  // the next tile's group
    // this tile's Q (issued last, or before all of K and V on the first)
    cp_async_wait(first ? 2 * n_groups : 0);
    __syncthreads();
    unsigned qf[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const T* qrow =
          sQ + (warp * kRowsW + mt * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(qf[mt][kk], qrow + kk * 16);
    }
    __syncthreads();  // every warp holds its Q fragments: sQ may be refilled
    if (more) {
      issue_rows(sQ, qb, p.q_ss, q0 + kTileQ, kTileQ, p.Sq, tid);
      cp_async_commit();
    }

    // the thread's rows: i = 2 mt + half is row warp*32 + 16 mt + 8 half + g
    int qi[4], segq[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qi[i] = q0 + warp * kRowsW + (i >> 1) * 16 + (i & 1) * 8 + g;
      if (kMasked && p.seg_q != nullptr && qi[i] < p.Sq)
        segq[i] = p.seg_q[static_cast<long long>(b) * p.Sq + qi[i]];
    }
    // key chunks this warp needs: all, or on the causal path up to the
    // diagonal of its last row; none for a warp past Sq
    int kv_end = p.Sk;
    if (p.causal) kv_end = min(kv_end, q0 + warp * kRowsW + kRowsW + offset);
    if (q0 + warp * kRowsW >= p.Sq) kv_end = 0;
    const int n_mine = kv_end > 0 ? (kv_end + kChunk - 1) / kChunk : 0;

    // pass 1: the masked scores' row max
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
    for (int c = 0; c < n_chunks; ++c) {
      if (first && c % 2 == 0) {   // K group c / 2 has landed
        cp_async_wait(n_groups - 1 - c / 2 + n_groups + more);
        __syncthreads();
      }
      if (c >= n_mine) continue;
      float acc[2][4][4];
      chunk_scores(acc, qf, sK, c, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          score_tile<kMasked>(p, acc[mt][j], qi[2 * mt], qi[2 * mt + 1],
                              c * kChunk + j * 8 + tq * 2, offset,
                              segq[2 * mt], segq[2 * mt + 1], sSegK, sBias);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[2 * mt + (e >> 1)] = fmaxf(mx[2 * mt + (e >> 1)], acc[mt][j][e]);
        }
    }
    // the row max over the quad's columns; a row with no valid key (max at
    // NEG_INF) takes p = exp(s - inf) = 0 at every key, as the TPU kernel's
    // (s > NEG_INF / 2) factor gives it
    float m_use[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_use[i] = mx[i] > 0.5f * kNegInf ? mx[i] : INFINITY;
    }

    // pass 2: p from the final max, l, and O += (p * keep) V
    float oacc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mt][j][e] = 0.f;
    float l[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < n_chunks; ++c) {
      if (first && c % 2 == 0) {   // V group c / 2 has landed
        cp_async_wait(n_groups - 1 - c / 2 + more);
        __syncthreads();
      }
      if (c >= n_mine) continue;
      float acc[2][4][4];
      chunk_scores(acc, qf, sK, c, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj0 = c * kChunk + j * 8 + tq * 2;
          score_tile<kMasked>(p, acc[mt][j], qi[2 * mt], qi[2 * mt + 1], kj0,
                              offset, segq[2 * mt], segq[2 * mt + 1], sSegK,
                              sBias);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 2 * mt + (e >> 1);
            float pe = __expf(acc[mt][j][e] - m_use[i]);
            l[i] += pe;
            // dropout: l sums the undropped p, the value product p * keep
            if (kDrop && pe != 0.f)
              pe *= dropout_keep(p.drop, bh, p.Sq, p.Sk, qi[i], kj0 + (e & 1));
            acc[mt][j][e] = pe;
          }
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // P's A fragments for keys c*32 + 16 kk .. +15, rounded to bf16
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[mt][0] = pack2<T>(acc[mt][2 * kk][0], acc[mt][2 * kk][1]);
          a[mt][1] = pack2<T>(acc[mt][2 * kk][2], acc[mt][2 * kk][3]);
          a[mt][2] = pack2<T>(acc[mt][2 * kk + 1][0], acc[mt][2 * kk + 1][1]);
          a[mt][3] = pack2<T>(acc[mt][2 * kk + 1][2], acc[mt][2 * kk + 1][3]);
        }
        const T* vk = vrow + (c * kChunk + kk * 16) * kLd;
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          unsigned bv[4];
          ldmatrix_x4_trans(bv, vk + dp * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_16816<T>(oacc[mt][2 * dp], a[mt], bv[0], bv[1]);
            mma_16816<T>(oacc[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = fmaxf(l[i], 1e-30f);
      if (qi[i] >= p.Sq) continue;
      T* orow =
          p.o + ((static_cast<long long>(b) * p.Sq + qi[i]) * p.H + h) * kD;
      const float inv = 1.f / l[i];
      const int mt = i >> 1, half = i & 1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<unsigned*>(orow + j * 8 + tq * 2) =
            pack2<T>(oacc[mt][j][2 * half] * inv,
                     oacc[mt][j][2 * half + 1] * inv);
      if (tq == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi[i]] =
            mx[i] + logf(l[i]);
    }
  }
}

template <bool kMasked, bool kDrop, typename T>
cudaError_t launch(const TcParams<T>& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Sk);
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_packed_fwd_tc_kernel<T, kMasked, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_packed_fwd_tc_kernel<T, kMasked, kDrop>
      <<<p.B * p.H, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* seg_q, const void* seg_k, const void* bias, int B, int H,
        int Sq, int Sk, long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh, long long v_sb,
        long long v_ss, long long v_sh, float scale, int causal, int dropout,
        unsigned drop_threshold, unsigned drop_seed, float drop_scale,
        void* stream) {
  TcParams<T> p = {};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  p.lse = static_cast<float*>(lse);
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
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool masked = causal || seg_q != nullptr;
  cudaError_t err;
  if (masked)
    err = dropout ? launch<true, true>(p, s) : launch<true, false>(p, s);
  else
    err = dropout ? launch<false, true>(p, s) : launch<false, false>(p, s);
  return static_cast<int>(err);
}


}  // namespace

// K4a-direct's 16-bit tensor-core body, arguments as flash_packed.cu's
// paddle_flash_packed_fwd: dtype must be 1 (bfloat16) or 2 (float16); q, k
// and v rows must be 16-byte aligned (base pointers and the batch, sequence
// and head strides). Strides are in elements; seg_q, seg_k (both or neither)
// and bias may be null. Returns the cudaError_t of the launch (0 = launched).
extern "C" int paddle_flash_packed_fwd_tc(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg_q, const void* seg_k, const void* bias, int B, int H,
    int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int dtype, int dropout, unsigned drop_threshold, unsigned drop_seed,
    float drop_scale, void* stream) {
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh};
  bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (long long s : strides) aligned = aligned && s % 8 == 0;
  if (B <= 0 || H <= 0 || HK != H || Sq <= 0 || Sk <= 0 || Sk > kMaxSk ||
      D != kD || (dtype != 1 && dtype != 2) || !aligned ||
      (seg_q == nullptr) != (seg_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto body = dtype == 1 ? run<__nv_bfloat16> : run<__half>;
  return body(q, k, v, o, lse, seg_q, seg_k, bias, B, H, Sq, Sk, q_sb, q_ss,
              q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
              dropout, drop_threshold, drop_seed, drop_scale, stream);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
