// K1 and K4a-stream on the tensor cores: the flash-attention forward with an
// online softmax over key stages, bf16 or float16, for Hopper (sm_90a),
// CUDA C++.
//
// Replaces, for 16-bit inputs, two TPU kernels that compute one function:
//   paddle_tpu/ops/_pallas/flash_attention.py:_fwd_kernel (:224, launched by
//     _fwd at :404): K1, any supported head dim, grouped-query KV;
//   paddle_tpu/ops/_pallas/flash_attention_packed.py:_fwd_kernel (:102,
//     launched by _fwd at :267): K4a-stream, head dim 64, KV heads = heads.
// K4a-stream is K1 at D = 64 with HK = H, so one body serves both, through two
// C entries. The float32 inputs stay on the CUDA-core bodies (flash_fwd.cu,
// flash_packed_stream.cu): on the tensor cores float32 would mean TF32, which
// is not the function the reference computes. The wrappers pick the body by
// dtype and count their launches apart. bf16 is written below; float16 is the
// same template over the element type T (mma.cuh), rounding p and o to
// float16 where the bf16 body rounds to bf16, as JAX's kernel does for a
// float16 input (its dots name an f32 result type whatever the input).
//
// What it computes, per query head h of batch row b (KV head h / (H / HK)),
// rounded where the TPU kernels round:
//   s   = scale * q k^T (bf16 products, f32 sums), then bottom-right causal
//         (key j kept for query i when j <= i + Sk - Sq), then segments
//         (seg_q[b, i] == seg_k[b, j], else NEG_INF), then + key_bias[b, j]
// then over the key stages in order, with m, l and acc in f32:
//   m'  = max(m, max_j s),  p = exp(s - m') * (s > NEG_INF / 2)
//   a   = exp(m - m'),  l = l a + sum p,  acc = acc a + (p * keep, rounded to
//         bf16) v
//   o   = acc / max(l, 1e-30) rounded to bf16,  lse = m + log(max(l, 1e-30))
// keep is the attention-prob dropout factor of dropout.cuh (the hash of the
// flat query head b*H + h and the position), 1 without dropout; l sums the
// undropped p. m starts at NEG_INF = -1e30, a finite number, so a row that
// finds its first valid key in a later stage gets a = 0 and never NaN; a row
// with no valid key gives o = 0 and lse = -1e30 + log 1e-30. p is rounded
// against the running max of its stage, as the TPU kernel rounds it against
// the running max of its key block: the plain version walks the same stages
// (flash_fwd_reference's key_tile), so kernel and plain version round at the
// same points. A stage is 128 keys at D = 64 and 128, the key block that the
// JAX package's tests pin, and 64 at D = 256, where 128 would not fit the
// registers.
//
// Layout: q [B, Sq, H, D], k and v [B, Sk, HK, D] bf16, read through their
// batch, sequence and head strides (the last dimension dense, every row
// 16-byte aligned: views of a fused QKV projection go in without a copy).
// seg_q [B, Sq], seg_k [B, Sk] int32 and bias [B, Sk] f32 are dense or null,
// one row per batch row. o is written dense [B, Sq, H, D] and lse dense
// [B, H, Sq] f32, the lse that K2/K3 and the streamed K4 backward read. Any Sq
// and Sk: the ragged edges are masked here.
//
// Design. One block per (b*h, 128-query tile); each warp owns 16 * kMT query
// rows (kMT m-tiles: at D = 64 two, so that each K or V fragment read from
// shared memory feeds two products; at D = 128 and 256 one, because the
// scores of a 128-key stage and the output accumulator of two m-tiles would
// take 256 registers). K and V arrive in bf16 by cp.async in a double-buffered
// ring of stages (rows padded to D + 8 values, so that ldmatrix's eight row
// reads hit distinct banks): stage t + 1 loads while stage t computes, K and
// V in separate groups, so a stage's scores wait only for its K. Both
// products run on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32
// accumulate), fed by ldmatrix (ldmatrix.trans for V): S = Q K^T for the whole
// stage into registers (Q's fragments stay in registers where kQReg says so,
// else they are read from shared memory at each k-step), the masks, the row
// max and sum reduced over the four lanes of a row by shuffles, and p
// converted to bf16 straight into the A-operand registers of O += P V. No
// score goes through shared memory.
//
// The work beside the products (what set K4a-direct's speed on an H100, see
// flash_packed_tc.cu) is kept off the interior stages: a stage below the
// causal diagonal of all the warp's rows, inside Sk and without segments
// takes a score in one FMA (the key bias is staged per stage in shared
// memory, 0 without one); only a stage that meets
// the diagonal, the ragged end of Sk, or segments tests each score, and there
// the 16-key steps wholly above the warp's diagonal or past Sk are skipped
// (their p is 0). Segments and dropout are separate instantiations. A row
// that has no valid key yet takes exp(s - inf) = 0 for every score instead of
// a per-score (s > NEG_INF / 2) test; with a valid key the factor is 1 for
// every s that exp does not already take to 0.
//
// Causal load balance: the query tiles are issued longest first (the grid's
// slow axis runs from the last tile), the counterpart of the TPU kernel's
// triangular pairing (_paired_qi_kj, _pallas/flash_attention.py:211): at B =
// 1, S = 2048 there are 256 blocks for 132 SMs, and the short tiles fill the
// tail.
//
// What bounds it on an H100. Causal GPT-3 1.3B attention (B = 1, S = 2048,
// H = 16, D = 128) does 4 * D * pairs = 1.72e10 FLOPs against 33.6 MB: the
// operations bound it (0.0174 ms at 989 TFLOP/s); ERNIE's long shape (B = 16,
// S = 2048, H = 12, D = 64) 2.06e11 FLOPs (0.208 ms). mma.sync reaches part of
// the peak that wgmma with TMA reaches (FlashAttention-3's shape): that is the
// step after this one. Shared memory: 92 KB at D = 64 (two blocks of 4 warps
// an SM), 172 KB at D = 128 and 199 KB at D = 256 (one block of 8 warps).
// Registers (ptxas -v on sm_90a, nvcc 12.9; chip_smoke.py's build phase
// prints them): 244-255 a thread at D = 128 with no spills; 254-255 at D =
// 256, one instantiation (dropout, no segments) spilling 12 bytes; 255 at
// D = 64, spilling 8-396 bytes (the scores of a 128-key stage for two m-tiles
// take 128 registers and the output 64), which a 64-key stage would avoid at
// the cost of rounding at other points than the JAX package's tests pin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "dropout.cuh"
#include "mma.cuh"

namespace {

constexpr int kTileQ = 128;          // query rows per block
constexpr float kNegInf = -1e30f;    // NEG_INF of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;

// per head dim: m-tiles a warp owns, keys a stage, Q's fragments in registers
template <int D>
struct Shape;
template <>
struct Shape<64> {
  static constexpr int kMT = 2, kN = 128;
  static constexpr bool kQReg = false;
};
template <>
struct Shape<128> {
  static constexpr int kMT = 1, kN = 128;
  static constexpr bool kQReg = true;
};
template <>
struct Shape<256> {
  static constexpr int kMT = 1, kN = 64;
  static constexpr bool kQReg = false;
};

template <int D>
struct Cfg {
  static constexpr int kMT = Shape<D>::kMT;
  static constexpr int kN = Shape<D>::kN;
  static constexpr bool kQReg = Shape<D>::kQReg;
  static constexpr int kRowsW = 16 * kMT;         // query rows a warp owns
  static constexpr int kWarps = kTileQ / kRowsW;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = D + 8;               // padded smem row
  static constexpr int kSegs = D / 8;             // 16-byte pieces of a row
  static constexpr int kNT = kN / 8;              // 8-key n-tiles of a stage
  static constexpr int kDT = D / 8;               // 8-wide n-tiles of o
  static constexpr int kKD = D / 16;              // k-steps of Q K^T
  static constexpr int kQF = kQReg ? kKD : 1;     // Q fragments kept
};

template <typename T>
struct FwdTcParams {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;
  const int* seg_q;    // null: no segments
  const int* seg_k;
  const float* bias;   // null: no key bias
  int B, H, HK, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
  DropoutArgs drop;    // attention-prob dropout (dropout.cuh)
};

template <int D>
constexpr size_t smem_bytes() {
  // sQ [128][D+8], sK and sV [2][kN][D+8] bf16; sBias and sSegK [2][kN]
  using C = Cfg<D>;
  return sizeof(__nv_bfloat16) * (kTileQ + 4 * C::kN) * C::kLd +
         (sizeof(float) + sizeof(int)) * 2 * C::kN;
}

// rows [row0, row0 + n) of a [*, D] bf16 operand into padded smem rows, by
// cp.async; rows at or past n_rows are zero
template <int D, typename T>
__device__ __forceinline__ void issue_rows(T* dst, const T* base,
                                           long long row_stride, int row0,
                                           int n, int n_rows, int tid) {
  using C = Cfg<D>;
  for (int i = tid; i < n * C::kSegs; i += C::kThreads) {
    const int r = i / C::kSegs;
    const int seg = i - r * C::kSegs;
    const int row = row0 + r;
    const bool in = row < n_rows;
    const T* src =
        in ? base + static_cast<long long>(row) * row_stride + seg * 8 : base;
    cp_async16(dst + r * C::kLd + seg * 8, src, in);
  }
}

// S = Q K^T for the warp's rows and the stage's keys: s[mt][nt] holds m-tile
// mt's keys 8 nt .. 8 nt + 7 in mma.sync's accumulator layout. Each K
// fragment feeds every m-tile. With kSkip, 16-key steps from n16 on are not
// computed (their scores stay 0 and the caller masks them).
template <int D, bool kSkip, typename T>
__device__ __forceinline__ void stage_scores(
    float (&s)[Cfg<D>::kMT][Cfg<D>::kNT][4],
    const unsigned (&qf)[Cfg<D>::kMT][Cfg<D>::kQF][4],
    const T* sQw, const T* sKs, int lane, int n16) {
  using C = Cfg<D>;
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
  // lane's ldmatrix row: key (lane >> 4) * 8 + (lane & 7) of a 16-key pair of
  // n-tiles, d half ((lane >> 3) & 1) of a 16-wide k-step
  const T* kb =
      sKs + ((lane >> 4) * 8 + (lane & 7)) * C::kLd + ((lane >> 3) & 1) * 8;
  const T* qb = sQw + (lane & 15) * C::kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < C::kKD; ++kk) {
    unsigned a[C::kMT][4];
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      if constexpr (C::kQReg) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[mt][r] = qf[mt][kk][r];
      } else {
        ldmatrix_x4(a[mt], qb + mt * 16 * C::kLd + kk * 16);
      }
    }
#pragma unroll
    for (int jp = 0; jp < C::kNT / 2; ++jp) {
      if (kSkip && jp >= n16) continue;
      unsigned b[4];
      ldmatrix_x4(b, kb + jp * 16 * C::kLd + kk * 16);
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt) {
        mma_16816<T>(s[mt][2 * jp], a[mt], b[0], b[1]);
        mma_16816<T>(s[mt][2 * jp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// The scores after _fwd_kernel's masks, in its order: scale, then causal,
// then segments (a masked score is NEG_INF), then + bias. sB holds the stage's
// key bias (0 without one). Without kTest a score is one FMA: the caller takes
// that form only for a stage below the diagonal of all the warp's rows, inside
// Sk, without segments. A key at or past Sk does not exist: -inf.
template <int D, bool kTest, bool kSeg, typename T>
__device__ __forceinline__ void stage_masks(
    float (&s)[Cfg<D>::kMT][Cfg<D>::kNT][4], const FwdTcParams<T>& p,
    const float* sB, const int* sS, int k0, const int (&qi)[2 * Cfg<D>::kMT],
    const int (&segq)[2 * Cfg<D>::kMT], int offset, int tq) {
  using C = Cfg<D>;
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt) {
    const int c = nt * 8 + tq * 2;
    // c is even: one 8-byte read gives both keys' bias or segments
    const float2 bias = *reinterpret_cast<const float2*>(sB + c);
    int2 segk = make_int2(0, 0);
    if (kTest && kSeg) segk = *reinterpret_cast<const int2*>(sS + c);
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bb = (e & 1) ? bias.y : bias.x;
        float x = fmaf(s[mt][nt][e], p.scale, bb);
        if (kTest) {
          const int i = 2 * mt + (e >> 1);
          const int kj = k0 + c + (e & 1);
          const bool out =
              (p.causal && kj > qi[i] + offset) ||
              (kSeg && segq[i] != ((e & 1) ? segk.y : segk.x));
          if (out) x = kNegInf + bb;
          if (kj >= p.Sk) x = -INFINITY;
        }
        s[mt][nt][e] = x;
      }
  }
}

// O += P V for the stage: p (s, already p * keep) rounded to T in pairs
// into the A fragments of 16-key steps, V^T's fragments by ldmatrix.trans.
// With kSkip, 16-key steps from n16 on are skipped (their p is 0).
template <int D, bool kSkip, typename T>
__device__ __forceinline__ void stage_values(
    float (&o)[Cfg<D>::kMT][Cfg<D>::kDT][4],
    const float (&s)[Cfg<D>::kMT][Cfg<D>::kNT][4], const T* sVs,
    int lane, int n16) {
  using C = Cfg<D>;
  // a lane's ldmatrix.trans row of V: key ((lane >> 3) & 1) * 8 + (lane & 7)
  // of a 16-key step, d half (lane >> 4) of a 16-wide pair of n-tiles
  const T* vrow =
      sVs + (((lane >> 3) & 1) * 8 + (lane & 7)) * C::kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < C::kNT / 2; ++kk) {
    if (kSkip && kk >= n16) continue;
    unsigned a[C::kMT][4];
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      a[mt][0] = pack2<T>(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      a[mt][1] = pack2<T>(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      a[mt][2] = pack2<T>(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      a[mt][3] = pack2<T>(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
    const T* vk = vrow + kk * 16 * C::kLd;
#pragma unroll
    for (int dp = 0; dp < C::kDT / 2; ++dp) {
      unsigned bv[4];
      ldmatrix_x4_trans(bv, vk + dp * 16);
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt) {
        mma_16816<T>(o[mt][2 * dp], a[mt], bv[0], bv[1]);
        mma_16816<T>(o[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
      }
    }
  }
}

// The online softmax of one stage, in place: s becomes p * keep (f32, not yet
// rounded); m, l and o are rescaled. A row whose max is still at NEG_INF has
// no valid key so far: it takes exp(s - inf) = 0 at every key.
template <int D, bool kDrop, typename T>
__device__ __forceinline__ void stage_softmax(
    float (&s)[Cfg<D>::kMT][Cfg<D>::kNT][4],
    float (&o)[Cfg<D>::kMT][Cfg<D>::kDT][4], float (&m)[2 * Cfg<D>::kMT],
    float (&l)[2 * Cfg<D>::kMT], const FwdTcParams<T>& p, int bh, int k0,
    const int (&qi)[2 * Cfg<D>::kMT], int tq) {
  using C = Cfg<D>;
  float mx[2 * C::kMT];
#pragma unroll
  for (int i = 0; i < 2 * C::kMT; ++i) mx[i] = -INFINITY;
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[2 * mt + (e >> 1)] = fmaxf(mx[2 * mt + (e >> 1)], s[mt][nt][e]);
  float m_use[2 * C::kMT], alpha[2 * C::kMT];
#pragma unroll
  for (int i = 0; i < 2 * C::kMT; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = exp2f((m[i] - m_new) * kLog2e);   // both finite
    m[i] = m_new;
    m_use[i] = m_new > 0.5f * kNegInf ? m_new : INFINITY;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int dt = 0; dt < C::kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] *= alpha[2 * mt + (e >> 1)];
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 2 * mt + (e >> 1);
        float pe = exp2f((s[mt][nt][e] - m_use[i]) * kLog2e);
        l[i] += pe;
        // dropout: l sums the undropped p, the value product takes p * keep
        if (kDrop && pe != 0.f)
          pe *= dropout_keep(p.drop, bh, p.Sq, p.Sk, qi[i],
                             k0 + nt * 8 + tq * 2 + (e & 1));
        s[mt][nt][e] = pe;
      }
}

// ---------------------------------------------------------------------------
// Grid (B*H, query tiles), Cfg<D>::kThreads threads. kSeg: segment ids;
// kDrop: dropout.
// ---------------------------------------------------------------------------

template <typename T, int D, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
    flash_fwd_tc_kernel(const FwdTcParams<T> p) {
  using C = Cfg<D>;
  constexpr int kN = C::kN;
  constexpr int kLd = C::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kTileQ * kLd;   // [2][kN][kLd]
  T* sV = sK + 2 * kN * kLd;   // [2][kN][kLd]
  float* sBias = reinterpret_cast<float*>(sV + 2 * kN * kLd);   // [2][kN]
  int* sSegK = reinterpret_cast<int*>(sBias + 2 * kN);          // [2][kN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator rows g and g + 8 of an m-tile
  const int tq = lane & 3;   // accumulator columns 2 tq, 2 tq + 1
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.HK);   // _kv_index: no repeated KV
  // causal: the longest query tiles first
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kTileQ;
  const int offset = p.Sk - p.Sq;    // bottom-right causal alignment
  const int qw0 = q0 + warp * C::kRowsW;   // the warp's first and last rows
  const int qw1 = qw0 + C::kRowsW - 1;

  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const float* bias_row =
      p.bias != nullptr ? p.bias + static_cast<long long>(b) * p.Sk : nullptr;
  const int* segk_row =
      kSeg ? p.seg_k + static_cast<long long>(b) * p.Sk : nullptr;

  // stages the block needs: all, or on the causal path up to the diagonal of
  // its last row (none when Sq > Sk leaves every row empty)
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kTileQ + offset);
  const int n_st = kv_end > 0 ? (kv_end + kN - 1) / kN : 0;

  // stage st's K (with its key bias and segments) and V, one cp.async group
  // each, into slot st & 1; past the last stage two empty groups, so that
  // every stage waits on the same counts
  auto issue_stage = [&](int st) {
    if (st < n_st) {
      const int k0 = st * kN;
      const int slot = st & 1;
      issue_rows<D>(sK + slot * kN * kLd, kb, p.k_ss, k0, kN, p.Sk, tid);
      for (int i = tid; i < kN; i += C::kThreads) {
        const int kj = k0 + i;
        const bool in = kj < p.Sk;
        cp_async4(sBias + slot * kN + i,
                  in && bias_row != nullptr ? bias_row + kj
                                            : static_cast<const void*>(kb),
                  in && bias_row != nullptr);
        if (kSeg)
          cp_async4(sSegK + slot * kN + i,
                    in ? segk_row + kj : static_cast<const void*>(kb), in);
      }
      cp_async_commit();
      issue_rows<D>(sV + slot * kN * kLd, vb, p.v_ss, k0, kN, p.Sk, tid);
      cp_async_commit();
    } else {
      cp_async_commit();
      cp_async_commit();
    }
  };

  issue_rows<D>(sQ, qb, p.q_ss, q0, kTileQ, p.Sq, tid);
  cp_async_commit();
  issue_stage(0);

  // the thread's rows: i = 2 mt + half is row qw0 + 16 mt + 8 half + g
  int qi[2 * C::kMT], segq[2 * C::kMT];
#pragma unroll
  for (int i = 0; i < 2 * C::kMT; ++i) {
    qi[i] = qw0 + (i >> 1) * 16 + (i & 1) * 8 + g;
    segq[i] = kSeg && qi[i] < p.Sq
                  ? p.seg_q[static_cast<long long>(b) * p.Sq + qi[i]] : 0;
  }
  const T* sQw = sQ + warp * C::kRowsW * kLd;
  const bool rows_in = qw0 < p.Sq;
  // the keys the warp's rows need end here (past it: causally masked or
  // beyond Sk)
  const int kw_end = p.causal ? min(p.Sk, qw1 + offset + 1) : p.Sk;

  cp_async_wait<2>();   // Q has landed (K0 and V0 may pend)
  __syncthreads();
  unsigned qf[C::kMT][C::kQF][4];
  if constexpr (C::kQReg) {
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
      for (int kk = 0; kk < C::kQF; ++kk)
        ldmatrix_x4(qf[mt][kk], sQw + (mt * 16 + (lane & 15)) * kLd +
                                    (lane >> 4) * 8 + kk * 16);
  }

  float m[2 * C::kMT], l[2 * C::kMT];
  float o[C::kMT][C::kDT][4];
#pragma unroll
  for (int i = 0; i < 2 * C::kMT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int dt = 0; dt < C::kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    const int k0 = st * kN;
    const int slot = st & 1;
    cp_async_wait<1>();   // this stage's K has landed (its V may pend)
    __syncthreads();      // ... for every thread; every warp is done with
                          // the last stage, whose slot the next one takes
    issue_stage(st + 1);
    // a warp with no row that needs a key of this stage leaves its state as
    // a walk over masked keys would (p = 0, alpha = 1)
    const bool active = rows_in && k0 < kw_end;
    // the per-score masks: at the diagonal, at the end of Sk, or segments
    const bool test = kSeg || k0 + kN > p.Sk ||
                      (p.causal && k0 + kN - 1 > qw0 + offset);
    const int n16 = min(kN / 16, (kw_end - k0 + 15) / 16);
    float s[C::kMT][C::kNT][4];
    const float* sB = sBias + slot * kN;
    if (active) {
      if (test) {
        stage_scores<D, true>(s, qf, sQw, sK + slot * kN * kLd, lane, n16);
        stage_masks<D, true, kSeg>(s, p, sB, sSegK + slot * kN, k0, qi, segq,
                                   offset, tq);
      } else {
        stage_scores<D, false>(s, qf, sQw, sK + slot * kN * kLd, lane, n16);
        stage_masks<D, false, kSeg>(s, p, sB, sSegK + slot * kN, k0, qi,
                                    segq, offset, tq);
      }
      stage_softmax<D, kDrop>(s, o, m, l, p, bh, k0, qi, tq);
    }
    cp_async_wait<2>();   // this stage's V has landed
    __syncthreads();
    if (active) {
      if (test)
        stage_values<D, true>(o, s, sV + slot * kN * kLd, lane, n16);
      else
        stage_values<D, false>(o, s, sV + slot * kN * kLd, lane, n16);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2 * C::kMT; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    if (qi[i] >= p.Sq) continue;
    T* orow =
        p.o + ((static_cast<long long>(b) * p.Sq + qi[i]) * p.H + h) * D;
    const int mt = i >> 1, half = i & 1;
#pragma unroll
    for (int dt = 0; dt < C::kDT; ++dt)
      *reinterpret_cast<unsigned*>(orow + dt * 8 + tq * 2) =
          pack2<T>(o[mt][dt][2 * half] / l[i],
                   o[mt][dt][2 * half + 1] / l[i]);
    if (tq == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi[i]] =
          m[i] + logf(l[i]);
  }
}

template <int D, bool kSeg, bool kDrop, typename T>
cudaError_t launch(const FwdTcParams<T>& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<T, D, kSeg, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + kTileQ - 1) / kTileQ);
  flash_fwd_tc_kernel<T, D, kSeg, kDrop>
      <<<grid, Cfg<D>::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dispatch(const FwdTcParams<T>& p, cudaStream_t s) {
  const bool seg = p.seg_q != nullptr;
  if (seg)
    return p.drop.on ? launch<D, true, true>(p, s)
                     : launch<D, true, false>(p, s);
  return p.drop.on ? launch<D, false, true>(p, s)
                   : launch<D, false, false>(p, s);
}

template <typename T>
int run_t(const void* q, const void* k, const void* v, void* o, void* lse,
          const void* seg_q, const void* seg_k, const void* bias, int B,
          int H, int HK, int Sq, int Sk, int D, long long q_sb,
          long long q_ss, long long q_sh, long long k_sb, long long k_ss,
          long long k_sh, long long v_sb, long long v_ss, long long v_sh,
          float scale, int causal, int dropout, unsigned drop_threshold,
          unsigned drop_seed, float drop_scale, void* stream) {
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh};
  bool aligned = (reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (long long s : strides) aligned = aligned && s % 8 == 0;
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK || Sq <= 0 || Sk < 0 ||
      !aligned || (seg_q == nullptr) != (seg_k == nullptr) ||
      (Sq + kTileQ - 1) / kTileQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdTcParams<T> p = {};
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
  p.scale = scale;
  p.causal = causal;
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(dispatch<64>(p, s));
    case 128:
      return static_cast<int>(dispatch<128>(p, s));
    case 256:
      return static_cast<int>(dispatch<256>(p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the body of dtype 1 (bfloat16) or 2 (float16)
int run(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* seg_q, const void* seg_k, const void* bias, int B, int H,
        int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh, float scale,
        int causal, int dtype, int dropout, unsigned drop_threshold,
        unsigned drop_seed, float drop_scale, void* stream) {
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  auto body = dtype == 1 ? run_t<__nv_bfloat16> : run_t<__half>;
  return body(q, k, v, o, lse, seg_q, seg_k, bias, B, H, HK, Sq, Sk, D, q_sb,
              q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
              dropout, drop_threshold, drop_seed, drop_scale, stream);
}

}  // namespace

// K1's 16-bit tensor-core body, arguments as flash_fwd.cu's
// paddle_flash_fwd: dtype must be 1 (bfloat16) or 2 (float16), D 64, 128 or
// 256, and q, k and v rows 16-byte
// aligned (base pointers and the batch, sequence and head strides). Strides
// are in elements; seg_q, seg_k (both or neither) and bias may be null.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int paddle_flash_fwd_tc(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg_q, const void* seg_k, const void* bias, int B, int H,
    int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int dtype, int dropout, unsigned drop_threshold, unsigned drop_seed,
    float drop_scale, void* stream) {
  return run(q, k, v, o, lse, seg_q, seg_k, bias, B, H, HK, Sq, Sk, D, q_sb,
             q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
             dtype, dropout, drop_threshold, drop_seed, drop_scale, stream);
}

// K4a-stream's 16-bit tensor-core body, arguments as flash_packed_stream.cu's
// paddle_flash_packed_fwd_stream: the same body at D = 64 with HK = H.
extern "C" int paddle_flash_packed_fwd_stream_tc(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* seg_q, const void* seg_k, const void* bias, int B, int H,
    int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int dtype, int dropout, unsigned drop_threshold, unsigned drop_seed,
    float drop_scale, void* stream) {
  if (D != 64 || HK != H || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, o, lse, seg_q, seg_k, bias, B, H, HK, Sq, Sk, D, q_sb,
             q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
             dtype, dropout, drop_threshold, drop_seed, drop_scale, stream);
}

// The keys a stage takes at head dim D (0 for a D the body does not take):
// the plain version's key_tile must equal it (flash_attention.py's
// TC_KEY_TILE), and chip_smoke.py checks that it does.
extern "C" int paddle_flash_fwd_tc_stage(int D) {
  switch (D) {
    case 64:
      return Cfg<64>::kN;
    case 128:
      return Cfg<128>::kN;
    case 256:
      return Cfg<256>::kN;
    default:
      return 0;
  }
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
