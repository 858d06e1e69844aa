// K4b-dq and K4b-dkv on the tensor cores: the streamed flash-attention
// backward at head dim 64, bf16, for Hopper (sm_90a), CUDA C++.
//
// Replaces, for bf16 inputs, two TPU kernels of
// paddle_tpu/ops/_pallas/flash_attention_packed.py:
//   paddle_flash_packed_bwd_dq_tc    _bwd_dq_kernel   (:297, launched :582)
//   paddle_flash_packed_bwd_dkv_tc   _bwd_dkv_kernel  (:348, launched :652)
// K4 runs them for d = 64 attention whose keys span more than one of the
// JAX package's tiles (ERNIE at its own 2048-token context). The float32
// inputs stay on the CUDA-core bodies of flash_packed_stream.cu (on the
// tensor cores float32 would mean TF32, which is not the function the
// reference computes), and so does dk/dv-direct (_bwd_dkv_kernel_direct) in
// both dtypes. The wrappers pick the body by dtype and count their launches
// apart.
//
// What they compute, per head (KV heads = heads), from the forward's lse
// and delta = rowsum(dO * O), with the masks in the TPU kernels' order and
// rounded where they round:
//   s   = scale * q k^T (bf16 products, f32 sums), then bottom-right causal
//         (key j kept for query i when j <= i + Sk - Sq), then segments
//         (seg_q[i] == seg_k[j], else NEG_INF), then + key_bias[j]
//   p   = exp(s - lse) * (s > NEG_INF / 2),  dp = dO v^T, times keep
//   ds  = p (dp - delta) scale, rounded to bf16                  (:335-340)
//   dq  = sum over keys of ds k                        (f32, rounded once)
//   dv  = sum over queries of (p keep, rounded to bf16)^T dO     (:392-399)
//   dk  = sum over queries of ds^T q                   (f32, rounded once)
// keep is the attention-prob dropout factor of dropout.cuh (the hash of the
// flat query head b*H + h and the position), 1 without dropout. A query row
// with no valid key (lse = NEG_INF + log 1e-30) gives dq = 0 and adds
// nothing to dk or dv.
//
// Layout: q, dO [B, Sq, H, 64] and k, v [B, Sk, H, 64] bf16, read through
// their batch, sequence and head strides (the last dimension dense, every row
// 16-byte aligned: the views of a fused QKV projection go in without a copy).
// lse and delta are dense [B, H, Sq] f32; seg_q [B, Sq], seg_k [B, Sk] int32
// and bias [B, Sk] f32 dense or null. dq, dk and dv are written dense. Any
// Sq and Sk: the ragged edges are masked here.
//
// Design. As on the TPU, each block owns its output tile and sums over the
// other axis in a fixed order, in f32 registers: no atomics, and results
// repeat bit for bit. dq and dk/dv stay two kernels, each recomputing s and
// p, as the TPU kernels do. Blocks of 4 warps own 64 rows, 16 a warp (one
// m-tile of mma.sync.m16n8k16, bf16 in, f32 accumulate); the other axis
// streams in stages of 64 through a cp.async double-buffered ring in shared
// memory (rows padded to 72 values, so that ldmatrix's eight row reads hit
// distinct banks): stage t + 1 loads while stage t computes.
// - dq: one block per (64-query tile, b*h); Q and dO fragments stay in
//   registers, with lse and delta of the thread's two rows. Per key stage,
//   S = Q K^T and dP = dO V^T (K and V as B operands by ldmatrix), the masks
//   and ds in registers, ds packed to bf16 straight into the A operand of
//   dQ += dS K, with K as the B operand by ldmatrix.trans.
// - dk/dv: one block per (64-key tile, b*h), keys as rows: K and V fragments
//   stay in registers, with each key row's bias and segment id. Q and dO
//   stream; each query stage's lse (+inf for a row with no valid key or past
//   Sq), delta and seg_q are loaded into registers while the stage before
//   computes, and stored to shared memory after it. S^T = K Q^T and dP^T =
//   V dO^T, then dV += (P^T keep) dO and dK += dS^T Q with dO and Q as B
//   operands by ldmatrix.trans. It starts at the first query stage that
//   reaches its key tile under causal masking.
// No score goes through shared memory.
//
// Registers set the shape. At D = 64 one m-tile takes 32 f32 registers for
// the scores of a 64-wide stage, 32 for dp, 32 for each output accumulator
// (one for dq, two for dk/dv) and 16 for each resident operand: dq about
// 128 before addresses, dk/dv about 160. Two m-tiles a warp, or 128-wide
// stages, would pass the 255 a thread allows. The stage is also the unit of
// the f32 sums that the plain versions walk (64 keys for dq, 64 queries for
// dk/dv: flash_attention_packed.KERNEL_TILE, which paddle_flash_packed_bwd_
// tc_stage reports and chip_smoke.py holds equal).
//
// The work beside the products is kept off the interior stages (what set
// K4a-direct's first tensor-core body's speed, see flash_packed_tc.cu): a
// stage where every (row, column) pair of the warp is inside Sq and Sk and
// below the causal diagonal, without segments, takes a score in an FMA, a
// subtraction, a multiply and an exp2; only the stages at the diagonal, at
// the ragged end of the streamed axis or with segments test each score.
// Segments and dropout are separate instantiations. x - lse is taken before
// the multiply by log2 e, as the forward takes s - m: where the key bias is
// -1e9 an f32 step is 64, and only the difference is exact (for a row whose
// keys all carry the padding bias, x and lse are both near -1e9, and
// x log2 e - lse log2 e with the two products rounded apart would put p off
// by up to 2^64). The keyless row: its lse is NEG_INF + log 1e-30, so
// exp(s - lse) of a masked score would be exp(+69); the per-score
// (s > NEG_INF / 2) test of the tested stages zeroes it, and such a row's lse
// is replaced by +inf once at load, so that every p it meets is exp(-inf) = 0.
// Causal query tiles of dq are issued longest first; the key tiles of dk/dv
// are in that order already. The grid's fast axis is the tile, so the
// blocks in flight share a few heads' K and V (or Q and dO) in L2.
//
// What bounds them on an H100. At ERNIE's long shape (B = 16, S = 2048,
// H = 12, non-causal: 192 heads x 2048^2 pairs) dq does 6 * 64 * pairs =
// 3.09e11 FLOPs against 204 MB, dk/dv 8 * 64 * pairs = 4.12e11 against 254
// MB: the operations bound them at the 989 TFLOP/s bf16 peak (0.313 and
// 0.417 ms). mma.sync reaches part of the peak that wgmma with TMA reaches;
// beside the products each score takes an exp2 and about ten FP32
// operations (and the murmur3 hash under dropout), which at D = 64 has
// fewer product FLOPs to hide behind than at D = 128. Shared memory: 55 KB
// a block (dq) and 56 KB (dk/dv). Registers and spills: ptxas -v on
// sm_90a, which chip_smoke.py's build phase prints; PERF.md records them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "dropout.cuh"
#include "mma.cuh"

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;      // a block's own rows
constexpr int kN = 64;                  // a stage: keys (dq), queries (dk/dv)
constexpr int kLd = kD + 8;             // padded smem row, in values
constexpr int kSegs = kD / 8;           // 16-byte pieces of a row
constexpr int kNT = kN / 8;             // 8-wide n-tiles of a stage
constexpr int kDT = kD / 8;             // 8-wide n-tiles of an output row
constexpr int kKD = kD / 16;            // k-steps over the head dim
constexpr float kNegInf = -1e30f;       // NEG_INF of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
// blocks an SM keeps (the register budget: 65536 / (128 * blocks))
constexpr int kMinBlocksDq = 3;
constexpr int kMinBlocksDkv = 2;

static_assert(kTile == kN, "issue_rows copies kN rows, the block's too");

using bf16 = __nv_bfloat16;

struct BwdTcParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  const int* seg_q;    // null: no segments
  const int* seg_k;
  const float* bias;   // null: no key bias
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  float scale;
  int causal;
  DropoutArgs drop;    // attention-prob dropout (dropout.cuh)
};

// sQ/sDO (dq) or sK/sV (dk/dv) [64][kLd], the ring's two operands
// [2][64][kLd] bf16; the per-column inputs of the two stages
constexpr size_t kOperandBytes = sizeof(bf16) * 6 * kN * kLd;
constexpr size_t kDqSmem = kOperandBytes + (sizeof(float) + sizeof(int)) * 2 * kN;
constexpr size_t kDkvSmem = kOperandBytes + (2 * sizeof(float) + sizeof(int)) * 2 * kN;

// rows [row0, row0 + 64) of a [*, 64] bf16 operand into padded smem rows, by
// cp.async; rows at or past n_rows are zero
__device__ __forceinline__ void issue_rows(bf16* dst, const bf16* base,
                                           long long row_stride, int row0,
                                           int n_rows, int tid) {
  for (int i = tid; i < kN * kSegs; i += kThreads) {
    const int r = i / kSegs;
    const int seg = i - r * kSegs;
    const int row = row0 + r;
    const bool in = row < n_rows;
    const bf16* src =
        in ? base + static_cast<long long>(row) * row_stride + seg * 8 : base;
    cp_async16(dst + r * kLd + seg * 8, src, in);
  }
}

// the A fragments of the warp's 16 rows (from sRows) over the head dim
__device__ __forceinline__ void load_frags(unsigned (&f)[kKD][4],
                                           const bf16* sRows, int lane) {
  const bf16* p = sRows + (lane & 15) * kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk) ldmatrix_x4(f[kk], p + kk * 16);
}

// acc = A B^T: A the warp's 16 rows (fragments a), B a stage of 64 rows of
// the head dim in smem (sB: [64][kLd]); acc[nt] holds columns 8 nt .. 8 nt + 7
// of the stage in mma.sync's accumulator layout. Each B fragment is read by
// ldmatrix (a lane's row: (lane >> 4) * 8 + (lane & 7) of a 16-row pair of
// n-tiles, d half ((lane >> 3) & 1) of a 16-wide k-step).
__device__ __forceinline__ void products_nt(float (&acc)[kNT][4],
                                            const unsigned (&a)[kKD][4],
                                            const bf16* sB, int lane) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const bf16* bb =
      sB + ((lane >> 4) * 8 + (lane & 7)) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk)
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      unsigned b[4];
      ldmatrix_x4(b, bb + jp * 16 * kLd + kk * 16);
      mma_16816(acc[2 * jp], a[kk], b[0], b[1]);
      mma_16816(acc[2 * jp + 1], a[kk], b[2], b[3]);
    }
}

// acc += X B: X the warp's 16 rows over the stage's 64 columns (f32, in the
// accumulator layout of products_nt), rounded to bf16 in pairs into A
// fragments of 16-column steps; B the stage's 64 rows of the head dim in smem
// by ldmatrix.trans (a lane's row: ((lane >> 3) & 1) * 8 + (lane & 7) of a
// 16-row step, d half (lane >> 4) of a 16-wide pair of n-tiles).
__device__ __forceinline__ void products_tn(float (&acc)[kDT][4],
                                            const float (&x)[kNT][4],
                                            const bf16* sB, int lane) {
  const bf16* br =
      sB + (((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    unsigned a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < kDT / 2; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, br + kk * 16 * kLd + dp * 16);
      mma_16816(acc[2 * dp], a, b[0], b[1]);
      mma_16816(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// the lse a query row's p is taken against: its own, or +inf for a row past
// Sq or with no valid key (lse at NEG_INF + log 1e-30), so that every p of
// such a row is exp(-inf) = 0
__device__ __forceinline__ float row_lse(float lse, bool in) {
  return in && lse > 0.5f * kNegInf ? lse : INFINITY;
}

// p of one score from its scaled, biased value x: the masks of _bwd_dq_kernel
// / _bwd_dkv_kernel in their order where kTest (out: causal or segments),
// else x as it is. x - lse is taken first, as the forward takes s - m: a row
// whose keys all carry bench.py's -1e9 padding bias has x and lse near -1e9,
// where an f32 step is 64, and only the difference is exact.
template <bool kTest>
__device__ __forceinline__ float prob(float x, float bias, bool out,
                                      float lse) {
  if (kTest) {
    if (out) x = kNegInf + bias;
    return x > 0.5f * kNegInf ? exp2f((x - lse) * kLog2e) : 0.f;
  }
  return exp2f((x - lse) * kLog2e);
}

// ---------------------------------------------------------------------------
// dq. Grid (query tiles, B*H), 128 threads.
// ---------------------------------------------------------------------------

// s (the stage's S) becomes ds, rounded later as products_tn packs it. sB
// and sS hold the stage's key bias (0 without one) and segment ids.
template <bool kSeg, bool kDrop, bool kTest>
__device__ __forceinline__ void dq_stage(float (&s)[kNT][4],
                                         const float (&dp)[kNT][4],
                                         const BwdTcParams& p, const float* sB,
                                         const int* sS, int bh, int k0,
                                         const int (&qi)[2],
                                         const int (&segq)[2],
                                         const float (&lse)[2],
                                         const float (&dlt)[2], int offset,
                                         int tq) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = nt * 8 + tq * 2;
    // c is even: one 8-byte read gives both keys' bias or segments
    const float2 bias = *reinterpret_cast<const float2*>(sB + c);
    int2 segk = make_int2(0, 0);
    if (kTest && kSeg) segk = *reinterpret_cast<const int2*>(sS + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int kj = k0 + c + (e & 1);
      const float bb = (e & 1) ? bias.y : bias.x;
      bool out = false;
      if (kTest)
        out = (p.causal && kj > qi[i] + offset) ||
              (kSeg && segq[i] != ((e & 1) ? segk.y : segk.x));
      float pe = prob<kTest>(fmaf(s[nt][e], p.scale, bb), bb, out, lse[i]);
      if (kTest && kj >= p.Sk) pe = 0.f;   // the key does not exist
      float dpv = dp[nt][e];
      if (kDrop && pe != 0.f)
        dpv *= dropout_keep(p.drop, bh, p.Sq, p.Sk, qi[i], kj);
      s[nt][e] = pe * (dpv - dlt[i]) * p.scale;
    }
  }
}

template <bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, kMinBlocksDq)
    flash_packed_bwd_dq_tc_kernel(const BwdTcParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [64][kLd]
  bf16* sDO = sQ + kTile * kLd;                   // [64][kLd]
  bf16* sK = sDO + kTile * kLd;                   // [2][kN][kLd]
  bf16* sV = sK + 2 * kN * kLd;                   // [2][kN][kLd]
  float* sBias = reinterpret_cast<float*>(sV + 2 * kN * kLd);   // [2][kN]
  int* sSegK = reinterpret_cast<int*>(sBias + 2 * kN);          // [2][kN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator rows g and g + 8 of the m-tile
  const int tq = lane & 3;   // accumulator columns 2 tq, 2 tq + 1
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // causal: the longest query tiles first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTile;
  const int offset = p.Sk - p.Sq;   // bottom-right causal alignment
  const int qw0 = q0 + warp * 16;   // the warp's first row

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* bias_row =
      p.bias != nullptr ? p.bias + static_cast<long long>(b) * p.Sk : nullptr;
  const int* segk_row =
      kSeg ? p.seg_k + static_cast<long long>(b) * p.Sk : nullptr;

  // stages the block needs: all, or on the causal path up to the diagonal
  // of its last row (none when Sq > Sk leaves every row empty)
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kTile + offset);
  const int n_st = kv_end > 0 ? (kv_end + kN - 1) / kN : 0;

  // stage st's K, V, key bias and segments into slot st & 1, one group
  auto issue_stage = [&](int st) {
    const int k0 = st * kN;
    const int slot = st & 1;
    issue_rows(sK + slot * kN * kLd, kb, p.k_ss, k0, p.Sk, tid);
    issue_rows(sV + slot * kN * kLd, vb, p.v_ss, k0, p.Sk, tid);
    for (int i = tid; i < kN; i += kThreads) {
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
  };

  issue_rows(sQ, qb, p.q_ss, q0, p.Sq, tid);
  issue_rows(sDO, dob, p.do_ss, q0, p.Sq, tid);
  cp_async_commit();
  if (n_st > 0) issue_stage(0);

  // the thread's rows: i = 0, 1 is row qw0 + g + 8 i
  const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
  int qi[2], segq[2];
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = qw0 + g + 8 * i;
    const bool in = qi[i] < p.Sq;
    lse[i] = row_lse(in ? p.lse[stat0 + qi[i]] : 0.f, in);
    dlt[i] = in ? p.delta[stat0 + qi[i]] : 0.f;
    segq[i] = kSeg && in ? p.seg_q[static_cast<long long>(b) * p.Sq + qi[i]]
                         : 0;
  }

  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[kKD][4], dof[kKD][4];
  load_frags(qf, sQ + warp * 16 * kLd, lane);
  load_frags(dof, sDO + warp * 16 * kLd, lane);

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const bool rows_in = qw0 < p.Sq;
  // the keys the warp's rows need end here (past it: causally masked or
  // beyond Sk)
  const int kw_end = p.causal ? min(p.Sk, qw0 + 16 + offset) : p.Sk;

  for (int st = 0; st < n_st; ++st) {
    const int k0 = st * kN;
    const int slot = st & 1;
    cp_async_wait<0>();   // this stage has landed
    __syncthreads();      // ... for every thread; every warp is done with
                          // the last stage, whose slot the next one takes
    if (st + 1 < n_st) issue_stage(st + 1);
    // a warp whose rows need no key of this stage would add zeros
    if (!rows_in || k0 >= kw_end) continue;
    const bf16* sKs = sK + slot * kN * kLd;
    float s[kNT][4], dp[kNT][4];
    products_nt(s, qf, sKs, lane);
    products_nt(dp, dof, sV + slot * kN * kLd, lane);
    // the per-score masks: at the diagonal, at the end of Sk, or segments
    const bool test = kSeg || k0 + kN > p.Sk ||
                      (p.causal && k0 + kN - 1 > qw0 + offset);
    if (test)
      dq_stage<kSeg, kDrop, true>(s, dp, p, sBias + slot * kN,
                                  sSegK + slot * kN, bh, k0, qi, segq, lse,
                                  dlt, offset, tq);
    else
      dq_stage<kSeg, kDrop, false>(s, dp, p, sBias + slot * kN,
                                   sSegK + slot * kN, bh, k0, qi, segq, lse,
                                   dlt, offset, tq);
    products_tn(acc, s, sKs, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qi[i] >= p.Sq) continue;
    bf16* row = p.dq + ((static_cast<long long>(b) * p.Sq + qi[i]) * p.H + h) * kD;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + tq * 2) =
          __floats2bfloat162_rn(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// dk/dv. Grid (key tiles, B*H), 128 threads.
// ---------------------------------------------------------------------------

// s (the stage's S^T) becomes p keep and dp (dP^T) becomes ds, both rounded
// later as products_tn packs them. sLse, sDl, sSq hold the stage's queries'
// lse (row_lse), delta and segment ids.
template <bool kSeg, bool kDrop, bool kTest>
__device__ __forceinline__ void dkv_stage(float (&s)[kNT][4],
                                          float (&dp)[kNT][4],
                                          const BwdTcParams& p,
                                          const float* sLse, const float* sDl,
                                          const int* sSq, int bh, int q0,
                                          const int (&kj)[2],
                                          const float (&kbias)[2],
                                          const int (&kseg)[2], int offset,
                                          int tq) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = nt * 8 + tq * 2;
    const float2 lse = *reinterpret_cast<const float2*>(sLse + c);
    const float2 dl = *reinterpret_cast<const float2*>(sDl + c);
    int2 segq = make_int2(0, 0);
    if (kTest && kSeg) segq = *reinterpret_cast<const int2*>(sSq + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int qi = q0 + c + (e & 1);
      bool out = false;
      if (kTest)
        out = (p.causal && kj[i] > qi + offset) ||
              (kSeg && ((e & 1) ? segq.y : segq.x) != kseg[i]);
      const float pe = prob<kTest>(fmaf(s[nt][e], p.scale, kbias[i]),
                                   kbias[i], out, (e & 1) ? lse.y : lse.x);
      const float de = (e & 1) ? dl.y : dl.x;
      if (kDrop) {
        const float keep =
            pe != 0.f ? dropout_keep(p.drop, bh, p.Sq, p.Sk, qi, kj[i]) : 1.f;
        dp[nt][e] = pe * (dp[nt][e] * keep - de) * p.scale;
        s[nt][e] = pe * keep;
      } else {
        dp[nt][e] = pe * (dp[nt][e] - de) * p.scale;
        s[nt][e] = pe;
      }
    }
  }
}

template <bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, kMinBlocksDkv)
    flash_packed_bwd_dkv_tc_kernel(const BwdTcParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [64][kLd]
  bf16* sV = sK + kTile * kLd;                    // [64][kLd]
  bf16* sQ = sV + kTile * kLd;                    // [2][kN][kLd]
  bf16* sDO = sQ + 2 * kN * kLd;                  // [2][kN][kLd]
  float* sLse = reinterpret_cast<float*>(sDO + 2 * kN * kLd);  // [2][kN]
  float* sDl = sLse + 2 * kN;                                  // [2][kN]
  int* sSq = reinterpret_cast<int*>(sDl + 2 * kN);             // [2][kN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * kTile;   // causal: tile 0 is the longest
  const int offset = p.Sk - p.Sq;
  const int kw0 = k0 + warp * 16;      // the warp's first key

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // the first query stage with a row that reaches this key tile:
  // (qt + 1) * 64 - 1 + offset >= k0, as _bwd_dkv_kernel tests it
  const int nq = (p.Sq + kN - 1) / kN;
  const int x = k0 - offset;
  const int qt_first = p.causal && x > 0 ? x / kN : 0;
  const int n_st = max(0, nq - qt_first);

  // query stage it's Q and dO into slot it & 1, one group
  auto issue_stage = [&](int it) {
    const int q0 = (qt_first + it) * kN;
    const int slot = it & 1;
    issue_rows(sQ + slot * kN * kLd, qb, p.q_ss, q0, p.Sq, tid);
    issue_rows(sDO + slot * kN * kLd, dob, p.do_ss, q0, p.Sq, tid);
    cp_async_commit();
  };
  // query q0 + tid's lse (row_lse), delta and segment id (threads < kN)
  auto load_stats = [&](int q0, float& ls, float& dl, int& sg) {
    const int qi = q0 + tid;
    const bool in = qi < p.Sq;
    ls = row_lse(in ? p.lse[stat0 + qi] : 0.f, in);
    dl = in ? p.delta[stat0 + qi] : 0.f;
    sg = kSeg && in ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
  };

  issue_rows(sK, kb, p.k_ss, k0, p.Sk, tid);
  issue_rows(sV, vb, p.v_ss, k0, p.Sk, tid);
  cp_async_commit();
  float ls_next = 0.f, dl_next = 0.f;
  int sg_next = 0;
  if (n_st > 0) {
    issue_stage(0);
    if (tid < kN) {
      load_stats(qt_first * kN, ls_next, dl_next, sg_next);
      sLse[tid] = ls_next;
      sDl[tid] = dl_next;
      if (kSeg) sSq[tid] = sg_next;
    }
  }

  // the thread's key rows: i = 0, 1 is key kw0 + g + 8 i
  int kj[2], kseg[2];
  float kbias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kj[i] = kw0 + g + 8 * i;
    const bool in = kj[i] < p.Sk;
    const long long at = static_cast<long long>(b) * p.Sk + kj[i];
    kbias[i] = in && p.bias != nullptr ? p.bias[at] : 0.f;
    kseg[i] = kSeg && in ? p.seg_k[at] : 0;
  }

  cp_async_wait<0>();
  __syncthreads();
  unsigned kf[kKD][4], vf[kKD][4];
  load_frags(kf, sK + warp * 16 * kLd, lane);
  load_frags(vf, sV + warp * 16 * kLd, lane);

  float acc_dk[kDT][4], acc_dv[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_dk[dt][e] = 0.f;
      acc_dv[dt][e] = 0.f;
    }

  const bool keys_in = kw0 < p.Sk;
  for (int it = 0; it < n_st; ++it) {
    const int q0 = (qt_first + it) * kN;
    const int slot = it & 1;
    cp_async_wait<0>();   // this stage's Q and dO have landed
    __syncthreads();      // ... and its stats are stored; every warp is
                          // done with the last stage, whose slot is next
    const bool more = it + 1 < n_st;
    if (more) {
      issue_stage(it + 1);
      // loaded now, stored after this stage's products
      if (tid < kN) load_stats(q0 + kN, ls_next, dl_next, sg_next);
    }
    // a warp none of whose keys this stage's queries reach adds zeros
    if (keys_in && (!p.causal || q0 + kN - 1 + offset >= kw0)) {
      const bf16* sQs = sQ + slot * kN * kLd;
      const bf16* sDOs = sDO + slot * kN * kLd;
      float s[kNT][4], dp[kNT][4];
      products_nt(s, kf, sQs, lane);
      products_nt(dp, vf, sDOs, lane);
      // the per-score masks: at the diagonal, at the end of Sq, or segments
      const bool test = kSeg || q0 + kN > p.Sq ||
                        (p.causal && kw0 + 15 > q0 + offset);
      if (test)
        dkv_stage<kSeg, kDrop, true>(s, dp, p, sLse + slot * kN,
                                     sDl + slot * kN, sSq + slot * kN, bh, q0,
                                     kj, kbias, kseg, offset, tq);
      else
        dkv_stage<kSeg, kDrop, false>(s, dp, p, sLse + slot * kN,
                                      sDl + slot * kN, sSq + slot * kN, bh,
                                      q0, kj, kbias, kseg, offset, tq);
      products_tn(acc_dv, s, sDOs, lane);
      products_tn(acc_dk, dp, sQs, lane);
    }
    if (more && tid < kN) {
      const int nslot = (slot ^ 1) * kN;
      sLse[nslot + tid] = ls_next;
      sDl[nslot + tid] = dl_next;
      if (kSeg) sSq[nslot + tid] = sg_next;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kj[i] >= p.Sk) continue;
    const long long row =
        ((static_cast<long long>(b) * p.Sk + kj[i]) * p.H + h) * kD;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + row + dt * 8 + tq * 2) =
          __floats2bfloat162_rn(acc_dk[dt][2 * i], acc_dk[dt][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + row + dt * 8 + tq * 2) =
          __floats2bfloat162_rn(acc_dv[dt][2 * i], acc_dv[dt][2 * i + 1]);
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, size_t smem, dim3 grid, const BwdTcParams& p,
                   cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kSeg, bool kDrop>
cudaError_t launch_one(bool dkv, const BwdTcParams& p, cudaStream_t s) {
  if (dkv)
    return launch(flash_packed_bwd_dkv_tc_kernel<kSeg, kDrop>, kDkvSmem,
                  dim3((p.Sk + kTile - 1) / kTile, p.B * p.H), p, s);
  return launch(flash_packed_bwd_dq_tc_kernel<kSeg, kDrop>, kDqSmem,
                dim3((p.Sq + kTile - 1) / kTile, p.B * p.H), p, s);
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* seg_q, const void* seg_k, const void* bias, void* out0,
        void* out1, int B, int H, int HK, int Sq, int Sk, int D,
        const long long (&strides)[12], float scale, int causal, int dtype,
        int dropout, unsigned drop_threshold, unsigned drop_seed,
        float drop_scale, void* stream) {
  bool aligned = (reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v) |
                  reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  for (long long st : strides) aligned = aligned && st % 8 == 0;
  if (B <= 0 || H <= 0 || HK != H || Sq <= 0 || Sk <= 0 || D != kD ||
      dtype != 1 || !aligned || static_cast<long long>(B) * H > 65535 ||
      (seg_q == nullptr) != (seg_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdTcParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.bias = static_cast<const float*>(bias);
  if (dkv) {
    p.dk = static_cast<bf16*>(out0);
    p.dv = static_cast<bf16*>(out1);
  } else {
    p.dq = static_cast<bf16*>(out0);
  }
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.do_sb = strides[9];
  p.do_ss = strides[10];
  p.do_sh = strides[11];
  p.scale = scale;
  p.causal = causal;
  p.drop = make_dropout(dropout, drop_threshold, drop_seed, drop_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (seg_q != nullptr)
    err = p.drop.on ? launch_one<true, true>(dkv, p, s)
                    : launch_one<true, false>(dkv, p, s);
  else
    err = p.drop.on ? launch_one<false, true>(dkv, p, s)
                    : launch_one<false, false>(dkv, p, s);
  return static_cast<int>(err);
}

}  // namespace

// K4b-dq's bf16 tensor-core body, arguments as flash_packed_stream.cu's
// paddle_flash_packed_bwd_dq: dtype must be 1 (bfloat16), D 64, HK = H, and
// q, k, v and dout rows 16-byte aligned (base pointers and the batch,
// sequence and head strides, in elements). seg_q, seg_k (both or neither)
// and bias may be null. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int paddle_flash_packed_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dq, int B, int H, int HK, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int dtype, int dropout, unsigned drop_threshold,
    unsigned drop_seed, float drop_scale, void* stream) {
  const long long strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  return run(false, q, k, v, dout, lse, delta, seg_q, seg_k, bias, dq,
             nullptr, B, H, HK, Sq, Sk, D, strides, scale, causal, dtype,
             dropout, drop_threshold, drop_seed, drop_scale, stream);
}

// K4b-dkv's bf16 tensor-core body, arguments as paddle_flash_packed_bwd_dq
// with dk and dv for dq.
extern "C" int paddle_flash_packed_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dk, void* dv, int B, int H, int HK, int Sq, int Sk,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int dtype, int dropout, unsigned drop_threshold,
    unsigned drop_seed, float drop_scale, void* stream) {
  const long long strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  return run(true, q, k, v, dout, lse, delta, seg_q, seg_k, bias, dk, dv, B,
             H, HK, Sq, Sk, D, strides, scale, causal, dtype, dropout,
             drop_threshold, drop_seed, drop_scale, stream);
}

// The width of a stage, the unit of both bodies' f32 sums (64 keys for dq,
// 64 queries for dk/dv): the plain versions' tile must equal it
// (flash_attention_packed.KERNEL_TILE), and chip_smoke.py checks that it
// does.
extern "C" int paddle_flash_packed_bwd_tc_stage() { return kN; }

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
