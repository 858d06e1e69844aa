// K2 and K3 on the tensor cores: the flash-attention backward at head dims
// 64 and 128, bf16 or float16, with grouped-query KV, and K4b-fused (BERT's
// attention backward), for Hopper (sm_90a), CUDA C++.
//
// Replaces, for 16-bit inputs at D in {64, 128}, two TPU kernels of
// paddle_tpu/ops/_pallas/flash_attention.py:
//   paddle_flash_bwd_dq_tc    _bwd_dq_kernel   (:431, launched by _bwd :628)
//   paddle_flash_bwd_dkv_tc   _bwd_dkv_kernel  (:502, launched by _bwd :736)
// and, through the same entries at D = 64 with KV heads = heads, the two of
// paddle_tpu/ops/_pallas/flash_attention_packed.py that compute the same
// functions for K4's streamed backward (ERNIE at its 2048-token context,
// cross-attention's dq):
//   _bwd_dq_kernel (:297, launched :582), _bwd_dkv_kernel (:348, :652).
// and, as paddle_flash_packed_bwd_fused_tc, the fused backward of
// flash_attention_packed.py, _bwd_fused_kernel (:448, launched by _bwd :544),
// which runs where all keys fit one tile (Sk <= 512 at BERT-base's 12
// heads): BERT-base, and ERNIE at S = 512 (see the last section below).
// bf16 is written below; float16 is the same template over the element type
// T (mma.cuh), rounding ds and p to float16 where bf16 rounds them, as JAX's
// kernels do for a float16 input.
// The float32 inputs stay on the CUDA-core bodies of flash_bwd.cu and
// flash_packed_stream.cu (on the tensor cores float32 would mean TF32, which
// is not the function the reference computes), and so does bf16 at D = 256
// (below). The wrappers pick the body by dtype and head dim and count their
// launches apart.
//
// What they compute, per query head h (KV head h / G, G = H / HK), from
// K1's lse and delta = rowsum(dO * O) - dlse, with the masks in the TPU
// kernels' order (:466-471) and rounded where they round:
//   s   = scale * q k^T (bf16 products, f32 sums), then bottom-right causal
//         (key j kept for query i when j <= i + Sk - Sq), then segments
//         (seg_q[i] == seg_k[j], else NEG_INF), then + key_bias[j]
//   p   = exp(s - lse) * (s > NEG_INF / 2),  dp = dO v^T, times keep
//   ds  = p (dp - delta) scale, rounded to bf16
//   dq  = sum over keys of ds k                        (f32, rounded once)
//   dv  = sum over the group's query heads and queries of
//         (p keep, rounded to bf16)^T dO
//   dk  = sum over the group's query heads and queries of ds^T q
// keep is the attention-prob dropout factor of dropout.cuh (the hash of the
// flat query head b*H + h and the position, K3's head numbered as JAX's
// query_bh :529-540 numbers it), 1 without dropout. A query row with no
// valid key (lse = NEG_INF + log 1e-30) gives dq = 0 and adds nothing to dk
// or dv.
//
// Layout: q, dO [B, Sq, H, D] and k, v [B, Sk, HK, D] bf16, read through
// their batch, sequence and head strides (the last dimension dense, every
// row 16-byte aligned: the views of a fused QKV projection go in without a
// copy). lse and delta are dense [B, H, Sq] f32; seg_q [B, Sq], seg_k
// [B, Sk] int32 and bias [B, Sk] f32 dense or null. dq [B, Sq, H, D] and
// dk, dv [B, Sk, HK, D] are written dense. Any Sq and Sk: the ragged edges
// are masked here.
//
// Design. Two bodies first written for K4's streamed dq and dk/dv at
// D = 64, taught the head dim 128 and grouped-query KV. As on the TPU,
// each block owns its output tile and sums over the other axis in a fixed
// order, in f32 registers: no atomics, and results repeat bit for bit. dq
// and dk/dv stay two kernels, each recomputing s and p, as the TPU kernels
// do. Blocks of 4 warps own 64 rows, 16 a warp (one m-tile of
// mma.sync.m16n8k16, bf16 in, f32 accumulate); the other axis streams in
// stages through a cp.async double-buffered ring in shared memory (rows
// padded to D + 8 values, so that ldmatrix's eight row reads hit distinct
// banks): stage t + 1 loads while stage t computes.
// - dq: one block per (64-query tile, b*h). Q and dO fragments stay in
//   registers, with lse and delta of the thread's two rows; K and V come
//   from the query head's KV head. Per key stage, S = Q K^T and dP = dO V^T
//   (K and V as B operands by ldmatrix), the masks and ds in registers, ds
//   packed to bf16 straight into the A operand of dQ += dS K, with K as the
//   B operand by ldmatrix.trans. Causal query tiles are issued longest
//   first.
// - dk/dv: one block per (64-key tile, b*hk), keys as rows, with each key
//   row's bias and segment id. The block walks the G query heads of its
//   group in order and, for each, the query stages from the first one that
//   reaches the key tile under causal masking; the ring runs across the
//   heads, so the next head's first stage loads while the last one
//   computes. Each stage's lse (+inf for a row with no valid key or past
//   Sq), delta and seg_q are loaded into registers while the stage before
//   computes, and stored to shared memory after it. S^T = K Q^T and dP^T =
//   V dO^T, then dV += (P^T keep) dO and dK += dS^T Q with dO and Q as B
//   operands by ldmatrix.trans. The sum over the group is head-major, then
//   query stage, as JAX's t = head * nq + qi and flash_bwd.cu take it.
// No score goes through shared memory. The grid's fast axis is the tile, so
// the blocks in flight share a few heads' K and V (or Q and dO) in L2.
// Shared memory: 55-56 KB a block at D = 64 (3 dq or 2 dk/dv blocks an SM),
// 105 KB at D = 128 (2 blocks an SM).
//
// Registers set the shape (Shape<D> below). One m-tile of 16 rows takes
// D / 2 f32 registers for each D-wide accumulator, D / 4 for each resident
// bf16 operand of the head dim, and N / 2 each for S and dP over an N-wide
// stage. At D = 64: 64-wide stages, the two resident operands in registers
// (dq about 128 before addresses, dk/dv about 160). At D = 128, dk/dv with
// K and V held in registers would need 2 * 64 + 2 * 32 + 64 = 256 at
// 64-wide stages, past the 255 a thread may have, and spills even at
// 32-wide ones; so it reads K and V from shared memory by ldmatrix at each
// k-step (a quarter more shared-memory reads for each product than with
// them held). dq keeps Q and dO in registers. Both take 64-wide stages at
// D = 128: against 32-wide ones they halve the syncs and copy issues per
// column for more registers, and ran faster at GPT-3 1.3B's training shape,
// at 254-255 registers with a few bytes spilled in the segment
// instantiations only. PERF.md says why this shape was kept.
//
// The work beside the products is kept off the interior stages (what set
// K4a-direct's first tensor-core body's speed, see flash_packed_tc.cu): a
// stage where every (row, column) pair of the warp is inside Sq and Sk and
// below the causal diagonal, without segments, takes a score in an FMA, a
// subtraction, a multiply and an exp2; only the stages at the diagonal, at
// the ragged end of the streamed axis or with segments test each score.
// Segments and dropout are separate instantiations. x - lse is taken before
// the multiply by log2 e: where the key bias is -1e9 an f32 step is 64, and
// only the difference is exact (for a row whose keys all carry the padding
// bias, x and lse are both near -1e9, and x log2 e - lse log2 e with the two
// products rounded apart would put p off by up to 2^64). The keyless row:
// its lse is NEG_INF + log 1e-30, so exp(s - lse) of a masked score would be
// exp(+69); the per-score (s > NEG_INF / 2) test of the tested stages zeroes
// it, and such a row's lse is replaced by +inf once at load, so that every p
// it meets is exp(-inf) = 0. Under dropout dp keep is rounded before delta
// is subtracted (__fmul_rn, which nvcc does not fuse into an FMA), as _bwd
// and the plain version round it.
//
// What bounds them on an H100. At GPT-3 1.3B's training shape (B = 4,
// S = 2048, H = 16, D = 128, causal: pairs = S(S+1)/2 per head) dq does
// 6 * 128 * pairs * 64 = 1.03e11 FLOPs against 169 MB, dk/dv 8 * 128 *
// pairs * 64 = 1.38e11 against 202 MB: the operations bound them at the 989
// TFLOP/s bf16 peak (0.104 and 0.139 ms). mma.sync reaches part of the peak
// that wgmma with TMA reaches; with 16 rows a warp every B fragment that
// ldmatrix brings feeds one m-tile, so shared-memory reads, and beside the
// products each score's exp2 and about ten FP32 operations (and the
// murmur3 hash under dropout), bound these bodies first. Registers, shared
// memory and spills: ptxas -v on sm_90a, which chip_smoke.py's build phase
// prints; PERF.md records them.
//
// bf16 and float16 at D = 256 stay on flash_bwd.cu's CUDA-core bodies: at
// 16 rows a warp its dq accumulator alone is 128 registers, and dk/dv has
// two; it needs the head dim split across warps or wgmma's accumulators
// spread over a warpgroup.
//
// K4b-fused (flash_packed_bwd_fused_tc_kernel). _bwd_fused_kernel recomputes
// s and p once for all three gradients: dq is whole inside one program,
// because all keys are one tile, and dk, dv add up over the query tiles.
// Here a head's keys are cut into nk = ceil(Sk / 64) tiles, one block each,
// and the nk blocks of a head form one thread-block cluster (nk <= 8, the
// portable cluster size, for every Sk that plan() sends here). Each block is
// K3's dk/dv body at D = 64 (K and V resident, their fragments in
// registers, 16 key rows a warp, Q and dO through the cp.async ring in
// 64-query stages, dk and dv in registers over all stages) and, per stage,
// also writes its dS (rounded to T) to shared memory with keys as rows, and
// from there takes its partial dq = dS^T K for the stage's 64 queries (A by
// ldmatrix.trans of dS, B by ldmatrix.trans of K) into an f32 buffer. After a cluster barrier, block r sums rows
// [r 64 / nk, (r + 1) 64 / nk) of the stage's dq over the nk partials, in
// key-tile order 0 .. nk - 1, reading its peers' buffers through distributed
// shared memory, and writes them in T: a fixed order, no atomics, results
// that repeat bit for bit. The barrier is split: a block arrives once its
// partial of stage t is written and waits for the cluster's arrivals only
// in stage t + 1, after that stage's main products, then sums stage t's dq
// (before its own dq product, so that the sum's loads and the dq
// accumulators are not live together). The partials are double-buffered,
// so one barrier a stage suffices (a block writes a buffer again two
// stages later, after every peer has arrived past its reads). Every block
// walks every query stage, so the cluster's barriers pair up under causal
// masking too; a warp that takes no product writes dS = 0. Writing per-tile
// partials to global memory instead would cost 805 MB at BERT's shape (B =
// 64, S = 512, 12 heads), more than the whole product's time.
// At that shape the function takes 5 products of 64 x 512 x 512 per head:
// 1.29e11 FLOPs (0.130 ms at the 989 TFLOP/s peak) against 201 MB of q, k,
// v, dO, dq, dk, dv (0.060 ms at 3.35 TB/s): operations bound it. Shared
// memory: 98.5 KB a block; registers (250-255 a thread) allow 2 blocks, 8
// warps, an SM. There the barrier a stage and dS's trip through shared
// memory cost more than the second recompute of the two-body route (the
// streamed dq and dk/dv above), which chip_smoke.py times beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "dropout.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;      // a block's own rows
constexpr float kNegInf = -1e30f;       // NEG_INF of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;

// a body's shape by head dim: the stage (keys for dq, queries for dk/dv),
// whether dk/dv keeps K and V in registers, and the blocks an SM keeps (the
// register budget: 65536 / (128 * blocks))
template <int D>
struct Shape;
template <>
struct Shape<64> {
  static constexpr int kDqN = 64;
  static constexpr int kDkvN = 64;
  static constexpr bool kDkvKvRegs = true;
  static constexpr int kDqBlocks = 3;
  static constexpr int kDkvBlocks = 2;
};
template <>
struct Shape<128> {
  static constexpr int kDqN = 64;
  static constexpr int kDkvN = 64;
  static constexpr bool kDkvKvRegs = false;
  static constexpr int kDqBlocks = 2;
  static constexpr int kDkvBlocks = 2;
};

template <typename T>
struct BwdTcParams {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  const int* seg_q;    // null: no segments
  const int* seg_k;
  const float* bias;   // null: no key bias
  T* dq;
  T* dk;
  T* dv;
  int B, H, HK, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  float scale;
  int causal;
  DropoutArgs drop;    // attention-prob dropout (dropout.cuh)
};

template <int D>
__host__ __device__ constexpr int ld() {   // padded smem row, in values
  return D + 8;
}

// the block's two resident operands [64][D + 8] and the ring's two
// [2][N][D + 8], bf16; then the per-column inputs of the two stages (dq: the
// keys' bias and segments; dk/dv: the queries' lse, delta and segments)
template <int D, int N>
constexpr size_t operand_bytes() {
  return sizeof(__half) * static_cast<size_t>(2 * kTile + 4 * N) * ld<D>();
}
template <int D>
constexpr size_t dq_smem() {
  constexpr int N = Shape<D>::kDqN;
  return operand_bytes<D, N>() + (sizeof(float) + sizeof(int)) * 2 * N;
}
template <int D>
constexpr size_t dkv_smem() {
  constexpr int N = Shape<D>::kDkvN;
  return operand_bytes<D, N>() + (2 * sizeof(float) + sizeof(int)) * 2 * N;
}

// rows [row0, row0 + ROWS) of a [*, D] bf16 operand into padded smem rows,
// by cp.async; rows at or past n_rows are zero
template <int D, int ROWS, typename T>
__device__ __forceinline__ void issue_rows(T* dst, const T* base,
                                           long long row_stride, int row0,
                                           int n_rows, int tid) {
  constexpr int kSegs = D / 8;   // 16-byte pieces of a row
  for (int i = tid; i < ROWS * kSegs; i += kThreads) {
    const int r = i / kSegs;
    const int seg = i - r * kSegs;
    const int row = row0 + r;
    const bool in = row < n_rows;
    const T* src =
        in ? base + static_cast<long long>(row) * row_stride + seg * 8 : base;
    cp_async16(dst + r * ld<D>() + seg * 8, src, in);
  }
}

// the A fragments of a warp's 16 rows over the head dim, held in registers
template <int D>
struct RegRows {
  unsigned f[D / 16][4];
  template <typename T>
  __device__ __forceinline__ void load(const T* sRows, int lane) {
    const T* p = sRows + (lane & 15) * ld<D>() + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(f[kk], p + kk * 16);
  }
  __device__ __forceinline__ void get(int kk, unsigned (&r)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = f[kk][e];
  }
};

// the same fragments read from shared memory at each k-step
template <int D>
struct SmemRows {
  const unsigned short* p;   // 16-bit values, whatever their type
  template <typename T>
  __device__ __forceinline__ void load(const T* sRows, int lane) {
    p = reinterpret_cast<const unsigned short*>(sRows) +
        (lane & 15) * ld<D>() + (lane >> 4) * 8;
  }
  __device__ __forceinline__ void get(int kk, unsigned (&r)[4]) const {
    ldmatrix_x4(r, p + kk * 16);
  }
};

// acc = A B^T: A the warp's 16 rows (RegRows or SmemRows), B a stage of N
// rows of the head dim in smem (sB: [N][D + 8]); acc[nt] holds columns 8 nt
// .. 8 nt + 7 of the stage in mma.sync's accumulator layout. Each B fragment
// is read by ldmatrix (a lane's row: (lane >> 4) * 8 + (lane & 7) of a
// 16-row pair of n-tiles, d half ((lane >> 3) & 1) of a 16-wide k-step).
template <int D, int N, typename A, typename T>
__device__ __forceinline__ void products_nt(float (&acc)[N / 8][4],
                                            const A& a, const T* sB,
                                            int lane) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const T* bb =
      sB + ((lane >> 4) * 8 + (lane & 7)) * ld<D>() + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned af[4];
    a.get(kk, af);
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      unsigned b[4];
      ldmatrix_x4(b, bb + jp * 16 * ld<D>() + kk * 16);
      mma_16816<T>(acc[2 * jp], af, b[0], b[1]);
      mma_16816<T>(acc[2 * jp + 1], af, b[2], b[3]);
    }
  }
}

// acc += X B: X the warp's 16 rows over the stage's N columns (f32, in the
// accumulator layout of products_nt), rounded to bf16 in pairs into A
// fragments of 16-column steps; B the stage's N rows of the head dim in smem
// by ldmatrix.trans (a lane's row: ((lane >> 3) & 1) * 8 + (lane & 7) of a
// 16-row step, d half (lane >> 4) of a 16-wide pair of n-tiles).
template <int D, int N, typename T>
__device__ __forceinline__ void products_tn(float (&acc)[D / 8][4],
                                            const float (&x)[N / 8][4],
                                            const T* sB, int lane) {
  const T* br =
      sB + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld<D>() + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    unsigned a[4];
    a[0] = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, br + kk * 16 * ld<D>() + dp * 16);
      mma_16816<T>(acc[2 * dp], a, b[0], b[1]);
      mma_16816<T>(acc[2 * dp + 1], a, b[2], b[3]);
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
// else x as it is. x - lse is taken first (see the note above).
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
template <int N, bool kSeg, bool kDrop, bool kTest, typename T>
__device__ __forceinline__ void dq_stage(float (&s)[N / 8][4],
                                         const float (&dp)[N / 8][4],
                                         const BwdTcParams<T>& p,
                                         const float* sB,
                                         const int* sS, int bh, int k0,
                                         const int (&qi)[2],
                                         const int (&segq)[2],
                                         const float (&lse)[2],
                                         const float (&dlt)[2], int offset,
                                         int tq) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
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
      // dp keep rounded apart from the subtraction (see dkv_stage)
      if (kDrop && pe != 0.f)
        dpv = __fmul_rn(dpv, dropout_keep(p.drop, bh, p.Sq, p.Sk, qi[i], kj));
      s[nt][e] = pe * (dpv - dlt[i]) * p.scale;
    }
  }
}

template <typename T, int D, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, Shape<D>::kDqBlocks)
    flash_bwd_dq_tc_kernel(const BwdTcParams<T> p) {
  constexpr int N = Shape<D>::kDqN;
  constexpr int kLd = ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [64][kLd]
  T* sDO = sQ + kTile * kLd;                   // [64][kLd]
  T* sK = sDO + kTile * kLd;                   // [2][N][kLd]
  T* sV = sK + 2 * N * kLd;                    // [2][N][kLd]
  float* sBias = reinterpret_cast<float*>(sV + 2 * N * kLd);   // [2][N]
  int* sSegK = reinterpret_cast<int*>(sBias + 2 * N);          // [2][N]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator rows g and g + 8 of the m-tile
  const int tq = lane & 3;   // accumulator columns 2 tq, 2 tq + 1
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.HK);
  // causal: the longest query tiles first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTile;
  const int offset = p.Sk - p.Sq;   // bottom-right causal alignment
  const int qw0 = q0 + warp * 16;   // the warp's first row

  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const T* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* bias_row =
      p.bias != nullptr ? p.bias + static_cast<long long>(b) * p.Sk : nullptr;
  const int* segk_row =
      kSeg ? p.seg_k + static_cast<long long>(b) * p.Sk : nullptr;

  // stages the block needs: all, or on the causal path up to the diagonal
  // of its last row (none when Sq > Sk leaves every row empty)
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kTile + offset);
  const int n_st = kv_end > 0 ? (kv_end + N - 1) / N : 0;

  // stage st's K, V, key bias and segments into slot st & 1, one group
  auto issue_stage = [&](int st) {
    const int k0 = st * N;
    const int slot = st & 1;
    issue_rows<D, N>(sK + slot * N * kLd, kb, p.k_ss, k0, p.Sk, tid);
    issue_rows<D, N>(sV + slot * N * kLd, vb, p.v_ss, k0, p.Sk, tid);
    for (int i = tid; i < N; i += kThreads) {
      const int kj = k0 + i;
      const bool in = kj < p.Sk;
      cp_async4(sBias + slot * N + i,
                in && bias_row != nullptr ? bias_row + kj
                                          : static_cast<const void*>(kb),
                in && bias_row != nullptr);
      if (kSeg)
        cp_async4(sSegK + slot * N + i,
                  in ? segk_row + kj : static_cast<const void*>(kb), in);
    }
    cp_async_commit();
  };

  issue_rows<D, kTile>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  issue_rows<D, kTile>(sDO, dob, p.do_ss, q0, p.Sq, tid);
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
  RegRows<D> qf, dof;
  qf.load(sQ + warp * 16 * kLd, lane);
  dof.load(sDO + warp * 16 * kLd, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const bool rows_in = qw0 < p.Sq;
  // the keys the warp's rows need end here (past it: causally masked or
  // beyond Sk)
  const int kw_end = p.causal ? min(p.Sk, qw0 + 16 + offset) : p.Sk;

  for (int st = 0; st < n_st; ++st) {
    const int k0 = st * N;
    const int slot = st & 1;
    cp_async_wait<0>();   // this stage has landed
    __syncthreads();      // ... for every thread; every warp is done with
                          // the last stage, whose slot the next one takes
    if (st + 1 < n_st) issue_stage(st + 1);
    // a warp whose rows need no key of this stage would add zeros
    if (!rows_in || k0 >= kw_end) continue;
    const T* sKs = sK + slot * N * kLd;
    float s[N / 8][4], dp[N / 8][4];
    products_nt<D, N>(s, qf, sKs, lane);
    products_nt<D, N>(dp, dof, sV + slot * N * kLd, lane);
    // the per-score masks: at the diagonal, at the end of Sk, or segments
    const bool test = kSeg || k0 + N > p.Sk ||
                      (p.causal && k0 + N - 1 > qw0 + offset);
    if (test)
      dq_stage<N, kSeg, kDrop, true>(s, dp, p, sBias + slot * N,
                                     sSegK + slot * N, bh, k0, qi, segq, lse,
                                     dlt, offset, tq);
    else
      dq_stage<N, kSeg, kDrop, false>(s, dp, p, sBias + slot * N,
                                      sSegK + slot * N, bh, k0, qi, segq,
                                      lse, dlt, offset, tq);
    products_tn<D, N>(acc, s, sKs, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qi[i] >= p.Sq) continue;
    T* row =
        p.dq + ((static_cast<long long>(b) * p.Sq + qi[i]) * p.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<unsigned*>(row + dt * 8 + tq * 2) =
          pack2<T>(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// dk/dv. Grid (key tiles, B*HK), 128 threads.
// ---------------------------------------------------------------------------

// s (the stage's S^T) becomes p keep and dp (dP^T) becomes ds, both rounded
// later as products_tn packs them. sLse, sDl, sSq hold the stage's queries'
// lse (row_lse), delta and segment ids.
template <int N, bool kSeg, bool kDrop, bool kTest, typename T>
__device__ __forceinline__ void dkv_stage(float (&s)[N / 8][4],
                                          float (&dp)[N / 8][4],
                                          const BwdTcParams<T>& p,
                                          const float* sLse, const float* sDl,
                                          const int* sSq, int bh, int q0,
                                          const int (&kj)[2],
                                          const float (&kbias)[2],
                                          const int (&kseg)[2], int offset,
                                          int tq) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
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
        // __fmul_rn: dp keep - delta fused into one FMA would round once
        // where _bwd and the plain version round twice, and flip ds's bf16
        // rounding where p = 1 makes ds large (rows of padding keys)
        dp[nt][e] = pe * (__fmul_rn(dp[nt][e], keep) - de) * p.scale;
        s[nt][e] = pe * keep;
      } else {
        dp[nt][e] = pe * (dp[nt][e] - de) * p.scale;
        s[nt][e] = pe;
      }
    }
  }
}

template <typename T, int D, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, Shape<D>::kDkvBlocks)
    flash_bwd_dkv_tc_kernel(const BwdTcParams<T> p) {
  constexpr int N = Shape<D>::kDkvN;
  constexpr int kLd = ld<D>();
  // K and V fragments held in registers, or read from smem at each k-step
  using KvRows = typename std::conditional<Shape<D>::kDkvKvRegs, RegRows<D>,
                                           SmemRows<D>>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);   // [64][kLd]
  T* sV = sK + kTile * kLd;                    // [64][kLd]
  T* sQ = sV + kTile * kLd;                    // [2][N][kLd]
  T* sDO = sQ + 2 * N * kLd;                   // [2][N][kLd]
  float* sLse = reinterpret_cast<float*>(sDO + 2 * N * kLd);  // [2][N]
  float* sDl = sLse + 2 * N;                                  // [2][N]
  int* sSq = reinterpret_cast<int*>(sDl + 2 * N);             // [2][N]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bhk = blockIdx.y;
  const int b = bhk / p.HK;
  const int hk = bhk - b * p.HK;
  const int G = p.H / p.HK;             // query heads of the group
  const int k0 = blockIdx.x * kTile;    // causal: tile 0 is the longest
  const int offset = p.Sk - p.Sq;
  const int kw0 = k0 + warp * 16;       // the warp's first key

  const T* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = p.v + b * p.v_sb + hk * p.v_sh;

  // the first query stage with a row that reaches this key tile:
  // (qt + 1) * N - 1 + offset >= k0, as _bwd_dkv_kernel tests it
  const int nq = (p.Sq + N - 1) / N;
  const int x = k0 - offset;
  const int qt_first = p.causal && x > 0 ? x / N : 0;
  const int n_st = max(0, nq - qt_first);   // stages of one query head
  const int n_all = G * n_st;               // head-major, then stage

  // stage t's query head (within the group) and first query
  auto head_of = [&](int t) { return t / n_st; };
  auto q0_of = [&](int t) { return (qt_first + t - head_of(t) * n_st) * N; };
  // stage t's Q and dO into slot t & 1, one group
  auto issue_stage = [&](int t) {
    const int h = hk * G + head_of(t);
    const int slot = t & 1;
    issue_rows<D, N>(sQ + slot * N * kLd, p.q + b * p.q_sb + h * p.q_sh,
                     p.q_ss, q0_of(t), p.Sq, tid);
    issue_rows<D, N>(sDO + slot * N * kLd,
                     p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0_of(t),
                     p.Sq, tid);
    cp_async_commit();
  };
  // stage t's query q0 + tid: its lse (row_lse), delta and segment id
  // (threads < N)
  auto load_stats = [&](int t, float& ls, float& dl, int& sg) {
    const int h = hk * G + head_of(t);
    const long long stat0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    const int qi = q0_of(t) + tid;
    const bool in = qi < p.Sq;
    ls = row_lse(in ? p.lse[stat0 + qi] : 0.f, in);
    dl = in ? p.delta[stat0 + qi] : 0.f;
    sg = kSeg && in ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
  };

  issue_rows<D, kTile>(sK, kb, p.k_ss, k0, p.Sk, tid);
  issue_rows<D, kTile>(sV, vb, p.v_ss, k0, p.Sk, tid);
  cp_async_commit();
  float ls_next = 0.f, dl_next = 0.f;
  int sg_next = 0;
  if (n_all > 0) {
    issue_stage(0);
    if (tid < N) {
      load_stats(0, ls_next, dl_next, sg_next);
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
  KvRows kf, vf;
  kf.load(sK + warp * 16 * kLd, lane);
  vf.load(sV + warp * 16 * kLd, lane);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_dk[dt][e] = 0.f;
      acc_dv[dt][e] = 0.f;
    }

  const bool keys_in = kw0 < p.Sk;
  for (int t = 0; t < n_all; ++t) {
    const int q0 = q0_of(t);
    const int bh = b * p.H + hk * G + head_of(t);   // JAX's query_bh
    const int slot = t & 1;
    cp_async_wait<0>();   // this stage's Q and dO have landed
    __syncthreads();      // ... and its stats are stored; every warp is
                          // done with the last stage, whose slot is next
    const bool more = t + 1 < n_all;
    if (more) {
      issue_stage(t + 1);
      // loaded now, stored after this stage's products
      if (tid < N) load_stats(t + 1, ls_next, dl_next, sg_next);
    }
    // a warp none of whose keys this stage's queries reach adds zeros
    if (keys_in && (!p.causal || q0 + N - 1 + offset >= kw0)) {
      const T* sQs = sQ + slot * N * kLd;
      const T* sDOs = sDO + slot * N * kLd;
      float s[N / 8][4], dp[N / 8][4];
      products_nt<D, N>(s, kf, sQs, lane);
      products_nt<D, N>(dp, vf, sDOs, lane);
      // the per-score masks: at the diagonal, at the end of Sq, or segments
      const bool test = kSeg || q0 + N > p.Sq ||
                        (p.causal && kw0 + 15 > q0 + offset);
      if (test)
        dkv_stage<N, kSeg, kDrop, true>(s, dp, p, sLse + slot * N,
                                        sDl + slot * N, sSq + slot * N, bh,
                                        q0, kj, kbias, kseg, offset, tq);
      else
        dkv_stage<N, kSeg, kDrop, false>(s, dp, p, sLse + slot * N,
                                         sDl + slot * N, sSq + slot * N, bh,
                                         q0, kj, kbias, kseg, offset, tq);
      products_tn<D, N>(acc_dv, s, sDOs, lane);
      products_tn<D, N>(acc_dk, dp, sQs, lane);
    }
    if (more && tid < N) {
      const int nslot = (slot ^ 1) * N;
      sLse[nslot + tid] = ls_next;
      sDl[nslot + tid] = dl_next;
      if (kSeg) sSq[nslot + tid] = sg_next;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kj[i] >= p.Sk) continue;
    const long long row =
        ((static_cast<long long>(b) * p.Sk + kj[i]) * p.HK + hk) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<unsigned*>(p.dk + row + dt * 8 + tq * 2) =
          pack2<T>(acc_dk[dt][2 * i], acc_dk[dt][2 * i + 1]);
      *reinterpret_cast<unsigned*>(p.dv + row + dt * 8 + tq * 2) =
          pack2<T>(acc_dv[dt][2 * i], acc_dv[dt][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4b-fused. Grid (nk, B*H) in clusters of nk = ceil(Sk / 64) blocks, one a
// 64-key tile, 128 threads. D = 64, KV heads = heads.
// ---------------------------------------------------------------------------

constexpr int kMaxClusterTiles = 8;   // Sk <= 512: the portable cluster size
constexpr int kLdDq = 64 + 4;         // f32 row of a dq partial in smem

// The cluster barrier in its two halves: arrive (this thread's shared-memory
// writes released to the cluster) and wait (every thread of every block has
// arrived; their writes acquired). A thread alternates the two.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// K, V [64][72] and the ring's Q, dO [2][64][72] (T), the stage's queries'
// lse, delta and segments [2][64], dS [64 keys][72] (T), and the two dq
// partials [2][64][68] f32
constexpr size_t fused_smem() {
  return operand_bytes<64, 64>() + (2 * sizeof(float) + sizeof(int)) * 2 * 64 +
         sizeof(__half) * kTile * ld<64>() +
         sizeof(float) * 2 * 64 * kLdDq;
}

template <typename T, bool kSeg, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    flash_packed_bwd_fused_tc_kernel(const BwdTcParams<T> p) {
  constexpr int D = 64;
  constexpr int N = 64;   // queries a stage
  constexpr int kLd = ld<D>();
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);         // [64][kLd]
  T* sV = sK + kTile * kLd;                       // [64][kLd]
  T* sQ = sV + kTile * kLd;                       // [2][N][kLd]
  T* sDO = sQ + 2 * N * kLd;                      // [2][N][kLd]
  float* sLse = reinterpret_cast<float*>(sDO + 2 * N * kLd);  // [2][N]
  float* sDl = sLse + 2 * N;                                  // [2][N]
  int* sSq = reinterpret_cast<int*>(sDl + 2 * N);             // [2][N]
  T* sDS = reinterpret_cast<T*>(sSq + 2 * N);     // [64 keys][kLd]
  float* sDQ = reinterpret_cast<float*>(sDS + kTile * kLd);   // [2][N][kLdDq]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int nk = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = rank * kTile;
  const int offset = p.Sk - p.Sq;
  const int kw0 = k0 + warp * 16;      // the warp's first key
  const int nq = (p.Sq + N - 1) / N;   // every block walks every stage

  const T* kb = p.k + b * p.k_sb + h * p.k_sh;
  const T* vb = p.v + b * p.v_sb + h * p.v_sh;
  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat0 = static_cast<long long>(bh) * p.Sq;

  auto issue_stage = [&](int t) {
    const int slot = t & 1;
    issue_rows<D, N>(sQ + slot * N * kLd, qb, p.q_ss, t * N, p.Sq, tid);
    issue_rows<D, N>(sDO + slot * N * kLd, dob, p.do_ss, t * N, p.Sq, tid);
    cp_async_commit();
  };
  auto load_stats = [&](int t, float& ls, float& dl, int& sg) {
    const int qi = t * N + tid;
    const bool in = qi < p.Sq;
    ls = row_lse(in ? p.lse[stat0 + qi] : 0.f, in);
    dl = in ? p.delta[stat0 + qi] : 0.f;
    sg = kSeg && in ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
  };

  issue_rows<D, kTile>(sK, kb, p.k_ss, k0, p.Sk, tid);
  issue_rows<D, kTile>(sV, vb, p.v_ss, k0, p.Sk, tid);
  cp_async_commit();
  float ls_next = 0.f, dl_next = 0.f;
  int sg_next = 0;
  issue_stage(0);
  if (tid < N) {
    load_stats(0, ls_next, dl_next, sg_next);
    sLse[tid] = ls_next;
    sDl[tid] = dl_next;
    if (kSeg) sSq[tid] = sg_next;
  }

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
  // K and V held in registers (12-20 bytes spilled in some forms: read
  // from smem at each k-step instead, nothing spills, but the stage is
  // slower)
  RegRows<D> kf, vf;
  kf.load(sK + warp * 16 * kLd, lane);
  vf.load(sV + warp * 16 * kLd, lane);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_dk[dt][e] = 0.f;
      acc_dv[dt][e] = 0.f;
    }

  const bool keys_in = kw0 < p.Sk;
  // the dq rows of a stage this block sums across the cluster
  const int r0 = rank * N / nk;
  const int r1 = (rank + 1) * N / nk;
  // rows r0 .. r1 of stage t's dq: the nk partials added in key-tile
  // order, read from the peers' shared memory four at a time (their loads
  // in flight together)
  auto reduce_rows = [&](int t) {
    const float* mine = sDQ + (t & 1) * N * kLdDq;
    for (int i = tid; i < (r1 - r0) * (D / 4); i += kThreads) {
      const int r = r0 + i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j0 = 0; j0 < nk; j0 += 4) {
        float4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j0 + j < nk)
            v[j] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(mine, static_cast<unsigned>(j0 + j)) +
                r * kLdDq + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j0 + j < nk) {
            sum.x += v[j].x;
            sum.y += v[j].y;
            sum.z += v[j].z;
            sum.w += v[j].w;
          }
      }
      const int qi = t * N + r;
      if (qi < p.Sq) {
        T* out =
            p.dq + ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * D + c;
        *reinterpret_cast<uint2*>(out) =
            make_uint2(pack2<T>(sum.x, sum.y), pack2<T>(sum.z, sum.w));
      }
    }
  };
  for (int t = 0; t < nq; ++t) {
    const int q0 = t * N;
    const int slot = t & 1;
    cp_async_wait<0>();   // this stage's Q and dO have landed
    __syncthreads();      // ... and its stats are stored; every warp is done
                          // with the last stage's Q, dO and dS
    const bool more = t + 1 < nq;
    if (more) {
      issue_stage(t + 1);
      if (tid < N) load_stats(t + 1, ls_next, dl_next, sg_next);
    }
    const T* sQs = sQ + slot * N * kLd;
    const T* sDOs = sDO + slot * N * kLd;
    float s[N / 8][4], dp[N / 8][4];
    const bool active =
        keys_in && (!p.causal || q0 + N - 1 + offset >= kw0);
    if (active) {
      // S^T = K Q^T and dP^T = V dO^T once for all three gradients
      products_nt<D, N>(s, kf, sQs, lane);
      products_nt<D, N>(dp, vf, sDOs, lane);
      const bool test = kSeg || q0 + N > p.Sq || k0 + kTile > p.Sk ||
                        (p.causal && kw0 + 15 > q0 + offset);
      if (test)
        dkv_stage<N, kSeg, kDrop, true>(s, dp, p, sLse + slot * N,
                                        sDl + slot * N, sSq + slot * N, bh,
                                        q0, kj, kbias, kseg, offset, tq);
      else
        dkv_stage<N, kSeg, kDrop, false>(s, dp, p, sLse + slot * N,
                                         sDl + slot * N, sSq + slot * N, bh,
                                         q0, kj, kbias, kseg, offset, tq);
      products_tn<D, N>(acc_dv, s, sDOs, lane);
      products_tn<D, N>(acc_dk, dp, sQs, lane);
    }
    // dS (rounded to T, as the dk product rounds it) to shared memory, keys
    // as rows: 0 for a key past Sk (its p is not masked: its row of K is 0,
    // but its ds may not be finite) and for a warp that took no product
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool kin = active && kj[i] < p.Sk;
      T* row = sDS + (warp * 16 + g + 8 * i) * kLd + tq * 2;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        *reinterpret_cast<unsigned*>(row + nt * 8) =
            kin ? pack2<T>(dp[nt][2 * i], dp[nt][2 * i + 1]) : 0u;
    }
    if (more && tid < N) {
      const int nslot = (slot ^ 1) * N;
      sLse[nslot + tid] = ls_next;
      sDl[nslot + tid] = dl_next;
      if (kSeg) sSq[nslot + tid] = sg_next;
    }
    __syncthreads();   // dS is whole
    if (t > 0) {
      // every block has written the last stage's partial (and read this
      // stage's buffer for the stage before it): sum the last stage's dq,
      // its barrier's latency hidden behind this stage's products
      cluster_wait();
      reduce_rows(t - 1);
    }
    // this key tile's dq partial for the warp's 16 queries: dS^T K, with
    // dS^T's fragments by ldmatrix.trans from the key rows and K's as B
    float acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
    {
      const T* ar = sDS + ((lane >> 4) * 8 + (lane & 7)) * kLd + warp * 16 +
                    ((lane >> 3) & 1) * 8;
      const T* br =
          sK + (((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        unsigned a[4];
        ldmatrix_x4_trans(a, ar + kk * 16 * kLd);
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          unsigned bf[4];
          ldmatrix_x4_trans(bf, br + kk * 16 * kLd + dp2 * 16);
          mma_16816<T>(acc[2 * dp2], a, bf[0], bf[1]);
          mma_16816<T>(acc[2 * dp2 + 1], a, bf[2], bf[3]);
        }
      }
    }
    float* part = sDQ + slot * N * kLdDq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = part + (warp * 16 + g + 8 * i) * kLdDq + tq * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(row + dt * 8) =
            make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
    }
    cluster_arrive();   // this stage's partial is whole
  }
  cluster_wait();
  reduce_rows(nq - 1);
  // no block leaves while a peer may read its partials
  cluster_arrive();
  cluster_wait();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kj[i] >= p.Sk) continue;
    const long long row =
        ((static_cast<long long>(b) * p.Sk + kj[i]) * p.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<unsigned*>(p.dk + row + dt * 8 + tq * 2) =
          pack2<T>(acc_dk[dt][2 * i], acc_dk[dt][2 * i + 1]);
      *reinterpret_cast<unsigned*>(p.dv + row + dt * 8 + tq * 2) =
          pack2<T>(acc_dv[dt][2 * i], acc_dv[dt][2 * i + 1]);
    }
  }
}

template <bool kSeg, bool kDrop, typename T>
cudaError_t launch_fused(const BwdTcParams<T>& p, cudaStream_t stream) {
  auto kernel = flash_packed_bwd_fused_tc_kernel<T, kSeg, kDrop>;
  const size_t smem = fused_smem();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nk = (p.Sk + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nk, p.B * p.H);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename K, typename T>
cudaError_t launch(K kernel, size_t smem, dim3 grid, const BwdTcParams<T>& p,
                   cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kSeg, bool kDrop, typename T>
cudaError_t launch_one(bool dkv, const BwdTcParams<T>& p, cudaStream_t s) {
  if (dkv)
    return launch(flash_bwd_dkv_tc_kernel<T, D, kSeg, kDrop>, dkv_smem<D>(),
                  dim3((p.Sk + kTile - 1) / kTile, p.B * p.HK), p, s);
  return launch(flash_bwd_dq_tc_kernel<T, D, kSeg, kDrop>, dq_smem<D>(),
                dim3((p.Sq + kTile - 1) / kTile, p.B * p.H), p, s);
}

template <int D, typename T>
cudaError_t launch_d(bool dkv, const BwdTcParams<T>& p, cudaStream_t s) {
  if (p.seg_q != nullptr)
    return p.drop.on ? launch_one<D, true, true>(dkv, p, s)
                     : launch_one<D, true, false>(dkv, p, s);
  return p.drop.on ? launch_one<D, false, true>(dkv, p, s)
                   : launch_one<D, false, false>(dkv, p, s);
}

template <typename T>
cudaError_t launch_fused_flags(const BwdTcParams<T>& p, cudaStream_t s) {
  if (p.seg_q != nullptr)
    return p.drop.on ? launch_fused<true, true>(p, s)
                     : launch_fused<true, false>(p, s);
  return p.drop.on ? launch_fused<false, true>(p, s)
                   : launch_fused<false, false>(p, s);
}

enum Which { kDq = 0, kDkv = 1, kFused = 2 };

template <typename T>
int run(Which which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* seg_q, const void* seg_k, const void* bias, void* dq,
        void* dk, void* dv, int B, int H, int HK, int Sq, int Sk, int D,
        const long long (&strides)[12], float scale, int causal, int dropout,
        unsigned drop_threshold, unsigned drop_seed, float drop_scale,
        void* stream) {
  bool aligned = (reinterpret_cast<uintptr_t>(q) |
                  reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v) |
                  reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  for (long long st : strides) aligned = aligned && st % 8 == 0;
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK || Sq <= 0 || Sk <= 0 ||
      (D != 64 && D != 128) || !aligned ||
      static_cast<long long>(B) * H > 65535 ||
      (seg_q == nullptr) != (seg_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (which == kFused &&
      (D != 64 || HK != H || Sk > kMaxClusterTiles * kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdTcParams<T> p = {};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.bias = static_cast<const float*>(bias);
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  p.B = B;
  p.H = H;
  p.HK = HK;
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
  if (which == kFused)
    err = launch_fused_flags(p, s);
  else
    err = D == 64 ? launch_d<64>(which == kDkv, p, s)
                  : launch_d<128>(which == kDkv, p, s);
  return static_cast<int>(err);
}

// the body of dtype 1 (bfloat16) or 2 (float16)
int run_dtype(int dtype, Which which, const void* q, const void* k,
              const void* v, const void* dout, const void* lse,
              const void* delta, const void* seg_q, const void* seg_k,
              const void* bias, void* dq, void* dk, void* dv, int B, int H,
              int HK, int Sq, int Sk, int D, const long long (&strides)[12],
              float scale, int causal, int dropout, unsigned drop_threshold,
              unsigned drop_seed, float drop_scale, void* stream) {
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  auto body = dtype == 1 ? run<__nv_bfloat16> : run<__half>;
  return body(which, q, k, v, dout, lse, delta, seg_q, seg_k, bias, dq, dk,
              dv, B, H, HK, Sq, Sk, D, strides, scale, causal, dropout,
              drop_threshold, drop_seed, drop_scale, stream);
}

}  // namespace

// K2's 16-bit tensor-core body, arguments as flash_bwd.cu's
// paddle_flash_bwd_dq: dtype must be 1 (bfloat16) or 2 (float16), D 64 or
// 128, HK dividing H, and q, k, v and dout rows 16-byte aligned (base
// pointers and the batch, sequence and head strides, in elements). seg_q,
// seg_k (both or neither) and bias may be null. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int paddle_flash_bwd_dq_tc(
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
  return run_dtype(dtype, kDq, q, k, v, dout, lse, delta, seg_q, seg_k, bias,
                   dq, nullptr, nullptr, B, H, HK, Sq, Sk, D, strides, scale,
                   causal, dropout, drop_threshold, drop_seed, drop_scale,
                   stream);
}

// K3's 16-bit tensor-core body, arguments as paddle_flash_bwd_dq_tc with dk
// and dv ([B, Sk, HK, D]) for dq.
extern "C" int paddle_flash_bwd_dkv_tc(
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
  return run_dtype(dtype, kDkv, q, k, v, dout, lse, delta, seg_q, seg_k, bias,
                   nullptr, dk, dv, B, H, HK, Sq, Sk, D, strides, scale,
                   causal, dropout, drop_threshold, drop_seed, drop_scale,
                   stream);
}

// K4b-fused's 16-bit tensor-core body (flash_packed_bwd_fused_tc_kernel):
// dq, dk and dv ([B, Sq, H, 64] and [B, Sk, H, 64]) in one launch, one
// cluster of ceil(Sk / 64) blocks a head. Arguments as paddle_flash_bwd_dq_tc
// with dk and dv after dq; D must be 64, HK = H and Sk <= 512.
extern "C" int paddle_flash_packed_bwd_fused_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dq, void* dk, void* dv, int B, int H, int HK,
    int Sq, int Sk, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, int causal, int dtype, int dropout,
    unsigned drop_threshold, unsigned drop_seed, float drop_scale,
    void* stream) {
  const long long strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  return run_dtype(dtype, kFused, q, k, v, dout, lse, delta, seg_q, seg_k,
                   bias, dq, dk, dv, B, H, HK, Sq, Sk, D, strides, scale,
                   causal, dropout, drop_threshold, drop_seed, drop_scale,
                   stream);
}

// The width of a body's stage at head dim D (dkv = 0: dq's keys, 1: dk/dv's
// queries), the unit of its f32 sums; 0 for a head dim it does not take.
// The bodies round only ds and p, element by element, so the stage moves
// nothing but the order of the f32 sums; chip_smoke.py prints it, and holds
// the D = 64 stages to flash_attention_packed.KERNEL_TILE, the tiles K4's
// streamed plain versions sum over.
extern "C" int paddle_flash_bwd_tc_stage(int D, int dkv) {
  if (D == 64) return dkv ? Shape<64>::kDkvN : Shape<64>::kDqN;
  if (D == 128) return dkv ? Shape<128>::kDkvN : Shape<128>::kDqN;
  return 0;
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
