// Flash-attention forward (K1) for Hopper (sm_90a), CUDA C++: the float32
// body, on the CUDA cores. bf16 inputs run on flash_fwd_tc.cu's tensor-core
// body (on the tensor cores float32 would mean TF32, which is not the function
// the reference computes).
//
// Replaces paddle_tpu/ops/_pallas/flash_attention.py:_fwd_kernel (driven by
// _fwd). What it computes is what that kernel computes:
//   o   = softmax(scale * q k^T + mask) v        (f32 softmax state and sums)
//   lse = m + log(max(l, 1e-30))                  (f32, natural log)
// with bottom-right causal masking (query i sees keys j <= i + Sk - Sq),
// grouped-query KV (query head h reads KV head h / (H / HK), never repeated;
// _kv_index), and the masked-row convention of _fwd_kernel's _finish: a row
// with no valid key keeps m = NEG_INF = -1e30 and l clamped at 1e-30, so it
// gives o = 0 and lse = -1e30. The masks go where a score is formed, in
// _fwd_kernel's order (:264-269): the scale, then causal, then segments
// (seg_q[b, i] == seg_k[b, j], else NEG_INF; _seg_mask :189-195), then the f32
// key bias (s + bias[b, j]). A masked score stays masked under a finite bias
// (p = exp(s - m) * (s > NEG_INF / 2)), and a -inf bias gives p = 0 and no
// NaN, because m starts at NEG_INF. The segments and the bias are per batch
// row ([B, Sq], [B, Sk]): every head of b reads the same row, never a per-head
// copy. With attention-prob dropout (dropout.cuh, the TPU kernel's position
// hash of (b*H + h, q, k)) the value product takes p * keep while l sums the
// undropped p.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, HK, D], read through their batch,
// sequence and head strides (the last dimension must be dense), so the caller
// makes no transposed copy. seg_q [B, Sq], seg_k [B, Sk] int32 and bias
// [B, Sk] f32 are dense, or null when absent. o is written dense
// [B, Sq, H, D]; lse dense [B, H, Sq]. Any Sq and Sk work: the ragged edge is
// masked here. JAX skips no tile for segments, and neither does this kernel.
//
// Design. One block of 128 threads per (b*h, 64-query tile); a loop over
// 64-key tiles staged in shared memory takes the place of Pallas's sequential
// third grid axis, and the softmax state (m, l) and the output accumulator
// stay in registers across it. On the causal path the loop stops at the
// diagonal tile, Hopper's counterpart of the TPU kernel's triangular pairing:
// no tile above the diagonal is loaded. Each thread owns a 4 x 8 micro-tile of
// the 64 x 64 score tile and a 4 x D/8 slice of the output, so the products
// read 12 shared-memory words per 32 FMAs; Q and K rows are padded to D + 1
// floats so the column reads hit distinct banks. The 8 threads of a row group
// are adjacent lanes and reduce the row max and sum with warp shuffles.
//
// What bounds it on an H100. At the serving path's prefill shapes (S 64 to
// 2048, D 128) attention is bound by operations: 4 * S^2 * D / 2 FLOPs per
// head (causal) against 4 * S * D * 4 bytes, at the 67 TFLOP/s float32 peak
// of the CUDA cores, which run both products as FMAs. Its tiles take 115 KB
// of shared memory at D = 128: two blocks fit an SM with 0.5 KB to spare
// (staging the masks there cost the second block and 60% of the time on an
// H100), so the masks are read from global memory.

#include <cuda_runtime.h>

#include "dropout.cuh"

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel

struct FlashFwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* seg_q;   // null: no segments
  const int* seg_k;
  const float* bias;  // null: no key bias
  int B, H, HK, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
  DropoutArgs drop;  // attention-prob dropout (dropout.cuh)
};

template <int D>
constexpr size_t smem_bytes() {
  // sQ [64][D+1] + sK [64][D+1] + sV [64][D] + sP [64][65], all f32 (at D =
  // 128 two blocks fit an SM: the masks are read from global memory, not
  // staged here, so as not to lose the second block)
  return sizeof(float) * static_cast<size_t>(kBlockM * (D + 1) +
                                             kBlockN * (D + 1) + kBlockN * D +
                                             kBlockM * (kBlockN + 1));
}

// the score of query qi and key kj after _fwd_kernel's masks, in its order:
// causal, then segments, then the key bias (a masked score is NEG_INF + bias);
// a key past Sk does not exist: masked, and outside the bias. seg_k and bias
// point at batch row b's [Sk] row (L1 holds them across the tile's rows).
// Without segments or a bias (kMasks false) only the causal mask is tested.
template <bool kMasks>
__device__ __forceinline__ float mask_score(const FlashFwdParams& p, float s,
                                            int qi, int kj, int offset,
                                            int seg_q, const int* seg_k,
                                            const float* bias) {
  const bool ok = kj < p.Sk && (!p.causal || kj <= qi + offset);
  if (!kMasks) return ok ? s : kNegInf;
  if (kj >= p.Sk) return kNegInf;
  if (!ok) s = kNegInf;
  if (p.seg_q != nullptr && seg_q != seg_k[kj]) s = kNegInf;
  if (p.bias != nullptr) s += bias[kj];
  return s;
}

template <int D, bool kMasks>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashFwdParams p) {
  constexpr int LDK = D + 1;        // padded row stride of the Q and K tiles
  constexpr int LDP = kBlockN + 1;  // padded row stride of the P tile
  constexpr int DT = D / 8;         // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockM * LDK;
  float* sV = sK + kBlockN * LDK;
  float* sP = sV + kBlockN * D;

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // column group: score columns tx + 8j
  const int ty = tid >> 3;  // row group: rows 4ty .. 4ty+3
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.HK);  // _kv_index: no repeated KV
  const int q0 = blockIdx.x * kBlockM;
  const int offset = p.Sk - p.Sq;   // bottom-right causal alignment

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int qi = q0 + r;
    sQ[r * LDK + c] =
        qi < p.Sq ? qb[static_cast<long long>(qi) * p.q_ss + c] : 0.f;
  }
  // the masks of batch row b: this thread's rows' segments, the keys' rows
  const int* segk_row =
      p.seg_k != nullptr ? p.seg_k + static_cast<long long>(b) * p.Sk : nullptr;
  const float* bias_row =
      p.bias != nullptr ? p.bias + static_cast<long long>(b) * p.Sk : nullptr;
  int segq_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    segq_r[i] = p.seg_q != nullptr && qi < p.Sq
                    ? p.seg_q[static_cast<long long>(b) * p.Sq + qi] : 0;
  }

  float m_i[4], l_i[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) acc[i][jj] = 0.f;
  }

  // Keys this tile needs: all of them, or on the causal path up to the
  // diagonal of its last row (none when Sq > Sk leaves every row empty).
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q0 + kBlockM + offset);
  const int n_tiles = kv_end > 0 ? (kv_end + kBlockN - 1) / kBlockN : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the last tile's readers of sK, sV and sP are done
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int kj = k0 + r;
      const bool in = kj < p.Sk;
      sK[r * LDK + c] =
          in ? kb[static_cast<long long>(kj) * p.k_ss + c] : 0.f;
      sV[r * D + c] =
          in ? vb[static_cast<long long>(kj) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LDK + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = sK[(tx + 8 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = mask_score<kMasks>(p, s[i][j] * p.scale, qi,
                                     k0 + tx + 8 * j, offset, segq_r[i],
                                     segk_row, bias_row);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // masked entries stay exactly 0: a row with no valid key so far has
        // s == m_new == NEG_INF, and exp(0) would average V
        const float e = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = e;
        rs += e;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) acc[i][jj] *= alpha;
      // dropout: l keeps the undropped p, the value product takes p * keep
      // (_fwd_kernel :278-288)
      if (p.drop.on) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (s[i][j] != 0.f)
            s[i][j] *= dropout_keep(p.drop, bh, p.Sq, p.Sk, qi, k0 + tx + 8 * j);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sP[(ty * 4 + i) * LDP + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

    const int n_keys = min(kBlockN, p.Sk - k0);
#pragma unroll 4
    for (int c = 0; c < n_keys; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) {
        const float vv = sV[c * D + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pr[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < p.Sq) {
      const float lc = fmaxf(l_i[i], 1e-30f);
      float* orow = static_cast<float*>(p.o) +
                ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * D;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj)
        orow[tx + 8 * jj] = acc[i][jj] / lc;
      if (tx == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
            m_i[i] + logf(lc);
    }
  }
}

template <int D, bool kMasks>
cudaError_t launch(const FlashFwdParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kMasks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.B * p.H);
  flash_fwd_kernel<D, kMasks><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const FlashFwdParams& p, int d, cudaStream_t stream) {
  const bool masks = p.seg_q != nullptr || p.bias != nullptr;
  switch (d) {
    case 64:
      return masks ? launch<64, true>(p, stream)
                   : launch<64, false>(p, stream);
    case 128:
      return masks ? launch<128, true>(p, stream)
                   : launch<128, false>(p, stream);
    case 256:
      return masks ? launch<256, true>(p, stream)
                   : launch<256, false>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype must be 0 (float32; bf16 runs on flash_fwd_tc.cu's tensor-core
// body). Strides are in elements; seg_q, seg_k
// (both or neither) and bias may be null. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int paddle_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, const void* seg_q,
                                const void* seg_k, const void* bias, int B,
                                int H, int HK,
                                int Sq, int Sk, int D, long long q_sb,
                                long long q_ss, long long q_sh, long long k_sb,
                                long long k_ss, long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, float scale,
                                int causal, int dtype, int dropout,
                                unsigned drop_threshold, unsigned drop_seed,
                                float drop_scale,
                                void* stream) {
  FlashFwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  if (B <= 0 || H <= 0 || HK <= 0 || H % HK || Sq <= 0 || Sk < 0 ||
      (seg_q == nullptr) != (seg_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_d(p, D, s));
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
