// Attention-prob dropout of the flash-attention kernels (K1-K4), shared by
// flash_fwd.cu, flash_fwd_tc.cu, flash_bwd.cu, flash_packed.cu,
// flash_packed_tc.cu, flash_packed_stream.cu and flash_bwd_tc.cu.
//
// The mask is the TPU kernels' own (paddle_tpu/ops/_pallas/flash_attention.py
// _mix32, _keep_threshold and _dropout_keepf, :125-155): the score of query q
// and key k of the flat query head bh = b * H + h has the flat index
//   idx = (bh * Sq + q) * Sk + k          (uint32 arithmetic: it wraps at 2^32)
// and is dropped when murmur3's finalizer of idx ^ seed falls below the
// threshold min(int(rate * 2^32), 2^32 - 1); a kept score is scaled by
// float32(1 / (1 - rate)). The host computes the threshold and the scale as
// JAX computes them and passes the int32 seed's bits. Every kernel applies the
// same function of (bh, q, k), so a forward and its backward regenerate one
// mask, and the kernels' own tiles do not enter it.

#pragma once

struct DropoutArgs {
  int on;              // 0: no dropout
  unsigned threshold;  // a hash below it drops
  unsigned seed;       // the bits of the int32 seed
  float scale;         // the factor of a kept probability
};

__device__ __forceinline__ unsigned dropout_mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// the keep factor of the score (bh, q, k): 0 (dropped) or d.scale
__device__ __forceinline__ float dropout_keep(const DropoutArgs& d, int bh,
                                              int Sq, int Sk, int q, int k) {
  const unsigned row = static_cast<unsigned>(bh) *
                           static_cast<unsigned>(Sq) +
                       static_cast<unsigned>(q);
  const unsigned idx =
      row * static_cast<unsigned>(Sk) + static_cast<unsigned>(k);
  return dropout_mix32(idx ^ d.seed) >= d.threshold ? d.scale : 0.f;
}

inline DropoutArgs make_dropout(int on, unsigned threshold, unsigned seed,
                                float scale) {
  DropoutArgs d;
  d.on = on;
  d.threshold = threshold;
  d.seed = seed;
  d.scale = scale;
  return d;
}
