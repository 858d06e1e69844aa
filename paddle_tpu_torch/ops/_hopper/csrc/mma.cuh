// Tensor-core helpers of the 16-bit attention bodies (flash_packed_tc.cu,
// flash_fwd_tc.cu, flash_bwd_tc.cu) and of conv.cu's: shared-memory
// addresses, cp.async copies, ldmatrix and mma.sync.m16n8k16 (bf16 or
// float16 in, f32 accumulate), for Hopper (sm_90a).
//
// The element type T (__nv_bfloat16 or __half) enters only the products
// (mma_16816<T>) and the roundings (pack2<T>, round_to<T>): cp.async and
// ldmatrix move 16-bit values without looking at them. JAX's kernels take
// float16 as they take bf16 (their dots name an f32 result type), so each
// 16-bit body is one template over T.
//
// mma.sync's fragments, per lane (g = lane >> 2, tq = lane & 3):
//   A 16 x 16 (row): a[0] = (g, 2tq..2tq+1), a[1] = (g+8, 2tq..),
//                    a[2] = (g, 8+2tq..),    a[3] = (g+8, 8+2tq..)
//   B 16 x 8 (col):  b0 = (k 2tq..2tq+1, n g), b1 = (k 8+2tq.., n g)
//   C 16 x 8 f32:    c[0..1] = (g, 2tq..2tq+1), c[2..3] = (g+8, 2tq..)
// so a score tile's accumulators, rounded to bf16 in pairs, are the A operand
// of the value product without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes from global to shared memory, zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the same with a run-time N (0 to 16; more waits for all)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
#define PADDLE_WAIT(N) \
  case N:              \
    cp_async_wait<N>(); \
    break;
    PADDLE_WAIT(1) PADDLE_WAIT(2) PADDLE_WAIT(3) PADDLE_WAIT(4)
    PADDLE_WAIT(5) PADDLE_WAIT(6) PADDLE_WAIT(7) PADDLE_WAIT(8)
    PADDLE_WAIT(9) PADDLE_WAIT(10) PADDLE_WAIT(11) PADDLE_WAIT(12)
    PADDLE_WAIT(13) PADDLE_WAIT(14) PADDLE_WAIT(15) PADDLE_WAIT(16)
#undef PADDLE_WAIT
    default:
      cp_async_wait<0>();
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), both of T; d 16 x 8 f32
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4],
                                                  const unsigned (&a)[4],
                                                  unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to T as one register of a pair, the first in the low half
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi);

template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <>
__device__ __forceinline__ unsigned pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// the two values of a pair register as f32 (low half first)
template <typename T>
__device__ __forceinline__ float2 unpack2(unsigned w);

template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

template <>
__device__ __forceinline__ float2 unpack2<__half>(unsigned w) {
  __half2 v;
  *reinterpret_cast<unsigned*>(&v) = w;
  return __half22float2(v);
}
