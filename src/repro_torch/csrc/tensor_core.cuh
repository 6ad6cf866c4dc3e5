// PTX helpers shared by the bf16 attention kernels (flash_attention.cu,
// flash_attention_bwd.cu and flash_decode.cu) and dot_interaction.cu:
// 16-byte asynchronous copies into shared memory, ldmatrix fragment
// loads, the m16n8k16 bf16 tensor-core product with float32
// accumulators, and the MUFU forms of 2^x and tanh.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * grp + tig, grp = lane / 4,
// tig = lane % 4):
//   A (16 x 16, row-major), 4 registers of 2 bf16: a0 = (row grp, cols
//     2 tig, 2 tig + 1), a1 = (row grp + 8, same cols), a2 = (row grp,
//     cols 2 tig + 8, + 9), a3 = (row grp + 8, cols 2 tig + 8, + 9);
//   B (16 x 8, k x n), 2 registers: b0 = (k rows 2 tig, 2 tig + 1, col
//     grp), b1 = (k rows 2 tig + 8, + 9, col grp);
//   C (16 x 8, float32), 4 registers: c0, c1 = (row grp, cols 2 tig,
//     2 tig + 1), c2, c3 = (row grp + 8, same cols).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1. With `valid`
// false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and register j receives this lane's pair of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, `lo` in the low half (the
// lower column of an A fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as the sum of two bf16 pairs packed like pack_bf16: hi =
// bf16(x), lo = bf16(x - hi). A product with hi and one with lo keep ~16
// bits of x instead of bf16's 8.
__device__ __forceinline__ void split_bf16(float lo_col, float hi_col,
                                           uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(lo_col, hi_col);
  lo = pack_bf16(lo_col - __uint_as_float(hi << 16),
                 hi_col - __uint_as_float(hi & 0xffff0000u));
}

// 2^x in one MUFU op (denormal results flush to zero; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (2^(2 x log2(e)) + 1) in two MUFU ops (ex2, rcp;
// +-1 where 2^.. overflows or underflows): an absolute error of ~2e-7, a
// few parts in 1e5 of a logit at a softcap of 50, against tanhf's ~20
// instructions. The softcap of the bf16 wgmma kernels, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): one
// function, so that the backward's P = exp(t - lse) rebuilds the t whose
// lse the forward wrote.
__device__ __forceinline__ float tanh_ex2(float x) {
  constexpr float kTwoLog2e = 2.f * 1.4426950408889634f;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n"
      : "=f"(r) : "f"(exp2_approx(kTwoLog2e * x) + 1.f));
  return fmaf(-2.f, r, 1.f);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tc
