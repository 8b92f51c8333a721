// Tensor-core building blocks for the bf16 and bf16x3 tiers of the core
// kernels (rotated_fused_tc.cu; the streaming kernel's bf16 tiers are to
// take them next).
//
// The tiers of density.cuh, on mma.sync: BF16 = one product of bf16
// operands with f32 accumulation; BF16X3 = the hi/lo bf16 split of both
// operands (hi = bf16(v), lo = bf16(v - hi), round to nearest even) and
// three products hi*hi, lo*hi, hi*lo into one f32 accumulator. Products of
// bf16 values are exact in f32, so only the order of the f32 sums differs
// from the scalar kernels and the plain PyTorch versions.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX
// ISA, "Matrix Fragments for mma.m16n8k16"), lane = 4 g + q:
//   A (16 x 16, row-major) a[0..3]: rows g, g + 8, g, g + 8; columns
//     2q, 2q + 1 (a[0], a[1]) and 2q + 8, 2q + 9 (a[2], a[3]);
//   B (16 x 8, k x n) b[0..1]: column g, rows 2q, 2q + 1 and 2q + 8, 2q + 9;
//   C (16 x 8) c[0..3]: row g columns 2q, 2q + 1, then row g + 8.
// Each 32-bit register holds two bf16, the lower column (or k) in the low
// half. ldmatrix loads them from shared memory: A from a row-major tile,
// B from an [n][k] tile (non-transposed) or a [k][n] tile (.trans).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace {

// ---- bf16 pairs ----

// Two f32 values as one bf16x2 register (a in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi_f32(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// The hi/lo split of a pair: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf16_lo_f32(hi), b - bf16_hi_f32(hi));
}

// ---- shared memory ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Lane's row address of an ldmatrix.x4 over a 16 x 16 bf16 block at
// `base` (row stride `ld` elements). A order: matrices (rows 0-7, cols
// 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols
// 8-15), i.e. a[0..3] of an A tile, or b0, b1 of n-tiles 0 and 1 of a
// [k][n] tile with .trans. B order: (rows 0-7, cols 0-7), (rows 0-7, cols
// 8-15), (rows 8-15, cols 0-7), (rows 8-15, cols 8-15), i.e. b0, b1 of
// n-tiles 0 and 1 of an [n][k] tile.
__device__ __forceinline__ const __nv_bfloat16* ldm_a_addr(const __nv_bfloat16* base, int ld,
                                                          int lane) {
  const int m = lane >> 3;
  return base + ((m & 1) * 8 + (lane & 7)) * ld + (m >> 1) * 8;
}

__device__ __forceinline__ const __nv_bfloat16* ldm_b_addr(const __nv_bfloat16* base, int ld,
                                                          int lane) {
  const int m = lane >> 3;
  return base + ((m >> 1) * 8 + (lane & 7)) * ld + (m & 1) * 8;
}

// ---- the product ----

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B at the tier: hi*hi, then (BF16X3) lo*hi and hi*lo.
template <bool X3>
__device__ __forceinline__ void mma_tier(float (&d)[4], const uint32_t (&a_hi)[4],
                                         const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                         uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_bf16(d, a_hi, b0_hi, b1_hi);
  if (X3) {
    mma_bf16(d, a_lo, b0_hi, b1_hi);
    mma_bf16(d, a_hi, b0_lo, b1_lo);
  }
}

// ---- cp.async (zero-fill when `in` is false) ----

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's newest commit groups are
// still in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

}  // namespace
