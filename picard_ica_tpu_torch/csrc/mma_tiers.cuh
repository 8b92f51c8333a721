// Tensor-core building blocks for the three tiers of the fused core
// kernel (rotated_fused_tc.cu) and of the streaming kernel's tensor-core
// route (streaming_fused_tc.cu).
//
// The tiers of density.cuh, on mma.sync: BF16 = one product of bf16
// operands with f32 accumulation; BF16X3 = the hi/lo bf16 split of both
// operands (hi = bf16(v), lo = bf16(v - hi), round to nearest even) and
// three products hi*hi, lo*hi, hi*lo into one f32 accumulator; F32 = the
// three-way split hi / mid / lo of both operands and the six products
// whose terms are at least 2^-16 of hi*hi (the TPU's Precision.HIGHEST,
// "exact f32"). Products of bf16 values are exact in f32, so only the
// order and rounding of the f32 sums differ from the scalar kernels and
// the plain PyTorch versions.
//
// The tensor cores add an MMA's products to its accumulator with the
// result rounded toward zero, not to nearest, so a long chain of MMAs
// into one accumulator drifts toward zero by up to an ulp a link. The
// F32 and BF16X3 tiers keep their sums out of such chains: their hi*hi
// products go either to an accumulator whose sums are exact (the f32
// rotation's fixed-point grids, rotated_fused_tc.cu) or to a fresh one
// per 16-deep step, which the caller adds in f32 to nearest.
//
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "density.cuh"

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

// The three-way split of a pair: hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid); hi + mid + lo == v exactly (each difference is
// exact in f32, and v's 24 bits fit three 8-bit significands).
__device__ __forceinline__ void split3_pair(float a, float b, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  hi = pack_bf16(a, b);
  split_pair(a - bf16_lo_f32(hi), b - bf16_hi_f32(hi), mid, lo);
}

// The fixed-point grid of a row or column whose largest magnitude is m =
// 2^e * 1.f: sigma = 1.5 * 2^(e + 16), and (v + sigma) - sigma rounds any
// |v| <= m to a multiple of 2^(e - 7) of at most 2^8 units, a bf16 value.
// Zero and subnormal m take the grid of 2^-126. Magnitudes from 2^111 up
// (far outside whitened data) are not on a grid.
__device__ __forceinline__ float grid_sigma(float m) {
  int e = (__float_as_int(m) >> 23) & 0xff;  // biased exponent of m >= 0
  e = e < 1 ? 1 : (e > 238 ? 238 : e);
  return __int_as_float(((e + 16) << 23) | 0x400000);
}

__device__ __forceinline__ float grid_round(float v, float sigma) {
  return __fsub_rn(__fadd_rn(v, sigma), sigma);
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

// bf16 parts an operand splits into at the tier.
__host__ __device__ constexpr int parts(int tier) {
  return tier == BF16 ? 1 : tier == BF16X3 ? 2 : 3;
}

// The pairs of the core kernel's fused pass (kernel 1) that run
// rotated_fused_wgmma.cu's kernel: delta mode on f32 X, the rotation and
// the contraction both at F32 or both at BF16X3, without H. Every other
// pair runs rotated_fused_tc.cu's mma.sync kernel; the C entry
// picard_core_wgmma_pair exports the rule.
__host__ __device__ constexpr bool core_wgmma_pair(bool delta, int rot, int ct, bool x_bf16,
                                                   bool need_h) {
  return delta && !x_bf16 && !need_h && rot == ct && (rot == F32 || rot == BF16X3);
}

// Two values as the bf16x2 registers of their parts at the tier, split
// elementwise.
template <int TIER>
__device__ __forceinline__ void split_parts(float a, float b, uint32_t (&v)[parts(TIER)]) {
  if constexpr (TIER == BF16) {
    v[0] = pack_bf16(a, b);
  } else if constexpr (TIER == BF16X3) {
    split_pair(a, b, v[0], v[1]);
  } else {
    split3_pair(a, b, v[0], v[1], v[2]);
  }
}

// d += A B at the tier, from the fragments of each part of A (a[p]) and
// of B (b[p] = b0, b1): p = 0 hi, then lo (BF16X3) or mid, lo (F32).
//   BF16:   hi*hi into d;
//   BF16X3: hi*hi, lo*hi, hi*lo into d;
//   F32:    lo*hi, mid*mid, hi*lo, mid*hi, hi*mid into `small`, then hi*hi
//           into d: the small products first. With d and small the same
//           accumulator, one chain that ends with hi*hi.
template <int TIER>
__device__ __forceinline__ void mma_tier(float (&d)[4], float (&small)[4],
                                         const uint32_t (&a)[parts(TIER)][4],
                                         const uint32_t (&b)[parts(TIER)][2]) {
  if constexpr (TIER == F32) {
    mma_bf16(small, a[2], b[0][0], b[0][1]);
    mma_bf16(small, a[1], b[1][0], b[1][1]);
    mma_bf16(small, a[0], b[2][0], b[2][1]);
    mma_bf16(small, a[1], b[0][0], b[0][1]);
    mma_bf16(small, a[0], b[1][0], b[1][1]);
  }
  mma_bf16(d, a[0], b[0][0], b[0][1]);
  if constexpr (TIER == BF16X3) {
    mma_bf16(d, a[1], b[0][0], b[0][1]);
    mma_bf16(d, a[0], b[1][0], b[1][1]);
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

// The mbarrier at `bar` receives one arrival once every cp.async this
// thread has issued so far has landed (its expected count includes it).
__device__ __forceinline__ void cp_async_mbar_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
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
