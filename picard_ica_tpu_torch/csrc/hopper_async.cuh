// Hopper's own instructions for the streaming kernel's launches A and B
// (streaming_fused_tc.cu rotate_wgmma_kernel, rotate_plain_wgmma_kernel,
// contract_wgmma_kernel) and
// the core kernel's wgmma pairs (rotated_fused_wgmma.cu): mbarriers, bulk
// and tensor-map copies from global into shared memory, wgmma.mma_async
// m64n128k16 and m64n64k16 (and m64n32k16) with both operands read from
// shared memory, named barriers and setmaxnreg. sm_90a only.
//
// The operand tiles are in wgmma's no-swizzle K-major layout: a tile of
// R rows (M for A, N for B) x 16 k bf16 is R / 8 groups of 8 rows, each
// group two 8 x 8 core matrices (k 0-7, then k 8-15) of 128 contiguous
// bytes, a row of a core matrix 16 bytes: element (r, k) at byte
// (r / 8) * 256 + (k / 8) * 128 + (r % 8) * 16 + (k % 8) * 2. So the
// descriptor's leading byte offset (the next core matrix along k) is 128
// and its stride byte offset (the next 8 rows) 256 (CORE_LBO, CORE_SBO).
#pragma once

#include <cstdint>

#include "mma_tiers.cuh"

namespace {

constexpr unsigned CORE_LBO = 128, CORE_SBO = 256;

// ---- mbarriers (shared memory, CTA scope) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (the bulk
// copies' complete_tx) and to the other threads after a block barrier.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and expect `bytes` of bulk copies on the barrier's phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity (0 for its first
// phase, 1 for its second, ...) has completed. A phase that has not
// completed after ~2^36 clocks (~35 s) is a fault of the kernel: it traps,
// so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 36)) {
      __trap();
    }
  }
}

// ---- bulk copies and proxies ----

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A box of a tiled 2-D tensor map (element, row) from global into this
// block's shared memory, completing on `bar`; `map` is the address of a
// __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// A box of a tiled tensor map (3-D: element, row, plane) from global
// into this block's shared memory, completing on `bar`; `map` is the
// address of a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// A box of a tiled tensor map (3-D: element, row, plane) from this
// block's shared memory into global memory, in this thread's current bulk
// group (bulk_commit).
__device__ __forceinline__ void tma_store_3d(const void* map, const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's newest bulk groups have not
// yet read their shared memory (the source may then be written again).
template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING) : "memory");
}

// Wait until at most PENDING of this thread's newest bulk groups are not
// yet complete.
template <int PENDING>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Orders this thread's shared-memory stores before later reads of the
// async proxy (wgmma's operand reads, a tensor-map store's reads).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- registers of a warpgroup ----

template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// A barrier of THREADS_IN of the block's threads, whole warps, on named
// barrier `id` (1-15; id 0 is __syncthreads').
template <int THREADS_IN>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS_IN) : "memory");
}

// ---- wgmma ----

// A no-swizzle K-major tile at `p` (16-byte aligned) as a descriptor.
__device__ __forceinline__ uint64_t core_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)(CORE_LBO >> 4) << 16 |
         (uint64_t)(CORE_SBO >> 4) << 32;
}

// A K-major tile at `p` (1024-byte aligned) in the 128-byte swizzle that a
// tensor map's CU_TENSOR_MAP_SWIZZLE_128B box lands in: rows of 64 bf16
// (128 bytes), 8-row atoms of 1024 bytes, each row's 16-byte chunks
// permuted by the row's index mod 8. A wgmma k block of 16 starts 32
// bytes further along the rows (add 2 to the descriptor).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

// A bf16 B tile at `p` (1024-byte aligned), MN-major in the same swizzle:
// the box of a tensor map over a row-major (K, N) matrix, 64 N values (128
// bytes) a k row, 8 k rows an atom of 1024 bytes, so a 16-deep k block
// starts 2048 bytes further (add 128 to the descriptor). The stride
// between 8-row groups along K is the stride byte offset; the leading byte
// offset (the next 64 N values) is unused at N = 64 and given the same
// 1024 bytes. Read with wgmma's transpose bit for B (wgmma_m64n64k16_mnb_fresh).
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)(1024 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most PENDING of this warpgroup's newest wgmma groups are
// still running.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// The compiler must not move reads or writes of the accumulator across
// the asynchronous product: each register passes through an empty asm.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B (fresh = true: the accumulator's old value is not read) or d +=
// A B for a 64 x 16 bf16 A and a 16 x 128 bf16 B, both K-major in shared
// memory, f32 d: thread t of the warpgroup holds d[4 i + 2 h + e] at row
// 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 i + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 bool fresh) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"((unsigned)fresh));
}

// d = A B (fresh) or d += A B for a 64 x 16 bf16 A and a 16 x 64 bf16 B,
// both K-major in shared memory, f32 d: thread t of the warpgroup holds
// d[4 i + 2 h + e] at row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 i +
// 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                bool fresh) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"((unsigned)fresh));
}

// d = A B with B MN-major, d written only (scale-d = 0): its registers are
// outputs of the asm, so nothing before it keeps them live.
__device__ __forceinline__ void wgmma_m64n64k16_mnb_fresh(float (&d)[32], uint64_t a,
                                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0u));
}

// The same for a 16 x 32 B: d[4 i + 2 h + e] at row 16 (t / 32) + (t %
// 32) / 4 + 8 h, column 8 i + 2 (t % 4) + e, i < 4.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b,
                                                bool fresh) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"((unsigned)fresh));
}

}  // namespace
