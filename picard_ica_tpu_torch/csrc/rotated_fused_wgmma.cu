// Hand-written Hopper (sm_90a) kernel for the line-search tries of the
// Picard-O core loop at N <= 64 in delta mode on f32 X, at the F32 and
// BF16X3 tiers (rotation tier = contraction tier), without H: the pairs of
// every try of the main path (mma_tiers.cuh core_wgmma_pair). It replaces
// picard_ica_tpu/ops/pallas_kernels.py rotated_fused_sums /
// _rotated_fused_kernel for those pairs; every other pair of that kernel
// stays on rotated_fused_tc.cu's mma.sync kernel.
//
// What it computes, exactly as rotated_fused_tc.cu's MODE_DELTA: Y_old =
// M_old X and dY = (M_new - M_old) X from one staged X; Y = Y_old + dY in
// f32; the delta density's row sums dll and pm (masked at columns >= T);
// with need_ysq, dysq = sum (2 Y_old + dY) dY and ysq = sum Y^2; G =
// psi(Y) Y^T at the contraction tier. One partial per COLS = 2048 columns
// at out + partial * stride, so the caller folds all outputs in one pass.
// No float atomics. Padded rows and columns are exact zeros, and psi' is
// masked at padded columns (psi'(0) != 0).
//
// The sums keep rotated_fused_tc.cu's order. F32 rotation: hi lies on
// fixed-point grids, per row of M_old and dM (rotated_fused_tc.cu's
// split_weight) and per column of X (2^-7 of its
// largest magnitude, mma_tiers.cuh grid_sigma), so every hi*hi sum over
// the rows is exact and chains in one accumulator; the five products of
// mid and lo chain in an accumulator of their own, added last to nearest.
// F32 contraction: each 16-column step's six products (small first, hi*hi
// last) start a fresh accumulator (scale-d = 0), added in f32 to nearest
// to its 256-column group's sum; the groups are added to G in order.
// BF16X3: each 16-deep step's three products start a fresh accumulator,
// in the rotation and in the contraction, added to nearest. A partial's
// sub-tiles alternate between three consumers: each sums its own steps,
// groups (256 of its own columns) and G so, and the three G are added at
// the partial's end.
//
// What bounds it on the card (one H100 SXM at 700 W), at N = 64 and 2M
// columns: the products, 74 K bf16 FMAs a column at F32 (2 rotations and
// the contraction at six products a 16-deep step; 0.298 ms on the tensor
// cores' 494.5 T FMA/s) and 37 K at BF16X3 (0.149 ms); X's 512 MB read
// once (0.153 ms of HBM); and beside them 1.3e8 evaluations of the delta
// density (tanh: exp, tanh, log1p and three IEEE divisions, ~130
// instructions an element with the row sums and the bf16 splits of psi
// and Y), which no tensor core lifts: ~0.85 ms of the SMs' issue at the
// ~0.66 instructions a cycle a partition that this mix reaches. In the
// mma.sync kernel the products and the density added up (PERF.md §6:
// products off saved 0.1-0.3 ms with tanh, the tanh density cost ~1 ms).
//
// What the design does about it (hopper_async.cuh's instructions): the
// products leave the issue slots for wgmma, and three consumers keep the
// density's issue busy while each one's products run.
//   * One block of four warpgroups an SM, taking partials a grid apart,
//     one at a time. Warpgroup 0 produces, warpgroups 1-3 consume
//     alternate sub-tiles of the partial, each into its own G, group and
//     row sums in the mma.sync kernel's order; at the partial's end the
//     three are added in the consumers' order and written. A block's work
//     unit is one partial, so a short T still fills the card (a block
//     holding three whole partials filled 1.23 waves at T = 1M).
//     setmaxnreg gives the consumers 160 registers and the producer 24.
//   * W stays resident: the consumers split M_old and dM once a block
//     into their bf16 parts (six 64 x 64 planes at F32, 48 KB; four at
//     BF16X3, 32 KB) in wgmma's no-swizzle K-major layout, while the
//     producer's first copies land; they are the rotation's A operands
//     from shared memory for the block's life. (Laid out by the caller in
//     torch, the planes cost ~20 small launches of host time a call.)
//   * The copies: the producer warpgroup keeps SF f32 stages of 64 rows x
//     BT = 32 columns in flight with cp.async, 16-byte copies (4-byte
//     ones at a ragged T, whose rows are not 16-byte aligned), each
//     thread's arrival on the stage's mbarrier following its copies
//     (cp.async.mbarrier.arrive), in column order (item i is consumer
//     i % 3's). (One bulk copy a row, 256 bytes, kept the copy engine's
//     queue, not the HBM, busy.)
//   * A consumer, per 32-column sub-tile: the split of its landed f32
//     stage into X's bf16 part tiles (hi / mid / lo at F32, hi on each
//     column's grid; hi / lo at BF16X3), after which the stage goes back
//     to the producer; the rotation, wgmma m64n32k16 (A = the W planes,
//     B = X's parts); the delta density on the accumulator fragments,
//     unrolled over the thread's 16 values, the row sums in registers;
//     psi's parts into the consumer's own tiles and Y's over X's, whose
//     products are done; the contraction, wgmma m64n64k16 over the two
//     16-column steps (A = psi, B = Y, K-major along columns), each step
//     in a fresh accumulator. The tiles' rows are M's in an order
//     (tile_row) that puts rows below 32 in every warp: at N <= 32 the
//     density runs in all four warps of a consumer, not two. Named
//     barriers of the warpgroup order its own steps; the consumers meet
//     only at a partial's end (a named barrier of the three, twice), the
//     producer never.
//   * The budget. Registers of a consumer thread at F32: one set's
//     rotation and its small-product sum 32 beside the other set's Y 16,
//     the group sum 32, the row sums 8, and G (32 values) in shared
//     memory: both sets at once, or G in registers, spilled at 160.
//     Shared memory at F32: W 48 KB, six f32 stages of 9 KB, three
//     consumers' parts (24 KB each), G (16 KB each) and row sums (1 KB
//     each): 225 KB of the 227 KB; at BF16X3 16 KB parts, 185 KB.
//   * What holds it (PERF.md §6): the density's issue (tanh ~9.5 K
//     cycles of a consumer's ~13 K a sub-tile at BF16X3).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (picard_ica_tpu_torch/ops/_build.py).
// Every C entry returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "density.cuh"
#include "hopper_async.cuh"
#include "mma_tiers.cuh"

namespace {

constexpr int NMAX = 64;
constexpr int COLS = 2048;        // columns per partial (rotated_fused_tc.cu COLS)
constexpr int GROUP_COLS = 256;   // columns of a group of the F32 contraction's sums
constexpr int BT = 32;            // columns of a sub-tile
constexpr int GROUP_SUBS = GROUP_COLS / BT;
constexpr int NC = 3;             // consumer warpgroups, alternate sub-tiles of a partial each
constexpr int THREADS = 128 * (1 + NC);
constexpr int KROT = BT * 16 * 2;     // bytes of one 16-deep k step of X's parts (BT columns)
constexpr int KCON = NMAX * 16 * 2;   // bytes of one 16-deep step of a 64-row tile
constexpr int WPLANE = 4 * KCON;      // bytes of one 64 x 64 part of M_old or dM
constexpr int OP = 4 * KROT;          // bytes of one part of a sub-tile's operand (64 x BT)
constexpr int LDX = BT + 4;           // floats a row of an f32 stage (rows 2 apart: 8 banks)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;
constexpr int SM_SMEM = 233472;       // shared memory of an SM for its blocks
constexpr int BLOCK_RESERVED = 1024;  // kept by the system per block
static_assert(COLS % GROUP_COLS == 0 && GROUP_COLS % BT == 0, "");
static_assert(OP == 2 * KCON, "X's parts of a sub-tile and Y's take the same bytes");
// setmaxnreg moves registers between a block's warpgroups: the consumers
// can take beyond the launch's share (65,536 / 512 a thread: 128) only
// what the producer gives up, or their setmaxnreg.inc waits for ever.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
static_assert((LAUNCH_REGS - PRODUCER_REGS) * 128 >= (CONSUMER_REGS - LAUNCH_REGS) * 128 * NC,
              "the consumers' registers come from the producer's");

// Shared memory: the 2 P W planes; SF f32 stages (64 rows x LDX floats);
// each consumer's X parts (P parts, Y's once the rotation has read them)
// and psi (P parts; consumer 0's hold the W rows' grids in the prologue);
// each consumer's G (its 128 threads' 32 values, value e of thread t at e
// * 128 + t: at F32 the accumulator itself, as the registers of the group
// sums leave no room for G beside the rotation; at BF16X3 stored at the
// partial's end) and row sums (4 x NMAX), which the partial's end adds;
// the mbarriers.
template <int ROT>
struct Cfg {
  static constexpr int P = parts(ROT);
  static constexpr int SF = 6;
  static constexpr int XF = 2 * P * WPLANE;
  static constexpr int XF_STAGE = NMAX * LDX * 4;
  static constexpr int OWN = XF + SF * XF_STAGE;  // consumer c's at + 2 c P OP
  static constexpr int GS = OWN + NC * 2 * P * OP;  // consumer c's G at + c NMAX^2 floats
  static constexpr int RS = GS + NC * NMAX * NMAX * 4;  // consumer c's row sums at + 4 c NMAX
  static constexpr int BAR = RS + NC * 4 * NMAX * 4;
  static constexpr int BYTES = BAR + 2 * SF * 8;
  static_assert(BYTES + BLOCK_RESERVED <= SM_SMEM, "one block fits an SM");
  // Item i of a block goes to consumer i % NC and stage i % SF: the item
  // a stage held before is its consumer's own, so no consumer waits on a
  // phase of a stage that is two uses away.
  static_assert(SF % NC == 0, "a stage serves one consumer");
  static_assert(XF_STAGE % 16 == 0 && OWN % 128 == 0, "copies and wgmma tiles aligned");
};

struct WgParams {
  int n, nr, nb;  // components; live rows (n rounded up to 16); partials
  long long t;
  int need_ysq, vec;
  float a, m2a, mha;          // the density's constants, as in density.cuh
  const float* w;             // (n, n): M_old
  const float* dm;            // (n, n): M_new - M_old
  const float* x;             // (n, t) row-major
  float *ll, *dysq, *g, *pm, *ysq;  // partial b at + b * stride
  long long stride;
};

// Row rho of the 64-row tiles (the rotation's output, psi, Y, G's rows
// and columns) is row 8 w + g + 32 h of M_old and dM, for rho = 16 w + 8 h
// + g: warp w's fragments hold rows g and g + 8 of its sixteen, so rows
// below 32 lie in the first eight of every warp's, and at N <= 32 all four
// warps of a consumer share the density, each over its h = 0 values.
__device__ __forceinline__ int tile_row(int rho) {
  return 8 * (rho >> 4) + (rho & 7) + 32 * ((rho >> 3) & 1);
}

// Sub-tiles of partial `part`.
__device__ __forceinline__ int sub_tiles(const WgParams& p, int part) {
  const long long left = p.t - (long long)part * COLS;
  const int cols = left < COLS ? (int)left : COLS;
  return (cols + BT - 1) / BT;
}

// The producer's 128 threads copy columns [c0, c0 + cols) of X's rows
// below n into f32 stage `st` (row r at r * LDX), zero past cols: 16-byte
// copies where the rows are 16-byte aligned (vec), else 4-byte ones (a
// ragged T); then each thread's arrival on `bar` follows its copies.
__device__ __forceinline__ void issue_copies(const WgParams& p, float* st, uint64_t* bar,
                                             long long c0, int cols, int tid) {
  if (p.vec) {  // cols is a multiple of 4
    for (int u = tid; u < p.n * (BT / 4); u += 128) {
      const int r = u / (BT / 4), c = (u % (BT / 4)) * 4;
      const bool in = c < cols;
      cp_async16_zfill(st + r * LDX + c, in ? p.x + (long long)r * p.t + c0 + c : p.x, in);
    }
  } else {
    for (int u = tid; u < p.n * BT; u += 128) {
      const int r = u / BT, c = u % BT;
      const bool in = c < cols;
      cp_async4_zfill(st + r * LDX + c, in ? p.x + (long long)r * p.t + c0 + c : p.x, in);
    }
  }
  cp_async_mbar_arrive_noinc(bar);
}

// The split of one landed f32 stage `xf` into the P part tiles at `xp`
// (the rotation's B: BT columns x 16 k a step, K-major). Warp w takes
// columns 8 w .. 8 w + 7; lane l column 8 w + l % 8 and, of each 8-row
// core group, rows 2 (l / 8) and + 1 (the four row pairs 8 banks apart at
// LDX = 36). At F32, hi lies on the grid of the column's largest
// magnitude, which meets in two shuffles; at BF16X3 the split is
// elementwise.
template <int ROT>
__device__ __forceinline__ void split_stage(const WgParams& p, const float* xf, unsigned char* xp,
                                            int cols, int lane, int warp) {
  constexpr int P = parts(ROT);
  const int col = 8 * warp + (lane & 7), qq = lane >> 3;
  const bool col_in = col < cols;
  auto val = [&](int r) -> float { return col_in && r < p.n ? xf[r * LDX + col] : 0.f; };
  float sigma = 0.f;
  if constexpr (ROT == F32) {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) m = fmaxf(m, fabsf(val(8 * j + 2 * qq + e)));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
    sigma = grid_sigma(m);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = val(8 * j + 2 * qq), b = val(8 * j + 2 * qq + 1);
    uint32_t u[3];
    if constexpr (ROT == F32) {
      const float h0 = grid_round(a, sigma), h1 = grid_round(b, sigma);
      u[0] = pack_bf16(h0, h1);  // exact
      split_pair(a - h0, b - h1, u[1], u[2]);
    } else {
      split_pair(a, b, u[0], u[1]);
    }
    const int off = (j >> 1) * KROT + (col >> 3) * 256 + (j & 1) * 128 + (col & 7) * 16 + 4 * qq;
#pragma unroll
    for (int q = 0; q < P; ++q) *reinterpret_cast<uint32_t*>(xp + q * OP + off) = u[q];
  }
}

// d = A B (fresh) or d += A B, a 64 x 16 A: wgmma m64n32k16 for the
// rotation's 16-register accumulators, m64n64k16 for the contraction's 32.
template <int R>
__device__ __forceinline__ void mma(float (&d)[R], uint64_t a, uint64_t b, bool fresh) {
  if constexpr (R == 16)
    wgmma_m64n32k16(d, a, b, fresh);
  else
    wgmma_m64n64k16(d, a, b, fresh);
}

// One 16-deep step of a product at the tier, from P part descriptors of
// A (a[q]) and of B (b[q]). F32: mma_tier<F32>'s order, the five small
// products into `small`, then hi*hi into `hh` (the same array, with
// fresh_hh false, for one chain); BF16X3: hi*hi, lo*hi, hi*lo into `hh`.
// A fresh chain starts its accumulator at zero.
template <int ROT, int R>
__device__ __forceinline__ void step(float (&small)[R], float (&hh)[R], const uint64_t (&a)[3],
                                     const uint64_t (&b)[3], bool fresh_small, bool fresh_hh) {
  if constexpr (ROT == F32) {
    mma(small, a[2], b[0], fresh_small);
    mma(small, a[1], b[1], false);
    mma(small, a[0], b[2], false);
    mma(small, a[1], b[0], false);
    mma(small, a[0], b[1], false);
    mma(hh, a[0], b[0], fresh_hh);
  } else {
    mma(hh, a[0], b[0], fresh_hh);
    mma(hh, a[1], b[0], false);
    mma(hh, a[0], b[1], false);
  }
}

// The descriptors of P part tiles `stride` bytes apart from `base`, `o`
// bytes on (a k step).
__device__ __forceinline__ void descs(uint64_t (&d)[3], const unsigned char* base, int stride,
                                      int o) {
  const uint64_t d0 = core_desc(base + o);
#pragma unroll
  for (int q = 0; q < 3; ++q) d[q] = d0 + (uint64_t)(q * stride >> 4);
}

// The consumers' prologue (ct = 0 .. 128 NC - 1): M_old and dM split into
// their P bf16 planes at `w_s` (plane set * P + q; row rho of a plane is
// row tile_row(rho)), zeros outside [0, n)^2, as rotated_fused_tc.cu's
// split_weight splits them (at F32 hi on the grid of its row's largest
// magnitude, kept at `sig`).
template <int ROT>
__device__ __forceinline__ void split_weights(const WgParams& p, unsigned char* w_s, float* sig,
                                              int ct) {
  constexpr int P = parts(ROT);
  if constexpr (ROT == F32) {
    if (ct < 2 * NMAX) {
      const int i = ct % NMAX;
      const float* m = ct < NMAX ? p.w : p.dm;
      float mx = 0.f;
      if (i < p.n)
        for (int k = 0; k < p.n; ++k) mx = fmaxf(mx, fabsf(m[i * p.n + k]));
      sig[ct] = grid_sigma(mx);
    }
    bar_sync<128 * NC>(4);
  }
  for (int idx = ct; idx < 2 * NMAX * NMAX; idx += 128 * NC) {
    const int set = idx / (NMAX * NMAX), i = (idx / NMAX) % NMAX, k = idx % NMAX;
    const int row = tile_row(i);
    const bool in = row < p.n && k < p.n;
    const float v = in ? (set ? p.dm : p.w)[row * p.n + k] : 0.f;
    float r[3] = {};
    if constexpr (ROT == F32) {
      r[0] = grid_round(v, sig[set * NMAX + row]);
      r[1] = bf16_round(v - r[0]);
      r[2] = bf16_round(v - r[0] - r[1]);
    } else {
      const Sp sp = split<ROT>(v);
      r[0] = sp.hi;
      r[1] = sp.lo;
    }
    const int off = (k >> 4) * KCON + (i >> 3) * 256 + ((k >> 3) & 1) * 128 + (i & 7) * 16 +
                    (k & 7) * 2;
#pragma unroll
    for (int q = 0; q < P; ++q)
      *reinterpret_cast<__nv_bfloat16*>(w_s + (set * P + q) * WPLANE + off) =
          __float2bfloat16_rn(r[q]);
  }
  fence_async_shared();  // the planes, before wgmma reads them
  bar_sync<128 * NC>(4);
}

template <int R>
__device__ __forceinline__ void add_to(float (&d)[R], const float (&s)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] += s[i];
}

template <int ROT, int D>
__global__ void __launch_bounds__(THREADS, 1) rotated_fused_wgmma_kernel(WgParams p) {
  using C = Cfg<ROT>;
  constexpr int P = C::P, SF = C::SF;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* xempty = xfull + SF;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < SF; ++s) {
      mbar_init(&xfull[s], 128);  // each producer thread's copies
      mbar_init(&xempty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The block's partials are blockIdx.x, + gridDim.x, ...; their sub-tiles
  // are the block's items in column order, item i consumer i % NC's.
  if (tid < 128) {
    // ---- the producer: copies, item by item ----
    regs_dec<PRODUCER_REGS>();
    for (int part = blockIdx.x, i = 0; part < p.nb; part += gridDim.x) {
      const int n_sub = sub_tiles(p, part);
      for (int j = 0; j < n_sub; ++j, ++i) {
        const int f = i % SF;
        if (i >= SF) mbar_wait(&xempty[f], (i / SF - 1) & 1);  // its consumer has split it
        const long long c0 = (long long)part * COLS + (long long)j * BT;
        const long long left = p.t - c0;
        issue_copies(p, reinterpret_cast<float*>(smem + C::XF + f * C::XF_STAGE), &xfull[f], c0,
                     left < BT ? (int)left : BT, tid);
      }
    }
    cp_async_wait<0>();  // no copy outlives its thread
    return;
  }

  // ---- the consumer warpgroups: consumer c takes items c, c + NC, ... ----
  regs_inc<CONSUMER_REGS>();
  const int ct = tid - 128, c = ct >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  unsigned char* xo = smem + C::OWN + 2 * c * P * OP;  // X's parts, then Y's
  unsigned char* psi_s = xo + P * OP;
  split_weights<ROT>(p, smem, reinterpret_cast<float*>(smem + C::OWN + P * OP), ct);
  const int bar_id = 1 + c;
  const int k_steps = p.nr / 16;
  // Whether the thread's rows of h = 0 and of h = 1 (8 warp + g + 32 h)
  // reach a live one: the density skips the others.
  const bool rows_live[2] = {8 * warp < p.n, 8 * warp + 32 < p.n};
  // G: at BF16X3 in registers; at F32 in shared memory (gsm), beside the
  // group's sum in registers (grp).
  float gs[ROT == F32 ? 1 : 32] = {}, grp[32] = {};
  float* const gs_all = reinterpret_cast<float*>(smem + C::GS);
  float* const rs_all = reinterpret_cast<float*>(smem + C::RS);
  float* gsm = gs_all + c * NMAX * NMAX + ct % 128;
  if constexpr (ROT == F32)
    for (int e = 0; e < 32; ++e) gsm[e * 128] = 0.f;
  float rs[2][4] = {};  // tile rows g, g + 8: dll, pm, dysq, ysq

  for (int part = blockIdx.x, ib = 0; part < p.nb; part += gridDim.x) {
    const int n_sub = sub_tiles(p, part);
    const long long col_base = (long long)part * COLS;
    // Sub-tile j is item ib + j; this consumer's first is j0.
    const int j0 = ((c - ib) % NC + NC) % NC;
    for (int j = j0, own = 0; j < n_sub; j += NC, ++own) {
      const int i = ib + j, f = i % SF;
      const long long c0 = col_base + (long long)j * BT;
      const long long left = p.t - c0;
      const int cols = left < BT ? (int)left : BT;
      const float* xf = reinterpret_cast<const float*>(smem + C::XF + f * C::XF_STAGE);

      // X's parts, split from the landed f32 stage, which then goes back
      // to the producer.
      mbar_wait(&xfull[f], (i / SF) & 1);
      split_stage<ROT>(p, xf, xo, cols, lane, warp);
      fence_async_shared();   // the parts, before wgmma reads them
      bar_sync<128>(bar_id);  // the stage read and the parts written by all four warps
      if (ct % 128 == 0) mbar_arrive(&xempty[f]);

      // The rotation: Y_old = M_old X, dY = dM X over the live k steps.
      float y0[16], dy[16];
      if constexpr (ROT == F32) {
        // One set at a time (dY, then Y_old): its small products' chain
        // and its hi*hi chain over the k steps, then their sum. (Both sets
        // at once spilled at 160 registers and ran 0.2 ms slower at 64 x
        // 2M.)
        float sm[16];
#pragma unroll
        for (int set = 1; set >= 0; --set) {
          float(&yv)[16] = set ? dy : y0;
          wgmma_fence();
          for (int ks = 0; ks < k_steps; ++ks) {
            uint64_t a[3], b[3];
            descs(a, smem + set * P * WPLANE, WPLANE, ks * KCON);
            descs(b, xo, OP, ks * KROT);
            step<F32>(sm, yv, a, b, ks == 0, ks == 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sm);
          fence_regs(yv);
#pragma unroll
          for (int e = 0; e < 16; ++e) yv[e] = sm[e] + yv[e];  // the small products' sum, then hi*hi's
        }
      } else {
        float f0[16], f1[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) y0[e] = dy[e] = 0.f;
        for (int ks = 0; ks < k_steps; ++ks) {
          uint64_t a0[3], a1[3], b[3];
          descs(a0, smem, WPLANE, ks * KCON);
          descs(a1, smem + P * WPLANE, WPLANE, ks * KCON);
          descs(b, xo, OP, ks * KROT);
          wgmma_fence();
          step<BF16X3>(f0, f0, a0, b, true, true);
          wgmma_commit();
          step<BF16X3>(f1, f1, a1, b, true, true);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(f0);
          add_to(y0, f0);
          wgmma_wait<0>();
          fence_regs(f1);
          add_to(dy, f1);
        }
      }
      bar_sync<128>(bar_id);  // every warp's products read X's parts: Y may replace them

      // The density on the fragments (element 4 jj + 2 h + e at tile row
      // 16 warp + g + 8 h, column 8 jj + 2 q + e), the masked row sums,
      // and the bf16 parts of psi and Y, K-major along columns (the
      // contraction's two 16-column steps). Eight rows of a warp that all
      // lie past the live ones are skipped: their rows of psi and Y reach
      // only entries of G past N, which are not written.
#pragma unroll
      for (int jj = 0; jj < BT / 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rows_live[h]) {
            float yv[2], ps[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 4 * jj + 2 * h + e;
              float psi, psid, ll;
              score_der_loglik_delta<D>(p, y0[k], dy[k], psi, psid, ll);
              const float y = y0[k] + dy[k];
              if (8 * jj + 2 * q + e < cols) {
                rs[h][0] += ll;
                rs[h][1] += psid;
                rs[h][2] += (2.f * y0[k] + dy[k]) * dy[k];
                rs[h][3] += y * y;
              }
              yv[e] = y;    // 0 at padded columns
              ps[e] = psi;  // psi(0) == 0 there
            }
            uint32_t vy[P], vp[P];
            split_parts<ROT>(yv[0], yv[1], vy);
            split_parts<ROT>(ps[0], ps[1], vp);
            const int off =
                (jj >> 1) * KCON + (2 * warp + h) * 256 + (jj & 1) * 128 + g * 16 + 4 * q;
#pragma unroll
            for (int u = 0; u < P; ++u) {
              *reinterpret_cast<uint32_t*>(xo + u * OP + off) = vy[u];
              *reinterpret_cast<uint32_t*>(psi_s + u * OP + off) = vp[u];
            }
          }
        }
      }
      fence_async_shared();   // the tiles, before wgmma reads them
      bar_sync<128>(bar_id);  // the tiles complete

      // The contraction over the sub-tile's two 16-column steps: each
      // step's products in a fresh accumulator (f0, then f1), added in
      // order to the group's sum (F32) or to G (BF16X3).
      {
        float f0[32], f1[32];
        float(&dst)[32] = *reinterpret_cast<float(*)[32]>(ROT == F32 ? grp : gs);
        uint64_t a[3], b[3];
        // One chain a step: at F32 the small products start it and hi*hi
        // ends it.
        wgmma_fence();
        descs(a, psi_s, OP, 0);
        descs(b, xo, OP, 0);
        step<ROT>(f0, f0, a, b, true, ROT != F32);
        wgmma_commit();
        descs(a, psi_s, OP, KCON);
        descs(b, xo, OP, KCON);
        step<ROT>(f1, f1, a, b, true, ROT != F32);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(f0);
        add_to(dst, f0);
        wgmma_wait<0>();
        fence_regs(f1);
        add_to(dst, f1);
      }
      // At F32 a group is GROUP_SUBS of the consumer's own sub-tiles.
      if (ROT == F32 && own % GROUP_SUBS == GROUP_SUBS - 1) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          gsm[e * 128] += grp[e];
          grp[e] = 0.f;
        }
      }
      bar_sync<128>(bar_id);  // every warp's contraction read psi and Y
    }
    ib += n_sub;

    // The partial's end: each consumer's last group, G (BF16X3) and row
    // sums (over the quad's lanes) into shared memory; then the consumers'
    // sums added in their order, one writer an entry; then the
    // accumulators start again.
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if constexpr (ROT == F32)
        gsm[e * 128] += grp[e];  // + 0 where the group just ended
      else
        gsm[e * 128] = gs[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rs[h][k] += __shfl_xor_sync(0xffffffffu, rs[h][k], 1);
        rs[h][k] += __shfl_xor_sync(0xffffffffu, rs[h][k], 2);
        if (q == 0) rs_all[(4 * c + k) * NMAX + 8 * warp + g + 32 * h] = rs[h][k];
      }
    }
    bar_sync<128 * NC>(4);  // every consumer's sums stored
    const long long base = (long long)part * p.stride;
    for (int s = ct; s < NMAX * NMAX; s += 128 * NC) {
      const int e = s >> 7, t = s & 127;  // value e of consumer thread t
      const int row = tile_row(16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((e >> 1) & 1));
      const int col = tile_row(8 * (e >> 2) + 2 * (t & 3) + (e & 1));
      if (row < p.n && col < p.n) {
        float v = gs_all[s];
#pragma unroll
        for (int cc = 1; cc < NC; ++cc) v += gs_all[cc * NMAX * NMAX + s];
        p.g[base + row * p.n + col] = v;
      }
    }
    if (ct < 4 * NMAX) {
      const int k = ct / NMAX, row = ct % NMAX;
      float* out = k == 0 ? p.ll : k == 1 ? p.pm : k == 2 ? p.dysq : p.ysq;
      if (row < p.n && (k < 2 || p.need_ysq)) {
        float v = rs_all[k * NMAX + row];
#pragma unroll
        for (int cc = 1; cc < NC; ++cc) v += rs_all[(4 * cc + k) * NMAX + row];
        out[base + row] = v;
      }
    }
    bar_sync<128 * NC>(4);  // every consumer's sums read
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      grp[e] = 0.f;
      if constexpr (ROT == F32)
        gsm[e * 128] = 0.f;
      else
        gs[e] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k) rs[h][k] = 0.f;
  }
}

template <int ROT>
cudaError_t launch_wgmma(int dens, const WgParams& p, cudaStream_t st) {
  constexpr int smem = Cfg<ROT>::BYTES;
  // One block an SM, each taking partials a grid apart.
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.nb < sms ? p.nb : sms);
  auto go = [&](auto kernel) {
    // Above 48 KB dynamic shared memory must be opted into; a refused
    // launch never runs and only cudaGetLastError reports it.
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, THREADS, smem, st>>>(p);
    return cudaGetLastError();
  };
  switch (dens) {
    case TANH: return go(rotated_fused_wgmma_kernel<ROT, TANH>);
    case EXP: return go(rotated_fused_wgmma_kernel<ROT, EXP>);
    case CUBE: return go(rotated_fused_wgmma_kernel<ROT, CUBE>);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Whether kernel 1's pair (delta, rotation tier, contraction tier, bf16 X,
// H) runs picard_rotated_fused_wgmma (1) or picard_rotated_fused_sums (0).
int picard_core_wgmma_pair(int delta, int rot_tier, int ct_tier, int x_bf16, int need_h) {
  return core_wgmma_pair(delta, rot_tier, ct_tier, x_bf16, need_h) ? 1 : 0;
}

// One line-search try of a core_wgmma_pair, with
// picard_rotated_fused_sums' arguments: delta mode without H, rotation
// and contraction at one tier (F32 or BF16X3) on f32 X, w = M_old and dm
// = M_new - M_old (n, n) f32. Partial b (of nb = ceil(t / 2048)) at out +
// b * stride; dysq and ysq only with need_ysq. Any other pair is refused.
int picard_rotated_fused_wgmma(int delta, int rot_tier, int ct_tier, int density, int need_h,
                               int need_ysq, double alpha, int n, long long t, int x_bf16,
                               const float* w, const float* dm, const void* x, float* dll,
                               float* dysq, float* g, float* pm, float* h, float* ysq,
                               long long stride, int nb, void* stream) {
  (void)h;
  if (!core_wgmma_pair(delta, rot_tier, ct_tier, x_bf16, need_h) || n < 1 || n > NMAX ||
      t < 1 || stride < 1 || (long long)nb != (t + COLS - 1) / COLS)
    return (int)cudaErrorInvalidValue;
  WgParams p = {};
  p.n = n;
  p.nr = (n + 15) / 16 * 16;
  p.nb = nb;
  p.t = t;
  p.need_ysq = need_ysq;
  p.vec = t % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  p.a = (float)alpha;
  p.m2a = (float)(-2.0 * alpha);
  p.mha = (float)(-alpha / 2.0);
  p.w = w;
  p.dm = dm;
  p.x = static_cast<const float*>(x);
  p.ll = dll;
  p.dysq = dysq;
  p.g = g;
  p.pm = pm;
  p.ysq = ysq;
  p.stride = stride;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(rot_tier == F32 ? launch_wgmma<F32>(density, p, st)
                               : launch_wgmma<BF16X3>(density, p, st));
}

}  // extern "C"
