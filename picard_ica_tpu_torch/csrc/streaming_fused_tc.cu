// Hand-written Hopper (sm_90a) kernels for picard_streaming_fused_sums at
// N > 64, in all ten of its (mode, rotation tier, contraction tier, X
// dtype) pairs, and for picard_streaming_loglik_tc. They replace
// picard_ica_tpu/ops/pallas_kernels.py streaming_fused_sums /
// _streaming_fused_kernel and streaming_loglik_sums /
// _streaming_loglik_kernel. The pairs (ROT, CT: the tiers of the rotation
// and of the contraction; on bf16 X the rotation runs at the bf16 tier,
// the weights rounded to bf16 by the caller, as in the TPU kernel):
//   * plain, ROT = CT = BF16, bf16 X: the default staged schedule's first
//     stage, and the moments hand-off on its X (rotate_plain_wgmma_kernel);
//   * delta, ROT = CT = BF16X3, f32 X: the second stage;
//   * delta, ROT = CT = F32, f32 X: the last stage, and every try of a
//     kernel_precision="f32" fit;
//   * plain, ROT = CT = F32, f32 X: the moments at the f32 stage boundary
//     and at an f32 fit's start;
//   * delta, ROT = CT = BF16, f32 X: every try of a fit pinned to
//     kernel_precision="bf16"; plain at the same tiers on f32 X, and plain
//     at BF16X3 on f32 X, are direct calls;
//   * delta, ROT = CT = BF16, bf16 X (also an f32 request on bf16 X), and
//     delta and plain with ROT = BF16, CT = BF16X3 on bf16 X: direct calls.
// Launch A of plain bf16 on bf16 X is rotate_plain_wgmma_kernel, of delta
// bf16x3 and delta f32 on f32 X rotate_wgmma_kernel<ROT> (the three on
// wgmma), of every other pair rotate_split_kernel<MODE, ROT, CT, XB>.
// The two wgmma kernels' log-lik modes, with no workspace, are
// picard_streaming_loglik_tc on bf16 X and on f32 X (below).
//
// What they compute, with f32 sums of exact bf16 products:
//   * the rotation at ROT: BF16, one product of bf16(W) and bf16(X)
//     (rounded as X is staged); BF16X3, X split once into hi / lo bf16
//     (hi = bf16(v), lo = bf16(v - hi)) and W passed split, the three
//     products hi*hi + lo*hi + hi*lo; F32, the TPU's HIGHEST, every
//     operand split three ways (hi = bf16(v), mid = bf16(v - hi), lo =
//     bf16(v - hi - mid), elementwise) and the six bf16 products whose
//     terms are at least 2^-16 of hi*hi (mma_tiers.cuh mma_tier<F32>).
//   * plain mode: Y = M_new X; the row sums dll = sum log_lik(Y), pm = sum
//     psi'(Y) (both masked at columns >= T) and, with need_ysq, ysq = dysq
//     = sum Y^2.
//   * delta mode: Y_old = M_old X and dY = (M_new - M_old) X from the one
//     staged X, Y = Y_old + dY in f32; the row sums of the delta density,
//     dll, pm (masked at columns >= T) and, with need_ysq, dysq = sum (2
//     Y_old + dY) dY and ysq = sum Y^2.
//   * the contraction at CT: G = psi(Y) Y^T and, with need_h, H = psi'(Y)
//     (Y^2)^T, psi and psi' those of the f32 Y; BF16 rounds psi and Y
//     (psi', Y^2) to bf16, BF16X3 takes their hi / lo splits, F32 their
//     three-way splits. The TPU kernel keeps Y in f32 and rounds only
//     inside its contraction, so storing the rounded or split planes
//     computes the same function.
//   * loglik (picard_streaming_loglik_tc): Y = M X as plain bf16's
//     rotation on bf16 X (M rounded to bf16) or plain f32's on f32 X, and
//     only the row sums ll = sum log_lik(Y), masked at columns >= T, and,
//     with need_ysq, ysq = sum Y^2.
//
// What bounds them on the card: bf16 FMAs on the tensor cores, N^2 T a
// product: 2 N^2 T plain bf16 (3 with H), 9 N^2 T delta bf16x3 (12 with
// H), 18 N^2 T delta f32 (24 with H), 12 N^2 T plain f32 (18 with H), 3
// N^2 T delta bf16 on either X (4 with H), 6 N^2 T plain bf16x3 on f32 X
// (9), 5 and 4 N^2 T delta and plain bf16x3 on bf16 X (8 and 7), loglik
// N^2 T on bf16 X and 6 N^2 T on f32 X; at 256 x 2M 0.53, 2.39, 4.77,
// 3.18, 0.80, 1.59, 1.33, 1.06, 0.27 and 1.59 ms of the tensor cores'
// 494.5 T FMA/s, against X's bytes read once (bf16 1 GB, 0.31 ms; f32 2
// GB, 0.61 ms); beside them N T density evaluations on the FP32 pipes and
// the SFU.
//
// What the design does about it: two GEMM-shaped launches, so that the
// products run on the tensor cores and the density runs once per
// element. Launch A of the three wgmma pairs is warp specialised
// (below); of the others a plain tile loop on mma.sync m16n8k16
// (mma_tiers.cuh) fed by a cp.async ring, two blocks of 8 warps an SM,
// so one block's density or stores overlap another's products. Launch B
// runs on wgmma in every pair (below). Every launch A writes psi and Y
// (with H also psi' and Y^2) to a workspace of (n_pad, ws_cols) planes
// at the contraction's tier, exact zeros at padded rows and columns, so
// launch B needs no mask and psi'(0) != 0 never reaches H; each (group,
// row) partial of the row sums is written once, with no atomics.
//   * Launch A, plain bf16 on bf16 X (rotate_plain_wgmma_kernel; the
//     staged fit's bf16 stage). Its bound at 256 x 2M: X's 1.02 GB read
//     and the psi and Y planes' 2.05 GB written (0.92 ms of HBM), N^2 T
//     bf16 products (0.27 ms of the tensor cores), and beside them the
//     plain density on 5.1e8 elements (tanh: an exp, two IEEE divisions
//     and a log1p, ~70 instructions with its masks, sums and packs, ~1.2
//     ms of the SMs' issue). What held the mma.sync kernel it replaces
//     (an mma.sync tile loop, 4.1 ms of launch A there, PERF.md §6): W
//     streamed again for every 64-column tile, every
//     thread copying between two block barriers a stage, the density and
//     the stores in the warps of the products, 4-byte stores of half
//     sectors. The design: one block of a producer and three consumer
//     warpgroups an SM; X's 64-column x 64-row boxes land by tensor map
//     in the 128-byte swizzle and are wgmma's B operand as they are,
//     MN-major (the transpose bit for B); W stays in shared memory for the
//     block's life up to N = 384, else streams beside X in boxes of 128
//     rows x 64 k; the consumers take alternate 64-column tiles, so one's
//     density runs while another's products do; the density is one rolled
//     copy over values parked in shared memory; psi and Y go out by
//     tensor-map stores of whole 128-byte rows. Each 16-deep k step starts a fresh
//     wgmma sum, added to the tile's f32 Y to nearest: a chain of wgmmas
//     over all of k rounds toward zero (PERF.md §6).
//   * Launch A, delta f32 and delta bf16x3 on f32 X (rotate_wgmma_kernel<F32 /
//     BF16X3>; the pairs of the f32 fit's and the staged fit's last two
//     stages): launch A of streaming_fused_sums in delta mode, built on
//     Hopper's own instructions. Its bound at 256 x 2M: 12 N^2 T bf16
//     products at F32 and 6 N^2 T at BF16X3 (3.18 and 1.59 ms on the
//     tensor cores), X's 2 GB read once (0.61 ms), the workspace's 4.1 GB
//     written once (1.22 ms). What held the mma.sync kernel that ran these
//     pairs before (rotate_split_kernel, PERF.md §6 PR 20): W's planes
//     streamed again through the ring for every 64-column tile (six bf16
//     planes at F32: 24.6 KB of W for each 4 KB of X), every thread
//     copying and splitting between two block barriers a 16-deep step,
//     one stage in flight, spills at two accumulator sets. The design:
//     one block of 384 threads an SM and a 128 x 128 tile (twice the
//     columns per byte of W). Warpgroup 0 produces: one thread keeps a
//     ring of 16-deep stages in flight with bulk copies (cp.async.bulk,
//     completing on the stage's mbarrier): W's parts in one copy, the
//     caller having laid them out as the kernel reads them
//     (ops/kernels.py _wgmma_weights), and X's 16 f32 rows of the tile,
//     each as the 16-byte aligned span around it (at a ragged t, as the
//     MEG's 1,000,003, up to 3 columns of the rows beside it at each
//     end); three warps split each landed f32 stage once into its bf16
//     part tiles (hi / mid / lo at F32, hi / lo at BF16X3) in wgmma's
//     K-major layout, zero past n and t. Warpgroups 1 and 2
//     consume, 64 W rows each: per step and set (Y_old, dY) a chain of
//     wgmma.mma_async m64n128k16 with both operands in shared memory,
//     six products at F32 (mma_tier<F32>'s order, small first, hi*hi
//     last) and three at BF16X3, starts in a fresh accumulator (scale-d =
//     0) and is added to the set's f32 sum, to nearest, as the mma.sync
//     kernels' fresh sums; the two warpgroups' chains interleave on the
//     tensor cores, so one adds while the other's chain runs. Each stage
//     goes back to the producer through a second mbarrier; no block
//     barrier is passed in the loop. setmaxnreg gives the consumers 232
//     registers (Y_old, dY and the fresh sum are 192 a thread) and the
//     producer 40. The density, the row sums (f64 in shared memory, once
//     a tile) and the workspace stores follow each tile in the consumers:
//     a quarter of the tile at a time is parked in shared memory and run
//     through one rolled copy of the density's code (fully unrolled, the
//     tanh epilogue took 12 ms); f32 planes go out as 8-byte column pairs,
//     whole 32-byte sectors; bf16x3's hi / lo planes are staged through
//     shared memory into 16-byte stores, two lanes a sector (4-byte stores
//     of half sectors cost 2 ms). What holds it now (PERF.md §6 PR 20):
//     not the copies (dropping W's or X's bytes saves nothing), but each
//     chain's wait and f32 add, the split, and the density, which runs in
//     both consumers at once and so is not hidden behind products.
//   * Launch A, the split pairs (rotate_split_kernel<MODE, ROT, CT, XB>:
//     plain f32, delta and plain bf16 and plain bf16x3 on f32 X, the bf16
//     X pairs but plain bf16): a tile loop on mma.sync (one block owns a
//     TILE-row block of W and one group of columns, walked in A_BT-column
//     tiles, k in KC-deep stages of a cp.async ring) with SETS
//     accumulator sets a warp (two in delta mode, Y_old and dY). The caller
//     passes each weight matrix split into its P zero-padded bf16 planes;
//     each landed KC-row f32 X stage is split once, all threads together,
//     into P bf16 part tiles in shared memory that every warp reads with
//     ldmatrix.trans (a landed bf16 tile, XB, is read as it is). The
//     tensor cores round each MMA's sum toward zero, and the rotation's K
//     runs up to 1344 deep, so each 16-deep k step is summed in a fresh
//     accumulator (P (P + 1) / 2 MMAs) and added to its set in f32, to
//     nearest. The ring holds two KC = 32-deep stages; the row sums go to
//     shared memory once per tile, in f64. Plain f32 takes M_new's three
//     planes, not delta mode with M_old = 0, which would double the
//     products and give the delta density's dll, and the plain
//     score_der_loglik. The workspace follows CT: one bf16 plane an
//     operand (as plain bf16's), hi / lo at BF16X3, f32 at F32.
//   * Loglik (picard_streaming_loglik_tc, kernel 9): the rotation alone,
//     with a log-lik epilogue, no workspace and no launch B, in the log-lik
//     mode of a wgmma launch A: on bf16 X rotate_plain_wgmma_kernel
//     (LOGLIK), on f32 X rotate_wgmma_kernel<F32, MODE_LOGLIK> (one
//     accumulator set, Y = M X; not delta mode with M_old = 0, which would
//     double the products and give the delta density's dll). Their bound at
//     256 x 2M: on bf16 X X's 1.02 GB read (0.31 ms of HBM) beside N^2 T
//     bf16 products (0.27 ms); on f32 X the six products of N^2 T (1.59 ms
//     of the tensor cores) beside X's 2 GB (0.61 ms); and beside either
//     the log-lik on 5.1e8 elements (tanh: an exp, a log1p and an IEEE
//     division, ~50 instructions, ~0.9 ms of the SMs' issue). What held the
//     kernels they replace (PERF.md §6): on bf16 X an mma.sync tile loop
//     that streamed W again for every 64-column tile, every thread copying
//     between two block barriers, the density in the warps of the
//     products; on f32 X the split launch A, which read W's three planes
//     again for every 64-column tile (24.6 KB of W for each 4 KB of X) and
//     split X between two block barriers with one stage in flight. The
//     epilogue parks Y, runs log_lik over it, masks columns >= t and drops
//     rows >= n (log_lik(0) != 0), and sums ll and Y^2 per row: f32 over a
//     tile, f64 across the tiles (and consumers) of the group, rounded
//     once into the group's one partial. On f32 X the log-lik mode lands
//     X's 16 x 128 stage by one tensor-map copy where its rows are 16-byte
//     aligned, and splits it in seven warps of two producer warpgroups:
//     sixteen row copies and three splitting warps each held the pipeline
//     below the products' pace (PERF.md §6). What holds the two kernels
//     now (same place): on bf16 X the tanh density's issue beside the
//     fresh-sum adds, which do not overlap; on f32 X the products' chain
//     waits with the epilogue in lockstep, and at a ragged t the row-span
//     copies. The groups (ops/kernels.py STREAM_TC_LOGLIK_COLS) are 1,536
//     columns: with only (N,) partials, a group's width sets nothing but
//     the number of blocks and the work of each, and 1,536 columns give
//     each of the bf16 X kernel's three consumers 8 of its 64-column
//     tiles.
//   * Launch B (contract_wgmma_kernel<CT>, every pair): G = psi Y^T (H =
//     psi' (Y^2)^T) as a plain NT GEMM whose K is the group's columns,
//     built on Hopper's own instructions. One block per TILE x TILE output
//     tile and group (a group's edge^2 blocks launch side by side, so its
//     rows come from HBM about once and from L2 to the others), one block
//     an SM: a producer warpgroup (two at F32) and two consumer
//     warpgroups of 64 rows x 128 columns each. The producer's thread 0
//     keeps a ring of stages in flight with tensor-map copies (the
//     workspace's planes as one 3-D map, 128-row boxes of 128-byte rows in
//     the 128-byte swizzle, completing on the stage's mbarrier): at BF16
//     and BF16X3 the bf16 part planes, which wgmma reads as they land; at
//     F32 the f32 planes, which the producers' eight warps split once into
//     hi / mid / lo part tiles (no-swizzle K-major). The consumers run
//     wgmma.mma_async m64n128k16 with both operands in shared memory. Each
//     FRESH columns are one chain in a fresh accumulator (scale-d = 0; two
//     k blocks at BF16, three products at BF16X3, six at F32 in mma_tier's
//     order, hi*hi last), added to the tile's f32 sum, to nearest; two
//     chains are in flight a consumer, each retired in the loop iteration
//     that issued it (a wait across iterations made ptxas serialize the
//     wgmmas). Its bound at 256 x 2M: the planes' bytes read once (2.05 GB
//     at BF16, 4.10 GB at BF16X3 and F32: 0.61 and 1.22 ms of HBM) and
//     1, 3 and 6 bf16 products of N^2 a column (0.27, 0.80 and 1.59 ms of
//     the tensor cores). What holds it (PERF.md §6 PR 23): at BF16 and
//     BF16X3 the copies (each row tile read from L2 by edge blocks); at F32
//     the split and the wgmma operand reads, which share the SM's shared
//     memory (256 KB a 32-column stage), and no longer overlap.
//   * Both launches cut T into the same n_parts groups, so the caller's
//     packed partial buffer and its one fold launch (ops/kernels.py
//     _fold_outputs) are those of the resident kernels. Where the workspace
//     for all of T would pass the caller's cap, the C entry runs A then B
//     per chunk of `groups_per_chunk` whole groups.
//
// Every C entry returns cudaGetLastError() (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "density.cuh"
#include "hopper_async.cuh"
#include "mma_tiers.cuh"

namespace {

// The port's declared capacity in components (ops/kernels.py
// STREAM_MAX_N). W streams through both launches in row blocks and k
// stages, so no buffer of either launch grows with N.
constexpr int STREAM_MAX_N = 1344;

constexpr int TILE = 128;          // W rows of a block of A; B's output tile edge
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NI = 4;              // a warp's 32 columns: 4 n-tiles
constexpr int MAX_GRID_Y = 65535;

// Split launch A's tile: TILE rows x A_BT columns over A_WR x A_WC warps,
// each 16 A_MI rows x 32 columns. W's planes are zero-padded along k to a
// multiple of A_KC (the caller's kp).
constexpr int A_BT = 64;
constexpr int A_KC = 64;
constexpr int A_WC = A_BT / 32;
constexpr int A_WR = WARPS / A_WC;
constexpr int A_MI = TILE / A_WR / 16;
constexpr int LDN = A_BT + 8;      // row stride of the [k][column] bf16 X stage tile
static_assert(TILE % A_BT == 0 && A_WR * A_WC == WARPS, "launch A's warp layout");
constexpr int BLOCKS = 2;                // blocks an SM of the split launch A
constexpr int SM_SMEM = 233472;          // shared memory of an SM for its blocks
constexpr int BLOCK_RESERVED = 1024;     // kept by the system per block

// The parts of rotate_wgmma_kernel and rotate_plain_wgmma_kernel that a
// timing build switches off, one bit each, to split their time (port_turns.py --parts adds
// -DPICARD_A_SKIP=bits to its own builds' flags): 1 the products, 2 the
// density (Y itself stands in for psi, psi' and the log-lik terms), 4 the
// workspace stores. The port's build sets none: the outputs are wrong
// with any bit set.
#ifndef PICARD_A_SKIP
#define PICARD_A_SKIP 0
#endif
constexpr int SKIP_PRODUCTS = PICARD_A_SKIP & 1, SKIP_DENSITY = PICARD_A_SKIP & 2,
              SKIP_STORES = PICARD_A_SKIP & 4;

// What launch A computes from Y: the plain mode's density, row sums and
// workspace (rotate_split_kernel; rotate_plain_wgmma_kernel on bf16 X);
// the delta mode's (two accumulator sets, Y_old and dY); or the log-lik
// row sums alone (kernel 9, no workspace: rotate_wgmma_kernel on f32 X,
// rotate_plain_wgmma_kernel's LOGLIK on bf16 X).
enum AMode { MODE_PLAIN = 0, MODE_DELTA = 1, MODE_LOGLIK = 2 };

// Split launch A (rotate_split_kernel) at rotation tier ROT with SETS
// accumulator sets (2 in delta mode, else 1), on f32 X or, with XB, bf16
// X: the same tile and warps; k in KC-deep stages of a D_STAGES ring. A
// stage holds the SETS P W planes (M_old's parts, then dM's; or M's:
// [row][k] each) and the X tile ([k][column]: f32, or bf16 at stride LDN
// with XB); each landed f32 X tile is split into P bf16 [k][column] part
// tiles (stride LDN), a landed bf16 one is read as it is. Then the row
// sums (4 sums x A_WC warps x TILE rows) in f64, added to once a tile, so
// the group's sums carry no error of their order. Every pair's layout
// stays under the 115,712 bytes a block may take at two blocks an SM.
constexpr int D_STAGES = 2;
constexpr int LDX = A_BT;  // row stride (floats) of the f32 X stage tile
template <int ROT, int SETS, bool XB>
struct DCfg {
  static constexpr int P = parts(ROT);
  static constexpr int KC = 32;
  static constexpr int LDK = KC + 8;
  static constexpr int W_PLANE = TILE * LDK;             // elements
  static constexpr int W_BYTES = SETS * P * W_PLANE * 2;
  static constexpr int STAGE = W_BYTES + (XB ? KC * LDN * 2 : KC * LDX * 4);  // bytes
  static constexpr int SPLIT = D_STAGES * STAGE;
  static constexpr int RED = SPLIT + (XB ? 0 : P * KC * LDN * 2);
  static constexpr int BYTES = RED + 4 * A_WC * TILE * 8;
  static_assert(!XB || ROT == BF16, "bf16 X rotates at the bf16 tier");
  static_assert(STAGE % 16 == 0 && W_BYTES % 16 == 0 && RED % 8 == 0, "aligned stages");
  static_assert(KC % 16 == 0, "stage depth");
  static_assert(BLOCKS * (BYTES + BLOCK_RESERVED) <= SM_SMEM, "two blocks fit an SM");
};

struct DParams {
  // rotate_wgmma_kernel's log-lik mode: f32 X as a tensor map of boxes of
  // G_BN columns x G_KS rows, where xtm (vec X); else X's rows by bulk
  // copies of their spans
  CUtensorMap xmap;
  int xtm;
  int n, kp, n_kc;  // components; k extent of the padded W; KC-deep stages of k
  long long t;
  int need_ysq, vec;
  float a, m2a, mha;
  // SETS P (n_pad, kp) bf16 planes: M_old's parts, then dM's (one at
  // bf16; hi, lo at bf16x3; hi, mid, lo at f32); in plain and log-lik mode
  // M's (in _wgmma_weights' layout for rotate_wgmma_kernel)
  const __nv_bfloat16* w;
  long long w_plane;  // n_pad * kp
  const void* x;      // (n, t) f32, or bf16 with XB, row-major
  // workspace, (n_pad, ws_cols) each, by the contraction's tier: at bf16
  // the bf16 planes psi, Y (with H psi', Y^2); at bf16x3 psi hi, lo, Y
  // hi, lo (with H psi' hi, lo, Y^2 hi, lo); at f32 the f32 planes psi, Y
  // (with H psi', Y^2)
  __nv_bfloat16* ws[8];
  float* wsf[4];
  long long ws_cols;
  int cols, g0;
  float *ll, *dysq, *pm, *ysq;
  long long stride;
};

struct BParams {
  // The chunk's workspace planes as one tensor map (element, row, plane:
  // Workspace::b_params), read by contract_wgmma_kernel's copies.
  CUtensorMap tm;
  float* out[2];  // G, H
  int n, edge;    // components; output tiles along a side (n_pad / TILE)
  int cols, g0;
  long long stride;
};

// Start split launch A's copies for ring step `it` (tile it / n_kc,
// k-stage it % n_kc) into stage `st`; the caller commits.
template <int ROT, int SETS, bool XB>
__device__ __forceinline__ void load_d(const DParams& p, unsigned char* st, int it,
                                       long long col0) {
  using C = DCfg<ROT, SETS, XB>;
  constexpr int KC = C::KC;
  const int tid = threadIdx.x;
  const int tile = it / p.n_kc, k0 = (it % p.n_kc) * KC;
  // W: SETS P planes x TILE rows x KC in 16-byte pieces, always in bounds.
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(st);
  const __nv_bfloat16* w = p.w + (long long)blockIdx.x * TILE * p.kp + k0;
  for (int u = tid; u < SETS * C::P * TILE * (KC / 8); u += THREADS) {
    const int m = u / (TILE * (KC / 8)), v = u % (TILE * (KC / 8));
    const int r = v / (KC / 8), c = (v % (KC / 8)) * 8;
    cp_async16_zfill(ws + m * C::W_PLANE + r * C::LDK + c,
                     w + m * p.w_plane + (long long)r * p.kp + c, true);
  }
  const long long c0 = col0 + (long long)tile * A_BT;
  if constexpr (XB) {
    // X: KC rows x A_BT bf16 columns, zero past n and t.
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + C::W_BYTES);
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    if (p.vec) {  // t % 8 == 0: an 8-column piece is all in or all out
      for (int u = tid; u < KC * (A_BT / 8); u += THREADS) {
        const int kr = u / (A_BT / 8), c = (u % (A_BT / 8)) * 8;
        const bool in = k0 + kr < p.n && c0 + c < p.t;
        cp_async16_zfill(xs + kr * LDN + c, in ? x + (long long)(k0 + kr) * p.t + c0 + c : x,
                         in);
      }
    } else {  // rows not 16-byte aligned: plain loads
      for (int u = tid; u < KC * A_BT; u += THREADS) {
        const int kr = u / A_BT, c = u % A_BT;
        const bool in = k0 + kr < p.n && c0 + c < p.t;
        xs[kr * LDN + c] = in ? x[(long long)(k0 + kr) * p.t + c0 + c] : __float2bfloat16_rn(0.f);
      }
    }
    return;
  }
  // X: KC rows x A_BT f32 columns, zero past n and t.
  float* xs = reinterpret_cast<float*>(st + C::W_BYTES);
  const float* x = static_cast<const float*>(p.x);
  if (p.vec) {  // t % 4 == 0: a 4-column piece is all in or all out
    for (int u = tid; u < KC * (A_BT / 4); u += THREADS) {
      const int kr = u / (A_BT / 4), c = (u % (A_BT / 4)) * 4;
      const bool in = k0 + kr < p.n && c0 + c < p.t;
      cp_async16_zfill(xs + kr * LDX + c, in ? x + (long long)(k0 + kr) * p.t + c0 + c : x, in);
    }
  } else {  // rows not 16-byte aligned: 4-byte copies
    for (int u = tid; u < KC * A_BT; u += THREADS) {
      const int kr = u / A_BT, c = u % A_BT;
      const bool in = k0 + kr < p.n && c0 + c < p.t;
      cp_async4_zfill(xs + kr * LDX + c, in ? x + (long long)(k0 + kr) * p.t + c0 + c : x, in);
    }
  }
}

// Launch A with the rotation at tier ROT (on bf16 X, XB, the bf16 tier),
// in MODE: delta (two accumulator sets) or plain (one); the workspace
// planes of the contraction's tier CT. Warp w owns rows 16 A_MI (w / A_WC)
// .. and columns 32 (w % A_WC) .. + 31 of the block's TILE x A_BT tile.
template <int MODE, int ROT, int CT, bool XB, int D, bool NEED_H>
__global__ void __launch_bounds__(THREADS, BLOCKS) rotate_split_kernel(DParams p) {
  constexpr int SETS = MODE == MODE_DELTA ? 2 : 1;
  using C = DCfg<ROT, SETS, XB>;
  constexpr int P = C::P, KC = C::KC;
  static_assert(MODE == MODE_DELTA || MODE == MODE_PLAIN, "the split launch's modes");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xsplit = reinterpret_cast<__nv_bfloat16*>(smem + C::SPLIT);  // P part tiles
  double* red = reinterpret_cast<double*>(smem + C::RED);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / A_WC, wc = warp % A_WC;
  const int row0 = blockIdx.x * TILE;
  const int grp = p.g0 + blockIdx.y;
  const long long col0 = (long long)grp * p.cols;
  const long long ws0 = (long long)blockIdx.y * p.cols;
  const int n_kc = p.n_kc;
  const int total = (p.cols / A_BT) * n_kc;

  for (int u = tid; u < 4 * A_WC * TILE; u += THREADS) red[u] = 0.0;
#pragma unroll
  for (int i = 0; i < D_STAGES - 1; ++i) {
    if (i < total) load_d<ROT, SETS, XB>(p, smem + i * C::STAGE, i, col0);
    cp_async_commit_group();
  }

  float acc[SETS][A_MI][NI][4] = {};  // Y_old, dY in delta mode; else Y

  for (int it = 0; it < total; ++it) {
    cp_async_wait<D_STAGES - 2>();
    __syncthreads();  // step it landed everywhere; the split tiles and stage (it - 1) are free
    const int ahead = it + D_STAGES - 1;
    if (ahead < total)
      load_d<ROT, SETS, XB>(p, smem + (ahead % D_STAGES) * C::STAGE, ahead, col0);
    cp_async_commit_group();

    const unsigned char* st = smem + (it % D_STAGES) * C::STAGE;
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(st);
    // The X parts the products read: a landed bf16 tile as it is, or the
    // landed f32 tile's split into its parts, once for every warp.
    const __nv_bfloat16* xparts = xsplit;
    if constexpr (XB) {
      xparts = reinterpret_cast<const __nv_bfloat16*>(st + C::W_BYTES);
    } else {
      const float* xs = reinterpret_cast<const float*>(st + C::W_BYTES);
      for (int u = tid; u < KC * (A_BT / 2); u += THREADS) {
        const int kr = u / (A_BT / 2), c = 2 * (u % (A_BT / 2));
        const float2 v = *reinterpret_cast<const float2*>(xs + kr * LDX + c);
        uint32_t parts_of[P];
        split_parts<ROT>(v.x, v.y, parts_of);
#pragma unroll
        for (int part = 0; part < P; ++part)
          *reinterpret_cast<uint32_t*>(xsplit + part * KC * LDN + kr * LDN + c) = parts_of[part];
      }
      __syncthreads();
    }

#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t b[NI][P][2];  // [n-tile][part][b0 / b1]
#pragma unroll
      for (int part = 0; part < P; ++part) {
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ldm_a_addr(xparts + part * KC * LDN + 16 * ks * LDN + 32 * wc +
                                              16 * np,
                                          LDN, lane));
          b[2 * np][part][0] = r[0], b[2 * np][part][1] = r[1];
          b[2 * np + 1][part][0] = r[2], b[2 * np + 1][part][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < A_MI; ++mi) {
#pragma unroll
        for (int set = 0; set < SETS; ++set) {
          uint32_t a[P][4];
#pragma unroll
          for (int part = 0; part < P; ++part)
            ldmatrix_x4(a[part], ldm_a_addr(ws + (P * set + part) * C::W_PLANE +
                                                (16 * A_MI * wr + 16 * mi) * C::LDK + 16 * ks,
                                            C::LDK, lane));
          // The k step's three (six) products in a fresh accumulator, added
          // to nearest.
          float t4[NI][4] = {};
#pragma unroll
          for (int nt = 0; nt < NI; ++nt) mma_tier<ROT>(t4[nt], t4[nt], a, b[nt]);
#pragma unroll
          for (int nt = 0; nt < NI; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[set][mi][nt][e] += t4[nt][e];
        }
      }
    }
    if (it % n_kc != n_kc - 1) continue;

    // The tile is done: the density on the fragments, the row sums into
    // shared memory, and the workspace planes (stores
    // of column pairs: 4-byte bf16 pairs at bf16, 4-byte hi / lo pairs at
    // bf16x3, 8-byte f32 pairs at f32).
    const int tile = it / n_kc;
    const long long c0 = col0 + (long long)tile * A_BT;
    const long long wcol = ws0 + (long long)tile * A_BT;
#pragma unroll
    for (int mi = 0; mi < A_MI; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = 16 * A_MI * wr + 16 * mi + g + 8 * hh;
        const int row = row0 + rl;
        float sums[4] = {};  // dll (plain: ll), pm, dysq, ysq
#pragma unroll
        for (int nt = 0; nt < NI; ++nt) {
          const int cl = 32 * wc + 8 * nt + 2 * q;
          float yv[2], ps[2], pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (MODE == MODE_DELTA) {
              const float y_old = acc[0][mi][nt][2 * hh + e];
              const float dy = acc[SETS - 1][mi][nt][2 * hh + e];
              float psi, psid, dll;
              score_der_loglik_delta<D>(p, y_old, dy, psi, psid, dll);
              const float y = y_old + dy;
              const bool valid = row < p.n && c0 + cl + e < p.t;
              if (valid) {
                sums[0] += dll;
                sums[1] += psid;
                if (p.need_ysq) {
                  sums[2] += (2.f * y_old + dy) * dy;
                  sums[3] += y * y;
                }
              }
              score_der<D>(p, y, psi, psid);  // the contraction's psi, psi' of the f32 Y
              yv[e] = y;  // 0 at padded rows and columns
              ps[e] = psi;
              pd[e] = valid ? psid : 0.f;
              acc[0][mi][nt][2 * hh + e] = acc[SETS - 1][mi][nt][2 * hh + e] = 0.f;
            } else {
              const float y = acc[0][mi][nt][2 * hh + e];
              float psi, psid, ll;
              score_der_loglik<D>(p, y, psi, psid, ll);
              const bool valid = row < p.n && c0 + cl + e < p.t;
              if (valid) {  // log_lik(0) != 0 and psi'(0) != 0
                sums[0] += ll;
                sums[1] += psid;
                if (p.need_ysq) sums[3] += y * y;
              }
              yv[e] = y;
              ps[e] = psi;
              pd[e] = valid ? psid : 0.f;
              acc[0][mi][nt][2 * hh + e] = 0.f;
            }
          }
          const long long off = (long long)row * p.ws_cols + wcol + cl;
          if constexpr (CT == F32) {
            *reinterpret_cast<float2*>(p.wsf[0] + off) = make_float2(ps[0], ps[1]);
            *reinterpret_cast<float2*>(p.wsf[1] + off) = make_float2(yv[0], yv[1]);
            if (NEED_H) {
              *reinterpret_cast<float2*>(p.wsf[2] + off) = make_float2(pd[0], pd[1]);
              *reinterpret_cast<float2*>(p.wsf[3] + off) =
                  make_float2(yv[0] * yv[0], yv[1] * yv[1]);
            }
          } else if constexpr (CT == BF16) {
            *reinterpret_cast<uint32_t*>(p.ws[0] + off) = pack_bf16(ps[0], ps[1]);
            *reinterpret_cast<uint32_t*>(p.ws[1] + off) = pack_bf16(yv[0], yv[1]);
            if (NEED_H) {
              *reinterpret_cast<uint32_t*>(p.ws[2] + off) = pack_bf16(pd[0], pd[1]);
              *reinterpret_cast<uint32_t*>(p.ws[3] + off) =
                  pack_bf16(yv[0] * yv[0], yv[1] * yv[1]);
            }
          } else {
            uint32_t hi, lo;
            split_pair(ps[0], ps[1], hi, lo);
            *reinterpret_cast<uint32_t*>(p.ws[0] + off) = hi;
            *reinterpret_cast<uint32_t*>(p.ws[1] + off) = lo;
            split_pair(yv[0], yv[1], hi, lo);
            *reinterpret_cast<uint32_t*>(p.ws[2] + off) = hi;
            *reinterpret_cast<uint32_t*>(p.ws[3] + off) = lo;
            if (NEED_H) {
              split_pair(pd[0], pd[1], hi, lo);
              *reinterpret_cast<uint32_t*>(p.ws[4] + off) = hi;
              *reinterpret_cast<uint32_t*>(p.ws[5] + off) = lo;
              split_pair(yv[0] * yv[0], yv[1] * yv[1], hi, lo);
              *reinterpret_cast<uint32_t*>(p.ws[6] + off) = hi;
              *reinterpret_cast<uint32_t*>(p.ws[7] + off) = lo;
            }
          }
        }
        // The quad's lanes, then this column warp's slot of the row: each
        // slot has one writer.
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sums[k] += __shfl_xor_sync(0xffffffffu, sums[k], 1);
          sums[k] += __shfl_xor_sync(0xffffffffu, sums[k], 2);
        }
        if (q == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) red[(k * A_WC + wc) * TILE + rl] += sums[k];
        }
      }
    }
  }

  // The group's row partials: the column warps in order, rounded once.
  __syncthreads();
  const int row = row0 + tid;
  if (tid < TILE && row < p.n) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double* r = red + k * A_WC * TILE + tid;
      double sum = r[0];
#pragma unroll
      for (int c = 1; c < A_WC; ++c) sum += r[c * TILE];
      v[k] = (float)sum;
    }
    const long long o = (long long)grp * p.stride + row;
    p.ll[o] = v[0];
    p.pm[o] = v[1];
    if (p.need_ysq) {
      // plain mode: dysq = ysq = sum Y^2
      p.dysq[o] = MODE == MODE_DELTA ? v[2] : v[3];
      p.ysq[o] = v[3];
    }
  }
}

// Launch A of the delta pairs on f32 X at ROT = CT = F32 or BF16X3, and
// the log-lik launch on f32 X at F32 (rotate_wgmma_kernel, MODE_DELTA or
// MODE_LOGLIK): warp specialised on Hopper's own instructions. The first
// warpgroup (two in log-lik mode) produces: warp 0 (one lane) fills a ring of STAGES
// (GCfg) with bulk copies, each stage a 16-deep k step: the SETS P W parts
// of the block's 128 rows (laid out by the caller as wgmma reads them, one
// copy; SETS = 2 in delta mode, M_old's and dM's, else M's)
// and of the 16 f32 rows of the 128-column X tile each row's 16-byte
// aligned span (x_span; the row itself at t % 4 == 0), completing on the stage's
// `full` barrier (in log-lik mode, where X's rows are 16-byte aligned, X's
// 16 x 128 box by one tensor-map copy instead: sixteen row copies a stage
// held the pipeline below the products' pace, PERF.md §6); its other warps
// (3, or 7 in log-lik mode) split each landed f32 X stage once into its P
// bf16 part tiles (K-major, as wgmma reads B), zero past n and t, and
// arrive on `ready`. The last two warpgroups consume, 64 W rows each, the
// same X tile: per step and set (Y_old and dY, or Y) the step's chain of P
// (P + 1) / 2 wgmma m64n128k16 starts in a fresh accumulator and is added to
// the set's f32 sum, to nearest; then each consumer warp arrives on the
// stage's `empty` barrier, which the producer waits on before it fills
// the stage again. While one consumer warpgroup adds its fresh sum, the
// other's chain runs on the tensor cores. The producer gives its
// registers to the consumers (setmaxnreg 40 / 232; 40 / 216 with log-lik
// mode's two producer warpgroups): the consumers hold
// Y_old, dY and the fresh sum, 192 f32 a thread (Y and the fresh sum, 128,
// in log-lik mode). After a tile's last step each consumer runs the
// density, the row sums and (in delta mode) the workspace stores of its
// 64 x 128 share (below). Both consumers wait on the same stages
// and so reach their epilogues together: no products run meanwhile (the
// epilogue is not overlapped with the next tile's products); only the
// producer's copies and splits go on, as far as the ring lets them.
constexpr int G_BN = 128;         // columns of an X tile
constexpr int G_KS = 16;          // k depth of a stage (one wgmma)
constexpr int G_CONSUMERS = 256;  // two consumer warpgroups
constexpr int G_TILE_BYTES = 128 * G_KS * 2;  // one 128-row (column) part tile
constexpr int G_PRODUCER_REGS = 40;
constexpr int OUT_LD = 24;  // row stride (bf16) of the staged output tile: no bank conflicts
constexpr int G_XS = G_BN + 4;  // row slot (f32) of a stage's f32 X rows: a span's most floats

// Row r of a stage's f32 X where its rows are not 16-byte aligned (not
// d.vec), its `cols` columns from `a` on, in X's 16-byte aligned bytes
// [x_lo, x_hi): the bulk copy takes the 16-byte aligned span around the
// row's columns, kept inside X, into the row's slot (from a - d on);
// column c lands at float c + d of the slot if 0 <= c + d < len ({d,
// len}, kept in the stage for the split), else (the head of X's first row
// if X is not 16-byte aligned, the tail of its last) the split reads it
// from global memory. With d.vec each row is copied as it is.
__device__ __forceinline__ int2 x_span(const float* a, int cols, std::uintptr_t x_lo,
                                       std::uintptr_t x_hi) {
  const std::uintptr_t at = reinterpret_cast<std::uintptr_t>(a);
  std::uintptr_t l = at & ~std::uintptr_t(15), h = (at + 4u * cols + 15u) & ~std::uintptr_t(15);
  l = l < x_lo ? x_lo : l;
  h = h > x_hi ? x_hi : h;
  const int len = cols > 0 && h > l ? (int)((h - l) >> 2) : 0;
  return make_int2((int)(((long long)at - (long long)l) >> 2), len);
}
static_assert(G_BN == TILE, "the tile is a group's column multiple and W's row block");

// The wgmma launch's shared memory (from a 128-byte aligned base): STAGES
// stages of [the SETS P W part tiles][the P X part tiles][the f32 X rows,
// 16 x G_XS][their 16 {d, len} (x_span)], then the consumers' epilogue
// slots (16 SETS floats a thread), at BF16X3 their staged output tiles,
// the row sums (4 sums x TILE rows, f64) and the full / ready / empty
// barriers. STAGES: as deep as the 227 KB allow; three stages measured
// within 0.5 ms of four or five at 256 x 2M in delta mode (PERF.md §6).
// The producers: one warpgroup in delta mode, whose three warps split X
// (the consumers need 232 registers for two sets); two in log-lik mode,
// whose seven splitting warps keep up with one set's products (three took
// as long as the products; PERF.md §6).
template <int ROT, int SETS>
struct GCfg {
  static constexpr int PRODUCERS = SETS == 1 ? 256 : 128;
  static constexpr int THREADS = PRODUCERS + G_CONSUMERS;
  static constexpr int SPLITTERS = PRODUCERS / 32 - 1;  // warps; warp 0 copies
  static constexpr int CONSUMER_REGS = SETS == 1 ? 216 : 232;
  static_assert(G_PRODUCER_REGS * PRODUCERS + CONSUMER_REGS * G_CONSUMERS <= 65536,
                "an SM's registers");
  static constexpr int P = parts(ROT);
  static constexpr int STAGES = SETS == 1 ? 6 : ROT == F32 ? 4 : 5;
  static constexpr int W_BYTES = SETS * P * G_TILE_BYTES;
  static constexpr int XP = W_BYTES;                    // the X part tiles
  static constexpr int XF = XP + P * G_TILE_BYTES;      // the f32 X rows
  static constexpr int XM = XF + G_KS * G_XS * 4;       // the rows' {d, len}
  static constexpr int STAGE = XM + G_KS * 8;
  static constexpr int EPI = STAGES * STAGE;
  // At BF16X3 the psi and Y hi / lo planes of a warp's 16 rows x 16
  // columns go out through OUT (rows OUT_LD bf16 apart) as whole 32-byte
  // sectors; 4-byte stores of column pairs wrote half sectors.
  static constexpr int OUT = EPI + 16 * SETS * G_CONSUMERS * 4;
  static constexpr int OUT_WARP = ROT == BF16X3 ? 4 * 16 * OUT_LD * 2 : 0;  // bytes
  static constexpr int RED = OUT + 8 * OUT_WARP;
  static constexpr int BAR = RED + 4 * TILE * 8;
  static constexpr int BYTES = BAR + 3 * STAGES * 8 + 128;  // + the aligning slack
  static_assert(BYTES + BLOCK_RESERVED <= SM_SMEM, "one block fits an SM");
  static_assert(STAGE % 128 == 0 && XF % 128 == 0, "X's tensor-map boxes 128-byte aligned");
};

// A consumer thread's values of quarter QT of its tile's columns (the
// fragment's n8 blocks 4 QT .. 4 QT + 3) into its 16 SETS slots of `epi`
// (slot j of consumer thread t at j * G_CONSUMERS + t): Y_old's 16, then
// dY's (or Y's 16).
template <int QT, int SETS>
__device__ __forceinline__ void park(const float (&acc)[SETS][64], float* epi, int ct) {
#pragma unroll
  for (int set = 0; set < SETS; ++set)
#pragma unroll
    for (int j = 0; j < 16; ++j) epi[(16 * set + j) * G_CONSUMERS + ct] = acc[set][16 * QT + j];
}

template <int ROT, int MODE, int D, bool NEED_H>
__global__ void __launch_bounds__(GCfg<ROT, MODE == MODE_DELTA ? 2 : 1>::THREADS, 1)
    rotate_wgmma_kernel(const __grid_constant__ DParams p) {
  static_assert(MODE == MODE_DELTA || (MODE == MODE_LOGLIK && ROT == F32 && !NEED_H),
                "delta mode, or the log-lik mode at F32");
  constexpr int SETS = MODE == MODE_DELTA ? 2 : 1;
  using C = GCfg<ROT, SETS>;
  constexpr int P = C::P, ST = C::STAGES, PT = C::PRODUCERS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* epi = reinterpret_cast<float*>(smem + C::EPI);
  __nv_bfloat16* outs = reinterpret_cast<__nv_bfloat16*>(smem + C::OUT);
  double* red = reinterpret_cast<double*>(smem + C::RED);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* ready = full + ST;
  uint64_t* empty = ready + ST;

  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = p.g0 + blockIdx.y;
  const long long col0 = (long long)grp * p.cols;
  const long long ws0 = (long long)blockIdx.y * p.cols;
  const int n_ks = p.n_kc, n_tiles = p.cols / G_BN, total = n_tiles * n_ks;

  for (int u = tid; u < 4 * TILE; u += C::THREADS) red[u] = 0.0;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], C::SPLITTERS);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < PT) {
    // ---- the producer warpgroups ----
    regs_dec<G_PRODUCER_REGS>();
    if (tid == 0) {
      // The copies: stage `it` % ST holds step it % n_ks of tile it / n_ks.
      const __nv_bfloat16* w =
          p.w + (long long)blockIdx.x * n_ks * (C::W_BYTES / 2);  // this row block's steps
      const float* x = static_cast<const float*>(p.x);
      const std::uintptr_t xb = reinterpret_cast<std::uintptr_t>(x);
      const std::uintptr_t x_lo = (xb + 15u) & ~std::uintptr_t(15);
      const std::uintptr_t x_hi = (xb + 4ull * p.n * p.t) & ~std::uintptr_t(15);
      for (int it = 0; it < total; ++it) {
        const int s = it % ST, tile = it / n_ks, k0 = (it % n_ks) * G_KS;
        if (it >= ST) mbar_wait(&empty[s], (it / ST - 1) & 1);
        unsigned char* st = smem + s * C::STAGE;
        int2* spans = reinterpret_cast<int2*>(st + C::XM);
        const long long c0 = col0 + (long long)tile * G_BN;
        const int rows = min(G_KS, p.n - k0);
        const long long left = p.t - c0;
        const int cols = left <= 0 ? 0 : left < G_BN ? (int)left : G_BN;
        const float* x0 = x + (long long)k0 * p.t + c0;
        if (p.xtm) {  // X's 16 x 128 box by tensor map, zero past n and t (counted whole)
          mbar_arrive_expect_tx(&full[s], C::W_BYTES + G_KS * G_BN * 4);
          bulk_load(st, w + (long long)(it % n_ks) * (C::W_BYTES / 2), C::W_BYTES, &full[s]);
          tma_load_2d(st + C::XF, &p.xmap, (int)c0, k0, &full[s]);
          continue;
        }
        unsigned bytes = C::W_BYTES;
        if (p.vec) {
          bytes += rows * cols * 4;
        } else {
          for (int r = 0; r < rows; ++r) {
            const int2 span = x_span(x0 + (long long)r * p.t, cols, x_lo, x_hi);
            spans[r] = span;
            bytes += span.y * 4;
          }
        }
        mbar_arrive_expect_tx(&full[s], bytes);  // releases the spans to the split
        bulk_load(st, w + (long long)(it % n_ks) * (C::W_BYTES / 2), C::W_BYTES, &full[s]);
        for (int r = 0; r < rows; ++r) {
          const int2 span = p.vec ? make_int2(0, cols) : spans[r];
          if (span.y > 0)
            bulk_load(st + C::XF + r * G_XS * 4, x0 + (long long)r * p.t - span.x, span.y * 4,
                      &full[s]);
        }
      }
    } else if (tid >= 32) {
      // The split: (column, 8-deep half of k) units, each 8 f32 values
      // into P 16-byte rows of the part tiles' core matrices. A landed
      // tensor-map box has rows of G_BN floats, a stage of spans rows of
      // G_XS.
      const float* x = static_cast<const float*>(p.x);
      const int ld = p.xtm ? G_BN : G_XS;
      for (int it = 0; it < total; ++it) {
        const int s = it % ST, tile = it / n_ks, k0 = (it % n_ks) * G_KS;
        mbar_wait(&full[s], (it / ST) & 1);
        unsigned char* st = smem + s * C::STAGE;
        const float* xf = reinterpret_cast<const float*>(st + C::XF);
        const int2* spans = reinterpret_cast<const int2*>(st + C::XM);
        const long long c0 = col0 + (long long)tile * G_BN;
        const long long left = p.t - c0;
        const int cols = left <= 0 ? 0 : left < G_BN ? (int)left : G_BN;
        for (int u = tid - 32; u < 2 * G_BN; u += PT - 32) {
          const int col = u % G_BN, kh = u / G_BN;
          uint32_t packed[P][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 8 * kh + 2 * j + e;
              v[e] = 0.f;
              if (col < cols && k0 + k < p.n) {
                if (p.vec) {
                  v[e] = xf[k * ld + col];
                } else {
                  const int2 span = spans[k];
                  const int c = col + span.x;
                  v[e] = (unsigned)c < (unsigned)span.y
                             ? xf[k * G_XS + c]
                             : __ldg(x + (long long)(k0 + k) * p.t + c0 + col);
                }
              }
            }
            uint32_t pair[P];
            split_parts<ROT>(v[0], v[1], pair);
#pragma unroll
            for (int part = 0; part < P; ++part) packed[part][j] = pair[part];
          }
#pragma unroll
          for (int part = 0; part < P; ++part)
            *reinterpret_cast<uint4*>(st + C::XP + part * G_TILE_BYTES + (col / 8) * CORE_SBO +
                                      kh * CORE_LBO + (col % 8) * 16) =
                make_uint4(packed[part][0], packed[part][1], packed[part][2], packed[part][3]);
        }
        fence_async_shared();  // the part tiles, before wgmma reads them
        __syncwarp();
        if (lane == 0) mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: cg owns rows 64 cg .. 64 cg + 63 ----
  regs_inc<C::CONSUMER_REGS>();
  const int ct = tid - PT, cg = ct / 128, warp = (ct % 128) / 32;
  const int wo = (ct / 32) * (C::OUT_WARP / 2);  // the warp's staged output tile
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * TILE;
  float acc[SETS][64];  // Y_old, dY in delta mode; else Y
  float fr[64] = {};     // a step's fresh sum
  for (int tile = 0; tile < n_tiles; ++tile) {
#pragma unroll
    for (int set = 0; set < SETS; ++set)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[set][i] = 0.f;
    for (int ks = 0; ks < n_ks; ++ks) {
      const int it = tile * n_ks + ks, s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      mbar_wait(&ready[s], (it / ST) & 1);
      const unsigned char* st = smem + s * C::STAGE;
      if constexpr (!SKIP_PRODUCTS) {
#pragma unroll
        for (int set = 0; set < SETS; ++set) {
          // part (a, b) of W's rows and of X: A at set's plane a, rows 64 cg.
          auto a = [&](int part) {
            return core_desc(st + (set * P + part) * G_TILE_BYTES + cg * (G_TILE_BYTES / 2));
          };
          auto b = [&](int part) { return core_desc(st + C::XP + part * G_TILE_BYTES); };
          wgmma_fence();
          if constexpr (ROT == F32) {  // mma_tier<F32>'s order: small first, hi*hi last
            wgmma_m64n128k16(fr, a(2), b(0), true);
            wgmma_m64n128k16(fr, a(1), b(1), false);
            wgmma_m64n128k16(fr, a(0), b(2), false);
            wgmma_m64n128k16(fr, a(1), b(0), false);
            wgmma_m64n128k16(fr, a(0), b(1), false);
            wgmma_m64n128k16(fr, a(0), b(0), false);
          } else {  // mma_tier<BF16X3>'s: hi*hi, lo*hi, hi*lo
            wgmma_m64n128k16(fr, a(0), b(0), true);
            wgmma_m64n128k16(fr, a(1), b(0), false);
            wgmma_m64n128k16(fr, a(0), b(1), false);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(fr);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[set][i] += fr[i];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // The tile is done. A quarter of its columns at a time, each thread
    // parks the quarter's values (Y_old and dY, or Y) in its own slots of
    // shared memory and runs the density, the row sums and (in delta mode)
    // the workspace stores over them in a rolled loop, four values at a
    // time: one copy of the density's code, not one for each of the 64
    // (unrolled, the tanh density's code ran from an instruction cache it
    // did not fit).
    const long long c0 = col0 + (long long)tile * G_BN;
    const long long wcol = ws0 + (long long)tile * G_BN;
    const long long left = p.t - c0;  // the tile's columns before t
    const int cols_in = left <= 0 ? 0 : left < G_BN ? (int)left : G_BN;
    float sums[2][4] = {};  // rows g and g + 8: dll (ll), pm, dysq, ysq
#pragma unroll 1
    for (int qt = 0; qt < 4; ++qt) {
      switch (qt) {
        case 0: park<0, SETS>(acc, epi, ct); break;
        case 1: park<1, SETS>(acc, epi, ct); break;
        case 2: park<2, SETS>(acc, epi, ct); break;
        default: park<3, SETS>(acc, epi, ct); break;
      }
#pragma unroll 1
      for (int il = 0; il < 4; ++il) {
        const int cl = 32 * qt + 8 * il + 2 * q;
        if constexpr (MODE == MODE_LOGLIK) {
          // The warp's 16 rows hold a row below n and the tile a column
          // below t, or their Y is all zeros (W's padded rows, X's padded
          // columns): then the density is skipped.
          const bool live = cols_in > 0 && row0 + 64 * cg + 16 * warp < p.n;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 64 * cg + 16 * warp + g + 8 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float y = epi[(4 * il + 2 * h + e) * G_CONSUMERS + ct];
              float ll = y;
              if (!SKIP_DENSITY && live) ll = log_lik<D>(p, y);
              if (row < p.n && cl + e < cols_in) {  // log_lik(0) != 0
                sums[h][0] += ll;
                sums[h][3] += y * y;
              }
            }
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 64 * cg + 16 * warp + g + 8 * h;
            float yv[2], ps[2], pd[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 4 * il + 2 * h + e;
              const float y_old = epi[j * G_CONSUMERS + ct], dy = epi[(16 + j) * G_CONSUMERS + ct];
              float psi = y_old, psid = dy, dll = y_old;
              if constexpr (!SKIP_DENSITY) score_der_loglik_delta<D>(p, y_old, dy, psi, psid, dll);
              const float y = y_old + dy;
              const bool valid = row < p.n && cl + e < cols_in;
              if (valid) {  // dysq and ysq summed always, written with need_ysq
                sums[h][0] += dll;
                sums[h][1] += psid;
                sums[h][2] += (2.f * y_old + dy) * dy;
                sums[h][3] += y * y;
              }
              if constexpr (!SKIP_DENSITY)
                score_der<D>(p, y, psi, psid);  // the contraction's psi, psi' of the f32 Y
              yv[e] = y;  // 0 at padded rows and columns
              ps[e] = psi;
              pd[e] = valid ? psid : 0.f;
            }
            const long long off = (long long)row * p.ws_cols + wcol + cl;
            if constexpr (SKIP_STORES) {
              // no workspace
            } else if constexpr (ROT == F32) {
              *reinterpret_cast<float2*>(p.wsf[0] + off) = make_float2(ps[0], ps[1]);
              *reinterpret_cast<float2*>(p.wsf[1] + off) = make_float2(yv[0], yv[1]);
              if (NEED_H) {
                *reinterpret_cast<float2*>(p.wsf[2] + off) = make_float2(pd[0], pd[1]);
                *reinterpret_cast<float2*>(p.wsf[3] + off) =
                    make_float2(yv[0] * yv[0], yv[1] * yv[1]);
              }
            } else {
              // psi and Y into the warp's staged tile (plane, row, column of
              // the il pair), psi' and Y^2 straight out.
              __nv_bfloat16* o = outs + wo + (g + 8 * h) * OUT_LD + 8 * (il & 1) + 2 * q;
              uint32_t v[4];
              split_pair(ps[0], ps[1], v[0], v[1]);
              split_pair(yv[0], yv[1], v[2], v[3]);
#pragma unroll
              for (int k = 0; k < 4; ++k) *reinterpret_cast<uint32_t*>(o + k * 16 * OUT_LD) = v[k];
              if (NEED_H) {
                uint32_t hi, lo;
                split_pair(pd[0], pd[1], hi, lo);
                *reinterpret_cast<uint32_t*>(p.ws[4] + off) = hi;
                *reinterpret_cast<uint32_t*>(p.ws[5] + off) = lo;
                split_pair(yv[0] * yv[0], yv[1] * yv[1], hi, lo);
                *reinterpret_cast<uint32_t*>(p.ws[6] + off) = hi;
                *reinterpret_cast<uint32_t*>(p.ws[7] + off) = lo;
              }
            }
          }
          if constexpr (ROT == BF16X3 && !SKIP_STORES) {
            if (il & 1) {
              // The il pair's 16 columns of the warp's 16 rows, four planes:
              // 16 bytes a lane, two lanes a row's 32-byte sector.
              __syncwarp();
              const long long col = wcol + 32 * qt + 16 * (il >> 1);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int c = lane + 32 * k, r = (c & 31) >> 1, half = c & 1;
                const uint4 v = *reinterpret_cast<const uint4*>(outs + wo + (k * 16 + r) * OUT_LD +
                                                                8 * half);
                *reinterpret_cast<uint4*>(p.ws[k] + (long long)(row0 + 64 * cg + 16 * warp + r) *
                                                        p.ws_cols + col + 8 * half) = v;
              }
              __syncwarp();
            }
          }
        }
      }
    }
    // The quad's lanes, then the row's one slot: each row has one writer.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sums[h][k] += __shfl_xor_sync(0xffffffffu, sums[h][k], 1);
        sums[h][k] += __shfl_xor_sync(0xffffffffu, sums[h][k], 2);
      }
      if (q == 0) {
        const int rl = 64 * cg + 16 * warp + g + 8 * h;
#pragma unroll
        for (int k = 0; k < 4; ++k) red[k * TILE + rl] += sums[h][k];
      }
    }
  }

  // The group's row partials, rounded once.
  bar_sync<G_CONSUMERS>(1);
  const int row = row0 + ct;
  if (ct < TILE && row < p.n) {
    const long long o = (long long)grp * p.stride + row;
    p.ll[o] = (float)red[ct];
    if (MODE == MODE_DELTA) {
      p.pm[o] = (float)red[TILE + ct];
      if (p.need_ysq) p.dysq[o] = (float)red[2 * TILE + ct];
    }
    if (p.need_ysq) p.ysq[o] = (float)red[3 * TILE + ct];
  }
}

// Launch A of plain bf16 on bf16 X, and the log-lik launch on bf16 X
// (rotate_plain_wgmma_kernel, LOGLIK): warp specialised on Hopper's own
// instructions. One block of 512 threads an
// SM owns TILE rows of W and one group of `cols` columns, walked in
// P_BN-column tiles. Warpgroups 1-3 consume alternate tiles of the group
// (consumer c takes tiles c, c + P_NC, ...), all TILE rows of each, so
// that one consumer's density and stores run while another's products
// do. Each consumer has a ring of its own: a ring shared by consumers that
// skip each other's stages would let one wait on a stage's phase two
// ahead, which an mbarrier's parity cannot tell from the last. Warp c of
// warpgroup 0 fills consumer c's ring of P_KC-deep stages: its lane 0
// with tensor-map copies (completing on the stage's `full` mbarrier) of
// X's box of P_BN columns x P_KC rows in the 128-byte swizzle, which wgmma
// reads MN-major (sw128_mn_desc; zero past n and t by the map), and, where
// W does not stay resident, of W's box of TILE rows x P_KC in the same
// swizzle, K-major (sw128_desc). Where X's rows are not 16-byte aligned (a
// ragged t, or an unaligned base: no tensor map can be made), the whole
// warp loads X's box with plain loads into the same swizzled layout and
// arrives once more. W (the caller's zero-padded (n_pad, kp) bf16 plane)
// is copied once a block into shared memory where kp <= P_RESIDENT_KP,
// beside rings as deep as what is left allows. A consumer runs per 16-deep
// k step two wgmma m64n64k16 (the two 64-row halves), each in a fresh sum
// added to the tile's f32 Y; a stage goes back to its producer warp
// through its `empty` mbarrier. setmaxnreg gives the consumers 152
// registers and the producer 56. The density follows each tile in its
// consumer, a quarter of the tile at a time (a thread's one row of the
// quarter, 8 rows of a warp, all 64 columns): the thread's 16 values are
// parked in its own shared-memory slots and run through one copy of the
// density's code; each row's sums go to f64 in shared memory once a
// quarter, a slot set for each consumer, added in the consumers' order at
// the group's end; psi and Y are staged a warp's 8 rows at a time (two
// buffers) in the 128-byte swizzle and written by tensor-map stores of
// whole 128-byte rows (psi' and Y^2, with H, as 4-byte column pairs). The
// log-lik mode runs log_lik alone, sums ll and Y^2, and stores nothing: it
// has no workspace, so no staging buffers either, and its rings take their
// room.
constexpr int P_BN = 64;   // columns of an X tile: one 128-byte swizzle row of bf16
constexpr int P_KC = 64;   // k depth of a stage: one box of X's rows (and of W's columns)
constexpr int P_NC = 3;    // consumer warpgroups
constexpr int P_THREADS = 128 * (1 + P_NC);
constexpr int P_PRODUCER_REGS = 56, P_CONSUMER_REGS = 152;
constexpr int P_X_BOX = P_KC * P_BN * 2;  // bytes of X's box
constexpr int P_W_BOX = TILE * P_KC * 2;  // bytes of W's box
constexpr int P_RESIDENT_KP = 384;        // W resident in shared memory up to this k extent
constexpr int P_MAX_STAGES = 8;           // of a consumer's ring
// After the rings and W: each consumer thread's 16 parked f32 values, each
// consumer warp's two staging buffers of psi and Y (each 2 planes x a box
// of the workspace's tensor map, P_OROWS rows of the tile's P_BN columns,
// 128-byte rows in the 128-byte swizzle; none in log-lik mode), the row
// sums (P_NC x 3 sums x TILE rows, f64), and the rings' full / empty
// barriers and W's.
constexpr int P_OROWS = 8;
constexpr int P_PARK = P_NC * 16 * 128 * 4;
constexpr int P_OBOX = P_OROWS * P_BN;      // bf16 elements of one box
constexpr int P_OUT_BUF = 2 * P_OBOX;       // of one buffer
constexpr int P_OUT_WARP = 2 * P_OUT_BUF;
constexpr int P_OUT = P_NC * 4 * P_OUT_WARP * 2;
constexpr int P_RED = P_NC * 3 * TILE * 8;
__host__ __device__ constexpr int plain_out_bytes(bool loglik) { return loglik ? 0 : P_OUT; }
__host__ __device__ constexpr int plain_fixed_bytes(bool loglik) {
  return P_PARK + plain_out_bytes(loglik) + P_RED + (2 * P_NC * P_MAX_STAGES + 1) * 8;
}
static_assert(P_KC == A_KC, "W's plane is padded along k to whole boxes");
static_assert(P_BN * 2 == 128 && P_KC % 16 == 0 && P_X_BOX % 1024 == 0 && P_W_BOX % 1024 == 0,
              "boxes of whole 128-byte swizzle atoms");
static_assert(P_PARK % 1024 == 0 && P_OUT % 1024 == 0, "swizzled staging boxes 1024-byte aligned");
static_assert(P_PRODUCER_REGS * 128 + P_CONSUMER_REGS * 128 * P_NC <= 65536, "an SM's registers");
static_assert(P_OBOX * 2 == 1024, "a box is one 128-byte swizzle atom");

struct PwParams {
  CUtensorMap wmap;  // W, (n_pad, kp) bf16: boxes of P_KC columns x TILE rows
  CUtensorMap xmap;  // X, (n, t) bf16: boxes of P_BN columns x P_KC rows (vec only)
  CUtensorMap omap;  // the workspace's planes: boxes of P_BN columns x P_OROWS rows
  int n, kp, n_ks, stages, resident, loglik;  // stages: of each consumer's ring
  long long t;
  int need_ysq, vec;
  float a, m2a, mha;
  const __nv_bfloat16* x;
  __nv_bfloat16 *psi, *y, *psid, *y2;  // workspace, (n_pad, ws_cols) each; null in log-lik mode
  long long ws_cols;
  int cols, g0;
  float *ll, *dysq, *pm, *ysq;
  long long stride;
};

// Bytes of one ring stage, and of the launch's shared memory (with the
// slack that aligns it to 1024).
__host__ __device__ constexpr int plain_stage_bytes(int resident) {
  return P_X_BOX + (resident ? 0 : P_W_BOX);
}
int plain_smem_bytes(const PwParams& p) {
  return 1024 + P_NC * p.stages * plain_stage_bytes(p.resident) +
         (p.resident ? p.n_ks * P_W_BOX : 0) + plain_fixed_bytes(p.loglik);
}

// A consumer thread's values of quarter QT of its tile, its row g + 8 (QT
// % 2) of half QT / 2 (fragment values 4 i + 2 h + e, all 64 columns 8 i +
// 2 q + e), into its 16 slots (slot 2 i + e at pk[(2 i + e) * 128]).
template <int QT>
__device__ __forceinline__ void park_plain(const float (&acc)[2][32], float* pk) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) pk[(2 * i + e) * 128] = acc[QT / 2][4 * i + 2 * (QT % 2) + e];
}

template <int D, bool NEED_H, bool LOGLIK>
__global__ void __launch_bounds__(P_THREADS, 1)
    rotate_plain_wgmma_kernel(const __grid_constant__ PwParams p) {
  static_assert(!(LOGLIK && NEED_H), "the log-lik mode has no contraction");
  constexpr bool STORES = !LOGLIK && !SKIP_STORES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ST = p.stages, stage_bytes = plain_stage_bytes(p.resident);
  unsigned char* wres = smem + P_NC * ST * stage_bytes;
  unsigned char* fixed = wres + (p.resident ? p.n_ks * P_W_BOX : 0);
  float* park = reinterpret_cast<float*>(fixed);
  __nv_bfloat16* outs = reinterpret_cast<__nv_bfloat16*>(fixed + P_PARK);
  double* red = reinterpret_cast<double*>(fixed + P_PARK + plain_out_bytes(LOGLIK));
  uint64_t* full = reinterpret_cast<uint64_t*>(fixed + P_PARK + plain_out_bytes(LOGLIK) + P_RED);
  uint64_t* empty = full + P_NC * P_MAX_STAGES;
  uint64_t* wfull = empty + P_NC * P_MAX_STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = blockIdx.x * TILE;
  const int grp = p.g0 + blockIdx.y;
  const long long col0 = (long long)grp * p.cols;        // the group's first column of X
  const long long ws0 = (long long)blockIdx.y * p.cols;  // and of the workspace
  const int n_ks = p.n_ks, n_tiles = p.cols / P_BN;

  for (int u = tid; u < P_NC * 3 * TILE; u += P_THREADS) red[u] = 0.0;
  if (tid == 0) {
    for (int s = 0; s < P_NC * ST; ++s) {
      mbar_init(&full[s], p.vec ? 1 : 2);  // the copies (and the loads' end)
      mbar_init(&empty[s], 4);             // each warp of the ring's consumer
    }
    mbar_init(wfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- the producer warpgroup: warp c fills consumer c's ring ----
    regs_dec<P_PRODUCER_REGS>();
    const int c = tid >> 5;
    if (tid == 0 && p.resident) {
      mbar_arrive_expect_tx(wfull, n_ks * P_W_BOX);
      for (int ks = 0; ks < n_ks; ++ks)
        tma_load_2d(wres + ks * P_W_BOX, &p.wmap, ks * P_KC, row0, wfull);
    }
    if (c >= P_NC || (p.vec && lane != 0)) return;
    // Item i of the ring is k stage i % n_ks of the consumer's tile i / n_ks
    // (tile c + P_NC (i / n_ks) of the group), in slot i % ST.
    const unsigned w_bytes = p.resident ? 0 : P_W_BOX;
    const unsigned short* x = reinterpret_cast<const unsigned short*>(p.x);
    const int total = (n_tiles - c + P_NC - 1) / P_NC * n_ks;
    for (int i = 0; i < total; ++i) {
      const int s = c * ST + i % ST, ks = i % n_ks, k0 = ks * P_KC;
      const long long c0 = col0 + (long long)(c + P_NC * (i / n_ks)) * P_BN;
      if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
      unsigned char* st = smem + s * stage_bytes;
      if (lane == 0) {
        const unsigned bytes = w_bytes + (p.vec ? P_X_BOX : 0);
        if (bytes)
          mbar_arrive_expect_tx(&full[s], bytes);
        else
          mbar_arrive(&full[s]);
        if (!p.resident) tma_load_2d(st + P_X_BOX, &p.wmap, k0, row0, &full[s]);
        if (p.vec) tma_load_2d(st, &p.xmap, (int)c0, k0, &full[s]);
      }
      if (p.vec) continue;
      // X's box by plain loads: lane l takes the column pair 2 l, 2 l + 1 of
      // each k row (whole 128-byte rows a warp), into the swizzled place a
      // tensor map would land it in (16-byte chunk j of row k at chunk j ^
      // (k % 8)), zero past n and t; then the loads' arrival.
      const long long cc = c0 + 2 * lane;
      const bool in0 = cc < p.t, in1 = cc + 1 < p.t;
#pragma unroll 16
      for (int k = 0; k < P_KC; ++k) {
        const bool row_in = k0 + k < p.n;
        const unsigned short* xr = x + (long long)(k0 + k) * p.t + cc;
        const uint32_t lo = row_in && in0 ? __ldg(xr) : 0u;
        const uint32_t hi = row_in && in1 ? __ldg(xr + 1) : 0u;
        *reinterpret_cast<uint32_t*>(st + k * 128 + (((lane >> 2) ^ (k & 7)) << 4) +
                                     4 * (lane & 3)) = lo | hi << 16;
      }
      fence_async_shared();  // the box, before wgmma reads it
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- the consumer warpgroups: consumer c takes tiles c, c + P_NC, ... ----
  regs_inc<P_CONSUMER_REGS>();
  const int ct = tid - 128, c = ct >> 7, warp = (ct & 127) >> 5;
  const int g = lane >> 2, q = lane & 3;
  float* pk = park + c * 16 * 128 + (ct & 127);
  __nv_bfloat16* ow = outs + (4 * c + warp) * P_OUT_WARP;
  double* rd = red + c * 3 * TILE;
  if (p.resident) mbar_wait(wfull, 0);
  float acc[2][32];
  int nq = 0;  // the consumer's quarters so far: the staging buffer's parity
  for (int tile = c, i0 = 0; tile < n_tiles; tile += P_NC, i0 += n_ks) {
    // The rotation, Y = W X over k: per 16-deep step the two halves'
    // products in fresh accumulators, added to the tile's f32 sums to
    // nearest (a chain of wgmmas rounds toward zero).
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
    for (int ks = 0; ks < n_ks; ++ks) {
      const int i = i0 + ks, s = c * ST + i % ST;  // item i of the consumer's ring
      mbar_wait(&full[s], (i / ST) & 1);
      const unsigned char* st = smem + s * stage_bytes;
      const unsigned char* wb = p.resident ? wres + ks * P_W_BOX : st + P_X_BOX;
      if constexpr (!SKIP_PRODUCTS) {
#pragma unroll
        for (int k16 = 0; k16 < P_KC / 16; ++k16) {
          const uint64_t b = sw128_mn_desc(st) + 128 * k16;
          float f0[32], f1[32];  // the step's fresh sums of the two halves
          wgmma_fence();
          wgmma_m64n64k16_mnb_fresh(f0, sw128_desc(wb) + 2 * k16, b);
          wgmma_commit();
          wgmma_m64n64k16_mnb_fresh(f1, sw128_desc(wb + 64 * 128) + 2 * k16, b);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(f0);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[0][i] += f0[i];
          wgmma_wait<0>();
          fence_regs(f1);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[1][i] += f1[i];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // The tile is done. A quarter of it at a time, rows g + 8 h of half
    // (one row a thread, 8 of the warp, all 64 columns): the thread's 16
    // values parked in its own slots, then the density, the row sums and
    // the staged stores over all 16 (one copy of the density's code, the
    // quarters in a rolled loop).
    const long long c0 = col0 + (long long)tile * P_BN;
    const long long wcol = ws0 + (long long)tile * P_BN;
    const long long left = p.t - c0;  // the tile's columns before t
    const int cols_in = left <= 0 ? 0 : left < P_BN ? (int)left : P_BN;
#pragma unroll 1
    for (int qt = 0; qt < 4; ++qt, ++nq) {
      switch (qt) {
        case 0: park_plain<0>(acc, pk); break;
        case 1: park_plain<1>(acc, pk); break;
        case 2: park_plain<2>(acc, pk); break;
        default: park_plain<3>(acc, pk); break;
      }
      const int rw = 64 * (qt >> 1) + 16 * warp + 8 * (qt & 1);  // the warp's first row
      const int row = row0 + rw + g;
      // The warp's 8 rows hold a row below n and the tile a column below
      // t, or their Y is all zeros (W's padded rows, X's padded columns):
      // then psi = Y = 0, and the density is skipped.
      const bool live = cols_in > 0 && row0 + rw < p.n;
      // The warp's buffer of this quarter, free once the store of two
      // quarters ago has read it.
      __nv_bfloat16* ob = ow + (nq & 1) * P_OUT_BUF;
      if constexpr (STORES) {
        if (lane == 0) bulk_wait_read<1>();
        __syncwarp();
      }
      float sums[3] = {};  // ll, pm, ysq of the row
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int cl = 8 * i + 2 * q;  // the pair's first column in the tile
        float yv[2], ps[2], pd[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = pk[(2 * i + e) * 128];
          float psi = y, psid = y, ll = y;
          if (!SKIP_DENSITY && live) {
            if constexpr (LOGLIK)
              ll = log_lik<D>(p, y);
            else
              score_der_loglik<D>(p, y, psi, psid, ll);
          }
          if (row < p.n && cl + e < cols_in) {  // log_lik(0) != 0 and psi'(0) != 0
            sums[0] += ll;
            if constexpr (!LOGLIK) sums[1] += psid;
            sums[2] += y * y;
            pd[e] = psid;
          } else {
            pd[e] = 0.f;
          }
          yv[e] = y;    // 0 at padded rows and columns
          ps[e] = psi;  // psi(0) == 0
        }
        if constexpr (STORES) {
          // Row g's 16-byte chunk i of each plane's box at chunk i ^ g.
          const int off = g * P_BN + ((i ^ g) << 3) + 2 * q;
          *reinterpret_cast<uint32_t*>(ob + off) = pack_bf16(ps[0], ps[1]);
          *reinterpret_cast<uint32_t*>(ob + P_OBOX + off) = pack_bf16(yv[0], yv[1]);
          if (NEED_H) {
            const long long o = (long long)row * p.ws_cols + wcol + cl;
            *reinterpret_cast<uint32_t*>(p.psid + o) = pack_bf16(pd[0], pd[1]);
            *reinterpret_cast<uint32_t*>(p.y2 + o) = pack_bf16(yv[0] * yv[0], yv[1] * yv[1]);
          }
        }
      }
      if constexpr (STORES) {
        // The warp's 8 rows of the tile, psi then Y, as two tensor-map
        // stores of whole 128-byte rows.
        fence_async_shared();  // the buffer, before the stores read it
        __syncwarp();
        if (lane == 0) {
          tma_store_3d(&p.omap, ob, (int)wcol, row0 + rw, 0);
          tma_store_3d(&p.omap, ob + P_OBOX, (int)wcol, row0 + rw, 1);
          bulk_commit();
        }
      }
      // The row's sums: the quad's lanes, then its one slot of this
      // consumer.
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = sums[k];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) rd[k * TILE + rw + g] += v;
      }
    }
  }

  // The group's row partials: the consumers' sums in order, rounded once;
  // and no store outlives the block.
  if (STORES && lane == 0) bulk_wait<0>();
  bar_sync<128 * P_NC>(1);
  const int row = row0 + ct;
  if (ct < TILE && row < p.n) {
    double v[3] = {};
#pragma unroll
    for (int cc = 0; cc < P_NC; ++cc)
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] += red[(3 * cc + k) * TILE + ct];
    const long long o = (long long)grp * p.stride + row;
    p.ll[o] = (float)v[0];
    if (LOGLIK) {
      if (p.need_ysq) p.ysq[o] = (float)v[2];
    } else {
      p.pm[o] = (float)v[1];
      if (p.need_ysq) p.ysq[o] = p.dysq[o] = (float)v[2];
    }
  }
}

// Launch B on Hopper's own instructions (contract_wgmma_kernel<TIER>;
// the design in the header). Grid (edge^2 output tiles, the chunk's
// groups, G or H); group g's partial at out + (g0 + g) * stride, rows
// and columns >= n not written. Thread 0 of the producers lands each
// stage of KC columns of both operands' planes as 128-row boxes of the
// workspace's tensor map (BParams::tm: element, row, plane) in the
// 128-byte swizzle (hopper_async.cuh sw128_desc): at BF16 and BF16X3 the
// bf16 part planes themselves, read by wgmma as they land; at F32 the f32
// planes into a RAW_STAGES ring, which the producers' 256 threads split
// once into the stage's hi / mid / lo part tiles in the no-swizzle
// K-major layout (core_desc). A stage holds CHAINS chains of FRESH
// columns; the ring depths made no difference at F32 (PERF.md §6 PR 23).
template <int TIER>
struct CwCfg {
  // Producer warpgroups (F32: two, whose eight warps split the f32 boxes),
  // then the two consumers; setmaxnreg's split of the launch's registers:
  // the consumers hold the tile's sum and two fresh chains, 192 f32 a
  // thread, and take what the producers give up.
  static constexpr int PRODUCERS = TIER == F32 ? 256 : 128;
  static constexpr int THREADS = PRODUCERS + 256;
  static constexpr int PRODUCER_REGS = TIER == F32 ? 40 : 56;
  static constexpr int CONSUMER_REGS = TIER == F32 ? 216 : 224;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static_assert(PRODUCER_REGS * PRODUCERS + CONSUMER_REGS * 256 <= LAUNCH_REGS * THREADS,
                "the consumers' registers come from the producers'");
  static constexpr int P = parts(TIER);
  static constexpr int FRESH = TIER == BF16 ? 32 : 16;  // columns a chain sums
  static constexpr int KC = TIER == F32 ? 32 : 64;      // columns a stage: 128-byte box rows
  static constexpr int CHAINS = KC / FRESH;
  static constexpr int BOX = TILE * 128;                 // bytes of one 128-row box
  static constexpr int BLK = TILE * 16 * 2;              // bytes of one no-swizzle k block
  static constexpr int PART = TIER == F32 ? KC / 16 * BLK : BOX;  // one part of one operand
  static constexpr int STAGE = 2 * P * PART;
  static constexpr int STAGES = TIER == F32 ? 2 : TIER == BF16X3 ? 3 : 6;
  static constexpr int RAW_STAGES = TIER == F32 ? 3 : 0;
  static constexpr int RAW0 = STAGES * STAGE;
  static constexpr int BAR = RAW0 + RAW_STAGES * 2 * BOX;
  // + the barriers, and the slack that aligns the boxes to 1024 bytes
  static constexpr int BYTES = BAR + (2 * STAGES + RAW_STAGES) * 8 + 1024;
  static_assert(BYTES + BLOCK_RESERVED <= SM_SMEM, "one block fits an SM");
  static_assert(CHAINS % 2 == 0 && STAGE % 1024 == 0, "chains in pairs, aligned boxes");
};

// One chain of consumer warpgroup cg: chain c's FRESH columns of stage
// `st` in a fresh accumulator, products in mma_tier's order (F32: small
// first, hi*hi last; BF16X3: hi*hi, lo*hi, hi*lo; BF16: two k blocks),
// committed as one wgmma group.
template <int TIER>
__device__ __forceinline__ void contract_chain(float (&fr)[64], const unsigned char* st, int cg,
                                               int c) {
  using C = CwCfg<TIER>;
  auto a = [&](int part, int kb) {
    return TIER == F32 ? core_desc(st + part * C::PART + kb * C::BLK + cg * (C::BLK / 2))
                       : sw128_desc(st + part * C::PART + cg * (C::BOX / 2)) + 2 * kb;
  };
  auto b = [&](int part, int kb) {
    return TIER == F32 ? core_desc(st + (C::P + part) * C::PART + kb * C::BLK)
                       : sw128_desc(st + (C::P + part) * C::PART) + 2 * kb;
  };
  wgmma_fence();
  if constexpr (TIER == F32) {
    wgmma_m64n128k16(fr, a(2, c), b(0, c), true);
    wgmma_m64n128k16(fr, a(1, c), b(1, c), false);
    wgmma_m64n128k16(fr, a(0, c), b(2, c), false);
    wgmma_m64n128k16(fr, a(1, c), b(0, c), false);
    wgmma_m64n128k16(fr, a(0, c), b(1, c), false);
    wgmma_m64n128k16(fr, a(0, c), b(0, c), false);
  } else if constexpr (TIER == BF16X3) {
    wgmma_m64n128k16(fr, a(0, c), b(0, c), true);
    wgmma_m64n128k16(fr, a(1, c), b(0, c), false);
    wgmma_m64n128k16(fr, a(0, c), b(1, c), false);
  } else {
    wgmma_m64n128k16(fr, a(0, 2 * c), b(0, 2 * c), true);
    wgmma_m64n128k16(fr, a(0, 2 * c + 1), b(0, 2 * c + 1), false);
  }
  wgmma_commit();
}

template <int TIER>
__global__ void __launch_bounds__(CwCfg<TIER>::THREADS, 1)
    contract_wgmma_kernel(const __grid_constant__ BParams p) {
  using C = CwCfg<TIER>;
  constexpr int P = C::P, KC = C::KC, ST = C::STAGES, RS = C::RAW_STAGES, PT = C::PRODUCERS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* empty = full + ST;
  uint64_t* raw_full = empty + ST;

  const int tid = threadIdx.x, lane = tid & 31;
  const int ti = blockIdx.x / p.edge, tj = blockIdx.x % p.edge;
  const int hmat = blockIdx.z;  // G's planes, or H's
  const int total = p.cols / KC;
  const int k0 = blockIdx.y * p.cols;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], TIER == F32 ? PT : 1);  // each splitting thread, or the copy
      mbar_init(&empty[s], 8);                     // each consumer warp
    }
    for (int s = 0; s < RS; ++s) mbar_init(&raw_full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < PT) {
    // ---- the producer warpgroups ----
    regs_dec<C::PRODUCER_REGS>();
    // Box (operand o, part pt) of step it: the operand's row tile, the
    // plane of its matrix and part (one f32 plane an operand at F32).
    constexpr int WP = TIER == F32 ? 1 : P;
    auto copy = [&](unsigned char* dst, int it, int o, int pt, uint64_t* bar) {
      tma_load_3d(dst, &p.tm, k0 + it * KC, (o ? tj : ti) * TILE, (hmat * 2 + o) * WP + pt, bar);
    };
    if constexpr (TIER != F32) {
      if (tid == 0) {
        for (int it = 0; it < total; ++it) {
          const int s = it % ST;
          if (it >= ST) mbar_wait(&empty[s], (it / ST - 1) & 1);
          unsigned char* st = smem + s * C::STAGE;
          mbar_arrive_expect_tx(&full[s], C::STAGE);
#pragma unroll
          for (int o = 0; o < 2; ++o)
#pragma unroll
            for (int pt = 0; pt < P; ++pt) copy(st + (o * P + pt) * C::PART, it, o, pt, &full[s]);
        }
      }
    } else {
      auto copy_raw = [&](int it) {
        unsigned char* raw = smem + C::RAW0 + (it % RS) * 2 * C::BOX;
        mbar_arrive_expect_tx(&raw_full[it % RS], 2 * C::BOX);
        copy(raw, it, 0, 0, &raw_full[it % RS]);
        copy(raw + C::BOX, it, 1, 0, &raw_full[it % RS]);
      };
      if (tid == 0)
        for (int it = 0; it < RS && it < total; ++it) copy_raw(it);
      for (int it = 0; it < total; ++it) {
        const int s = it % ST;
        mbar_wait(&raw_full[it % RS], (it / RS) & 1);
        if (it >= ST) mbar_wait(&empty[s], (it / ST - 1) & 1);
        const unsigned char* raw = smem + C::RAW0 + (it % RS) * 2 * C::BOX;
        unsigned char* st = smem + s * C::STAGE;
        // Thread tid's pieces (operand, row r, 16-byte chunk c4 of the
        // row's 32 f32), v = tid + PT j: a half-warp's 8-byte part
        // stores fill 128 contiguous bytes. Four pieces' loads first, then
        // their splits.
        constexpr int PER_OP = TILE * 8 / PT;
#pragma unroll 1
        for (int j0 = 0; j0 < 2 * PER_OP; j0 += 4) {
          float4 x[4];
          int at[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + u, o = j / PER_OP, v = tid + PT * (j % PER_OP), rest = v >> 4;
            const int r = ((v >> 1) & 7) | (rest >> 2) << 3, c4 = (v & 1) | (rest & 3) << 1;
            x[u] = *reinterpret_cast<const float4*>(raw + o * C::BOX + r * 128 +
                                                    ((c4 ^ (r & 7)) << 4));
            at[u] = o * P * C::PART + (c4 / 4) * C::BLK + (r / 8) * CORE_SBO +
                    ((c4 % 4) / 2) * CORE_LBO + (r % 8) * 16 + (c4 % 2) * 8;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t lo2[P], hi2[P];
            split_parts<F32>(x[u].x, x[u].y, lo2);
            split_parts<F32>(x[u].z, x[u].w, hi2);
#pragma unroll
            for (int pt = 0; pt < P; ++pt)
              *reinterpret_cast<uint2*>(st + at[u] + pt * C::PART) = make_uint2(lo2[pt], hi2[pt]);
          }
        }
        fence_async_shared();  // the part tiles, before wgmma reads them
        mbar_arrive(&full[s]);
        bar_sync<PT>(1);  // every producer thread is done with the raw stage
        if (tid == 0 && it + RS < total) copy_raw(it + RS);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: cg owns rows 64 cg .. 64 cg + 63 ----
  regs_inc<C::CONSUMER_REGS>();
  const int ct = tid - PT, cg = ct / 128, warp = (ct % 128) / 32;
  const int g = lane >> 2, q = lane & 3;
  float acc[64], f0[64], f1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = f0[i] = f1[i] = 0.f;
  // Chains in pairs: f1's chain runs while f0's is added to the tile, and
  // the other consumer's chains while f1's is; so the chains' sums reach
  // acc in column order, to nearest, and every chain is retired in the
  // iteration that issued it (a wait across iterations made ptxas
  // serialize the wgmmas). A stage goes back to the producer once its
  // last chain is done.
  for (int it = 0; it < total; ++it) {
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    const unsigned char* st = smem + s * C::STAGE;
#pragma unroll
    for (int c = 0; c < C::CHAINS; c += 2) {
      contract_chain<TIER>(f0, st, cg, c);
      contract_chain<TIER>(f1, st, cg, c + 1);
      wgmma_wait<1>();
      fence_regs(f0);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += f0[i];
      wgmma_wait<0>();
      fence_regs(f1);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += f1[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float* out = p.out[hmat] + (long long)(p.g0 + blockIdx.y) * p.stride;
  const int i0 = ti * TILE + 64 * cg + 16 * warp + g;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * (e >> 1), j = tj * TILE + 8 * c + 2 * q + (e & 1);
      if (i < p.n && j < p.n) out[(long long)i * p.n + j] = acc[4 * c + e];
    }
  }
}

template <class Kernel, class Params>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const Params& p, cudaStream_t st,
                   int threads = THREADS) {
  // Above 48 KB dynamic shared memory must be opted into; a refused
  // launch never runs and only cudaGetLastError reports it.
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

// The wgmma launch on bf16 X (rotate_plain_wgmma_kernel): launch A of
// plain bf16, or with LOGLIK the log-lik launch.
template <bool NEED_H, bool LOGLIK>
cudaError_t launch_plain_wgmma(int dens, dim3 grid, const PwParams& p, cudaStream_t st) {
  const int smem = plain_smem_bytes(p);
  switch (dens) {
    case TANH:
      return launch(rotate_plain_wgmma_kernel<TANH, NEED_H, LOGLIK>, smem, grid, p, st, P_THREADS);
    case EXP:
      return launch(rotate_plain_wgmma_kernel<EXP, NEED_H, LOGLIK>, smem, grid, p, st, P_THREADS);
    case CUBE:
      return launch(rotate_plain_wgmma_kernel<CUBE, NEED_H, LOGLIK>, smem, grid, p, st, P_THREADS);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, int ROT, int CT, bool XB, bool NEED_H>
cudaError_t launch_d(int dens, dim3 grid, const DParams& p, cudaStream_t st) {
  using C = DCfg<ROT, MODE == MODE_DELTA ? 2 : 1, XB>;
  DParams q = p;
  q.n_kc = (p.n + C::KC - 1) / C::KC;
  switch (dens) {
    case TANH:
      return launch(rotate_split_kernel<MODE, ROT, CT, XB, TANH, NEED_H>, C::BYTES, grid, q, st);
    case EXP:
      return launch(rotate_split_kernel<MODE, ROT, CT, XB, EXP, NEED_H>, C::BYTES, grid, q, st);
    case CUBE:
      return launch(rotate_split_kernel<MODE, ROT, CT, XB, CUBE, NEED_H>, C::BYTES, grid, q, st);
  }
  return cudaErrorInvalidValue;
}

// rotate_wgmma_kernel in MODE (delta, or the log-lik launch on f32 X).
template <int ROT, int MODE, bool NEED_H>
cudaError_t launch_g(int dens, dim3 grid, const DParams& p, cudaStream_t st) {
  using C = GCfg<ROT, MODE == MODE_DELTA ? 2 : 1>;
  DParams q = p;
  q.n_kc = (p.n + G_KS - 1) / G_KS;
  switch (dens) {
    case TANH:
      return launch(rotate_wgmma_kernel<ROT, MODE, TANH, NEED_H>, C::BYTES, grid, q, st,
                    C::THREADS);
    case EXP:
      return launch(rotate_wgmma_kernel<ROT, MODE, EXP, NEED_H>, C::BYTES, grid, q, st,
                    C::THREADS);
    case CUBE:
      return launch(rotate_wgmma_kernel<ROT, MODE, CUBE, NEED_H>, C::BYTES, grid, q, st,
                    C::THREADS);
  }
  return cudaErrorInvalidValue;
}

// Launch B of one chunk at the contraction tier CT: contract_wgmma_kernel.
template <int CT>
cudaError_t launch_contract(dim3 grid, const BParams& b, cudaStream_t st) {
  return launch(contract_wgmma_kernel<CT>, CwCfg<CT>::BYTES, grid, b, st, CwCfg<CT>::THREADS);
}

cudaError_t launch_contract(int ct, dim3 grid, const BParams& b, cudaStream_t st) {
  switch (ct) {
    case F32: return launch_contract<F32>(grid, b, st);
    case BF16X3: return launch_contract<BF16X3>(grid, b, st);
    case BF16: return launch_contract<BF16>(grid, b, st);
  }
  return cudaErrorInvalidValue;
}

// The wgmma launch A then B for one chunk, delta mode at ROT = CT on f32 X.
template <int ROT>
cudaError_t launch_wgmma_split(int dens, bool need_h, dim3 grid_a, const DParams& d,
                               dim3 grid_b, const BParams& b, cudaStream_t st) {
  cudaError_t e = need_h ? launch_g<ROT, MODE_DELTA, true>(dens, grid_a, d, st)
                         : launch_g<ROT, MODE_DELTA, false>(dens, grid_a, d, st);
  if (e != cudaSuccess) return e;
  return launch_contract<ROT>(grid_b, b, st);
}

// Split launch A then B for one chunk, in MODE (delta or plain) at the
// rotation tier ROT and the contraction tier CT, on f32 or (XB) bf16 X.
template <int MODE, int ROT, int CT, bool XB>
cudaError_t launch_split(int dens, bool need_h, dim3 grid_a, const DParams& d, dim3 grid_b,
                         const BParams& b, cudaStream_t st) {
  cudaError_t e = need_h ? launch_d<MODE, ROT, CT, XB, true>(dens, grid_a, d, st)
                         : launch_d<MODE, ROT, CT, XB, false>(dens, grid_a, d, st);
  if (e != cudaSuccess) return e;
  return launch_contract<CT>(grid_b, b, st);
}

// The pairs whose launch A is rotate_wgmma_kernel, their W laid out by
// the caller as it reads it (ops/kernels.py _wgmma_weights): delta mode on
// f32 X, rotation and contraction both at BF16X3 or both at F32.
// split_pairs routes by it; picard_stream_wgmma_pair exports it, and
// ops/kernels.py holds its own choice of W's layout to it when it loads
// the library.
constexpr bool wgmma_pair(bool delta, int rot, int ct, bool x_bf16) {
  return delta && !x_bf16 && rot == ct && (rot == BF16X3 || rot == F32);
}

// The pair whose launch A is rotate_plain_wgmma_kernel: plain mode on bf16
// X, both tiers BF16. Its W is the caller's plain (n_pad, kp) bf16 plane,
// which the kernel reads through a tensor map, so the caller needs no
// rule of its own for it.
constexpr bool plain_wgmma_pair(bool delta, int rot, int ct, bool x_bf16) {
  return !delta && x_bf16 && rot == BF16 && ct == BF16;
}

// The fused pass's pairs on the split launch, as rotated_fused_tc.cu's
// fused_tiers: (BF16, BF16) and (BF16X3, BF16X3) in either mode on f32 X,
// (F32, F32) in either mode on f32 X, (BF16, BF16) in delta mode and
// (BF16, BF16X3) in either mode on bf16 X. Plain (BF16, BF16) on bf16 X
// is rotate_plain_wgmma_kernel's (the C entry); any other pair is refused
// before a launch.
template <int MODE>
cudaError_t split_pairs(int rot, int ct, int x_bf16, int dens, bool need_h, dim3 grid_a,
                        const DParams& d, dim3 grid_b, const BParams& b, cudaStream_t st) {
  if (!x_bf16) {
    if (rot == BF16 && ct == BF16)
      return launch_split<MODE, BF16, BF16, false>(dens, need_h, grid_a, d, grid_b, b, st);
    if constexpr (MODE == MODE_DELTA) {
      if (wgmma_pair(true, rot, ct, false))
        return rot == F32 ? launch_wgmma_split<F32>(dens, need_h, grid_a, d, grid_b, b, st)
                          : launch_wgmma_split<BF16X3>(dens, need_h, grid_a, d, grid_b, b, st);
    } else {
      if (rot == BF16X3 && ct == BF16X3)
        return launch_split<MODE, BF16X3, BF16X3, false>(dens, need_h, grid_a, d, grid_b, b, st);
      if (rot == F32 && ct == F32)
        return launch_split<MODE, F32, F32, false>(dens, need_h, grid_a, d, grid_b, b, st);
    }
  } else if (rot == BF16) {
    if (ct == BF16X3)
      return launch_split<MODE, BF16, BF16X3, true>(dens, need_h, grid_a, d, grid_b, b, st);
    if (ct == BF16 && MODE == MODE_DELTA)
      return launch_split<MODE_DELTA, BF16, BF16, true>(dens, need_h, grid_a, d, grid_b, b, st);
  }
  return cudaErrorInvalidValue;
}

// The fields launch A's two parameter sets share, from the C entries'
// arguments (the weights at w, X at x, the ll / dysq / pm / ysq partials).
template <class Params>
void fill_common(Params& a, int n, long long t, int need_ysq, double alpha, int cols, float* ll,
                 float* dysq, float* pm, float* ysq, long long stride) {
  a.n = n;
  a.kp = (n + A_KC - 1) / A_KC * A_KC;
  a.t = t;
  a.need_ysq = need_ysq;
  a.a = (float)alpha;
  a.m2a = (float)(-2.0 * alpha);
  a.mha = (float)(-alpha / 2.0);
  a.cols = cols;
  a.ll = ll;
  a.dysq = dysq;
  a.pm = pm;
  a.ysq = ysq;
  a.stride = stride;
}

// The parameters of the split launch A and of rotate_wgmma_kernel (w: the
// planes of the pair's tiers and mode, n_pad * kp apart for the split
// launch, in _wgmma_weights' layout for rotate_wgmma_kernel; f32 X, or
// bf16 X with x_bf16; launch_d and launch_g set the stage count n_kc).
DParams d_params(int x_bf16, int n, long long t, int need_ysq, double alpha, int cols,
                 const void* w, const void* x, float* ll, float* dysq, float* pm, float* ysq,
                 long long stride) {
  DParams d{};
  fill_common(d, n, t, need_ysq, alpha, cols, ll, dysq, pm, ysq, stride);
  d.vec = (t * (x_bf16 ? 2 : 4)) % 16 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  d.w = static_cast<const __nv_bfloat16*>(w);
  d.w_plane = (long long)(n + TILE - 1) / TILE * TILE * d.kp;
  d.x = x;
  return d;
}

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (the
// library is not linked); null where the installed CUDA lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) ==
                       cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// One chunk's workspace at `ws`: 2 (4 with H) operand planes at the
// contraction tier, plane (matrix * 2 + operand) * P + part: psi, Y (psi',
// Y^2), each as one bf16 plane, hi and lo bf16 planes, or at f32 as one
// f32 plane (P = 1), each (n_pad, cols).
struct Workspace {
  int ct, P, n_planes, n_pad;
  long long cols;
  unsigned char* base;
  Workspace(const void* ws, int ct_tier, int need_h, int n_pad_, long long cols_)
      : ct(ct_tier), P(ct_tier == F32 ? 1 : parts(ct_tier)), n_planes(2 * (1 + need_h) * P),
        n_pad(n_pad_), cols(cols_), base(static_cast<unsigned char*>(const_cast<void*>(ws))) {}
  long long bytes() const { return n_planes * (long long)n_pad * cols * (ct == F32 ? 4 : 2); }
  __nv_bfloat16* plane(int i) const {
    return i < n_planes && ct != F32 ? reinterpret_cast<__nv_bfloat16*>(base) + i * n_pad * cols
                                     : nullptr;
  }
  float* plane_f(int i) const {
    return i < n_planes && ct == F32 ? reinterpret_cast<float*>(base) + i * n_pad * cols : nullptr;
  }
  // The planes as one 3-D tensor map (element, row, plane) of boxes of
  // box_cols x box_rows elements in the given swizzle; false if the
  // encoding fails.
  bool map(CUtensorMap& tm, unsigned box_cols, unsigned box_rows, CUtensorMapSwizzle sw) const {
    const EncodeTiled encode = encode_tiled();
    const int elem = ct == F32 ? 4 : 2;
    const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n_pad, (cuuint64_t)n_planes};
    const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)cols * elem * n_pad};
    const cuuint32_t box[3] = {box_cols, box_rows, 1u}, unit[3] = {1u, 1u, 1u};
    return encode &&
           encode(&tm, ct == F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  // Launch B's parameters over this workspace: G's partials at g, H's at
  // h, and the planes as a tensor map of 128-row boxes in the 128-byte
  // swizzle (64 bf16 or 32 f32 columns); false if the encoding fails.
  bool b_params(int n, int group_cols, float* g, float* h, long long stride, BParams& b) const {
    b = BParams{};
    b.out[0] = g;
    b.out[1] = h;
    b.n = n;
    b.edge = n_pad / TILE;
    b.cols = group_cols;
    b.stride = stride;
    return map(b.tm, 128u / (ct == F32 ? 4 : 2), TILE, CU_TENSOR_MAP_SWIZZLE_128B);
  }
};

// rotate_plain_wgmma_kernel's parameters over the chunk workspace wk
// (launch A of plain bf16 on bf16 X), or with no workspace (wk null: the
// log-lik launch on bf16 X): W's tensor map (boxes of P_KC columns x TILE
// rows of the caller's zero-padded (n_pad, kp) bf16 plane) and, where X's
// rows are 16-byte aligned (vec), X's (boxes of P_BN columns x P_KC rows);
// W resident where kp <= P_RESIDENT_KP, and a ring as deep as the shared
// memory left allows. False if an encoding fails.
bool pw_params(int n, long long t, int need_ysq, double alpha, int cols, const void* w,
               const void* x, const Workspace* wk, float* ll, float* dysq, float* pm, float* ysq,
               long long stride, PwParams& p) {
  p = PwParams{};
  fill_common(p, n, t, need_ysq, alpha, cols, ll, dysq, pm, ysq, stride);
  p.n_ks = p.kp / P_KC;
  p.vec = (t * 2) % 16 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.loglik = wk == nullptr;
  if (wk) {
    p.psi = wk->plane(0);
    p.y = wk->plane(1);
    p.psid = wk->plane(2);
    p.y2 = wk->plane(3);
    p.ws_cols = wk->cols;
    if (!wk->map(p.omap, P_BN, P_OROWS, CU_TENSOR_MAP_SWIZZLE_128B)) return false;
  }
  p.resident = p.kp <= P_RESIDENT_KP;
  const int left = SM_SMEM - BLOCK_RESERVED - 1024 - plain_fixed_bytes(p.loglik) -
                   (p.resident ? p.n_ks * P_W_BOX : 0);
  const int stages = left / (P_NC * plain_stage_bytes(p.resident));
  p.stages = stages < P_MAX_STAGES ? stages : P_MAX_STAGES;
  const EncodeTiled encode = encode_tiled();
  if (!encode || p.stages < 2) return false;
  const int n_pad = (n + TILE - 1) / TILE * TILE;
  const cuuint32_t unit[2] = {1u, 1u};
  const cuuint64_t wdims[2] = {(cuuint64_t)p.kp, (cuuint64_t)n_pad};
  const cuuint64_t wstrides[1] = {(cuuint64_t)p.kp * 2};
  const cuuint32_t wbox[2] = {(cuuint32_t)P_KC, (cuuint32_t)TILE};
  if (encode(&p.wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdims, wstrides,
             wbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (!p.vec) return true;
  const cuuint64_t xdims[2] = {(cuuint64_t)t, (cuuint64_t)n};
  const cuuint64_t xstrides[1] = {(cuuint64_t)t * 2};
  const cuuint32_t xbox[2] = {(cuuint32_t)P_BN, (cuuint32_t)P_KC};
  return encode(&p.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdims,
                xstrides, xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The log-lik launch on f32 X (rotate_wgmma_kernel): where X's rows are
// 16-byte aligned (d.vec), X's tensor map of boxes of G_BN columns x G_KS
// rows (xtm). False if the encoding fails.
bool x_map(DParams& d) {
  if (!d.vec) return true;
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[2] = {1u, 1u};
  const cuuint64_t dims[2] = {(cuuint64_t)d.t, (cuuint64_t)d.n};
  const cuuint64_t strides[1] = {(cuuint64_t)d.t * 4};
  const cuuint32_t box[2] = {(cuuint32_t)G_BN, (cuuint32_t)G_KS};
  d.xtm = encode &&
          encode(&d.xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(d.x), dims, strides,
                 box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  return d.xtm;
}

bool bad_shape(int n, long long t, int cols, int n_parts, int density, long long stride,
               const void* w) {
  return n < 1 || n > STREAM_MAX_N || t < 1 || cols < TILE || cols % TILE != 0 ||
         (long long)n_parts != (t + cols - 1) / cols || density < TANH || density > CUBE ||
         stride < 1 || reinterpret_cast<std::uintptr_t>(w) % 16 != 0;
}

}  // namespace

extern "C" {

int picard_stream_max_n() { return STREAM_MAX_N; }

// The tile edge (W rows of a block of A, B's output tile edge) and the k
// depth the caller pads W to: the caller pads W to (n_pad, kp) with n_pad
// a multiple of the first and kp of the second, and sizes groups in whole
// tiles.
int picard_stream_tc_tile() { return TILE; }
int picard_stream_tc_kc() { return A_KC; }
// The k depth of a step of the wgmma launch A (its W layout's k blocks).
int picard_stream_wgmma_ks() { return G_KS; }
// 1 if the pair's launch A is rotate_wgmma_kernel, whose W the caller lays
// out as it reads it (wgmma_pair), else 0.
int picard_stream_wgmma_pair(int delta, int rot_tier, int ct_tier, int x_bf16) {
  return wgmma_pair(delta != 0, rot_tier, ct_tier, x_bf16 != 0);
}

// A line-search try of picard_streaming_fused_sums on the tensor cores:
// delta = 1 (delta mode, with M_old and dM = M_new - M_old) or 0 (plain
// mode, with M_new), the rotation at rot_tier and the contraction at
// ct_tier, on f32 X or (x_bf16 = 1) bf16 X, in one of the ten pairs of
// split_pairs and plain_wgmma_pair (an unknown pair returns
// cudaErrorInvalidValue and launches nothing). w: the weights' zero-padded
// (n_pad, kp) bf16 planes, each matrix's parts at rot_tier in order (one
// at BF16; hi, lo at BF16X3; hi, mid, lo at F32), M_old's then dM's in
// delta mode; x: (n, t) f32 or bf16; ws: the workspace, 2 (4 with H)
// operand planes at ct_tier (bf16; hi and lo bf16 at BF16X3; f32 at F32),
// each (n_pad, groups_per_chunk * cols). T is cut into n_parts groups of
// `cols` columns; group g's partial of each output is at out + g *
// stride.
int picard_streaming_fused_tc(int delta, int rot_tier, int ct_tier, int x_bf16, int density,
                              int need_h, int need_ysq, double alpha, int n, long long t, int cols,
                              int n_parts, int groups_per_chunk, const void* w, const void* x,
                              void* ws, float* dll, float* dysq, float* g, float* pm, float* h,
                              float* ysq, long long stride, void* stream) {
  if (ct_tier < F32 || ct_tier > BF16 || bad_shape(n, t, cols, n_parts, density, stride, w) ||
      groups_per_chunk < 1 || groups_per_chunk > MAX_GRID_Y || (need_ysq && (!dysq || !ysq)) ||
      (need_h && !h) || reinterpret_cast<std::uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_pad = (n + TILE - 1) / TILE * TILE;
  const Workspace wk(ws, ct_tier, need_h, n_pad, (long long)groups_per_chunk * cols);

  // Plain bf16 on bf16 X runs rotate_plain_wgmma_kernel; every other pair
  // the split launch.
  const bool dense = plain_wgmma_pair(delta != 0, rot_tier, ct_tier, x_bf16 != 0);
  PwParams a;
  DParams d{};
  if (dense) {
    if (!pw_params(n, t, need_ysq, alpha, cols, w, x, &wk, dll, dysq, pm, ysq, stride, a))
      return (int)cudaErrorInvalidValue;
  } else {
    d = d_params(x_bf16, n, t, need_ysq, alpha, cols, w, x, dll, dysq, pm, ysq, stride);
    for (int i = 0; i < 8; ++i) d.ws[i] = wk.plane(i);
    for (int i = 0; i < 4; ++i) d.wsf[i] = wk.plane_f(i);
    d.ws_cols = wk.cols;
  }

  BParams b;
  if (!wk.b_params(n, cols, g, h, stride, b)) return (int)cudaErrorInvalidValue;

  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  for (int g0 = 0; g0 < n_parts; g0 += groups_per_chunk) {
    const int ng = n_parts - g0 < groups_per_chunk ? n_parts - g0 : groups_per_chunk;
    a.g0 = d.g0 = b.g0 = g0;
    const dim3 grid_a(n_pad / TILE, ng), grid_b(b.edge * b.edge, ng, need_h ? 2 : 1);
    cudaError_t e;
    if (dense) {
      e = need_h ? launch_plain_wgmma<true, false>(density, grid_a, a, st)
                 : launch_plain_wgmma<false, false>(density, grid_a, a, st);
      if (e == cudaSuccess) e = launch_contract<BF16>(grid_b, b, st);
    } else {
      e = delta ? split_pairs<MODE_DELTA>(rot_tier, ct_tier, x_bf16, density, need_h, grid_a, d,
                                          grid_b, b, st)
                : split_pairs<MODE_PLAIN>(rot_tier, ct_tier, x_bf16, density, need_h, grid_a, d,
                                          grid_b, b, st);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Launch B alone, as picard_streaming_fused_tc runs it after launch A:
// G = psi Y^T and, with need_h, H = psi' (Y^2)^T over each group's
// columns at ct_tier, from a workspace the caller fills. ws holds
// ceil(n_parts / groups_per_chunk) chunks' workspaces back to back, each
// laid out as picard_streaming_fused_tc's (Workspace); group i of chunk c
// is group c * groups_per_chunk + i, its partial of G (H) at g (h) +
// group * stride. For the tests, chip_smoke.py and port_turns.py.
int picard_stream_contract_tc(int ct_tier, int need_h, int n, int cols, int n_parts,
                              int groups_per_chunk, const void* ws, float* g, float* h,
                              long long stride, void* stream) {
  if (ct_tier < F32 || ct_tier > BF16 || n < 1 || n > STREAM_MAX_N || cols < TILE ||
      cols % TILE != 0 || n_parts < 1 || groups_per_chunk < 1 || groups_per_chunk > MAX_GRID_Y ||
      stride < 1 || !g || (need_h && !h) || reinterpret_cast<std::uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_pad = (n + TILE - 1) / TILE * TILE;
  const long long ws_cols = (long long)groups_per_chunk * cols;
  const long long chunk_bytes = Workspace(ws, ct_tier, need_h, n_pad, ws_cols).bytes();
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  for (int g0 = 0, c = 0; g0 < n_parts; g0 += groups_per_chunk, ++c) {
    const int ng = n_parts - g0 < groups_per_chunk ? n_parts - g0 : groups_per_chunk;
    const Workspace wk(static_cast<const unsigned char*>(ws) + c * chunk_bytes, ct_tier, need_h,
                       n_pad, ws_cols);
    BParams b;
    if (!wk.b_params(n, cols, g, h, stride, b)) return (int)cudaErrorInvalidValue;
    b.g0 = g0;
    const cudaError_t e = launch_contract(ct_tier, dim3(b.edge * b.edge, ng, need_h ? 2 : 1), b, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// picard_streaming_loglik_sums' row sums on the tensor cores: ll = sum
// log_lik(M x), masked at columns >= t, and with need_ysq ysq = sum (M
// x)^2, one partial each per group at out + group index * stride, the
// wgmma launches in log-lik mode. tier = BF16: bf16 X,
// rotate_plain_wgmma_kernel; w: the (n_pad, kp) zero-padded bf16 copy of
// M. tier = F32: f32 X, rotate_wgmma_kernel<F32, MODE_LOGLIK>; w: the
// hi / mid / lo splits of M in _wgmma_weights' layout. T is cut into
// n_parts groups of `cols` columns, at most MAX_GRID_Y (one launch).
int picard_streaming_loglik_tc(int tier, int density, int need_ysq, double alpha, int n,
                               long long t, int cols, int n_parts, const void* w, const void* x,
                               float* ll, float* ysq, long long stride, void* stream) {
  if (!(tier == BF16 || tier == F32) || bad_shape(n, t, cols, n_parts, density, stride, w) ||
      n_parts > MAX_GRID_Y || !ll || (need_ysq && !ysq))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + TILE - 1) / TILE, n_parts);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (tier == BF16) {
    PwParams a;
    if (!pw_params(n, t, need_ysq, alpha, cols, w, x, nullptr, ll, nullptr, nullptr, ysq, stride,
                   a))
      return (int)cudaErrorInvalidValue;
    return (int)launch_plain_wgmma<false, true>(density, grid, a, st);
  }
  DParams d = d_params(0, n, t, need_ysq, alpha, cols, w, x, ll, nullptr, nullptr, ysq, stride);
  if (!x_map(d)) return (int)cudaErrorInvalidValue;
  return (int)launch_g<F32, MODE_LOGLIK, false>(density, grid, d, st);
}

}  // extern "C"
