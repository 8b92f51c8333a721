// Hand-written Hopper (sm_90a) kernel for the three data passes of the
// Picard-O core loop at N <= 64, and their C entries. One tensor-core
// kernel in four modes serves them all:
//
//   picard_rotated_fused_sums   replaces picard_ica_tpu/ops/pallas_kernels.py
//                               rotated_fused_sums / _rotated_fused_kernel:
//                               one line-search try (the loss delta or the
//                               absolute log-lik of M_new X, and the
//                               candidate's G, sum psi', H, sum Y^2) in ONE
//                               read of X; MODE_DELTA and MODE_PLAIN, but
//                               delta f32 and delta bf16x3 on f32 X without
//                               H, the main path's tries, which run
//                               rotated_fused_wgmma.cu's wgmma kernel;
//   picard_rotated_moments_sums replaces rotated_moments_sums /
//                               _rotated_moments_kernel (G, sum psi', H,
//                               sum Y^2 of Y = W X); MODE_MOMENTS, the
//                               plain mode without the log-lik;
//   picard_rotated_loglik_sums  replaces rotated_loglik_sums /
//                               _rotated_loglik_kernel (sum log_lik(M X),
//                               sum (M X)^2 per row); MODE_LOGLIK, the
//                               rotation and a log-lik epilogue, no
//                               contraction.
//
// What bounds it on the card, at N = 64 and 2M columns: the tiers are
// exact bf16 products with f32 sums, so the products belong on the tensor
// cores (494.5 T bf16 FMA/s dense). Delta f32, the TPU's HIGHEST: 2
// rotations + 1 contraction at 6 products each, 74 K FMAs a column (0.30
// ms), against 256 bytes of f32 X a column (0.15 ms of HBM): products.
// Delta bf16x3: 3 products each, 37 K FMAs (0.15 ms): at the ridge. Plain
// bf16 on bf16 X: 8 K FMAs against 128 bytes (0.03 / 0.08 ms): bytes.
// The moments on f32 X: 1 rotation + 1 contraction at 6 products (0.20
// ms): products; the log-lik on f32 X: 1 rotation at 6 (0.10 ms) against
// 0.15 ms of HBM: bytes, and on bf16 X 0.08 ms of HBM. Beside them, 1.3e8
// density evaluations (tanh / exp / log1p on the FP32 pipes and the SFU)
// that no tensor core lifts.
//
// What the design does about it.
//   * Rotation and contraction on mma.sync m16n8k16 bf16 (mma_tiers.cuh):
//     bf16x3 is three products, f32 six. W (and dm in delta mode) are
//     split into bf16 tiles once per block and read with ldmatrix.
//   * The bf16x3 tier's sums: each 16-deep step's three products go to a
//     fresh accumulator added in f32 to nearest, in the rotation and the
//     contraction; so does each 16-column step's product in the bf16
//     tier's contraction. Chained into one accumulator (12 MMAs a
//     rotation, 384 a block's contraction at bf16x3, 128 at bf16), the
//     sums drifted toward zero against f64 past twice the plain version's
//     error (PERF.md).
//   * The f32 tier's sums. The tensor cores round each MMA's sum toward
//     zero, so a chain of MMAs drifts by up to an ulp a link, always the
//     same way, and a row sum over 2M columns of Y^2 would carry it.
//     The rotation therefore puts hi on a fixed-point grid per row of W
//     (dm) and per column of X (2^-7 of its largest magnitude, mma_tiers.cuh
//     grid_sigma), so every hi*hi sum over the 64 rows is exact; mid and
//     lo split the rest elementwise, and their five products go to an
//     accumulator of their own, added last to nearest. The contraction
//     splits psi and Y elementwise and sums each 16-column step's six
//     products (small first, hi*hi last) in a fresh accumulator that is
//     added in f32, to nearest, to its 256-column group's sum, and the
//     groups to G: 16 + 8 rounded adds a partial, not 128, in every mode
//     whose contraction runs at the f32 tier.
//   * The tier pairs (rotation, contraction) of the TPU kernels: the fused
//     pass's (bf16, bf16) on f32 or bf16 X, (bf16x3, bf16x3) and (f32,
//     f32) on f32 X, (bf16, bf16x3) on bf16 X; the moments' (f32, f32) on
//     f32 X and (bf16, f32) on bf16 X (the single-pass bf16 rotation of
//     w.astype(x.dtype), contractions at HIGHEST); the log-lik's f32 on
//     f32 X and bf16 on bf16 X.
//   * X comes through a 2-stage cp.async ring (16-byte copies where every
//     row is 16-byte aligned, else 4-byte ones; bf16 X with unaligned rows
//     takes plain loads), zero-filled past N and T, so the next sub-tile
//     lands while the current one is used; 3 and 4 stages measured no
//     faster. The f32 tier splits each landed sub-tile of X once, all
//     threads together, into three part tiles in psi's space (free until
//     the density), which the warps read with ldmatrix; the bf16 tiers
//     split f32 X as a warp loads its B fragments, each element by the two
//     warps that share its column.
//   * The density runs on the rotation's accumulator fragments in
//     registers, and the row sums stay there. Y, psi (and psi', Y^2 for H)
//     go to shared memory as bf16 part tiles, Y into the ring stage whose
//     X was just consumed; the contraction G += psi Y^T reads them with
//     ldmatrix, and each warp holds its 16 x 32 share of G (and H) in
//     registers across the block's columns. The log-lik mode stores no
//     tile and has no contraction: one barrier a sub-tile (three at the
//     f32 tier), against three (five) in the other modes.
//   * 8 warps a block, 2 blocks an SM (1 with H at bf16x3, whose tiles
//     take 96 KB besides the ring, and with H at an f32 contraction, 198
//     KB). An f32 contraction without H (the main path's final stage and
//     its moments) takes 32-column sub-tiles with 16 rows a warp in the
//     rotation, and so does the f32 log-lik: three tiles an operand then
//     take 103 KB and 128 registers, so two blocks, 16 warps, share an SM
//     and one's density runs while another's products do. The log-lik
//     mode's blocks take 62 KB at the f32 tier and 31 KB at bf16, so 3
//     and 4 of them share an SM.
//   * Tiles of 16 rows past N are skipped; padded rows and columns are
//     zeros, and psi', log_lik (nonzero at 0) are masked at padded columns.
//     The f32 rotation runs all 64 rows, so that its loops unroll and its
//     independent MMA chains interleave.
//
// One partial per COLS columns, written at out + block * stride (the
// outputs side by side in one buffer), so the caller can fold all
// outputs in one pass. No float atomics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (picard_ica_tpu_torch/ops/_build.py).
// Every C entry returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "density.cuh"
#include "mma_tiers.cuh"

namespace {

constexpr int NMAX = 64;
constexpr int COLS = 2048;        // columns per partial (COLS_PER_BLOCK)
constexpr int GROUP_COLS = 256;   // columns of a group of the f32 tier's G sums
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LDB = 72;           // row stride (elements) of a W tile: 144 B
constexpr int TILE_W = NMAX * LDB;  // elements of one W tile
constexpr int STAGES = 2;                 // X sub-tiles in the cp.async ring
constexpr int SM_SMEM = 233472;           // shared memory of an SM for its blocks
constexpr int BLOCK_RESERVED = 1024;      // kept by the system per block

// What a launch computes (the table of the header).
enum Mode { MODE_DELTA = 0, MODE_PLAIN = 1, MODE_MOMENTS = 2, MODE_LOGLIK = 3 };

__host__ __device__ constexpr bool contracts(int mode) { return mode != MODE_LOGLIK; }

// The rotation's warp shape: RG row groups of 64 / RG rows (MI 16-row
// m-tiles) x CGS column groups of 16 columns. 2 row groups over 64-column
// sub-tiles; an f32 contraction without H takes 4 row groups over
// 32-column sub-tiles, whose tiles are half as wide, so that two blocks
// (16 warps) share an SM. The log-lik mode, which has no contraction,
// takes the shape of its rotation tier (CT = ROT).
template <int CT, bool NEED_H>
struct Shape {
  static constexpr int RG = CT == F32 && !NEED_H ? 4 : 2;
  static constexpr int MI = NMAX / RG / 16;
  static constexpr int CGS = WARPS / RG;
  static constexpr int BT = 16 * CGS;           // columns per sub-tile
  static constexpr int LDT = BT + 8;            // row stride (elements) of a Y / psi tile
  static constexpr int TILE = NMAX * LDT;       // elements of one Y / psi tile
  static constexpr int LDX = BT + 4;            // row stride (floats) of an f32 X stage
  static constexpr int RED_FLOATS = 4 * CGS * NMAX;  // row sums: type x column group x row
  static_assert(COLS % BT == 0, "");
  static_assert(RED_FLOATS >= 2 * NMAX && RED_FLOATS >= WARPS * BT,
                "the row grids of W and dm, and the column maxima of X, fit the row-sum space");
};

// Blocks an SM: 2, but 1 with H at an f32 or bf16x3 contraction (three
// tiles, or pairs of tiles, for each of psi, psi', Y, Y^2). The log-lik
// mode, whose blocks hold no contraction's tiles, takes 3 at the f32
// tier and 4 at bf16 (in turns on an H100, 9 % and 13 % faster than 2).
constexpr int blocks_per_sm(int mode, bool need_h, int ct) {
  if (!contracts(mode)) return ct == BF16 ? 4 : 3;
  return need_h && ct != BF16 ? 1 : 2;
}

struct TcParams {
  int n, nr;  // components; live rows (n rounded up to 16)
  long long t;
  int need_ysq, vec;
  float a, m2a, mha;  // the density's constants, as in density.cuh
  const float* w;     // (n, n): M_old in delta mode, else M_new (W)
  const float* dm;    // (n, n): M_new - M_old (delta mode)
  const void* x;      // (n, t) f32 or bf16, row-major
  float *ll, *dysq, *g, *pm, *h, *ysq;  // partial b at + b * stride
  long long stride;
};

// ROT, CT: the tiers (density.cuh) of the rotation and the contraction;
// an operand at a tier is parts(tier) bf16 tiles. The psi space holds the
// psi (psi', Y^2) tiles, and at the f32 rotation tier the split of X
// before them; the log-lik mode stores no other tile.
template <int MODE, int ROT, int CT, bool XB, bool NEED_H>
struct TcLayout {
  using Sh = Shape<CT, NEED_H>;
  static_assert(!(XB && ROT != BF16), "bf16 X rotates at the bf16 tier");
  static_assert(contracts(MODE) || (CT == ROT && !NEED_H),
                "the log-lik mode takes its rotation tier's shape and no H");
  static constexpr int W_TILES = (MODE == MODE_DELTA ? 2 : 1) * parts(ROT);
  static constexpr int CT_TILES = parts(CT);
  static constexpr int T_BYTES = Sh::TILE * 2;
  static constexpr int X_BYTES = XB ? T_BYTES : NMAX * Sh::LDX * 4;
  static constexpr int Y_BYTES = contracts(MODE) ? CT_TILES * T_BYTES : 0;
  static constexpr int STAGE = X_BYTES > Y_BYTES ? X_BYTES : Y_BYTES;
  static constexpr int RING = W_TILES * TILE_W * 2;
  static constexpr int PSI = RING + STAGES * STAGE;
  static constexpr int PSI_TILES = contracts(MODE) ? (NEED_H ? 3 : 1) * CT_TILES * T_BYTES : 0;
  static constexpr int X_PARTS = ROT == F32 ? 3 * T_BYTES : 0;
  static constexpr int RED = PSI + (PSI_TILES > X_PARTS ? PSI_TILES : X_PARTS);
  static constexpr int BYTES = RED + Sh::RED_FLOATS * 4;
  static_assert(blocks_per_sm(MODE, NEED_H, CT) * (BYTES + BLOCK_RESERVED) <= SM_SMEM,
                "the blocks an SM fit its shared memory");
};

// Issue the copies of X columns [c0, c0 + BT), rows [0, nr), into `dst`;
// entries outside [0, n) x [0, t) are zero-filled. The caller commits.
template <class Sh, bool XB>
__device__ __forceinline__ void load_x(unsigned char* dst, const TcParams& p, int nr,
                                       long long c0) {
  constexpr int BT = Sh::BT;
  const int tid = threadIdx.x;
  if (XB) {
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(p.x);
    __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(dst);
    if (p.vec) {  // t % 8 == 0: an 8-element chunk is all in or all out
      for (int u = tid; u < nr * (BT / 8); u += THREADS) {
        const int r = u / (BT / 8), c = (u % (BT / 8)) * 8;
        const bool in = r < p.n && c0 + c < p.t;
        cp_async16_zfill(s + r * Sh::LDT + c, in ? x + r * p.t + c0 + c : x, in);
      }
    } else {  // rows not 4-byte aligned: plain loads
      for (int u = tid; u < nr * BT; u += THREADS) {
        const int r = u / BT, c = u % BT;
        const bool in = r < p.n && c0 + c < p.t;
        s[r * Sh::LDT + c] = in ? x[r * p.t + c0 + c] : __float2bfloat16_rn(0.f);
      }
    }
  } else {
    const float* x = reinterpret_cast<const float*>(p.x);
    float* s = reinterpret_cast<float*>(dst);
    if (p.vec) {  // t % 4 == 0
      for (int u = tid; u < nr * (BT / 4); u += THREADS) {
        const int r = u / (BT / 4), c = (u % (BT / 4)) * 4;
        const bool in = r < p.n && c0 + c < p.t;
        cp_async16_zfill(s + r * Sh::LDX + c, in ? x + r * p.t + c0 + c : x, in);
      }
    } else {
      for (int u = tid; u < nr * BT; u += THREADS) {
        const int r = u / BT, c = u % BT;
        const bool in = r < p.n && c0 + c < p.t;
        cp_async4_zfill(s + r * Sh::LDX + c, in ? x + r * p.t + c0 + c : x, in);
      }
    }
  }
}

// Two values as their parts' tiles at element offset `off` (part q at
// + q * TILE).
template <int TIER, int TILE>
__device__ __forceinline__ void store_pair(__nv_bfloat16* tile, int off, float a, float b) {
  uint32_t v[parts(TIER)];
  split_parts<TIER>(a, b, v);
#pragma unroll
  for (int q = 0; q < parts(TIER); ++q)
    *reinterpret_cast<uint32_t*>(tile + q * TILE + off) = v[q];
}

// One weight into its parts' tiles at `dst` (part q at + q * TILE_W); at
// the f32 tier hi lies on its row's grid `sigma`.
template <int TIER>
__device__ __forceinline__ void split_weight(float v, float sigma, __nv_bfloat16* dst) {
  float r[3] = {};
  if constexpr (TIER == F32) {
    r[0] = grid_round(v, sigma);
    r[1] = bf16_round(v - r[0]);
    r[2] = bf16_round(v - r[0] - r[1]);
  } else {
    const Sp s = split<TIER>(v);
    r[0] = s.hi;
    r[1] = s.lo;
  }
#pragma unroll
  for (int q = 0; q < parts(TIER); ++q) dst[q * TILE_W] = __float2bfloat16_rn(r[q]);
}

// The f32 tier's rotation operand: the X sub-tile at `xs` (f32, row
// stride LDX) split once into its three bf16 part tiles at `xp` (part u at
// + u * TILE, [k][n] with row stride LDT), hi on the grid of its column's
// largest magnitude. Each thread takes a column pair over NMAX / GROUPS
// rows; the column maxima meet through `part_max` (WARPS x BT floats).
// Ends with the parts written by this thread; the caller syncs.
template <class Sh>
__device__ __forceinline__ void split_x_parts(const float* xs, __nv_bfloat16* xp,
                                              float* part_max) {
  constexpr int BT = Sh::BT, PAIRS = BT / 2, GROUPS = THREADS / PAIRS;
  constexpr int ROWS = NMAX / GROUPS;
  static_assert(NMAX % GROUPS == 0 && 32 % PAIRS == 0, "");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = 2 * (tid % PAIRS), r0 = (tid / PAIRS) * ROWS;
  float2 v[ROWS];
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    v[r] = *reinterpret_cast<const float2*>(xs + (r0 + r) * Sh::LDX + c);
    m0 = fmaxf(m0, fabsf(v[r].x));
    m1 = fmaxf(m1, fabsf(v[r].y));
  }
#pragma unroll
  for (int o = PAIRS; o < 32; o *= 2) {  // the warp's row groups
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  if (lane < PAIRS) {
    part_max[warp * BT + c] = m0;
    part_max[warp * BT + c + 1] = m1;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    m0 = fmaxf(m0, part_max[w * BT + c]);
    m1 = fmaxf(m1, part_max[w * BT + c + 1]);
  }
  const float s0 = grid_sigma(m0), s1 = grid_sigma(m1);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float h0 = grid_round(v[r].x, s0), h1 = grid_round(v[r].y, s1);
    uint32_t u[3];
    u[0] = pack_bf16(h0, h1);  // exact
    split_pair(v[r].x - h0, v[r].y - h1, u[1], u[2]);
    __nv_bfloat16* dst = xp + (r0 + r) * Sh::LDT + c;
#pragma unroll
    for (int q = 0; q < 3; ++q) *reinterpret_cast<uint32_t*>(dst + q * Sh::TILE) = u[q];
  }
}

// Warps: in the rotation, warp w owns rows 16 MI (w / CGS) .. + 16 MI - 1
// (MI 16-row m-tiles) and sub-tile columns 16 (w % CGS) .. + 15 (two
// 8-column n-tiles); in the contraction, rows 16 (w % 4) .. + 15 of G and
// columns 32 (w / 4) .. + 31 (four n-tiles).
template <int MODE, int ROT, int CT, bool XB, int D, bool NEED_H>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(MODE, NEED_H, CT))
    rotated_fused_tc_kernel(TcParams p) {
  using L = TcLayout<MODE, ROT, CT, XB, NEED_H>;
  using Sh = Shape<CT, NEED_H>;
  constexpr bool DELTA = MODE == MODE_DELTA, CONTRACT = contracts(MODE);
  constexpr bool LL = MODE != MODE_MOMENTS;       // log-lik row sums
  constexpr bool FUSED = MODE <= MODE_PLAIN;      // the dysq output
  constexpr int S = STAGES, BT = Sh::BT, CGS = Sh::CGS, MI = Sh::MI;
  constexpr int LDT = Sh::LDT, TILE = Sh::TILE, LDX = Sh::LDX;
  constexpr int RP = parts(ROT), CP = parts(CT);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // RP tiles
  __nv_bfloat16* d_s = w_s + RP * TILE_W;                        // DELTA: RP tiles
  unsigned char* ring = smem + L::RING;
  __nv_bfloat16* psi_s = reinterpret_cast<__nv_bfloat16*>(smem + L::PSI);
  __nv_bfloat16* psid_s = psi_s + CP * TILE;  // NEED_H
  __nv_bfloat16* y2_s = psid_s + CP * TILE;   // NEED_H
  float* red = reinterpret_cast<float*>(smem + L::RED);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // The f32 tier runs all 64 rows: with no tile skipped, its loops unroll
  // and the independent MMA chains interleave.
  const int n = p.n, nr = ROT == F32 ? NMAX : p.nr;
  const long long c_begin = (long long)blockIdx.x * COLS;
  const long long c_end = c_begin + COLS < p.t ? c_begin + COLS : p.t;
  const int n_sub = (int)((c_end - c_begin + BT - 1) / BT);

  // The ring: sub-tile s lands in stage s % S, S - 1 sub-tiles ahead; one
  // commit group per sub-tile (empty past the block's last).
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_sub) load_x<Sh, XB>(ring + i * L::STAGE, p, nr, c_begin + (long long)i * BT);
    cp_async_commit_group();
  }

  // The f32 tier's row grids of W and dm (in the row-sum space, which the
  // epilogue takes over after the last barrier of the main loop).
  float* w_sig = red;
  if constexpr (ROT == F32) {
    if (tid < (DELTA ? 2 : 1) * NMAX) {
      const int i = tid % NMAX;
      const float* m = tid < NMAX ? p.w : p.dm;
      float mx = 0.f;
      if (i < n)
        for (int k = 0; k < n; ++k) mx = fmaxf(mx, fabsf(m[i * n + k]));
      w_sig[tid] = grid_sigma(mx);
    }
    __syncthreads();
  }

  // W (and dm) split once; zeros outside [0, n)^2, so rows past n rotate
  // to Y = 0 and columns past n meet the zero-filled X rows.
  for (int idx = tid; idx < NMAX * NMAX; idx += THREADS) {
    const int i = idx / NMAX, k = idx % NMAX;
    const bool in = i < n && k < n;
    split_weight<ROT>(in ? p.w[i * n + k] : 0.f, w_sig[i], w_s + i * LDB + k);
    if (DELTA) split_weight<ROT>(in ? p.dm[i * n + k] : 0.f, w_sig[NMAX + i], d_s + i * LDB + k);
  }

  const int rh = warp / CGS, cg = warp % CGS;  // rotation: row group, column group
  const int cm = warp & 3, cj = warp >> 2;     // contraction: m-tile, column half
  bool live[MI];  // the warp's m-tiles that hold rows below nr
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) live[mi] = 16 * (MI * rh + mi) < nr;
  const int k_steps = nr / 16;

  // Row sums over the block's columns: [m-tile][row g / g + 8].
  float rs_ll[MI][2] = {}, rs_pm[MI][2] = {}, rs_ysq[MI][2] = {}, rs_dysq[MI][2] = {};
  float g_acc[4][4] = {}, h_acc[4][4] = {};
  // An f32-tier contraction (the moments, and the fused modes' f32 tier)
  // sums G (H) in two levels: each 16-column step into a group's sum
  // (g_grp), each group of GROUP_COLS columns into G; 8 + 16 rounded f32
  // adds a partial, not 128.
  constexpr bool GROUPED = CONTRACT && CT == F32;
  constexpr int GROUP_SUBS = GROUP_COLS / BT;  // sub-tiles a group
  static_assert(GROUP_COLS % BT == 0 && COLS % GROUP_COLS == 0, "");
  float g_grp[4][4] = {}, h_grp[4][4] = {};

  for (int s = 0; s < n_sub; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // sub-tile s landed everywhere; stage (s - 1) % S is free
    const int ahead = s + S - 1;
    if (ahead < n_sub)
      load_x<Sh, XB>(ring + (ahead % S) * L::STAGE, p, nr, c_begin + (long long)ahead * BT);
    cp_async_commit_group();
    unsigned char* stage = ring + (s % S) * L::STAGE;
    const long long c0 = c_begin + (long long)s * BT;
    // The f32 tier splits X once into part tiles in psi's space, which is
    // free until the density (the previous contraction ended before the
    // barrier above), with the column maxima in the row-sum space.
    __nv_bfloat16* x_parts = psi_s;
    if constexpr (ROT == F32) {
      split_x_parts<Sh>(reinterpret_cast<const float*>(stage), x_parts, red);
      __syncthreads();
    }

    // Rotation: acc = M x (accd = dm x) over this warp's 16 MI x 16 block;
    // the f32 tier's small products in accs (accds), added last. The
    // bf16x3 tier sums each 16-deep k step's three products in a fresh
    // accumulator, added to acc in f32 to nearest, so that no MMA chain
    // into acc is longer than three links.
    float acc[MI][2][4] = {}, accd[MI][2][4] = {}, accs[MI][2][4] = {}, accds[MI][2][4] = {};
    auto rotate = [](float (&d)[4], float (&small)[4], const uint32_t (&af)[RP][4],
                     const uint32_t (&bf)[RP][2]) {
      if constexpr (ROT == BF16X3) {
        float t[4] = {};
        mma_tier<ROT>(t, t, af, bf);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] += t[e];
      } else {
        mma_tier<ROT>(d, small, af, bf);
      }
    };
    if (live[0]) {
      for (int ks = 0; ks < k_steps; ++ks) {
        uint32_t b[2][RP][2];  // [n-tile][part][b0 / b1]
        if constexpr (XB || ROT == F32) {
          const __nv_bfloat16* xs = XB ? reinterpret_cast<const __nv_bfloat16*>(stage) : x_parts;
#pragma unroll
          for (int u = 0; u < RP; ++u) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, ldm_a_addr(xs + u * TILE + 16 * ks * LDT + 16 * cg, LDT, lane));
            b[0][u][0] = r[0], b[0][u][1] = r[1], b[1][u][0] = r[2], b[1][u][1] = r[3];
          }
        } else {
          const float* xs = reinterpret_cast<const float*>(stage) + (16 * ks + 2 * q) * LDX;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* col = xs + 16 * cg + 8 * nt + g;
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              uint32_t v[RP];
              split_parts<ROT>(col[(8 * kh) * LDX], col[(8 * kh + 1) * LDX], v);
#pragma unroll
              for (int u = 0; u < RP; ++u) b[nt][u][kh] = v[u];
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if (!live[mi]) continue;
          const int a_off = 16 * (MI * rh + mi) * LDB + 16 * ks;
          uint32_t a[RP][4];
#pragma unroll
          for (int u = 0; u < RP; ++u) ldmatrix_x4(a[u], ldm_a_addr(w_s + u * TILE_W + a_off, LDB, lane));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) rotate(acc[mi][nt], accs[mi][nt], a, b[nt]);
          if (DELTA) {
#pragma unroll
            for (int u = 0; u < RP; ++u) ldmatrix_x4(a[u], ldm_a_addr(d_s + u * TILE_W + a_off, LDB, lane));
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) rotate(accd[mi][nt], accds[mi][nt], a, b[nt]);
          }
        }
      }
    }
    // The log-lik mode writes no tile, so the next sub-tile's first
    // barrier is the only one it needs.
    if constexpr (CONTRACT) __syncthreads();  // every read of this stage's X is done

    // Density on the fragments, masked row sums, and the bf16 tiles: Y
    // into this stage, psi (psi', Y^2) into theirs.
    __nv_bfloat16* y_s = reinterpret_cast<__nv_bfloat16*>(stage);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (!live[mi]) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 16 * cg + 8 * nt + 2 * q;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 16 * (MI * rh + mi) + g + 8 * hh;
          float yv[2], ps[2], pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = 2 * hh + e;
            const bool valid = c0 + col + e < p.t;
            float y, psi = 0.f, psid = 0.f, ll = 0.f, dysq = 0.f;
            // The f32 tier: the small products' sum, then hi*hi's.
            const float y0 = ROT == F32 ? accs[mi][nt][f] + acc[mi][nt][f] : acc[mi][nt][f];
            if constexpr (DELTA) {
              const float dy = ROT == F32 ? accds[mi][nt][f] + accd[mi][nt][f] : accd[mi][nt][f];
              y = y0 + dy;
              score_der_loglik_delta<D>(p, y0, dy, psi, psid, ll);
              dysq = (2.f * y0 + dy) * dy;
            } else if constexpr (MODE == MODE_PLAIN) {
              y = y0;
              score_der_loglik<D>(p, y, psi, psid, ll);
            } else if constexpr (MODE == MODE_MOMENTS) {
              y = y0;
              score_der<D>(p, y, psi, psid);
            } else {
              y = y0;
              ll = log_lik<D>(p, y);
            }
            if (valid) {
              if (LL) rs_ll[mi][hh] += ll;
              if (CONTRACT) rs_pm[mi][hh] += psid;
              if (p.need_ysq) {
                rs_ysq[mi][hh] += y * y;
                if (DELTA) rs_dysq[mi][hh] += dysq;
              }
            }
            yv[e] = y;
            ps[e] = psi;  // psi(0) == 0 at padded columns
            pd[e] = valid ? psid : 0.f;
          }
          if constexpr (CONTRACT) {
            const int off = row * LDT + col;
            store_pair<CT, TILE>(y_s, off, yv[0], yv[1]);
            store_pair<CT, TILE>(psi_s, off, ps[0], ps[1]);
            if (NEED_H) {
              store_pair<CT, TILE>(psid_s, off, pd[0], pd[1]);
              store_pair<CT, TILE>(y2_s, off, yv[0] * yv[0], yv[1] * yv[1]);
            }
          }
        }
      }
    }
    if constexpr (CONTRACT) __syncthreads();  // the tiles are complete

    // Contraction: G += psi Y^T (H += psi' (Y^2)^T) over the sub-tile.
    // Every tier sums each 16-column step's six (three, one) products in a
    // fresh accumulator and adds it to G in f32, to nearest: a block's
    // 2,048 columns chained into G would be 384 MMAs at bf16x3 and 128 at
    // bf16, each rounded toward zero. The moments mode adds it to its
    // group's sum instead, and that to G at the group's end.
    if (CONTRACT && 16 * cm < nr) {
#pragma unroll
      for (int ks = 0; ks < BT / 16; ++ks) {
        const int a_off = 16 * cm * LDT + 16 * ks;
        uint32_t a[CP][4], ad[CP][4];
#pragma unroll
        for (int u = 0; u < CP; ++u) {
          ldmatrix_x4(a[u], ldm_a_addr(psi_s + u * TILE + a_off, LDT, lane));
          if (NEED_H) ldmatrix_x4(ad[u], ldm_a_addr(psid_s + u * TILE + a_off, LDT, lane));
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int j0 = 32 * cj + 16 * np;
          if (j0 >= nr) continue;
          const int b_off = j0 * LDT + 16 * ks;
          uint32_t b[2][CP][2];  // [n-tile][part][b0 / b1]
          auto load_b = [&](const __nv_bfloat16* tile) {
#pragma unroll
            for (int u = 0; u < CP; ++u) {
              uint32_t r[4];
              ldmatrix_x4(r, ldm_b_addr(tile + u * TILE + b_off, LDT, lane));
              b[0][u][0] = r[0], b[0][u][1] = r[1], b[1][u][0] = r[2], b[1][u][1] = r[3];
            }
          };
          auto contract = [&](float (&dst)[4][4], const uint32_t (&af)[CP][4]) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              float(&d)[4] = dst[2 * np + nt];
              float t[4] = {};
              mma_tier<CT>(t, t, af, b[nt]);
#pragma unroll
              for (int e = 0; e < 4; ++e) d[e] += t[e];
            }
          };
          load_b(y_s);
          contract(GROUPED ? g_grp : g_acc, a);
          if (NEED_H) {
            load_b(y2_s);
            contract(GROUPED ? h_grp : h_acc, ad);
          }
        }
      }
      if (GROUPED && ((s + 1) % GROUP_SUBS == 0 || s + 1 == n_sub)) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            g_acc[nt][e] += g_grp[nt][e];
            g_grp[nt][e] = 0.f;
            if (NEED_H) {
              h_acc[nt][e] += h_grp[nt][e];
              h_grp[nt][e] = 0.f;
            }
          }
        }
      }
    }
  }

  // Epilogue: the block's partial. Row sums: the quad's lanes, then the
  // column groups in order, through shared memory.
  const long long base = (long long)blockIdx.x * p.stride;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (!live[mi]) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v[4] = {rs_ll[mi][hh], rs_pm[mi][hh], rs_ysq[mi][hh], rs_dysq[mi][hh]};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 1);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 2);
      }
      if (q == 0) {
        const int row = 16 * (MI * rh + mi) + g + 8 * hh;
#pragma unroll
        for (int k = 0; k < 4; ++k) red[(k * CGS + cg) * NMAX + row] = v[k];
      }
    }
  }
  __syncthreads();
  if (tid < n) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* r = red + k * CGS * NMAX + tid;
      v[k] = r[0];
#pragma unroll
      for (int c = 1; c < CGS; ++c) v[k] += r[c * NMAX];
    }
    if (LL) p.ll[base + tid] = v[0];
    if (CONTRACT) p.pm[base + tid] = v[1];
    if (p.need_ysq) {
      p.ysq[base + tid] = v[2];
      if (FUSED) p.dysq[base + tid] = DELTA ? v[3] : v[2];
    }
  }
  if (CONTRACT && 16 * cm < nr) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * cm + g + 8 * (e >> 1), j = 32 * cj + 8 * nt + 2 * q + (e & 1);
        if (i < n && j < n) {
          p.g[base + i * n + j] = g_acc[nt][e];
          if (NEED_H) p.h[base + i * n + j] = h_acc[nt][e];
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int MODE, int ROT, int CT, bool XB, int D, bool NEED_H>
cudaError_t launch_tc(const TcParams& p, int nb, cudaStream_t st) {
  constexpr int smem = TcLayout<MODE, ROT, CT, XB, NEED_H>::BYTES;
  auto kernel = rotated_fused_tc_kernel<MODE, ROT, CT, XB, D, NEED_H>;
  // The shared-memory opt-in, once per device.
  static bool opted_in[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES || !opted_in[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) opted_in[device] = true;
  }
  kernel<<<nb, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int MODE, int ROT, int CT, bool XB, bool NEED_H>
cudaError_t by_density(int dens, const TcParams& p, int nb, cudaStream_t st) {
  switch (dens) {
    case TANH: return launch_tc<MODE, ROT, CT, XB, TANH, NEED_H>(p, nb, st);
    case EXP: return launch_tc<MODE, ROT, CT, XB, EXP, NEED_H>(p, nb, st);
    case CUBE: return launch_tc<MODE, ROT, CT, XB, CUBE, NEED_H>(p, nb, st);
  }
  return cudaErrorInvalidValue;
}

// A pair that runs rotated_fused_wgmma.cu's kernel without H
// (core_wgmma_pair) keeps only its instantiation with H here.
template <int MODE, int ROT, int CT, bool XB>
cudaError_t by_h(int need_h, int dens, const TcParams& p, int nb, cudaStream_t st) {
  if constexpr (core_wgmma_pair(MODE == MODE_DELTA, ROT, CT, XB, false))
    return need_h ? by_density<MODE, ROT, CT, XB, true>(dens, p, nb, st) : cudaErrorInvalidValue;
  else
    return need_h ? by_density<MODE, ROT, CT, XB, true>(dens, p, nb, st)
                  : by_density<MODE, ROT, CT, XB, false>(dens, p, nb, st);
}

// The fused pass's tier pairs: (BF16, BF16) on f32 or bf16 X, (BF16X3,
// BF16X3) and (F32, F32) on f32 X, (BF16, BF16X3) on bf16 X; in delta mode
// (BF16X3, BF16X3) and (F32, F32) on f32 X only with H (without,
// picard_rotated_fused_wgmma).
template <int MODE>
cudaError_t fused_tiers(int rot, int ct, int x_bf16, int need_h, int dens, const TcParams& p,
                        int nb, cudaStream_t st) {
  if (rot == BF16 && ct == BF16)
    return x_bf16 ? by_h<MODE, BF16, BF16, true>(need_h, dens, p, nb, st)
                  : by_h<MODE, BF16, BF16, false>(need_h, dens, p, nb, st);
  if (rot == BF16X3 && ct == BF16X3 && !x_bf16)
    return by_h<MODE, BF16X3, BF16X3, false>(need_h, dens, p, nb, st);
  if (rot == F32 && ct == F32 && !x_bf16)
    return by_h<MODE, F32, F32, false>(need_h, dens, p, nb, st);
  if (rot == BF16 && ct == BF16X3 && x_bf16)
    return by_h<MODE, BF16, BF16X3, true>(need_h, dens, p, nb, st);
  return cudaErrorInvalidValue;
}

TcParams make_params(int n, long long t, int need_ysq, int x_bf16, double alpha,
                     const float* w, const void* x, long long stride) {
  TcParams p = {};
  p.n = n;
  p.nr = (n + 15) / 16 * 16;
  p.t = t;
  p.need_ysq = need_ysq;
  const long long row_bytes = t * (x_bf16 ? 2 : 4);
  p.vec = row_bytes % 16 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  p.a = (float)alpha;
  p.m2a = (float)(-2.0 * alpha);
  p.mha = (float)(-alpha / 2.0);
  p.w = w;
  p.x = x;
  p.stride = stride;
  return p;
}

bool bad_shape(int n, long long t, int nb, long long stride) {
  return n < 1 || n > NMAX || t < 1 || stride < 1 || (long long)nb != (t + COLS - 1) / COLS;
}

}  // namespace

extern "C" {

int picard_max_n() { return NMAX; }

int picard_cols_per_block() { return COLS; }

const char* picard_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Fused line-search try. delta = 1: dll = sum [log_lik(M_new x) -
// log_lik(M_old x)] (analytic form), dysq = sum (2 y_old + dy) dy, with w
// = M_old and dm = M_new - M_old. delta = 0 (plain): dll = sum
// log_lik(M_new x), dysq = sum (M_new x)^2, with w = M_new (dm unused).
// Block b writes its partials at out + b * stride.
int picard_rotated_fused_sums(int delta, int rot_tier, int ct_tier, int density, int need_h,
                              int need_ysq, double alpha, int n, long long t, int x_bf16,
                              const float* w, const float* dm, const void* x, float* dll,
                              float* dysq, float* g, float* pm, float* h, float* ysq,
                              long long stride, int nb, void* stream) {
  if (bad_shape(n, t, nb, stride)) return (int)cudaErrorInvalidValue;
  TcParams p = make_params(n, t, need_ysq, x_bf16, alpha, w, x, stride);
  p.dm = dm;
  p.ll = dll;
  p.dysq = dysq;
  p.g = g;
  p.pm = pm;
  p.h = h;
  p.ysq = ysq;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = delta
      ? fused_tiers<MODE_DELTA>(rot_tier, ct_tier, x_bf16, need_h, density, p, nb, st)
      : fused_tiers<MODE_PLAIN>(rot_tier, ct_tier, x_bf16, need_h, density, p, nb, st);
  return (int)e;
}

// Moments of Y = W x: rot_tier F32 on f32 X, BF16 on bf16 X (W rounded
// to bf16); the contractions at the f32 tier, as the TPU kernel's
// HIGHEST dots.
int picard_rotated_moments_sums(int rot_tier, int density, int need_h, int need_ysq,
                                double alpha, int n, long long t, int x_bf16, const float* w,
                                const void* x, float* g, float* pm, float* h, float* ysq,
                                long long stride, int nb, void* stream) {
  if (bad_shape(n, t, nb, stride)) return (int)cudaErrorInvalidValue;
  TcParams p = make_params(n, t, need_ysq, x_bf16, alpha, w, x, stride);
  p.g = g;
  p.pm = pm;
  p.h = h;
  p.ysq = ysq;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (rot_tier == F32 && !x_bf16)
    e = by_h<MODE_MOMENTS, F32, F32, false>(need_h, density, p, nb, st);
  else if (rot_tier == BF16 && x_bf16)
    e = by_h<MODE_MOMENTS, BF16, F32, true>(need_h, density, p, nb, st);
  return (int)e;
}

// Row sums of log_lik(M x) and (optionally) (M x)^2: rot_tier F32 on
// f32 X, BF16 on bf16 X.
int picard_rotated_loglik_sums(int rot_tier, int density, int need_ysq, double alpha, int n,
                               long long t, int x_bf16, const float* m, const void* x,
                               float* ll, float* ysq, long long stride, int nb, void* stream) {
  if (bad_shape(n, t, nb, stride)) return (int)cudaErrorInvalidValue;
  TcParams p = make_params(n, t, need_ysq, x_bf16, alpha, m, x, stride);
  p.ll = ll;
  p.ysq = ysq;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (rot_tier == F32 && !x_bf16)
    e = by_density<MODE_LOGLIK, F32, F32, false, false>(density, p, nb, st);
  else if (rot_tier == BF16 && x_bf16)
    e = by_density<MODE_LOGLIK, BF16, BF16, true, false>(density, p, nb, st);
  return (int)e;
}

}  // extern "C"
