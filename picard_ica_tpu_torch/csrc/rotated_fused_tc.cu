// Hand-written Hopper (sm_90a) kernel for the bf16 and bf16x3 tiers of
// picard_rotated_fused_sums (rotated_sums.cu routes every tier pair but
// (F32, F32) here). It replaces, for those tiers,
// picard_ica_tpu/ops/pallas_kernels.py rotated_fused_sums /
// _rotated_fused_kernel, which runs them on the TPU's matrix unit: one
// line-search try (the loss delta or absolute log-lik of M_new X, and the
// candidate's G, sum psi', H, sum Y^2) in ONE read of X.
//
// What bounds it on the card, at N = 64 and 2M columns: the tiers are
// exact bf16 products with f32 sums, so the products belong on the tensor
// cores (494.5 T bf16 FMA/s dense). Delta bf16x3: 2 rotations + 1
// contraction at 3 products each, 49 K FMAs a column (0.20 ms), against
// 256 bytes of f32 X a column (0.15 ms of HBM): at the ridge. Plain bf16
// on bf16 X: 8 K FMAs against 128 bytes (0.03 / 0.08 ms): bytes. Beside
// both, 1.3e8 density evaluations (tanh / exp / log1p on the FP32 pipes
// and the SFU) that no tensor core lifts.
//
// What the design does about it.
//   * Rotation and contraction on mma.sync m16n8k16 bf16 (mma_tiers.cuh):
//     bf16x3 is three products into one f32 accumulator. W (and dm in
//     delta mode) are split into bf16 hi/lo tiles once per block and read
//     with ldmatrix.
//   * X comes through a 2-stage cp.async ring (16-byte copies where every
//     row is 16-byte aligned, else 4-byte ones; bf16 X with unaligned rows
//     takes plain loads), zero-filled past N and T, so the next sub-tile
//     lands while the current one is used; 3 and 4 stages measured no
//     faster. f32 X is split into bf16 hi/lo as a warp loads its B
//     fragments; each element is split by the two warps that share its
//     column, not by eight.
//   * The density runs on the rotation's accumulator fragments in
//     registers, and the row sums stay there. Y, psi (and psi', Y^2 for H)
//     go to shared memory as bf16 hi/lo tiles, Y into the ring stage whose
//     X was just consumed; the contraction G += psi Y^T reads them with
//     ldmatrix, and each warp holds its 16 x 32 share of G (and H) in
//     registers across the block's columns.
//   * 8 warps a block, 2 blocks an SM (1 with H at bf16x3, whose tiles
//     take 96 KB besides the ring); three barriers a 64-column sub-tile.
//   * Tiles of 16 rows past N are skipped; padded rows and columns are
//     zeros, and psi', log_lik (nonzero at 0) are masked at padded columns.
//
// One partial per COLS columns (as the scalar kernels), written at
// out + block * stride, so the caller can fold all outputs in one pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "density.cuh"
#include "mma_tiers.cuh"

namespace {

constexpr int NMAX = 64;
constexpr int BT = 64;            // columns per sub-tile
constexpr int COLS = 2048;        // columns per partial (COLS_PER_BLOCK)
constexpr int THREADS = 256;
constexpr int LDB = 72;           // row stride (elements) of every bf16 tile: 144 B
constexpr int LDX = 68;           // row stride (floats) of an f32 X stage
constexpr int TILE = NMAX * LDB;  // elements of one bf16 tile
constexpr int TILE_BYTES = TILE * 2;
constexpr int RED_FLOATS = 4 * 4 * NMAX;  // row sums: type x column group x row
constexpr int STAGES = 2;                 // X sub-tiles in the cp.async ring
constexpr int SM_SMEM = 233472;           // shared memory of an SM for its blocks
constexpr int BLOCK_RESERVED = 1024;      // kept by the system per block
static_assert(COLS % BT == 0, "");

// Blocks an SM: 2, but 1 with H at bf16x3 (three pairs of hi/lo tiles).
constexpr int blocks_per_sm(bool need_h, bool ct_x3) { return need_h && ct_x3 ? 1 : 2; }

struct TcParams {
  int n, nr;  // components; live rows (n rounded up to 16)
  long long t;
  int need_ysq, vec;
  float a, m2a, mha;  // the density's constants, as in density.cuh
  const float* w;     // (n, n): M_old in delta mode, M_new in plain mode
  const float* dm;    // (n, n): M_new - M_old (delta mode)
  const void* x;      // (n, t) f32 or bf16, row-major
  float *ll, *dysq, *g, *pm, *h, *ysq;  // partial b at + b * stride
  long long stride;
};

template <bool DELTA, bool ROT_X3, bool CT_X3, bool XB, bool NEED_H>
struct TcLayout {
  static_assert(!(XB && ROT_X3), "bf16 X rotates at the bf16 tier");
  static constexpr int W_TILES = (DELTA ? 2 : 1) * (ROT_X3 ? 2 : 1);
  static constexpr int CT_TILES = CT_X3 ? 2 : 1;
  static constexpr int X_BYTES = XB ? TILE_BYTES : NMAX * LDX * 4;
  static constexpr int Y_BYTES = CT_TILES * TILE_BYTES;
  static constexpr int STAGE = X_BYTES > Y_BYTES ? X_BYTES : Y_BYTES;
  static constexpr int RING = W_TILES * TILE_BYTES;
  static constexpr int PSI = RING + STAGES * STAGE;
  static constexpr int RED = PSI + (NEED_H ? 3 : 1) * CT_TILES * TILE_BYTES;
  static constexpr int BYTES = RED + RED_FLOATS * 4;
  static_assert(blocks_per_sm(NEED_H, CT_X3) * (BYTES + BLOCK_RESERVED) <= SM_SMEM,
                "the blocks an SM fit its shared memory");
};

// Issue the copies of X columns [c0, c0 + BT), rows [0, nr), into `dst`;
// entries outside [0, n) x [0, t) are zero-filled. The caller commits.
template <bool XB>
__device__ __forceinline__ void load_x(unsigned char* dst, const TcParams& p, long long c0) {
  const int tid = threadIdx.x;
  if (XB) {
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(p.x);
    __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(dst);
    if (p.vec) {  // t % 8 == 0: an 8-element chunk is all in or all out
      for (int u = tid; u < p.nr * (BT / 8); u += THREADS) {
        const int r = u / (BT / 8), c = (u % (BT / 8)) * 8;
        const bool in = r < p.n && c0 + c < p.t;
        cp_async16_zfill(s + r * LDB + c, in ? x + r * p.t + c0 + c : x, in);
      }
    } else {  // rows not 4-byte aligned: plain loads
      for (int u = tid; u < p.nr * BT; u += THREADS) {
        const int r = u / BT, c = u % BT;
        const bool in = r < p.n && c0 + c < p.t;
        s[r * LDB + c] = in ? x[r * p.t + c0 + c] : __float2bfloat16_rn(0.f);
      }
    }
  } else {
    const float* x = reinterpret_cast<const float*>(p.x);
    float* s = reinterpret_cast<float*>(dst);
    if (p.vec) {  // t % 4 == 0
      for (int u = tid; u < p.nr * (BT / 4); u += THREADS) {
        const int r = u / (BT / 4), c = (u % (BT / 4)) * 4;
        const bool in = r < p.n && c0 + c < p.t;
        cp_async16_zfill(s + r * LDX + c, in ? x + r * p.t + c0 + c : x, in);
      }
    } else {
      for (int u = tid; u < p.nr * BT; u += THREADS) {
        const int r = u / BT, c = u % BT;
        const bool in = r < p.n && c0 + c < p.t;
        cp_async4_zfill(s + r * LDX + c, in ? x + r * p.t + c0 + c : x, in);
      }
    }
  }
}

// Two values as bf16 tiers into tile(s) at element offset `off`: hi (and
// lo when X3).
template <bool X3>
__device__ __forceinline__ void store_pair(__nv_bfloat16* hi_tile, int off, float a, float b) {
  uint32_t hi, lo;
  if (X3) {
    split_pair(a, b, hi, lo);
    *reinterpret_cast<uint32_t*>(hi_tile + TILE + off) = lo;
  } else {
    hi = pack_bf16(a, b);
  }
  *reinterpret_cast<uint32_t*>(hi_tile + off) = hi;
}

// Warps: in the rotation, warp w owns rows 32 (w / 4) .. + 31 (two 16-row
// m-tiles) and sub-tile columns 16 (w % 4) .. + 15 (two 8-column n-tiles);
// in the contraction, rows 16 (w % 4) .. + 15 of G and columns 32 (w / 4)
// .. + 31 (four n-tiles).
template <bool DELTA, bool ROT_X3, bool CT_X3, bool XB, int D, bool NEED_H>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(NEED_H, CT_X3))
    rotated_fused_tc_kernel(TcParams p) {
  using L = TcLayout<DELTA, ROT_X3, CT_X3, XB, NEED_H>;
  constexpr int S = STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_lo = w_hi + (ROT_X3 ? TILE : 0);
  __nv_bfloat16* d_hi = w_hi + (ROT_X3 ? 2 : 1) * TILE;  // DELTA
  __nv_bfloat16* d_lo = d_hi + (ROT_X3 ? TILE : 0);
  unsigned char* ring = smem + L::RING;
  __nv_bfloat16* psi_s = reinterpret_cast<__nv_bfloat16*>(smem + L::PSI);
  __nv_bfloat16* psid_s = psi_s + L::CT_TILES * TILE;  // NEED_H
  __nv_bfloat16* y2_s = psid_s + L::CT_TILES * TILE;   // NEED_H
  float* red = reinterpret_cast<float*>(smem + L::RED);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int n = p.n, nr = p.nr;
  const long long c_begin = (long long)blockIdx.x * COLS;
  const long long c_end = c_begin + COLS < p.t ? c_begin + COLS : p.t;
  const int n_sub = (int)((c_end - c_begin + BT - 1) / BT);

  // The ring: sub-tile s lands in stage s % S, S - 1 sub-tiles ahead; one
  // commit group per sub-tile (empty past the block's last).
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_sub) load_x<XB>(ring + i * L::STAGE, p, c_begin + (long long)i * BT);
    cp_async_commit_group();
  }

  // W (and dm) split once; zeros outside [0, n)^2, so rows past n rotate
  // to Y = 0 and columns past n meet the zero-filled X rows.
  for (int idx = tid; idx < NMAX * NMAX; idx += THREADS) {
    const int i = idx / NMAX, k = idx % NMAX;
    const bool in = i < n && k < n;
    const Sp s = split<ROT_X3 ? BF16X3 : BF16>(in ? p.w[i * n + k] : 0.f);
    w_hi[i * LDB + k] = __float2bfloat16_rn(s.hi);
    if (ROT_X3) w_lo[i * LDB + k] = __float2bfloat16_rn(s.lo);
    if (DELTA) {
      const Sp sd = split<ROT_X3 ? BF16X3 : BF16>(in ? p.dm[i * n + k] : 0.f);
      d_hi[i * LDB + k] = __float2bfloat16_rn(sd.hi);
      if (ROT_X3) d_lo[i * LDB + k] = __float2bfloat16_rn(sd.lo);
    }
  }

  const int rh = warp >> 2, cg = warp & 3;  // rotation: row half, column group
  const int cm = warp & 3, cj = warp >> 2;  // contraction: m-tile, column half
  const bool live[2] = {32 * rh < nr, 32 * rh + 16 < nr};
  const int k_steps = nr / 16;

  // Row sums over the block's columns: [m-tile][row g / g + 8].
  float rs_ll[2][2] = {}, rs_pm[2][2] = {}, rs_ysq[2][2] = {}, rs_dysq[2][2] = {};
  float g_acc[4][4] = {}, h_acc[4][4] = {};

  for (int s = 0; s < n_sub; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // sub-tile s landed everywhere; stage (s - 1) % S is free
    const int ahead = s + S - 1;
    if (ahead < n_sub) load_x<XB>(ring + (ahead % S) * L::STAGE, p, c_begin + (long long)ahead * BT);
    cp_async_commit_group();
    unsigned char* stage = ring + (s % S) * L::STAGE;
    const long long c0 = c_begin + (long long)s * BT;

    // Rotation: acc = M x (accd = dm x) over this warp's 32 x 16 block.
    float acc[2][2][4] = {}, accd[2][2][4] = {};
    if (live[0]) {
      for (int ks = 0; ks < k_steps; ++ks) {
        uint32_t bh[2][2], bl[2][2];
        if (XB) {
          uint32_t r[4];
          const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage);
          ldmatrix_x4_trans(r, ldm_a_addr(xs + 16 * ks * LDB + 16 * cg, LDB, lane));
          bh[0][0] = r[0], bh[0][1] = r[1], bh[1][0] = r[2], bh[1][1] = r[3];
          bl[0][0] = bl[0][1] = bl[1][0] = bl[1][1] = 0u;
        } else {
          const float* xs = reinterpret_cast<const float*>(stage) + (16 * ks + 2 * q) * LDX;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* col = xs + 16 * cg + 8 * nt + g;
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              const float v0 = col[(8 * kh) * LDX], v1 = col[(8 * kh + 1) * LDX];
              if (ROT_X3) {
                split_pair(v0, v1, bh[nt][kh], bl[nt][kh]);
              } else {
                bh[nt][kh] = pack_bf16(v0, v1);
                bl[nt][kh] = 0u;
              }
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (!live[mi]) continue;
          const int a_off = (32 * rh + 16 * mi) * LDB + 16 * ks;
          uint32_t ah[4], al[4] = {};
          ldmatrix_x4(ah, ldm_a_addr(w_hi + a_off, LDB, lane));
          if (ROT_X3) ldmatrix_x4(al, ldm_a_addr(w_lo + a_off, LDB, lane));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_tier<ROT_X3>(acc[mi][nt], ah, al, bh[nt][0], bh[nt][1], bl[nt][0], bl[nt][1]);
          if (DELTA) {
            ldmatrix_x4(ah, ldm_a_addr(d_hi + a_off, LDB, lane));
            if (ROT_X3) ldmatrix_x4(al, ldm_a_addr(d_lo + a_off, LDB, lane));
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma_tier<ROT_X3>(accd[mi][nt], ah, al, bh[nt][0], bh[nt][1], bl[nt][0], bl[nt][1]);
          }
        }
      }
    }
    __syncthreads();  // every read of this stage's X is done

    // Density on the fragments, masked row sums, and the bf16 tiles: Y
    // into this stage, psi (psi', Y^2) into theirs.
    __nv_bfloat16* y_s = reinterpret_cast<__nv_bfloat16*>(stage);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (!live[mi]) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 16 * cg + 8 * nt + 2 * q;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 32 * rh + 16 * mi + g + 8 * hh;
          float yv[2], ps[2], pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = c0 + col + e < p.t;
            float y, psi, psid, ll, dysq = 0.f;
            if (DELTA) {
              const float y_old = acc[mi][nt][2 * hh + e], dy = accd[mi][nt][2 * hh + e];
              y = y_old + dy;
              score_der_loglik_delta<D>(p, y_old, dy, psi, psid, ll);
              dysq = (2.f * y_old + dy) * dy;
            } else {
              y = acc[mi][nt][2 * hh + e];
              score_der_loglik<D>(p, y, psi, psid, ll);
            }
            if (valid) {
              rs_ll[mi][hh] += ll;
              rs_pm[mi][hh] += psid;
              if (p.need_ysq) {
                rs_ysq[mi][hh] += y * y;
                if (DELTA) rs_dysq[mi][hh] += dysq;
              }
            }
            yv[e] = y;
            ps[e] = psi;  // psi(0) == 0 at padded columns
            pd[e] = valid ? psid : 0.f;
          }
          const int off = row * LDB + col;
          store_pair<CT_X3>(y_s, off, yv[0], yv[1]);
          store_pair<CT_X3>(psi_s, off, ps[0], ps[1]);
          if (NEED_H) {
            store_pair<CT_X3>(psid_s, off, pd[0], pd[1]);
            store_pair<CT_X3>(y2_s, off, yv[0] * yv[0], yv[1] * yv[1]);
          }
        }
      }
    }
    __syncthreads();  // the tiles are complete

    // Contraction: G += psi Y^T (H += psi' (Y^2)^T) over the sub-tile.
    if (16 * cm < nr) {
#pragma unroll
      for (int ks = 0; ks < BT / 16; ++ks) {
        const int a_off = 16 * cm * LDB + 16 * ks;
        uint32_t ah[4], al[4] = {}, dh[4], dl[4] = {};
        ldmatrix_x4(ah, ldm_a_addr(psi_s + a_off, LDB, lane));
        if (CT_X3) ldmatrix_x4(al, ldm_a_addr(psi_s + TILE + a_off, LDB, lane));
        if (NEED_H) {
          ldmatrix_x4(dh, ldm_a_addr(psid_s + a_off, LDB, lane));
          if (CT_X3) ldmatrix_x4(dl, ldm_a_addr(psid_s + TILE + a_off, LDB, lane));
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int j0 = 32 * cj + 16 * np;
          if (j0 >= nr) continue;
          const int b_off = j0 * LDB + 16 * ks;
          uint32_t bh[4], bl[4] = {};
          ldmatrix_x4(bh, ldm_b_addr(y_s + b_off, LDB, lane));
          if (CT_X3) ldmatrix_x4(bl, ldm_b_addr(y_s + TILE + b_off, LDB, lane));
          mma_tier<CT_X3>(g_acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_tier<CT_X3>(g_acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
          if (NEED_H) {
            ldmatrix_x4(bh, ldm_b_addr(y2_s + b_off, LDB, lane));
            if (CT_X3) ldmatrix_x4(bl, ldm_b_addr(y2_s + TILE + b_off, LDB, lane));
            mma_tier<CT_X3>(h_acc[2 * np], dh, dl, bh[0], bh[1], bl[0], bl[1]);
            mma_tier<CT_X3>(h_acc[2 * np + 1], dh, dl, bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
    }
  }

  // Epilogue: the block's partial. Row sums: the quad's lanes, then the
  // four column groups in order, through shared memory.
  const long long base = (long long)blockIdx.x * p.stride;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
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
        const int row = 32 * rh + 16 * mi + g + 8 * hh;
#pragma unroll
        for (int k = 0; k < 4; ++k) red[(k * 4 + cg) * NMAX + row] = v[k];
      }
    }
  }
  __syncthreads();
  if (tid < n) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* r = red + k * 4 * NMAX + tid;
      v[k] = ((r[0] + r[NMAX]) + r[2 * NMAX]) + r[3 * NMAX];
    }
    p.ll[base + tid] = v[0];
    p.pm[base + tid] = v[1];
    if (p.need_ysq) {
      p.ysq[base + tid] = v[2];
      p.dysq[base + tid] = DELTA ? v[3] : v[2];
    }
  }
  if (16 * cm < nr) {
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

template <bool DELTA, bool ROT_X3, bool CT_X3, bool XB, int D, bool NEED_H>
cudaError_t launch_tc(const TcParams& p, int nb, cudaStream_t st) {
  constexpr int smem = TcLayout<DELTA, ROT_X3, CT_X3, XB, NEED_H>::BYTES;
  auto kernel = rotated_fused_tc_kernel<DELTA, ROT_X3, CT_X3, XB, D, NEED_H>;
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

template <bool DELTA, bool ROT_X3, bool CT_X3, bool XB, bool NEED_H>
cudaError_t by_density(int dens, const TcParams& p, int nb, cudaStream_t st) {
  switch (dens) {
    case TANH: return launch_tc<DELTA, ROT_X3, CT_X3, XB, TANH, NEED_H>(p, nb, st);
    case EXP: return launch_tc<DELTA, ROT_X3, CT_X3, XB, EXP, NEED_H>(p, nb, st);
    case CUBE: return launch_tc<DELTA, ROT_X3, CT_X3, XB, CUBE, NEED_H>(p, nb, st);
  }
  return cudaErrorInvalidValue;
}

template <bool DELTA, bool ROT_X3, bool CT_X3, bool XB>
cudaError_t by_h(int need_h, int dens, const TcParams& p, int nb, cudaStream_t st) {
  return need_h ? by_density<DELTA, ROT_X3, CT_X3, XB, true>(dens, p, nb, st)
                : by_density<DELTA, ROT_X3, CT_X3, XB, false>(dens, p, nb, st);
}

// The tier pairs the wrapper sends: (BF16, BF16) on f32 or bf16 X,
// (BF16X3, BF16X3) on f32 X, (BF16, BF16X3) on bf16 X.
template <bool DELTA>
cudaError_t by_tiers(int rot, int ct, int x_bf16, int need_h, int dens, const TcParams& p,
                     int nb, cudaStream_t st) {
  if (rot == BF16 && ct == BF16)
    return x_bf16 ? by_h<DELTA, false, false, true>(need_h, dens, p, nb, st)
                  : by_h<DELTA, false, false, false>(need_h, dens, p, nb, st);
  if (rot == BF16X3 && ct == BF16X3 && !x_bf16)
    return by_h<DELTA, true, true, false>(need_h, dens, p, nb, st);
  if (rot == BF16 && ct == BF16X3 && x_bf16)
    return by_h<DELTA, false, true, true>(need_h, dens, p, nb, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Called by picard_rotated_fused_sums (rotated_sums.cu) for every tier
// pair but (F32, F32); its arguments, already checked there.
int rotated_fused_tc(int delta, int rot_tier, int ct_tier, int density, int need_h,
                     int need_ysq, double alpha, int n, long long t, int x_bf16,
                     const float* w, const float* dm, const void* x, float* dll,
                     float* dysq, float* g, float* pm, float* h, float* ysq,
                     long long stride, int nb, void* stream) {
  TcParams p;
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
  p.dm = dm;
  p.x = x;
  p.ll = dll;
  p.dysq = dysq;
  p.g = g;
  p.pm = pm;
  p.h = h;
  p.ysq = ysq;
  p.stride = stride;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = delta
      ? by_tiers<true>(rot_tier, ct_tier, x_bf16, need_h, density, p, nb, st)
      : by_tiers<false>(rot_tier, ct_tier, x_bf16, need_h, density, p, nb, st);
  return (int)e;
}
