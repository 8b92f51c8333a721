// Hand-written Hopper (sm_90a) kernels for one route of
// picard_streaming_fused_sums: the plain mode (absolute log-lik) at the
// bf16 tier on bf16 X, which the default staged schedule runs as its first
// stage at N > 64 (and the moments hand-off on that stage's X). They
// replace, for that route, picard_ica_tpu/ops/pallas_kernels.py
// streaming_fused_sums / _streaming_fused_kernel; every other mode and
// tier stays on streaming_sums.cu's scalar kernel.
//
// What it computes, for Y = bf16(M_new) X with bf16 operands and f32 sums:
// the row sums dll = sum log_lik(Y), pm = sum psi'(Y) (both masked at
// columns >= T) and, with need_ysq, ysq = dysq = sum Y^2; G = bf16(psi(Y))
// bf16(Y)^T and, with need_h, H = bf16(psi'(Y)) bf16(Y^2)^T, f32 sums. The
// TPU kernel keeps Y in f32 and rounds psi, Y and Y^2 to bf16 only inside
// its contraction, so storing them as bf16 computes the same function.
//
// What bounds it on the card: 2 N^2 T bf16 FMAs (3 N^2 T with H), one
// rotation and one contraction (at 256 x 2M 2.6e11, 0.53 ms of the tensor
// cores' 494.5 T FMA/s), against X's bytes read once (1 GB at 256 x 2M,
// 0.31 ms of HBM); beside them N T density evaluations on the FP32 pipes
// and the SFU (5.1e8 at 256 x 2M).
//
// What the design does about it: two GEMM-shaped launches, each a plain
// tile loop on mma.sync m16n8k16 (mma_tiers.cuh) fed by a cp.async ring,
// so that the products run on the tensor cores and the density runs once
// per element. Both run two blocks of 8 warps an SM, so one block's
// density or stores overlap another's products, and take 64-deep k
// stages (four MMA k-steps a barrier); 128-column tiles in A at one block
// an SM, and 32-deep stages, measured slower (PERF.md).
//   * Launch A (rotate_density_kernel): one block owns a TILE-row block of
//     W and one group of `cols` consecutive columns, and walks the group's
//     A_BT-column tiles in order. Per tile, Y[TILE x A_BT] = W X on the
//     tensor cores, k over N in A_KC-deep stages (W, copied by the caller
//     into a zero-padded bf16 (n_pad, kp) matrix, is the A operand; X, (N,
//     T) row-major, the B operand read with ldmatrix.trans; 16-byte copies
//     where T % 8 == 0, else plain loads, zero-filled past N and T). The
//     density runs on the accumulator fragments; the row sums stay in
//     registers across the group's tiles, so each (group, row) partial is
//     a sequential f32 sum with no atomics. psi and Y (with H also psi' and
//     Y^2) go to a bf16 workspace of (n_pad, ws_cols) matrices, exact zeros
//     at padded rows and columns, so launch B needs no mask and psi'(0) !=
//     0 never reaches H.
//   * Launch B (contract_kernel): G = psi Y^T (H = psi' (Y^2)^T) as a
//     plain NT GEMM whose K is the group's columns; both operands are
//     K-contiguous and read with ldmatrix. One block per TILE x TILE
//     output tile and group keeps its tile in registers over the group's
//     columns and writes it once into the group's partial. The tensor
//     cores round each MMA's sum toward zero, so each 32 columns are
//     summed in a fresh accumulator (a chain of two MMAs) and added to the
//     tile in f32, to nearest.
//   * Both launches cut T into the same n_parts groups, so the caller's
//     packed partial buffer and its one fold launch (ops/kernels.py
//     _fold_outputs) are those of the scalar kernel. Where the workspace
//     for all of T would pass the caller's cap, the C entry runs A then B
//     per chunk of `groups_per_chunk` whole groups.
//
// Every C entry returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#include "density.cuh"
#include "mma_tiers.cuh"

extern "C" int picard_stream_max_n();

namespace {

constexpr int TILE = 128;          // W rows of a block of A; B's output tile edge
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NI = 4;              // a warp's 32 columns: 4 n-tiles
constexpr int MAX_GRID_Y = 65535;

// Launch A's tile: TILE rows x A_BT columns over A_WR x A_WC warps, each
// 16 A_MI rows x 32 columns; k in A_KC-deep stages of an A_STAGES ring.
constexpr int A_BT = 64;
constexpr int A_KC = 64;
constexpr int A_STAGES = 4;
constexpr int A_WC = A_BT / 32;
constexpr int A_WR = WARPS / A_WC;
constexpr int A_MI = TILE / A_WR / 16;
constexpr int A_LDK = A_KC + 8;    // row stride (elements) of the [row][k] W stage tile
constexpr int LDN = A_BT + 8;      // row stride of the [k][column] X stage tile
static_assert(TILE % A_BT == 0 && A_WR * A_WC == WARPS, "launch A's warp layout");

// Launch A's shared memory: the ring (a W and an X stage tile each), then
// the row sums of the column warps (3 sums x A_WC warps x TILE rows).
constexpr int A_W_STAGE = TILE * A_LDK;  // elements
constexpr int A_X_STAGE = A_KC * LDN;
constexpr int A_RED = A_STAGES * (A_W_STAGE + A_X_STAGE) * 2;
constexpr int A_BYTES = A_RED + 3 * A_WC * TILE * 4;
constexpr int BLOCKS = 2;                // blocks an SM, in both launches
constexpr int SM_SMEM = 233472;          // shared memory of an SM for its blocks
constexpr int BLOCK_RESERVED = 1024;     // kept by the system per block

// Launch B: a warp's 64 x 32 share of the output tile, 4 m-tiles x 4
// n-tiles; k in B_KC-deep stages of a B_STAGES ring (two [row][k] tiles a
// stage), summed 32 columns at a time in a fresh accumulator.
constexpr int MI = 4;
constexpr int B_KC = 64;
constexpr int B_STAGES = 3;
constexpr int B_LDK = B_KC + 8;
constexpr int B_STAGE = TILE * B_LDK;
constexpr int B_BYTES = B_STAGES * 2 * B_STAGE * 2;
static_assert(A_KC % 16 == 0 && B_KC % 32 == 0, "stage depths");
static_assert(BLOCKS * (A_BYTES + BLOCK_RESERVED) <= SM_SMEM &&
                  BLOCKS * (B_BYTES + BLOCK_RESERVED) <= SM_SMEM,
              "two blocks of either launch fit an SM's shared memory");

struct AParams {
  int n, kp;  // components; k extent of the padded W (a multiple of A_KC)
  long long t;
  int need_ysq, vec;
  float a, m2a, mha;           // the density's constants, as in density.cuh
  const __nv_bfloat16* w;      // (n_pad, kp) bf16 M_new, zero-padded
  const __nv_bfloat16* x;      // (n, t) bf16, row-major
  __nv_bfloat16 *psi, *y, *psid, *y2;  // workspace, (n_pad, ws_cols) each
  long long ws_cols;
  int cols, g0;                // columns per group; this chunk's first group
  float *ll, *dysq, *pm, *ysq; // group g's partial at + g * stride
  long long stride;
};

struct BParams {
  const __nv_bfloat16 *psi, *y, *psid, *y2;  // the workspace
  float *g, *h;
  int n, edge;  // components; output tiles along a side (n_pad / TILE)
  long long ws_cols;
  int cols, g0;
  long long stride;
};

// Start launch A's copies for ring step `it` (tile it / n_kc, k-stage it %
// n_kc) into `ws` / `xs`; the caller commits.
__device__ __forceinline__ void load_a(const AParams& p, __nv_bfloat16* ws, __nv_bfloat16* xs,
                                       int it, int n_kc, long long col0) {
  const int tid = threadIdx.x;
  const int tile = it / n_kc, k0 = (it % n_kc) * A_KC;
  // W: TILE rows x A_KC in 16-byte pieces, always in bounds.
  const __nv_bfloat16* w = p.w + (long long)blockIdx.x * TILE * p.kp + k0;
  for (int u = tid; u < TILE * (A_KC / 8); u += THREADS) {
    const int r = u / (A_KC / 8), c = (u % (A_KC / 8)) * 8;
    cp_async16_zfill(ws + r * A_LDK + c, w + (long long)r * p.kp + c, true);
  }
  // X: A_KC rows x A_BT columns, zero past n and t.
  const long long c0 = col0 + (long long)tile * A_BT;
  if (p.vec) {  // t % 8 == 0: an 8-column piece is all in or all out
    for (int u = tid; u < A_KC * (A_BT / 8); u += THREADS) {
      const int kr = u / (A_BT / 8), c = (u % (A_BT / 8)) * 8;
      const bool in = k0 + kr < p.n && c0 + c < p.t;
      cp_async16_zfill(xs + kr * LDN + c, in ? p.x + (long long)(k0 + kr) * p.t + c0 + c : p.x,
                       in);
    }
  } else {  // rows not 16-byte aligned: plain loads
    for (int u = tid; u < A_KC * A_BT; u += THREADS) {
      const int kr = u / A_BT, c = u % A_BT;
      const bool in = k0 + kr < p.n && c0 + c < p.t;
      xs[kr * LDN + c] = in ? p.x[(long long)(k0 + kr) * p.t + c0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Warps: in launch A, warp w owns rows 16 A_MI (w / A_WC) .. and columns
// 32 (w % A_WC) .. + 31 of the block's TILE x A_BT tile; in launch B, rows
// 64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31 of the TILE x TILE
// output tile.
template <int D, bool NEED_H>
__global__ void __launch_bounds__(THREADS, BLOCKS) rotate_density_kernel(AParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + A_RED);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / A_WC, wc = warp % A_WC;
  const int row0 = blockIdx.x * TILE;
  const int grp = p.g0 + blockIdx.y;
  const long long col0 = (long long)grp * p.cols;        // the group's first column of X
  const long long ws0 = (long long)blockIdx.y * p.cols;  // and of the workspace
  const int n_kc = p.kp / A_KC;
  const int total = (p.cols / A_BT) * n_kc;

  auto w_stage = [&](int s) { return ring + s * (A_W_STAGE + A_X_STAGE); };
  auto x_stage = [&](int s) { return ring + s * (A_W_STAGE + A_X_STAGE) + A_W_STAGE; };

#pragma unroll
  for (int i = 0; i < A_STAGES - 1; ++i) {
    if (i < total) load_a(p, w_stage(i), x_stage(i), i, n_kc, col0);
    cp_async_commit_group();
  }

  float acc[A_MI][NI][4] = {};
  // Row sums over the group: [m-tile][row g / g + 8].
  float rs_ll[A_MI][2] = {}, rs_pm[A_MI][2] = {}, rs_ysq[A_MI][2] = {};

  for (int it = 0; it < total; ++it) {
    cp_async_wait<A_STAGES - 2>();
    __syncthreads();  // step it landed everywhere; stage (it - 1) % A_STAGES is free
    const int ahead = it + A_STAGES - 1;
    if (ahead < total)
      load_a(p, w_stage(ahead % A_STAGES), x_stage(ahead % A_STAGES), ahead, n_kc, col0);
    cp_async_commit_group();

    const __nv_bfloat16* ws = w_stage(it % A_STAGES);
    const __nv_bfloat16* xs = x_stage(it % A_STAGES);
#pragma unroll
    for (int ks = 0; ks < A_KC / 16; ++ks) {
      uint32_t b[NI][2];
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ldm_a_addr(xs + 16 * ks * LDN + 32 * wc + 16 * np, LDN, lane));
        b[2 * np][0] = r[0], b[2 * np][1] = r[1], b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < A_MI; ++mi) {
        uint32_t a[4];
        ldmatrix_x4(a, ldm_a_addr(ws + (16 * A_MI * wr + 16 * mi) * A_LDK + 16 * ks, A_LDK, lane));
#pragma unroll
        for (int nt = 0; nt < NI; ++nt) mma_bf16(acc[mi][nt], a, b[nt][0], b[nt][1]);
      }
    }
    if (it % n_kc != n_kc - 1) continue;

    // The tile is done: density on the fragments, masked row sums, and the
    // bf16 workspace (4-byte stores of column pairs).
    const int tile = it / n_kc;
    const long long c0 = col0 + (long long)tile * A_BT;
    const long long wcol = ws0 + (long long)tile * A_BT;
#pragma unroll
    for (int mi = 0; mi < A_MI; ++mi) {
#pragma unroll
      for (int nt = 0; nt < NI; ++nt) {
        const int cl = 32 * wc + 8 * nt + 2 * q;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 16 * A_MI * wr + 16 * mi + g + 8 * hh;
          float yv[2], ps[2], pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = acc[mi][nt][2 * hh + e];
            float psi, psid, ll;
            score_der_loglik<D>(p, y, psi, psid, ll);
            const bool valid = row < p.n && c0 + cl + e < p.t;
            if (valid) {
              rs_ll[mi][hh] += ll;
              rs_pm[mi][hh] += psid;
              if (p.need_ysq) rs_ysq[mi][hh] += y * y;
            }
            yv[e] = y;     // 0 at padded rows and columns
            ps[e] = psi;   // psi(0) == 0
            pd[e] = valid ? psid : 0.f;
            acc[mi][nt][2 * hh + e] = 0.f;
          }
          const long long off = (long long)row * p.ws_cols + wcol + cl;
          *reinterpret_cast<uint32_t*>(p.y + off) = pack_bf16(yv[0], yv[1]);
          *reinterpret_cast<uint32_t*>(p.psi + off) = pack_bf16(ps[0], ps[1]);
          if (NEED_H) {
            *reinterpret_cast<uint32_t*>(p.psid + off) = pack_bf16(pd[0], pd[1]);
            *reinterpret_cast<uint32_t*>(p.y2 + off) = pack_bf16(yv[0] * yv[0], yv[1] * yv[1]);
          }
        }
      }
    }
  }

  // The group's row partials: the quad's lanes, then the column warps in
  // order, through shared memory.
#pragma unroll
  for (int mi = 0; mi < A_MI; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v[3] = {rs_ll[mi][hh], rs_pm[mi][hh], rs_ysq[mi][hh]};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 1);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 2);
      }
      if (q == 0) {
        const int rl = 16 * A_MI * wr + 16 * mi + g + 8 * hh;
#pragma unroll
        for (int k = 0; k < 3; ++k) red[(k * A_WC + wc) * TILE + rl] = v[k];
      }
    }
  }
  __syncthreads();
  const int row = row0 + tid;
  if (tid < TILE && row < p.n) {
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* r = red + k * A_WC * TILE + tid;
      v[k] = r[0];
#pragma unroll
      for (int c = 1; c < A_WC; ++c) v[k] += r[c * TILE];
    }
    const long long o = (long long)grp * p.stride + row;
    p.ll[o] = v[0];
    p.pm[o] = v[1];
    if (p.need_ysq) {
      p.ysq[o] = v[2];
      p.dysq[o] = v[2];
    }
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS) contract_kernel(BParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int ti = blockIdx.x / p.edge, tj = blockIdx.x % p.edge;
  const bool hmat = blockIdx.z == 1;
  const long long k0 = (long long)blockIdx.y * p.cols;
  const __nv_bfloat16* a_src = (hmat ? p.psid : p.psi) + (long long)ti * TILE * p.ws_cols + k0;
  const __nv_bfloat16* b_src = (hmat ? p.y2 : p.y) + (long long)tj * TILE * p.ws_cols + k0;
  const int total = p.cols / B_KC;

  // Both operands: TILE rows x B_KC in 16-byte pieces.
  auto load = [&](int it) {
    __nv_bfloat16* as = ring + (it % B_STAGES) * 2 * B_STAGE;
    __nv_bfloat16* bs = as + B_STAGE;
    const long long k = (long long)it * B_KC;
    for (int u = tid; u < TILE * (B_KC / 8); u += THREADS) {
      const int r = u / (B_KC / 8), c = (u % (B_KC / 8)) * 8;
      cp_async16_zfill(as + r * B_LDK + c, a_src + r * p.ws_cols + k + c, true);
      cp_async16_zfill(bs + r * B_LDK + c, b_src + r * p.ws_cols + k + c, true);
    }
  };

#pragma unroll
  for (int i = 0; i < B_STAGES - 1; ++i) {
    if (i < total) load(i);
    cp_async_commit_group();
  }

  float acc[MI][NI][4] = {};
  for (int it = 0; it < total; ++it) {
    cp_async_wait<B_STAGES - 2>();
    __syncthreads();
    if (it + B_STAGES - 1 < total) load(it + B_STAGES - 1);
    cp_async_commit_group();

    const __nv_bfloat16* as = ring + (it % B_STAGES) * 2 * B_STAGE;
    const __nv_bfloat16* bs = as + B_STAGE;
#pragma unroll
    for (int k32 = 0; k32 < B_KC; k32 += 32) {
      uint32_t b[2][NI][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, ldm_b_addr(bs + (32 * wc + 16 * np) * B_LDK + k32 + 16 * ks, B_LDK,
                                    lane));
          b[ks][2 * np][0] = r[0], b[ks][2 * np][1] = r[1];
          b[ks][2 * np + 1][0] = r[2], b[ks][2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        float t[NI][4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, ldm_a_addr(as + (64 * wr + 16 * mi) * B_LDK + k32 + 16 * ks, B_LDK,
                                    lane));
#pragma unroll
          for (int nt = 0; nt < NI; ++nt) mma_bf16(t[nt], a, b[ks][nt][0], b[ks][nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < NI; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] += t[nt][e];
      }
    }
  }

  float* out = (hmat ? p.h : p.g) + (long long)(p.g0 + blockIdx.y) * p.stride;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ti * TILE + 64 * wr + 16 * mi + g + 8 * (e >> 1);
        const int j = tj * TILE + 32 * wc + 8 * nt + 2 * q + (e & 1);
        if (i < p.n && j < p.n) out[(long long)i * p.n + j] = acc[mi][nt][e];
      }
    }
  }
}

template <class Kernel, class Params>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const Params& p, cudaStream_t st) {
  // Above 48 KB dynamic shared memory must be opted into; a refused
  // launch never runs and only cudaGetLastError reports it.
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool NEED_H>
cudaError_t launch_a(int dens, dim3 grid, const AParams& p, cudaStream_t st) {
  switch (dens) {
    case TANH: return launch(rotate_density_kernel<TANH, NEED_H>, A_BYTES, grid, p, st);
    case EXP: return launch(rotate_density_kernel<EXP, NEED_H>, A_BYTES, grid, p, st);
    case CUBE: return launch(rotate_density_kernel<CUBE, NEED_H>, A_BYTES, grid, p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The tile edge (W rows of a block of A, B's output tile edge) and A's
// k depth of a stage: the caller pads W to (n_pad, kp) with n_pad a
// multiple of the first and kp of the second, and sizes groups in whole
// tiles.
int picard_stream_tc_tile() { return TILE; }
int picard_stream_tc_kc() { return A_KC; }

// The plain-mode line-search try at the bf16 tier on bf16 X (the outputs
// of picard_streaming_fused_sums with delta = 0, rot = ct = BF16, x_bf16 =
// 1). w: the (n_pad, kp) zero-padded bf16 copy of M_new; x: (n, t) bf16;
// ws: the workspace, 2 (4 with H) bf16 matrices of (n_pad,
// groups_per_chunk * cols). T is cut into n_parts groups of `cols`
// columns; group g's partial of each output is at out + g * stride.
int picard_streaming_fused_tc(int density, int need_h, int need_ysq, double alpha, int n,
                              long long t, int cols, int n_parts, int groups_per_chunk,
                              const void* w, const void* x, void* ws, float* dll, float* dysq,
                              float* g, float* pm, float* h, float* ysq, long long stride,
                              void* stream) {
  if (n < 1 || n > picard_stream_max_n() || t < 1 || cols < TILE || cols % TILE != 0 ||
      (long long)n_parts != (t + cols - 1) / cols || groups_per_chunk < 1 ||
      groups_per_chunk > MAX_GRID_Y || density < TANH || density > CUBE || stride < 1 ||
      (need_ysq && (!dysq || !ysq)) || (need_h && !h) ||
      reinterpret_cast<std::uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_pad = (n + TILE - 1) / TILE * TILE;
  const long long ws_cols = (long long)groups_per_chunk * cols;
  const long long mat = (long long)n_pad * ws_cols;
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(ws);

  AParams a;
  a.n = n;
  a.kp = (n + A_KC - 1) / A_KC * A_KC;
  a.t = t;
  a.need_ysq = need_ysq;
  a.vec = (t * 2) % 16 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  a.a = (float)alpha;
  a.m2a = (float)(-2.0 * alpha);
  a.mha = (float)(-alpha / 2.0);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.psi = base;
  a.y = base + mat;
  a.psid = need_h ? base + 2 * mat : nullptr;
  a.y2 = need_h ? base + 3 * mat : nullptr;
  a.ws_cols = ws_cols;
  a.cols = cols;
  a.ll = dll;
  a.dysq = dysq;
  a.pm = pm;
  a.ysq = ysq;
  a.stride = stride;

  BParams b;
  b.psi = a.psi;
  b.y = a.y;
  b.psid = a.psid;
  b.y2 = a.y2;
  b.g = g;
  b.h = h;
  b.n = n;
  b.edge = n_pad / TILE;
  b.ws_cols = ws_cols;
  b.cols = cols;
  b.stride = stride;

  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  for (int g0 = 0; g0 < n_parts; g0 += groups_per_chunk) {
    const int ng = n_parts - g0 < groups_per_chunk ? n_parts - g0 : groups_per_chunk;
    a.g0 = b.g0 = g0;
    const dim3 grid_a(n_pad / TILE, ng);
    cudaError_t e = need_h ? launch_a<true>(density, grid_a, a, st)
                           : launch_a<false>(density, grid_a, a, st);
    if (e != cudaSuccess) return (int)e;
    e = launch(contract_kernel, B_BYTES, dim3(b.edge * b.edge, ng, need_h ? 2 : 1), b, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
