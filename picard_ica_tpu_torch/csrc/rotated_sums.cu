// Hand-written Hopper (sm_90a) kernels for two data passes of the
// Picard-O core loop, and the C entries of all three. One templated
// kernel body serves both:
//
//   picard_rotated_moments_sums replaces picard_ica_tpu/ops/pallas_kernels.py
//                               rotated_moments_sums /
//                               _rotated_moments_kernel (G, sum psi', H,
//                               sum Y^2 of Y = W X);
//   picard_rotated_loglik_sums  replaces rotated_loglik_sums /
//                               _rotated_loglik_kernel (sum log_lik(M X),
//                               sum (M X)^2 per row).
//
// The third, picard_rotated_fused_sums (rotated_fused_sums /
// _rotated_fused_kernel: one line-search try in one read of X), runs
// every tier on the tensor cores (rotated_fused_tc.cu); its entry below
// checks the shape and hands over.
//
// What bounds them on the card, at N = 64 (4096 FMAs per 64 x 64
// product per column of X; the H100's scalar-FP32 peak of 33.5 T FMA/s
// against 3.35 TB/s of HBM puts the line at 10 FMA per byte):
//   moments: 8-12 K FMAs per 256 bytes of f32 X: 32-48 FMA/B;
//   loglik: 4 K FMAs (+ 64 exp/log1p) per 256 bytes: 16 FMA/B.
// Both are bound by the FP32 pipes (scalar FMA), with shared-memory
// load bandwidth the second limit.
//
// What the design does about it.
//   * X is read from HBM exactly once per call; Y, psi(Y), psi'(Y) never
//     leave the SM (shared-memory tiles of BT columns).
//   * W sits in shared memory, rounded at the block's start to the
//     rotation tier (bf16 for bf16 X), so the inner loops issue only FMAs
//     and broadcast float4 loads of W.
//   * Each thread owns an 8 x 4 register tile of the rotation and a 4 x 4
//     register tile of G and H; the tiles have a padded row stride
//     (BT + 1) so both access patterns are free of bank conflicts.
//   * Reductions: every block walks SUBTILES consecutive sub-tiles (a
//     sequential depth of at most 16, the grouped-partials trade-off of
//     pallas_kernels.py:145-174) and writes one partial per output at
//     out + block * stride (the outputs side by side in one buffer); the
//     caller folds them pairwise. No float atomics.
//
// Tiers (F32, BF16) and the density formulas live in density.cuh, shared
// with streaming_sums.cu; the contractions here are exact f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (picard_ica_tpu_torch/ops/_build.py).
// Every C entry returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include "density.cuh"

namespace {

constexpr int NMAX = 64;        // kernel capacity in components
constexpr int BT = 128;         // columns per sub-tile
constexpr int SUBTILES = 16;    // sub-tiles per block (sequential depth)
constexpr int COLS_PER_BLOCK = BT * SUBTILES;
constexpr int THREADS = 256;
constexpr int TS = BT + 1;      // padded row stride of the column tiles

// Rotation phase: threads as 32 columns x 8 rows.
constexpr int RT_ROWS = NMAX / 8;   // rows per thread (i = ty + 8 r)
constexpr int RT_COLS = BT / 32;    // columns per thread (c = tx + 32 q)
// Contraction phase: threads as 16 x 16 over the N x N outputs.
constexpr int CT_DIM = NMAX / 16;   // i = ca + 16 u, j = cb + 16 v

enum Mode { MOMENTS = 0, LOGLIK = 1 };

// Block b's partial of each output starts at out + b * stride.
struct Outs {
  float* ll;    // (n) log-lik row sums
  float* g;     // (n, n) psi(Y) Y^T
  float* pm;    // (n) sum psi'(Y)
  float* h;     // (n, n) psi'(Y) (Y^2)^T
  float* ysq;   // (n) sum Y^2
  long long stride;
};

struct Params {
  int n;
  long long t;
  int need_ysq;
  int x_bf16;
  float a;    // alpha
  float m2a;  // f32(-2 alpha), as densities.py rounds its constants
  float mha;  // f32(-alpha / 2)
  const float* w;   // (n, n): M (W) of the rotation
  const void* x;    // (n, t) f32 or bf16, row-major
  Outs out;
};

// ---- shared-memory layout ----

template <int MODE, bool NEED_H>
struct Layout {
  static constexpr bool CONTRACT = MODE == MOMENTS;
  static constexpr int TILES = 1 + (CONTRACT ? 1 : 0) + (NEED_H ? 1 : 0);
  static constexpr size_t BYTES =
      sizeof(float) * ((size_t)NMAX * NMAX + (size_t)TILES * NMAX * TS);
};

// ROT: the rotation tier, F32 or BF16 (bf16 X).
template <int MODE, int ROT, int D, bool NEED_H>
__global__ void __launch_bounds__(THREADS, 1) rotated_sums_kernel(Params p) {
  using L = Layout<MODE, NEED_H>;
  constexpr bool CONTRACT = L::CONTRACT;
  static_assert(ROT == F32 || ROT == BF16, "the fused pass runs in rotated_fused_tc.cu");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w_s = smem;
  float* xy = smem + NMAX * NMAX;              // X tile, then Y tile
  float* psi_t = xy + NMAX * TS;               // CONTRACT only
  float* psid_t = psi_t + NMAX * TS;           // NEED_H only

  const int tid = threadIdx.x;
  const int n = p.n;
  const long long t_len = p.t;

  // Stage W once per block, rounded to the rotation tier; rows and
  // columns beyond n are zero, so padded rows rotate to Y = 0.
  for (int idx = tid; idx < NMAX * NMAX; idx += THREADS) {
    const int i = idx / NMAX, k = idx % NMAX;
    const bool in = i < n && k < n;
    w_s[idx] = split<ROT>(in ? p.w[i * n + k] : 0.f).hi;
  }

  const int tx = tid & 31, ty = tid >> 5;
  const int cb = tid & 15, ca = tid >> 4;

  float rs_ll[RT_ROWS], rs_pm[RT_ROWS], rs_ysq[RT_ROWS];
#pragma unroll
  for (int r = 0; r < RT_ROWS; ++r) {
    rs_ll[r] = 0.f;
    rs_pm[r] = 0.f;
    rs_ysq[r] = 0.f;
  }
  float g_acc[CT_DIM][CT_DIM], h_acc[CT_DIM][CT_DIM];
#pragma unroll
  for (int u = 0; u < CT_DIM; ++u)
#pragma unroll
    for (int v = 0; v < CT_DIM; ++v) {
      g_acc[u][v] = 0.f;
      h_acc[u][v] = 0.f;
    }

  const long long col0 = (long long)blockIdx.x * COLS_PER_BLOCK;
  for (int s = 0; s < SUBTILES; ++s) {
    const long long c0 = col0 + (long long)s * BT;
    if (c0 >= t_len) break;  // uniform across the block
    __syncthreads();  // W staged; the previous sub-tile's tiles are free

    // Load the X tile (coalesced along T), zero outside [0, n) x [0, t).
    for (int idx = tid; idx < NMAX * BT; idx += THREADS) {
      const int k = idx / BT, c = idx % BT;
      const long long col = c0 + c;
      float v = 0.f;
      if (k < n && col < t_len) {
        const long long off = (long long)k * t_len + col;
        v = p.x_bf16
                ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(p.x)[off])
                : reinterpret_cast<const float*>(p.x)[off];
      }
      xy[k * TS + c] = v;
    }
    __syncthreads();

    // Rotation: acc = M x.
    float acc[RT_ROWS][RT_COLS];
#pragma unroll
    for (int r = 0; r < RT_ROWS; ++r)
#pragma unroll
      for (int q = 0; q < RT_COLS; ++q) acc[r][q] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < NMAX; k0 += 4) {
      Sp xs[4][RT_COLS];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < RT_COLS; ++q)
          xs[kk][q] = split<ROT>(xy[(k0 + kk) * TS + tx + 32 * q]);
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r) {
        const int i = ty + 8 * r;
        const float4 wh = *reinterpret_cast<const float4*>(&w_s[i * NMAX + k0]);
        const Sp w4[4] = {{wh.x, 0.f}, {wh.y, 0.f}, {wh.z, 0.f}, {wh.w, 0.f}};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < RT_COLS; ++q)
            acc[r][q] = mac<ROT>(w4[kk], xs[kk][q], acc[r][q]);
      }
    }
    if (CONTRACT) __syncthreads();  // every thread is done reading X

    // Density, masked row sums, and the Y / psi / psi' tiles.
#pragma unroll
    for (int r = 0; r < RT_ROWS; ++r) {
      const int i = ty + 8 * r;
#pragma unroll
      for (int q = 0; q < RT_COLS; ++q) {
        const int c = tx + 32 * q;
        const bool valid = c0 + c < t_len;
        const float y = acc[r][q];
        float psi = 0.f, psid = 0.f, ll = 0.f;
        if (MODE == MOMENTS)
          score_der<D>(p, y, psi, psid);
        else
          ll = log_lik<D>(p, y);
        if (valid) {
          if (MODE == LOGLIK) rs_ll[r] += ll;
          if (MODE == MOMENTS) rs_pm[r] += psid;
          if (p.need_ysq) rs_ysq[r] += y * y;
        }
        if (CONTRACT) {
          xy[i * TS + c] = y;
          psi_t[i * TS + c] = psi;  // psi(0) == 0 at padded columns
          if (NEED_H) psid_t[i * TS + c] = valid ? psid : 0.f;
        }
      }
    }

    if (CONTRACT) {
      __syncthreads();
      // G += psi Y^T, H += psi' (Y^2)^T over the sub-tile's columns, in
      // exact f32.
#pragma unroll 4
      for (int c = 0; c < BT; ++c) {
        float ps[CT_DIM], pd[CT_DIM], yv[CT_DIM], y2[CT_DIM];
#pragma unroll
        for (int u = 0; u < CT_DIM; ++u) {
          ps[u] = psi_t[(ca + 16 * u) * TS + c];
          if (NEED_H) pd[u] = psid_t[(ca + 16 * u) * TS + c];
        }
#pragma unroll
        for (int v = 0; v < CT_DIM; ++v) {
          yv[v] = xy[(cb + 16 * v) * TS + c];
          if (NEED_H) y2[v] = yv[v] * yv[v];
        }
#pragma unroll
        for (int u = 0; u < CT_DIM; ++u)
#pragma unroll
          for (int v = 0; v < CT_DIM; ++v) {
            g_acc[u][v] = fmaf(ps[u], yv[v], g_acc[u][v]);
            if (NEED_H) h_acc[u][v] = fmaf(pd[u], y2[v], h_acc[u][v]);
          }
      }
    }
  }

  // Epilogue: one partial per output for this block.
  const long long blk = blockIdx.x;
#pragma unroll
  for (int r = 0; r < RT_ROWS; ++r) {
    float v_ll = rs_ll[r], v_pm = rs_pm[r], v_ysq = rs_ysq[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v_ll += __shfl_xor_sync(0xffffffffu, v_ll, off);
      v_pm += __shfl_xor_sync(0xffffffffu, v_pm, off);
      v_ysq += __shfl_xor_sync(0xffffffffu, v_ysq, off);
    }
    const int i = ty + 8 * r;
    if (tx == 0 && i < n) {
      const long long o = blk * p.out.stride + i;
      if (MODE == LOGLIK) p.out.ll[o] = v_ll;
      if (MODE == MOMENTS) p.out.pm[o] = v_pm;
      if (p.need_ysq) p.out.ysq[o] = v_ysq;
    }
  }
  if (CONTRACT) {
#pragma unroll
    for (int u = 0; u < CT_DIM; ++u)
#pragma unroll
      for (int v = 0; v < CT_DIM; ++v) {
        const int i = ca + 16 * u, j = cb + 16 * v;
        if (i < n && j < n) {
          const long long o = blk * p.out.stride + i * n + j;
          p.out.g[o] = g_acc[u][v];
          if (NEED_H) p.out.h[o] = h_acc[u][v];
        }
      }
  }
}

template <int MODE, int ROT, int D, bool NEED_H>
cudaError_t launch(const Params& p, int nb, cudaStream_t stream) {
  constexpr size_t smem = Layout<MODE, NEED_H>::BYTES;
  auto kern = rotated_sums_kernel<MODE, ROT, D, NEED_H>;
  // Above 48 KB dynamic shared memory must be opted into, on the current
  // device; a refused launch never runs and only cudaGetLastError
  // reports it.
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<nb, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE, int ROT, bool NEED_H>
cudaError_t by_density_h(int dens, const Params& p, int nb, cudaStream_t st) {
  switch (dens) {
    case TANH: return launch<MODE, ROT, TANH, NEED_H>(p, nb, st);
    case EXP: return launch<MODE, ROT, EXP, NEED_H>(p, nb, st);
    case CUBE: return launch<MODE, ROT, CUBE, NEED_H>(p, nb, st);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, int ROT>
cudaError_t by_density(int dens, int need_h, const Params& p, int nb,
                       cudaStream_t st) {
  return need_h ? by_density_h<MODE, ROT, true>(dens, p, nb, st)
                : by_density_h<MODE, ROT, false>(dens, p, nb, st);
}

Params make_params(int n, long long t, int need_ysq, int x_bf16, double alpha,
                   const float* w, const void* x, long long stride) {
  Params p;
  p.n = n;
  p.t = t;
  p.need_ysq = need_ysq;
  p.x_bf16 = x_bf16;
  p.a = (float)alpha;
  p.m2a = (float)(-2.0 * alpha);
  p.mha = (float)(-alpha / 2.0);
  p.w = w;
  p.x = x;
  p.out = Outs{nullptr, nullptr, nullptr, nullptr, nullptr, stride};
  return p;
}

bool bad_shape(int n, long long t, int nb, long long stride) {
  return n < 1 || n > NMAX || t < 1 || stride < 1 ||
         (long long)nb != (t + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK;
}

}  // namespace

// The fused pass, every tier (rotated_fused_tc.cu).
int rotated_fused_tc(int delta, int rot_tier, int ct_tier, int density, int need_h,
                     int need_ysq, double alpha, int n, long long t, int x_bf16,
                     const float* w, const float* dm, const void* x, float* dll,
                     float* dysq, float* g, float* pm, float* h, float* ysq,
                     long long stride, int nb, void* stream);

extern "C" {

int picard_max_n() { return NMAX; }

int picard_cols_per_block() { return COLS_PER_BLOCK; }

const char* picard_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Fused line-search try. delta = 1: dll = sum [log_lik(M_new x) -
// log_lik(M_old x)] (analytic form), dysq = sum (2 y_old + dy) dy, with w
// = M_old and dm = M_new - M_old. delta = 0 (plain): dll = sum
// log_lik(M_new x), dysq = sum (M_new x)^2, with w = M_new (dm unused).
// Block b writes its partials at out + b * stride. Every tier pair runs
// the tensor-core kernel.
int picard_rotated_fused_sums(int delta, int rot_tier, int ct_tier,
                              int density, int need_h, int need_ysq,
                              double alpha, int n, long long t, int x_bf16,
                              const float* w, const float* dm, const void* x,
                              float* dll, float* dysq, float* g, float* pm,
                              float* h, float* ysq, long long stride, int nb,
                              void* stream) {
  if (bad_shape(n, t, nb, stride)) return (int)cudaErrorInvalidValue;
  return rotated_fused_tc(delta, rot_tier, ct_tier, density, need_h, need_ysq, alpha, n, t,
                          x_bf16, w, dm, x, dll, dysq, g, pm, h, ysq, stride, nb, stream);
}

// Moments of Y = W x: rotation at rot_tier (F32, or BF16 for bf16 X),
// contractions in exact f32, as the TPU kernel's HIGHEST dots.
int picard_rotated_moments_sums(int rot_tier, int density, int need_h,
                                int need_ysq, double alpha, int n, long long t,
                                int x_bf16, const float* w, const void* x,
                                float* g, float* pm, float* h, float* ysq,
                                long long stride, int nb, void* stream) {
  if (bad_shape(n, t, nb, stride)) return (int)cudaErrorInvalidValue;
  Params p = make_params(n, t, need_ysq, x_bf16, alpha, w, x, stride);
  p.out = Outs{nullptr, g, pm, h, ysq, stride};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (rot_tier == F32)
    e = by_density<MOMENTS, F32>(density, need_h, p, nb, st);
  else if (rot_tier == BF16)
    e = by_density<MOMENTS, BF16>(density, need_h, p, nb, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// Row sums of log_lik(M x) and (optionally) (M x)^2.
int picard_rotated_loglik_sums(int rot_tier, int density, int need_ysq,
                               double alpha, int n, long long t, int x_bf16,
                               const float* m, const void* x, float* ll,
                               float* ysq, long long stride, int nb, void* stream) {
  if (bad_shape(n, t, nb, stride)) return (int)cudaErrorInvalidValue;
  Params p = make_params(n, t, need_ysq, x_bf16, alpha, m, x, stride);
  p.out = Outs{ll, nullptr, nullptr, nullptr, ysq, stride};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (rot_tier == F32)
    e = by_density_h<LOGLIK, F32, false>(density, p, nb, st);
  else if (rot_tier == BF16)
    e = by_density_h<LOGLIK, BF16, false>(density, p, nb, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
