// Hand-written Hopper (sm_90a) kernel for the core loop at N > 64, where
// the weights no longer fit whole in shared memory:
//
//   picard_streaming_fused_sums  replaces picard_ica_tpu/ops/pallas_kernels.py
//                                streaming_fused_sums / _streaming_fused_kernel
//                                (one line-search try at large N: the loss
//                                delta or absolute log-lik of M_new X, and
//                                the candidate's G, sum psi', H, sum Y^2);
//                                in plain mode it also serves the moments of
//                                Y = W X (the JAX package's hand-off of
//                                rotated_moments_sums, :338-342).
//
// Every pass of the default staged schedule runs on the tensor cores
// instead (streaming_fused_tc.cu): the plain mode at the bf16 tier on bf16
// X and at the f32 tier on f32 X, and the delta mode at the bf16x3 and the
// f32 tier on f32 X; so do the log-lik row sums (streaming_loglik_sums,
// picard_streaming_loglik_tc). The kernel here keeps every other (mode,
// tier, X dtype): delta bf16 on f32 X (a kernel_precision="bf16" fit),
// delta on bf16 X, plain bf16 on f32 X and plain bf16x3; it is not built
// at the tier pairs the tensor cores take.
//
// What computes what. A block owns `group` consecutive tiles of BT
// columns of X. For each tile it rotates Y = W X one pass of RPP rows at a
// time (RPP * BT = 8192 outputs a pass; W and X stream through shared
// memory in chunks of KC = 16 along k, prefetched into registers while
// the previous chunk is multiplied), evaluates the density on the pass,
// adds the masked row statistics (dll, dysq, pm, ysq) into the block's own
// row partials, and parks Y in a (ceil(N/64)*64, BT) shared-memory tile.
// The contraction phase then recomputes psi and psi' from the whole Y tile
// (as the TPU kernel's final grid step does, :1042-1058) one 64-row block
// at a time and adds psi Y^T (and psi' (Y^2)^T) into the block's (N, N)
// partial in global memory, 64 x 64 outputs at a time. Exactly one block
// owns each partial and updates it in place, tile after tile, so the
// sums are deterministic: no float atomics. The caller folds the partials
// pairwise (ops/moments.fold_pairwise).
//
// Sequential depth: a G/H entry sums BT columns in registers, then at
// most `group` tile sums in order (group = 16 unless the partials would
// pass STREAM_PARTIALS_MAX in ops/kernels.py; 25 at 1024 x 200,000), so
// every accumulator is a sequential f32 sum over at most a few thousand
// columns, as in the other kernels. Row statistics: the same.
//
// Partials held at the shapes chip_smoke.py runs (n_partials x N^2 x 4
// bytes per matrix): 256 x 2,000,000 (BT 128, 977 partials) 256 MB, and
// 256 MB more for H; 306 x 1,000,003 (BT 64, 977) 366 MB; 1024 x 200,000
// (BT 32, 250) 1.05 GB. All under RESIDENT_PARTIALS_MAX (2 GB).
//
// What bounds it on the card (H100 SXM: 33.5 T FMA/s of scalar FP32,
// 3.35 TB/s of HBM, 50 MB of L2):
//   * a delta try with G only costs 3 N^2 T FMAs (two rotations and one
//     contraction): 3.9e11 at 256 x 2M (12 ms at peak), 6.3e11 at
//     1024 x 200k (19 ms); the bf16x3 tier three times the products;
//   * X is read from HBM once a call (2 GB at 256 x 2M f32, 0.6 ms); each
//     row pass re-reads the tile's X chunks from L2, and every tile reads
//     all of W (and dm) from L2: BT / 4 FMAs a byte;
//   * the read-modify-write of the G partial costs BT / 8 FMAs a byte. At
//     N = 256 a partial is 256 KB, and the 132 blocks in flight hold
//     34 MB: it stays in L2. At N = 1024 (4 MB a partial, 0.55 GB in
//     flight) it goes to HBM: 8 MB a tile, about 52 GB a call at
//     1024 x 200k (16 ms of HBM time, overlapped with the FMAs of the next
//     64 x 64 output block since its old values are loaded first).
//   So the kernel is bound by the FP32 pipes and, in the rotation, by
//   shared-memory issue (one broadcast float4 of W per 4-8 FMAs); at
//   N = 1024 the partials' HBM traffic is the second limit.
//
// What the design does about it: exact f32 FMAs (no TF32, no tensor
// cores, no library call); each thread owns 32 rotation outputs (64 in
// delta mode) with warp-uniform W rows, so W is read as broadcast float4
// and X as conflict-free scalars; the contraction reads psi and Y as
// float4 along columns with a row stride of BT + 4 floats (16 rows of a
// warp in two wavefronts) for 16 (32 with H) FMAs a column; one block of
// 256 threads per SM, as the Y tile takes most of the shared memory.
// BT is the largest of 128, 64, 32 whose Y tile and staging fit in the
// 227 KB a block may use: N <= 256 -> 128, <= 704 -> 64, <= 1344 -> 32.
// STREAM_MAX_N = 1344 in every mode (H included), above the JAX package's
// 896 (with H) / 1152 (G only).
//
// Padding: W rows and columns beyond N and X columns beyond T load as 0,
// so padded Y entries are exactly 0; psi(0) = 0 and (Y^2) = 0 keep them
// out of G and H, and psi' and log_lik are masked out of the row sums.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC (picard_ica_tpu_torch/ops/_build.py).
// Every C entry returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include "density.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 16;             // k depth of one staged chunk of W and X
constexpr int PASS_ELEMS = 8192;   // rotation outputs of one pass: RPP x BT
constexpr int CB = 64;             // contraction output block edge
constexpr int MIN_BT = 32;
constexpr int SMEM_MAX = 232448;   // opt-in shared memory of one block

enum SMode { S_PLAIN = 1, S_DELTA = 2 };

struct SParams {
  int n;
  long long t;
  int need_ysq;
  int x_bf16;
  int dens;
  float a;    // alpha
  float m2a;  // f32(-2 alpha), as densities.py rounds its constants
  float mha;  // f32(-alpha / 2)
  const float* w;   // (n, n): M; M_old in delta mode
  const float* dm;  // (n, n): M_new - M_old (delta mode only)
  const void* x;    // (n, t) f32 or bf16, row-major
  int n_tiles;
  int group;        // tiles per block (and per partial)
  // Group b's partial of each output starts at out + b * stride.
  float* ll;    // (n) log-lik (delta) row sums
  float* dysq;  // (n) sum (2 y_old + dy) dy, or sum y^2 (plain)
  float* g;     // (n, n) psi(Y) Y^T
  float* pm;    // (n) sum psi'(Y)
  float* h;     // (n, n) psi'(Y) (Y^2)^T
  float* ysq;   // (n) sum Y^2
  long long stride;
};

constexpr long long smem_floats(int n, int bt) {
  const long long rot = 2LL * (PASS_ELEMS / bt) * KC + (long long)KC * bt;
  const long long ny = (long long)(n + CB - 1) / CB * CB;
  const long long con = 2LL * CB * (bt + 4);
  return ny * (bt + 4) + (rot > con ? rot : con);
}

constexpr int choose_bt(int n) {
  for (int bt = 128; bt >= MIN_BT; bt /= 2)
    if (smem_floats(n, bt) * 4 <= SMEM_MAX) return bt;
  return 0;
}

constexpr int stream_max_n() {
  int n = 0;
  while (choose_bt(n + CB) != 0) n += CB;
  return n;
}

constexpr int STREAM_MAX_N = stream_max_n();

// ---- the density, chosen at run time (uniform across the grid) ----

__device__ __forceinline__ void score_der_rt(const SParams& p, float y,
                                             float& psi, float& psid) {
  switch (p.dens) {
    case TANH: score_der<TANH>(p, y, psi, psid); break;
    case EXP: score_der<EXP>(p, y, psi, psid); break;
    default: score_der<CUBE>(p, y, psi, psid);
  }
}

__device__ __forceinline__ void score_der_loglik_rt(const SParams& p, float y,
                                                    float& psi, float& psid,
                                                    float& ll) {
  switch (p.dens) {
    case TANH: score_der_loglik<TANH>(p, y, psi, psid, ll); break;
    case EXP: score_der_loglik<EXP>(p, y, psi, psid, ll); break;
    default: score_der_loglik<CUBE>(p, y, psi, psid, ll);
  }
}

__device__ __forceinline__ void score_der_loglik_delta_rt(
    const SParams& p, float y_old, float dy, float& psi, float& psid,
    float& dll) {
  switch (p.dens) {
    case TANH: score_der_loglik_delta<TANH>(p, y_old, dy, psi, psid, dll); break;
    case EXP: score_der_loglik_delta<EXP>(p, y_old, dy, psi, psid, dll); break;
    default: score_der_loglik_delta<CUBE>(p, y_old, dy, psi, psid, dll);
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Row partial `out[g, row]`: written by the group's first tile, then
// added to in tile order.
__device__ __forceinline__ void row_update(float* out, long long o, bool first,
                                           float v) {
  out[o] = first ? v : out[o] + v;
}

template <int MODE, int ROT, int CT, bool NEED_H, int BT>
__global__ void __launch_bounds__(THREADS, 1) streaming_kernel(SParams p) {
  constexpr bool DELTA = MODE == S_DELTA;
  constexpr int YS = BT + 4;                 // padded row stride of Y / psi
  constexpr int RPP = PASS_ELEMS / BT;       // rows of one rotation pass
  constexpr int QC = BT / 32;                // columns a thread: lane + 32 q
  constexpr int RR = RPP / WARPS;            // rows a thread: warp + 8 r
  constexpr int W_PER = RPP * KC / THREADS;  // staged W (dm) values a thread
  constexpr int X_PER = KC * BT / THREADS;   // staged X values a thread
  // BF16 operands are rounded once, as they are staged; the products are
  // then plain FMAs of the rounded values.
  constexpr int RUSE = ROT == BF16 ? F32 : ROT;
  static_assert(RR * QC == 32 && W_PER * THREADS == RPP * KC &&
                X_PER * THREADS == KC * BT, "tile shape");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = p.n;
  const int ny = (n + CB - 1) / CB * CB;
  float* y_s = smem;                       // (ny, YS) Y tile
  float* stage = smem + (size_t)ny * YS;   // rotation chunks | psi blocks
  float* w_s = stage;                      // (RPP, KC)
  float* d_s = w_s + RPP * KC;             // (RPP, KC), delta mode
  float* x_s = d_s + RPP * KC;             // (KC, BT)
  float* psi_s = stage;                    // (CB, YS)
  float* psid_s = psi_s + CB * YS;         // (CB, YS), NEED_H

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t_len = p.t;
  const int n_kc = (n + KC - 1) / KC;
  const int n_chunks = (n + RPP - 1) / RPP * n_kc;
  const long long grp = blockIdx.x;
  const int tile0 = (int)grp * p.group;
  const int tile1 = min(tile0 + p.group, p.n_tiles);

  for (int tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0;
    const long long c0 = (long long)tile * BT;

    float wr[W_PER], dr[W_PER], xr[X_PER];
    auto fetch = [&](int chunk) {
      const int row0 = chunk / n_kc * RPP, k0 = chunk % n_kc * KC;
#pragma unroll
      for (int e = 0; e < W_PER; ++e) {
        const int idx = tid + e * THREADS;
        const int row = row0 + idx / KC, k = k0 + idx % KC;
        const bool in = row < n && k < n;
        wr[e] = in ? p.w[row * n + k] : 0.f;
        if (DELTA) dr[e] = in ? p.dm[row * n + k] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < X_PER; ++e) {
        const int idx = tid + e * THREADS;
        const int k = k0 + idx / BT;
        const long long col = c0 + idx % BT;
        float v = 0.f;
        if (k < n && col < t_len) {
          const long long off = (long long)k * t_len + col;
          v = p.x_bf16 ? __bfloat162float(
                             reinterpret_cast<const __nv_bfloat16*>(p.x)[off])
                       : reinterpret_cast<const float*>(p.x)[off];
        }
        xr[e] = v;
      }
    };

    float acc[RR][QC], accd[RR][QC];
    fetch(0);
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int kci = chunk % n_kc;
      if (kci == 0) {
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
          for (int q = 0; q < QC; ++q) {
            acc[r][q] = 0.f;
            accd[r][q] = 0.f;
          }
      }
      __syncthreads();  // every reader of the stage is done
#pragma unroll
      for (int e = 0; e < W_PER; ++e) {
        const int idx = tid + e * THREADS;  // = row * KC + k
        w_s[idx] = ROT == BF16 ? bf16_round(wr[e]) : wr[e];
        if (DELTA) d_s[idx] = ROT == BF16 ? bf16_round(dr[e]) : dr[e];
      }
#pragma unroll
      for (int e = 0; e < X_PER; ++e) {
        const int idx = tid + e * THREADS;  // = k * BT + c
        x_s[idx] = ROT == BF16 ? bf16_round(xr[e]) : xr[e];
      }
      __syncthreads();
      if (chunk + 1 < n_chunks) fetch(chunk + 1);  // in flight meanwhile

#pragma unroll
      for (int k4 = 0; k4 < KC; k4 += 4) {
        Sp xs[4][QC];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < QC; ++q)
            xs[kk][q] = split<RUSE>(x_s[(k4 + kk) * BT + lane + 32 * q]);
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const int rl = warp + WARPS * r;
          const float4 wv = *reinterpret_cast<const float4*>(&w_s[rl * KC + k4]);
          const Sp w4[4] = {split<RUSE>(wv.x), split<RUSE>(wv.y),
                            split<RUSE>(wv.z), split<RUSE>(wv.w)};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < QC; ++q)
              acc[r][q] = mac<RUSE>(w4[kk], xs[kk][q], acc[r][q]);
          if (DELTA) {
            const float4 dv = *reinterpret_cast<const float4*>(&d_s[rl * KC + k4]);
            const Sp d4[4] = {split<RUSE>(dv.x), split<RUSE>(dv.y),
                              split<RUSE>(dv.z), split<RUSE>(dv.w)};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int q = 0; q < QC; ++q)
                accd[r][q] = mac<RUSE>(d4[kk], xs[kk][q], accd[r][q]);
          }
        }
      }
      if (kci != n_kc - 1) continue;

      // End of a pass: density, masked row statistics, the Y tile.
      const int row0 = chunk / n_kc * RPP;
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const int row = row0 + warp + WARPS * r;
        float s_ll = 0.f, s_dysq = 0.f, s_pm = 0.f, s_ysq = 0.f;
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          const int c = lane + 32 * q;
          const bool valid = c0 + c < t_len;
          float y, psi = 0.f, psid = 0.f, ll = 0.f, dysq = 0.f;
          if (MODE == S_PLAIN) {
            y = acc[r][q];
            score_der_loglik_rt(p, y, psi, psid, ll);
          } else {
            const float y_old = acc[r][q], dy = accd[r][q];
            y = y_old + dy;
            score_der_loglik_delta_rt(p, y_old, dy, psi, psid, ll);
            dysq = (2.f * y_old + dy) * dy;
          }
          if (valid) {
            s_ll += ll;
            s_pm += psid;
            if (p.need_ysq) {
              s_ysq += y * y;
              s_dysq += dysq;
            }
          }
          if (row < ny) y_s[row * YS + c] = y;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s_ll += __shfl_xor_sync(0xffffffffu, s_ll, off);
          s_dysq += __shfl_xor_sync(0xffffffffu, s_dysq, off);
          s_pm += __shfl_xor_sync(0xffffffffu, s_pm, off);
          s_ysq += __shfl_xor_sync(0xffffffffu, s_ysq, off);
        }
        if (lane == 0 && row < n) {
          const long long o = grp * p.stride + row;
          row_update(p.ll, o, first, s_ll);
          row_update(p.pm, o, first, s_pm);
          if (p.need_ysq) {
            row_update(p.ysq, o, first, s_ysq);
            if (MODE == S_DELTA) row_update(p.dysq, o, first, s_dysq);
            if (MODE == S_PLAIN) row_update(p.dysq, o, first, s_ysq);
          }
        }
      }
    }

    // Contraction: G += psi Y^T (H += psi' (Y^2)^T) over the tile.
    __syncthreads();  // the Y tile is complete
    const int nb = ny / CB;
    const int ti = tid >> 4, tj = tid & 15;  // i = ti + 16 u, j = tj + 16 v
    for (int ib = 0; ib < nb; ++ib) {
      for (int idx = tid; idx < CB * BT; idx += THREADS) {
        const int rl = idx / BT, c = idx % BT;
        float psi, psid;
        score_der_rt(p, y_s[(ib * CB + rl) * YS + c], psi, psid);
        psi_s[rl * YS + c] = psi;
        if (NEED_H) psid_s[rl * YS + c] = psid;
      }
      __syncthreads();
      for (int jb = 0; jb < nb; ++jb) {
        // The old partial values are loaded first, so their latency runs
        // under this block's FMAs.
        float go[4][4], ho[4][4], ga[4][4], ha[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int i = ib * CB + ti + 16 * u, j = jb * CB + tj + 16 * v;
            const long long o = grp * p.stride + i * n + j;
            const bool in = !first && i < n && j < n;
            go[u][v] = in ? p.g[o] : 0.f;
            ho[u][v] = (NEED_H && in) ? p.h[o] : 0.f;
            ga[u][v] = 0.f;
            ha[u][v] = 0.f;
          }
        const float* yb = y_s + (size_t)(jb * CB + tj) * YS;
        const float* pb = psi_s + (size_t)ti * YS;
        const float* db = psid_s + (size_t)ti * YS;
#pragma unroll 2
        for (int c = 0; c < BT; c += 4) {
          float4 pv[4], dv[4], yv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            pv[u] = *reinterpret_cast<const float4*>(pb + 16 * u * YS + c);
            if (NEED_H) dv[u] = *reinterpret_cast<const float4*>(db + 16 * u * YS + c);
          }
#pragma unroll
          for (int v = 0; v < 4; ++v)
            yv[v] = *reinterpret_cast<const float4*>(yb + 16 * v * YS + c);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            Sp ps[4], pd[4], ys[4], y2[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              ps[u] = split<CT>(comp(pv[u], cc));
              if (NEED_H) pd[u] = split<CT>(comp(dv[u], cc));
            }
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float yy = comp(yv[v], cc);
              ys[v] = split<CT>(yy);
              if (NEED_H) y2[v] = split<CT>(yy * yy);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                ga[u][v] = mac<CT>(ps[u], ys[v], ga[u][v]);
                if (NEED_H) ha[u][v] = mac<CT>(pd[u], y2[v], ha[u][v]);
              }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int i = ib * CB + ti + 16 * u, j = jb * CB + tj + 16 * v;
            if (i < n && j < n) {
              const long long o = grp * p.stride + i * n + j;
              p.g[o] = first ? ga[u][v] : go[u][v] + ga[u][v];
              if (NEED_H) p.h[o] = first ? ha[u][v] : ho[u][v] + ha[u][v];
            }
          }
      }
      __syncthreads();  // psi_s is rewritten by the next row block
    }
  }
}

template <int MODE, int ROT, int CT, bool NEED_H, int BT>
cudaError_t launch(const SParams& p, int n_groups, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(p.n, BT) * sizeof(float);
  auto kern = streaming_kernel<MODE, ROT, CT, NEED_H, BT>;
  // Above 48 KB dynamic shared memory must be opted into; a refused
  // launch never runs and only cudaGetLastError reports it.
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<n_groups, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE, int ROT, int CT, bool NEED_H>
cudaError_t by_bt(int bt, const SParams& p, int ng, cudaStream_t st) {
  switch (bt) {
    case 128: return launch<MODE, ROT, CT, NEED_H, 128>(p, ng, st);
    case 64: return launch<MODE, ROT, CT, NEED_H, 64>(p, ng, st);
    case 32: return launch<MODE, ROT, CT, NEED_H, 32>(p, ng, st);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, int ROT, int CT>
cudaError_t by_h(int need_h, int bt, const SParams& p, int ng, cudaStream_t st) {
  return need_h ? by_bt<MODE, ROT, CT, true>(bt, p, ng, st)
                : by_bt<MODE, ROT, CT, false>(bt, p, ng, st);
}

template <int MODE>
cudaError_t by_tiers(int rot, int ct, int need_h, int bt, const SParams& p,
                     int ng, cudaStream_t st) {
  // (f32, f32) and delta (bf16x3, bf16x3): streaming_fused_tc.cu
  if constexpr (MODE == S_PLAIN) {
    if (rot == BF16X3 && ct == BF16X3)
      return by_h<MODE, BF16X3, BF16X3>(need_h, bt, p, ng, st);
  }
  if (rot == BF16 && ct == BF16) return by_h<MODE, BF16, BF16>(need_h, bt, p, ng, st);
  if (rot == BF16 && ct == BF16X3)  // bf16 X at the bf16x3 tier
    return by_h<MODE, BF16, BF16X3>(need_h, bt, p, ng, st);
  return cudaErrorInvalidValue;
}

SParams make_params(int n, long long t, int need_ysq, int x_bf16, int dens,
                    double alpha, const float* w, const float* dm,
                    const void* x, int bt, int group, long long stride) {
  SParams p;
  p.n = n;
  p.t = t;
  p.need_ysq = need_ysq;
  p.x_bf16 = x_bf16;
  p.dens = dens;
  p.a = (float)alpha;
  p.m2a = (float)(-2.0 * alpha);
  p.mha = (float)(-alpha / 2.0);
  p.w = w;
  p.dm = dm;
  p.x = x;
  p.n_tiles = (int)((t + bt - 1) / bt);
  p.group = group;
  p.ll = p.dysq = p.g = p.pm = p.h = p.ysq = nullptr;
  p.stride = stride;
  return p;
}

bool bad_grid(int n, long long t, int dens, int bt, int group, int n_groups,
              long long stride) {
  if (n < 1 || n > STREAM_MAX_N || t < 1 || group < 1 || dens < TANH ||
      dens > CUBE || stride < 1)
    return true;
  const long long n_tiles = (t + bt - 1) / bt;
  return n_tiles > 0x7fffffffLL ||
         (long long)n_groups != (n_tiles + group - 1) / group;
}

}  // namespace

extern "C" {

int picard_stream_max_n() { return STREAM_MAX_N; }

// Columns a tile of the fused kernel takes at this N (0 above
// STREAM_MAX_N).
int picard_stream_tile(int n) { return n < 1 ? 0 : choose_bt(n); }

// Fused line-search try at large N. delta = 1: dll = sum [log_lik(M_new x)
// - log_lik(M_old x)] (analytic form), dysq = sum (2 y_old + dy) dy, with
// w = M_old and dm = M_new - M_old. delta = 0 (plain): dll = sum
// log_lik(M_new x), dysq = sum (M_new x)^2, with w = M_new (dm unused).
// One partial per output and group, at out + group index * stride;
// `group` tiles of picard_stream_tile(n) columns per partial.
int picard_streaming_fused_sums(int delta, int rot_tier, int ct_tier,
                                int density, int need_h, int need_ysq,
                                double alpha, int n, long long t, int x_bf16,
                                int group, const float* w, const float* dm,
                                const void* x, float* dll, float* dysq,
                                float* g, float* pm, float* h, float* ysq,
                                long long stride, int n_groups, void* stream) {
  const int bt = n < 1 ? 0 : choose_bt(n);
  if (bt == 0 || bad_grid(n, t, density, bt, group, n_groups, stride))
    return (int)cudaErrorInvalidValue;
  SParams p = make_params(n, t, need_ysq, x_bf16, density, alpha, w, dm, x,
                          bt, group, stride);
  p.ll = dll;
  p.dysq = dysq;
  p.g = g;
  p.pm = pm;
  p.h = h;
  p.ysq = ysq;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = delta
      ? by_tiers<S_DELTA>(rot_tier, ct_tier, need_h, bt, p, n_groups, st)
      : by_tiers<S_PLAIN>(rot_tier, ct_tier, need_h, bt, p, n_groups, st);
  return (int)e;
}

}  // extern "C"
