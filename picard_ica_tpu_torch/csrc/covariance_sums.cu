// Hand-written Hopper (sm_90a) kernels for the whitening statistics:
//
//   picard_row_sums        replaces picard_ica_tpu/ops/pallas_kernels.py
//                          row_sums / _row_sums_kernel (per-row sums, the
//                          mean's numerator);
//   picard_covariance_sums replaces covariance_sums / _covariance_kernel
//                          (X X^T), centered_covariance_sums /
//                          _centered_covariance_kernel ((X - mu)(X - mu)^T,
//                          centering in the tile load) and
//                          _grouped_covariance / _grouped_cov_kernel (either,
//                          with one partial per group of column chunks).
//
// Every kernel returns UNNORMALIZED partial sums, one per CHUNK columns of
// X (one per `group` chunks in the grouped form); the caller folds them
// pairwise (ops/moments.fold_pairwise). Blocks never share an output and
// there are no float atomics. Every accumulator is a sequential f32 sum
// over at most CHUNK columns (the grouped form adds its <= group chunk
// sums in order on top), which keeps the accuracy of the TPU kernels'
// per-tile partials: the eigenvectors of the covariance amplify its error
// by 1 / eigengap (picard_ica_tpu/ops/whitening.py).
//
// What bounds them on the card (H100 SXM: 3.35 TB/s of HBM, 33.5 T FMA/s
// of scalar FP32 outside the tensor cores):
//   row sums: one read of X and one add per element, bound by HBM (1.0 GB
//     at 64 x 4M f32, about 0.3 ms). Each warp streams one row of a chunk
//     with coalesced loads, 8 warps per block, and the block count
//     (chunks x rows / 8) keeps enough loads in flight.
//   covariance: 64 FMAs per element of X at N = 64 (16.8 G FMA at 64 x 4M,
//     about 0.5 ms of FP32 against 0.3 ms of HBM: near balance), and N FMAs
//     per element at large N (3.6e11 per 1M columns at N = 600: FP32-bound).
//     The grid runs over (column chunk x upper-triangle pair of 64 x 64
//     output tiles), so N has no shared-memory cap and the symmetry halves
//     the FMAs of the off-diagonal tiles. A block stages the two (64, BT)
//     row slabs in shared memory, column-major with a padded stride, centered
//     and masked as they are loaded; each of its 128 threads keeps an 8 x 4
//     register tile and reads three float4 per column for 32 FMAs, so the
//     inner loop is bound by the FMA pipes and not by shared memory, and
//     at most 128 registers a thread leave room for 4 blocks per SM, whose
//     loads overlap the others' FMAs. The tile is written with its mirror,
//     because NumPy's eigh reads the lower triangle. Exact f32 FMAs: no
//     TF32 and no tensor cores (later work).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC (picard_ica_tpu_torch/ops/_build.py).
// Every C entry returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 2048;          // columns of X per partial sum
constexpr int RS_THREADS = 256;      // row sums: 8 warps, one row each
constexpr int RS_ROWS = RS_THREADS / 32;
constexpr int TILE = 64;             // output tile edge (rows of a slab)
constexpr int BT = 64;               // columns staged per sub-tile
constexpr int STRIDE = TILE + 4;     // padded slab stride (one column's rows)
constexpr int COV_THREADS = 128;     // 8 x 16 threads, 8 x 4 outputs each
constexpr int RA = 8, RB = 4;        // register tile: rows x columns
constexpr int COV_BLOCKS_PER_SM = 4; // caps registers at 128 a thread
constexpr int MAX_GRID_Y = 65535;
static_assert(COV_THREADS == 128 && TILE == 64 && BT == 64,
              "load_slab maps 4 warps x 2 column groups onto a 64 x 64 slab");

// ---- row sums ----

__global__ void __launch_bounds__(RS_THREADS)
    row_sums_kernel(const float* __restrict__ x, int n, long long t,
                    float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.y * RS_ROWS + warp;
  if (row >= n) return;  // uniform across the warp
  const long long c0 = (long long)blockIdx.x * CHUNK;
  const long long c1 = c0 + CHUNK < t ? c0 + CHUNK : t;  // ragged tail
  const float* xr = x + (long long)row * t;
  float acc = 0.f;
#pragma unroll 8
  for (long long c = c0 + lane; c < c1; c += 32) acc += xr[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(long long)blockIdx.x * n + row] = acc;
}

// ---- covariance ----

// Stage rows [r0, r0 + 64) x columns [c0, c0 + BT) of X into s (column c
// at s[c * STRIDE], its 64 rows contiguous). A warp's lanes cover 8
// columns x 4 rows: the global loads are 32-byte row segments and the
// stores hit 32 distinct banks; each thread handles 2 columns x 16 rows.
// The means are read and every global load is issued before the first
// store, so no store into s (which the compiler cannot tell apart from
// smean) holds back a load. Entries outside [0, n) x [0, t) are 0; in the
// centered form the mean is subtracted first and those entries still stay
// 0, so padding adds 0 to the sums and not mean^2.
template <bool CENTERED>
__device__ __forceinline__ void load_slab(float* s, const float* smean,
                                          const float* __restrict__ x, int n,
                                          long long t, int r0, long long c0) {
  constexpr int ROWS = TILE / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r_lo = lane >> 3;
  float mu[ROWS];
#pragma unroll
  for (int rh = 0; rh < ROWS; ++rh) mu[rh] = CENTERED ? smean[4 * rh + r_lo] : 0.f;
  float v[2][ROWS];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long col = c0 + (warp + 4 * h) * 8 + (lane & 7);
    const float* src = x + (long long)(r0 + r_lo) * t + col;
#pragma unroll
    for (int rh = 0; rh < ROWS; ++rh) {
      v[h][rh] = col < t && r0 + 4 * rh + r_lo < n ? src[4 * rh * t] : 0.f;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long col = c0 + (warp + 4 * h) * 8 + (lane & 7);
    const int c = (warp + 4 * h) * 8 + (lane & 7);
#pragma unroll
    for (int rh = 0; rh < ROWS; ++rh) {
      const bool in = col < t && r0 + 4 * rh + r_lo < n;
      s[c * STRIDE + 4 * rh + r_lo] = in ? v[h][rh] - mu[rh] : 0.f;
    }
  }
}

// The slab rows of a thread's register tile: 4 at 4 q + u and 4 at
// 32 + 4 q + u, so the float4 reads of one column by a warp are
// contiguous.
__device__ __forceinline__ int reg_row(int q, int u) {
  return (u < 4 ? 0 : 32 - 4) + 4 * q + u;
}

// One block: output tile pair (ti, tj), ti <= tj, over the columns of one
// partial: `group` chunks of CHUNK columns (group = 1: one chunk). Each
// chunk is summed in registers, in column order; in the grouped form the
// chunk sums are added in order into the block's own partial in `out`
// (the TPU kernel's tile products added into its group accumulator), so
// no accumulator is deeper than CHUNK columns.
template <bool CENTERED>
__global__ void __launch_bounds__(COV_THREADS, COV_BLOCKS_PER_SM)
    covariance_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                      int n, long long t, int n_tiles, int n_pairs, int group,
                      float* __restrict__ out) {
  __shared__ __align__(16) float smem[2 * BT * STRIDE];
  __shared__ float smean[2 * TILE];

  const long long part = blockIdx.x / n_pairs;
  int p = blockIdx.x % n_pairs;
  int ti = 0;
  while (p >= n_tiles - ti) {
    p -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const bool diag = ti == tj;
  float* sa = smem;
  float* sb = smem + (diag ? 0 : BT * STRIDE);  // the diagonal reads one slab
  if (CENTERED) {
    for (int i = threadIdx.x; i < 2 * TILE; i += COV_THREADS) {
      const int row = (i < TILE ? ti : tj) * TILE + i % TILE;
      smean[i] = row < n ? mean[row] : 0.f;
    }
  }
  const int qa = threadIdx.x >> 4, qb = threadIdx.x & 15;
  float* o = out + part * (long long)n * n;

  const long long p0 = part * CHUNK * (long long)group;
  const long long p1 = p0 + (long long)CHUNK * group < t ? p0 + (long long)CHUNK * group : t;
  for (long long k0 = p0; k0 < p1; k0 += CHUNK) {
    float acc[RA][RB];
#pragma unroll
    for (int u = 0; u < RA; ++u)
#pragma unroll
      for (int v = 0; v < RB; ++v) acc[u][v] = 0.f;
    const long long k1 = k0 + CHUNK < p1 ? k0 + CHUNK : p1;
    for (long long c0 = k0; c0 < k1; c0 += BT) {
      __syncthreads();  // the previous sub-tile is consumed; smean is staged
      load_slab<CENTERED>(sa, smean, x, n, t, ti * TILE, c0);
      if (!diag) load_slab<CENTERED>(sb, smean + TILE, x, n, t, tj * TILE, c0);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BT; ++c) {
        const float* ca = sa + c * STRIDE;
        const float4 a0 = *reinterpret_cast<const float4*>(ca + 4 * qa);
        const float4 a1 = *reinterpret_cast<const float4*>(ca + 32 + 4 * qa);
        const float4 b = *reinterpret_cast<const float4*>(sb + c * STRIDE + 4 * qb);
        const float av[RA] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[RB] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < RA; ++u)
#pragma unroll
          for (int v = 0; v < RB; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
    }

    // Add the chunk to the partial; after the last chunk also write the
    // mirror. A diagonal tile is symmetric bit for bit (fmaf(a, b, c) ==
    // fmaf(b, a, c), same order), so only off-diagonal tiles mirror.
    const bool first = k0 == p0, last = k1 == p1;
#pragma unroll
    for (int u = 0; u < RA; ++u)
#pragma unroll
      for (int v = 0; v < RB; ++v) {
        const int i = ti * TILE + reg_row(qa, u);
        const int j = tj * TILE + 4 * qb + v;
        if (i < n && j < n) {
          float* dst = o + (long long)i * n + j;
          const float val = first ? acc[u][v] : *dst + acc[u][v];
          *dst = val;
          if (last && !diag) o[(long long)j * n + i] = val;
        }
      }
  }
}

template <bool CENTERED>
cudaError_t launch_cov(const float* x, const float* mean, int n, long long t,
                       int n_tiles, int n_pairs, int group, float* out,
                       long long blocks, cudaStream_t st) {
  covariance_kernel<CENTERED><<<(unsigned)blocks, COV_THREADS, 0, st>>>(
      x, mean, n, t, n_tiles, n_pairs, group, out);
  return cudaGetLastError();
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

int picard_cov_chunk() { return CHUNK; }

// Per-row sums of x (n, t) f32, one partial per CHUNK columns:
// out (n_parts, n), n_parts = ceil(t / CHUNK).
int picard_row_sums(int n, long long t, const float* x, float* out, int n_parts,
                    void* stream) {
  if (n < 1 || t < 1 || (long long)n_parts != ceil_div(t, CHUNK) ||
      ceil_div(n, RS_ROWS) > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n_parts, (unsigned)ceil_div(n, RS_ROWS));
  row_sums_kernel<<<grid, RS_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, n, t, out);
  return (int)cudaGetLastError();
}

// (x - mean)(x - mean)^T (mean may be null: x x^T) of x (n, t) f32, one
// partial per `group` chunks of CHUNK columns: out (n_parts, n, n),
// n_parts = ceil(ceil(t / CHUNK) / group). group = 1 is the per-chunk
// kernel; group > 1 the grouped one.
int picard_covariance_sums(int n, long long t, const float* x, const float* mean,
                           int group, float* out, int n_parts, void* stream) {
  if (n < 1 || t < 1 || group < 1 ||
      (long long)n_parts != ceil_div(ceil_div(t, CHUNK), group))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = ceil_div(n, TILE);
  const long long n_pairs = n_tiles * (n_tiles + 1) / 2;
  const long long blocks = n_pairs * n_parts;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nt = (int)n_tiles, np = (int)n_pairs;
  return (int)(mean != nullptr
                   ? launch_cov<true>(x, mean, n, t, nt, np, group, out, blocks, st)
                   : launch_cov<false>(x, mean, n, t, nt, np, group, out, blocks, st));
}

}  // extern "C"
