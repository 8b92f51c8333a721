// Hand-written Hopper (sm_90a) kernels for the whitening statistics:
//
//   picard_row_sums        replaces picard_ica_tpu/ops/pallas_kernels.py
//                          row_sums / _row_sums_kernel (per-row sums, the
//                          mean's numerator);
//   picard_covariance_sums replaces covariance_sums / _covariance_kernel
//                          (X X^T), centered_covariance_sums /
//                          _centered_covariance_kernel ((X - mu)(X - mu)^T,
//                          centering on chip) and _grouped_covariance /
//                          _grouped_cov_kernel (either, with one partial per
//                          group of column chunks);
//   picard_fold_pairwise   the fold of their partials on the device, in the
//                          order of ops/moments.fold_pairwise (the JAX
//                          package's _reduce_partials), bit for bit.
//
// Every kernel sums UNNORMALIZED partials, one per CHUNK columns of X (one
// per `group` chunks in the grouped form), and the fold adds them pairwise.
// Blocks never share an output and there are no float atomics. Every
// accumulator is an f32 sum over at most CHUNK columns (the grouped form
// adds its <= group chunk sums in order on top), which keeps the accuracy
// of the TPU kernels' per-tile partials: the eigenvectors of the covariance
// amplify its error by 1 / eigengap (picard_ica_tpu/ops/whitening.py).
//
// What bounds them on the card (H100 SXM: 3.35 TB/s of HBM, 33.5 T FMA/s
// of scalar FP32 outside the tensor cores):
//   row sums: one read of X, bound by HBM (1.0 GB at 64 x 4M f32, 0.31 ms).
//     One warp sums one (row, chunk) item; a grid of as many blocks as fit
//     on the SMs at once walks the items, and each lane issues all of its
//     16-byte loads of a chunk (16 of them) before it adds, so the loads in
//     flight cover HBM's latency. Rows that are not 16-byte aligned take
//     the same kernel with 4-byte loads.
//   covariance: N (N + 1) / 2 FMAs per column (8.3e9 at 64 x 4M: 0.25 ms of
//     FP32 against 0.31 ms of HBM; 1.8e11 at 600 x 1M: 5.4 ms, FP32-bound).
//     The output is cut into 64 x 64 tiles; a block owns one tile (pair) of
//     one partial. Off-diagonal tile pairs (ti < tj) compute all 64 x 64
//     products; a diagonal tile only its 72 8 x 4 sub-blocks that reach the
//     upper triangle (2,304 of 4,096 products), and the mirror is written. The
//     (rows, BT) slabs of X come through a ring of STAGES buffers filled by
//     cp.async (16-byte copies, or 4-byte ones for unaligned rows, with
//     zero-fill past the edges), so the next slabs land while the current
//     one is consumed. Each slab is centered once per element on chip,
//     while it is turned column-major for the FMA loop, and padded entries
//     stay exactly 0 (not -mean: X X^T - T mu mu^T would cancel). Each
//     thread keeps an 8 x 4 register tile (32 FMAs for three float4 reads a
//     column) over its share of the slab's columns (KS threads split every
//     slab), the KS shares are added in a fixed tree at the end of each
//     chunk, and the grouped form adds its chunk sums in order in
//     registers. Exact f32 FMAs: no TF32 and no tensor cores. On the H100
//     this reaches about 40 % of the bound (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC (picard_ica_tpu_torch/ops/_build.py).
// Every C entry returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 2048;      // columns of X per partial sum
constexpr int RS_THREADS = 256;  // row sums: 8 warps, one (row, chunk) each
constexpr int RS_VEC = CHUNK / 4 / 32;   // float4 loads per lane per chunk
constexpr int FOLD_COLS = 32;            // fold: elements per block
constexpr int FOLD_THREADS = 1024;       // 32 elements x 32 lanes
constexpr int TILE = 64;                 // output tile edge
constexpr int STAGES = 2;                // slabs in the cp.async ring

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

// ---- cp.async ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ---- row sums ----

// One warp per (row, chunk) item; item w is chunk w / n, row w % n, so the
// warps of a block read neighbouring rows of one chunk. VEC: 16-byte loads
// (rows 16-byte aligned, t % 4 == 0); a full chunk is 16 float4 a lane, all
// loaded before the first add.
template <bool VEC>
__global__ void __launch_bounds__(RS_THREADS)
    row_sums_kernel(const float* __restrict__ x, int n, long long t,
                    long long n_parts, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long items = n_parts * n;
  const long long step = ((long long)gridDim.x * RS_THREADS) >> 5;
  for (long long w = ((long long)blockIdx.x * RS_THREADS + threadIdx.x) >> 5; w < items;
       w += step) {
    const long long part = w / n;
    const int row = (int)(w - part * n);
    const long long c0 = part * CHUNK;
    const int len = (int)(c0 + CHUNK < t ? CHUNK : t - c0);
    const float* xr = x + (long long)row * t + c0;
    float acc = 0.f;
    if (VEC) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      if (len == CHUNK) {
        float4 v[RS_VEC];
#pragma unroll
        for (int k = 0; k < RS_VEC; ++k) v[k] = __ldg(x4 + lane + 32 * k);
#pragma unroll
        for (int k = 0; k < RS_VEC; ++k) acc += (v[k].x + v[k].y) + (v[k].z + v[k].w);
      } else {
#pragma unroll 4
        for (int k = lane; k < len / 4; k += 32) {
          const float4 v = __ldg(x4 + k);
          acc += (v.x + v.y) + (v.z + v.w);
        }
      }
    } else {
#pragma unroll 16
      for (int c = lane; c < len; c += 32) acc += __ldg(xr + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[part * n + row] = acc;
  }
}

// ---- the fold ----

// buf (p, m) -> dst (m): fold_pairwise's rounds, in place in buf. A round
// with p rows adds row half + i into row i (i < half = p / 2) and, for odd
// p, then adds row p - 1 into row 0; the same thread does row 0's two adds
// in that order. Rows >= half are never written in their round.
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(float* buf, int p, long long m, float* __restrict__ dst) {
  const long long e = (long long)blockIdx.x * FOLD_COLS + (threadIdx.x % FOLD_COLS);
  const int li = threadIdx.x / FOLD_COLS;
  const bool live = e < m;
  constexpr int LANES = FOLD_THREADS / FOLD_COLS;
  while (p > 1) {
    const int half = p / 2;
    if (live) {
#pragma unroll 4
      for (int i = li; i < half; i += LANES)
        buf[i * m + e] = buf[i * m + e] + buf[(half + i) * m + e];
      if ((p & 1) && li == 0) buf[e] = buf[e] + buf[(p - 1) * m + e];
    }
    __syncthreads();
    p = half;
  }
  if (live && li == 0) dst[e] = buf[e];
}

cudaError_t launch_fold(float* buf, int p, long long m, float* dst, cudaStream_t st) {
  const long long blocks = ceil_div(m, FOLD_COLS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fold_kernel<<<(unsigned)blocks, FOLD_THREADS, 0, st>>>(buf, p, m, dst);
  return cudaGetLastError();
}

// ---- covariance ----

// A block's shape. Each thread owns an RA x RB = 8 x 4 register tile
// (sub-block) of the output and CPS columns of every slab; KS threads share
// a sub-block. DIAG: one 64-row slab and the 72 sub-blocks of a diagonal
// tile that reach its upper triangle (rows 8 bi.., columns 4 cj.., cj >=
// 2 bi). Otherwise the slabs of two row tiles (128 rows: ti's, then tj's)
// and all 128 sub-blocks of the pair.
constexpr int RA = 8, RB = 4, EL = RA * RB;

template <bool DIAG>
struct Cov {
  static constexpr int ROWS = DIAG ? TILE : 2 * TILE;
  // Sub-blocks: a diagonal tile's that reach its upper triangle, all of
  // a pair's.
  static constexpr int JOBS = DIAG ? 72 : 128;
  static constexpr int KS = DIAG ? 2 : 1;       // threads sharing a sub-block
  static constexpr int THREADS = JOBS * KS;     // 144, 128
  static constexpr int BLOCKS = 3;              // an SM (shared memory)
  static constexpr int BT = DIAG ? 64 : 32;     // slab columns
  static constexpr int CPS = BT / KS;           // a thread's columns a slab: 32
  static constexpr int RSTR = BT + 4;           // raw slab row stride
  static constexpr int CSTR = ROWS + 4;         // column-major slab stride
  static constexpr int GS = JOBS * EL / THREADS;  // group sums a thread: 16, 32
  static constexpr int STAGE = ROWS * RSTR;
  static constexpr int RED = (KS > 1 ? KS / 2 : 1) * JOBS * EL;
  static constexpr int SMEM = 4 * (STAGES * STAGE + BT * CSTR + RED + ROWS);
  static_assert(CHUNK % BT == 0 && JOBS * EL % THREADS == 0 && RED >= JOBS * EL, "");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "BLOCKS blocks an SM");
};

// Row r of a block's slab -> row of X.
template <bool DIAG>
__device__ __forceinline__ int slab_row(int r, int ti, int tj) {
  return DIAG || r < TILE ? ti * TILE + r : tj * TILE + r - TILE;
}

// Issue the copies of slab columns [c0, c0 + BT) into the raw buffer s
// (row-major, stride RSTR); entries outside [0, n) x [0, t) are zero-filled.
template <bool DIAG, bool VEC>
__device__ __forceinline__ void load_slab(float* s, const float* __restrict__ x, int n,
                                          long long t, int ti, int tj, long long c0) {
  using S = Cov<DIAG>;
  constexpr int PER_ROW = VEC ? S::BT / 4 : S::BT;
  for (int u = threadIdx.x; u < S::ROWS * PER_ROW; u += S::THREADS) {
    const int r = u / PER_ROW, c = (u % PER_ROW) * (VEC ? 4 : 1);
    const int row = slab_row<DIAG>(r, ti, tj);
    const long long col = c0 + c;
    const bool in = row < n && col < t;  // VEC: t % 4 == 0, so col + 3 < t
    const float* src = in ? x + (long long)row * t + col : x;
    if (VEC)
      cp_async16(s + r * S::RSTR + c, src, in);
    else
      cp_async4(s + r * S::RSTR + c, src, in);
  }
}

// Sub-block of job j: its first a row and b row within the slab.
template <bool DIAG>
__device__ __forceinline__ void job_rows(int j, int& ra, int& rb) {
  constexpr int NB = TILE / RB, STEP = RA / RB;  // sub-block columns, per row block
  if (DIAG) {
    int bi = 0;
    while (j >= NB - STEP * bi) {
      j -= NB - STEP * bi;
      ++bi;
    }
    ra = RA * bi;
    rb = RB * (STEP * bi + j);
  } else {
    ra = RA * (j / NB);
    rb = TILE + RB * (j % NB);
  }
}

// One block: tile ti (DIAG) or tile pair (ti, tj) of one partial, whose
// columns are `group` chunks of CHUNK. Slabs of BT columns never straddle
// a chunk. Per chunk, thread (job j, share g) sums columns g CPS ..
// (g + 1) CPS - 1 of every slab into acc in column order; at the chunk's
// end the KS shares are added in a fixed tree ((g, g + KS/2), ...) and the
// chunk sum is added in order to the thread's GS group sums in registers.
// The last chunk writes the partial and its mirror.
template <bool DIAG, bool CENTERED, bool VEC>
__device__ __forceinline__ void covariance_block(const float* __restrict__ x,
                                                 const float* __restrict__ mean, int n,
                                                 long long t, int n_tiles, int n_pairs,
                                                 int group, float* __restrict__ out) {
  using S = Cov<DIAG>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                              // STAGES raw slabs
  float* cs = ring + STAGES * S::STAGE;            // column-major slab
  float* red = cs + S::BT * S::CSTR;               // chunk-end tree
  float* smean = red + S::RED;                     // slab rows' means

  const long long part = blockIdx.x / n_pairs;
  int p = blockIdx.x % n_pairs, ti = 0, tj = 0;
  if (DIAG) {
    ti = tj = p;
  } else {
    while (p >= n_tiles - 1 - ti) {
      p -= n_tiles - 1 - ti;
      ++ti;
    }
    tj = ti + 1 + p;
  }
  const int tid = threadIdx.x;
  const int job = tid % S::JOBS, share = tid / S::JOBS;
  int ra, rb;
  job_rows<DIAG>(job, ra, rb);
  for (int r = tid; r < S::ROWS; r += S::THREADS) {
    const int row = slab_row<DIAG>(r, ti, tj);
    smean[r] = CENTERED && row < n ? mean[row] : 0.f;
  }

  const long long p0 = part * CHUNK * (long long)group;
  const long long p1 = p0 + (long long)CHUNK * group < t ? p0 + (long long)CHUNK * group : t;
  const int n_slabs = (int)ceil_div(p1 - p0, S::BT);
  constexpr int SLABS_PER_CHUNK = CHUNK / S::BT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs) load_slab<DIAG, VEC>(ring + s * S::STAGE, x, n, t, ti, tj, p0 + s * S::BT);
    cp_async_commit();
  }

  float acc[RA][RB];
  float gsum[S::GS];
#pragma unroll
  for (int u = 0; u < RA; ++u)
#pragma unroll
    for (int v = 0; v < RB; ++v) acc[u][v] = 0.f;
  int chunk = 0;

  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slab s landed
    __syncthreads();  // everyone's copies landed; cs and stage s - 1 are free
    const int ahead = s + STAGES - 1;
    if (ahead < n_slabs)
      load_slab<DIAG, VEC>(ring + (ahead % STAGES) * S::STAGE, x, n, t, ti, tj,
                           p0 + (long long)ahead * S::BT);
    cp_async_commit();

    // Turn the slab column-major, centering each element once; padded
    // entries stay exactly 0.
    const float* raw = ring + (s % STAGES) * S::STAGE;
    const long long c0 = p0 + (long long)s * S::BT;
    const bool full = c0 + S::BT <= t;
    for (int u = tid; u < S::ROWS * S::BT / 4; u += S::THREADS) {
      const int r = u % S::ROWS, c = (u / S::ROWS) * 4;
      float4 v = *reinterpret_cast<const float4*>(raw + r * S::RSTR + c);
      if (CENTERED) {
        // Rows past n hold 0 and their mean is 0; only the columns of the
        // ragged last slab need the mask.
        const float mu = smean[r];
        if (full) {
          v.x -= mu, v.y -= mu, v.z -= mu, v.w -= mu;
        } else {
          const long long left = t - (c0 + c);
          v.x = left > 0 ? v.x - mu : 0.f;
          v.y = left > 1 ? v.y - mu : 0.f;
          v.z = left > 2 ? v.z - mu : 0.f;
          v.w = left > 3 ? v.w - mu : 0.f;
        }
      }
      cs[(c + 0) * S::CSTR + r] = v.x;
      cs[(c + 1) * S::CSTR + r] = v.y;
      cs[(c + 2) * S::CSTR + r] = v.z;
      cs[(c + 3) * S::CSTR + r] = v.w;
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < S::CPS; ++k) {
      const float* col = cs + (S::CPS * share + k) * S::CSTR;
      const float4 a0 = *reinterpret_cast<const float4*>(col + ra);
      const float4 a1 = *reinterpret_cast<const float4*>(col + ra + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(col + rb);
      const float av[RA] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[RB] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int u = 0; u < RA; ++u)
#pragma unroll
        for (int v = 0; v < RB; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }

    if ((s + 1) % SLABS_PER_CHUNK != 0 && s + 1 != n_slabs) continue;
    // End of a chunk: add the KS shares, element-major in red (share-half
    // h's element e of job j at red[h][e][j]) so the stores are conflict-free.
#pragma unroll
    for (int h = S::KS / 2; h >= 1; h /= 2) {
      if (share >= h && share < 2 * h) {
        float* dst = red + (share - h) * S::JOBS * EL + job;
#pragma unroll
        for (int e = 0; e < EL; ++e) dst[e * S::JOBS] = acc[e / RB][e % RB];
      }
      __syncthreads();
      if (share < h) {
        const float* src = red + share * S::JOBS * EL + job;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[e / RB][e % RB] += src[e * S::JOBS];
      }
      __syncthreads();
    }
    if (share == 0) {
#pragma unroll
      for (int e = 0; e < EL; ++e) red[e * S::JOBS + job] = acc[e / RB][e % RB];
    }
    __syncthreads();
    // Thread tid holds chunk sums tid + q * THREADS of red (element-major).
#pragma unroll
    for (int q = 0; q < S::GS; ++q) {
      const float c = red[q * S::THREADS + tid];
      gsum[q] = chunk == 0 ? c : gsum[q] + c;
    }
#pragma unroll
    for (int u = 0; u < RA; ++u)
#pragma unroll
      for (int v = 0; v < RB; ++v) acc[u][v] = 0.f;
    ++chunk;
  }

  // The partial: entry (i, j) with i <= j and its mirror. Every entry of
  // the upper triangle lies in exactly one sub-block, so each value is
  // computed once and the output is symmetric bit for bit.
  float* o = out + part * (long long)n * n;
#pragma unroll
  for (int q = 0; q < S::GS; ++q) {
    const int idx = q * S::THREADS + tid;
    const int e = idx / S::JOBS, jb = idx % S::JOBS;
    int a, b;
    job_rows<DIAG>(jb, a, b);
    const int i = slab_row<DIAG>(a + e / RB, ti, tj);
    const int j = slab_row<DIAG>(b + e % RB, ti, tj);
    if (i <= j && j < n) {
      o[(long long)i * n + j] = gsum[q];
      o[(long long)j * n + i] = gsum[q];
    }
  }
}

// Cov<DIAG>::BLOCKS blocks an SM: the diagonal kernel's 144 threads may take
// 136 registers each, the pair kernel's 128 threads 168 (no spills).
template <bool CENTERED, bool VEC>
__global__ void __maxnreg__(136) cov_diag_kernel(const float* __restrict__ x,
                                                 const float* __restrict__ mean, int n,
                                                 long long t, int n_tiles, int n_pairs,
                                                 int group, float* __restrict__ out) {
  covariance_block<true, CENTERED, VEC>(x, mean, n, t, n_tiles, n_pairs, group, out);
}

template <bool CENTERED, bool VEC>
__global__ void __maxnreg__(168) cov_pair_kernel(const float* __restrict__ x,
                                                 const float* __restrict__ mean, int n,
                                                 long long t, int n_tiles, int n_pairs,
                                                 int group, float* __restrict__ out) {
  covariance_block<false, CENTERED, VEC>(x, mean, n, t, n_tiles, n_pairs, group, out);
}

constexpr int MAX_DEVICES = 64;

template <bool DIAG, bool CENTERED, bool VEC>
cudaError_t launch_cov_kernel(const float* x, const float* mean, int n, long long t,
                              int n_tiles, int n_pairs, int group, float* out,
                              long long blocks, cudaStream_t st) {
  using S = Cov<DIAG>;
  auto kernel = DIAG ? cov_diag_kernel<CENTERED, VEC> : cov_pair_kernel<CENTERED, VEC>;
  // The shared-memory opt-in, once per device (a launch asks again only
  // on a device not seen yet).
  static bool opted_in[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES || !opted_in[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) opted_in[device] = true;
  }
  kernel<<<(unsigned)blocks, S::THREADS, S::SMEM, st>>>(x, mean, n, t, n_tiles, n_pairs,
                                                         group, out);
  return cudaGetLastError();
}

template <bool DIAG>
cudaError_t launch_cov(const float* x, const float* mean, bool vec, int n, long long t,
                       int n_tiles, int n_pairs, int group, float* out, long long blocks,
                       cudaStream_t st) {
  if (mean != nullptr)
    return vec ? launch_cov_kernel<DIAG, true, true>(x, mean, n, t, n_tiles, n_pairs, group,
                                                     out, blocks, st)
               : launch_cov_kernel<DIAG, true, false>(x, mean, n, t, n_tiles, n_pairs,
                                                      group, out, blocks, st);
  return vec ? launch_cov_kernel<DIAG, false, true>(x, mean, n, t, n_tiles, n_pairs, group,
                                                    out, blocks, st)
             : launch_cov_kernel<DIAG, false, false>(x, mean, n, t, n_tiles, n_pairs, group,
                                                     out, blocks, st);
}

// The 16-byte load path: every row of x (n, t) starts 16-byte aligned.
// Otherwise (a row view x[1:] of odd t, an offset view) the 4-byte one.
bool vec_ok(const float* x, long long t) {
  return t % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
}

}  // namespace

extern "C" {

int picard_cov_chunk() { return CHUNK; }

// Fold buf (p, m) into dst (m) in fold_pairwise's order; buf is scratch.
int picard_fold_pairwise(int p, long long m, float* buf, float* dst, void* stream) {
  if (p < 1 || m < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_fold(buf, p, m, dst, reinterpret_cast<cudaStream_t>(stream));
}

// Per-row sums of x (n, t) f32 into out (n): one partial per CHUNK
// columns into parts (n_parts, n), n_parts = ceil(t / CHUNK), folded on
// the device.
int picard_row_sums(int n, long long t, const float* x, float* parts, int n_parts, float* out,
                    void* stream) {
  if (n < 1 || t < 1 || (long long)n_parts != ceil_div(t, CHUNK))
    return (int)cudaErrorInvalidValue;
  const bool vec = vec_ok(x, t);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  void (*kernel)(const float*, int, long long, long long, float*) =
      vec ? row_sums_kernel<true> : row_sums_kernel<false>;
  // As many blocks as the SMs hold at once (asked once per device and
  // load path), fewer for a small input.
  static int fill_of[MAX_DEVICES][2] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int fill = device < MAX_DEVICES ? fill_of[device][vec ? 1 : 0] : 0;
  if (fill == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RS_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    fill = sms * (per_sm > 0 ? per_sm : 1);
    if (device < MAX_DEVICES) fill_of[device][vec ? 1 : 0] = fill;
  }
  const long long needed = ceil_div((long long)n_parts * n, RS_THREADS / 32);
  const unsigned blocks = (unsigned)(needed < fill ? needed : (long long)fill);
  kernel<<<blocks, RS_THREADS, 0, st>>>(x, n, t, n_parts, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold(parts, n_parts, n, out, st);
}

// (x - mean)(x - mean)^T (mean may be null: x x^T) of x (n, t) f32 into
// out (n, n): one partial per `group` chunks of CHUNK columns into parts
// (n_parts, n, n), n_parts = ceil(ceil(t / CHUNK) / group), folded on the
// device. group = 1 is the per-chunk kernel; group > 1 the grouped one.
int picard_covariance_sums(int n, long long t, const float* x, const float* mean, int group,
                           float* parts, int n_parts, float* out, void* stream) {
  if (n < 1 || t < 1 || group < 1 || (long long)n_parts != ceil_div(ceil_div(t, CHUNK), group))
    return (int)cudaErrorInvalidValue;
  const bool vec = vec_ok(x, t);
  const long long n_tiles = ceil_div(n, TILE);
  const long long n_off = n_tiles * (n_tiles - 1) / 2;
  if ((n_off > 0 ? n_off : n_tiles) * n_parts > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nt = (int)n_tiles;
  cudaError_t err = cudaSuccess;
  if (n_off > 0)
    err = launch_cov<false>(x, mean, vec, n, t, nt, (int)n_off, group, parts, n_off * n_parts,
                            st);
  if (err == cudaSuccess)
    err = launch_cov<true>(x, mean, vec, n, t, nt, nt, group, parts, n_tiles * n_parts, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold(parts, n_parts, (long long)n * n, out, st);
}

}  // extern "C"
