// Native f64 conformance oracle for the Picard ICA solver.
//
// An independent C++ implementation of the exact algorithm the
// reference implements (reference: src/core.rs:162-401, solver.rs:45-189,
// whitening.rs:24-110, lbfgs.rs:84-171, density.rs, math.rs), written
// from the algorithm specification in SURVEY.md. Its role mirrors the
// Rust reference's: a sequential double-precision CPU ground truth the
// PyTorch + CUDA solver (f32 on the GPU's kernels, f64 on the CPU) is
// validated against — BASELINE.md demands Amari distance < 1e-3 vs the
// reference on all bench mixtures, and conformance runs go through this
// oracle in place of the Rust reference. It runs on the host in f64
// wherever the solver runs, the GPU's machine included.
//
// Everything is plain C++17 + OpenMP over the T (samples) axis; the
// N x N work is sequential, exactly like the reference. No LAPACK: the
// only decompositions needed are a symmetric N x N eigh (cyclic Jacobi)
// and an LU signed log-determinant, both hand-rolled below.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

#include <cstdio>
#include <cstdlib>

#if defined(__AVX512F__)
#include <immintrin.h>
// glibc libmvec AVX-512 vector math: 8 doubles per call, <= 4 ulp.
// Used for the O(N*T) transcendental passes (score + log-lik) that
// dominate oracle runtime at conformance scales (T >= 100k); the <=4ulp
// elementwise difference vs scalar libm is far below the amari < 1e-9
// lockstep tolerance in tests/test_torch_native.py.
extern "C" {
__m512d _ZGVeN8v_tanh(__m512d);
__m512d _ZGVeN8v_exp(__m512d);
__m512d _ZGVeN8v_log1p(__m512d);
}
#define PICARD_ORACLE_AVX512 1
#endif

namespace {

using std::size_t;

constexpr double kSingularLoss = 1e15;    // core.rs:90-96
constexpr double kMinEig = 1e-10;         // math.rs:22, whitening.rs:77
constexpr int kFallbackLsTries = 10;      // core.rs:361

// ---------------------------------------------------------------------------
// Dense row-major helpers. Matrices are (rows, cols), row-major.
// ---------------------------------------------------------------------------

struct Mat {
    int r = 0, c = 0;
    std::vector<double> d;
    Mat() = default;
    Mat(int r_, int c_) : r(r_), c(c_), d(static_cast<size_t>(r_) * c_, 0.0) {}
    double &at(int i, int j) { return d[static_cast<size_t>(i) * c + j]; }
    double at(int i, int j) const { return d[static_cast<size_t>(i) * c + j]; }
};

Mat eye(int n) {
    Mat m(n, n);
    for (int i = 0; i < n; ++i) m.at(i, i) = 1.0;
    return m;
}

// Dot product with manual 4x8-wide FMA accumulators (a plain reduction
// loop will not vectorize without -ffast-math reassociation).
double vdot(const double *a, const double *b, int n) {
#ifdef PICARD_ORACLE_AVX512
    __m512d a0 = _mm512_setzero_pd(), a1 = _mm512_setzero_pd();
    __m512d a2 = _mm512_setzero_pd(), a3 = _mm512_setzero_pd();
    int s = 0;
    for (; s + 32 <= n; s += 32) {
        a0 = _mm512_fmadd_pd(_mm512_loadu_pd(a + s), _mm512_loadu_pd(b + s), a0);
        a1 = _mm512_fmadd_pd(_mm512_loadu_pd(a + s + 8),
                             _mm512_loadu_pd(b + s + 8), a1);
        a2 = _mm512_fmadd_pd(_mm512_loadu_pd(a + s + 16),
                             _mm512_loadu_pd(b + s + 16), a2);
        a3 = _mm512_fmadd_pd(_mm512_loadu_pd(a + s + 24),
                             _mm512_loadu_pd(b + s + 24), a3);
    }
    for (; s + 8 <= n; s += 8)
        a0 = _mm512_fmadd_pd(_mm512_loadu_pd(a + s), _mm512_loadu_pd(b + s), a0);
    double acc = _mm512_reduce_add_pd(
        _mm512_add_pd(_mm512_add_pd(a0, a1), _mm512_add_pd(a2, a3)));
    for (; s < n; ++s) acc += a[s] * b[s];
    return acc;
#else
    double acc = 0.0;
    for (int s = 0; s < n; ++s) acc += a[s] * b[s];
    return acc;
#endif
}

#ifdef PICARD_ORACLE_AVX512
// 4x4 register-blocked dot tile: out[r][c] += a_r . b_c over len.
// 16 zmm accumulators + 8 streams; compute-bound at FMA throughput.
void dot4x4(const double *const a[4], const double *const b[4], int len,
            Mat &out, int i, int j, int t_unused) {
    (void)t_unused;
    __m512d acc[4][4];
    for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) acc[r][c] = _mm512_setzero_pd();
    int s = 0;
    for (; s + 8 <= len; s += 8) {
        __m512d bv[4];
        for (int c = 0; c < 4; ++c) bv[c] = _mm512_loadu_pd(b[c] + s);
        for (int r = 0; r < 4; ++r) {
            __m512d av = _mm512_loadu_pd(a[r] + s);
            for (int c = 0; c < 4; ++c)
                acc[r][c] = _mm512_fmadd_pd(av, bv[c], acc[r][c]);
        }
    }
    for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
            double v = _mm512_reduce_add_pd(acc[r][c]);
            for (int s2 = s; s2 < len; ++s2) v += a[r][s2] * b[c][s2];
            out.at(i + r, j + c) += v;
        }
}
#endif

// C = A * B. AVX-512 path: 16-column zmm strips with 4-row blocks of A
// broadcast-FMA'd against B's column strip; accumulators live in
// registers for the whole k sweep so B and C are streamed from DRAM
// once. B's access is strided (row length apart), which exceeds the
// hardware prefetcher's stream capacity for N >= ~32 rows, so the next
// strip's B lines are software-prefetched while the current strip
// computes.
Mat matmul(const Mat &a, const Mat &b) {
    Mat out(a.r, b.c);
#ifdef PICARD_ORACLE_AVX512
    int c0 = 0;
    for (; c0 + 16 <= b.c; c0 += 16) {
        if (c0 + 32 <= b.c) {
            for (int k = 0; k < a.c; ++k) {
                const char *nxt = reinterpret_cast<const char *>(
                    &b.d[static_cast<size_t>(k) * b.c + c0 + 16]);
                _mm_prefetch(nxt, _MM_HINT_T0);
                _mm_prefetch(nxt + 64, _MM_HINT_T0);
            }
        }
        int i = 0;
        for (; i + 4 <= a.r; i += 4) {
            __m512d acc[4][2];
            for (int r = 0; r < 4; ++r)
                for (int h = 0; h < 2; ++h) acc[r][h] = _mm512_setzero_pd();
            for (int k = 0; k < a.c; ++k) {
                const double *bk = &b.d[static_cast<size_t>(k) * b.c + c0];
                __m512d b0 = _mm512_loadu_pd(bk);
                __m512d b1 = _mm512_loadu_pd(bk + 8);
                for (int r = 0; r < 4; ++r) {
                    __m512d av = _mm512_set1_pd(a.at(i + r, k));
                    acc[r][0] = _mm512_fmadd_pd(av, b0, acc[r][0]);
                    acc[r][1] = _mm512_fmadd_pd(av, b1, acc[r][1]);
                }
            }
            for (int r = 0; r < 4; ++r) {
                double *orow = &out.d[static_cast<size_t>(i + r) * b.c + c0];
                _mm512_storeu_pd(orow, acc[r][0]);
                _mm512_storeu_pd(orow + 8, acc[r][1]);
            }
        }
        for (; i < a.r; ++i) {
            __m512d a0 = _mm512_setzero_pd(), a1 = _mm512_setzero_pd();
            for (int k = 0; k < a.c; ++k) {
                const double *bk = &b.d[static_cast<size_t>(k) * b.c + c0];
                __m512d av = _mm512_set1_pd(a.at(i, k));
                a0 = _mm512_fmadd_pd(av, _mm512_loadu_pd(bk), a0);
                a1 = _mm512_fmadd_pd(av, _mm512_loadu_pd(bk + 8), a1);
            }
            double *orow = &out.d[static_cast<size_t>(i) * b.c + c0];
            _mm512_storeu_pd(orow, a0);
            _mm512_storeu_pd(orow + 8, a1);
        }
    }
    if (c0 < b.c) {
        for (int i = 0; i < a.r; ++i) {
            double *orow = &out.d[static_cast<size_t>(i) * b.c];
            for (int k = 0; k < a.c; ++k) {
                double aik = a.at(i, k);
                const double *brow = &b.d[static_cast<size_t>(k) * b.c];
                for (int j = c0; j < b.c; ++j) orow[j] += aik * brow[j];
            }
        }
    }
#else
    for (int i = 0; i < a.r; ++i) {
        for (int k = 0; k < a.c; ++k) {
            double aik = a.at(i, k);
            if (aik == 0.0) continue;
            const double *brow = &b.d[static_cast<size_t>(k) * b.c];
            double *orow = &out.d[static_cast<size_t>(i) * b.c];
            for (int j = 0; j < b.c; ++j) orow[j] += aik * brow[j];
        }
    }
#endif
    return out;
}

// C = A * B^T / scale (the N x T moment contraction), blocked over T so
// each chunk of both operands is read from memory once (O(N*T) traffic
// instead of the naive O(N^2*T)), with 4x4 register-tiled dot kernels.
Mat matmul_bt_scaled(const Mat &a, const Mat &b, double inv_scale) {
    Mat out(a.r, b.r);
    int t = a.c;
    // Chunk so both (N, chunk) panels fit in L2 (~0.5 MB each).
    int tc = std::max(256, 131072 / std::max(a.r, b.r));
    for (int t0 = 0; t0 < t; t0 += tc) {
        int len = std::min(t, t0 + tc) - t0;
        int i = 0;
#ifdef PICARD_ORACLE_AVX512
        for (; i + 4 <= a.r; i += 4) {
            const double *ar[4];
            for (int r = 0; r < 4; ++r)
                ar[r] = &a.d[static_cast<size_t>(i + r) * t + t0];
            int j = 0;
            for (; j + 4 <= b.r; j += 4) {
                const double *br[4];
                for (int c = 0; c < 4; ++c)
                    br[c] = &b.d[static_cast<size_t>(j + c) * t + t0];
                dot4x4(ar, br, len, out, i, j, t);
            }
            for (; j < b.r; ++j) {
                const double *brj = &b.d[static_cast<size_t>(j) * t + t0];
                for (int r = 0; r < 4; ++r)
                    out.at(i + r, j) += vdot(ar[r], brj, len);
            }
        }
#endif
        for (; i < a.r; ++i) {
            const double *ari = &a.d[static_cast<size_t>(i) * t + t0];
            for (int j = 0; j < b.r; ++j)
                out.at(i, j) +=
                    vdot(ari, &b.d[static_cast<size_t>(j) * t + t0], len);
        }
    }
    if (inv_scale != 1.0)
        for (double &x : out.d) x *= inv_scale;
    return out;
}

double max_abs(const Mat &m) {
    double v = 0.0;
    for (double x : m.d) v = std::max(v, std::fabs(x));
    return v;
}

// ---------------------------------------------------------------------------
// Symmetric eigendecomposition: cyclic Jacobi (ascending eigenvalues).
// ---------------------------------------------------------------------------

void jacobi_eigh(const Mat &a_in, std::vector<double> &evals, Mat &evecs) {
    int n = a_in.r;
    Mat a = a_in;
    evecs = eye(n);
    // Convergence threshold RELATIVE to the matrix scale: the
    // unnormalized covariance X X^T has entries ~T, so a fixed
    // absolute 1e-28 is unreachable (post-convergence off-diagonal
    // rounding noise ~ (|a| * 1e-16)^2 * n^2) and every whiten would
    // burn all 100 O(n^3) sweeps on a single core. off/frob^2
    // < 1e-29 leaves the off-diagonal norm at ~3e-15 relative — far
    // below the oracle's 1e-12 conformance tolerances — while the
    // quadratically-convergent sweep reaches it in ~8 passes.
    double frob2 = 0.0;
    for (double v : a.d) frob2 += v * v;
    double off_tol = std::max(1e-28, 1e-29 * frob2);
    for (int sweep = 0; sweep < 100; ++sweep) {
        double off = 0.0;
        for (int p = 0; p < n; ++p)
            for (int q = p + 1; q < n; ++q) off += a.at(p, q) * a.at(p, q);
        if (off < off_tol) break;
        for (int p = 0; p < n; ++p) {
            for (int q = p + 1; q < n; ++q) {
                double apq = a.at(p, q);
                if (std::fabs(apq) < 1e-300) continue;
                double theta = 0.5 * (a.at(q, q) - a.at(p, p)) / apq;
                double t = (theta >= 0 ? 1.0 : -1.0) /
                           (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
                double c = 1.0 / std::sqrt(t * t + 1.0);
                double s = t * c;
                for (int k = 0; k < n; ++k) {
                    double akp = a.at(k, p), akq = a.at(k, q);
                    a.at(k, p) = c * akp - s * akq;
                    a.at(k, q) = s * akp + c * akq;
                }
                for (int k = 0; k < n; ++k) {
                    double apk = a.at(p, k), aqk = a.at(q, k);
                    a.at(p, k) = c * apk - s * aqk;
                    a.at(q, k) = s * apk + c * aqk;
                }
                for (int k = 0; k < n; ++k) {
                    double vkp = evecs.at(k, p), vkq = evecs.at(k, q);
                    evecs.at(k, p) = c * vkp - s * vkq;
                    evecs.at(k, q) = s * vkp + c * vkq;
                }
            }
        }
    }
    evals.resize(n);
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::vector<double> diag(n);
    for (int i = 0; i < n; ++i) diag[i] = a.at(i, i);
    std::sort(order.begin(), order.end(),
              [&](int x, int y) { return diag[x] < diag[y]; });
    Mat sorted(n, n);
    for (int j = 0; j < n; ++j) {
        evals[j] = diag[order[j]];
        for (int i = 0; i < n; ++i) sorted.at(i, j) = evecs.at(i, order[j]);
    }
    evecs = sorted;
}

// W <- (W W^T)^{-1/2} W  (math.rs:12-33). Returns min eigenvalue.
double sym_decorrelation(Mat &w) {
    int n = w.r;
    Mat wwt = matmul_bt_scaled(w, w, 1.0);
    std::vector<double> evals;
    Mat u;
    jacobi_eigh(wwt, evals, u);
    double min_eig = evals[0];
    Mat proj(n, n);
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) {
            double acc = 0.0;
            for (int k = 0; k < n; ++k) {
                double ek = std::max(evals[k], 1e-300);
                acc += u.at(i, k) * u.at(j, k) / std::sqrt(ek);
            }
            proj.at(i, j) = acc;
        }
    w = matmul(proj, w);
    return min_eig;
}

// Signed log-determinant via LU with partial pivoting (math.rs:84-88).
void slogdet(const Mat &m_in, double *sign, double *logabs) {
    int n = m_in.r;
    Mat m = m_in;
    double sgn = 1.0, logsum = 0.0;
    for (int k = 0; k < n; ++k) {
        int piv = k;
        for (int i = k + 1; i < n; ++i)
            if (std::fabs(m.at(i, k)) > std::fabs(m.at(piv, k))) piv = i;
        if (m.at(piv, k) == 0.0) {
            *sign = 0.0;
            *logabs = -std::numeric_limits<double>::infinity();
            return;
        }
        if (piv != k) {
            for (int j = 0; j < n; ++j) std::swap(m.at(k, j), m.at(piv, j));
            sgn = -sgn;
        }
        double pivot = m.at(k, k);
        if (pivot < 0) sgn = -sgn;
        logsum += std::log(std::fabs(pivot));
        for (int i = k + 1; i < n; ++i) {
            double f = m.at(i, k) / pivot;
            for (int j = k; j < n; ++j) m.at(i, j) -= f * m.at(k, j);
        }
    }
    *sign = sgn;
    *logabs = logsum;
}

// Matrix exponential: scaling-and-squaring Taylor series (math.rs:38-74).
Mat matrix_exp(const Mat &a) {
    int n = a.r;
    double norm = max_abs(a);
    if (norm < 1e-15) return eye(n);
    int s = std::max(0, static_cast<int>(std::ceil(std::log2(norm))));
    Mat a_scaled = a;
    double scale = std::ldexp(1.0, s);
    for (double &x : a_scaled.d) x /= scale;
    Mat result = eye(n), term = eye(n);
    for (int k = 1; k <= 30; ++k) {
        term = matmul(term, a_scaled);
        for (double &x : term.d) x /= k;
        for (size_t i = 0; i < result.d.size(); ++i) result.d[i] += term.d[i];
        if (max_abs(term) < 1e-16) break;
    }
    for (int i = 0; i < s; ++i) result = matmul(result, result);
    return result;
}

// ---------------------------------------------------------------------------
// Densities (density.rs): log-lik, score, score-derivative.
// ---------------------------------------------------------------------------

enum DensityType { kTanh = 0, kExp = 1, kCube = 2 };

struct Density {
    int type;
    double alpha;

    double log_lik(double y) const {
        switch (type) {
            case kTanh: {
                double ay = std::fabs(y);
                return ay + std::log1p(std::exp(-2.0 * alpha * ay)) / alpha;
            }
            case kExp:
                return -std::exp(-alpha * y * y / 2.0) / alpha;
            default:  // kCube
                return y * y * y * y / 4.0;
        }
    }
    void score_and_der(double y, double *psi, double *psi_d) const {
        switch (type) {
            case kTanh: {
                double s = std::tanh(alpha * y);
                *psi = s;
                *psi_d = alpha * (1.0 - s * s);
                break;
            }
            case kExp: {
                double k = std::exp(-alpha * y * y / 2.0);
                *psi = y * k;
                *psi_d = (1.0 - alpha * y * y) * k;
                break;
            }
            default: {
                *psi = y * y * y;
                *psi_d = 3.0 * y * y;
            }
        }
    }

    // Vectorized row passes (8-wide via libmvec). Semantics identical
    // to the scalar forms above / density.rs; scalar tail for t % 8.
    void score_row(const double *y, double *psi, double *psi_d, int t) const {
        int s = 0;
#ifdef PICARD_ORACLE_AVX512
        const __m512d va = _mm512_set1_pd(alpha);
        const __m512d one = _mm512_set1_pd(1.0);
        switch (type) {
            case kTanh:
                for (; s + 8 <= t; s += 8) {
                    __m512d vy = _mm512_loadu_pd(y + s);
                    __m512d sh = _ZGVeN8v_tanh(_mm512_mul_pd(va, vy));
                    _mm512_storeu_pd(psi + s, sh);
                    _mm512_storeu_pd(
                        psi_d + s,
                        _mm512_mul_pd(
                            va, _mm512_fnmadd_pd(sh, sh, one)));
                }
                break;
            case kExp: {
                const __m512d mhalf_a = _mm512_set1_pd(-0.5 * alpha);
                for (; s + 8 <= t; s += 8) {
                    __m512d vy = _mm512_loadu_pd(y + s);
                    __m512d ysq = _mm512_mul_pd(vy, vy);
                    __m512d k = _ZGVeN8v_exp(_mm512_mul_pd(mhalf_a, ysq));
                    _mm512_storeu_pd(psi + s, _mm512_mul_pd(vy, k));
                    _mm512_storeu_pd(
                        psi_d + s,
                        _mm512_mul_pd(_mm512_fnmadd_pd(va, ysq, one), k));
                }
                break;
            }
            default: {
                const __m512d three = _mm512_set1_pd(3.0);
                for (; s + 8 <= t; s += 8) {
                    __m512d vy = _mm512_loadu_pd(y + s);
                    __m512d ysq = _mm512_mul_pd(vy, vy);
                    _mm512_storeu_pd(psi + s, _mm512_mul_pd(ysq, vy));
                    _mm512_storeu_pd(psi_d + s, _mm512_mul_pd(three, ysq));
                }
            }
        }
#endif
        for (; s < t; ++s) score_and_der(y[s], &psi[s], &psi_d[s]);
    }

    // Sum of log_lik over a row (the line-search loss reduction).
    double loglik_row_sum(const double *y, int t) const {
        int s = 0;
        double tail = 0.0;
#ifdef PICARD_ORACLE_AVX512
        __m512d acc = _mm512_setzero_pd();
        switch (type) {
            case kTanh: {
                const __m512d m2a = _mm512_set1_pd(-2.0 * alpha);
                const __m512d inva = _mm512_set1_pd(1.0 / alpha);
                for (; s + 8 <= t; s += 8) {
                    __m512d ay = _mm512_abs_pd(_mm512_loadu_pd(y + s));
                    __m512d e = _ZGVeN8v_exp(_mm512_mul_pd(m2a, ay));
                    __m512d l = _ZGVeN8v_log1p(e);
                    acc = _mm512_add_pd(acc, _mm512_fmadd_pd(l, inva, ay));
                }
                break;
            }
            case kExp: {
                const __m512d mhalf_a = _mm512_set1_pd(-0.5 * alpha);
                const __m512d minva = _mm512_set1_pd(-1.0 / alpha);
                for (; s + 8 <= t; s += 8) {
                    __m512d vy = _mm512_loadu_pd(y + s);
                    __m512d k =
                        _ZGVeN8v_exp(_mm512_mul_pd(mhalf_a, _mm512_mul_pd(vy, vy)));
                    acc = _mm512_fmadd_pd(minva, k, acc);
                }
                break;
            }
            default: {
                const __m512d quarter = _mm512_set1_pd(0.25);
                for (; s + 8 <= t; s += 8) {
                    __m512d vy = _mm512_loadu_pd(y + s);
                    __m512d ysq = _mm512_mul_pd(vy, vy);
                    acc = _mm512_fmadd_pd(_mm512_mul_pd(ysq, ysq), quarter, acc);
                }
            }
        }
        tail = _mm512_reduce_add_pd(acc);
#endif
        for (; s < t; ++s) tail += log_lik(y[s]);
        return tail;
    }
};

// ---------------------------------------------------------------------------
// Loss (core.rs:39-85): -log|det W| (non-ortho) + sum_i signs_i E[loglik(Y_i)]
// (+ 0.5 sum E[Y_i^2] when extended && !ortho). Singular -> 1e15 penalty.
// ---------------------------------------------------------------------------

double compute_loss(const Mat &y, const Mat &w, const std::vector<double> &signs,
                    const Density &den, bool ortho, bool extended) {
    int n = y.r, t = y.c;
    double loss = 0.0;
    if (!ortho) {
        double sign, logabs;
        slogdet(w, &sign, &logabs);
        if (sign == 0.0 || !std::isfinite(logabs)) return kSingularLoss;
        loss -= logabs;
    }
    double inv_t = 1.0 / t;
    double acc_total = 0.0;
#pragma omp parallel for reduction(+ : acc_total)
    for (int i = 0; i < n; ++i) {
        const double *row = &y.d[static_cast<size_t>(i) * t];
        double term = signs[i] * den.loglik_row_sum(row, t) * inv_t;
        if (extended && !ortho) term += 0.5 * vdot(row, row, t) * inv_t;
        acc_total += term;
    }
    loss += acc_total;
    return std::isfinite(loss) ? loss : kSingularLoss;
}

// ---------------------------------------------------------------------------
// L-BFGS pieces (lbfgs.rs:84-171).
// ---------------------------------------------------------------------------

struct LbfgsMem {
    std::vector<Mat> s, y;
    std::vector<double> r;
    void clear() { s.clear(); y.clear(); r.clear(); }
};

double frob_dot(const Mat &a, const Mat &b) {
    double acc = 0.0;
    for (size_t i = 0; i < a.d.size(); ++i) acc += a.d[i] * b.d[i];
    return acc;
}

// Pairwise 2x2 solves (lbfgs.rs:136-150).
Mat solve_hessian_system(const Mat &h, const std::vector<double> &h_off,
                         const Mat &g) {
    int n = h.r;
    Mat out(n, n);
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) {
            double det = h.at(i, j) * h.at(j, i) - h_off[i] * h_off[j];
            if (std::fabs(det) > 1e-15)
                out.at(i, j) =
                    (h.at(j, i) * g.at(i, j) - h_off[i] * g.at(j, i)) / det;
        }
    return out;
}

// Eigenvalue-floor the off-diagonal 2x2 blocks (lbfgs.rs:155-171).
// Row-major in-place scan EXACTLY like the reference: a lower-triangle
// entry (p, q) reads the already-bumped upper partner h[q][p]; upper
// entries see only originals. (models/core.py vectorizes the same
// order as two phases.)
void regularize_hessian(Mat &h, const std::vector<double> &h_off,
                        double lambda_min) {
    int n = h.r;
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) {
            if (i == j) continue;
            double diff = h.at(i, j) - h.at(j, i);
            double discr = std::sqrt(diff * diff + 4.0 * h_off[i] * h_off[j]);
            double ev = 0.5 * (h.at(i, j) + h.at(j, i) - discr);
            if (ev < lambda_min) h.at(i, j) += lambda_min - ev;
        }
}

Mat compute_direction(const Mat &g, const Mat &h,
                      const std::vector<double> &h_off, const LbfgsMem &mem,
                      bool ortho) {
    int n = g.r;
    int count = static_cast<int>(mem.s.size());
    Mat q = g;
    std::vector<double> alphas(count, 0.0);
    for (int i = count - 1; i >= 0; --i) {
        double a = mem.r[i] * frob_dot(mem.s[i], q);
        alphas[i] = a;
        for (size_t k = 0; k < q.d.size(); ++k) q.d[k] -= a * mem.y[i].d[k];
    }
    Mat z(n, n);
    if (ortho) {
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j) z.at(i, j) = q.at(i, j) / h.at(i, j);
        Mat zs(n, n);
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j)
                zs.at(i, j) = 0.5 * (z.at(i, j) - z.at(j, i));
        z = zs;
    } else {
        z = solve_hessian_system(h, h_off, q);
    }
    for (int i = 0; i < count; ++i) {
        double beta = mem.r[i] * frob_dot(mem.y[i], z);
        for (size_t k = 0; k < z.d.size(); ++k)
            z.d[k] += (alphas[i] - beta) * mem.s[i].d[k];
    }
    for (double &x : z.d) x = -x;
    return z;
}

// ---------------------------------------------------------------------------
// Line search (core.rs:99-150). On success Y/W/loss are the accepted
// candidate and step = alpha * D; on failure they are the LAST TRIED
// candidate and step uses the once-more-halved alpha.
// ---------------------------------------------------------------------------

bool line_search(Mat &y, Mat &w, const Mat &dir,
                 const std::vector<double> &signs, const Density &den,
                 bool ortho, bool extended, int ls_tries, double *loss,
                 Mat *step) {
    int n = w.r;
    double alpha = 1.0;
    Mat y_try, w_try;
    double loss_try = 0.0;
    bool success = false;
    for (int it = 0; it < ls_tries; ++it) {
        Mat transform;
        if (ortho) {
            Mat scaled = dir;
            for (double &x : scaled.d) x *= alpha;
            transform = matrix_exp(scaled);
        } else {
            transform = eye(n);
            for (int i = 0; i < n; ++i)
                for (int j = 0; j < n; ++j)
                    transform.at(i, j) += alpha * dir.at(i, j);
        }
        y_try = matmul(transform, y);
        w_try = matmul(transform, w);
        loss_try = compute_loss(y_try, w_try, signs, den, ortho, extended);
        if (loss_try < *loss) {
            success = true;
            break;
        }
        alpha /= 2.0;
    }
    y = std::move(y_try);
    w = std::move(w_try);
    *loss = loss_try;
    *step = dir;
    for (double &x : step->d) x *= alpha;
    return success;
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Core optimizer loop on pre-whitened, pre-rotated data
// (core.rs:162-401). `x` is (n, t) row-major; the caller has already
// applied W_init. `covariance` is (n, n) or null. Outputs: w (n, n),
// y (n, t), signs (n). Returns 0 on success.
int picard_oracle_core(const double *x, int n, int t, const double *covariance,
                       int density_type, double alpha, int ortho, int extended,
                       int max_iter, double tol, int m, int ls_tries,
                       double lambda_min, double *out_w, double *out_y,
                       double *out_signs, int *out_n_iter, int *out_converged,
                       double *out_gradient_norm) {
    Density den{density_type, alpha};
    Mat xm(n, t);
    std::memcpy(xm.d.data(), x, sizeof(double) * xm.d.size());

    Mat w = eye(n);
    Mat y = xm;
    std::vector<double> signs(n, 1.0), old_signs(n, 1.0);

    double loss = compute_loss(y, w, signs, den, ortho, extended);

    Mat c(n, n);
    bool has_cov = covariance != nullptr;
    if (extended) {
        if (has_cov) {
            std::memcpy(c.d.data(), covariance, sizeof(double) * c.d.size());
        } else {
            c = matmul_bt_scaled(xm, xm, 1.0 / t);
        }
    }

    LbfgsMem mem;
    Mat g_old(n, n), prev_step(n, n);
    double gradient_norm = 1.0;
    int n_iter = 0;
    bool converged = false;
    double inv_t = 1.0 / t;

    for (int it = 0; it < max_iter; ++it) {
        n_iter = it + 1;
        // Score pass + moments (core.rs:215-276).
        Mat psi(n, t), psi_d(n, t);
#pragma omp parallel for
        for (int i = 0; i < n; ++i) {
            den.score_row(&y.d[static_cast<size_t>(i) * t],
                          &psi.d[static_cast<size_t>(i) * t],
                          &psi_d.d[static_cast<size_t>(i) * t], t);
        }
        Mat g = matmul_bt_scaled(psi, y, inv_t);

        bool sign_change = false;
        if (extended) {
            std::vector<double> pm(n, 0.0);
            for (int i = 0; i < n; ++i) {
                const double *dr = &psi_d.d[static_cast<size_t>(i) * t];
                double acc = 0.0;
                for (int s = 0; s < t; ++s) acc += dr[s];
                pm[i] = acc * inv_t;
            }
            for (int i = 0; i < n; ++i) {
                double k = pm[i] * c.at(i, i) - g.at(i, i);
                signs[i] = (k >= 0.0) ? 1.0 : -1.0;  // f64::signum(+0) == 1
            }
            if (it > 0) {
                for (int i = 0; i < n; ++i)
                    if (signs[i] != old_signs[i]) sign_change = true;
            }
            old_signs = signs;
            for (int i = 0; i < n; ++i) {
                if (signs[i] < 0.0) {
                    for (int j = 0; j < n; ++j) g.at(i, j) = -g.at(i, j);
                    double *dr = &psi_d.d[static_cast<size_t>(i) * t];
                    for (int s = 0; s < t; ++s) dr[s] = -dr[s];
                }
            }
            if (!ortho) {
                for (int i = 0; i < n; ++i)
                    for (int j = 0; j < n; ++j) g.at(i, j) += c.at(i, j);
                for (double &v : psi_d.d) v += 1.0;
            }
        }

        // Hessian pieces (core.rs:256-276).
        std::vector<double> h_off(n, 1.0);
        Mat h(n, n);
        if (ortho) {
            for (int i = 0; i < n; ++i) h_off[i] = g.at(i, i);
            std::vector<double> pm_f(n, 0.0);
            for (int i = 0; i < n; ++i) {
                const double *dr = &psi_d.d[static_cast<size_t>(i) * t];
                double acc = 0.0;
                for (int s = 0; s < t; ++s) acc += dr[s];
                pm_f[i] = acc * inv_t;  // signs already folded into psi_d
            }
            for (int i = 0; i < n; ++i)
                for (int j = 0; j < n; ++j) {
                    double v = 0.5 * (pm_f[i] + pm_f[j] - h_off[i] - h_off[j]);
                    h.at(i, j) = std::max(v, lambda_min);
                }
        } else {
            Mat ysq(n, t);
            for (size_t k = 0; k < ysq.d.size(); ++k)
                ysq.d[k] = y.d[k] * y.d[k];
            h = matmul_bt_scaled(psi_d, ysq, inv_t);
            regularize_hessian(h, h_off, lambda_min);
        }

        // Project the gradient (core.rs:280-286).
        if (ortho) {
            Mat gs(n, n);
            for (int i = 0; i < n; ++i)
                for (int j = 0; j < n; ++j)
                    gs.at(i, j) = 0.5 * (g.at(i, j) - g.at(j, i));
            g = gs;
        } else {
            for (int i = 0; i < n; ++i) g.at(i, i) -= 1.0;
        }

        gradient_norm = max_abs(g);
        if (std::getenv("PICARD_ORACLE_VERBOSE")) {
            std::fprintf(stderr, "oracle iter %d gnorm %.17e loss %.17e\n",
                         it + 1, gradient_norm, loss);
        }
        if (gradient_norm < tol) {
            converged = true;
            break;
        }

        // L-BFGS memory push (core.rs:296-313).
        if (it > 0) {
            Mat y_diff(n, n);
            for (size_t k = 0; k < y_diff.d.size(); ++k)
                y_diff.d[k] = g.d[k] - g_old.d[k];
            double denom = frob_dot(prev_step, y_diff);
            double r = 1.0 / denom;
            if (std::isfinite(r)) {
                mem.s.push_back(prev_step);
                mem.y.push_back(y_diff);
                mem.r.push_back(r);
                if (static_cast<int>(mem.s.size()) > m) {
                    mem.s.erase(mem.s.begin());
                    mem.y.erase(mem.y.begin());
                    mem.r.erase(mem.r.begin());
                }
            }
        }

        // Sign change: re-baseline the loss, flush memory (core.rs:317-331).
        if (extended && sign_change) {
            loss = compute_loss(y, w, signs, den, ortho, extended);
            mem.clear();
        }

        Mat direction = compute_direction(g, h, h_off, mem, ortho);

        Mat step(n, n);
        Mat y_saved = y, w_saved = w;
        double loss_saved = loss;
        bool success = line_search(y, w, direction, signs, den, ortho,
                                   extended, ls_tries, &loss, &step);
        if (!success) {
            // Gradient-descent fallback (core.rs:349-364), restarted
            // from the pre-line-search state.
            mem.clear();
            y = std::move(y_saved);
            w = std::move(w_saved);
            loss = loss_saved;
            Mat neg_g = g;
            for (double &v : neg_g.d) v = -v;
            line_search(y, w, neg_g, signs, den, ortho, extended,
                        kFallbackLsTries, &loss, &step);
        }
        if (std::getenv("PICARD_ORACLE_VERBOSE")) {
            std::fprintf(stderr,
                         "  ls: success=%d dirnorm=%.10e newloss=%.17e\n",
                         success ? 1 : 0, max_abs(direction), loss);
        }
        prev_step = step;
        g_old = g;

        // Extended covariance proxy C = W cov W^T (core.rs:375-379).
        if (extended && has_cov) {
            Mat cov(n, n);
            std::memcpy(cov.d.data(), covariance, sizeof(double) * cov.d.size());
            Mat wc = matmul(w, cov);
            c = matmul_bt_scaled(wc, w, 1.0);  // (W cov) W^T
        }
    }

    std::memcpy(out_w, w.d.data(), sizeof(double) * w.d.size());
    std::memcpy(out_y, y.d.data(), sizeof(double) * y.d.size());
    for (int i = 0; i < n; ++i) out_signs[i] = signs[i];
    *out_n_iter = n_iter;
    *out_converged = converged ? 1 : 0;
    *out_gradient_norm = gradient_norm;
    return 0;
}

// Center rows in place: x is (n, t) row-major; out_mean gets the row
// means (whitening.rs:24-35).
void picard_oracle_center(double *x, int n, int t, double *out_mean) {
    for (int i = 0; i < n; ++i) {
        double *row = x + static_cast<size_t>(i) * t;
        double acc = 0.0;
        for (int s = 0; s < t; ++s) acc += row[s];
        double mean = acc / t;
        out_mean[i] = mean;
        for (int s = 0; s < t; ++s) row[s] -= mean;
    }
}

// PCA whitening of centered data via eigh of X X^T (equivalent to the
// reference's thin SVD, whitening.rs:48-110), including the
// deterministic "largest-|entry| positive" row-sign convention.
// out_k is (k, n); out_data is (k, t). Returns 0, or 1 on singular data.
int picard_oracle_whiten(const double *x, int n, int t, int n_components,
                         double *out_k, double *out_data) {
    Mat xm(n, t);
    std::memcpy(xm.d.data(), x, sizeof(double) * xm.d.size());
    Mat cov = matmul_bt_scaled(xm, xm, 1.0);
    std::vector<double> evals;
    Mat u;
    jacobi_eigh(cov, evals, u);  // ascending
    int k = n_components;
    Mat kmat(k, n);
    for (int j = 0; j < k; ++j) {
        int src = n - 1 - j;  // descending order
        double ev = std::max(evals[src], 0.0);
        double s = std::sqrt(ev);
        if (s < kMinEig) return 1;
        double scale = std::sqrt(static_cast<double>(t)) / s;
        for (int i = 0; i < n; ++i) kmat.at(j, i) = u.at(i, src) * scale;
    }
    // Sign convention (whitening.rs:92-107).
    for (int j = 0; j < k; ++j) {
        int arg = 0;
        for (int i = 1; i < n; ++i)
            if (std::fabs(kmat.at(j, i)) > std::fabs(kmat.at(j, arg))) arg = i;
        if (kmat.at(j, arg) < 0.0)
            for (int i = 0; i < n; ++i) kmat.at(j, i) = -kmat.at(j, i);
    }
    Mat data = matmul(kmat, xm);
    std::memcpy(out_k, kmat.d.data(), sizeof(double) * kmat.d.size());
    std::memcpy(out_data, data.d.data(), sizeof(double) * data.d.size());
    return 0;
}

// Symmetric FastICA warm start (solver.rs:218-249): fixed number of
// iterations of C = E[psi(WX) X^T] - diag(E[psi'(WX)]) W followed by
// symmetric decorrelation. w is (n, n) in/out. Returns 1 on singular.
int picard_oracle_ica_par(const double *x, int n, int t, int density_type,
                          double alpha, int n_iter, double *w_io) {
    Density den{density_type, alpha};
    Mat xm(n, t);
    std::memcpy(xm.d.data(), x, sizeof(double) * xm.d.size());
    Mat w(n, n);
    std::memcpy(w.d.data(), w_io, sizeof(double) * w.d.size());
    // The reference decorrelates the INITIAL W before the loop
    // (solver.rs:224 `let mut w = sym_decorrelation(w_init)?`), so a
    // non-orthogonal w_init must be projected here too — without this
    // the oracle runs a different algorithm for non-orthogonal inits
    // (models/fastica.py:32 matches the reference).
    if (sym_decorrelation(w) < kMinEig) return 1;
    double inv_t = 1.0 / t;
    std::vector<double> psid_row(t);
    for (int it = 0; it < n_iter; ++it) {
        Mat y = matmul(w, xm);
        Mat psi(n, t);
        std::vector<double> pm(n, 0.0);
        for (int i = 0; i < n; ++i) {
            den.score_row(&y.d[static_cast<size_t>(i) * t],
                          &psi.d[static_cast<size_t>(i) * t], psid_row.data(), t);
            double acc = 0.0;
            for (int s = 0; s < t; ++s) acc += psid_row[s];
            pm[i] = acc * inv_t;
        }
        Mat cmat = matmul_bt_scaled(psi, xm, inv_t);
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j) cmat.at(i, j) -= pm[i] * w.at(i, j);
        w = cmat;
        if (sym_decorrelation(w) < kMinEig) return 1;
    }
    std::memcpy(w_io, w.d.data(), sizeof(double) * w.d.size());
    return 0;
}

}  // extern "C"
