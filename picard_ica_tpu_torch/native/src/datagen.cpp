// Native benchmark-data generator.
//
// Reproduces the reference benchmark harness's data stream
// (reference: benches/benchmarks.rs:8-35) bit-for-bit in the integer
// domain: a wrapping-u64 LCG (state * 6364136223846793005 + 1), 31
// retained bits mapped to [0, 1), Laplace sources via inverse CDF and
// a uniform(-0.5, 0.5) mixing matrix drawn from the same stream.
//
// The plain version (utils/datagen.py's ``_lcg_stream``) computes the
// same stream with a vectorized NumPy closed form, one core and several
// (n, t) temporaries; this OpenMP version jumps each thread to its
// stream offset in O(log k) (LCG jump via modular exponentiation of the
// affine map) and fills in parallel. The states are the plain version's
// bit for bit; the values may differ from NumPy's log by 1 ulp.

#include <cstdint>
#include <cstddef>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint64_t kMul = 6364136223846793005ULL;
constexpr uint64_t kInc = 1ULL;

// Advance an LCG state by `steps` in O(log steps):
// s_k = A^k s_0 + (A^{k-1} + ... + 1) c, computed with the standard
// affine-map exponentiation (cur_mul/cur_add squared each bit).
uint64_t lcg_jump(uint64_t state, uint64_t steps) {
    uint64_t acc_mul = 1, acc_add = 0;
    uint64_t cur_mul = kMul, cur_add = kInc;
    while (steps > 0) {
        if (steps & 1) {
            acc_mul *= cur_mul;
            acc_add = acc_add * cur_mul + cur_add;
        }
        cur_add = (cur_mul + 1) * cur_add;
        cur_mul *= cur_mul;
        steps >>= 1;
    }
    return state * acc_mul + acc_add;
}

inline uint64_t lcg_next(uint64_t &state) {
    state = state * kMul + kInc;
    return state;
}

// benchmarks.rs:16 semantics: top 31 bits of the *new* state over 2^31.
inline double lcg_uniform(uint64_t &state) {
    return static_cast<double>(lcg_next(state) >> 33) /
           static_cast<double>(1ULL << 31);
}

inline double laplace_inv_cdf(double u) {
    // Inverse CDF of the unit Laplace distribution; clamps guard
    // log(0) exactly like the NumPy plain version.
    if (u < 0.5) {
        double v = 2.0 * u;
        return std::log(v > 1e-300 ? v : 1e-300);
    }
    double v = 2.0 * (1.0 - u);
    return -std::log(v > 1e-300 ? v : 1e-300);
}

}  // namespace

extern "C" {

// Fill `out[0..count)` with unit-Laplace samples from the LCG stream
// seeded at `seed`; returns the stream state after `count` draws.
uint64_t picard_lcg_laplace_fill(uint64_t seed, double *out, size_t count) {
#ifdef _OPENMP
#pragma omp parallel
    {
        int nthreads = omp_get_num_threads();
        int tid = omp_get_thread_num();
        size_t chunk = (count + nthreads - 1) / nthreads;
        size_t begin = static_cast<size_t>(tid) * chunk;
        size_t end = begin + chunk < count ? begin + chunk : count;
        if (begin < end) {
            uint64_t state = lcg_jump(seed, begin);
            for (size_t i = begin; i < end; ++i) {
                out[i] = laplace_inv_cdf(lcg_uniform(state));
            }
        }
    }
#else
    uint64_t state = seed;
    for (size_t i = 0; i < count; ++i) {
        out[i] = laplace_inv_cdf(lcg_uniform(state));
    }
#endif
    return lcg_jump(seed, count);
}

// Fill `out[0..count)` with uniform(-0.5, 0.5) draws (the mixing
// matrix stream, benchmarks.rs:30-33); returns the advanced state.
uint64_t picard_lcg_uniform_centered_fill(uint64_t seed, double *out,
                                          size_t count) {
    uint64_t state = seed;
    for (size_t i = 0; i < count; ++i) {
        out[i] = lcg_uniform(state) - 0.5;
    }
    return state;
}

}  // extern "C"
