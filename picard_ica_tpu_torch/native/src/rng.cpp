// Reference-matched random stream: StdRng(=ChaCha12) + ziggurat
// StandardNormal, the reference's random W-init source
// (solver.rs:57-60, 112-120).
//
// This is the independent C++ twin of utils/reference_rng.py — both
// are written from the public specs (rand_core's seed_from_u64 PCG32
// expansion, the djb ChaCha layout with 12 rounds, rand_distr 0.5's
// 256-strip symmetric ziggurat) and tests/test_torch_native.py
// asserts they agree BIT-FOR-BIT; see the Python module's docstring
// for the full provenance / verification story.
//
// Compiled with -ffp-contract=off (see native/__init__.py): FMA
// contraction of e.g. f[i+1] + (f[i]-f[i+1])*w would fork the
// rejection decisions from the Python twin's un-fused arithmetic.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline uint32_t rotl32(uint32_t v, int c) {
    return (v << c) | (v >> (32 - c));
}

constexpr double ZIG_R = 3.654152885361008796;
constexpr double ZIG_V = 0.00492867323399;

double zig_x[257];
double zig_f[257];
bool tables_ready = false;

void init_tables() {
    zig_x[0] = ZIG_V / std::exp(-0.5 * ZIG_R * ZIG_R);
    zig_x[1] = ZIG_R;
    for (int i = 1; i < 255; ++i) {
        double y = ZIG_V / zig_x[i] + std::exp(-0.5 * zig_x[i] * zig_x[i]);
        zig_x[i + 1] = std::sqrt(-2.0 * std::log(y));
    }
    zig_x[256] = 0.0;
    for (int i = 0; i < 257; ++i) {
        zig_f[i] = std::exp(-0.5 * zig_x[i] * zig_x[i]);
    }
    tables_ready = true;
}

struct StdRng {
    uint32_t key[8];
    uint64_t counter;
    uint32_t buf[16];
    int pos;

    explicit StdRng(uint64_t seed) : counter(0), pos(16) {
        // rand_core SeedableRng::seed_from_u64: one PCG32 (XSH-RR)
        // step per 4 seed bytes, little-endian.
        uint64_t s = seed;
        for (int k = 0; k < 8; ++k) {
            s = s * 6364136223846793005ULL + 11634580027462260723ULL;
            uint32_t xs = (uint32_t)(((s >> 18) ^ s) >> 27);
            uint32_t rot = (uint32_t)(s >> 59);
            key[k] = (xs >> rot) | (xs << ((32 - rot) & 31));
    }
    }

    void refill() {
        // One djb-layout ChaCha12 block: constants | key | 64-bit
        // counter (words 12-13) | 64-bit nonce = 0 (words 14-15).
        const uint32_t st[16] = {
            0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
            key[0], key[1], key[2], key[3],
            key[4], key[5], key[6], key[7],
            (uint32_t)counter, (uint32_t)(counter >> 32), 0u, 0u,
        };
        uint32_t x[16];
        std::memcpy(x, st, sizeof(st));
#define PICARD_QR(a, b, c, d)                                          \
    x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 16);                      \
    x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 12);                      \
    x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 8);                       \
    x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 7);
        for (int r = 0; r < 6; ++r) {  // 12 rounds = 6 double rounds
            PICARD_QR(0, 4, 8, 12) PICARD_QR(1, 5, 9, 13)
            PICARD_QR(2, 6, 10, 14) PICARD_QR(3, 7, 11, 15)
            PICARD_QR(0, 5, 10, 15) PICARD_QR(1, 6, 11, 12)
            PICARD_QR(2, 7, 8, 13) PICARD_QR(3, 4, 9, 14)
        }
#undef PICARD_QR
        for (int k = 0; k < 16; ++k) buf[k] = x[k] + st[k];
        ++counter;
        pos = 0;
    }

    // Two consecutive LE u32 output words, low word first. All
    // consumers draw whole u64s so a refill never splits one (the
    // crate's BlockRng handles that case; it is unreachable here).
    uint64_t next_u64() {
        if (pos >= 16) refill();
        uint64_t lo = buf[pos];
        uint64_t hi = buf[pos + 1];
        pos += 2;
        return lo | (hi << 32);
    }
};

inline double bits_to_f64(uint64_t b) {
    double d;
    std::memcpy(&d, &b, 8);
    return d;
}

// Open01: 52 high bits spliced under exponent 0 -> [1, 2), shifted
// into (0, 1).
inline double open01(StdRng& rng) {
    uint64_t frac = rng.next_u64() >> 12;
    return bits_to_f64(frac | 0x3ff0000000000000ULL) - (1.0 - 0x1p-53);
}

double std_normal(StdRng& rng) {
    for (;;) {
        uint64_t bits = rng.next_u64();
        int i = (int)(bits & 0xff);
        // High 52 bits -> [2, 4) by exponent splice, minus 3 -> [-1, 1).
        double u = bits_to_f64((bits >> 12) | 0x4000000000000000ULL) - 3.0;
        double x = u * zig_x[i];
        if (std::fabs(x) < zig_x[i + 1]) return x;
        if (i == 0) {
            // Tail beyond R: Marsaglia exponential rejection.
            double xt = 1.0, yt = 0.0;
            while (-2.0 * yt < xt * xt) {
                xt = std::log(open01(rng)) / ZIG_R;
                yt = std::log(open01(rng));
            }
            return u < 0.0 ? xt - ZIG_R : ZIG_R - xt;
        }
        double w = (double)(rng.next_u64() >> 11) * 0x1p-53;
        if (zig_f[i + 1] + (zig_f[i] - zig_f[i + 1]) * w
                < std::exp(-0.5 * x * x)) {
            return x;
        }
    }
}

}  // namespace

extern "C" {

// Fill `out[0..count)` with the StandardNormal stream of
// StdRng::seed_from_u64(seed) — row-major W fill order.
void picard_reference_normal_fill(uint64_t seed, double* out,
                                  size_t count) {
    if (!tables_ready) init_tables();
    StdRng rng(seed);
    for (size_t k = 0; k < count; ++k) out[k] = std_normal(rng);
}

// Raw u64 stream (diagnostics / cross-checking the Python twin's
// ChaCha layer in isolation).
void picard_reference_u64_fill(uint64_t seed, uint64_t* out,
                               size_t count) {
    StdRng rng(seed);
    for (size_t k = 0; k < count; ++k) out[k] = rng.next_u64();
}

}  // extern "C"
