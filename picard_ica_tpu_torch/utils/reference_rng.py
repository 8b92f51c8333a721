"""Reference-matched random streams for the random ``w_init`` path.

The reference initializes W (when ``w_init=None``) by filling an
N x N matrix row-major with standard-normal samples from
``StdRng::seed_from_u64(random_state)`` (solver.rs:57-60, 112-120).
This module reproduces that stream *by construction* from the public
specifications of the three layers rand 0.9 composes:

1. ``SeedableRng::seed_from_u64`` — expands the u64 into a 32-byte
   seed with a PCG32 step per 4 bytes (rand_core's documented, .
   stability-guaranteed algorithm; multiplier 6364136223846793005,
   increment 11634580027462260723, XSH-RR output).
2. ``StdRng`` = ChaCha12: the djb ChaCha stream cipher (64-bit block
   counter in words 12-13, 64-bit nonce = 0 in words 14-15) with 12
   double-rounds halved to 12 rounds total; ``next_u64`` consumes two
   consecutive little-endian u32 output words (low word first).
3. ``rand_distr::StandardNormal`` — the 256-strip symmetric ziggurat
   (Marsaglia-Tsang as shipped in rand_distr 0.5): strip index from
   the low 8 bits, the uniform in [-1, 1) from the high 52 bits via
   exponent splicing, Open01 + log tail fallback for strip 0, and a
   53-bit multiply-uniform for the wedge rejection test.

Verification strategy (no Rust toolchain exists in this environment,
so the crate itself cannot be executed):

* the ChaCha core is parametric in rounds and state layout and is
  tested against the RFC 8439 ChaCha20 keystream vector — the quarter
  round, word order and serialization are shared with ChaCha12;
* the ziggurat tables are regenerated here from the standard
  construction (R = 3.654152885361008796, V = 0.00492867323399 — the
  constants rand_distr's tables were generated from) rather than
  copied;
* an independent C++ implementation (native/src/rng.cpp) is written
  from the same specifications and the two must agree bit-for-bit
  (tests/test_torch_native.py) — two independent derivations of the
  spec guarding each other. The fit draws through the C++ one
  (:func:`normal_matrix`); the pure-Python sampler here is its plain
  version (:func:`normal_matrix_plain`).

docs/PARITY.md row 1e records the remaining caveat: last-ULP table
agreement with the crate's checked-in constants is unverifiable here.
"""

from __future__ import annotations

import math

import numpy as np

_MASK64 = (1 << 64) - 1

# -- seed_from_u64: PCG32 (XSH-RR) expansion ----------------------------

_PCG_MUL = 6364136223846793005
_PCG_INC = 11634580027462260723


def seed_from_u64(state: int) -> bytes:
    """Expand a u64 into a 32-byte ChaCha seed exactly as rand_core's
    ``SeedableRng::seed_from_u64`` default implementation does."""
    state &= _MASK64
    out = bytearray()
    for _ in range(8):  # 32 bytes / 4 per PCG32 output
        state = (state * _PCG_MUL + _PCG_INC) & _MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & 0xFFFFFFFF
        out += x.to_bytes(4, "little")
    return bytes(out)


# -- ChaCha block function (djb layout, parametric rounds) --------------

_CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _chacha_blocks(key_words: np.ndarray, counter0: int, n_blocks: int,
                   rounds: int = 12, ietf_words: tuple = ()) -> np.ndarray:
    """``n_blocks`` consecutive ChaCha output blocks as a
    (n_blocks, 16) uint32 array, vectorized over the block axis.

    djb variant: 64-bit counter in words 12-13, 64-bit nonce (always 0
    for ``StdRng``) in words 14-15. ``ietf_words`` optionally overrides
    words 13-15 (32-bit counter + 96-bit nonce) for the RFC 8439
    conformance test.
    """
    n = int(n_blocks)
    state = np.zeros((16, n), dtype=np.uint32)
    for i, c in enumerate(_CHACHA_CONSTANTS):
        state[i] = c
    for i in range(8):
        state[4 + i] = key_words[i]
    ctr = (np.arange(n, dtype=np.uint64) + np.uint64(counter0 & _MASK64))
    state[12] = (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if ietf_words:
        for i, w in enumerate(ietf_words):
            state[13 + i] = w
    else:
        state[13] = (ctr >> np.uint64(32)).astype(np.uint32)
        # words 14-15 stay 0 (StdRng stream id)

    x = state.copy()

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] = np.bitwise_or(
            np.left_shift(x[d] ^ x[a], 16), np.right_shift(x[d] ^ x[a], 16)
        )
        x[c] += x[d]
        x[b] = np.bitwise_or(
            np.left_shift(x[b] ^ x[c], 12), np.right_shift(x[b] ^ x[c], 20)
        )
        x[a] += x[b]
        x[d] = np.bitwise_or(
            np.left_shift(x[d] ^ x[a], 8), np.right_shift(x[d] ^ x[a], 24)
        )
        x[c] += x[d]
        x[b] = np.bitwise_or(
            np.left_shift(x[b] ^ x[c], 7), np.right_shift(x[b] ^ x[c], 25)
        )

    with np.errstate(over="ignore"):
        for _ in range(rounds // 2):
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        x += state
    return x.T.copy()  # (n_blocks, 16), word-major little-endian stream


class StdRng:
    """rand 0.9 ``StdRng`` (ChaCha12, nonce 0) — ``next_u64`` only.

    The buffer refill batches blocks for NumPy efficiency; the output
    word sequence is the standard sequential ChaCha stream, identical
    to rand_chacha's 4-block ``BlockRng`` buffer. All consumers here
    draw u64s (two u32 words, low first) so the refill boundary never
    splits a u64 (the real ``BlockRng`` handles that case; with 16-word
    blocks and u64-only consumption it is unreachable).
    """

    _BATCH_BLOCKS = 64  # 1024 u32 words per refill

    def __init__(self, seed_u64: int):
        seed = seed_from_u64(seed_u64)
        self._key = np.frombuffer(seed, dtype="<u4").copy()
        self._counter = 0
        self._buf = np.empty(0, dtype=np.uint64)
        self._pos = 0

    def _refill(self) -> None:
        words = _chacha_blocks(
            self._key, self._counter, self._BATCH_BLOCKS, rounds=12
        ).reshape(-1)
        self._counter += self._BATCH_BLOCKS
        le = words.astype("<u4").view("<u8")  # low word first == LE pairs
        self._buf = le.astype(np.uint64)
        self._pos = 0

    def next_u64(self) -> int:
        if self._pos >= self._buf.shape[0]:
            self._refill()
        v = int(self._buf[self._pos])
        self._pos += 1
        return v


# -- rand_distr StandardNormal: 256-strip symmetric ziggurat ------------

_ZIG_R = 3.654152885361008796
_ZIG_V = 0.00492867323399


def _make_tables():
    f = lambda x: math.exp(-0.5 * x * x)  # noqa: E731
    f_inv = lambda y: math.sqrt(-2.0 * math.log(y))  # noqa: E731
    xs = [0.0] * 257
    xs[0] = _ZIG_V / f(_ZIG_R)
    xs[1] = _ZIG_R
    for i in range(1, 255):
        xs[i + 1] = f_inv(_ZIG_V / xs[i] + f(xs[i]))
    xs[256] = 0.0
    fs = [f(x) for x in xs]
    return xs, fs


ZIG_NORM_X, ZIG_NORM_F = _make_tables()

_F64_ONE_BITS = 0x3FF0000000000000
_U53_SCALE = 1.0 / (1 << 53)
_OPEN01_SUB = 1.0 - 2.0 ** -53


def _bits_to_unit_sym(bits: int) -> float:
    """High 52 bits -> [2, 4) by exponent splice, minus 3 -> [-1, 1)."""
    u = (bits >> 12) | 0x4000000000000000
    return np.uint64(u).view(np.float64).item() - 3.0


def _open01(rng: StdRng) -> float:
    frac = rng.next_u64() >> 12
    return np.uint64(frac | _F64_ONE_BITS).view(np.float64).item() - _OPEN01_SUB


def _standard_uniform(rng: StdRng) -> float:
    return (rng.next_u64() >> 11) * _U53_SCALE


def standard_normal(rng: StdRng) -> float:
    """One ``rand_distr::StandardNormal`` f64 sample."""
    while True:
        bits = rng.next_u64()
        i = bits & 0xFF
        u = _bits_to_unit_sym(bits)
        x = u * ZIG_NORM_X[i]
        if abs(x) < ZIG_NORM_X[i + 1]:
            return x
        if i == 0:
            # Tail: Marsaglia's exponential-rejection beyond R.
            xt, yt = 1.0, 0.0
            while -2.0 * yt < xt * xt:
                xt = math.log(_open01(rng)) / _ZIG_R
                yt = math.log(_open01(rng))
            return xt - _ZIG_R if u < 0.0 else _ZIG_R - xt
        if (ZIG_NORM_F[i + 1]
                + (ZIG_NORM_F[i] - ZIG_NORM_F[i + 1]) * _standard_uniform(rng)
                < math.exp(-0.5 * x * x)):
            return x


def normal_matrix(seed_u64: int, n_rows: int, n_cols: int) -> np.ndarray:
    """Row-major (n_rows, n_cols) f64 standard-normal fill from
    ``StdRng::seed_from_u64(seed)`` — the reference's random W init
    stream (solver.rs:112-120).

    Drawn by the native C++ twin (``native/src/rng.cpp``), bit for bit
    :func:`normal_matrix_plain`; a failed build of the native library
    raises.
    """
    from .. import native

    return native.reference_normal_matrix(seed_u64, n_rows, n_cols)


def normal_matrix_plain(seed_u64: int, n_rows: int, n_cols: int) -> np.ndarray:
    """:func:`normal_matrix` by the pure-Python sampler, one
    :func:`standard_normal` call a sample: the plain version the native
    draw is held against."""
    rng = StdRng(seed_u64)
    flat = np.array(
        [standard_normal(rng) for _ in range(n_rows * n_cols)], dtype=np.float64
    )
    return flat.reshape(n_rows, n_cols)
