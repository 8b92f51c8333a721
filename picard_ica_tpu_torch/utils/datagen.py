"""Seeded synthetic ICA data (on the host, and torch on a device).

The host generators match those of ``picard_ica_tpu/utils/datagen.py``
(importing that module would pull in ``jax``):

  * ``generate_bench_data`` reproduces the reference benchmark generator
    in the integer domain (benches/benchmarks.rs:8-35): an LCG
    (``state * 6364136223846793005 + 1`` on wrapping u64), Laplace
    sources by inverse CDF, uniform(-0.5, 0.5) mixing. The stream is
    filled by the native library (``native.lcg_laplace``,
    ``native.lcg_uniform_centered``: OpenMP, each thread jumped to its
    offset); its plain version is the vectorized NumPy closed form
    (``_lcg_stream``, ``_lcg_uniform``, ``_lcg_jump``, ``_lcg_laplace``,
    :func:`generate_bench_data_plain`), whose states it matches bit for
    bit and whose values within 1 ulp (the two logs);
  * ``reference_mixing_matrix`` is that mixing block alone, reached by
    jumping the LCG past the n*t source draws, bit for bit the NumPy
    form;
  * ``generate_test_data`` / ``generate_mixed_kurtosis_data`` are the
    seeded test fixtures (NumPy).

``generate_bench_data_device`` makes the bench mixture on a torch
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_LCG_MUL = np.uint64(6364136223846793005)
_LCG_INC = np.uint64(1)


def _lcg_stream(state: int, count: int) -> Tuple[np.ndarray, int]:
    """Generate ``count`` u64 LCG states starting after ``state``.

    Vectorized closed form: s_k = A^k s_0 + (1 + A + ... + A^{k-1})
    mod 2^64, using numpy's wrapping uint64 arithmetic — bit-identical
    to the scalar recurrence but O(count) vector work.
    """
    s0 = np.uint64(state)
    with np.errstate(over="ignore"):
        pows = np.multiply.accumulate(np.full(count, _LCG_MUL, dtype=np.uint64))
        geo = np.cumsum(
            np.concatenate([np.ones(1, np.uint64), pows[:-1]]), dtype=np.uint64
        )
        states = pows * s0 + geo
    return states, int(states[-1])


def _lcg_uniform(states: np.ndarray) -> np.ndarray:
    """Map LCG states to [0, 1) doubles exactly as benchmarks.rs:16
    (31 retained bits over 2^31)."""
    return (states >> np.uint64(33)).astype(np.float64) / float(1 << 31)


def _lcg_laplace(state: int, count: int) -> Tuple[np.ndarray, int]:
    """``native.lcg_laplace`` in NumPy: ``count`` unit-Laplace samples by
    inverse CDF and the state after them."""
    states, state = _lcg_stream(state, count)
    u = _lcg_uniform(states)
    data = np.where(u < 0.5, np.log(np.maximum(2.0 * u, 1e-300)), -np.log(np.maximum(2.0 * (1.0 - u), 1e-300)))
    return data, state


def generate_bench_data(n_features: int, n_samples: int, seed: int = 42) -> np.ndarray:
    """Mixed Laplace data identical to the reference benchmark harness
    (f64), filled by the native LCG stream."""
    from .. import native

    data, state = native.lcg_laplace(seed, n_features * n_samples)
    mixing, _ = native.lcg_uniform_centered(state, n_features * n_features)
    return mixing.reshape(n_features, n_features) @ data.reshape(n_features, n_samples)


def generate_bench_data_plain(n_features: int, n_samples: int, seed: int = 42) -> np.ndarray:
    """:func:`generate_bench_data` by the vectorized NumPy closed form:
    the plain version the native stream is held against."""
    data, state = _lcg_laplace(seed, n_features * n_samples)
    states, _ = _lcg_stream(state, n_features * n_features)
    mixing = _lcg_uniform(states).reshape(n_features, n_features) - 0.5
    return mixing @ data.reshape(n_features, n_samples)


def _lcg_jump(state: int, count: int) -> int:
    """LCG state after ``count`` steps, in O(log count) host work: binary
    composition of the affine map f(s) = A*s + 1 mod 2^64, bit-identical
    to ``_lcg_stream(state, count)[1]`` without materializing the
    stream."""
    m = 1 << 64
    a, c = int(_LCG_MUL), int(_LCG_INC)
    acc_a, acc_c = 1, 0
    k = count
    while k:
        if k & 1:
            acc_a, acc_c = (acc_a * a) % m, (acc_c * a + c) % m
        a, c = (a * a) % m, (a * c + c) % m
        k >>= 1
    return (acc_a * state + acc_c) % m


def reference_mixing_matrix(n_features: int, n_samples: int, seed: int = 42) -> np.ndarray:
    """The reference harness's uniform(-0.5, 0.5) mixing matrix,
    bit-exact: the LCG is jumped past the n*t source draws in closed
    form, then the n*n mixing block is drawn from the exact stream
    position the Rust harness uses (benches/benchmarks.rs:27-31), by the
    native stream."""
    from .. import native

    mixing, _ = native.lcg_uniform_centered(_lcg_jump(seed, n_features * n_samples),
                                            n_features * n_features)
    return mixing.reshape(n_features, n_features)


# Column block of the in-place Laplace transform (a few block-sized
# temporaries beside the one data buffer).
_GEN_BLOCK_T = 1 << 20


def laplace_sources_device(n: int, t: int, seed: int, device) -> torch.Tensor:
    """(n, t) f32 standard Laplace sources made on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.

    ``u ~ U(-1 + epsneg, 1)`` then ``sign(u) * log1p(-|u|)``, the form
    of ``jax.random.laplace``, written over the one data buffer a column
    block at a time. The values are not the JAX package's (its device
    generator draws from the ``rbg`` stream); the law is the same.
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.empty((n, t), dtype=torch.float32, device=device)
    x.uniform_(-1.0 + float(np.finfo(np.float32).epsneg), 1.0, generator=gen)
    below_one = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    for start in range(0, t, _GEN_BLOCK_T):
        u = x[:, start: start + _GEN_BLOCK_T]
        u.copy_(torch.sign(u) * torch.log1p(-u.abs().clamp_(max=below_one)))
    return x


def generate_bench_data_device(n_features: int, n_samples: int, seed: int = 42,
                               device="cuda") -> torch.Tensor:
    """The bench mixture made on ``device``, f32 (n_features, n_samples).

    Standard Laplace sources (:func:`laplace_sources_device`, the law of
    the reference's inverse-CDF construction, benchmarks.rs:18-24) mixed
    by the bit-exact reference mixing matrix
    (:func:`reference_mixing_matrix`) through the in-place blockwise
    rotation, so generation peaks at one data buffer. The sources come
    from a ``torch.Generator``, not from the JAX package's ``rbg``
    stream, so the values differ from its ``generate_bench_data_device``
    while the mixing matrix is the same.
    """
    from ..ops.linalg import rotate_rows_inplace

    x = laplace_sources_device(n_features, n_samples, seed, device)
    mixing = torch.as_tensor(reference_mixing_matrix(n_features, n_samples, seed),
                             dtype=torch.float32, device=device)
    return rotate_rows_inplace(mixing, x)


def generate_test_data(n: int, t: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded (sources, mixing, mixed) fixture (solver.rs:257-286)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-12, 1.0, size=(n, t))
    sign = np.where(rng.random((n, t)) < 0.5, 1.0, -1.0)
    sources = sign * (-np.log(u))
    mixing = rng.standard_normal((n, n))
    return sources, mixing, mixing @ sources


def generate_mixed_kurtosis_data(n: int, t: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mixed sub/super-Gaussian fixture for extended-mode tests
    (modeled on jade.rs:209-243): alternating Laplace (super) and
    uniform (sub) sources."""
    rng = np.random.default_rng(seed)
    sources = np.empty((n, t))
    for i in range(n):
        if i % 2 == 0:
            u = rng.uniform(1e-12, 1.0, size=t)
            sign = np.where(rng.random(t) < 0.5, 1.0, -1.0)
            sources[i] = sign * (-np.log(u))
        else:
            sources[i] = rng.uniform(-np.sqrt(3.0), np.sqrt(3.0), size=t)
    mixing = rng.standard_normal((n, n))
    return sources, mixing, mixing @ sources
