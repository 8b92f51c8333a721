"""The fused pass's bf16 tiers and the packed partials, on the CPU.

``rotated_fused_sums`` runs its bf16 and bf16x3 tiers on the tensor
cores (csrc/rotated_fused_tc.cu) in 16-row tiles, 64-column sub-tiles
and 2,048-column partials. Here its plain version, which the CUDA kernel
is held against on the card (tests/test_torch_cuda.py, chip_smoke.py),
goes against the JAX package's Pallas kernel in interpret mode at the
edges of that tiling. Then the packed partial buffer the core wrappers
fold in one launch, and the per-tier launch counts.

Tolerances, as tests/test_torch_kernels.py: 2e-5 of each output's scale
for the bf16x3 tier on f32 X (f32 sums in another order); 2e-4 where a
bf16 tier rounds psi and Y, or X is bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picard_ica_tpu.ops import densities as jd
from picard_ica_tpu.ops import pallas_kernels as pk
from picard_ica_tpu_torch.ops import densities as td
from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.ops.moments import fold_pairwise

torch.set_num_threads(2)

TOL = {"bf16x3": 2e-5, "bf16": 2e-4}
# One column past the first 2,048-column partial.
T_EDGE = 2049


def _inputs(n, t, seed):
    rng = np.random.default_rng(seed)
    m_old = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    m_new = m_old + 0.05 * rng.standard_normal((n, n))
    x = rng.laplace(size=(n, t)) / np.sqrt(2.0)
    return m_new.astype(np.float32), m_old.astype(np.float32), x.astype(np.float32)


def _check(j_out, t_out, tol):
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        assert b.dtype == torch.float32
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        scale = max(np.abs(a).max(), 1e-30)
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol * scale)


def _both(m_new, m_old, x, bf16_x, precision, absolute_ll):
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if bf16_x:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    j = pk.rotated_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old), jx, jd.Tanh(),
                              True, True, interpret=True, precision=precision,
                              absolute_ll=absolute_ll)
    out = K.rotated_fused_sums_plain(torch.from_numpy(m_new), torch.from_numpy(m_old),
                                     tx, td.Tanh(), True, True, precision, absolute_ll)
    return j, out


@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("n", [1, 15, 17, 63])
def test_fused_tiers_match_pallas_at_tile_edges(n, precision, absolute_ll):
    """N one short of, and one past, a 16-row tile, and a single row."""
    m_new, m_old, x = _inputs(n, T_EDGE, 20 + n)
    j, out = _both(m_new, m_old, x, False, precision, absolute_ll)
    _check(j, out, TOL[precision])


@pytest.mark.parametrize("precision,absolute_ll", [("bf16", True), ("bf16x3", False)],
                         ids=["plain-bf16", "delta-bf16x3"])
@pytest.mark.parametrize("n", [16, 17, 63])
def test_fused_tiers_bf16_x_match_pallas(n, precision, absolute_ll):
    """bf16 X (the bf16 stage's copy): the rotation at the bf16 tier and the
    contractions at the requested one."""
    m_new, m_old, x = _inputs(n, T_EDGE, 40 + n)
    j, out = _both(m_new, m_old, x, True, precision, absolute_ll)
    _check(j, out, TOL["bf16"])


def _fused_outputs(n):
    """The fused wrapper's outputs with H on and Y^2 off (two offsets
    None)."""
    vec, mat = (n,), (n, n)
    return [(vec, True), (vec, False), (mat, True), (vec, True), (mat, True), (vec, False)]


@pytest.mark.parametrize("n", [1, 17, 64])
@pytest.mark.parametrize("n_parts", [1, 2, 3, 5, 7, 31, 977, 1954])
def test_packed_partials_fold_as_per_output_folds(n_parts, n):
    """The packed buffer's offsets, and its fold sliced per output, bit for
    bit the fold of each output's own partials."""
    outputs = _fused_outputs(n)
    offsets, size = K.packed_offsets(outputs)
    assert offsets == [0, None, n, n + n * n, 2 * n + n * n, None]
    assert size == 2 * n + 2 * n * n
    g = torch.Generator().manual_seed(n_parts * 100 + n)
    parts = [torch.randn((n_parts, *shape), generator=g) * 1e3 if flag else None
             for shape, flag in outputs]
    buf = torch.empty((n_parts, size))
    for p, o in zip(parts, offsets):
        if p is not None:
            buf[:, o: o + p[0].numel()] = p.reshape(n_parts, -1)
    got = K.unpack_folded(K.fold_partials(buf), outputs, offsets, buf)
    for p, v, (shape, _) in zip(parts, got, outputs):
        assert v.shape == shape and v.dtype == torch.float32
        if p is None:
            assert not v.any()
        else:
            assert torch.equal(v, fold_pairwise(p))


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
def test_cpu_fused_calls_count_no_tier(precision, bf16_x):
    """On the CPU the fused wrapper runs its plain version: neither its
    launch count nor any tier's count moves."""
    m_new, m_old, x = (torch.from_numpy(v) for v in _inputs(8, 700, 60))
    if bf16_x:
        x = x.to(torch.bfloat16)
    K.reset_launch_counts()
    assert K.rotated_fused_sums.launches_by_tier == {"f32": 0, "bf16x3": 0, "bf16": 0}
    for absolute_ll in (False, True):
        K.rotated_fused_sums(m_new, m_old, x, td.Tanh(), True, True, precision, absolute_ll)
    assert K.rotated_fused_sums.launches_by_tier == {"f32": 0, "bf16x3": 0, "bf16": 0}
    assert K.rotated_fused_sums.launches == 0
