"""Plain versions of the port's kernels against the JAX Pallas kernels.

``ops/kernels.py`` holds, for each CUDA kernel, a plain PyTorch version
that the wrapper runs for CPU tensors. Here the same NumPy inputs go
through it and through ``picard_ica_tpu.ops.pallas_kernels`` in
interpret mode (as tests/test_pallas.py runs them on the CPU). The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances:
  * f64: 1e-9 relative to each output's scale, as test_pallas.py holds
    the Pallas kernels to plain NumPy (per-tile partials vs one sum).
  * f32: 2e-5 relative to each output's scale — f32 sums over a few
    thousand columns in another order (per-tile partials + pairwise
    fold in JAX, one torch reduction here).
  * bf16 X / bf16 tiers: 2e-4 relative to scale — outputs computed from
    Y values whose f32 rotation sums of exact bf16 products are ordered
    differently, fed through the density.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picard_ica_tpu.ops import densities as jd
from picard_ica_tpu.ops import pallas_kernels as pk
from picard_ica_tpu_torch.ops import densities as td
from picard_ica_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

DENS = {"tanh": (jd.Tanh(), td.Tanh()), "exp0.5": (jd.Exp(0.5), td.Exp(0.5)),
        "cube": (jd.Cube(), td.Cube())}
TOL = {"f64": 1e-9, "f32": 2e-5, "bf16": 2e-4}


def _inputs(n, t, seed, dtype):
    rng = np.random.default_rng(seed)
    m_old = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    m_new = m_old + 0.05 * rng.standard_normal((n, n))
    x = rng.laplace(size=(n, t)) / np.sqrt(2.0)
    return m_new.astype(dtype), m_old.astype(dtype), x.astype(dtype)


def _check(j_out, t_out, tol):
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        scale = max(np.abs(a).max(), 1e-300)
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("t", [255, 1000])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("dens", list(DENS))
def test_fused_plain_version_matches_pallas_f64(dens, absolute_ll, t):
    jden, tden = DENS[dens]
    m_new, m_old, x = _inputs(4, t, 6, np.float64)
    j = pk.rotated_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old), jnp.asarray(x),
                              jden, True, True, interpret=True, absolute_ll=absolute_ll)
    out = K.rotated_fused_sums(torch.from_numpy(m_new), torch.from_numpy(m_old),
                               torch.from_numpy(x), tden, True, True,
                               absolute_ll=absolute_ll)
    _check(j, out, TOL["f64"])


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
def test_fused_plain_version_matches_pallas_tiers_f32(precision, absolute_ll):
    m_new, m_old, x = _inputs(8, 1000, 7, np.float32)
    jden, tden = DENS["tanh"]
    j = pk.rotated_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old), jnp.asarray(x),
                              jden, True, True, interpret=True, precision=precision,
                              absolute_ll=absolute_ll)
    out = K.rotated_fused_sums(torch.from_numpy(m_new), torch.from_numpy(m_old),
                               torch.from_numpy(x), tden, True, True,
                               precision=precision, absolute_ll=absolute_ll)
    for v in out:
        assert v.dtype == torch.float32
    _check(j, out, TOL["bf16"] if precision == "bf16" else TOL["f32"])


@pytest.mark.parametrize("precision,absolute_ll", [("f32", True), ("bf16", True), ("bf16", False)])
def test_fused_plain_version_matches_pallas_bf16_x(precision, absolute_ll):
    """bf16 X (the cheap tier's copy): weights rounded to bf16, an f32
    tier becomes bf16, outputs stay f32."""
    m_new, m_old, x = _inputs(16, 700, 8, np.float32)
    jden, tden = DENS["tanh"]
    j = pk.rotated_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old),
                              jnp.asarray(x).astype(jnp.bfloat16), jden, True, True,
                              interpret=True, precision=precision, absolute_ll=absolute_ll)
    out = K.rotated_fused_sums(torch.from_numpy(m_new), torch.from_numpy(m_old),
                               torch.from_numpy(x).to(torch.bfloat16), tden, True, True,
                               precision=precision, absolute_ll=absolute_ll)
    for v in out:
        assert v.dtype == torch.float32
    _check(j, out, TOL["bf16"])


@pytest.mark.parametrize("flags", [(False, False), (True, False), (False, True)])
def test_fused_flags_off_give_zeros(flags):
    need_h, need_ysq = flags
    m_new, m_old, x = _inputs(4, 300, 9, np.float64)
    jden, tden = DENS["tanh"]
    j = pk.rotated_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old), jnp.asarray(x),
                              jden, need_h, need_ysq, interpret=True)
    out = K.rotated_fused_sums(torch.from_numpy(m_new), torch.from_numpy(m_old),
                               torch.from_numpy(x), tden, need_h, need_ysq)
    _check(j, out, TOL["f64"])
    if not need_h:
        assert not out[4].any()
    if not need_ysq:
        assert not out[1].any() and not out[5].any()


@pytest.mark.parametrize("t", [255, 1000])
@pytest.mark.parametrize("dens", list(DENS))
def test_moments_plain_version_matches_pallas_f64(dens, t):
    jden, tden = DENS[dens]
    _, w, x = _inputs(5, t, 10, np.float64)
    j = pk.rotated_moments_sums(jnp.asarray(w), jnp.asarray(x), jden, True, True,
                                interpret=True)
    out = K.rotated_moments_sums(torch.from_numpy(w), torch.from_numpy(x), tden, True, True)
    _check(j, out, TOL["f64"])


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_moments_plain_version_matches_pallas_f32(x_dtype):
    _, w, x = _inputs(16, 1000, 11, np.float32)
    jden, tden = DENS["tanh"]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if x_dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    j = pk.rotated_moments_sums(jnp.asarray(w), jx, jden, False, True, interpret=True)
    out = K.rotated_moments_sums(torch.from_numpy(w), tx, tden, False, True)
    _check(j, out, TOL[x_dtype])


@pytest.mark.parametrize("t", [255, 256, 1000])
@pytest.mark.parametrize("dens", list(DENS))
def test_loglik_plain_version_matches_pallas_f64(dens, t):
    jden, tden = DENS[dens]
    _, m, x = _inputs(4, t, 12, np.float64)
    j = pk.rotated_loglik_sums(jnp.asarray(m), jnp.asarray(x), jden, True, interpret=True)
    out = K.rotated_loglik_sums(torch.from_numpy(m), torch.from_numpy(x), tden, True)
    _check(j, out, TOL["f64"])


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_loglik_plain_version_matches_pallas_f32(x_dtype):
    _, m, x = _inputs(16, 1000, 13, np.float32)
    jden, tden = DENS["exp0.5"]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if x_dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    j = pk.rotated_loglik_sums(jnp.asarray(m), jx, jden, False, interpret=True)
    out = K.rotated_loglik_sums(torch.from_numpy(m), tx, tden, False)
    _check(j, out, TOL[x_dtype])


def test_cpu_wrappers_count_no_launches():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    K.reset_launch_counts()
    m_new, m_old, x = _inputs(4, 300, 14, np.float32)
    args = (torch.from_numpy(m_new), torch.from_numpy(m_old), torch.from_numpy(x))
    K.rotated_fused_sums(*args, td.Tanh(), True, True)
    K.rotated_moments_sums(args[0], args[2], td.Tanh(), True, True)
    K.rotated_loglik_sums(args[0], args[2], td.Tanh(), True)
    assert [k.launches for k in K.KERNELS] == [0] * len(K.KERNELS)
