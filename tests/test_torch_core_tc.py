"""Kernels 2 and 3 as the tensor-core kernel computes them, on the CPU.

``rotated_moments_sums`` and ``rotated_loglik_sums`` run on the tensor
cores at N <= 64, as the moments and log-lik modes of the fused pass's
kernel (csrc/rotated_fused_tc.cu):
  * the rotation: on f32 X at the f32 tier, six bf16 products of
    three-way splits with hi on a fixed-point grid per row of W and per
    column of X (so the hi*hi sums are exact); on bf16 X one product of
    bf16(W) and X, the TPU kernel's ``w.astype(x.dtype)``;
  * the moments' contractions G = psi Y^T and H = psi' (Y^2)^T at the
    f32 tier on both dtypes: psi and Y split elementwise, each
    16-column step's six products summed in a fresh accumulator that is
    added in f32 to its 256-column group's sum, and each group's sum to
    the block's; one partial per 2,048 columns, folded pairwise;
  * the row sums (sum psi', sum Y^2, sum log_lik) in f32 per 2,048-column
    block, folded pairwise; the log-lik mode has no contraction.

This file emulates that arithmetic in torch, with the split and
six-product helpers of tests/test_torch_f32_tier.py, and holds it
against two references on the same NumPy inputs:
  * the JAX package's Pallas kernels (``interpret=True``), to the f32
    tolerance of tests/test_torch_kernels.py;
  * an f64 evaluation of the same sums: the emulation's error at most
    F32_ERR_FACTOR times the exact-f32 plain version's plus
    F32_SCALE_FLOOR of the output's scale.

The emulation is test arithmetic: the package's plain versions stay
exact f32, and the card's tests hold the kernel against them.
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

from test_torch_f32_tier import six_pass_dot

torch.set_num_threads(2)

# As tests/test_torch_f32_tier.py (and tests/test_torch_cuda.py on the
# card): the emulated error against f64 within this factor of the plain
# version's, plus this share of the output's scale.
F32_ERR_FACTOR = 2.0
F32_SCALE_FLOOR = 1e-7
# f32 sums in another order (tests/test_torch_kernels.py).
F32_TOL = 2e-5
# Columns per partial, per group of the contraction's sums and per
# contraction step of the kernel.
COLS = K.COLS_PER_BLOCK
GROUP = 256
STEP = 16
# Two partials, the second one column long.
T_RAGGED = 2049

DENS = {"tanh": (jd.Tanh(), td.Tanh()), "exp0.5": (jd.Exp(0.5), td.Exp(0.5)),
        "cube": (jd.Cube(), td.Cube())}
NS = [1, 17, 63, 64]


# ---- the kernel's arithmetic, emulated -------------------------------------


def _bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def _pad_cols(v, t_pad):
    return torch.nn.functional.pad(v, (0, t_pad - v.shape[1]))


def rotation(w, x):
    """Y = W X in f32: six products of the grid split on f32 X, one
    product of bf16(W) and X on bf16 X."""
    if x.dtype == torch.bfloat16:
        return _bf16(w) @ x.float()
    return six_pass_dot(w, x, grid=True)


def contraction(a, b):
    """``a @ b.T`` over the columns as the kernel sums it: six products of
    elementwise splits a 16-column step, the steps added in order in f32
    to their 256-column group's sum and the groups to their block's, the
    2,048-column blocks folded pairwise."""
    n, t = a.shape
    t_pad = -(-t // COLS) * COLS
    a = _pad_cols(a, t_pad).reshape(n, t_pad // STEP, STEP).transpose(0, 1)
    b = _pad_cols(b, t_pad).reshape(n, t_pad // STEP, STEP).permute(1, 2, 0)
    steps = six_pass_dot(a, b, grid=False).reshape(
        t_pad // COLS, COLS // GROUP, GROUP // STEP, n, n)
    acc = torch.zeros_like(steps[:, 0, 0])
    for g in range(COLS // GROUP):
        group = torch.zeros_like(acc)
        for k in range(GROUP // STEP):
            group = group + steps[:, g, k]
        acc = acc + group
    return fold_pairwise(acc)


def row_sums(v):
    """Row sums in f32, one partial per 2,048 columns, folded pairwise."""
    n, t = v.shape
    t_pad = -(-t // COLS) * COLS
    return fold_pairwise(_pad_cols(v, t_pad).reshape(n, t_pad // COLS, COLS).sum(dim=2).T)


def emulated_moments(w, x, density, need_h, need_ysq):
    """(G, pm, H, ysq) of the moments mode; padded columns are zeros of
    X, whose psi is 0 and whose psi' is masked (not summed)."""
    n = x.shape[0]
    y = rotation(w, x)
    psi, psi_d = density.score_and_der(y)
    g = contraction(psi, y)
    h = contraction(psi_d, y * y) if need_h else torch.zeros(n, n)
    ysq = row_sums(y * y) if need_ysq else torch.zeros(n)
    return g, row_sums(psi_d), h, ysq


def emulated_loglik(m, x, density, need_ysq):
    """(ll, ysq) row sums of the log-lik mode."""
    y = rotation(m, x)
    ysq = row_sums(y * y) if need_ysq else torch.zeros(x.shape[0])
    return row_sums(density.log_lik(y)), ysq


# ---- the checks ------------------------------------------------------------


def _inputs(n, t, seed, bf16_x):
    """Weights near the identity and unit-variance Laplace X (f32 NumPy);
    X and its torch tensor in bf16 when ``bf16_x``."""
    rng = np.random.default_rng(seed)
    w = (np.eye(n) + 0.1 * rng.standard_normal((n, n))).astype(np.float32)
    x = (rng.laplace(size=(n, t)) / np.sqrt(2.0)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if bf16_x:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return w, jx, torch.from_numpy(w), tx


def _f64_args(w, x):
    """The same operands in f64: bf16 X's weights rounded to bf16 first,
    as every version rounds them."""
    if x.dtype == torch.bfloat16:
        w = _bf16(w)
    return w.double(), x.double()


def _hold(emul, exact, ref, jax_out):
    for e, p, r, j in zip(emul, exact, ref, jax_out):
        assert e.dtype == torch.float32 and e.shape == r.shape
        scale = float(r.abs().max())
        err_e = float((e.double() - r).abs().max())
        err_p = float((p.double() - r).abs().max())
        assert err_e <= F32_ERR_FACTOR * err_p + F32_SCALE_FLOOR * scale, (err_e, err_p, scale)
        j = np.asarray(j, np.float64)
        np.testing.assert_allclose(e.double().numpy(), j, rtol=F32_TOL,
                                   atol=F32_TOL * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n", NS)
def test_emulated_moments_mode(n, dens, flags, bf16_x):
    jden, tden = DENS[dens]
    w_np, jx, w, x = _inputs(n, T_RAGGED, 130 + n, bf16_x)
    emul = emulated_moments(w, x, tden, *flags)
    exact = K.rotated_moments_sums(w, x, tden, *flags)
    ref = K.rotated_moments_sums_plain(*_f64_args(w, x), tden, *flags)
    j = pk.rotated_moments_sums(jnp.asarray(w_np), jx, jden, *flags, interpret=True)
    _hold(emul, exact, ref, j)
    if not flags[0]:
        assert not emul[2].any() and not exact[2].any()
    if not flags[1]:
        assert not emul[3].any() and not exact[3].any()


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("need_ysq", [False, True], ids=["ll", "ll+ysq"])
@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n", NS)
def test_emulated_loglik_mode(n, dens, need_ysq, bf16_x):
    jden, tden = DENS[dens]
    w_np, jx, m, x = _inputs(n, T_RAGGED, 170 + n, bf16_x)
    emul = emulated_loglik(m, x, tden, need_ysq)
    exact = K.rotated_loglik_sums(m, x, tden, need_ysq)
    ref = K.rotated_loglik_sums_plain(*_f64_args(m, x), tden, need_ysq)
    j = pk.rotated_loglik_sums(jnp.asarray(w_np), jx, jden, need_ysq, interpret=True)
    _hold(emul, exact, ref, j)
    if not need_ysq:
        assert not emul[1].any() and not exact[1].any()

