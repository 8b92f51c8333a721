"""The fused pass's f32 tier as the tensor-core kernel computes it, on the CPU.

``rotated_fused_sums`` runs its f32 tier on the tensor cores
(csrc/rotated_fused_tc.cu): each f32 operand split three ways into bf16
parts (hi, mid, lo) and the six products whose terms reach 2^-16 of
hi*hi, on ``mma.sync`` with f32 accumulation -- the TPU's
``Precision.HIGHEST``. The rotation puts hi on a fixed-point grid per
row of the weights and per column of X, so that its hi*hi sums are
exact (the tensor cores round an accumulation toward zero); the
contraction splits elementwise. The small products are summed first
and hi*hi last. The contraction sums each 16-column step's six products
in a fresh f32 sum, adds the steps in order to their 256-column group's
sum and the groups to their 2,048-column block's partial, as the
moments mode does (tests/test_torch_core_tc.py), and folds the blocks'
partials pairwise. Added straight into the block's partial, 128 steps
a block, the steps' sums failed the bound below (N = 1, 15 and 64).

This file emulates that arithmetic in torch (the split, the six f32
products of bf16-valued operands, small products first, the step and
block order of the contraction) and runs it
through ``rotated_fused_sums_plain`` in place of the exact-f32 products
of its ``"f32"`` tier:
  * the split itself: exact elementwise, on the grid for the rotation;
  * the fused sums: each output's error against the f64 plain version
    at most F32_ERR_FACTOR times the exact-f32 plain version's plus
    F32_SCALE_FLOOR of the output's scale, and agreement with the JAX
    package's Pallas kernel (``precision="f32"``, interpret mode) to the
    f32 tolerance of tests/test_torch_kernels.py;
  * fits at tol 1e-7 through the emulated tier, against exact f32.

The emulation is test arithmetic: the package's plain version stays
exact f32, and the card's tests hold the kernel against it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picard_ica_tpu.ops import densities as jd
from picard_ica_tpu.ops import pallas_kernels as pk
from picard_ica_tpu_torch import Picard, PicardConfig
from picard_ica_tpu_torch.ops import densities as td
from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.ops.moments import fold_pairwise
from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

torch.set_num_threads(2)

# As tests/test_torch_cuda.py holds the kernel at 64 x 2,000,000.
F32_ERR_FACTOR = 2.0
F32_SCALE_FLOOR = 1e-7
# f32 sums in another order (tests/test_torch_kernels.py).
F32_TOL = 2e-5
# One column past the first 2,048-column partial.
T_EDGE = 2049
# The contraction's block partial, group and step (columns).
COLS = K.COLS_PER_BLOCK
GROUP = 256
STEP = 16

DENS = {"tanh": (jd.Tanh(), td.Tanh()), "exp0.5": (jd.Exp(0.5), td.Exp(0.5)),
        "cube": (jd.Cube(), td.Cube())}


# ---- the kernel's arithmetic, emulated -------------------------------------


def _bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def split3(v):
    """hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)."""
    hi = _bf16(v)
    mid = _bf16(v - hi)
    return hi, mid, _bf16(v - hi - mid)


def grid_sigma(m):
    """1.5 * 2^(e + 16) for maxima m = 2^e * 1.f (mma_tiers.cuh
    grid_sigma): (v + sigma) - sigma puts |v| <= m on multiples of
    2^(e - 7). Zero and subnormal m take e = -126."""
    _, e = torch.frexp(m)
    e = torch.where(m > 0, e - 1, -126).clamp(-126, 111)
    return torch.ldexp(torch.full_like(m, 1.5), e + 16)


def split3_grid(v, sigma):
    """hi on the grid of ``sigma``, then the bf16 split of v - hi."""
    hi = (v + sigma) - sigma
    mid = _bf16(v - hi)
    return hi, mid, _bf16(v - hi - mid)


def six_pass_dot(a, b, grid):
    """``a @ b`` in f32 from the six products of the three-way splits:
    lo*hi + mid*mid + hi*lo + mid*hi + hi*mid first, then hi*hi. With
    ``grid``, hi lies on a grid per row of ``a`` and per column of ``b``."""
    if grid:
        ah, am, al = split3_grid(a, grid_sigma(a.abs().amax(dim=1, keepdim=True)))
        bh, bm, bl = split3_grid(b, grid_sigma(b.abs().amax(dim=0, keepdim=True)))
    else:
        (ah, am, al), (bh, bm, bl) = split3(a), split3(b)
    small = al @ bh + am @ bm + ah @ bl + am @ bh + ah @ bm
    return small + ah @ bh


def stepped_contraction(a, b):
    """``a @ b`` over T ((N, T) times (T, N)) as the fused kernel sums it:
    six products of elementwise splits a 16-column step, the steps' sums
    added in order in f32 to their 256-column group's sum and the groups
    to their 2,048-column block's partial, the blocks' partials folded
    pairwise. Padded columns are zeros."""
    n, t = a.shape
    t_pad = -(-t // COLS) * COLS
    a = torch.nn.functional.pad(a, (0, t_pad - t)).reshape(n, t_pad // STEP, STEP)
    b = torch.nn.functional.pad(b, (0, 0, 0, t_pad - t)).reshape(t_pad // STEP, STEP, -1)
    steps = six_pass_dot(a.transpose(0, 1), b, grid=False)
    steps = steps.reshape(t_pad // COLS, COLS // GROUP, GROUP // STEP, n, b.shape[2])
    acc = torch.zeros_like(steps[:, 0, 0])
    for g in range(COLS // GROUP):
        group = torch.zeros_like(acc)
        for k in range(GROUP // STEP):
            group = group + steps[:, g, k]
        acc = acc + group
    return fold_pairwise(acc)


def _emulated_kernel_dot(real):
    """``ops.kernels._kernel_dot`` with its f32-tier products as the
    kernel's: the rotations ((N, N) weights times (N, T) X) on the grid,
    the contractions ((N, T) times (T, N)) elementwise, in the kernel's
    order of steps and blocks."""

    def dot(a, b, acc, precision):
        if precision != "f32" or acc != torch.float32:
            return real(a, b, acc, precision)
        rotation = a.shape[0] == a.shape[1]
        assert rotation != (b.shape[1] == a.shape[0]), "ambiguous at T == N"
        if rotation:
            return six_pass_dot(a.float(), b.float(), True)
        return stepped_contraction(a.float(), b.float())

    return dot


@pytest.fixture
def emulate(monkeypatch):
    """A switch: after ``emulate()``, ``rotated_fused_sums_plain`` (and so
    the CPU wrapper, and fits with ``use_kernels=True``) runs the kernel's
    f32 arithmetic; the moments and loglik passes stay exact f32, as their
    kernels are. ``emulate()`` returns the list its calls append to."""
    calls = []
    inner = K.rotated_fused_sums_plain
    dot = _emulated_kernel_dot(K._kernel_dot)

    def fused(*args, **kwargs):
        calls.append(1)
        with monkeypatch.context() as m:
            m.setattr(K, "_kernel_dot", dot)
            return inner(*args, **kwargs)

    def enable():
        monkeypatch.setattr(K, "rotated_fused_sums_plain", fused)
        return calls

    return enable


# ---- the split ---------------------------------------------------------------


def _f32_values(seed, size=20_000):
    """f32 values across exponents [-100, 100] and signs, plus bf16
    rounding ties of hi (low 16 bits 0x8000) and of mid."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**23, size, dtype=np.uint32)
    bits |= (rng.integers(27, 228, size, dtype=np.uint32) << 23)
    bits |= (rng.integers(0, 2, size, dtype=np.uint32) << 31)
    bits[: size // 4] = (bits[: size // 4] & 0xFFFF0000) | 0x8000
    bits[size // 4: size // 2] = (bits[size // 4: size // 2] & 0xFFFFFF00) | 0x80
    return torch.from_numpy(bits.view(np.float32).copy())


def _is_bf16(v):
    return torch.equal(v, _bf16(v))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_way_split_is_exact(seed):
    v = _f32_values(seed)
    hi, mid, lo = split3(v)
    assert all(_is_bf16(p) for p in (hi, mid, lo))
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
    # Each part is at most half an ulp of the one before, in bf16.
    assert bool((mid.abs() <= hi.abs() * 2.0**-8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0**-8).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_split_makes_the_hi_products_exact(seed):
    """On the grid of its row (column) maximum 2^E, hi is a bf16 value and
    a multiple of 2^(E - 7); hi + mid + lo is v to 2^(E - 24), exactly
    where v's exponent is E; and hi*hi sums of 64 terms are exact in f32."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((np.eye(64) + 0.1 * rng.standard_normal((64, 64))).astype(np.float32))
    x = torch.from_numpy(rng.laplace(size=(64, 3000)).astype(np.float32))
    x[:, :1000] *= torch.from_numpy(10.0 ** rng.uniform(-30, 30, 1000).astype(np.float32))
    x[:, -1] = 0.0
    for v, dim in ((w, 1), (x, 0)):
        m = v.abs().amax(dim=dim, keepdim=True)
        hi, mid, lo = split3_grid(v, grid_sigma(m))
        assert all(_is_bf16(p) for p in (hi, mid, lo))
        _, e = torch.frexp(m)
        unit = torch.ldexp(torch.ones_like(m), e - 8).double()
        assert torch.equal(torch.remainder(hi.double(), unit), torch.zeros_like(hi.double()))
        err = (hi.double() + mid.double() + lo.double() - v.double()).abs()
        assert bool((err <= unit * 2.0**-16).all())
        top = torch.frexp(v)[1] == e
        assert not bool(err[top].any())
    wh = split3_grid(w, grid_sigma(w.abs().amax(dim=1, keepdim=True)))[0]
    xh = split3_grid(x, grid_sigma(x.abs().amax(dim=0, keepdim=True)))[0]
    assert torch.equal((wh @ xh).double(), wh.double() @ xh.double())


# ---- the fused sums --------------------------------------------------------


def _inputs(n, t, seed):
    rng = np.random.default_rng(seed)
    m_old = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    m_new = m_old + 0.05 * rng.standard_normal((n, n))
    x = rng.laplace(size=(n, t)) / np.sqrt(2.0)
    return m_new.astype(np.float32), m_old.astype(np.float32), x.astype(np.float32)


@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("n", [1, 15, 17, 63, 64])
def test_emulated_f32_tier_error_against_f64(emulate, n, absolute_ll, dens):
    jden, tden = DENS[dens]
    m_new, m_old, x = _inputs(n, T_EDGE, 70 + n)
    t_args = [torch.from_numpy(v) for v in (m_new, m_old, x)]
    flags = (True, True, "f32", absolute_ll)
    exact = K.rotated_fused_sums_plain(*t_args, tden, *flags)
    ref = K.rotated_fused_sums_plain(*(v.double() for v in t_args), tden, *flags)
    calls = emulate()
    emul = K.rotated_fused_sums(*t_args, tden, *flags)
    assert calls == [1]
    j = pk.rotated_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old), jnp.asarray(x), jden,
                              True, True, interpret=True, precision="f32",
                              absolute_ll=absolute_ll)
    for e, p, r, jv in zip(emul, exact, ref, j):
        assert e.dtype == torch.float32 and e.shape == r.shape
        scale = float(r.abs().max())
        err_e = float((e.double() - r).abs().max())
        err_p = float((p.double() - r).abs().max())
        assert err_e <= F32_ERR_FACTOR * err_p + F32_SCALE_FLOOR * scale, (err_e, err_p, scale)
        jv = np.asarray(jv, np.float64)
        np.testing.assert_allclose(e.double().numpy(), jv, rtol=F32_TOL,
                                   atol=F32_TOL * max(np.abs(jv).max(), 1e-30))


# ---- fits ------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixture():
    _, a, x = generate_mixed_kurtosis_data(16, 50_000, 0)
    return a, x


@pytest.mark.parametrize("precision", ["f32", "auto"])
def test_fit_through_the_emulated_f32_tier(mixture, emulate, precision):
    """tol 1e-7 through the kernel's f32 arithmetic: converged, within two
    iterations of the exact-f32 fit, on its unmixing to Amari < 1e-6."""
    a, x = mixture
    cfg = PicardConfig(random_state=0, use_kernels=True, kernel_precision=precision, tol=1e-7)
    r_x = Picard.fit(x, cfg, device="cpu")
    calls = emulate()
    r_e = Picard.fit(x, cfg, device="cpu")
    assert calls
    assert r_x.converged and r_e.converged
    assert abs(r_e.n_iterations - r_x.n_iterations) <= 2
    w_e = r_e.full_unmixing().double().numpy()
    w_x = r_x.full_unmixing().double().numpy()
    assert amari_distance(w_e, np.linalg.inv(w_x)) < 1e-6
    assert amari_distance(w_e, a) < 5e-3
