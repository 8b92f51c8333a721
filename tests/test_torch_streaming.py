"""The port's core loop above N = 64 against the JAX package, on the CPU.

The streaming kernels' plain versions (``ops/kernels.streaming_*_plain``)
against ``picard_ica_tpu.ops.pallas_kernels.streaming_*`` in interpret
mode, the hand-off of the ``rotated_*`` wrappers, and whole fits at
N = 72 through ``use_kernels=True``. Inputs are made with NumPy from a
seed. The CUDA kernels are held against the plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances:
  * f64: rtol 1e-12 and atol 1e-12 of each output's largest entry, as
    tests/test_streaming.py holds the streaming kernels to the resident
    ones (the two packages cut T into other tiles, so sums are ordered
    differently).
  * f32 and bf16x3 contractions: 2e-5 of each output's largest entry —
    f32 sums over a few thousand columns in another order.
  * a bf16 contraction (the bf16 tier, or an f32 request on bf16 X): 1e-3
    of each output's largest entry — psi and Y are rounded to bf16 after
    a rotation whose f32 sums are ordered differently, so a few roundings
    flip by 2^-8 (tests/test_torch_cuda.py RTOL_BF16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picard_ica_tpu as J
import picard_ica_tpu_torch as P
from picard_ica_tpu.ops import densities as jd
from picard_ica_tpu.ops import pallas_kernels as pk
from picard_ica_tpu_torch import solver
from picard_ica_tpu_torch.ops import densities as td
from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.ops.moments import fold_pairwise
from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

torch.set_num_threads(2)

DENS = {"tanh": (jd.Tanh(), td.Tanh()), "exp0.5": (jd.Exp(0.5), td.Exp(0.5)),
        "cube": (jd.Cube(), td.Cube())}
# One and two 128-row W blocks, padded rows, and a ragged T.
SHAPES = [(72, 777), (200, 2049), (130, 513)]
F32_TOL = 2e-5
BF16_TOL = 1e-3


def _inputs(n, t, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    m_old = rng.standard_normal((n, n)) * 0.3
    m_new = m_old + rng.standard_normal((n, n)) * 0.01
    x = rng.standard_normal((n, t))
    return m_new.astype(dtype), m_old.astype(dtype), x.astype(dtype)


def _check(j_out, t_out, tol):
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        assert b.shape == a.shape
        scale = max(np.abs(a).max(), 1e-300)
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol * scale)


def _fused(m_new, m_old, x, dens, need_h, need_ysq, precision="f32",
           absolute_ll=False, x_bf16=False):
    jden, tden = DENS[dens]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if x_bf16:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    j = pk.streaming_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old), jx, jden,
                                need_h, need_ysq, interpret=True,
                                precision=precision, absolute_ll=absolute_ll)
    t = K.streaming_fused_sums_plain(torch.from_numpy(m_new), torch.from_numpy(m_old),
                                     tx, tden, need_h, need_ysq, precision, absolute_ll)
    return j, t


@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n,t", SHAPES)
def test_fused_plain_version_matches_jax_streaming_f64(n, t, dens, absolute_ll):
    m_new, m_old, x = _inputs(n, t, 1)
    _check(*_fused(m_new, m_old, x, dens, True, True, absolute_ll=absolute_ll), 1e-12)


@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("flags", [(False, False), (True, False), (False, True)])
def test_fused_flags_off_give_zeros(flags, absolute_ll):
    m_new, m_old, x = _inputs(130, 513, 2)
    j, t = _fused(m_new, m_old, x, "tanh", *flags, absolute_ll=absolute_ll)
    _check(j, t, 1e-12)
    need_h, need_ysq = flags
    if not need_h:
        assert not t[4].any()
    if not need_ysq:
        assert not t[1].any() and not t[5].any()


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
def test_fused_plain_version_matches_jax_streaming_tiers_f32(precision, absolute_ll):
    """f32 X at every tier; at bf16 (a kernel_precision="bf16" fit's
    tries, and plain mode's direct call) X and the weights are rounded to
    bf16 inside the rotation, and psi and Y inside the contraction."""
    m_new, m_old, x = _inputs(130, 2049, 3, np.float32)
    j, t = _fused(m_new, m_old, x, "tanh", True, True, precision, absolute_ll)
    for v in t:
        assert v.dtype == torch.float32
    _check(j, t, BF16_TOL if precision == "bf16" else F32_TOL)


# (precision, absolute_ll) on bf16 X; the ids of the plain-mode cases
# name only the precision.
BF16_X_CASES = [("f32", True), ("bf16", True), ("bf16x3", True),
                ("f32", False), ("bf16", False), ("bf16x3", False)]


@pytest.mark.parametrize("precision,absolute_ll", BF16_X_CASES,
                         ids=["f32", "bf16", "plain-bf16x3", "delta-f32", "delta-bf16",
                              "delta-bf16x3"])
def test_fused_plain_version_matches_jax_streaming_bf16_x(precision, absolute_ll):
    """bf16 X (the bf16 tier's copy): the weights are rounded to bf16, the
    rotation runs the bf16 tier and an f32 request runs the bf16 tier;
    a bf16x3 request keeps the hi / lo contraction."""
    m_new, m_old, x = _inputs(130, 2049, 4, np.float32)
    j, t = _fused(m_new, m_old, x, "tanh", True, True, precision, absolute_ll, x_bf16=True)
    for v in t:
        assert v.dtype == torch.float32
    _check(j, t, F32_TOL if precision == "bf16x3" else BF16_TOL)


# Kernel 8's launch B alone: (N, T) with one and two 128-row blocks and
# a ragged T.
CONTRACT_SHAPES = [(65, 3001), (130, 4099)]


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("n,t", CONTRACT_SHAPES)
@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
def test_contract_plain_version_matches_jax_streaming(monkeypatch, precision, n, t, chunked):
    """Launch B's plain version (``K.stream_contract_sums_plain``) over the
    workspace of the port's own plain rotation and density
    (``K.contract_workspace``), its groups folded pairwise, gives the JAX
    package's G and H (plain mode on f32 X at the tier). ``chunked``:
    groups of 128 columns, two a chunk."""
    m, _, x = _inputs(n, t, 8, np.float32)
    jden, tden = DENS["tanh"]
    j = pk.streaming_fused_sums(jnp.asarray(m), jnp.asarray(m), jnp.asarray(x), jden, True,
                                False, interpret=True, precision=precision, absolute_ll=True)
    y = K._kernel_dot(torch.from_numpy(m), torch.from_numpy(x), torch.float32, precision)
    psi, psi_d = tden.score_and_der(y)
    if chunked:
        monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 128)
        n_pad = -(-n // 128) * 128
        monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX",
                            2 * 128 * 2 * 2 * K._TC_ELEM_BYTES[precision] * n_pad)
    plan = K.stream_tc_plan(n, t, True, precision)
    assert plan.groups_per_chunk == (2 if chunked else plan.n_parts)
    ws = K.contract_workspace([psi, y, psi_d, y * y], precision, plan)
    g, h = K.stream_contract_sums_plain(ws, n, precision, True, plan.cols_per_group,
                                        plan.n_parts)
    assert g.shape == h.shape == (plan.n_parts, n, n)
    _check((j[2], j[4]), (fold_pairwise(g), fold_pairwise(h)),
           BF16_TOL if precision == "bf16" else F32_TOL)


def test_group_boundaries_match_jax(monkeypatch):
    """Groups of 2 tiles in both packages: 71 tiles of 128 in 36 groups
    here, 5 tiles of 2048 in 3 groups in the JAX package."""
    monkeypatch.setattr(pk, "_STREAM_GROUP", 2)
    monkeypatch.setattr(K, "STREAM_GROUP", 2)
    m_new, m_old, x = _inputs(72, 9001, 5)  # a shape no other test traces
    _check(*_fused(m_new, m_old, x, "tanh", True, True), 1e-12)


@pytest.mark.parametrize("need_ysq", [False, True])
@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n,t", SHAPES)
def test_loglik_plain_version_matches_jax_streaming(n, t, dens, need_ysq):
    _, m, x = _inputs(n, t, 6)
    jden, tden = DENS[dens]
    j = pk.streaming_loglik_sums(jnp.asarray(m), jnp.asarray(x), jden, need_ysq,
                                 interpret=True)
    out = K.streaming_loglik_sums_plain(torch.from_numpy(m), torch.from_numpy(x),
                                        tden, need_ysq)
    _check(j, out, 1e-12)


def test_loglik_plain_version_matches_jax_streaming_bf16_x():
    _, m, x = _inputs(200, 2049, 7, np.float32)
    jden, tden = DENS["exp0.5"]
    j = pk.streaming_loglik_sums(jnp.asarray(m), jnp.asarray(x).astype(jnp.bfloat16),
                                 jden, True, interpret=True)
    out = K.streaming_loglik_sums_plain(torch.from_numpy(m),
                                        torch.from_numpy(x).to(torch.bfloat16), tden, True)
    _check(j, out, BF16_TOL)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(K, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(K, name, spy)
    return calls


def test_resident_wrappers_hand_off_above_kernel_max_n(monkeypatch):
    """At N = 72 the port's rotated_* wrappers take the streaming plain
    versions and equal the JAX package's rotated_* wrappers (which run
    its resident kernels there) to 1e-12 in f64."""
    fused = _spy(monkeypatch, "streaming_fused_sums_plain")
    loglik = _spy(monkeypatch, "streaming_loglik_sums_plain")
    m_new, m_old, x = _inputs(72, 1000, 8)
    jm_new, jm_old, jx = jnp.asarray(m_new), jnp.asarray(m_old), jnp.asarray(x)
    tm_new, tm_old, tx = (torch.from_numpy(v) for v in (m_new, m_old, x))
    jden, tden = DENS["tanh"]
    K.reset_launch_counts()
    _check(pk.rotated_fused_sums(jm_new, jm_old, jx, jden, True, True, interpret=True),
           K.rotated_fused_sums(tm_new, tm_old, tx, tden, True, True), 1e-12)
    assert len(fused) == 1
    _check(pk.rotated_moments_sums(jm_old, jx, jden, True, True, interpret=True),
           K.rotated_moments_sums(tm_old, tx, tden, True, True), 1e-12)
    assert len(fused) == 2
    _check(pk.rotated_loglik_sums(jm_old, jx, jden, True, interpret=True),
           K.rotated_loglik_sums(tm_old, tx, tden, True), 1e-12)
    assert len(loglik) == 1
    assert [k.launches for k in K.KERNELS] == [0] * len(K.KERNELS)


def test_partials_budget_routes_to_streaming(monkeypatch):
    """Below the N cap but above the resident partials budget the
    wrappers stream too (tests/test_streaming.py's rule)."""
    m_new, m_old, x = _inputs(48, 1152, 9)
    args = tuple(torch.from_numpy(v) for v in (m_new, m_old, x))
    resident = K.rotated_fused_sums(*args, td.Tanh(), True, True)
    monkeypatch.setattr(K, "RESIDENT_PARTIALS_MAX", 1024)
    calls = _spy(monkeypatch, "streaming_fused_sums")
    routed = K.rotated_fused_sums(*args, td.Tanh(), True, True)
    assert calls, "the partials budget did not hand off to the streaming kernel"
    direct = K.streaming_fused_sums_plain(*args, td.Tanh(), True, True)
    for a, b, c in zip(direct, routed, resident):
        assert torch.equal(a, b)
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(c.abs().max()))


def test_wrappers_raise_above_stream_max_n():
    n = K.STREAM_MAX_N + 1
    x = torch.zeros((n, 10))
    eye = torch.eye(n)
    with pytest.raises(ValueError, match="STREAM_MAX_N"):
        K.rotated_fused_sums(eye, eye, x, td.Tanh(), False, False)
    with pytest.raises(ValueError, match="STREAM_MAX_N"):
        K.rotated_moments_sums(eye, x, td.Tanh(), False, False)
    with pytest.raises(ValueError, match="STREAM_MAX_N"):
        K.rotated_loglik_sums(eye, x, td.Tanh(), False)


def test_solver_refuses_kernels_above_stream_max_n(monkeypatch):
    monkeypatch.setattr(solver, "STREAM_MAX_N", 4)
    x = np.random.default_rng(0).standard_normal((6, 500))
    with pytest.raises(P.InvalidConfigError, match="streaming"):
        P.Picard.fit(x, P.PicardConfig(use_kernels=True, random_state=0), device="cpu")
    # auto and the torch path are not capped
    assert P.Picard.fit(x, P.PicardConfig(random_state=0, max_iter=2),
                        device="cpu").n_iterations == 2


def _whitened(n, t, seed):
    """A mixed sub/super-Gaussian mixture centered and whitened in NumPy
    f64, so that a comparison holds the core loops alone: at N = 72 the
    two packages' f64 eigh differ by ~1e-8 in the final W."""
    _, _, x = generate_mixed_kurtosis_data(n, t, seed)
    x = x - x.mean(axis=1, keepdims=True)
    d, e = np.linalg.eigh(x @ x.T / t)
    return (e / np.sqrt(d)).T @ x


def test_fit_f64_streaming_matches_jax(monkeypatch):
    """The whole core loop at N = 72 in f64, ortho + extended, to
    convergence: the port's fit through the streaming plain versions
    against the JAX package's XLA path; the same iterations and W to
    1e-9."""
    calls = _spy(monkeypatch, "streaming_fused_sums_plain")
    x = _whitened(72, 4000, 11)
    kw = dict(random_state=0, kernel_precision="f32", centering=False, whiten=False)
    rj = J.Picard.fit(x, J.PicardConfig(use_pallas=False, **kw))
    rt = P.Picard.fit(x, P.PicardConfig(dtype=torch.float64, use_kernels=True, **kw),
                      device="cpu")
    assert calls
    assert rt.converged and bool(rj.converged)
    assert rt.n_iterations == int(rj.n_iterations)
    np.testing.assert_allclose(rt.full_unmixing().numpy(), np.asarray(rj.full_unmixing()),
                               rtol=1e-9, atol=1e-9)


def test_fit_f32_streaming_matches_jax():
    """An f32 fit of a 72 x 10,000 mixed mixture at the default config
    through the streaming plain versions against the JAX package's f32
    fit: both converge at tol 1e-7 and agree to Amari < 1e-4. Each f32
    path stops at its own point of a flat optimum at this sample count:
    the port's torch path lands 1.0e-5 from the JAX fit, the streaming
    path 3.5e-5 from it and 2.8e-5 from the torch path."""
    _, a, x = generate_mixed_kurtosis_data(72, 10_000, 12)
    rj = J.Picard.fit(x, J.PicardConfig(random_state=0, dtype=jnp.float32))
    rt = P.Picard.fit(x, P.PicardConfig(random_state=0, use_kernels=True), device="cpu")
    assert rt.converged and bool(rj.converged)
    am = amari_distance(rt.full_unmixing().double().numpy(),
                        np.linalg.inv(np.asarray(rj.full_unmixing(), np.float64)))
    assert am < 1e-4, am
