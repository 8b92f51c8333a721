"""CUDA kernels of picard_ica_tpu_torch against their plain versions.

Needs an NVIDIA GPU (Hopper, sm_90a): every test here is marked
``cuda`` and skips without one. Imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the kernel and the plain version of the same tier differ
only in the order of f32 sums (products of bf16 values are exact in
f32), so outputs agree to RTOL relative to each output's largest entry;
the bf16 contraction tier of the streaming kernels and of the
tensor-core kernel's tier and shape tests to RTOL_BF16 (see there). The
fused kernel's f32 tier, six bf16 products on the tensor cores, holds
the exact-f32 plain version to RTOL, and at the main path's width its
error against f64 to F32_ERR_FACTOR times the plain version's.
"""

import functools
import math

import numpy as np
import pytest
import torch

from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.ops.densities import Cube, Exp, Tanh

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# f32 sums over a few thousand columns, reordered: ~1e-6 of the largest
# entry; bf16-rounded operands can flip a rounding of psi at a few ulps.
RTOL = 2e-5
# The bf16 contraction tier rounds psi and Y (and Y^2) to bf16 after the
# rotation: a reordered f32 rotation sum over N terms flips some of those
# roundings, each moving a term by up to 2^-8 of itself. Reordering the
# plain version's own rotation (f64 sums rounded to f32) moves G by up to
# 2.7e-4 of its largest entry at N = 1024, T = 1,500 on the CPU; the
# tensor-core kernel's H moved by 2.5e-5 of its largest entry at N = 33,
# T = 2,056 (two flipped Y^2 roundings).
RTOL_BF16 = 1e-3

DENSITIES = [Tanh(), Exp(0.5), Cube()]
# The f32 tier's error against an f64 evaluation may be this many times
# the exact-f32 plain version's, plus F32_SCALE_FLOOR of the output's
# largest entry (an ulp or so, where the plain version's error happens to
# be near zero).
F32_ERR_FACTOR = 2.0
F32_SCALE_FLOOR = 1e-7
# The bf16x3 tier's error against f64 sums of the same split operands may
# be this many times the plain version's, plus DRIFT_FLOOR of the
# output's largest entry (tests/test_torch_stream_tc_cuda.py's rule).
DRIFT_FACTOR = 2.0
DRIFT_FLOOR = 1e-7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, t, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.laplace(size=(n, t)).astype(np.float32)).to(dev)
    m_old = torch.from_numpy(np.eye(n) + 0.2 * rng.standard_normal((n, n))).float().to(dev)
    m_new = m_old + torch.from_numpy(0.05 * rng.standard_normal((n, n))).float().to(dev)
    return x, m_old, m_new


def _close(out_k, out_p, rtol=RTOL):
    for a, b in zip(out_k, out_p):
        assert a.dtype == torch.float32 and a.device.type == "cuda"
        assert bool(torch.isfinite(a).all())
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
def test_fused_matches_plain(dev, density, precision, absolute_ll, flags):
    x, m_old, m_new = _inputs(dev, 8, 5000)
    args = (m_new, m_old, x, density, *flags, precision, absolute_ll)
    before = K.rotated_fused_sums.launches
    out_k = K.rotated_fused_sums(*args)
    assert K.rotated_fused_sums.launches == before + 1
    _close(out_k, K.rotated_fused_sums_plain(*args))


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
def test_fused_bf16_x_matches_plain(dev, precision, absolute_ll):
    x, m_old, m_new = _inputs(dev, 64, 4097, seed=1)
    args = (m_new, m_old, x.to(torch.bfloat16), Tanh(), True, True,
            precision, absolute_ll)
    _close(K.rotated_fused_sums(*args), K.rotated_fused_sums_plain(*args))


# The tensor-core kernel's tier pairs (csrc/rotated_fused_tc.cu), as
# (precision, bf16 X): (bf16, bf16) on f32 and on bf16 X, (bf16x3, bf16x3)
# on f32 X, and bf16 X at the bf16x3 tier (bf16, bf16x3).
TC_PAIRS = [("bf16", False), ("bf16", True), ("bf16x3", False), ("bf16x3", True)]


def _tc_x(dev, n, t, aligned, bf16_x, seed):
    """X (n, t) whose rows are 16-byte aligned (T rounded up to a multiple
    of 8) or not (T odd), in f32 or bf16; the weights of _inputs."""
    if aligned:
        t += -t % 8
    x, m_old, m_new = _inputs(dev, n, t, seed=seed)
    if bf16_x:
        x = x.to(torch.bfloat16)
    row_bytes = t * x.element_size()
    assert (row_bytes % 16 == 0 and x.data_ptr() % 16 == 0) == aligned
    return x, m_old, m_new


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("precision,bf16_x", TC_PAIRS, ids=["bf16", "bf16-bf16x", "bf16x3",
                                                             "bf16x3-bf16x"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_fused_tc_tiers_match_plain(dev, aligned, precision, bf16_x, absolute_ll, flags,
                                    density):
    """Every tier pair, mode, density and flag set of the tensor-core
    kernel, at N = 33 (a live 16-row tile with one row) over two partials;
    the bf16 contraction tier to RTOL_BF16, as the streaming kernels'."""
    x, m_old, m_new = _tc_x(dev, 33, 2049, aligned, bf16_x, seed=9)
    args = (m_new, m_old, x, density, *flags, precision, absolute_ll)
    K.reset_launch_counts()
    out_k = K.rotated_fused_sums(*args)
    assert K.rotated_fused_sums.launches_by_tier[precision] == 1
    _close(out_k, K.rotated_fused_sums_plain(*args),
           RTOL_BF16 if precision == "bf16" else RTOL)


@pytest.mark.parametrize("case", ["delta bf16x3", "plain bf16, bf16 X"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("t", [1, 15, 2047, 2049, 100_003])
@pytest.mark.parametrize("n", [1, 8, 15, 16, 17, 33, 63, 64])
def test_fused_tc_shapes_match_plain(dev, n, t, aligned, case):
    """The main path's two tensor-core cases at the edges of the 16-row
    tiles, the 64-column sub-tiles and the 2,048-column partials."""
    delta = case == "delta bf16x3"
    x, m_old, m_new = _tc_x(dev, n, t, aligned, not delta, seed=n + t)
    args = (m_new, m_old, x, Tanh(), False, False, "bf16x3" if delta else "bf16", not delta)
    _close(K.rotated_fused_sums(*args), K.rotated_fused_sums_plain(*args),
           RTOL if delta else RTOL_BF16)


@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("t", [1, 15, 2047, 2049, 100_003])
@pytest.mark.parametrize("n", [1, 8, 15, 16, 17, 33, 63, 64])
def test_fused_f32_tier_shapes_match_plain(dev, n, t, aligned, absolute_ll, flags):
    """The f32 tier (six bf16 products on the tensor cores) at the edges of
    the 16-row tiles, the 64-column sub-tiles and the 2,048-column
    partials, with and without H, against exact f32."""
    x, m_old, m_new = _tc_x(dev, n, t, aligned, False, seed=n + t)
    args = (m_new, m_old, x, Tanh(), *flags, "f32", absolute_ll)
    K.reset_launch_counts()
    out_k = K.rotated_fused_sums(*args)
    assert K.rotated_fused_sums.launches_by_tier["f32"] == 1
    _close(out_k, K.rotated_fused_sums_plain(*args))


@pytest.mark.parametrize("need_h", [True, False], ids=["h", "wgmma"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
def test_fused_f32_tier_error_against_f64(dev, absolute_ll, need_h):
    """At the main path's width, 64 x 2,000,000, every output of the f32
    tier (Y^2 on; H on, or off, which in delta mode is the wgmma route of
    the main path's tries) is as close to an f64 evaluation as the
    exact-f32 plain version, within F32_ERR_FACTOR and F32_SCALE_FLOOR."""
    x, m_old, m_new = _inputs(dev, 64, 2_000_000, seed=12)
    args = (m_new, m_old, x, Tanh(), need_h, True, "f32", absolute_ll)
    K.reset_launch_counts()
    out_k = K.rotated_fused_sums(*args)
    wgmma = not absolute_ll and not need_h
    assert K.rotated_fused_sums.launches_by_route["wgmma"]["f32"] == int(wgmma)
    out_p = K.rotated_fused_sums_plain(*args)
    out_64 = K.rotated_fused_sums_plain(m_new.double(), m_old.double(), x.double(), Tanh(),
                                        need_h, True, "f32", absolute_ll)
    for i, (k, p, r) in enumerate(zip(out_k, out_p, out_64)):
        if i == 4 and not need_h:  # H is not computed
            continue
        err_k = float((k.double() - r).abs().max())
        err_p = float((p.double() - r).abs().max())
        bound = F32_ERR_FACTOR * err_p + F32_SCALE_FLOOR * float(r.abs().max())
        assert err_k <= bound, (err_k, err_p, bound)


def _split64(v):
    return tuple(u.double() for u in K._split_bf16(v.float()))


def _x3_64(a_pair, b_pair):
    """hi*hi + lo*hi + hi*lo of split operands, in f64."""
    (a_hi, a_lo), (b_hi, b_lo) = a_pair, b_pair
    return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo


def _drift(out_k, out_p, ref):
    err_k = float((out_k.double() - ref).abs().max())
    err_p = float((out_p.double() - ref).abs().max())
    bound = DRIFT_FACTOR * err_p + DRIFT_FLOOR * float(ref.abs().max())
    print(f"error against f64: kernel {err_k:.4g}, plain {err_p:.4g}, bound {bound:.4g}")
    assert err_k <= bound, (err_k, err_p, bound)


def test_fused_bf16x3_rotation_drift_against_f64(dev):
    """The bf16x3 tier at the main path's width, 64 x 2,000,000: dysq =
    sum (2 Y_old + dY) dY and ysq = sum Y^2 against the same sums in f64
    of the same hi / lo operands (the tensor cores round each MMA's sum
    toward zero, so a chain of MMAs pulls Y_old and dY toward zero, and
    a sum of Y^2 over 2M columns carries it)."""
    x, m_old, m_new = _inputs(dev, 64, 2_000_000, seed=13)
    args = (m_new, m_old, x, Tanh(), False, True, "bf16x3", False)
    K.reset_launch_counts()
    out_k = K.rotated_fused_sums(*args)
    assert K.rotated_fused_sums.launches_by_route["wgmma"]["bf16x3"] == 1
    out_p = K.rotated_fused_sums_plain(*args)
    x_pair = _split64(x)
    y_old = _x3_64(_split64(m_old), x_pair)
    dy = _x3_64(_split64(m_new - m_old), x_pair)
    del x_pair
    dysq = ((2.0 * y_old + dy) * dy).sum(dim=1)
    y_old += dy
    ysq = (y_old * y_old).sum(dim=1)
    del y_old, dy
    _drift(out_k[1], out_p[1], dysq)
    _drift(out_k[5], out_p[5], ysq)


def test_fused_bf16x3_g_drift_against_f64(dev):
    """The bf16x3 contraction at 64 x 2,000,000 (128 16-column steps a
    2,048-column partial): M_old = M_new = I and the cube density, so Y =
    hi(X) + lo(X) exactly in both and the kernel's split operands are bit
    for bit the plain version's; G's error against f64 sums of those
    operands within DRIFT_FACTOR of the plain version's."""
    x, _, _ = _inputs(dev, 64, 2_000_000, seed=14)
    eye = torch.eye(64, device=dev)
    args = (eye, eye, x, Cube(), False, False, "bf16x3", False)
    K.reset_launch_counts()
    g_k = K.rotated_fused_sums(*args)[2]
    assert K.rotated_fused_sums.launches_by_route["wgmma"]["bf16x3"] == 1
    g_p = K.rotated_fused_sums_plain(*args)[2]
    hi, lo = K._split_bf16(x)
    y = hi + lo
    g_64 = _x3_64(_split64(y * y * y), tuple(v.T for v in _split64(y)))
    _drift(g_k, g_p, g_64)


def test_fused_bf16_rotation_drift_against_f64(dev):
    """The plain bf16 tier on bf16 X at the main path's width, 64 x
    2,000,000: ysq = sum Y^2 (and dysq, the same sum in plain mode)
    against the same sum in f64 of the same bf16 operands, bf16(M) and X
    (the tensor cores round each MMA's sum toward zero)."""
    x, _, m_new = _inputs(dev, 64, 2_000_000, seed=15)
    x = x.to(torch.bfloat16)
    args = (m_new, m_new, x, Tanh(), False, True, "bf16", True)
    out_k = K.rotated_fused_sums(*args)
    out_p = K.rotated_fused_sums_plain(*args)
    y = K._bf16(m_new).double() @ x.double()
    ysq = (y * y).sum(dim=1)
    del y
    _drift(out_k[5], out_p[5], ysq)
    _drift(out_k[1], out_p[1], ysq)


def test_fused_bf16_g_drift_against_f64(dev):
    """The plain bf16 contraction at 64 x 2,000,000 (128 16-column steps a
    2,048-column partial): M = I and the cube density on bf16 X, so Y = X
    exactly in both and the operands bf16(Y^3) and Y are bit for bit the
    plain version's; G's error against f64 sums of those operands within
    DRIFT_FACTOR of the plain version's."""
    x, _, _ = _inputs(dev, 64, 2_000_000, seed=16)
    x = x.to(torch.bfloat16)
    eye = torch.eye(64, device=dev)
    args = (eye, eye, x, Cube(), False, False, "bf16", True)
    g_k = K.rotated_fused_sums(*args)[2]
    g_p = K.rotated_fused_sums_plain(*args)[2]
    y = x.float()
    g_64 = K._bf16(y * y * y).double() @ y.double().T
    _drift(g_k, g_p, g_64)


def _core_calls(dev):
    """One call per core wrapper (all outputs on), over several partials;
    the fused wrapper in each tier, and at N = 80 the streaming kernels."""
    x, m_old, m_new = _inputs(dev, 40, 10_001, seed=10)
    xs, ms_old, ms_new = _inputs(dev, 80, 10_001, seed=11)
    d = Tanh()
    return {
        "fused f32": lambda: K.rotated_fused_sums(m_new, m_old, x, d, True, True, "f32"),
        "fused bf16x3": lambda: K.rotated_fused_sums(m_new, m_old, x, d, True, True, "bf16x3"),
        "fused bf16, bf16 X": lambda: K.rotated_fused_sums(
            m_new, m_old, x.to(torch.bfloat16), d, True, True, "bf16", True),
        "moments": lambda: K.rotated_moments_sums(m_old, x, d, True, True),
        "loglik": lambda: K.rotated_loglik_sums(m_old, x, d, True),
        "streaming fused": lambda: K.streaming_fused_sums(ms_new, ms_old, xs, d, True, True),
        "streaming loglik": lambda: K.streaming_loglik_sums(ms_old, xs, d, True),
    }


@pytest.mark.parametrize("call", ["fused f32", "fused bf16x3", "fused bf16, bf16 X", "moments",
                                  "loglik", "streaming fused", "streaming loglik"])
def test_core_wrappers_fold_on_the_card_bitwise(dev, monkeypatch, call):
    """Each core wrapper folds its packed partials in one launch of the fold
    kernel, bit for bit fold_pairwise of the same partials; the outputs
    are the folded row in order."""
    from picard_ica_tpu_torch.ops.moments import fold_pairwise

    seen = []
    fold = K.fold_partials

    def spy(buf):
        seen.append(buf.clone())
        return fold(buf)

    monkeypatch.setattr(K, "fold_partials", spy)
    out = _core_calls(dev)[call]()
    assert len(seen) == 1 and seen[0].shape[0] > 1
    assert torch.equal(torch.cat([v.flatten() for v in out]), fold_pairwise(seen[0]))


def test_fused_launches_by_tier(dev):
    x, m_old, m_new = _inputs(dev, 16, 3000)
    K.reset_launch_counts()
    for precision in ("f32", "bf16x3", "bf16x3", "bf16"):
        K.rotated_fused_sums(m_new, m_old, x, Tanh(), False, False, precision)
    # bf16 X: an f32 request runs (and counts as) the bf16 tier.
    K.rotated_fused_sums(m_new, m_old, x.to(torch.bfloat16), Tanh(), False, False, "f32", True)
    assert K.rotated_fused_sums.launches_by_tier == {"f32": 1, "bf16x3": 2, "bf16": 2}
    assert K.rotated_fused_sums.launches == 5


# Kernels 2 and 3 (the moments and log-lik modes of the tensor-core
# kernel): N short of, at and one past a 16-row tile and the full width;
# T of one column, short of and one past a 2,048-column partial, and the
# main path's length with a ragged tail. The aligned cases round T up to
# a multiple of 8, so that every row is 16-byte aligned on both dtypes.
CORE_NS = [1, 17, 33, 63, 64]
CORE_TS = [1, 2047, 2049, 1_000_003]


@functools.lru_cache(maxsize=2)
def _core_inputs(n, t, seed):
    """Unit-variance Laplace X (n, t) made on the card, and weights near
    the identity whose rows keep unit scale (chip_smoke.py's inputs)."""
    from picard_ica_tpu_torch.utils.datagen import laplace_sources_device

    rng = np.random.default_rng(seed)
    x = laplace_sources_device(n, t, seed, "cuda").mul_(float(1.0 / np.sqrt(2.0)))
    w = np.eye(n) + 0.8 / np.sqrt(n) * rng.standard_normal((n, n))
    return x, torch.from_numpy(w).float().cuda()


def _core_x(n, t, aligned, bf16_x, seed):
    if aligned:
        t += -t % 8
    x, w = _core_inputs(n, t, seed)
    if bf16_x:
        x = x.to(torch.bfloat16)
    assert (t * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0) == aligned
    return x, w


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("t", CORE_TS)
@pytest.mark.parametrize("n", CORE_NS)
def test_moments_matches_plain(dev, n, t, aligned, bf16_x, flags, density):
    """Kernel 2 against the exact-f32 plain version: f32 contractions on
    both dtypes, an f32 (bf16 X: bf16) rotation."""
    x, w = _core_x(n, t, aligned, bf16_x, seed=2)
    args = (w, x, density, *flags)
    before = K.rotated_moments_sums.launches
    out_k = K.rotated_moments_sums(*args)
    assert K.rotated_moments_sums.launches == before + 1
    _close(out_k, K.rotated_moments_sums_plain(*args))


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("need_ysq", [False, True])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("t", CORE_TS)
@pytest.mark.parametrize("n", CORE_NS)
def test_loglik_matches_plain(dev, n, t, aligned, bf16_x, need_ysq, density):
    """Kernel 3 against the exact-f32 plain version, log_lik(0) != 0
    masked at the padded columns."""
    x, w = _core_x(n, t, aligned, bf16_x, seed=3)
    args = (w, x, density, need_ysq)
    before = K.rotated_loglik_sums.launches
    out_k = K.rotated_loglik_sums(*args)
    assert K.rotated_loglik_sums.launches == before + 1
    _close(out_k, K.rotated_loglik_sums_plain(*args))


def _f64_operands(w, x):
    """f64 copies of a core kernel's operands: bf16 X's weights rounded to
    bf16 first, as the kernel and the plain version round them."""
    if x.dtype == torch.bfloat16:
        w = K._bf16(w)
    return w.double(), x.double()


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_moments_drift_against_f64(dev, bf16_x):
    """Kernel 2 at the main path's width, 64 x 2,000,000 (128 16-column
    steps a partial, 2M-column row sums): G, pm and ysq against f64 sums
    of the same operands, within DRIFT_FACTOR of the plain version."""
    x, _, w = _inputs(dev, 64, 2_000_000, seed=17)
    if bf16_x:
        x = x.to(torch.bfloat16)
    args = (w, x, Tanh(), False, True)
    out_k = K.rotated_moments_sums(*args)
    out_p = K.rotated_moments_sums_plain(*args)
    ref = K.rotated_moments_sums_plain(*_f64_operands(w, x), Tanh(), False, True)
    for i in (0, 1, 3):
        _drift(out_k[i], out_p[i], ref[i])


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_loglik_drift_against_f64(dev, bf16_x):
    """Kernel 3 at 64 x 2,000,000: the ll and ysq row sums over 2,048
    columns a partial against f64 sums of the same operands, within
    DRIFT_FACTOR of the plain version."""
    x, _, w = _inputs(dev, 64, 2_000_000, seed=18)
    if bf16_x:
        x = x.to(torch.bfloat16)
    out_k = K.rotated_loglik_sums(w, x, Tanh(), True)
    out_p = K.rotated_loglik_sums_plain(w, x, Tanh(), True)
    ref = K.rotated_loglik_sums_plain(*_f64_operands(w, x), Tanh(), True)
    for k, p, r in zip(out_k, out_p, ref):
        _drift(k, p, r)


# The tensor-core kernel's mode of each wrapper (csrc/rotated_fused_tc.cu
# Mode), as the first template argument of its name.
TC_MODES = {"moments": 2, "loglik": 3}


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("wrapper", list(TC_MODES))
def test_core_wrappers_launch_the_tensor_core_kernel(dev, wrapper, bf16_x):
    """``torch.profiler`` sees the wrapper's call launch the mma.sync
    kernel in its mode (and the fold), and the built library holds no
    scalar resident kernel."""
    from torch.profiler import ProfilerActivity, profile

    from picard_ica_tpu_torch.ops import _build

    x, m_old, _ = _inputs(dev, 40, 10_001, seed=19)
    if bf16_x:
        x = x.to(torch.bfloat16)
    call = (lambda: K.rotated_moments_sums(m_old, x, Tanh(), True, True)) \
        if wrapper == "moments" else (lambda: K.rotated_loglik_sums(m_old, x, Tanh(), True))
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    mode = TC_MODES[wrapper]
    tc = [k for k in names if f"rotated_fused_tc_kernel<{mode}," in k
          or f"rotated_fused_tc_kernelILi{mode}E" in k]
    assert len(tc) == 1, names
    assert not any("rotated_sums_kernel" in k for k in names), names
    lib = _build.library_path()
    assert b"rotated_sums_kernel" not in lib.read_bytes()
    assert not any("rotated_sums_kernel" in k[0]
                   for ks in _build.resource_report().values() for k in ks)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, m_old, m_new = _inputs(dev, 8, 300)
    with pytest.raises(TypeError):
        K.rotated_moments_sums(m_old.double(), x.double(), Tanh(), False, False)
    with pytest.raises(ValueError):
        K.rotated_loglik_sums(m_old, x[:, ::2], Tanh(), False)
    # Above KERNEL_MAX_N the wrappers stream; above STREAM_MAX_N they raise.
    big = torch.zeros((K.STREAM_MAX_N + 1, 300), device=dev)
    eye = torch.eye(K.STREAM_MAX_N + 1, device=dev)
    with pytest.raises(ValueError):
        K.rotated_loglik_sums(eye, big, Tanh(), False)
    with pytest.raises(ValueError):
        K.rotated_fused_sums(eye, eye, big, Tanh(), False, False)


@pytest.mark.parametrize("n", [8, 33, 64])
def test_fit_kernels_match_torch_path(dev, n):
    """End to end on the card: N=8 keeps f32 X in the bf16 tier, N=33
    and N=64 (the kernels' full width) take the bf16 copy; the bf16x3
    and f32 stages' tries take the wgmma route. Both paths converge to
    the same unmixing."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

    _, a, x = generate_mixed_kurtosis_data(n, 60_000, 5)
    K.reset_launch_counts()
    r_k = Picard.fit(x, PicardConfig(random_state=0))
    assert K.rotated_fused_sums.launches > 0 and K.rotated_moments_sums.launches > 0
    by_route = K.rotated_fused_sums.launches_by_route
    assert by_route["wgmma"]["f32"] > 0
    assert by_route["mma.sync"]["f32"] == by_route["mma.sync"]["bf16x3"] == 0
    r_t = Picard.fit(x, PicardConfig(random_state=0, use_kernels=False))
    assert r_k.converged and r_t.converged
    assert r_k.sources.device.type == "cuda" and r_k.sources.shape == (n, 60_000)
    w_k = r_k.full_unmixing().double().cpu().numpy()
    w_t = r_t.full_unmixing().double().cpu().numpy()
    assert amari_distance(w_k, np.linalg.inv(w_t)) < 1e-4
    assert amari_distance(w_k, a) < 5e-3


# ---- device whitening -------------------------------------------------------

# N of the whitening kernels: one output tile, one full tile, and the
# grouped hand-off (N > 512) with a ragged last tile. T is ragged too.
STATS_SHAPES = [(4, 5001), (64, 4097), (513, 2500), (600, 3001)]


def _stats_inputs(dev, n, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.laplace(size=(n, t)) + 1.5
    mean = x.mean(axis=1)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(mean.astype(np.float32)).to(dev))


@pytest.mark.parametrize("n,t", STATS_SHAPES)
def test_row_sums_matches_plain(dev, n, t):
    x, _ = _stats_inputs(dev, n, t)
    before = K.row_sums.launches
    out = K.row_sums(x)
    assert K.row_sums.launches == before + 1
    _close([out], [K.row_sums_plain(x)])


@pytest.mark.parametrize("centered", [False, True], ids=["plain", "centered"])
@pytest.mark.parametrize("n,t", STATS_SHAPES)
def test_covariance_matches_plain(dev, n, t, centered):
    """The covariance wrappers: per-chunk kernels up to N = 512, the
    grouped kernel above."""
    x, mean = _stats_inputs(dev, n, t, seed=1)
    m = mean if centered else None
    grouped = n > K.COV_RESIDENT_MAX_N
    counter = (K._grouped_covariance if grouped else
               K.centered_covariance_sums if centered else K.covariance_sums)
    before = counter.launches
    out = K.centered_covariance_sums(x, mean) if centered else K.covariance_sums(x)
    assert counter.launches == before + 1
    if grouped:
        ref = K.grouped_covariance_plain(x, m)
    elif centered:
        ref = K.centered_covariance_sums_plain(x, mean)
    else:
        ref = K.covariance_sums_plain(x)
    assert torch.equal(out, out.T)
    _close([out], [ref])


@pytest.mark.parametrize("centered", [False, True], ids=["plain", "centered"])
@pytest.mark.parametrize("n", [4, 64, 600])
def test_grouped_covariance_matches_plain(dev, n, centered):
    """Across group boundaries: 70,001 columns are 35 chunks, 3 groups."""
    x, mean = _stats_inputs(dev, n, 70_001, seed=2)
    m = mean if centered else None
    out = K._grouped_covariance(x, m)
    assert torch.equal(out, out.T)
    _close([out], [K.grouped_covariance_plain(x, m)])


def _layout(dev, n, t, layout, seed):
    """X (n, t) in one of the layouts the load paths split on: rows
    16-byte aligned (T % 4 == 0), a row view ``x[1:]`` of odd T, T % 4 != 0
    contiguous, and T % 4 == 0 at a base 4 bytes past alignment."""
    rng = np.random.default_rng(seed)
    if layout == "aligned":
        t -= t % 4
        x = torch.from_numpy(rng.laplace(size=(n, t)).astype(np.float32) + 1.5).to(dev)
    elif layout == "row-view":
        t += 1 - t % 2
        x = torch.from_numpy(rng.laplace(size=(n + 1, t)).astype(np.float32) + 1.5).to(dev)[1:]
    elif layout == "ragged":
        t += 2 - t % 4 if t % 4 in (0, 1) else 0
        x = torch.from_numpy(rng.laplace(size=(n, t)).astype(np.float32) + 1.5).to(dev)
    else:  # offset
        t -= t % 4
        flat = torch.from_numpy(rng.laplace(size=n * t + 1).astype(np.float32) + 1.5).to(dev)
        x = flat[1:].view(n, t)
    # Only the aligned layout takes the 16-byte loads (csrc vec_ok).
    assert x.is_contiguous()
    assert (t % 4 == 0 and x.data_ptr() % 16 == 0) == (layout == "aligned")
    return x, x.double().mean(dim=1).float()


LAYOUTS = ["aligned", "row-view", "ragged", "offset"]
STATS_N = [1, 4, 63, 64, 65, 130, 600]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", STATS_N)
def test_row_sums_load_paths(dev, n, layout):
    """Both load paths at the N and T edges: 2 full chunks and a tail."""
    x, _ = _layout(dev, n, 5000, layout, seed=n)
    before = K.row_sums.launches
    out = K.row_sums(x)
    assert K.row_sums.launches == before + 1 and out.shape == (n,)
    _close([out], [K.row_sums_plain(x)])


@pytest.mark.parametrize("group", [1, K.COV_GROUP], ids=["per-chunk", "grouped"])
@pytest.mark.parametrize("centered", [False, True], ids=["plain", "centered"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", STATS_N)
def test_covariance_kernel_load_paths(dev, n, layout, centered, group):
    """The covariance kernel (diagonal tiles alone up to N = 64, with the
    off-diagonal pairs above) per chunk and grouped, on both load paths,
    against the plain version of the same partition; symmetric bit for
    bit."""
    x, mean = _layout(dev, n, 5000, layout, seed=100 + n)
    m = mean if centered else None
    out = K._covariance_launch(x, m, group)
    if group == 1:
        ref = (K.centered_covariance_sums_plain(x, mean) if centered
               else K.covariance_sums_plain(x))
    else:
        ref = K.grouped_covariance_plain(x, m)
    assert out.shape == (n, n) and torch.equal(out, out.T)
    _close([out], [ref])


@pytest.mark.parametrize("shape", [(64,), (64, 64), (7, 5), (600, 600)], ids=str)
@pytest.mark.parametrize("n_parts", [1, 2, 3, 5, 7, 31, 1954])
def test_fold_kernel_bitwise_equals_fold_pairwise(dev, n_parts, shape):
    from picard_ica_tpu_torch.ops.moments import fold_pairwise

    if n_parts * math.prod(shape) > 2e7:
        n_parts = 33
    g = torch.Generator(device=dev).manual_seed(n_parts)
    parts = torch.randn((n_parts, *shape), generator=g, device=dev) * 1e3
    want = fold_pairwise(parts.clone())
    got = K.fold_partials(parts.clone())
    assert got.shape == want.shape and torch.equal(got, want)


def test_whitening_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, mean = _stats_inputs(dev, 8, 3000)
    with pytest.raises(TypeError):
        K.row_sums(x.double())
    with pytest.raises(TypeError):
        K.covariance_sums(x.double())
    with pytest.raises(ValueError):
        K.row_sums(x[:, ::2])
    with pytest.raises(ValueError):
        K.centered_covariance_sums(x[:, ::2], mean)
    with pytest.raises(ValueError):
        K.centered_covariance_sums(x, mean[:4])
    with pytest.raises(ValueError):
        K._grouped_covariance(x, mean[:, None])
    with pytest.raises(ValueError):
        K.fold_partials(torch.zeros((3, 4), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        K.fold_partials(torch.zeros((3, 4), device=dev)[:, ::2])


def test_fit_cuda_tensor_through_device_whitening(dev):
    """An f32 tensor on the card: whitened by the kernels, fitted, the
    caller's tensor untouched, and the same unmixing as the CPU fit of
    the same data."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

    _, a, x = generate_mixed_kurtosis_data(8, 60_000, 5)
    x32 = torch.from_numpy(x.astype(np.float32))
    x_dev = x32.to(dev)
    before = x_dev.clone()
    K.reset_launch_counts()
    r_g = Picard.fit(x_dev, PicardConfig(random_state=0))
    for k in (K.row_sums, K.centered_covariance_sums, K.covariance_sums,
              K.rotated_fused_sums, K.rotated_moments_sums):
        assert k.launches > 0, k.__name__
    assert torch.equal(x_dev, before)
    r_c = Picard.fit(x32, PicardConfig(random_state=0), device="cpu")
    assert r_g.converged and r_c.converged
    assert r_g.sources.device.type == "cuda" and r_c.sources.device.type == "cpu"
    w_g = r_g.full_unmixing().double().cpu().numpy()
    w_c = r_c.full_unmixing().double().numpy()
    assert amari_distance(w_g, np.linalg.inv(w_c)) < 1e-4
    assert amari_distance(w_g, a) < 5e-3


def test_cpu_tensor_without_device_fits_on_the_card(dev):
    """A CPU tensor without ``device=`` is copied to the card and fitted
    there through the kernels; the caller's tensor is unchanged."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.utils import generate_mixed_kurtosis_data

    _, _, x = generate_mixed_kurtosis_data(8, 60_000, 5)
    x32 = torch.from_numpy(x.astype(np.float32))
    before = x32.clone()
    K.reset_launch_counts()
    r = Picard.fit(x32, PicardConfig(random_state=0))
    assert r.converged and r.sources.device.type == "cuda"
    assert K.row_sums.launches == 1 and K.rotated_fused_sums.launches > 0
    assert x32.device.type == "cpu" and torch.equal(x32, before)


# ---- the core loop above KERNEL_MAX_N: the streaming kernels ----------------

# One and two 64-row contraction blocks, the three tile widths (128, 64,
# 32 columns), N not a multiple of 64, and ragged T. 1,500 columns at
# N = 1024 are 47 tiles in 3 partials.
STREAM_SHAPES = [(65, 2049), (130, 5001), (306, 3001), (1024, 1500)]


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
@pytest.mark.parametrize("n,t", STREAM_SHAPES)
def test_streaming_fused_matches_plain(dev, n, t, density, precision, absolute_ll, flags):
    x, m_old, m_new = _inputs(dev, n, t, seed=4)
    args = (m_new, m_old, x, density, *flags, precision, absolute_ll)
    before = K.streaming_fused_sums.launches
    out_k = K.streaming_fused_sums(*args)
    assert K.streaming_fused_sums.launches == before + 1
    _close(out_k, K.streaming_fused_sums_plain(*args),
           RTOL_BF16 if precision == "bf16" else RTOL)


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("n,t", [(130, 4097), (306, 3001)])
def test_streaming_fused_bf16_x_matches_plain(dev, n, t, precision, absolute_ll):
    x, m_old, m_new = _inputs(dev, n, t, seed=5)
    args = (m_new, m_old, x.to(torch.bfloat16), Tanh(), True, True,
            precision, absolute_ll)
    # bf16 X: an f32 request runs the bf16 tier.
    _close(K.streaming_fused_sums(*args), K.streaming_fused_sums_plain(*args),
           RTOL if precision == "bf16x3" else RTOL_BF16)


@pytest.mark.parametrize("group", [2, 16])
@pytest.mark.parametrize("n", [72, 1024])
def test_streaming_fused_across_group_boundaries(dev, monkeypatch, n, group):
    """70,001 columns: 547 tiles of 128 at N = 72 in groups of ``group``
    tiles; 2,188 tiles of 32 at N = 1024, where the G and H partials
    budget (STREAM_PARTIALS_MAX) sets groups of 18. Plain mode at bf16x3,
    which the scalar kernel serves; plain and delta f32 run the
    tensor-core route, whose groups are stream_tc_plan's."""
    monkeypatch.setattr(K, "STREAM_GROUP", group)
    x, m_old, m_new = _inputs(dev, n, 70_001, seed=6)
    args = (m_new, m_old, x, Tanh(), True, True, "bf16x3", True)
    _close(K.streaming_fused_sums(*args), K.streaming_fused_sums_plain(*args))


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("need_ysq", [False, True])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("n,t", [(65, 255), (306, 3001), (1024, 40_001)])
def test_streaming_loglik_matches_plain(dev, n, t, density, need_ysq, bf16_x):
    x, m_old, _ = _inputs(dev, n, t, seed=7)
    if bf16_x:
        x = x.to(torch.bfloat16)
    args = (m_old, x, density, need_ysq)
    before = K.streaming_loglik_sums.launches
    out_k = K.streaming_loglik_sums(*args)
    assert K.streaming_loglik_sums.launches == before + 1
    _close(out_k, K.streaming_loglik_sums_plain(*args))


def test_resident_wrappers_hand_off_above_kernel_max_n(dev):
    """At N = 80 the rotated_* wrappers launch the streaming kernels and
    count there; the moments are the fused kernel's plain mode."""
    x, m_old, m_new = _inputs(dev, 80, 3001, seed=8)
    K.reset_launch_counts()
    out = K.rotated_fused_sums(m_new, m_old, x, Tanh(), True, True)
    _close(out, K.streaming_fused_sums_plain(m_new, m_old, x, Tanh(), True, True))
    mom = K.rotated_moments_sums(m_old, x, Tanh(), True, True)
    _close(mom, K.rotated_moments_sums_plain(m_old, x, Tanh(), True, True))
    ll = K.rotated_loglik_sums(m_old, x, Tanh(), True)
    _close(ll, K.rotated_loglik_sums_plain(m_old, x, Tanh(), True))
    assert K.streaming_fused_sums.launches == 2 and K.streaming_loglik_sums.launches == 1
    assert (K.rotated_fused_sums.launches, K.rotated_moments_sums.launches,
            K.rotated_loglik_sums.launches) == (0, 0, 0)


def test_fit_streaming_kernels_match_cpu(dev):
    """N = 80 with use_kernels=True: the card's fit runs the streaming
    kernels and lands on the CPU fit's unmixing (plain versions)."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

    _, a, x = generate_mixed_kurtosis_data(80, 60_000, 5)
    cfg = PicardConfig(random_state=0, use_kernels=True)
    K.reset_launch_counts()
    r_g = Picard.fit(x, cfg)
    assert K.streaming_fused_sums.launches > 0
    assert K.rotated_fused_sums.launches == 0 and K.rotated_moments_sums.launches == 0
    r_c = Picard.fit(x, cfg, device="cpu")
    assert r_g.converged and r_c.converged
    w_g = r_g.full_unmixing().double().cpu().numpy()
    w_c = r_c.full_unmixing().double().numpy()
    assert amari_distance(w_g, np.linalg.inv(w_c)) < 1e-4
    assert amari_distance(w_g, a) < 5e-3
