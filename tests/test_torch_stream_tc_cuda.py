"""The tensor-core route of streaming_fused_sums and streaming_loglik_sums
against their plain versions.

The route (``csrc/streaming_fused_tc.cu``) serves, at 64 < N <=
STREAM_MAX_N, every (mode, tier, X dtype) pair of streaming_fused_sums:
a rotation-and-density launch into a workspace of psi / Y planes, then a
contraction launch; and the loglik kernel, the rotation launch alone with
a log-lik epilogue, on bf16 X and on f32 X. Needs an NVIDIA GPU (Hopper,
sm_90a): every test here is marked ``cuda`` and skips without one.
Imports no JAX:

    python -m pytest --noconftest tests/test_torch_stream_tc_cuda.py -q

Tolerances of a bf16 contraction: RTOL_BF16 of each output's largest
entry, as kernel 1's bf16 tier (tests/test_torch_cuda.py): psi, Y (psi',
Y^2) are rounded to bf16 after a rotation whose f32 sums are ordered
differently, so a few roundings flip by 2^-8. Where T is a few columns,
one term is a large share of an entry of G or H, and one flipped rounding
of it can pass that (at 1344 x 31 a flip of one Y^2 near 100 moved H by
0.133 against 0.116 = 1e-3 of its largest entry): the shape tests add to
G and H the largest move one flip in each operand can make, 2^-7 of the
largest |psi| |Y| (|psi'| |Y^2|). G's drift against f64 sums of the same
bf16 operands may be DRIFT_FACTOR times the plain version's, plus
DRIFT_FLOOR of G's largest entry; so may delta bf16's rotation sums (dysq
and ysq) on f32 X.

A bf16x3 contraction (delta bf16x3 on f32 X, and the bf16x3 pairs of the
other direct calls): RTOL_X3 = 2e-5 of each output's largest entry,
the bf16x3 rule of tests/test_torch_streaming.py (the hi / lo splits keep
~16 bits, so a flipped rounding of a lo part moves a term by at most
2^-17 of each operand). The drift of its rotation (dysq and ysq against
f64 sums of the same split operands) and of its contraction (G, with
operands equal bit for bit to the plain version's) may be DRIFT_FACTOR
times the plain version's, plus DRIFT_FLOOR of the output's largest
entry.

Delta f32 and plain f32 on f32 X (six bf16 products of three-way
splits): RTOL_F32 = 2e-5 of each output's largest entry against the
exact-f32 plain version, the f32 rule of tests/test_torch_streaming.py.
Their drift (dysq and ysq, and G) is held against f64 sums of the f32
operands themselves, within DRIFT_FACTOR of the plain version's error
plus DRIFT_FLOOR of the output's largest entry.

The loglik kernel (the wgmma launches' log-lik modes): RTOL_F32 at both
tiers (it rounds nothing to bf16 after its rotation, so only the order of
the f32 sums differs); at both tiers its ll and ysq drift against f64
sums of its operands under the same DRIFT_FACTOR rule (ll is the loss
baseline the line search compares against).

Launch B alone (``K.stream_contract_sums``) over a workspace of the same
values as its plain version's: each group's partials within RTOL_F32 of
the group's largest entry at f32 (six bf16 products against exact f32),
and RTOL_X3 at bf16x3 and bf16 (the same bf16 operands, only the order of
the f32 sums differs).
"""

import numpy as np
import pytest
import torch

from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.ops.densities import Cube, Exp, Tanh

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

RTOL_BF16 = 1e-3
RTOL_X3 = 2e-5
RTOL_F32 = 2e-5
DRIFT_FACTOR = 2.0
DRIFT_FLOOR = 1e-7
DENSITIES = [Tanh(), Exp(0.5), Cube()]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, t, seed, dtype=torch.bfloat16):
    """Unit-variance Laplace X (in bf16 unless asked otherwise) and
    weights near the identity whose rows keep unit scale at any N."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.laplace(size=(n, t)) / np.sqrt(2.0)).astype(np.float32))
    s = 0.8 / np.sqrt(n)
    m_old = np.eye(n) + s * rng.standard_normal((n, n))
    m_new = m_old + 0.1 * s * rng.standard_normal((n, n))
    return (x.to(dev).to(dtype), torch.from_numpy(m_old).float().to(dev),
            torch.from_numpy(m_new).float().to(dev))


def _close(out_k, out_p, rtol=RTOL_BF16, flips=(0.0,) * 6):
    for a, b, flip in zip(out_k, out_p, flips):
        assert a.dtype == torch.float32 and a.device.type == "cuda"
        assert bool(torch.isfinite(a).all())
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        assert err <= rtol * scale + flip, (err, scale, flip)


def _flips(m_new, x, density):
    """Per output, the largest move of one flipped bf16 rounding in each
    operand of a G or H term (zero for the row sums, which round nothing
    to bf16)."""
    y = K._kernel_dot(K._bf16(m_new), x.float(), torch.float32, "bf16")
    psi, psid = density.score_and_der(y)

    def flip(u, v):
        return 2.0**-7 * float(u.abs().max()) * float(v.abs().max())

    return 0.0, 0.0, flip(psi, y), 0.0, flip(psid, y * y), 0.0


def _run_tc(args):
    K.reset_launch_counts()
    out = K.streaming_fused_sums(*args)
    assert K.streaming_fused_sums.launches == 1
    tier = K._tiers(args[2], args[6])[0]
    assert K.streaming_fused_sums.launches_by_tier[tier] == 1
    mode = "plain" if args[7] else "delta"
    assert K.streaming_fused_sums.launches_by_mode[mode][tier] == 1
    return out


@pytest.mark.parametrize("t", [1, 31, 129, 2049])
@pytest.mark.parametrize("n", [65, 127, 128, 129, 257, 704, 705, 1024, 1344])
def test_stream_tc_shapes_match_plain(dev, n, t):
    """At the edges of the 128-row blocks, the tiles and the 64-deep k
    stages, H and Y^2 on."""
    x, m_old, m_new = _inputs(dev, n, t, seed=n + t)
    args = (m_new, m_old, x, Tanh(), True, True, "bf16", True)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args),
           flips=_flips(m_new, x, Tanh()))


@pytest.mark.parametrize("n", [65, 257, 1024])
def test_stream_tc_unaligned_rows_match_plain(dev, n):
    """1,000,003 columns: bf16 rows that are not 16-byte aligned take the
    plain loads; 245 groups of 4,096 columns."""
    x, m_old, m_new = _inputs(dev, n, 1_000_003, seed=n)
    assert (x.shape[1] * 2) % 16 != 0
    args = (m_new, m_old, x, Tanh(), False, True, "bf16", True)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args))


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_stream_tc_flags_and_densities_match_plain(dev, need_h, need_ysq, density):
    x, m_old, m_new = _inputs(dev, 200, 10_007, seed=3)
    args = (m_new, m_old, x, density, need_h, need_ysq, "f32", True)
    out = _run_tc(args)
    _close(out, K.streaming_fused_sums_plain(*args))
    if not need_h:
        assert not out[4].any()
    if not need_ysq:
        assert not out[1].any() and not out[5].any()


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_stream_tc_chunks_match_plain(dev, monkeypatch, need_h):
    """A workspace cap of two groups: 20,001 columns in 20 groups of 1,024
    run as 10 chunks of both launches."""
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 1024)
    n, t = 257, 20_001
    col_bytes = 2 * (1 + need_h) * 384 * 2
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 1024 * col_bytes)
    plan = K.stream_tc_plan(n, t, need_h)
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (1024, 20, 2)
    x, m_old, m_new = _inputs(dev, n, t, seed=4)
    args = (m_new, m_old, x, Tanh(), need_h, True, "bf16", True)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args))


@pytest.mark.parametrize("t", [4096, 8200])
@pytest.mark.parametrize("n", [65, 128, 257, 384, 385, 1344])
def test_stream_tc_aligned_shapes_match_plain(dev, n, t):
    """Rows of whole 16-byte pieces (T % 8 == 0), which launch A copies by
    tensor map: W resident in shared memory up to N = 384 and streamed
    beside X above it, a last group cut short at 8,200 columns; H and Y^2
    on."""
    x, m_old, m_new = _inputs(dev, n, t, seed=n + t + 1)
    assert (t * 2) % 16 == 0 and x.data_ptr() % 16 == 0
    args = (m_new, m_old, x, Tanh(), True, True, "bf16", True)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args),
           flips=_flips(m_new, x, Tanh()))


def test_stream_tc_unaligned_base_matches_plain(dev):
    """X starting one element past a 16-byte boundary (a storage offset of
    one element): rows of a whole number of 16-byte pieces whose base no
    tensor map can take, so launch A loads X with plain loads."""
    n, t = 257, 3 * 4096
    x, m_old, m_new = _inputs(dev, n, t, seed=12)
    buf = torch.empty(n * t + 1, dtype=x.dtype, device=dev)
    xu = buf[1:].view(n, t)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0 and (t * 2) % 16 == 0
    for flags in (False, True):
        args = (m_new, m_old, xu, Tanh(), flags, flags, "bf16", True)
        _close(_run_tc(args), K.streaming_fused_sums_plain(*args),
               flips=_flips(m_new, xu, Tanh()))


def test_stream_tc_rotation_drift_against_f64(dev):
    """Plain bf16 on bf16 X at 1344 x 200,000, K 1344 deep: ysq = sum Y^2
    and dll = sum log_lik(Y) against the same sums in f64 of Y = bf16(M)
    bf16(X) in f64, within DRIFT_FACTOR of the plain version's error plus
    DRIFT_FLOOR of the output's largest entry (the tensor cores round a
    chain of products toward zero, which a 1,344-deep rotation would
    show)."""
    n, t = 1344, 200_000
    x, m_old, m_new = _inputs(dev, n, t, seed=13)
    args = (m_new, m_old, x, Tanh(), False, True, "bf16", True)
    out_k = _run_tc(args)
    out_p = K.streaming_fused_sums_plain(*args)
    y = K._bf16(m_new).double() @ x.double()
    ysq = (y * y).sum(dim=1)
    _, _, ll = Tanh().score_der_loglik(y)
    del y
    dll = ll.sum(dim=1)
    del ll
    _drift(out_k[5], out_p[5], ysq)
    _drift(out_k[0], out_p[0], dll)


def test_moments_hand_off_takes_the_tc_route(dev):
    """rotated_moments_sums on bf16 X above N = 64 is the fused plain mode
    at the bf16 tier: the tensor-core route."""
    x, m_old, _ = _inputs(dev, 130, 5000, seed=5)
    K.reset_launch_counts()
    out = K.rotated_moments_sums(m_old, x, Tanh(), True, True)
    assert K.streaming_fused_sums.launches_by_mode["plain"]["bf16"] == 1
    _close(out, K.rotated_moments_sums_plain(m_old, x, Tanh(), True, True))


# The six pairs no default fit takes but a kernel_precision="bf16" fit's
# tries (delta bf16 on f32 X): (label, precision, absolute_ll, bf16 X).
OTHER_PAIRS = [
    ("delta bf16, bf16 X", "bf16", False, True),
    ("delta bf16x3, bf16 X", "bf16x3", False, True),
    ("plain bf16x3, bf16 X", "bf16x3", True, True),
    ("delta bf16, f32 X", "bf16", False, False),
    ("plain bf16, f32 X", "bf16", True, False),
    ("plain bf16x3", "bf16x3", True, False),
]


def _pair_args(dev, n, t, seed, precision, absolute_ll, bf16_x, flags=True):
    x, m_old, m_new = _inputs(dev, n, t, seed, torch.bfloat16 if bf16_x else torch.float32)
    return (m_new, m_old, x, Tanh(), flags, flags, precision, absolute_ll)


def _pair_flips(args):
    """A bf16 contraction's flip allowance (_flips, Y ~ M_new X in either
    mode); none at bf16x3."""
    m_new, _, x, density, _, _, precision, _ = args
    return _flips(m_new, x, density) if precision == "bf16" else (0.0,) * 6


@pytest.mark.parametrize("label,precision,absolute_ll,bf16_x", OTHER_PAIRS,
                         ids=[r[0] for r in OTHER_PAIRS])
def test_other_pairs_take_the_tc_route(dev, label, precision, absolute_ll, bf16_x):
    """Each of the six pairs launches the tensor-core route (counted by
    mode and contraction tier) and matches its plain version."""
    args = _pair_args(dev, 130, 3001, 6, precision, absolute_ll, bf16_x)
    out = _run_tc(args)
    _close(out, K.streaming_fused_sums_plain(*args),
           RTOL_BF16 if precision == "bf16" else RTOL_X3, _pair_flips(args))


@pytest.mark.parametrize("flags", [False, True], ids=["min", "h+ysq"])
@pytest.mark.parametrize("t", [1, 2047, 1_000_003])
@pytest.mark.parametrize("n", [65, 130, 257, 705])
@pytest.mark.parametrize("label,precision,absolute_ll,bf16_x", OTHER_PAIRS,
                         ids=[r[0] for r in OTHER_PAIRS])
def test_other_pairs_ragged_shapes_match_plain(dev, label, precision, absolute_ll, bf16_x, n,
                                               t, flags):
    """The six pairs at the edges of the 128-row blocks and the 32-deep k
    stages, ragged T (rows not 16-byte aligned: plain bf16 loads, 4-byte
    f32 copies), with and without H and the Y^2 sums."""
    args = _pair_args(dev, n, t, n + t + 40, precision, absolute_ll, bf16_x, flags)
    out = _run_tc(args)
    _close(out, K.streaming_fused_sums_plain(*args),
           RTOL_BF16 if precision == "bf16" else RTOL_X3, _pair_flips(args))
    if not flags:
        assert not out[4].any() and not out[1].any() and not out[5].any()
    elif absolute_ll:
        assert torch.equal(out[1], out[5])  # plain mode: dysq = ysq = sum Y^2


def test_delta_bf16_rotation_drift_against_f64(dev):
    """Delta bf16 on f32 X (a kernel_precision="bf16" fit's tries) at
    256 x 2,000,000: dysq = sum (2 Y_old + dY) dY and ysq = sum Y^2
    against the same sums in f64 of the same bf16 operands (bf16(M_old),
    bf16(dM), bf16(X)), within DRIFT_FACTOR of the plain version's error
    plus DRIFT_FLOOR of the output's largest entry."""
    args = _pair_args(dev, 256, 2_000_000, 41, "bf16", False, False, flags=False)
    args = args[:5] + (True,) + args[6:]
    m_new, m_old, x = args[:3]
    out_k = _run_tc(args)
    out_p = K.streaming_fused_sums_plain(*args)
    x64 = K._bf16(x).double()
    y_old = K._bf16(m_old).double() @ x64
    dy = K._bf16(m_new - m_old).double() @ x64
    del x64
    dysq = ((2.0 * y_old + dy) * dy).sum(dim=1)
    y_old += dy
    ysq = (y_old * y_old).sum(dim=1)
    del y_old, dy
    _drift(out_k[1], out_p[1], dysq)
    _drift(out_k[5], out_p[5], ysq)


def test_library_holds_no_scalar_streaming_kernel(dev):
    """The built library holds no scalar ``streaming_kernel`` (neither in
    ptxas's report nor among its bytes) and no ``streaming_sums.cu``, and
    in one torch.profiler session over the six direct-call pairs only the
    route's kernels (launch B: ``contract_wgmma_kernel``) and the fold
    run."""
    from torch.profiler import ProfilerActivity, profile

    from picard_ica_tpu_torch.ops import _build

    K._lib()
    report = _build.resource_report()
    assert "streaming_sums.cu" not in report
    assert not any("streaming_kernel" in k[0] for ks in report.values() for k in ks)
    assert b"streaming_kernel" not in _build.library_path().read_bytes()
    calls = [_pair_args(dev, 130, 3001, 42, precision, absolute_ll, bf16_x)
             for _, precision, absolute_ll, bf16_x in OTHER_PAIRS]
    for args in calls:
        K.streaming_fused_sums(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in calls:
            K.streaming_fused_sums(*args)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_time_total > 0}
    assert any("rotate_split_kernel" in k for k in names), names
    assert any("contract_wgmma_kernel" in k for k in names), names
    assert not any("streaming_kernel" in k for k in names), names


def test_stream_tc_g_drift_against_f64(dev):
    """The contraction's sums at 1024 x 200,000: W = I and the cube
    density, so the kernel's bf16 operands are bit for bit the plain
    version's, bf16(Y^3) and bf16(Y) with Y = X; G's error against f64
    sums of those operands within DRIFT_FACTOR of the plain version's."""
    n, t = 1024, 200_000
    x, _, _ = _inputs(dev, n, t, seed=7)
    eye = torch.eye(n, device=dev)
    args = (eye, eye, x, Cube(), False, False, "bf16", True)
    g_k = _run_tc(args)[2]
    g_p = K.streaming_fused_sums_plain(*args)[2]
    y = x.float()
    psi = (y * y * y).to(torch.bfloat16)
    g_64 = psi.double() @ x.double().T
    err_k = float((g_k.double() - g_64).abs().max())
    err_p = float((g_p.double() - g_64).abs().max())
    bound = DRIFT_FACTOR * err_p + DRIFT_FLOOR * float(g_64.abs().max())
    assert err_k <= bound, (err_k, err_p, bound)


# ---------------------------------------------------------------------------
# Delta mode at the bf16x3 tier on f32 X.
# ---------------------------------------------------------------------------


def _x3_args(dev, n, t, seed, density=Tanh(), need_h=True, need_ysq=True):
    x, m_old, m_new = _inputs(dev, n, t, seed, torch.float32)
    return (m_new, m_old, x, density, need_h, need_ysq, "bf16x3", False)


@pytest.mark.parametrize("t", [1, 31, 4100, 20_001])
@pytest.mark.parametrize("n", [65, 130, 257, 1344])
def test_stream_tc_x3_shapes_match_plain(dev, n, t):
    """Delta bf16x3 at the edges of the 128-row blocks and the 32-deep k
    stages, ragged T (T % 8 != 0; 4-byte copies where T % 4 != 0), H and
    the Y^2 sums on."""
    args = _x3_args(dev, n, t, seed=n + t)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args), RTOL_X3)


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_stream_tc_x3_flags_and_densities_match_plain(dev, need_h, need_ysq, density):
    """Ragged N and T (T % 8 == 4: 16-byte copies of f32 rows)."""
    args = _x3_args(dev, 257, 10_004, 8, density, need_h, need_ysq)
    out = _run_tc(args)
    _close(out, K.streaming_fused_sums_plain(*args), RTOL_X3)
    if not need_h:
        assert not out[4].any()
    if not need_ysq:
        assert not out[1].any() and not out[5].any()


@pytest.mark.parametrize("n", [257, 1024])
def test_stream_tc_x3_unaligned_rows_match_plain(dev, n):
    """1,000,003 columns: f32 rows that are not 16-byte aligned take the
    4-byte copies; 245 groups of 4,096 columns."""
    args = _x3_args(dev, n, 1_000_003, n, need_h=False)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args), RTOL_X3)


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_stream_tc_x3_chunks_match_plain(dev, monkeypatch, need_h):
    """A workspace cap of two groups of hi / lo planes: 20,001 columns in
    20 groups of 1,024 run as 10 chunks of both launches."""
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 1024)
    n, t = 257, 20_001
    col_bytes = 2 * (1 + need_h) * 2 * 384 * 2
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 1024 * col_bytes)
    plan = K.stream_tc_plan(n, t, need_h, "bf16x3")
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (1024, 20, 2)
    args = _x3_args(dev, n, t, 9, need_h=need_h)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args), RTOL_X3)


def test_rotated_hand_off_takes_the_x3_route(dev):
    """rotated_fused_sums above N = 64, delta bf16x3 on f32 X (the staged
    schedule's second stage): the tensor-core route at bf16x3."""
    x, m_old, m_new = _inputs(dev, 130, 5000, 10, torch.float32)
    args = (m_new, m_old, x, Tanh(), False, True, "bf16x3", False)
    K.reset_launch_counts()
    out = K.rotated_fused_sums(*args)
    assert K.streaming_fused_sums.launches_by_tier["bf16x3"] == 1
    _close(out, K.rotated_fused_sums_plain(*args), RTOL_X3)


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


def test_stream_tc_x3_rotation_drift_against_f64(dev):
    """The rotation's sums at 1024 x 200,000, K 1024 deep: dysq = sum (2
    Y_old + dY) dY and ysq = sum Y^2 against the same sums in f64 of the
    same split operands (the tensor cores round toward zero, so a long
    chain of MMAs would pull Y_old and dY toward zero)."""
    n, t = 1024, 200_000
    args = _x3_args(dev, n, t, 11, need_h=False)
    m_new, m_old, x = args[:3]
    out_k = _run_tc(args)
    out_p = K.streaming_fused_sums_plain(*args)
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


def test_stream_tc_x3_g_drift_against_f64(dev):
    """The contraction's sums at 1024 x 200,000: M_old = M_new = I and the
    cube density, so Y = hi(X) + lo(X) exactly in both and the kernel's
    split operands are bit for bit the plain version's; G's error against
    f64 sums of those operands within DRIFT_FACTOR of the plain
    version's."""
    n, t = 1024, 200_000
    x, _, _ = _inputs(dev, n, t, 12, torch.float32)
    eye = torch.eye(n, device=dev)
    args = (eye, eye, x, Cube(), False, False, "bf16x3", False)
    g_k = _run_tc(args)[2]
    g_p = K.streaming_fused_sums_plain(*args)[2]
    hi, lo = K._split_bf16(x)
    y = hi + lo
    g_64 = _x3_64(_split64(y * y * y), tuple(v.T for v in _split64(y)))
    _drift(g_k, g_p, g_64)


# ---------------------------------------------------------------------------
# Delta mode at the f32 tier on f32 X.
# ---------------------------------------------------------------------------


def _f32_args(dev, n, t, seed, density=Tanh(), need_h=True, need_ysq=True):
    x, m_old, m_new = _inputs(dev, n, t, seed, torch.float32)
    return (m_new, m_old, x, density, need_h, need_ysq, "f32", False)


@pytest.mark.parametrize("t", [1, 31, 4100, 20_001])
@pytest.mark.parametrize("n", [65, 130, 257, 1024, 1344])
def test_stream_tc_f32_shapes_match_plain(dev, n, t):
    """Delta f32 at the edges of the 128-row blocks and the 16-deep k
    stages, ragged T (T % 8 != 0; 4-byte copies where T % 4 != 0), H and
    the Y^2 sums on."""
    args = _f32_args(dev, n, t, seed=n + t)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args), RTOL_F32)


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_stream_tc_f32_flags_and_densities_match_plain(dev, need_h, need_ysq, density):
    """Ragged N and T (T % 8 == 4: 16-byte copies of f32 rows)."""
    args = _f32_args(dev, 257, 10_004, 13, density, need_h, need_ysq)
    out = _run_tc(args)
    _close(out, K.streaming_fused_sums_plain(*args), RTOL_F32)
    if not need_h:
        assert not out[4].any()
    if not need_ysq:
        assert not out[1].any() and not out[5].any()


@pytest.mark.parametrize("n", [257, 1024])
def test_stream_tc_f32_unaligned_rows_match_plain(dev, n):
    """1,000,003 columns: f32 rows that are not 16-byte aligned take the
    4-byte copies; 245 groups of 4,096 columns."""
    args = _f32_args(dev, n, 1_000_003, n + 1, need_h=False)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args), RTOL_F32)


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_stream_tc_f32_chunks_match_plain(dev, monkeypatch, need_h):
    """A workspace cap of two groups of f32 planes: 20,001 columns in 20
    groups of 1,024 run as 10 chunks of both launches."""
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 1024)
    n, t = 257, 20_001
    col_bytes = 2 * (1 + need_h) * 384 * 4
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 1024 * col_bytes)
    plan = K.stream_tc_plan(n, t, need_h, "f32")
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (1024, 20, 2)
    args = _f32_args(dev, n, t, 14, need_h=need_h)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args), RTOL_F32)


def test_rotated_hand_off_takes_the_f32_route(dev):
    """rotated_fused_sums above N = 64, delta f32 on f32 X (the staged
    schedule's last stage, and every pass of an f32-only fit): the
    tensor-core route at f32. So does the moments hand-off (plain f32)."""
    x, m_old, m_new = _inputs(dev, 130, 5000, 15, torch.float32)
    args = (m_new, m_old, x, Tanh(), False, True, "f32", False)
    K.reset_launch_counts()
    out = K.rotated_fused_sums(*args)
    assert K.streaming_fused_sums.launches_by_tier["f32"] == 1
    _close(out, K.rotated_fused_sums_plain(*args), RTOL_F32)
    K.reset_launch_counts()
    mom = K.rotated_moments_sums(m_old, x, Tanh(), False, True)
    assert K.streaming_fused_sums.launches_by_tier["f32"] == 1
    _close(mom, K.rotated_moments_sums_plain(m_old, x, Tanh(), False, True), RTOL_F32)


def test_stream_tc_f32_rotation_drift_against_f64(dev):
    """The rotation's sums at 1024 x 200,000, K 1024 deep: dysq = sum (2
    Y_old + dY) dY and ysq = sum Y^2 against the same sums in f64 of the
    f32 operands (M_old, the f32 dM = M_new - M_old and X), within
    DRIFT_FACTOR of the exact-f32 plain version's error."""
    n, t = 1024, 200_000
    args = _f32_args(dev, n, t, 16, need_h=False)
    m_new, m_old, x = args[:3]
    out_k = _run_tc(args)
    out_p = K.streaming_fused_sums_plain(*args)
    x64 = x.double()
    y_old = m_old.double() @ x64
    dy = (m_new - m_old).double() @ x64
    del x64
    dysq = ((2.0 * y_old + dy) * dy).sum(dim=1)
    y_old += dy
    ysq = (y_old * y_old).sum(dim=1)
    del y_old, dy
    _drift(out_k[1], out_p[1], dysq)
    _drift(out_k[5], out_p[5], ysq)


def test_stream_tc_f32_g_drift_against_f64(dev):
    """The contraction's sums at 1024 x 200,000: M_old = M_new = I and the
    cube density, so Y = X exactly in both (hi(I) = 1, mid = lo = 0) and
    psi = X^3 in f32; G's error against f64 sums of those f32 operands
    within DRIFT_FACTOR of the exact-f32 plain version's."""
    n, t = 1024, 200_000
    x, _, _ = _inputs(dev, n, t, 17, torch.float32)
    eye = torch.eye(n, device=dev)
    args = (eye, eye, x, Cube(), False, False, "f32", False)
    g_k = _run_tc(args)[2]
    g_p = K.streaming_fused_sums_plain(*args)[2]
    g_64 = (x * x * x).double() @ x.double().T
    _drift(g_k, g_p, g_64)


# ---------------------------------------------------------------------------
# Plain mode at the f32 tier on f32 X (the moments hand-off at f32).
# ---------------------------------------------------------------------------

WIDE_N = [65, 127, 129, 704, 1344]


def _plain_f32_args(dev, n, t, seed, density=Tanh(), need_h=True, need_ysq=True):
    x, m_old, _ = _inputs(dev, n, t, seed, torch.float32)
    return (m_old, m_old, x, density, need_h, need_ysq, "f32", True)


@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
@pytest.mark.parametrize("t", [1, 31, 4100, 20_001])
@pytest.mark.parametrize("n", WIDE_N)
def test_stream_tc_plain_f32_shapes_match_plain(dev, n, t, flags):
    """Plain f32 at the edges of the 128-row blocks and the 32-deep k
    stages, ragged T (T % 8 != 0; 4-byte copies where T % 4 != 0), with
    and without H and the Y^2 sums."""
    args = _plain_f32_args(dev, n, t, n + t + 20, need_h=flags[0], need_ysq=flags[1])
    out = _run_tc(args)
    _close(out, K.streaming_fused_sums_plain(*args), RTOL_F32)
    if flags[1]:
        assert torch.equal(out[1], out[5])  # dysq = ysq = sum Y^2


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_stream_tc_plain_f32_flags_and_densities_match_plain(dev, need_h, need_ysq, density):
    """Ragged N and T (T % 8 == 4: 16-byte copies of f32 rows)."""
    args = _plain_f32_args(dev, 257, 10_004, 21, density, need_h, need_ysq)
    out = _run_tc(args)
    _close(out, K.streaming_fused_sums_plain(*args), RTOL_F32)
    if not need_h:
        assert not out[4].any()
    if not need_ysq:
        assert not out[1].any() and not out[5].any()


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_stream_tc_plain_f32_unaligned_and_chunked_match_plain(dev, monkeypatch, need_h):
    """1,000,003 columns (4-byte copies of f32 rows), then a workspace cap
    of two groups of f32 planes: 20,001 columns in 20 groups of 1,024 run
    as 10 chunks of both launches."""
    args = _plain_f32_args(dev, 257, 1_000_003, 22, need_h=need_h)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args), RTOL_F32)
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 1024)
    n, t = 257, 20_001
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 1024 * 2 * (1 + need_h) * 384 * 4)
    plan = K.stream_tc_plan(n, t, need_h, "f32")
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (1024, 20, 2)
    args = _plain_f32_args(dev, n, t, 23, need_h=need_h)
    _close(_run_tc(args), K.streaming_fused_sums_plain(*args), RTOL_F32)


def test_stream_tc_plain_f32_rotation_drift_against_f64(dev):
    """The plain f32 rotation at 1024 x 200,000, K 1024 deep: ysq = sum Y^2
    against the same sum in f64 of the f32 operands (M and X), within
    DRIFT_FACTOR of the exact-f32 plain version's error."""
    args = _plain_f32_args(dev, 1024, 200_000, 24, need_h=False)
    m, x = args[0], args[2]
    out_k = _run_tc(args)
    out_p = K.streaming_fused_sums_plain(*args)
    y = m.double() @ x.double()
    ysq = (y * y).sum(dim=1)
    del y
    _drift(out_k[5], out_p[5], ysq)


def test_stream_tc_plain_f32_g_drift_against_f64(dev):
    """The plain f32 route's contraction at 1024 x 200,000: M = I and the
    cube density, so Y = X exactly and psi = X^3 in f32; G's error against
    f64 sums of those f32 operands within DRIFT_FACTOR of the exact-f32
    plain version's."""
    n, t = 1024, 200_000
    x, _, _ = _inputs(dev, n, t, 25, torch.float32)
    eye = torch.eye(n, device=dev)
    args = (eye, eye, x, Cube(), False, False, "f32", True)
    g_k = _run_tc(args)[2]
    g_p = K.streaming_fused_sums_plain(*args)[2]
    _drift(g_k, g_p, (x * x * x).double() @ x.double().T)


# ---------------------------------------------------------------------------
# The loglik kernel on the route, bf16 X and f32 X.
# ---------------------------------------------------------------------------


def _run_loglik(args):
    K.reset_launch_counts()
    out = K.streaming_loglik_sums(*args)
    tier = "bf16" if args[1].dtype == torch.bfloat16 else "f32"
    assert K.streaming_loglik_sums.launches == 1
    assert K.streaming_loglik_sums.launches_by_tier == {
        "bf16": int(tier == "bf16"), "f32": int(tier == "f32")}
    return out


def _loglik_args(dev, n, t, seed, bf16_x, density=Tanh(), need_ysq=True):
    x, m_old, _ = _inputs(dev, n, t, seed, torch.bfloat16 if bf16_x else torch.float32)
    return (m_old, x, density, need_ysq)


@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("t", [1, 31, 4100, 20_001])
@pytest.mark.parametrize("n", WIDE_N)
def test_stream_loglik_tc_shapes_match_plain(dev, n, t, bf16_x, need_ysq):
    """The loglik kernel at the edges of the 128-row blocks and the k
    stages (64-deep boxes on bf16 X, 16-deep steps on f32 X) and ragged T,
    masked at columns >= T (log_lik(0) != 0)."""
    args = _loglik_args(dev, n, t, n + t + 30, bf16_x, need_ysq=need_ysq)
    out = _run_loglik(args)
    _close(out, K.streaming_loglik_sums_plain(*args), RTOL_F32)
    if not need_ysq:
        assert not out[1].any()


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_stream_loglik_tc_densities_match_plain(dev, bf16_x, density):
    args = _loglik_args(dev, 257, 10_004, 31, bf16_x, density)
    _close(_run_loglik(args), K.streaming_loglik_sums_plain(*args), RTOL_F32)


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_stream_loglik_tc_unaligned_and_narrow_groups_match_plain(dev, monkeypatch, bf16_x):
    """1,000,003 columns (rows not 16-byte aligned: plain loads of bf16 X,
    bulk copies of the 16-byte aligned spans around f32 X's rows), then
    groups of one 128-column tile (7,813 groups in the one launch)."""
    args = _loglik_args(dev, 1024, 1_000_003, 32, bf16_x)
    _close(_run_loglik(args), K.streaming_loglik_sums_plain(*args), RTOL_F32)
    monkeypatch.setattr(K, "STREAM_TC_LOGLIK_COLS", 128)
    assert K.stream_tc_plan(129, 1_000_003, False, planes=False).n_parts == 7813
    args = _loglik_args(dev, 129, 1_000_003, 33, bf16_x)
    _close(_run_loglik(args), K.streaming_loglik_sums_plain(*args), RTOL_F32)


def test_rotated_loglik_hand_off_takes_the_route(dev):
    """rotated_loglik_sums above N = 64 (the loss re-baselines): the
    route's loglik kernel on either X dtype."""
    for bf16_x in (False, True):
        args = _loglik_args(dev, 130, 5000, 34, bf16_x)
        K.reset_launch_counts()
        out = K.rotated_loglik_sums(*args)
        tier = "bf16" if bf16_x else "f32"
        assert K.streaming_loglik_sums.launches_by_tier[tier] == 1
        assert K.rotated_loglik_sums.launches == 0
        _close(out, K.rotated_loglik_sums_plain(*args), RTOL_F32)


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("n", [1024, 1344])
def test_stream_loglik_tc_drift_against_f64(dev, n, bf16_x):
    """The loglik kernel at N x 200,000, K up to 1344 deep: ll and ysq
    against the same sums in f64 of the kernel's operands (M and X on f32
    X; bf16(M) and X on bf16 X), within DRIFT_FACTOR of the plain
    version's error (ll is the loss baseline the line search compares
    against). A chain of wgmma sums over all of k rounds toward zero and
    fails at 1344 x 200,000; each 16-deep step's fresh sum holds."""
    args = _loglik_args(dev, n, 200_000, 35, bf16_x)
    m, x, density = args[:3]
    out_k = _run_loglik(args)
    out_p = K.streaming_loglik_sums_plain(*args)
    y = (K._bf16(m) if bf16_x else m).double() @ x.double()
    ll = density.log_lik(y).sum(dim=1)
    ysq = (y * y).sum(dim=1)
    del y
    _drift(out_k[0], out_p[0], ll)
    _drift(out_k[1], out_p[1], ysq)


@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_stream_loglik_tc_small_ragged_matches_plain(dev, bf16_x, need_ysq):
    """72 x 1,000,003 (chip_smoke.py's N_SMALL2 x T_RAGGED): one W row
    block, mostly padding (log_lik(0) != 0: the padded rows are dropped),
    and rows not 16-byte aligned (plain loads of bf16 X; f32 X's rows as
    their 16-byte aligned spans)."""
    args = _loglik_args(dev, 72, 1_000_003, 36, bf16_x, need_ysq=need_ysq)
    out = _run_loglik(args)
    _close(out, K.streaming_loglik_sums_plain(*args), RTOL_F32)
    if not need_ysq:
        assert not out[1].any()


def test_loglik_launches_no_mma_sync_kernel(dev):
    """A loglik call can launch only the wgmma kernels' log-lik modes: the
    built library holds ``rotate_plain_wgmma_kernel`` with LOGLIK (bf16 X)
    and ``rotate_wgmma_kernel`` at F32 in MODE_LOGLIK (f32 X), for every
    density, and neither ``rotate_density_kernel`` nor a MODE_LOGLIK
    instantiation of the mma.sync ``rotate_split_kernel`` (ptxas's report
    of the build, by mangled name: template arguments <D, NEED_H = false,
    LOGLIK = true> and <ROT = F32, MODE = MODE_LOGLIK, D, NEED_H = false>;
    MODE first in the split kernel's). The kernels' names in a trace:
    ``port_turns.py --loglik``."""
    from picard_ica_tpu_torch.ops import _build

    K._lib()
    assert b"rotate_density_kernel" not in _build.library_path().read_bytes()
    names = [k[0] for ks in _build.resource_report().values() for k in ks]
    assert not any("rotate_density_kernel" in k or "rotate_split_kernelILi2E" in k
                   for k in names)
    for d in range(3):  # TANH, EXP, CUBE
        assert sum(f"rotate_plain_wgmma_kernelILi{d}ELb0ELb1E" in k for k in names) == 1
        assert sum(f"rotate_wgmma_kernelILi0ELi2ELi{d}ELb0E" in k for k in names) == 1
    for bf16_x in (True, False):
        _run_loglik(_loglik_args(dev, 130, 50_000, 37, bf16_x))


def test_staged_fit_makes_no_scalar_launch(dev):
    """A default staged fit at N = 256 through the streaming kernels
    (``use_kernels=True``): every fused pass on the tensor-core route, the
    scalar kernel never launched, and every loglik launch on the route."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.utils import generate_mixed_kurtosis_data

    _, _, x = generate_mixed_kurtosis_data(256, 100_000, 2)
    K.reset_launch_counts()
    r = Picard.fit(x, PicardConfig(random_state=0, use_kernels=True))
    tiers = K.streaming_fused_sums.launches_by_tier
    print(f"iterations {r.n_iterations}, stage exits {r.stage_exits}, fused {tiers}, "
          f"loglik {K.streaming_loglik_sums.launches_by_tier}")
    assert bool(torch.isfinite(r.unmixing).all())
    assert sum(tiers.values()) == K.streaming_fused_sums.launches > 0
    assert tiers["bf16"] > 0
    assert K.streaming_loglik_sums.launches == sum(
        K.streaming_loglik_sums.launches_by_tier.values())


def test_auto_takes_the_streaming_kernels(dev):
    """use_kernels=None at N = 80 (past the resident kernels' 64): an f32
    fit on the card runs the streaming kernels, as the measured auto rule
    (solver.AUTO_KERNELS_MAX_N) says, and converges (the data of
    tests/test_torch_cuda.py's use_kernels=True fit)."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

    _, a, x = generate_mixed_kurtosis_data(80, 60_000, 5)
    K.reset_launch_counts()
    r = Picard.fit(x, PicardConfig(random_state=0))
    assert K.streaming_fused_sums.launches > 0 and K.rotated_fused_sums.launches == 0
    assert r.converged
    assert amari_distance(r.full_unmixing().double().cpu().numpy(), a) < 5e-3


# ---------------------------------------------------------------------------
# Launch B alone (``K.stream_contract_sums``, the C entry
# ``picard_stream_contract_tc``) against its plain version.
# ---------------------------------------------------------------------------


def _contract_ws(dev, n, t, tier, need_h, seed):
    """A launch-B workspace from unit-scale operands on the card: Y
    standard normal, psi = tanh(Y), psi' = 1 - psi^2 and Y^2."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(n, t, device=dev, generator=gen)
    psi = torch.tanh(y)
    ops = [psi, y] + ([1.0 - psi * psi, y * y] if need_h else [])
    plan = K.stream_tc_plan(n, t, need_h, tier)
    ws = K.contract_workspace(ops, tier, plan)
    del ops, y, psi
    return plan, ws


def _contract_close(tier, got, want):
    """Each group's partial within the tier's rule of its largest entry:
    RTOL_F32 against the exact-f32 plain version at f32, RTOL_X3 at bf16x3,
    and at bf16 the same 2e-5 (the operands are the same bf16 values, so
    only the order of the f32 sums differs)."""
    rtol = RTOL_F32 if tier == "f32" else RTOL_X3
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    assert bool(((got - want).abs() <= rtol * scale).all()), \
        float(((got - want).abs() / scale).max())


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
@pytest.mark.parametrize("t", [4096, 1_000_003])
@pytest.mark.parametrize("n", [65, 129, 306, 1024])
@pytest.mark.parametrize("tier", ["bf16", "bf16x3", "f32"])
def test_contract_matches_plain(dev, tier, n, t, need_h):
    """Launch B alone at every tier, with and without H, over the plan's
    workspace (at 1,000,003 columns several chunks at N = 1024, the last
    group ragged): each group's partials of G and H against the plain
    version's."""
    plan, ws = _contract_ws(dev, n, t, tier, need_h, n + t)
    args = (ws, n, tier, need_h, plan.cols_per_group, plan.n_parts)
    K.reset_launch_counts()
    out = K.stream_contract_sums(*args)
    torch.cuda.synchronize()
    assert K.stream_contract_sums.launches == 1
    assert (out[1] is None) == (not need_h)
    want = K.stream_contract_sums_plain(*args)
    for m in range(1 + need_h):
        _contract_close(tier, out[m], want[m])
