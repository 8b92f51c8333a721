"""The tensor-core route of streaming_fused_sums and streaming_loglik_sums,
on the CPU.

The route (``csrc/streaming_fused_tc.cu``: every (mode, tier, X dtype)
pair of the fused kernel, the rotation at the rotation tier, bf16 on bf16
X, and the workspace and contraction at the contraction tier; the loglik
kernel, the rotation launch alone with a log-lik epilogue, on bf16 X at
the bf16 tier and on f32 X at the f32 tier) runs only on the card. What
surrounds it is held here:

  * :func:`ops.kernels.stream_tc_plan`'s invariants at every tier: the
    groups cover T once in whole tiles, a chunk is whole groups, and the
    workspace stays under its cap;
  * a torch emulation of the two launches (the plan's groups and chunks;
    X split once at the rotation tier and shared by both rotations; the
    workspace planes, bf16 psi and Y, with H psi' and Y^2, each as hi and
    lo at bf16x3 and as f32 at f32, exact zeros at padded rows and
    columns; per-group row sums and products; the groups folded
    pairwise) against the JAX package's ``streaming_fused_sums(...,
    interpret=True)`` (``picard_ica_tpu.ops.pallas_kernels``) in all ten
    pairs, and against ``streaming_fused_sums_plain``. At f32 the
    emulation splits every operand three ways (hi / mid / lo) and sums the
    six products of each 16-deep step, small first and hi*hi last, before
    adding the step to its f32 sum, as the kernels' fresh accumulators do.
    The delta pairs on f32 X at bf16x3 and f32 model the wgmma launch A
    (``rotate_wgmma_kernel``): at bf16x3 too each 16-deep step's hi*hi,
    lo*hi, hi*lo form a fresh sum, and each row's sums run by 128-column
    tiles, f32 within a tile and f64 across the group's tiles;
  * the wrapper's launch of every pair on tensors on the meta device (the
    C entry replaced by a recorder): the mode, both tiers, X's dtype, the
    weights' planes, their layout (the wgmma launch A's, for its pairs)
    and the plan; the wgmma layout's place of every weight; and the
    library's load holding its wgmma pairs to the wrapper's;
  * a torch emulation of the loglik kernel, the log-lik modes of the two
    wgmma launch A kernels (the ``planes=False`` plan's groups; the
    rotation of either tier in fresh 16-deep steps; the masked log-lik and
    Y^2 row sums per group in each kernel's order: on bf16 X f32 over
    64-column tiles, f64 over each of three consumers' alternate tiles,
    the consumers in order; on f32 X f32 over 128-column tiles, f64 across
    them; the groups folded pairwise) against the JAX package's
    ``streaming_loglik_sums(..., interpret=True)`` and
    ``streaming_loglik_sums_plain``, and its wrapper's launch on the meta
    device (the weights' layout of each X dtype).

Tolerances: with a bf16 contraction, 1e-3 of each output's largest
entry, the bf16 rule of tests/test_torch_streaming.py (psi and Y are
rounded to bf16 after rotations whose f32 sums are ordered differently);
with a bf16x3 or an f32 contraction, 2e-5 of each output's largest
entry, that file's f32 and bf16x3 rule (the splits keep ~16 or ~24 bits,
and only the order of the f32 sums differs). The loglik kernel rounds nothing
to bf16 after its rotation, so both its tiers are held to 2e-5 too
(LL_TOL): only the order of the f32 sums differs. The CUDA kernels are held against the plain
version on the card by tests/test_torch_stream_tc_cuda.py and
chip_smoke.py.
"""

from types import SimpleNamespace

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

DENS = {"tanh": (jd.Tanh(), td.Tanh()), "exp0.5": (jd.Exp(0.5), td.Exp(0.5)),
        "cube": (jd.Cube(), td.Cube())}
BF16_TOL = 1e-3
X3_TOL = 2e-5
F32_TOL = 2e-5
# One 128-row block with padded rows, a second block, ragged T.
SHAPES = [(65, 777), (80, 2049), (130, 4099)]


def _inputs(n, t, seed):
    rng = np.random.default_rng(seed)
    m_new = (np.eye(n) + 0.8 / np.sqrt(n) * rng.standard_normal((n, n))).astype(np.float32)
    x = (rng.laplace(size=(n, t)) / np.sqrt(2.0)).astype(np.float32)
    return m_new, x


def _delta_inputs(n, t, seed):
    """f32 X and a line-search step's M_old, M_new near the identity."""
    m_new, x = _inputs(n, t, seed)
    rng = np.random.default_rng(seed + 1)
    m_old = (m_new - 0.1 * 0.8 / np.sqrt(n) * rng.standard_normal((n, n))).astype(np.float32)
    return m_new, m_old, x


def _padded_planes(mats, n_pad):
    """The weights as zero-padded (n_pad, n) rows."""
    out = torch.zeros((len(mats), n_pad, mats[0].shape[1]))
    for plane, m in zip(out, mats):
        plane[: m.shape[0]] = m
    return out


def _x3(a_pair, b_pair):
    """The three products of split operands, hi*hi + lo*hi + hi*lo."""
    (a_hi, a_lo), (b_hi, b_lo) = a_pair, b_pair
    return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo


def _x6(a, b):
    """The six products of three-way split operands in the kernels' order:
    lo*hi, mid*mid, hi*lo, mid*hi, hi*mid, then hi*hi (mma_tier<F32>)."""
    (a_hi, a_mid, a_lo), (b_hi, b_mid, b_lo) = a, b
    return (a_lo @ b_hi + a_mid @ b_mid + a_hi @ b_lo + a_mid @ b_hi + a_hi @ b_mid
            + a_hi @ b_hi)


STEP = 16  # the depth of an MMA: each step's products form one fresh sum


def _x6_rotate(w_parts, x_parts):
    """W X at the f32 tier: the six products of each 16-deep k step, each
    step's sum added to the f32 result in order."""
    out = 0.0
    for s in range(0, x_parts[0].shape[0], STEP):
        out = out + _x6([u[:, s:s + STEP] for u in w_parts], [u[s:s + STEP] for u in x_parts])
    return out


def _x3_rotate(w_parts, x_parts):
    """W X at the bf16x3 tier as the wgmma launch A sums it: each 16-deep
    k step's hi*hi, lo*hi, hi*lo in a fresh sum, the step added to the f32
    result in order."""
    out = 0.0
    for s in range(0, x_parts[0].shape[0], STEP):
        out = out + _x3([u[:, s:s + STEP] for u in w_parts], [u[s:s + STEP] for u in x_parts])
    return out


# The wgmma launch A's column tile: each row's sums over a tile are f32,
# the tiles' sums are added in f64 and the group's rounded once.
WGMMA_TILE = 128


def _row_sums(v, s, tiled):
    """Each row's sum of ``v`` over the columns ``s``: by the wgmma
    launch A's tiles with ``tiled``, else in one f32 sum."""
    if not tiled:
        return v[:, s].sum(dim=1)
    u = v[:, s]
    return u.reshape(u.shape[0], -1, WGMMA_TILE).sum(dim=2).double().sum(dim=1).float()


def _x6_contract(a, b):
    """a b^T at the f32 tier over a group's columns: a and b split three
    ways, the six products of each 16-column step (batched over the
    steps), the steps added to the f32 result in order."""
    n, cols = a.shape

    def stepped(v):  # (n, cols) -> (steps, n, STEP)
        return v.reshape(n, cols // STEP, STEP).transpose(0, 1)

    steps = _x6([stepped(u) for u in K._split3_bf16(a)],
                [stepped(u).transpose(1, 2) for u in K._split3_bf16(b)])
    out = steps[0]
    for p in steps[1:]:
        out = out + p
    return out


# A matrix's bf16 parts at each tier: itself rounded, hi / lo, hi / mid / lo.
PARTS = {"bf16": lambda v: (K._bf16(v),), "bf16x3": K._split_bf16, "f32": K._split3_bf16}


def _rotate(w_parts, x_parts, rot, wgmma=False):
    """W X at the rotation tier from the parts of both (at bf16x3 with
    ``wgmma`` in fresh 16-deep steps)."""
    if rot == "f32":
        return _x6_rotate(w_parts, x_parts)
    if rot == "bf16x3":
        return _x3_rotate(w_parts, x_parts) if wgmma else _x3(w_parts, x_parts)
    return w_parts[0] @ x_parts[0]  # bf16: products of bf16 values are exact in f32


def _emulate(m_new, x, density, need_h, need_ysq, m_old=None, tier=None):
    """The route's two launches in torch, on the CPU: per chunk of whole
    groups, launch A's workspace and its row sums per group, launch B's
    products per group; every output's groups folded pairwise.

    ``tier`` is the request (default: bf16x3 with ``m_old``, else bf16);
    on bf16 X the rotation runs at the bf16 tier and an f32 request at
    bf16, as ``K._tiers``. The weights in X's working dtype (rounded to
    bf16 on bf16 X) as zero-padded planes of their parts at the rotation
    tier: M_new's in plain mode (``m_old`` None), M_old's and dM's in
    delta mode. Each chunk of X split once at the rotation tier (rounded
    to bf16 at bf16, hi / lo at bf16x3, hi / mid / lo at f32, where each
    16-deep k step's six products form a fresh sum) and shared by both
    rotations; in delta mode Y = Y_old + dY and the delta density's row
    sums, in plain mode the plain density's. The workspace planes of psi
    and Y (psi' and Y^2 with H) at the contraction tier: bf16, hi / lo at
    bf16x3, f32 at f32 (the contraction splits them three ways and sums
    each 16-column step's six products fresh). Zeros at padded rows and
    columns, psi' masked there. The delta pairs on f32 X at bf16x3 and
    f32 (``K.WGMMA_PAIRS``) run the wgmma launch A: the rotations in
    fresh 16-deep steps at both tiers, the row sums by 128-column tiles
    (:func:`_row_sums`)."""
    n, t = x.shape
    delta = m_old is not None
    tier, rot = K._tiers(x, tier or ("bf16x3" if delta else "bf16"))
    wgmma = K._wgmma_pair(delta, rot, tier, x.dtype != torch.float32)
    plan = K.stream_tc_plan(n, t, need_h, tier)
    cols = plan.cols_per_group
    if delta:
        mn, mo = K._mats(x, m_new, m_old)
        mats = [mo, mn - mo]
    else:
        mats = K._mats(x, m_new)
    w = [_padded_planes(PARTS[rot](m), plan.n_pad) for m in mats]
    xf = x.float()
    live = (torch.arange(plan.n_pad) < n)[:, None]
    parts = [[] for _ in range(6)]
    for g0 in range(0, plan.n_parts, plan.groups_per_chunk):
        g1 = min(g0 + plan.groups_per_chunk, plan.n_parts)
        c0, c1 = g0 * cols, g1 * cols
        xc = torch.nn.functional.pad(xf[:, c0:min(c1, t)], (0, c1 - min(c1, t)))
        valid = live & (torch.arange(c0, c1) < t)[None]
        x_parts = PARTS[rot](xc)  # one split shared by both rotations
        if delta:
            y_old = _rotate(w[0], x_parts, rot, wgmma)
            dy = _rotate(w[1], x_parts, rot, wgmma)
            y = y_old + dy
            _, pm_el, ll = density.score_der_loglik_delta(y_old, dy)
            dysq = (2.0 * y_old + dy) * dy
            psi, psid = density.score_and_der(y)
        else:
            y = _rotate(w[0], x_parts, rot)
            psi, psid, ll = density.score_der_loglik(y)
            pm_el, dysq = psid, y * y
        ll = torch.where(valid, ll, 0.0)
        pm_el = torch.where(valid, pm_el, 0.0)
        psid = torch.where(valid, psid, 0.0)
        split = (lambda v: (v,)) if tier == "f32" else PARTS[tier]  # noqa: E731
        ops = [split(psi), split(y)] + ([split(psid), split(y * y)] if need_h else [])
        elem = 4 if tier == "f32" else 2  # bytes of a workspace element of one plane
        assert sum(map(len, ops)) * plan.n_pad * (c1 - c0) * elem <= plan.ws_bytes
        for v in (u for pair in ops for u in pair):  # exactly zero past n and t
            assert not v[~valid].any()

        def product(a, b, s):
            if tier == "f32":
                return _x6_contract(a[0][:n, s], b[0][:n, s])
            a, b = [u[:n, s] for u in a], [u[:n, s].T for u in b]
            return _x3(a, b) if tier == "bf16x3" else a[0] @ b[0]

        for g in range(g1 - g0):
            s = slice(g * cols, (g + 1) * cols)
            parts[0].append(_row_sums(ll[:n], s, wgmma))
            parts[1].append(_row_sums(dysq[:n], s, wgmma))
            parts[2].append(product(ops[0], ops[1], s))
            parts[3].append(_row_sums(pm_el[:n], s, wgmma))
            if need_h:
                parts[4].append(product(ops[2], ops[3], s))
            parts[5].append(_row_sums(y[:n] * y[:n], s, wgmma))
    assert len(parts[0]) == plan.n_parts
    out = [fold_pairwise(torch.stack(p)) if p else torch.zeros((n, n)) for p in parts]
    if not need_ysq:
        out[1] = out[5] = torch.zeros(n)
    return tuple(out)


def _check(ref, got, tol=BF16_TOL):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        assert b.shape == a.shape
        scale = max(np.abs(a).max(), 1e-300)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale)


def _jax(m_new, x, dens, need_h, need_ysq):
    jden = DENS[dens][0]
    m = jnp.asarray(m_new)
    return pk.streaming_fused_sums(m, m, jnp.asarray(x).astype(jnp.bfloat16), jden, need_h,
                                   need_ysq, interpret=True, precision="bf16",
                                   absolute_ll=True)


@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n,t", SHAPES)
def test_emulated_route_matches_jax_and_plain(n, t, dens):
    m_new, x = _inputs(n, t, n + t)
    tm, tx = torch.from_numpy(m_new), torch.from_numpy(x).to(torch.bfloat16)
    tden = DENS[dens][1]
    got = _emulate(tm, tx, tden, True, True)
    _check(_jax(m_new, x, dens, True, True), got)
    _check(K.streaming_fused_sums_plain(tm, tm, tx, tden, True, True, "bf16", True), got)


@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_emulated_route_flags(need_h, need_ysq):
    m_new, x = _inputs(80, 1001, 3)
    tm, tx = torch.from_numpy(m_new), torch.from_numpy(x).to(torch.bfloat16)
    got = _emulate(tm, tx, td.Tanh(), need_h, need_ysq)
    _check(_jax(m_new, x, "tanh", need_h, need_ysq), got)
    if not need_h:
        assert not got[4].any()
    if not need_ysq:
        assert not got[1].any() and not got[5].any()


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_emulated_route_in_chunks(monkeypatch, need_h):
    """Groups of 128 columns and a workspace of two groups: 2,049 columns
    in 17 groups run as 9 chunks, and give the unchunked sums."""
    m_new, x = _inputs(80, 2049, 4)
    tm, tx = torch.from_numpy(m_new), torch.from_numpy(x).to(torch.bfloat16)
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 128)
    whole = _emulate(tm, tx, td.Tanh(), need_h, True)
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 128 * 2 * (1 + need_h) * 128 * 2)
    plan = K.stream_tc_plan(80, 2049, need_h)
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (128, 17, 2)
    chunked = _emulate(tm, tx, td.Tanh(), need_h, True)
    _check(whole, chunked, 1e-6)
    _check(_jax(m_new, x, "tanh", need_h, True), chunked)


def _jax_delta(m_new, m_old, x, dens, need_h, need_ysq, precision="bf16x3"):
    return pk.streaming_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old), jnp.asarray(x),
                                   DENS[dens][0], need_h, need_ysq, interpret=True,
                                   precision=precision, absolute_ll=False)


def _delta_case(n, t, seed):
    m_new, m_old, x = _delta_inputs(n, t, seed)
    return (m_new, m_old, x), tuple(torch.from_numpy(v) for v in (m_new, m_old, x))


@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n,t", SHAPES)
def test_emulated_delta_route_matches_jax_and_plain(n, t, dens):
    (m_new, m_old, x), (tm, to, tx) = _delta_case(n, t, n + t)
    tden = DENS[dens][1]
    got = _emulate(tm, tx, tden, True, True, m_old=to)
    _check(_jax_delta(m_new, m_old, x, dens, True, True), got, X3_TOL)
    _check(K.streaming_fused_sums_plain(tm, to, tx, tden, True, True, "bf16x3", False), got,
           X3_TOL)


@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_emulated_delta_route_flags(need_h, need_ysq):
    (m_new, m_old, x), (tm, to, tx) = _delta_case(80, 1001, 3)
    got = _emulate(tm, tx, td.Tanh(), need_h, need_ysq, m_old=to)
    _check(_jax_delta(m_new, m_old, x, "tanh", need_h, need_ysq), got, X3_TOL)
    if not need_h:
        assert not got[4].any()
    if not need_ysq:
        assert not got[1].any() and not got[5].any()


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_emulated_delta_route_in_chunks(monkeypatch, need_h):
    """Groups of 128 columns and a workspace of two groups of hi / lo
    planes: 2,049 columns in 17 groups run as 9 chunks, and give the
    unchunked sums."""
    (m_new, m_old, x), (tm, to, tx) = _delta_case(80, 2049, 4)
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 128)
    whole = _emulate(tm, tx, td.Exp(0.5), need_h, True, m_old=to)
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 128 * 2 * (1 + need_h) * 2 * 128 * 2)
    plan = K.stream_tc_plan(80, 2049, need_h, "bf16x3")
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (128, 17, 2)
    chunked = _emulate(tm, tx, td.Exp(0.5), need_h, True, m_old=to)
    _check(whole, chunked, 1e-6)
    _check(_jax_delta(m_new, m_old, x, "exp0.5", need_h, True), chunked, X3_TOL)


def test_cpu_wrapper_runs_the_plain_version_in_delta_bf16x3():
    """Delta bf16x3 on a CPU tensor of f32 X runs the plain version and
    launches nothing."""
    _, (tm, to, tx) = _delta_case(80, 1001, 5)
    K.reset_launch_counts()
    out = K.streaming_fused_sums(tm, to, tx, td.Tanh(), True, True, "bf16x3", False)
    ref = K.streaming_fused_sums_plain(tm, to, tx, td.Tanh(), True, True, "bf16x3", False)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert K.streaming_fused_sums.launches == 0
    assert K.streaming_fused_sums.launches_by_tier == {"f32": 0, "bf16x3": 0, "bf16": 0}


# ---------------------------------------------------------------------------
# Delta mode at the f32 tier on f32 X.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n,t", SHAPES)
def test_emulated_f32_route_matches_jax_and_plain(n, t, dens):
    (m_new, m_old, x), (tm, to, tx) = _delta_case(n, t, n + t)
    tden = DENS[dens][1]
    got = _emulate(tm, tx, tden, True, True, m_old=to, tier="f32")
    _check(_jax_delta(m_new, m_old, x, dens, True, True, "f32"), got, F32_TOL)
    _check(K.streaming_fused_sums_plain(tm, to, tx, tden, True, True, "f32", False), got,
           F32_TOL)


@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_emulated_f32_route_flags(need_h, need_ysq):
    (m_new, m_old, x), (tm, to, tx) = _delta_case(80, 1001, 3)
    got = _emulate(tm, tx, td.Tanh(), need_h, need_ysq, m_old=to, tier="f32")
    _check(_jax_delta(m_new, m_old, x, "tanh", need_h, need_ysq, "f32"), got, F32_TOL)
    if not need_h:
        assert not got[4].any()
    if not need_ysq:
        assert not got[1].any() and not got[5].any()


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_emulated_f32_route_in_chunks(monkeypatch, need_h):
    """Groups of 128 columns and a workspace of two groups of f32 planes:
    2,049 columns in 17 groups run as 9 chunks, and give the unchunked
    sums."""
    (m_new, m_old, x), (tm, to, tx) = _delta_case(80, 2049, 4)
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 128)
    whole = _emulate(tm, tx, td.Cube(), need_h, True, m_old=to, tier="f32")
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 128 * 2 * (1 + need_h) * 128 * 4)
    plan = K.stream_tc_plan(80, 2049, need_h, "f32")
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (128, 17, 2)
    chunked = _emulate(tm, tx, td.Cube(), need_h, True, m_old=to, tier="f32")
    _check(whole, chunked, 1e-6)
    _check(_jax_delta(m_new, m_old, x, "cube", need_h, True, "f32"), chunked, F32_TOL)


@pytest.mark.parametrize("n,n_planes", [(65, 4), (130, 6), (306, 6)])
def test_wgmma_weights_layout(n, n_planes):
    """Each weight (plane, row r, column k) lands where the wgmma launch A
    copies and reads it: row block r // 128's k step k // 16's stage, the
    plane's 4,096-byte tile in it, and in the tile the no-swizzle K-major
    core-matrix place (r % 128 // 8) * 128 + (k % 16 // 8) * 64 + (r % 8)
    * 8 + k % 8; zeros past n in both."""
    rng = np.random.default_rng(n)
    planes = [K._bf16(torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)))
              for _ in range(n_planes)]
    n_pad, n_ks = -(-n // 128) * 128, -(-n // 16)
    flat = K._wgmma_weights(planes, n, n_pad, "cpu").reshape(-1).float()
    assert flat.numel() == n_planes * n_pad * n_ks * 16
    m, r, k = torch.meshgrid(torch.arange(n_planes), torch.arange(n_pad),
                             torch.arange(n_ks * 16), indexing="ij")
    at = ((((r // 128) * n_ks + k // 16) * n_planes + m) * 2048 + (r % 128 // 8) * 128
          + (k % 16 // 8) * 64 + (r % 8) * 8 + k % 8)
    want = torch.zeros(n_planes, n_pad, n_ks * 16)
    want[:, :n, :n] = torch.stack(planes)
    assert torch.equal(flat[at], want)


@pytest.mark.parametrize("n", [65, 306, 1344])
def test_plain_wgmma_weights_layout(n):
    """Plain bf16 on bf16 X: the wgmma launch A reads the one bf16 plane
    of M_new through a tensor map of boxes of 64 columns x 128 rows
    (csrc P_KC x TILE) of a row-major (n_pad, kp) matrix: weight (r, k) at
    r * kp + k, kp a whole number of boxes, zeros past n in both."""
    rng = np.random.default_rng(n)
    m = K._bf16(torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)))
    n_pad, kp = -(-n // 128) * 128, -(-n // 64) * 64
    assert K.STREAM_TC_KC == 64 and K.STREAM_TC_TILE == 128
    w = K._tc_weights([m], n, n_pad, "cpu")
    assert w.shape == (1, n_pad, kp) and w.dtype == torch.bfloat16 and w.is_contiguous()
    flat = w.reshape(-1).float()
    r, k = torch.meshgrid(torch.arange(n_pad), torch.arange(kp), indexing="ij")
    want = torch.zeros(n_pad, kp)
    want[:n, :n] = m
    assert torch.equal(flat[r * kp + k], want)


def _csrc_wgmma_pair(delta, rot, ct, x_bf16):
    """csrc/streaming_fused_tc.cu's wgmma_pair over the C entries' tier
    codes: delta mode on f32 X, both tiers bf16x3 or both f32."""
    return int(bool(delta) and not x_bf16 and rot == ct
               and rot in (K._TIERS["bf16x3"], K._TIERS["f32"]))


def _csrc_core_wgmma_pair(delta, rot, ct, x_bf16, need_h):
    """csrc/mma_tiers.cuh core_wgmma_pair (kernel 1's wgmma route), as the
    library's ``picard_core_wgmma_pair`` answers."""
    return int(bool(delta) and not x_bf16 and not need_h and rot == ct
               and rot in (K._TIERS["bf16x3"], K._TIERS["f32"]))


@pytest.mark.parametrize("drift", [False, True, "core", "core refused"])
def test_lib_holds_the_wgmma_pairs(monkeypatch, drift):
    """Loading the library holds its wgmma pairs
    (``picard_stream_wgmma_pair``) to the wrapper's choice of the weights'
    layout (``K._wgmma_pair``), and kernel 1's route
    (``picard_core_wgmma_pair``) to the wrapper's (``K._core_wgmma_pair``):
    a library on which one pair differs, here plain f32 on f32 X (True),
    kernel 1's delta f32 with H ("core") or its delta bf16x3 without H
    ("core refused"), fails the load."""
    from picard_ica_tpu_torch.ops import _build

    consts = {"picard_max_n": K.KERNEL_MAX_N, "picard_cols_per_block": K.COLS_PER_BLOCK,
              "picard_cov_chunk": K.COV_CHUNK, "picard_stream_max_n": K.STREAM_MAX_N,
              "picard_stream_tc_tile": K.STREAM_TC_TILE, "picard_stream_tc_kc": K.STREAM_TC_KC,
              "picard_stream_wgmma_ks": K.STREAM_TC_WGMMA_KS}

    f32 = K._TIERS["f32"]

    def pair(delta, rot, ct, x_bf16):
        drifted = drift is True and not delta and rot == ct == f32 and not x_bf16
        return int(drifted) or _csrc_wgmma_pair(delta, rot, ct, x_bf16)

    def core_pair(delta, rot, ct, x_bf16, need_h):
        if drift == "core refused" and rot == ct == K._TIERS["bf16x3"]:
            return 0
        drifted = drift == "core" and delta and rot == ct == f32 and not x_bf16 and need_h
        return int(drifted) or _csrc_core_wgmma_pair(delta, rot, ct, x_bf16, need_h)

    lib = SimpleNamespace(**{k: (lambda v=v: v) for k, v in consts.items()},
                          picard_stream_wgmma_pair=pair, picard_core_wgmma_pair=core_pair)
    monkeypatch.setattr(_build, "load", lambda: lib)
    K._lib.cache_clear()
    try:
        if drift:
            with pytest.raises(RuntimeError, match="wgmma pairs"):
                K._lib()
        else:
            assert K._lib() is lib
    finally:
        K._lib.cache_clear()


def test_split3_is_exact():
    """hi + mid + lo is the f32 operand exactly, each part a bf16 value,
    and each part at most 2^-8 of the one before (to nearest), over
    magnitudes from 1e-20 to 1e20."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096),
        [0.0, 1.0, -3.0, 2.0**-100]]).astype(np.float32))
    hi, mid, lo = K._split3_bf16(v)
    assert torch.equal((hi + mid) + lo, v)
    for part in (hi, mid, lo):
        assert torch.equal(K._bf16(part), part)
    assert bool((mid.abs() <= 2.0**-8 * hi.abs()).all())
    assert bool((lo.abs() <= 2.0**-8 * mid.abs()).all())


def test_cpu_wrapper_runs_the_plain_version_in_delta_f32():
    """Delta f32 on a CPU tensor of f32 X runs the plain version and
    launches nothing."""
    _, (tm, to, tx) = _delta_case(80, 1001, 6)
    K.reset_launch_counts()
    out = K.streaming_fused_sums(tm, to, tx, td.Tanh(), False, True, "f32", False)
    ref = K.streaming_fused_sums_plain(tm, to, tx, td.Tanh(), False, True, "f32", False)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert K.streaming_fused_sums.launches == 0
    assert K.streaming_fused_sums.launches_by_tier == {"f32": 0, "bf16x3": 0, "bf16": 0}


def test_cpu_wrapper_runs_the_plain_version():
    """On a CPU tensor the route's tuple runs the plain version and
    launches nothing."""
    m_new, x = _inputs(80, 1001, 5)
    tm, tx = torch.from_numpy(m_new), torch.from_numpy(x).to(torch.bfloat16)
    K.reset_launch_counts()
    out = K.streaming_fused_sums(tm, tm, tx, td.Tanh(), True, True, "bf16", True)
    ref = K.streaming_fused_sums_plain(tm, tm, tx, td.Tanh(), True, True, "bf16", True)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert K.streaming_fused_sums.launches == 0
    assert K.streaming_fused_sums.launches_by_tier == {"f32": 0, "bf16x3": 0, "bf16": 0}


def _col_bytes(plan, need_h, tier="bf16"):
    return 2 * (1 + need_h) * (1 if tier == "bf16" else 2) * plan.n_pad * 2


PLAN_CASES = [  # (n, t, need_h, workspace cap or None, group columns or None)
    (65, 1, False, None, None),
    (65, 127, True, None, None),
    (128, 4096, False, None, None),
    (129, 4097, True, None, None),
    (256, 2_000_000, False, None, None),
    (256, 2_000_000, True, None, None),
    (1024, 200_000, True, None, None),
    (1344, 1_000_003, True, None, None),
    (1344, 30_000_000, True, None, None),
    (300, 123_457, False, 3 * 1024 * 1024, None),
    (300, 123_457, True, 64 * 1024 * 1024, 1024),
    (700, 9_999_999, False, 8 * 1024**3, None),
]


def _plan_invariants(monkeypatch, n, t, need_h, cap, group_cols, tier):
    if cap is not None:
        monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", cap)
    if group_cols is not None:
        monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", group_cols)
    plan = K.stream_tc_plan(n, t, need_h, tier)
    col_bytes = _col_bytes(plan, need_h, tier)
    tile = K.STREAM_TC_TILE
    assert plan.n_pad % tile == 0 and n <= plan.n_pad < n + tile
    # the groups cover T exactly once, in whole tiles
    assert plan.cols_per_group % tile == 0
    assert (plan.n_parts - 1) * plan.cols_per_group < t <= plan.n_parts * plan.cols_per_group
    # a chunk is whole groups, and a launch's grid takes them
    assert 1 <= plan.groups_per_chunk <= min(plan.n_parts, 65535)
    # the workspace of one chunk, under the cap
    assert plan.ws_bytes == plan.groups_per_chunk * plan.cols_per_group * col_bytes
    assert plan.ws_bytes <= K.STREAM_TC_WORKSPACE_MAX
    # groups of at least STREAM_TC_GROUP_COLS columns where T and the cap allow
    fit = K.STREAM_TC_WORKSPACE_MAX // (col_bytes * tile) * tile
    assert plan.cols_per_group >= min(K.STREAM_TC_GROUP_COLS, -(-t // tile) * tile, fit)
    # the partials stay under their cap unless the workspace cap forced narrower groups
    partials = plan.n_parts * (1 + need_h) * n * n * 4
    assert partials <= max(K.STREAM_PARTIALS_MAX, (1 + need_h) * n * n * 4) or (
        plan.cols_per_group == fit)
    return plan


@pytest.mark.parametrize("n,t,need_h,cap,group_cols", PLAN_CASES)
def test_plan_invariants(monkeypatch, n, t, need_h, cap, group_cols):
    _plan_invariants(monkeypatch, n, t, need_h, cap, group_cols, "bf16")


@pytest.mark.parametrize("n,t,need_h,cap,group_cols", PLAN_CASES)
def test_plan_invariants_bf16x3(monkeypatch, n, t, need_h, cap, group_cols):
    """The hi / lo planes double the workspace a column: the same call
    takes chunks of half the groups, or narrower groups."""
    x3 = _plan_invariants(monkeypatch, n, t, need_h, cap, group_cols, "bf16x3")
    one = K.stream_tc_plan(n, t, need_h, "bf16")
    assert x3.n_pad == one.n_pad and x3.cols_per_group <= one.cols_per_group
    assert x3.groups_per_chunk * x3.cols_per_group <= one.groups_per_chunk * one.cols_per_group


@pytest.mark.parametrize("n,t,need_h,cap,group_cols", PLAN_CASES)
def test_plan_invariants_f32(monkeypatch, n, t, need_h, cap, group_cols):
    """f32 planes take 4 bytes an element, as bf16x3's hi / lo pair: the
    same call is cut as at bf16x3."""
    f32 = _plan_invariants(monkeypatch, n, t, need_h, cap, group_cols, "f32")
    assert f32 == K.stream_tc_plan(n, t, need_h, "bf16x3")


def test_plan_of_the_f32_fit():
    """256 x 2,000,000 at f32 without H (the f32 stage and the f32-only
    fit): 4.1 GB of f32 planes for all of T, so 489 groups of 4,096 columns
    run as two chunks of up to 256 groups under the 2 GB cap."""
    plan = K.stream_tc_plan(256, 2_000_000, False, "f32")
    assert plan == K.StreamTcPlan(256, 4096, 489, 256, 2 * 1024**3)


def test_plan_of_the_staged_fit_delta_stage():
    """256 x 2,000,000 at bf16x3 without H: 4.1 GB of planes for all of T,
    so 489 groups of 4,096 columns run as two chunks of up to 256 groups
    under the 2 GB cap."""
    plan = K.stream_tc_plan(256, 2_000_000, False, "bf16x3")
    assert plan == K.StreamTcPlan(256, 4096, 489, 256, 2 * 1024**3)


# ---------------------------------------------------------------------------
# Plain mode at the f32 tier on f32 X (the moments hand-off at f32).
# ---------------------------------------------------------------------------

# One 128-row block with padded rows, two, and three
# with one live row in the last; ragged T.
WIDE_SHAPES = [(65, 777), (130, 2049), (257, 1031)]


def _jax_plain_f32(m_new, x, dens, need_h, need_ysq):
    m = jnp.asarray(m_new)
    return pk.streaming_fused_sums(m, m, jnp.asarray(x), DENS[dens][0], need_h, need_ysq,
                                   interpret=True, precision="f32", absolute_ll=True)


@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n,t", WIDE_SHAPES)
def test_emulated_plain_f32_route_matches_jax_and_plain(n, t, dens):
    m_new, x = _inputs(n, t, n + t + 1)
    tm, tx = torch.from_numpy(m_new), torch.from_numpy(x)
    tden = DENS[dens][1]
    got = _emulate(tm, tx, tden, True, True, tier="f32")
    _check(_jax_plain_f32(m_new, x, dens, True, True), got, F32_TOL)
    _check(K.streaming_fused_sums_plain(tm, tm, tx, tden, True, True, "f32", True), got,
           F32_TOL)


@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_emulated_plain_f32_route_flags(need_h, need_ysq):
    m_new, x = _inputs(80, 1001, 7)
    tm, tx = torch.from_numpy(m_new), torch.from_numpy(x)
    got = _emulate(tm, tx, td.Tanh(), need_h, need_ysq, tier="f32")
    _check(_jax_plain_f32(m_new, x, "tanh", need_h, need_ysq), got, F32_TOL)
    if not need_h:
        assert not got[4].any()
    if not need_ysq:
        assert not got[1].any() and not got[5].any()
    else:
        assert torch.equal(got[1], got[5])  # plain mode: dysq = ysq = sum Y^2


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
def test_emulated_plain_f32_route_in_chunks(monkeypatch, need_h):
    """Groups of 128 columns and a workspace of two groups of f32 planes:
    2,049 columns in 17 groups run as 9 chunks, and give the unchunked
    sums."""
    m_new, x = _inputs(80, 2049, 8)
    tm, tx = torch.from_numpy(m_new), torch.from_numpy(x)
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 128)
    whole = _emulate(tm, tx, td.Exp(0.5), need_h, True, tier="f32")
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 128 * 2 * (1 + need_h) * 128 * 4)
    plan = K.stream_tc_plan(80, 2049, need_h, "f32")
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (128, 17, 2)
    chunked = _emulate(tm, tx, td.Exp(0.5), need_h, True, tier="f32")
    _check(whole, chunked, 1e-6)
    _check(_jax_plain_f32(m_new, x, "exp0.5", need_h, True), chunked, F32_TOL)


def test_cpu_wrapper_runs_the_plain_version_in_plain_f32():
    """Plain f32 on a CPU tensor of f32 X (the moments hand-off) runs the
    plain version and launches nothing."""
    m_new, x = _inputs(80, 1001, 9)
    tm, tx = torch.from_numpy(m_new), torch.from_numpy(x)
    K.reset_launch_counts()
    out = K.rotated_moments_sums(tm, tx, td.Tanh(), True, True)
    ref = K.streaming_fused_sums_plain(tm, tm, tx, td.Tanh(), True, True, "f32", True)[2:]
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert K.streaming_fused_sums.launches == 0
    assert K.streaming_fused_sums.launches_by_tier == {"f32": 0, "bf16x3": 0, "bf16": 0}


# ---------------------------------------------------------------------------
# The loglik kernel (kernel 9) on the route: bf16 X and f32 X.
# ---------------------------------------------------------------------------

LL_TOL = 2e-5


# The loglik kernel on bf16 X (rotate_plain_wgmma_kernel's log-lik mode):
# 64-column tiles, consumer c of three taking tiles c, c + 3, ... of a
# group.
PLAIN_TILE, PLAIN_CONSUMERS = 64, 3


def _steps_rotate(w, x):
    """W X as the wgmma kernels sum it: each 16-deep k step's products in a
    fresh sum, the steps added to the f32 result in order."""
    out = 0.0
    for s in range(0, x.shape[0], STEP):
        out = out + w[:, s:s + STEP] @ x[s:s + STEP]
    return out


def _consumer_row_sums(v, s):
    """Each row's sum of ``v`` over the columns ``s`` as the log-lik mode
    on bf16 X adds it: f32 over each 64-column tile, each consumer's tiles
    in f64, the consumers' sums in order, rounded once."""
    u = v[:, s]
    tiles = u.reshape(u.shape[0], -1, PLAIN_TILE).sum(dim=2).double()
    total = 0.0
    for c in range(PLAIN_CONSUMERS):
        total = total + tiles[:, c::PLAIN_CONSUMERS].sum(dim=1)
    return total.float()


def _emulate_loglik(m, x, density, need_ysq):
    """The loglik kernel in torch, on the CPU: the ``planes=False`` plan's
    groups; Y = bf16(M) X on bf16 X (exact bf16 products, a fresh f32 sum
    a 16-deep k step) or, on f32 X, the f32 tier's rotation (hi / mid / lo
    of M and X, six products a 16-deep k step in a fresh sum); log_lik(Y)
    masked at padded rows and at columns >= T (log_lik(0) != 0), and Y^2;
    each row's sums per group in the kernels' order (bf16 X:
    :func:`_consumer_row_sums`; f32 X: f32 over 128-column tiles, f64
    across them, :func:`_row_sums`), the groups folded pairwise."""
    n, t = x.shape
    tier = "bf16" if x.dtype == torch.bfloat16 else "f32"
    plan = K.stream_tc_plan(n, t, False, tier, planes=False)
    assert plan.ws_bytes == 0 and plan.groups_per_chunk == plan.n_parts
    cols, width = plan.cols_per_group, plan.n_parts * plan.cols_per_group
    xc = torch.nn.functional.pad(x.float(), (0, width - t))
    if tier == "f32":
        y = _x6_rotate(_padded_planes(K._split3_bf16(m), plan.n_pad), K._split3_bf16(xc))
    else:
        y = _steps_rotate(_padded_planes([K._bf16(m.float())], plan.n_pad)[0], xc)
    valid = (torch.arange(plan.n_pad) < n)[:, None] & (torch.arange(width) < t)[None]
    ll = torch.where(valid, density.log_lik(y), 0.0)
    assert not y[~valid].any()  # zeros past n and t: Y^2 needs no mask

    def folded(v):
        groups = [slice(g * cols, (g + 1) * cols) for g in range(plan.n_parts)]
        if tier == "f32":
            return fold_pairwise(torch.stack([_row_sums(v[:n], s, True) for s in groups]))
        return fold_pairwise(torch.stack([_consumer_row_sums(v[:n], s) for s in groups]))

    return folded(ll), folded(y * y) if need_ysq else torch.zeros(n)


def _jax_loglik(m, x, dens, need_ysq, bf16_x):
    xj = jnp.asarray(x).astype(jnp.bfloat16) if bf16_x else jnp.asarray(x)
    return pk.streaming_loglik_sums(jnp.asarray(m), xj, DENS[dens][0], need_ysq,
                                    interpret=True)


def _loglik_case(n, t, seed, bf16_x):
    m, x = _inputs(n, t, seed)
    tx = torch.from_numpy(x)
    return m, x, torch.from_numpy(m), tx.to(torch.bfloat16) if bf16_x else tx


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n,t", WIDE_SHAPES)
def test_emulated_loglik_matches_jax_and_plain(n, t, dens, bf16_x):
    m, x, tm, tx = _loglik_case(n, t, n + t + 2, bf16_x)
    tden = DENS[dens][1]
    got = _emulate_loglik(tm, tx, tden, True)
    _check(_jax_loglik(m, x, dens, True, bf16_x), got, LL_TOL)
    _check(K.streaming_loglik_sums_plain(tm, tx, tden, True), got, LL_TOL)


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
def test_emulated_loglik_flags(need_ysq, bf16_x):
    m, x, tm, tx = _loglik_case(80, 1001, 10, bf16_x)
    got = _emulate_loglik(tm, tx, td.Tanh(), need_ysq)
    _check(_jax_loglik(m, x, "tanh", need_ysq, bf16_x), got, LL_TOL)
    if not need_ysq:
        assert not got[1].any()


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_emulated_loglik_at_the_group_cap(monkeypatch, bf16_x):
    """A launch takes at most 65,535 groups: with a cap of 5, 2,049 columns
    go to 5 groups of 512 instead of 17 of 128, and give the same sums."""
    m, x, tm, tx = _loglik_case(80, 2049, 11, bf16_x)
    monkeypatch.setattr(K, "STREAM_TC_LOGLIK_COLS", 128)
    narrow = _emulate_loglik(tm, tx, td.Cube(), True)
    assert K.stream_tc_plan(80, 2049, False, planes=False).n_parts == 17
    monkeypatch.setattr(K, "_MAX_GRID_Y", 5)
    plan = K.stream_tc_plan(80, 2049, False, planes=False)
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (512, 5, 5)
    capped = _emulate_loglik(tm, tx, td.Cube(), True)
    _check(narrow, capped, 1e-6)
    _check(_jax_loglik(m, x, "cube", True, bf16_x), capped, LL_TOL)


LOGLIK_PLAN_CASES = [  # (n, t)
    (65, 1), (65, 127), (128, 1024), (129, 1025), (256, 2_000_000), (306, 1_000_003),
    (1024, 200_000), (1344, 30_000_000), (1344, 100_000_000), (700, 9_999_999),
]


@pytest.mark.parametrize("n,t", LOGLIK_PLAN_CASES)
def test_loglik_plan_invariants(n, t):
    """The loglik kernel's partition: whole tiles covering T once, groups
    of at least STREAM_TC_LOGLIK_COLS columns where T allows (then a
    multiple of three 64-column tiles), at most 65,535 of them in the one
    launch, and no workspace."""
    plan = K.stream_tc_plan(n, t, False, "f32", planes=False)
    tile = K.STREAM_TC_TILE
    assert plan.n_pad % tile == 0 and n <= plan.n_pad < n + tile
    assert plan.cols_per_group % tile == 0
    assert (plan.n_parts - 1) * plan.cols_per_group < t <= plan.n_parts * plan.cols_per_group
    assert 1 <= plan.n_parts == plan.groups_per_chunk <= 65535
    assert plan.ws_bytes == 0
    assert plan.cols_per_group >= min(K.STREAM_TC_LOGLIK_COLS, -(-t // tile) * tile)
    if plan.cols_per_group == K.STREAM_TC_LOGLIK_COLS:
        # whole tiles of both kernels, and as many for each of the bf16 X
        # kernel's three consumers
        assert plan.cols_per_group % (3 * PLAIN_TILE) == plan.cols_per_group % WGMMA_TILE == 0
    assert plan == K.stream_tc_plan(n, t, True, "bf16", planes=False)  # H and the tier: no say


def test_loglik_plan_of_the_fits():
    """256 x 2,000,000 (phases 5 and 5c) in 1,303 groups of 1,536 columns
    (24 of the bf16 X kernel's 64-column tiles, 8 a consumer), 1024 x
    200,000 in 131."""
    assert K.stream_tc_plan(256, 2_000_000, False, planes=False) == K.StreamTcPlan(
        256, 1536, 1303, 1303, 0)
    assert K.stream_tc_plan(1024, 200_000, False, planes=False) == K.StreamTcPlan(
        1024, 1536, 131, 131, 0)


def test_cpu_loglik_wrapper_runs_the_plain_version():
    """On CPU tensors of either dtype the loglik wrapper runs the plain
    version and launches nothing."""
    K.reset_launch_counts()
    for bf16_x in (False, True):
        _, _, tm, tx = _loglik_case(80, 1001, 12, bf16_x)
        out = K.streaming_loglik_sums(tm, tx, td.Tanh(), True)
        ref = K.streaming_loglik_sums_plain(tm, tx, td.Tanh(), True)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert K.streaming_loglik_sums.launches == 0
    assert K.streaming_loglik_sums.launches_by_tier == {"bf16": 0, "f32": 0}


class _Recorder:
    """Stands in for the kernels' library and ``_run``: records each C
    entry's name and arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            return 0
        entry.__name__ = name
        return entry

    def run(self, entry, *args, device):
        self.calls.append((entry.__name__, args))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(K, "_lib", lambda: rec)
    monkeypatch.setattr(K, "_run", rec.run)
    planes, layouts = [], []

    def spy(layout):
        real = getattr(K, layout)

        def weights(p, n, n_pad, device):
            planes.append([v.to(torch.float32) for v in p])
            w = real(p, n, n_pad, device)
            layouts.append((layout, tuple(w.shape)))
            return w
        monkeypatch.setattr(K, layout, weights)

    spy("_tc_weights")
    spy("_wgmma_weights")
    rec.planes, rec.layouts = planes, layouts
    return rec


def _meta(v):
    return v.to("meta")


@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_loglik_wrapper_routes_both_dtypes(recorder, bf16_x):
    """A non-CPU tensor of either dtype takes the route's loglik entry: the
    bf16 tier on bf16 X with M rounded to bf16 (one (n_pad, kp) plane, read
    through W's tensor map), the f32 tier on f32 X with M's hi / mid / lo
    (three planes in the wgmma launch's layout, ``_wgmma_weights``), the
    ``planes=False`` plan's groups, one launch counted by tier; then the
    fold."""
    n, t = 257, 3000
    _, _, tm, tx = _loglik_case(n, t, 13, bf16_x)
    K.reset_launch_counts()
    ll, ysq = K.streaming_loglik_sums(_meta(tm), _meta(tx), td.Exp(0.5), True)
    assert ll.shape == ysq.shape == (n,)
    tier = "bf16" if bf16_x else "f32"
    plan = K.stream_tc_plan(n, t, False, tier, planes=False)
    (name, args), (fold, _) = recorder.calls
    assert name == "picard_streaming_loglik_tc" and fold == "picard_fold_pairwise"
    assert args[:8] == (K._TIERS[tier], 1, 1, 0.5, n, t, plan.cols_per_group, plan.n_parts)
    assert K.streaming_loglik_sums.launches == 1
    assert K.streaming_loglik_sums.launches_by_tier == {"bf16": int(bf16_x), "f32": int(not bf16_x)}
    (planes,) = recorder.planes  # meta tensors hold no values: their count and shapes
    assert len(planes) == (1 if bf16_x else 3)
    assert all(p.shape == (n, n) for p in planes)
    (layout,) = recorder.layouts
    if bf16_x:
        assert layout == ("_tc_weights", (1, plan.n_pad, -(-n // 64) * 64))
    else:  # (row block, 16-deep k step, plane, 128 x 16 tile in core matrices)
        assert layout == ("_wgmma_weights", (plan.n_pad // 128, -(-n // 16), 3, 16, 2, 8, 8))


def test_plain_f32_wrapper_takes_the_route(recorder):
    """Plain f32 on a non-CPU f32 tensor (the moments hand-off) takes the
    tensor-core entry in plain mode (delta = 0) at the f32 tier with M_new's
    three planes and the f32 plan, counted on the route."""
    n, t = 130, 5000
    m_new, x = _inputs(n, t, 14)
    tm = _meta(torch.from_numpy(m_new))
    K.reset_launch_counts()
    out = K.rotated_moments_sums(tm, _meta(torch.from_numpy(x)), td.Tanh(), True, True)
    assert [tuple(v.shape) for v in out] == [(n, n), (n,), (n, n), (n,)]
    plan = K.stream_tc_plan(n, t, True, "f32")
    (name, args), (fold, _) = recorder.calls
    assert name == "picard_streaming_fused_tc" and fold == "picard_fold_pairwise"
    assert args[:4] == (0, K._TIERS["f32"], K._TIERS["f32"], 0)
    assert args[9:13] == (t, plan.cols_per_group, plan.n_parts, plan.groups_per_chunk)
    assert len(recorder.planes[0]) == 3
    assert K.streaming_fused_sums.launches_by_tier == {"f32": 1, "bf16x3": 0, "bf16": 0}


# Every (mode, requested tier, X dtype) of the wrapper: (absolute_ll,
# precision, bf16 X) -> (rotation tier, contraction tier, weight planes).
ALL_PAIRS = [
    (True, "bf16", True, "bf16", "bf16", 1),
    (True, "f32", True, "bf16", "bf16", 1),
    (True, "bf16x3", True, "bf16", "bf16x3", 1),
    (False, "bf16", True, "bf16", "bf16", 2),
    (False, "f32", True, "bf16", "bf16", 2),
    (False, "bf16x3", True, "bf16", "bf16x3", 2),
    (True, "bf16", False, "bf16", "bf16", 1),
    (True, "bf16x3", False, "bf16x3", "bf16x3", 2),
    (True, "f32", False, "f32", "f32", 3),
    (False, "bf16", False, "bf16", "bf16", 2),
    (False, "bf16x3", False, "bf16x3", "bf16x3", 4),
    (False, "f32", False, "f32", "f32", 6),
]


def test_tc_route_takes_delta_f32_on_f32_x(recorder):
    """A non-CPU tensor takes the tensor-core entry in every (mode, tier,
    X dtype) pair, delta f32 on f32 X among them: the mode, the rotation
    tier (bf16 on bf16 X), the contraction tier (bf16 for an f32 request
    on bf16 X) and X's dtype passed to the entry, the weights' parts at
    the rotation tier, the plan of the contraction tier's workspace, and
    the launch counted by mode and contraction tier."""
    n, t = 130, 3001
    (m_new, m_old, x), _ = _delta_case(n, t, 15)
    tm, to = (_meta(torch.from_numpy(v)) for v in (m_new, m_old))
    for absolute_ll, precision, bf16_x, rot, ct, n_planes in ALL_PAIRS:
        tx = torch.from_numpy(x).to(torch.bfloat16 if bf16_x else torch.float32)
        recorder.calls.clear()
        recorder.planes.clear()
        recorder.layouts.clear()
        K.reset_launch_counts()
        out = K.streaming_fused_sums(tm, to, _meta(tx), td.Tanh(), True, True, precision,
                                     absolute_ll)
        assert [tuple(v.shape) for v in out] == [(n,), (n,), (n, n), (n,), (n, n), (n,)]
        plan = K.stream_tc_plan(n, t, True, ct)
        (name, args), (fold, _) = recorder.calls
        assert name == "picard_streaming_fused_tc" and fold == "picard_fold_pairwise"
        assert args[:4] == (int(not absolute_ll), K._TIERS[rot], K._TIERS[ct], int(bf16_x))
        assert args[9:13] == (t, plan.cols_per_group, plan.n_parts, plan.groups_per_chunk)
        assert len(recorder.planes[0]) == n_planes
        # the wgmma launch A's pairs take its layout: (row block, k step,
        # plane, 16 row groups, 2 k halves, 8 x 8 core matrix); plain bf16
        # on bf16 X runs launch A on wgmma too, reading the one (n_pad, kp)
        # bf16 plane through a tensor map of 64-column boxes (kp a multiple
        # of 64); every other pair takes that layout on mma.sync
        wgmma = not absolute_ll and not bf16_x and ct in ("bf16x3", "f32")
        assert K._wgmma_pair(not absolute_ll, rot, ct, bf16_x) == wgmma
        plain_wgmma = absolute_ll and bf16_x and ct == "bf16"
        (layout, shape), = recorder.layouts
        if wgmma:
            assert layout == "_wgmma_weights"
            assert shape == (plan.n_pad // 128, -(-n // 16), n_planes, 16, 2, 8, 8)
        else:
            assert layout == "_tc_weights"
            assert shape == (n_planes, plan.n_pad, -(-n // 64) * 64)
            if plain_wgmma:
                assert shape == (1, plan.n_pad, -(-n // K.STREAM_TC_KC) * K.STREAM_TC_KC)
        assert K.streaming_fused_sums.launches == 1
        assert K.streaming_fused_sums.launches_by_tier[ct] == 1
        mode = "plain" if absolute_ll else "delta"
        assert K.streaming_fused_sums.launches_by_mode[mode][ct] == 1
        # launch B: one a chunk, by the contraction tier
        assert K.streaming_fused_sums.contract_launches_by_tier == {
            tier: plan.n_parts // plan.groups_per_chunk * (tier == ct) for tier in K._TIERS}


# ---------------------------------------------------------------------------
# The six other pairs: delta and plain bf16 on f32 X (a kernel_precision=
# "bf16" fit's tries, and a direct call), plain bf16x3 on f32 X, delta bf16
# on bf16 X, delta and plain bf16x3 on bf16 X (the rotation at the bf16
# tier, the contraction at bf16x3).
# ---------------------------------------------------------------------------

# (id, precision, absolute_ll, bf16 X)
OTHER_PAIRS = [
    ("delta-bf16-f32x", "bf16", False, False),
    ("plain-bf16-f32x", "bf16", True, False),
    ("plain-bf16x3-f32x", "bf16x3", True, False),
    ("delta-bf16-bf16x", "bf16", False, True),
    ("delta-bf16x3-bf16x", "bf16x3", False, True),
    ("plain-bf16x3-bf16x", "bf16x3", True, True),
]
PAIR_IDS = [p[0] for p in OTHER_PAIRS]


def _pair_case(n, t, seed, bf16_x):
    """M_new, M_old near the identity and X (bf16 with ``bf16_x``), as
    NumPy f32 and as torch tensors."""
    m_new, m_old, x = _delta_inputs(n, t, seed)
    tx = torch.from_numpy(x)
    return (m_new, m_old, x), (torch.from_numpy(m_new), torch.from_numpy(m_old),
                               tx.to(torch.bfloat16) if bf16_x else tx)


def _jax_pair(m_new, m_old, x, dens, need_h, need_ysq, precision, absolute_ll, bf16_x):
    xj = jnp.asarray(x).astype(jnp.bfloat16) if bf16_x else jnp.asarray(x)
    return pk.streaming_fused_sums(jnp.asarray(m_new), jnp.asarray(m_old), xj, DENS[dens][0],
                                   need_h, need_ysq, interpret=True, precision=precision,
                                   absolute_ll=absolute_ll)


def _pair_tol(precision):
    """1e-3 for a bf16 contraction, 2e-5 for a bf16x3 one."""
    return BF16_TOL if precision == "bf16" else X3_TOL


def _run_pair(tm, to, tx, density, need_h, need_ysq, precision, absolute_ll):
    return _emulate(tm, tx, density, need_h, need_ysq, m_old=None if absolute_ll else to,
                    tier=precision)


@pytest.mark.parametrize("dens", list(DENS))
@pytest.mark.parametrize("n,t", WIDE_SHAPES)
@pytest.mark.parametrize("pair", OTHER_PAIRS, ids=PAIR_IDS)
def test_emulated_other_pairs_match_jax_and_plain(pair, n, t, dens):
    _, precision, absolute_ll, bf16_x = pair
    (m_new, m_old, x), (tm, to, tx) = _pair_case(n, t, n + t + 3, bf16_x)
    tden = DENS[dens][1]
    got = _run_pair(tm, to, tx, tden, True, True, precision, absolute_ll)
    tol = _pair_tol(precision)
    _check(_jax_pair(m_new, m_old, x, dens, True, True, precision, absolute_ll, bf16_x), got,
           tol)
    _check(K.streaming_fused_sums_plain(tm, to, tx, tden, True, True, precision, absolute_ll),
           got, tol)


@pytest.mark.parametrize("need_ysq", [False, True], ids=["no-ysq", "ysq"])
@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
@pytest.mark.parametrize("pair", OTHER_PAIRS, ids=PAIR_IDS)
def test_emulated_other_pairs_flags(pair, need_h, need_ysq):
    _, precision, absolute_ll, bf16_x = pair
    (m_new, m_old, x), (tm, to, tx) = _pair_case(80, 1001, 16, bf16_x)
    got = _run_pair(tm, to, tx, td.Tanh(), need_h, need_ysq, precision, absolute_ll)
    _check(_jax_pair(m_new, m_old, x, "tanh", need_h, need_ysq, precision, absolute_ll,
                     bf16_x), got, _pair_tol(precision))
    if not need_h:
        assert not got[4].any()
    if not need_ysq:
        assert not got[1].any() and not got[5].any()
    elif absolute_ll:
        assert torch.equal(got[1], got[5])  # plain mode: dysq = ysq = sum Y^2


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
@pytest.mark.parametrize("pair", OTHER_PAIRS, ids=PAIR_IDS)
def test_emulated_other_pairs_in_chunks(monkeypatch, pair, need_h):
    """Groups of 128 columns and a workspace of two groups of the
    contraction tier's planes: 2,049 columns in 17 groups run as 9
    chunks, and give the unchunked sums."""
    _, precision, absolute_ll, bf16_x = pair
    (m_new, m_old, x), (tm, to, tx) = _pair_case(80, 2049, 17, bf16_x)
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 128)
    whole = _run_pair(tm, to, tx, td.Exp(0.5), need_h, True, precision, absolute_ll)
    ct = K._tiers(tx, precision)[0]
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX",
                        2 * 128 * 2 * (1 + need_h) * 128 * K._TC_ELEM_BYTES[ct])
    plan = K.stream_tc_plan(80, 2049, need_h, ct)
    assert (plan.cols_per_group, plan.n_parts, plan.groups_per_chunk) == (128, 17, 2)
    chunked = _run_pair(tm, to, tx, td.Exp(0.5), need_h, True, precision, absolute_ll)
    _check(whole, chunked, 1e-6)
    _check(_jax_pair(m_new, m_old, x, "exp0.5", need_h, True, precision, absolute_ll, bf16_x),
           chunked, _pair_tol(precision))


@pytest.mark.parametrize("pair", OTHER_PAIRS, ids=PAIR_IDS)
def test_cpu_wrapper_runs_the_plain_version_in_other_pairs(pair):
    """On a CPU tensor each of the six pairs runs the plain version and
    launches nothing."""
    _, precision, absolute_ll, bf16_x = pair
    _, (tm, to, tx) = _pair_case(80, 1001, 18, bf16_x)
    K.reset_launch_counts()
    out = K.streaming_fused_sums(tm, to, tx, td.Tanh(), True, True, precision, absolute_ll)
    ref = K.streaming_fused_sums_plain(tm, to, tx, td.Tanh(), True, True, precision,
                                       absolute_ll)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert K.streaming_fused_sums.launches == 0


# ---------------------------------------------------------------------------
# Launch B alone (``picard_stream_contract_tc``): the workspace, the plain
# version and the wrapper.
# ---------------------------------------------------------------------------


def _contract_case(monkeypatch, n, t, tier, need_h, seed):
    """Random operands (psi, Y and with H psi', Y^2: standard normal) in
    a workspace of groups of 128 columns, two groups a chunk."""
    monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 128)
    n_pad = -(-n // 128) * 128
    monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX",
                        2 * 128 * 2 * (1 + need_h) * K._TC_ELEM_BYTES[tier] * n_pad)
    plan = K.stream_tc_plan(n, t, need_h, tier)
    assert plan.groups_per_chunk == 2 and plan.n_parts == -(-t // 128)
    gen = torch.Generator().manual_seed(seed)
    ops = [torch.randn(n, t, generator=gen) for _ in range(2 * (1 + need_h))]
    return plan, ops, K.contract_workspace(ops, tier, plan)


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
@pytest.mark.parametrize("tier", ["bf16", "bf16x3", "f32"])
def test_contract_plain_version_gives_each_groups_partials(monkeypatch, tier, need_h):
    """The workspace holds each operand's parts at the tier, zero past N
    and T, chunk by chunk; the plain version's partial of group i is the
    sum over its 128 columns of the operands' part products (hi*hi +
    lo*hi + hi*lo at bf16x3), held to the same sums in f64."""
    n, t = 65, 1001
    plan, ops, ws = _contract_case(monkeypatch, n, t, tier, need_h, 3)
    assert ws.shape == (4, 2 * (1 + need_h) * (2 if tier == "bf16x3" else 1), 128, 256)
    assert ws.dtype == (torch.float32 if tier == "f32" else torch.bfloat16)
    assert not ws[:, :, n:].any() and not ws[-1, :, :, t - 3 * 256:].any()
    parts = (lambda v: (v,)) if tier == "f32" else PARTS[tier]  # noqa: E731
    out = K.stream_contract_sums_plain(ws, n, tier, need_h, 128, plan.n_parts)
    assert len(out) == 2 and (out[1] is None) == (not need_h)
    for m, got in enumerate(out[: 1 + need_h]):
        assert got.shape == (plan.n_parts, n, n) and got.dtype == torch.float32
        for i in range(plan.n_parts):
            s = slice(128 * i, min(t, 128 * (i + 1)))
            a, b = (parts(ops[2 * m + o][:, s]) for o in (0, 1))
            a, b = [v.double() for v in a], [v.double().T for v in b]
            want = a[0] @ b[0] + (a[1] @ b[0] + a[0] @ b[1] if tier == "bf16x3" else 0)
            np.testing.assert_allclose(got[i].double().numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("need_h", [False, True], ids=["no-h", "h"])
@pytest.mark.parametrize("tier", ["bf16", "bf16x3", "f32"])
def test_contract_wrapper_launches_the_entry(monkeypatch, recorder, tier, need_h):
    """A non-CPU workspace takes ``picard_stream_contract_tc``: the tier,
    H, N, the group width, the groups, the groups a chunk, the three
    pointers (no H pointer without H) and the partials' stride N^2; one
    launch counted; (n_parts, N, N) partials of G and of H."""
    n, t = 130, 1001
    plan, _, ws = _contract_case(monkeypatch, n, t, tier, need_h, 4)
    K.reset_launch_counts()
    g, h = K.stream_contract_sums(_meta(ws), n, tier, need_h, 128, plan.n_parts)
    ((name, args),) = recorder.calls
    assert name == "picard_stream_contract_tc"
    assert args[:6] == (K._TIERS[tier], int(need_h), n, 128, plan.n_parts, 2)
    assert (args[8] is None) == (not need_h) and args[9] == n * n
    assert g.shape == (plan.n_parts, n, n) and (h is None) == (not need_h)
    assert K.stream_contract_sums.launches == 1


# (label, change to the call) that the wrapper refuses before a launch.
CONTRACT_REFUSED = [
    ("tier", {"tier": "f16"}),
    ("n", {"n": 129}),
    ("cols", {"cols": 96}),
    ("h planes", {"need_h": True}),
    ("groups", {"n_parts": 9}),
    ("dtype", {"dtype": torch.float16}),
]


@pytest.mark.parametrize("label,change", CONTRACT_REFUSED, ids=[c[0] for c in CONTRACT_REFUSED])
def test_contract_wrapper_refuses_a_mismatched_workspace(monkeypatch, recorder, label, change):
    """A workspace whose shape or dtype does not fit the call (N's padded
    rows, the planes of the tier and H, whole groups, the chunks of the
    groups, the tier's element) raises and launches nothing."""
    plan, _, ws = _contract_case(monkeypatch, 65, 1001, "bf16x3", False, 5)
    call = {"n": 65, "tier": "bf16x3", "need_h": False, "cols": 128, "n_parts": plan.n_parts}
    call.update(change)
    ws = _meta(ws.to(change.pop("dtype", ws.dtype)))
    call.pop("dtype", None)
    with pytest.raises((ValueError, TypeError)):
        K.stream_contract_sums(ws, **call)
    assert not recorder.calls


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_fused_wrapper_counts_launch_b_a_chunk(monkeypatch, recorder, chunked):
    """The fused route counts its launch B once a chunk, by the
    contraction tier: 4,099 columns in 33 groups of 128 take 17 chunks of
    two groups."""
    n, t = 80, 4099
    (m_new, m_old, x), _ = _delta_case(n, t, 16)
    if chunked:
        monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", 128)
        monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", 2 * 128 * 2 * 4 * 128)
    K.reset_launch_counts()
    K.streaming_fused_sums(*(_meta(torch.from_numpy(v)) for v in (m_new, m_old, x)),
                           td.Tanh(), False, False, "bf16x3", False)
    chunks = 17 if chunked else 1
    assert K.streaming_fused_sums.contract_launches_by_tier == {"f32": 0, "bf16x3": chunks,
                                                                "bf16": 0}
