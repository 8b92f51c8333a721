"""The tensor-core route of streaming_fused_sums, on the CPU.

The route (``csrc/streaming_fused_tc.cu``: plain mode, bf16 tier, bf16
X) runs only on the card. What surrounds it is held here:

  * :func:`ops.kernels.stream_tc_plan`'s invariants: the groups cover T
    once in whole tiles, a chunk is whole groups, and the workspace stays
    under its cap;
  * a torch emulation of the two launches (the plan's groups and chunks,
    bf16 psi and Y, with H psi' and Y^2, in a workspace with exact zeros
    at padded rows and columns, per-group row sums and products, the
    groups folded pairwise) against
    ``picard_ica_tpu.ops.pallas_kernels.streaming_fused_sums(...,
    precision="bf16", absolute_ll=True, interpret=True)`` on bf16 X and
    against ``streaming_fused_sums_plain``.

Tolerance: 1e-3 of each output's largest entry, the bf16-X rule of
tests/test_torch_streaming.py (psi and Y are rounded to bf16 after
rotations whose f32 sums are ordered differently). The CUDA kernels are
held against the plain version on the card by
tests/test_torch_stream_tc_cuda.py and chip_smoke.py.
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

DENS = {"tanh": (jd.Tanh(), td.Tanh()), "exp0.5": (jd.Exp(0.5), td.Exp(0.5)),
        "cube": (jd.Cube(), td.Cube())}
BF16_TOL = 1e-3
# One 128-row block with padded rows, a second block, ragged T.
SHAPES = [(65, 777), (80, 2049), (130, 4099)]


def _inputs(n, t, seed):
    rng = np.random.default_rng(seed)
    m_new = (np.eye(n) + 0.8 / np.sqrt(n) * rng.standard_normal((n, n))).astype(np.float32)
    x = (rng.laplace(size=(n, t)) / np.sqrt(2.0)).astype(np.float32)
    return m_new, x


def _emulate(m_new, x, density, need_h, need_ysq):
    """The route's two launches in torch, on the CPU: per chunk of whole
    groups, launch A's workspace (bf16 psi and Y, with H psi' and Y^2;
    zeros at padded rows and columns, psi' masked there) and its row sums
    per group, launch B's products per group; every output's groups
    folded pairwise."""
    n, t = x.shape
    plan = K.stream_tc_plan(n, t, need_h)
    cols = plan.cols_per_group
    w = torch.zeros((plan.n_pad, n))
    w[:n] = K._bf16(m_new.float())
    xf = x.float()
    live = (torch.arange(plan.n_pad) < n)[:, None]
    parts = [[] for _ in range(6)]
    for g0 in range(0, plan.n_parts, plan.groups_per_chunk):
        g1 = min(g0 + plan.groups_per_chunk, plan.n_parts)
        c0, c1 = g0 * cols, g1 * cols
        xc = torch.nn.functional.pad(xf[:, c0:min(c1, t)], (0, c1 - min(c1, t)))
        y = w @ xc  # products of bf16 values are exact in f32
        psi, psid, ll = density.score_der_loglik(y)
        valid = live & (torch.arange(c0, c1) < t)[None]
        ll = torch.where(valid, ll, 0.0)
        psid = torch.where(valid, psid, 0.0)
        ws = [K._bf16(psi), K._bf16(y)] + ([K._bf16(psid), K._bf16(y * y)] if need_h else [])
        assert len(ws) * plan.n_pad * (c1 - c0) * 2 <= plan.ws_bytes
        for v in ws:  # the workspace is exactly zero past n and t
            assert not v[~valid].any()
        for g in range(g1 - g0):
            s = slice(g * cols, (g + 1) * cols)
            ysq = (y[:n, s] * y[:n, s]).sum(dim=1)
            parts[0].append(ll[:n, s].sum(dim=1))
            parts[1].append(ysq)
            parts[2].append(ws[0][:n, s] @ ws[1][:n, s].T)
            parts[3].append(psid[:n, s].sum(dim=1))
            if need_h:
                parts[4].append(ws[2][:n, s] @ ws[3][:n, s].T)
            parts[5].append(ysq)
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
    assert K.streaming_fused_sums.launches_by_route == {"scalar": 0, "tc": 0}


def _col_bytes(plan, need_h):
    return 2 * (1 + need_h) * plan.n_pad * 2


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


@pytest.mark.parametrize("n,t,need_h,cap,group_cols", PLAN_CASES)
def test_plan_invariants(monkeypatch, n, t, need_h, cap, group_cols):
    if cap is not None:
        monkeypatch.setattr(K, "STREAM_TC_WORKSPACE_MAX", cap)
    if group_cols is not None:
        monkeypatch.setattr(K, "STREAM_TC_GROUP_COLS", group_cols)
    plan = K.stream_tc_plan(n, t, need_h)
    tile = K.STREAM_TC_TILE
    assert plan.n_pad % tile == 0 and n <= plan.n_pad < n + tile
    # the groups cover T exactly once, in whole tiles
    assert plan.cols_per_group % tile == 0
    assert (plan.n_parts - 1) * plan.cols_per_group < t <= plan.n_parts * plan.cols_per_group
    # a chunk is whole groups, and a launch's grid takes them
    assert 1 <= plan.groups_per_chunk <= min(plan.n_parts, 65535)
    # the workspace of one chunk, under the cap
    assert plan.ws_bytes == plan.groups_per_chunk * plan.cols_per_group * _col_bytes(plan, need_h)
    assert plan.ws_bytes <= K.STREAM_TC_WORKSPACE_MAX
    # groups of at least STREAM_TC_GROUP_COLS columns where T and the cap allow
    fit = K.STREAM_TC_WORKSPACE_MAX // (_col_bytes(plan, need_h) * tile) * tile
    assert plan.cols_per_group >= min(K.STREAM_TC_GROUP_COLS, -(-t // tile) * tile, fit)
    # the partials stay under their cap unless the workspace cap forced narrower groups
    partials = plan.n_parts * (1 + need_h) * n * n * 4
    assert partials <= max(K.STREAM_PARTIALS_MAX, (1 + need_h) * n * n * 4) or (
        plan.cols_per_group == fit)
