"""The data passes of a fit: CUDA kernels and plain versions.

Counterpart of ``picard_ica_tpu/ops/pallas_kernels.py``: every kernel
the JAX package writes in Pallas. The core loop up to N = 64, one
tensor-core kernel in four modes (``csrc/rotated_fused_tc.cu``), whose
f32 tier is the TPU's ``Precision.HIGHEST``, six bf16 products of
three-way splits, against the plain versions' exact f32 products:

  * :func:`rotated_fused_sums`   — one line-search try in one read of X
    (replaces ``rotated_fused_sums``, pallas_kernels.py:838-955), its
    delta and plain modes, every tier; the main path's tries (delta mode
    on f32 X at the f32 and bf16x3 tiers, without H:
    :func:`_core_wgmma_pair`) run ``csrc/rotated_fused_wgmma.cu``'s kernel
    on ``wgmma`` instead;
  * :func:`rotated_moments_sums` — moments of Y = W X at stage
    boundaries (replaces ``rotated_moments_sums``, :306-395), the plain
    mode without the log-lik: on f32 X rotation and contractions at the
    f32 tier, on bf16 X a bf16 rotation and f32 contractions;
  * :func:`rotated_loglik_sums`  — loss re-baselines (replaces
    ``rotated_loglik_sums``, :674-719), the rotation (f32 tier on f32 X,
    bf16 on bf16 X) and a log-lik epilogue, no contraction.

The core loop above N = 64 (``csrc/streaming_fused_tc.cu``), where W
no longer fits whole in shared memory:

  * :func:`streaming_fused_sums` — kernel 1's outputs with W in row
    blocks (replaces ``streaming_fused_sums``, :1061-1183), in every
    (mode, tier, X dtype) pair as two GEMM-shaped tensor-core launches
    planned by :func:`stream_tc_plan`: the rotation at the rotation tier
    (bf16 on bf16 X) with the density and row sums into a workspace of
    psi / Y planes at the contraction tier (bf16; hi and lo at bf16x3;
    f32 at f32, split three ways by the contraction), then G (H) over
    it (launch B, ``contract_wgmma_kernel`` on ``wgmma``);
  * :func:`stream_contract_sums` — launch B alone, over a workspace the
    caller fills (:func:`contract_workspace`): each group's partials of
    G (H), for the tests, ``chip_smoke.py`` and ``port_turns.py``;
  * :func:`streaming_loglik_sums` — kernel 3's outputs for large N
    (replaces ``streaming_loglik_sums``, :1205-1274), on ``wgmma``: the
    log-lik modes of the route's two ``wgmma`` launch A kernels
    (``picard_streaming_loglik_tc``), on bf16 X at the bf16 tier and on
    f32 X at the f32 tier, with no workspace.

The three ``rotated_*`` wrappers hand off to the streaming ones, on
every device, when N > :data:`KERNEL_MAX_N` or when their per-block
(N, N) partials would pass :data:`RESIDENT_PARTIALS_MAX` — the JAX
package's rule (:330-342, :685-688, :868-875) with the port's own
resident capacity. The moments take the fused kernel's plain mode with
``m_old = w`` and keep its last four outputs. Counters count the kernel
that ran: a streamed call raises ``streaming_*.launches``.

Device whitening (``csrc/covariance_sums.cu``):

  * :func:`row_sums` — per-row sums, the mean's numerator (replaces
    ``row_sums``, :398-434);
  * :func:`centered_covariance_sums` — (X - mean)(X - mean)^T with the
    centering on chip (replaces ``centered_covariance_sums``,
    :555-648);
  * :func:`covariance_sums` — X X^T (replaces ``covariance_sums``,
    :544-610);
  * :func:`_grouped_covariance` — either covariance with one partial per
    group of column chunks (replaces ``_grouped_covariance``,
    :468-541); the two covariance wrappers hand off to it for
    N > 512 or partials above 2 GB, as in the JAX package.

Each returns UNNORMALIZED sums over T, so callers divide by T (or
reduce across devices first). For each there is:

  * the wrapper, which runs the plain PyTorch version ONLY for a tensor
    on the CPU, and for a CUDA tensor launches the kernel or raises (no
    fallback);
  * the plain version (``*_plain``), the same formulation as the TPU
    kernel with an explicit bf16 split for the bf16x3 tier; the CPU
    tests and ``chip_smoke.py`` hold the kernels against it;
  * a launch counter, ``<wrapper>.launches``, raised by one at each
    kernel launch and nowhere else (``rotated_fused_sums`` also counts
    by tier, ``launches_by_tier``, and by route and tier,
    ``launches_by_route``; ``streaming_fused_sums`` by contraction
    tier, ``launches_by_tier``, and by mode and tier,
    ``launches_by_mode``, and its launch B's launches, one a chunk, by
    contraction tier, ``contract_launches_by_tier``;
    ``streaming_loglik_sums`` by X's tier, ``launches_by_tier``);
  * the fold of the kernel's per-block partials on the card, in
    :func:`ops.moments.fold_pairwise`'s order and bitwise equal to it:
    the core kernels write all their outputs side by side into one
    packed (n_parts, L) buffer (:func:`packed_offsets`) that one launch
    of the fold kernel folds (:func:`fold_partials`); the whitening C
    entries launch the fold kernel themselves.

Semantics kept from the TPU kernels: padded columns contribute nothing
(psi'(0) != 0 and log_lik(0) != 0); with bf16 X the weights are rounded
to bf16 and the rotation runs at the bf16 tier, and a requested f32
tier becomes bf16; delta mode takes dm = M_new - M_old in f32; plain
mode never reads M_old; outputs whose flag is off are zeros and cost
nothing.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .densities import Cube, Exp, Tanh
from .moments import fold_pairwise
from .precision import _bf16, _dot_bf16x3_presplit, _kernel_dot, _split3_bf16, _split_bf16

_pad = torch.nn.functional.pad

# The kernels' capacity in components: W and dm are staged whole in
# shared memory and the warps' tiles are sized for N <= 64
# (csrc/rotated_fused_tc.cu NMAX). A capacity, not a speed crossover.
KERNEL_MAX_N = 64
# Columns of X each CUDA block reduces into one partial (COLS in
# csrc/rotated_fused_tc.cu).
COLS_PER_BLOCK = 2048
# Columns of X per partial of the whitening kernels (CHUNK in
# csrc/covariance_sums.cu); the plain versions chunk alike by default.
COV_CHUNK = 2048
# Column chunks per partial of the grouped covariance (the JAX package's
# _COV_GROUP, pallas_kernels.py:437).
COV_GROUP = 16
# The covariance wrappers take the grouped kernel above this N, or when
# the per-chunk (n_chunks, N, N) f32 partials would pass this many bytes
# (pallas_kernels.py:137, 438, 590-593). Both limits come from the TPU's
# VMEM and are kept for parity; they are to be re-measured on the H100.
COV_RESIDENT_MAX_N = 512
RESIDENT_PARTIALS_MAX = 2 * 1024**3

# The streaming kernels' declared capacity in components
# (csrc/streaming_fused_tc.cu picard_stream_max_n).
STREAM_MAX_N = 1344
# Height of the zero-padded W row blocks of the plain versions (the JAX
# package's _STREAM_NB).
STREAM_ROWS = 128
# Tiles of X per G/H partial of the fused plain version (the JAX
# package's _STREAM_GROUP).
STREAM_GROUP = 16
# More tiles go to a partial of the plain version, and more columns to a
# group of the tensor-core route, when the (n_groups, N, N) f32 partials
# of one call would pass this many bytes (1024 x 200,000: 25 tiles).
STREAM_PARTIALS_MAX = 1024**3
# Columns per tile of the loglik plain version, which parks no Y tile.
STREAM_LOGLIK_TILE = 128
# The tensor-core route of the fused kernel (csrc/streaming_fused_tc.cu:
# TILE, A_KC): W row blocks and the contraction's output tiles are
# STREAM_TC_TILE wide, groups are whole STREAM_TC_TILE-column tiles, and
# W is zero-padded along k to a multiple of STREAM_TC_KC.
STREAM_TC_TILE = 128
STREAM_TC_KC = 64
# The delta pairs on f32 X at the bf16x3 and f32 tiers (WGMMA_PAIRS) run
# launch A on wgmma (csrc/streaming_fused_tc.cu rotate_wgmma_kernel, G_KS),
# and so does the loglik kernel on f32 X: its W is zero-padded along k to a
# multiple of STREAM_TC_WGMMA_KS and laid out in the order the kernel copies
# and reads it (_wgmma_weights).
STREAM_TC_WGMMA_KS = 16
WGMMA_PAIRS = ("bf16x3", "f32")
# Columns per partial (group) of the route, at least: a group is the
# contraction's K, so its (N, N) partial is written once per this many
# columns.
STREAM_TC_GROUP_COLS = 4096
# The route's psi and Y planes (psi', Y^2 with H; bf16, as hi and lo at
# the bf16x3 tier, f32 at the f32 tier) of a call are kept under this
# many bytes; a larger call runs in chunks of whole groups.
STREAM_TC_WORKSPACE_MAX = 2 * 1024**3
# Columns per partial of the loglik kernel on the route, at least: its
# partials are (N,) rows, so a group's width sets only the work of a block
# and the number of blocks. 1,536 columns are 24 of the bf16 X kernel's
# 64-column tiles, 8 for each of its three consumers (1,024 left one
# consumer 6 tiles to the others' 5), and 12 of the f32 X kernel's
# 128-column tiles; at 128 x 1,000,000 they still fill ~5 waves of the
# card's 132 blocks (PERF.md §6).
STREAM_TC_LOGLIK_COLS = 1536
# Groups one launch may take (a CUDA grid's y extent).
_MAX_GRID_Y = 65535
# The fused plain version's tile rule (stream_tile): a model of a Y tile
# of ceil(N/64)*64 rows and its staging under a block's 227 KB of shared
# memory, which fixes the order of that version's sums.
_STREAM_SMEM_MAX = 232448
_STREAM_KC, _STREAM_PASS, _STREAM_CB = 16, 8192, 64

_TIERS = {"f32": 0, "bf16x3": 1, "bf16": 2}
# Kernel 1's routes: csrc/rotated_fused_wgmma.cu for _core_wgmma_pair,
# csrc/rotated_fused_tc.cu for every other pair.
CORE_ROUTES = ("wgmma", "mma.sync")
# Workspace bytes of one element of an operand (psi, Y, psi', Y^2) on the
# tensor-core route, by tier: one bf16 plane, hi and lo bf16 planes, one
# f32 plane.
_TC_ELEM_BYTES = {"bf16": 2, "bf16x3": 4, "f32": 4}


def work_dtype(x):
    """bf16 X still accumulates and reduces in f32."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def _zeros(shape, x):
    return torch.zeros(shape, dtype=work_dtype(x), device=x.device)


def _tiers(x, precision: str):
    """(contraction tier, rotation tier): with bf16 X a requested f32
    becomes bf16 and the rotation runs at the bf16 tier."""
    if x.dtype == torch.bfloat16:
        return ("bf16" if precision == "f32" else precision), "bf16"
    return precision, precision


def _mats(x, *mats):
    """The weights in X's working dtype: with bf16 X rounded to bf16 (the
    TPU kernel's ``m.astype(x.dtype)``)."""
    if x.dtype == torch.bfloat16:
        return [_bf16(m.to(torch.float32)) for m in mats]
    return [m.to(x.dtype) for m in mats]


def _delta_mats(x, m_new, m_old):
    """Delta mode's ``(M_old, dM = M_new - M_old)`` in X's working dtype.
    On f32 X, dM is taken in the weights' own dtype before the conversion,
    so that the small steps of an f64 W (models/core) keep their digits;
    on bf16 X both weights are rounded first, as in :func:`_mats`."""
    if x.dtype == torch.bfloat16:
        mn, mo = _mats(x, m_new, m_old)
        return mo, mn - mo
    return m_old.to(x.dtype), (m_new - m_old).to(x.dtype)


def _weights(x, *mats):
    """X and the weights in the working dtype (:func:`_mats`); bf16 X is
    widened exactly."""
    return x.to(work_dtype(x)), _mats(x, *mats)


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------


def rotated_moments_sums_plain(w, x, density, need_h: bool, need_ysq: bool):
    """(G_sum, pm_sum, H_sum, ysq_sum) of Y = W X: the rotation in exact
    f32 (bf16 products for bf16 X), contractions in exact f32/f64."""
    n = x.shape[0]
    acc = work_dtype(x)
    xf, (wf,) = _weights(x, w)
    y = _kernel_dot(wf, xf, acc, "bf16" if x.dtype == torch.bfloat16 else "f32")
    psi, psi_d = density.score_and_der(y)
    g = psi @ y.T
    pm = psi_d.sum(dim=1)
    h = psi_d @ (y * y).T if need_h else _zeros((n, n), x)
    ysq = (y * y).sum(dim=1) if need_ysq else _zeros((n,), x)
    return g, pm, h, ysq


def rotated_loglik_sums_plain(m, x, density, need_ysq: bool):
    """(loglik_rowsums, ysq_rowsums) of Y = M X."""
    n = x.shape[0]
    acc = work_dtype(x)
    xf, (mf,) = _weights(x, m)
    y = _kernel_dot(mf, xf, acc, "bf16" if x.dtype == torch.bfloat16 else "f32")
    ll = density.log_lik(y).sum(dim=1)
    ysq = (y * y).sum(dim=1) if need_ysq else _zeros((n,), x)
    return ll, ysq


def rotated_fused_sums_plain(m_new, m_old, x, density, need_h: bool,
                             need_ysq: bool, precision: str = "f32",
                             absolute_ll: bool = False):
    """``(dll, dysq, g, pm, h, ysq)`` of one line-search try.

    Delta mode: dll/dysq are the row sums of the analytic
    ``log_lik(M_new X) - log_lik(M_old X)`` and of ``(2 Y_old + dY) dY``
    from ``Y_old = M_old X`` and ``dY = (M_new - M_old) X``. Plain mode
    (``absolute_ll``): the absolute ``log_lik(M_new X)`` and
    ``(M_new X)^2`` row sums; ``m_old`` is not read. g/pm/h/ysq are the
    raw moment sums of ``M_new X`` at the tier.
    """
    n = x.shape[0]
    acc = work_dtype(x)
    precision, rot = _tiers(x, precision)

    def tdot(a, b, tier):
        return _kernel_dot(a, b, acc, tier)

    if absolute_ll:
        xf, (mn,) = _weights(x, m_new)
        y_new = tdot(mn, xf, rot)
        psi, psi_d, ll = density.score_der_loglik(y_new)
        dll = ll.sum(dim=1)
        dysq = (y_new * y_new).sum(dim=1) if need_ysq else _zeros((n,), x)
    else:
        xf = x.to(acc)
        mo, dm = _delta_mats(x, m_new, m_old)
        if rot == "bf16x3" and acc != torch.float64:
            # One shared hi/lo split of X feeds both rotations.
            x_pair = _split_bf16(xf)
            y_old = _dot_bf16x3_presplit(_split_bf16(mo), x_pair, acc)
            dy = _dot_bf16x3_presplit(_split_bf16(dm), x_pair, acc)
        else:
            y_old = tdot(mo, xf, rot)
            dy = tdot(dm, xf, rot)
        y_new = y_old + dy
        psi, psi_d, dll_el = density.score_der_loglik_delta(y_old, dy)
        dll = dll_el.sum(dim=1)
        dysq = (
            ((2.0 * y_old + dy) * dy).sum(dim=1) if need_ysq
            else _zeros((n,), x)
        )
    g = tdot(psi, y_new.T, precision)
    pm = psi_d.sum(dim=1)
    ysq_new = y_new * y_new
    ysq = ysq_new.sum(dim=1) if need_ysq else _zeros((n,), x)
    h = tdot(psi_d, ysq_new.T, precision) if need_h else _zeros((n, n), x)
    return dll, dysq, g, pm, h, ysq


def _n_chunks(t: int, chunk: int) -> int:
    return -(-t // chunk)


def _chunk_products(x, chunk: int):
    """(n_chunks, N, N) per-chunk products ``X_c X_c^T`` in X's dtype;
    the last chunk is the ragged tail (nothing is padded, so nothing
    padded can add to the sums)."""
    n, t = x.shape
    full = (t // chunk) * chunk
    parts = []
    if full:
        body = x[:, :full].reshape(n, full // chunk, chunk).transpose(0, 1)
        parts.append(torch.bmm(body, body.transpose(1, 2)))
    if full < t:
        tail = x[:, full:]
        parts.append((tail @ tail.T)[None])
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def row_sums_plain(x, chunk: int = COV_CHUNK):
    """Per-row sums of X: one partial per ``chunk`` columns in X's dtype,
    folded pairwise."""
    n, t = x.shape
    full = (t // chunk) * chunk
    parts = []
    if full:
        parts.append(x[:, :full].reshape(n, full // chunk, chunk).sum(dim=2).T)
    if full < t:
        parts.append(x[:, full:].sum(dim=1)[None])
    return fold_pairwise(torch.cat(parts))


def covariance_sums_plain(x, chunk: int = COV_CHUNK):
    """``X X^T``: one (N, N) partial per ``chunk`` columns, folded
    pairwise."""
    return fold_pairwise(_chunk_products(x, chunk))


def centered_covariance_sums_plain(x, mean):
    """``(X - mean)(X - mean)^T``; the mean is cast to X's dtype first
    (pallas_kernels.py:647)."""
    return covariance_sums_plain(x - mean.to(x.dtype)[:, None])


def grouped_covariance_plain(x, mean=None):
    """The covariance (centered when ``mean`` is given) with one partial
    per :data:`COV_GROUP` chunks: the chunk products are added in order
    within a group, and the groups are folded pairwise."""
    if mean is not None:
        x = x - mean.to(x.dtype)[:, None]
    p = _chunk_products(x, COV_CHUNK)
    n_groups = _n_chunks(p.shape[0], COV_GROUP)
    pad = n_groups * COV_GROUP - p.shape[0]
    if pad:  # exact zeros: the in-order sums of the last group are unchanged
        p = torch.cat([p, p.new_zeros((pad,) + p.shape[1:])])
    p = p.reshape(n_groups, COV_GROUP, *p.shape[1:])
    acc = p[:, 0]
    for k in range(1, COV_GROUP):
        acc = acc + p[:, k]
    return fold_pairwise(acc)


def stream_tile(n: int) -> int:
    """Columns of X per tile of the fused plain version: the largest of
    128, 64 and 32 whose Y tile and staging fit the shared-memory model
    (N <= 256 -> 128, <= 704 -> 64, <= 1344 -> 32). Only the order of the
    plain version's sums follows from it."""
    ny = -(-n // _STREAM_CB) * _STREAM_CB
    for bt in (128, 64, 32):
        rot = 2 * (_STREAM_PASS // bt) * _STREAM_KC + _STREAM_KC * bt
        con = 2 * _STREAM_CB * (bt + 4)
        if 4 * (ny * (bt + 4) + max(rot, con)) <= _STREAM_SMEM_MAX:
            return bt
    raise ValueError(f"N={n} exceeds the streaming kernels' capacity "
                     f"STREAM_MAX_N={STREAM_MAX_N}")


def stream_group(n_tiles: int, n: int, n_mats: int) -> int:
    """Tiles per partial of the fused plain version: :data:`STREAM_GROUP`,
    or more when ``n_mats`` (N, N) partials per group would pass
    :data:`STREAM_PARTIALS_MAX`."""
    group = min(STREAM_GROUP, n_tiles)
    if n_mats:
        max_groups = max(1, STREAM_PARTIALS_MAX // (n_mats * n * n * 4))
        group = max(group, _n_chunks(n_tiles, max_groups))
    return group


class StreamTcPlan(NamedTuple):
    """How the tensor-core route cuts one call (:func:`stream_tc_plan`)."""

    n_pad: int             # N rounded up to whole STREAM_TC_TILE blocks
    cols_per_group: int    # columns of X per partial, whole tiles
    n_parts: int           # groups (partials) covering T
    groups_per_chunk: int  # groups one pair of launches takes
    ws_bytes: int          # the workspace of one chunk


def stream_tc_plan(n: int, t: int, need_h: bool, tier: str = "bf16",
                   planes: bool = True) -> StreamTcPlan:
    """The tensor-core route's partition of T: groups of at least
    :data:`STREAM_TC_GROUP_COLS` columns (fewer for a smaller T), more
    where the (n_parts, N, N) f32 partials would pass
    :data:`STREAM_PARTIALS_MAX` or a launch would take more than 65,535
    groups, and fewer where one group's workspace would pass
    :data:`STREAM_TC_WORKSPACE_MAX`, which wins; then as many whole groups
    per chunk as the workspace cap holds. The workspace is 2 (4 with H)
    planes of (n_pad, groups_per_chunk * cols_per_group): bf16 at the bf16
    tier, twice as many (hi and lo) at bf16x3, f32 at f32.

    With ``planes=False``, the loglik kernel's partition: no workspace
    and no (N, N) partials, so groups of at least
    :data:`STREAM_TC_LOGLIK_COLS` columns, more where one launch would
    take more than 65,535 groups, all in one chunk."""
    tile = STREAM_TC_TILE
    n_pad = _n_chunks(n, tile) * tile
    if not planes:
        want = max(STREAM_TC_LOGLIK_COLS, _n_chunks(t, _MAX_GRID_Y))
        cols = min(_n_chunks(want, tile), _n_chunks(t, tile)) * tile
        n_parts = _n_chunks(t, cols)
        return StreamTcPlan(n_pad, cols, n_parts, n_parts, 0)
    n_mats = 1 + need_h
    col_bytes = 2 * n_mats * _TC_ELEM_BYTES[tier] * n_pad
    max_groups = min(_MAX_GRID_Y, max(1, STREAM_PARTIALS_MAX // (n_mats * n * n * 4)))
    want = max(STREAM_TC_GROUP_COLS, _n_chunks(t, max_groups))
    fit = STREAM_TC_WORKSPACE_MAX // (col_bytes * tile) * tile
    cols = max(tile, min(_n_chunks(want, tile) * tile, _n_chunks(t, tile) * tile, fit))
    n_parts = _n_chunks(t, cols)
    per_chunk = max(1, min(n_parts, _MAX_GRID_Y,
                           STREAM_TC_WORKSPACE_MAX // (cols * col_bytes)))
    return StreamTcPlan(n_pad, cols, n_parts, per_chunk, per_chunk * cols * col_bytes)


def _tile_row_sums(v, bt: int, n_tiles: int):
    """(rows, >= n_tiles * bt) -> (n_tiles, rows) row sums of each tile."""
    return v[:, : n_tiles * bt].reshape(v.shape[0], n_tiles, bt).sum(dim=2).T


def _grouped_tile_products(a, b, bt: int, group: int, tier: str, acc):
    """``sum over tiles of a_tile b_tile^T`` at the tier: added in order
    within groups of ``group`` tiles, the groups folded pairwise. The
    column count of ``a`` and ``b`` is a whole number of groups."""
    n_groups = a.shape[1] // (group * bt)
    a4 = a.reshape(a.shape[0], n_groups, group, bt)
    b4 = b.reshape(b.shape[0], n_groups, group, bt)
    total = None
    for k in range(group):
        p = _kernel_dot(a4[:, :, k].transpose(0, 1), b4[:, :, k].permute(1, 2, 0),
                        acc, tier)
        total = p if total is None else total + p
    return fold_pairwise(total)


def _row_blocks(mats, n: int):
    """The weights zero-padded to whole :data:`STREAM_ROWS`-row blocks,
    as a list of row blocks per matrix."""
    npad = _n_chunks(n, STREAM_ROWS) * STREAM_ROWS
    padded = [_pad(m, (0, 0, 0, npad - n)) for m in mats]
    return [[m[r: r + STREAM_ROWS] for m in padded]
            for r in range(0, npad, STREAM_ROWS)]


def streaming_fused_sums_plain(m_new, m_old, x, density, need_h: bool,
                               need_ysq: bool, precision: str = "f32",
                               absolute_ll: bool = False):
    """:func:`rotated_fused_sums_plain`'s outputs in the streaming
    formulation (pallas_kernels.py:958-1183): W zero-padded to 128-row
    blocks; per block, the rotation, the density and the per-tile row
    statistics (dll, dysq, pm, ysq), folded pairwise over tiles; then psi
    and psi' recomputed from the assembled Y, and G (H) summed in order
    within groups of :func:`stream_group` tiles of :func:`stream_tile`
    columns, the groups folded pairwise. Everything is sliced back to N."""
    n, t = x.shape
    acc = work_dtype(x)
    precision, rot = _tiers(x, precision)
    bt = stream_tile(n)
    n_tiles = _n_chunks(t, bt)
    group = stream_group(n_tiles, n, 1 + need_h)
    tpad = _n_chunks(n_tiles, group) * group * bt
    xf = x.to(acc)
    mats = _mats(x, m_new) if absolute_ll else _delta_mats(x, m_new, m_old)
    xf = _pad(xf, (0, tpad - t))  # masked columns: X = 0, so Y = 0
    valid = torch.arange(tpad, device=x.device) < t
    # One shared hi/lo split of X feeds every rotation (:1012-1018).
    x_pair = _split_bf16(xf) if rot == "bf16x3" and acc != torch.float64 else None

    def rotate(m):
        if x_pair is not None:
            return _dot_bf16x3_presplit(_split_bf16(m), x_pair, acc)
        return _kernel_dot(m, xf, acc, rot)

    ys, stats = [], []
    for blk in _row_blocks(mats, n):
        if absolute_ll:
            y = rotate(blk[0])
            _, psi_d, ll = density.score_der_loglik(y)
            ll = torch.where(valid, ll, 0.0)  # log_lik(0) != 0
            dysq = y * y
        else:
            y_old = rotate(blk[0])
            dy = rotate(blk[1])
            y = y_old + dy
            _, psi_d, ll = density.score_der_loglik_delta(y_old, dy)
            dysq = (2.0 * y_old + dy) * dy
            del y_old, dy
        psi_d = torch.where(valid, psi_d, 0.0)  # psi'(0) != 0
        stats.append([_tile_row_sums(v, bt, n_tiles)
                      for v in (ll, dysq, psi_d, y * y)])
        ys.append(y)
        del psi_d, ll, dysq
    dll, dysq, pm, ysq = (fold_pairwise(torch.cat(parts, dim=1))[:n]
                          for parts in zip(*stats))
    # The padded rows of Y only reach the entries sliced away, so the
    # contraction reads rows [:n]; psi(0) = 0 and Y^2 = 0 at the padded
    # columns.
    y = torch.cat(ys)[:n]
    del ys, xf, x_pair
    psi, psi_d = density.score_and_der(y)
    g = _grouped_tile_products(psi, y, bt, group, precision, acc)
    del psi
    if need_h:
        h = _grouped_tile_products(psi_d, y * y, bt, group, precision, acc)
    else:
        h = _zeros((n, n), x)
    if not need_ysq:
        dysq = ysq = _zeros((n,), x)
    return dll, dysq, g, pm, h, ysq


def streaming_loglik_sums_plain(m, x, density, need_ysq: bool):
    """:func:`rotated_loglik_sums_plain`'s outputs in the streaming
    formulation (pallas_kernels.py:1186-1274): M zero-padded to 128-row
    blocks, per-tile row sums of :data:`STREAM_LOGLIK_TILE` columns
    folded pairwise, sliced back to N."""
    n, t = x.shape
    acc = work_dtype(x)
    bt = STREAM_LOGLIK_TILE
    n_tiles = _n_chunks(t, bt)
    xf, mats = _weights(x, m)
    xf = _pad(xf, (0, n_tiles * bt - t))
    valid = torch.arange(n_tiles * bt, device=x.device) < t
    rot = "bf16" if x.dtype == torch.bfloat16 else "f32"
    ll_parts, ysq_parts = [], []
    for (mb,) in _row_blocks(mats, n):
        y = _kernel_dot(mb, xf, acc, rot)
        ll_parts.append(_tile_row_sums(torch.where(valid, density.log_lik(y), 0.0),
                                       bt, n_tiles))
        ysq_parts.append(_tile_row_sums(y * y, bt, n_tiles))
    ll = fold_pairwise(torch.cat(ll_parts, dim=1))[:n]
    ysq = (fold_pairwise(torch.cat(ysq_parts, dim=1))[:n] if need_ysq
           else _zeros((n,), x))
    return ll, ysq


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    """The kernels' library, checked once against this module's
    constants (every launch asks for it: the check's ctypes calls would
    otherwise sit inside each kernel's time on the card)."""
    from . import _build

    lib = _build.load()
    if (lib.picard_max_n() != KERNEL_MAX_N
            or lib.picard_cols_per_block() != COLS_PER_BLOCK
            or lib.picard_cov_chunk() != COV_CHUNK
            or lib.picard_stream_max_n() != STREAM_MAX_N
            or lib.picard_stream_tc_tile() != STREAM_TC_TILE
            or lib.picard_stream_tc_kc() != STREAM_TC_KC
            or lib.picard_stream_wgmma_ks() != STREAM_TC_WGMMA_KS
            or any(bool(lib.picard_stream_wgmma_pair(d, _TIERS[r], _TIERS[c], xb))
                   != _wgmma_pair(bool(d), r, c, bool(xb))
                   for d in (0, 1) for r in _TIERS for c in _TIERS for xb in (0, 1))
            or any(bool(lib.picard_core_wgmma_pair(d, _TIERS[r], _TIERS[c], xb, h))
                   != _core_wgmma_pair(bool(d), r, c, bool(xb), bool(h))
                   for d in (0, 1) for r in _TIERS for c in _TIERS for xb in (0, 1)
                   for h in (0, 1))):
        raise RuntimeError("csrc/ and ops/kernels.py disagree on NMAX / "
                           "COLS_PER_BLOCK / CHUNK / the streaming tiles / "
                           "the wgmma pairs")
    return lib


def kernel_density(density) -> bool:
    """Whether the CUDA kernels implement ``density``: exactly ``Tanh``,
    ``Exp`` or ``Cube``. A subclass may override a formula, and a plugin
    (the ``Density`` protocol) has its own, which the kernels cannot run."""
    return type(density) in (Tanh, Exp, Cube)


def _density_code(density):
    if type(density) is Tanh:
        return 0, float(density.alpha)
    if type(density) is Exp:
        return 1, float(density.alpha)
    if type(density) is Cube:
        return 2, 1.0
    raise NotImplementedError(
        f"the CUDA kernels implement Tanh, Exp and Cube, not {density!r}"
    )


def _check_cuda(x, *mats, cap=KERNEL_MAX_N):
    """Validate a CUDA launch's inputs against a kernel capacity of
    ``cap`` components; returns (n, t, n_blocks of the resident
    kernels)."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (N, T), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the CUDA kernels take f32 or bf16 X, got {x.dtype} "
            "(f64 runs on the torch path: use_kernels=False)"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, t = x.shape
    if n > cap:
        raise ValueError(f"N={n} exceeds the kernels' capacity of {cap} components")
    for m in mats:
        if tuple(m.shape) != (n, n):
            raise ValueError(f"weights must be ({n}, {n}), got {tuple(m.shape)}")
        if m.device != x.device:
            raise ValueError("weights and x must be on the same device")
    return n, t, math.ceil(t / COLS_PER_BLOCK)


def _ptr(v):
    return None if v is None else v.data_ptr()


def _run(entry, *args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = entry(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{entry.__name__} failed: CUDA error {rc} "
            f"({_lib().picard_error_string(rc).decode()})"
        )


def packed_offsets(outputs):
    """``(offsets, L)``: where each output starts in one row of L floats
    of a packed (n_parts, L) partial buffer. ``outputs`` holds ``(shape,
    flag)`` per output; those whose flag is on sit side by side in order,
    and an output whose flag is off takes no room (offset None)."""
    offsets, size = [], 0
    for shape, flag in outputs:
        offsets.append(size if flag else None)
        if flag:
            size += math.prod(shape)
    return offsets, size


def unpack_folded(folded, outputs, offsets, like):
    """The outputs as views of the folded (L,) row; zeros (in the working
    dtype of ``like``) where a flag is off."""
    return tuple(folded[o: o + math.prod(shape)].view(shape) if o is not None
                 else _zeros(shape, like)
                 for (shape, _), o in zip(outputs, offsets))


def _fold_outputs(n_parts, outputs, x, launch):
    """Run ``launch(pointers, L)`` into one packed (n_parts, L) f32
    partial buffer and fold it on the card in one launch: ``pointers``
    holds each output's base address (None where its flag is off) and
    partial p of an output lies at base + p * L."""
    offsets, size = packed_offsets(outputs)
    buf = torch.empty((n_parts, size), dtype=torch.float32, device=x.device)
    launch([None if o is None else buf.data_ptr() + 4 * o for o in offsets], size)
    return unpack_folded(fold_partials(buf), outputs, offsets, x)


def _fused_outputs(n, need_h, need_ysq):
    """The fused kernels' six outputs (dll, dysq, G, pm, H, ysq) as
    ``(shape, flag)``."""
    vec, mat = (n,), (n, n)
    return [(vec, True), (vec, need_ysq), (mat, True), (vec, True), (mat, need_h),
            (vec, need_ysq)]


def _fused_launch(entry, n_parts, m_new, m_old, x, density, need_h, need_ysq,
                  precision, absolute_ll):
    """Launch a resident fused kernel (``entry``: the ``mma.sync`` one or,
    for a :func:`_core_wgmma_pair`, the ``wgmma`` one, which take the same
    arguments) with ``n_parts`` partials per output and fold them: the
    weights of the mode (delta mode takes M_old and dM, :func:`_delta_mats`), the
    tiers of X's dtype, and the six outputs, zeros where a flag is off."""
    n, t = x.shape
    precision, rot = _tiers(x, precision)
    code, alpha = _density_code(density)
    if absolute_ll:
        w, dm = _mats(x, m_new)[0].contiguous(), None
    else:
        w, dm = (v.contiguous() for v in _delta_mats(x, m_new, m_old))
    outputs = _fused_outputs(n, need_h, need_ysq)

    def launch(ptrs, stride):
        _run(entry, int(not absolute_ll), _TIERS[rot], _TIERS[precision], code,
             int(need_h), int(need_ysq), alpha, n, t, int(x.dtype == torch.bfloat16),
             w.data_ptr(), _ptr(dm), x.data_ptr(), *ptrs, stride, n_parts,
             device=x.device)

    return _fold_outputs(n_parts, outputs, x, launch)


def rotated_fused_sums(m_new, m_old, x, density, need_h: bool, need_ysq: bool,
                       precision: str = "f32", absolute_ll: bool = False):
    """Unnormalized ``(dll, dysq, g, pm, h, ysq)`` of one line-search try
    (see :func:`rotated_fused_sums_plain` for the semantics). On the card
    a :func:`_core_wgmma_pair` runs the ``wgmma`` kernel, every other pair
    the ``mma.sync`` one."""
    if _streams(x, 1 + need_h):
        return streaming_fused_sums(m_new, m_old, x, density, need_h, need_ysq,
                                    precision, absolute_ll)
    if x.device.type == "cpu":
        return rotated_fused_sums_plain(m_new, m_old, x, density, need_h,
                                        need_ysq, precision, absolute_ll)
    _, _, nb = _check_cuda(x, m_new) if absolute_ll else _check_cuda(x, m_new, m_old)
    tier, rot = _tiers(x, precision)
    if _core_wgmma_pair(not absolute_ll, rot, tier, x.dtype == torch.bfloat16, need_h):
        entry, route = _lib().picard_rotated_fused_wgmma, "wgmma"
    else:
        entry, route = _lib().picard_rotated_fused_sums, "mma.sync"
    out = _fused_launch(entry, nb, m_new, m_old, x, density, need_h, need_ysq, precision,
                        absolute_ll)
    rotated_fused_sums.launches += 1
    rotated_fused_sums.launches_by_tier[tier] += 1
    rotated_fused_sums.launches_by_route[route][tier] += 1
    return out


def _core_wgmma_pair(delta: bool, rot: str, tier: str, x_bf16: bool, need_h: bool) -> bool:
    """Whether kernel 1's pair runs the ``wgmma`` kernel
    (``csrc/rotated_fused_wgmma.cu``): delta mode on f32 X, the rotation
    and the contraction both at a tier of :data:`WGMMA_PAIRS`, without H
    -- every try of the main path. :func:`_lib` holds csrc's
    ``picard_core_wgmma_pair`` to it."""
    return (delta and not x_bf16 and not need_h and rot == tier
            and tier in WGMMA_PAIRS)


def rotated_moments_sums(w, x, density, need_h: bool, need_ysq: bool):
    """Unnormalized ``(G_sum, pm_sum, H_sum, ysq_sum)`` of Y = W X."""
    if _streams(x, 1 + need_h):
        # The fused kernel's plain mode computes the same moment set.
        return streaming_fused_sums(w, w, x, density, need_h, need_ysq,
                                    absolute_ll=True)[2:]
    if x.device.type == "cpu":
        return rotated_moments_sums_plain(w, x, density, need_h, need_ysq)
    n, t, nb = _check_cuda(x, w)
    bf16_x = x.dtype == torch.bfloat16
    code, alpha = _density_code(density)
    wf = _mats(x, w)[0].contiguous()
    outputs = [((n, n), True), ((n,), True), ((n, n), need_h), ((n,), need_ysq)]

    def launch(ptrs, stride):
        _run(_lib().picard_rotated_moments_sums,
             _TIERS["bf16" if bf16_x else "f32"], code, int(need_h),
             int(need_ysq), alpha, n, t, int(bf16_x), wf.data_ptr(),
             x.data_ptr(), *ptrs, stride, nb, device=x.device)

    out = _fold_outputs(nb, outputs, x, launch)
    rotated_moments_sums.launches += 1
    return out


def rotated_loglik_sums(m, x, density, need_ysq: bool):
    """Unnormalized ``(loglik_rowsums, ysq_rowsums)`` of Y = M X."""
    if _streams(x, 0):
        return streaming_loglik_sums(m, x, density, need_ysq)
    if x.device.type == "cpu":
        return rotated_loglik_sums_plain(m, x, density, need_ysq)
    _, _, nb = _check_cuda(x, m)
    out = _loglik_launch(_lib().picard_rotated_loglik_sums, nb, m, x, density, need_ysq)
    rotated_loglik_sums.launches += 1
    return out


def _loglik_launch(entry, n_parts, m, x, density, need_ysq):
    """Launch the resident loglik kernel (``entry``) with ``n_parts``
    partials per output and fold them; the ysq row sums are zeros when not
    asked for."""
    n, t = x.shape
    bf16_x = x.dtype == torch.bfloat16
    code, alpha = _density_code(density)
    mf = _mats(x, m)[0].contiguous()

    def launch(ptrs, stride):
        _run(entry, _TIERS["bf16" if bf16_x else "f32"], code, int(need_ysq), alpha,
             n, t, int(bf16_x), mf.data_ptr(), x.data_ptr(), *ptrs,
             stride, n_parts, device=x.device)

    return _fold_outputs(n_parts, [((n,), True), ((n,), need_ysq)], x, launch)


def _streams(x, n_mats: int) -> bool:
    """The JAX package's hand-off from the resident core kernels to the
    streaming ones: N beyond :data:`KERNEL_MAX_N`, or ``n_mats`` per-block
    (N, N) partials past :data:`RESIDENT_PARTIALS_MAX`."""
    n, t = x.shape[0], x.shape[-1]
    return (n > KERNEL_MAX_N
            or _n_chunks(t, COLS_PER_BLOCK) * n * n * 4 * n_mats > RESIDENT_PARTIALS_MAX)


def _stream_cap(x):
    if x.shape[0] > STREAM_MAX_N:
        raise ValueError(f"N={x.shape[0]} exceeds the streaming kernels' "
                         f"capacity STREAM_MAX_N={STREAM_MAX_N}")


def streaming_fused_sums(m_new, m_old, x, density, need_h: bool,
                         need_ysq: bool, precision: str = "f32",
                         absolute_ll: bool = False):
    """:func:`rotated_fused_sums` for N up to :data:`STREAM_MAX_N` (see
    :func:`streaming_fused_sums_plain`); the same return tuple. On the
    card every (mode, tier, X dtype) pair runs the tensor-core route."""
    _stream_cap(x)
    if x.device.type == "cpu":
        return streaming_fused_sums_plain(m_new, m_old, x, density, need_h,
                                          need_ysq, precision, absolute_ll)
    mats = (m_new,) if absolute_ll else (m_new, m_old)
    _check_cuda(x, *mats, cap=STREAM_MAX_N)
    out = _streaming_fused_tc(m_new, m_old, x, density, need_h, need_ysq, precision,
                              absolute_ll)
    tier = _tiers(x, precision)[0]
    streaming_fused_sums.launches += 1
    streaming_fused_sums.launches_by_tier[tier] += 1
    streaming_fused_sums.launches_by_mode["plain" if absolute_ll else "delta"][tier] += 1
    return out


def _tc_weights(planes, n: int, n_pad: int, device):
    """The weights' bf16 planes zero-padded to (n_pad, kp), kp a multiple
    of :data:`STREAM_TC_KC`, as one (len(planes), n_pad, kp) tensor."""
    kp = _n_chunks(n, STREAM_TC_KC) * STREAM_TC_KC
    w = torch.zeros((len(planes), n_pad, kp), dtype=torch.bfloat16, device=device)
    for plane, v in zip(w, planes):
        plane[:n, :n] = v  # bf16 values: the conversion is exact
    return w


def _wgmma_weights(planes, n: int, n_pad: int, device):
    """The weights' bf16 planes for ``rotate_wgmma_kernel`` (the wgmma
    launch A of :data:`WGMMA_PAIRS`, and the loglik kernel on f32 X):
    zero-padded to (n_pad, kp), kp a multiple of
    :data:`STREAM_TC_WGMMA_KS`, in the order its ring copies them, (row
    block, k step, plane, 128 x 16 tile) with
    each tile in wgmma's no-swizzle K-major layout (8 x 8 core matrices of
    16-byte rows: element (r, k) of a tile at (r // 8) * 128 + (k // 8) *
    64 + (r % 8) * 8 + k % 8), so that one stage's planes are one
    contiguous copy."""
    ks = STREAM_TC_WGMMA_KS
    kp = _n_chunks(n, ks) * ks
    w = torch.zeros((len(planes), n_pad, kp), dtype=torch.bfloat16, device=device)
    for plane, v in zip(w, planes):
        plane[:n, :n] = v  # bf16 values: the conversion is exact
    tile = STREAM_TC_TILE
    w = w.view(len(planes), n_pad // tile, tile // 8, 8, kp // ks, 2, ks // 2)
    return w.permute(1, 4, 0, 2, 5, 3, 6).contiguous()


def _wgmma_pair(delta: bool, rot: str, tier: str, x_bf16: bool) -> bool:
    """Whether kernel 8's launch A at this pair is the wgmma kernel, whose
    weights take :func:`_wgmma_weights`' layout: delta mode on f32 X, the
    rotation and the contraction both at a tier of :data:`WGMMA_PAIRS`.
    :func:`_lib` holds csrc's ``picard_stream_wgmma_pair`` to it."""
    return delta and not x_bf16 and rot == tier and tier in WGMMA_PAIRS


# A weight matrix's bf16 parts at each rotation tier: itself rounded, its
# hi / lo split, its hi / mid / lo split.
_PARTS = {"bf16": lambda m: [_bf16(m)], "bf16x3": _split_bf16, "f32": _split3_bf16}


def _streaming_fused_tc(m_new, m_old, x, density, need_h, need_ysq, precision, absolute_ll):
    """The tensor-core route: the weights in X's working dtype (rounded to
    bf16 on bf16 X, :func:`_mats`) as zero-padded (n_pad, kp) bf16 planes
    of their parts at the rotation tier (:data:`_PARTS`), M_new's in plain
    mode, M_old's then dM = M_new - M_old's (:func:`_delta_mats`) in delta mode; one
    workspace of :func:`stream_tc_plan`'s size at the contraction tier;
    both launches per chunk in one C call; the packed partials folded as
    the resident kernels'. The :data:`WGMMA_PAIRS` in delta mode on f32 X
    take the planes in :func:`_wgmma_weights`' layout."""
    n, t = x.shape
    tier, rot = _tiers(x, precision)
    plan = stream_tc_plan(n, t, need_h, tier)
    code, alpha = _density_code(density)
    if absolute_ll:
        mats = _mats(x, m_new)
    else:
        mats = list(_delta_mats(x, m_new, m_old))
    wgmma = _wgmma_pair(not absolute_ll, rot, tier, x.dtype == torch.bfloat16)
    w = (_wgmma_weights if wgmma else _tc_weights)(
        [p for m in mats for p in _PARTS[rot](m)], n, plan.n_pad, x.device)
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=x.device)

    def launch(ptrs, stride):
        _run(_lib().picard_streaming_fused_tc, int(not absolute_ll), _TIERS[rot], _TIERS[tier],
             int(x.dtype == torch.bfloat16), code, int(need_h), int(need_ysq), alpha, n, t,
             plan.cols_per_group, plan.n_parts, plan.groups_per_chunk, w.data_ptr(),
             x.data_ptr(), ws.data_ptr(), *ptrs, stride, device=x.device)

    out = _fold_outputs(plan.n_parts, _fused_outputs(n, need_h, need_ysq), x, launch)
    streaming_fused_sums.contract_launches_by_tier[tier] += _n_chunks(plan.n_parts,
                                                                      plan.groups_per_chunk)
    return out


def streaming_loglik_sums(m, x, density, need_ysq: bool):
    """:func:`rotated_loglik_sums` for N up to :data:`STREAM_MAX_N`, on
    ``wgmma``: bf16 X at the bf16 tier (M rounded to bf16, one bf16 plane
    read through a tensor map, :func:`_tc_weights`), f32 X at the f32 tier
    (M's hi / mid / lo splits in :func:`_wgmma_weights`' layout, six
    products a 16-deep step); groups of :func:`stream_tc_plan`'s
    ``planes=False`` partition, one launch."""
    _stream_cap(x)
    if x.device.type == "cpu":
        return streaming_loglik_sums_plain(m, x, density, need_ysq)
    n, t, _ = _check_cuda(x, m, cap=STREAM_MAX_N)
    tier = "bf16" if x.dtype == torch.bfloat16 else "f32"
    plan = stream_tc_plan(n, t, False, planes=False)
    code, alpha = _density_code(density)
    w = (_tc_weights if tier == "bf16" else _wgmma_weights)(
        _PARTS[tier](_mats(x, m)[0]), n, plan.n_pad, x.device)

    def launch(ptrs, stride):
        _run(_lib().picard_streaming_loglik_tc, _TIERS[tier], code, int(need_ysq), alpha, n, t,
             plan.cols_per_group, plan.n_parts, w.data_ptr(), x.data_ptr(), *ptrs, stride,
             device=x.device)

    out = _fold_outputs(plan.n_parts, [((n,), True), ((n,), need_ysq)], x, launch)
    streaming_loglik_sums.launches += 1
    streaming_loglik_sums.launches_by_tier[tier] += 1
    return out


def contract_workspace(operands, tier: str, plan: StreamTcPlan):
    """Launch A's workspace for every chunk of ``plan``, filled from
    ``operands`` ((N, T) tensors: psi, Y and, with H, psi', Y^2) as
    launch A fills it: a (n_chunks, planes, n_pad, groups_per_chunk *
    cols_per_group) tensor, chunk c holding groups c * groups_per_chunk
    on; plane operand * P + part, at the contraction tier one bf16 plane
    an operand, hi and lo bf16 planes at bf16x3, one f32 plane at f32;
    exact zeros past N and T."""
    n, t = operands[0].shape
    cols = plan.groups_per_chunk * plan.cols_per_group
    n_chunks = _n_chunks(plan.n_parts, plan.groups_per_chunk)
    split = (lambda v: (v,)) if tier == "f32" else _PARTS[tier]  # noqa: E731
    planes = [part for v in operands for part in split(v.float())]
    ws = torch.zeros((n_chunks, len(planes), plan.n_pad, cols),
                     dtype=torch.float32 if tier == "f32" else torch.bfloat16,
                     device=operands[0].device)
    for c in range(n_chunks):
        c0, c1 = c * cols, min(t, (c + 1) * cols)
        for plane, v in zip(ws[c], planes):
            plane[:n, : c1 - c0] = v[:, c0:c1]  # bf16 values at bf16 tiers: exact
    return ws


def _contract_dims(ws, n: int, tier: str, need_h: bool, cols: int, n_parts: int):
    """(parts an operand, groups a chunk) of a launch-B workspace, after
    checking its shape against the call."""
    if tier not in _TIERS:
        raise ValueError(f"unknown tier {tier!r}")
    p = 2 if tier == "bf16x3" else 1
    if ws.dim() != 4:
        raise ValueError(f"the workspace must be 4-D, got shape {tuple(ws.shape)}")
    n_chunks, n_planes, n_pad, ws_cols = ws.shape
    gpc = ws_cols // cols if cols > 0 else 0
    if (cols <= 0 or cols % STREAM_TC_TILE or ws_cols % cols or not 0 < n <= STREAM_MAX_N
            or n_pad != _n_chunks(n, STREAM_TC_TILE) * STREAM_TC_TILE
            or n_planes != 2 * (1 + need_h) * p or n_parts < 1
            or n_chunks != _n_chunks(n_parts, gpc)):
        raise ValueError(f"workspace {tuple(ws.shape)} does not fit N={n}, {tier}, "
                         f"need_h={need_h}, {n_parts} groups of {cols} columns")
    want = torch.float32 if tier == "f32" else torch.bfloat16
    if ws.dtype != want:
        raise TypeError(f"a {tier} workspace holds {want}, got {ws.dtype}")
    return p, gpc


def stream_contract_sums_plain(ws, n: int, tier: str, need_h: bool, cols: int,
                               n_parts: int, acc=torch.float32):
    """:func:`stream_contract_sums`' partials in plain PyTorch, summed in
    ``acc`` (f32 or f64): per group, psi Y^T (psi' (Y^2)^T) over its
    columns at the tier, as the kernels' other plain versions take it
    (:func:`_kernel_dot`; at bf16x3 hi*hi + lo*hi + hi*lo,
    :func:`_dot_bf16x3_presplit`)."""
    p, gpc = _contract_dims(ws, n, tier, need_h, cols, n_parts)
    out = []
    for m in range(1 + need_h):
        per_chunk = []
        for c in range(ws.shape[0]):
            ng = min(gpc, n_parts - c * gpc)

            def operand(o):  # its parts as (groups, N, cols) views
                return [ws[c, (2 * m + o) * p + pt, :n, : ng * cols].unflatten(1, (ng, cols))
                        .transpose(0, 1).to(acc) for pt in range(p)]

            a, b = operand(0), [v.transpose(1, 2) for v in operand(1)]
            per_chunk.append(_dot_bf16x3_presplit(a, b, acc) if tier == "bf16x3"
                             else _kernel_dot(a[0], b[0], acc, "f32"))
        out.append(torch.cat(per_chunk))
    return out[0], (out[1] if need_h else None)


def stream_contract_sums(ws, n: int, tier: str, need_h: bool, cols: int, n_parts: int):
    """Kernel 8's launch B alone (``picard_stream_contract_tc``): G = psi
    Y^T and, with ``need_h``, H = psi' (Y^2)^T over each group of
    ``cols`` columns at the contraction tier, from a workspace laid out
    as :func:`contract_workspace` lays it out. Returns the (n_parts, N, N)
    f32 partials of G and of H (None without ``need_h``), unfolded."""
    if ws.device.type == "cpu":
        return stream_contract_sums_plain(ws, n, tier, need_h, cols, n_parts)
    _, gpc = _contract_dims(ws, n, tier, need_h, cols, n_parts)
    if not ws.is_contiguous():
        raise ValueError("the workspace must be contiguous")
    g = torch.empty((n_parts, n, n), dtype=torch.float32, device=ws.device)
    h = torch.empty_like(g) if need_h else None
    _run(_lib().picard_stream_contract_tc, _TIERS[tier], int(need_h), n, cols, n_parts, gpc,
         ws.data_ptr(), g.data_ptr(), _ptr(h), n * n, device=ws.device)
    stream_contract_sums.launches += 1
    return g, h


def _check_stats(x, mean=None):
    """Validate a whitening kernel's inputs; returns ``(n, t, mean_f32)``."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (N, T), got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(
            f"the whitening kernels take f32 X, got {x.dtype} (f64 takes the "
            "plain torch reductions)"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, t = x.shape
    if mean is not None:
        if tuple(mean.shape) != (n,):
            raise ValueError(f"mean must have shape ({n},), got {tuple(mean.shape)}")
        if mean.device != x.device:
            raise ValueError("mean and x must be on the same device")
        mean = mean.to(torch.float32).contiguous()
    return n, t, mean


def _use_grouped(n: int, t: int) -> bool:
    """The JAX package's hand-off to the grouped covariance."""
    return (n > COV_RESIDENT_MAX_N
            or _n_chunks(t, COV_CHUNK) * n * n * 4 > RESIDENT_PARTIALS_MAX)


def fold_partials(buf):
    """Fold (n_parts, ...) f32 partials in ``fold_pairwise``'s order, bit
    for bit; the buffer is scratch and may be overwritten. For a CUDA
    tensor one launch of the fold kernel, which runs the rounds in place
    (the whitening kernels' entries run it themselves); on the CPU its
    plain version, ``fold_pairwise``."""
    if buf.device.type == "cpu":
        return fold_pairwise(buf)
    if buf.dtype != torch.float32 or not buf.is_contiguous() or buf.dim() < 1:
        raise ValueError("the fold kernel takes contiguous f32 partials")
    out = torch.empty(buf.shape[1:], dtype=torch.float32, device=buf.device)
    _run(_lib().picard_fold_pairwise, buf.shape[0], out.numel(), buf.data_ptr(),
         out.data_ptr(), device=buf.device)
    return out


def _covariance_launch(x, mean, group: int):
    n, t, mean = _check_stats(x, mean)
    n_parts = _n_chunks(_n_chunks(t, COV_CHUNK), group)
    parts = torch.empty((n_parts, n, n), dtype=torch.float32, device=x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    _run(_lib().picard_covariance_sums, n, t, x.data_ptr(), _ptr(mean), group,
         parts.data_ptr(), n_parts, out.data_ptr(), device=x.device)
    return out


def row_sums(x):
    """Unnormalized per-row sums of X (the mean's numerator)."""
    if x.device.type == "cpu":
        return row_sums_plain(x)
    n, t, _ = _check_stats(x)
    n_parts = _n_chunks(t, COV_CHUNK)
    parts = torch.empty((n_parts, n), dtype=torch.float32, device=x.device)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    _run(_lib().picard_row_sums, n, t, x.data_ptr(), parts.data_ptr(), n_parts,
         out.data_ptr(), device=x.device)
    row_sums.launches += 1
    return out


def covariance_sums(x):
    """Unnormalized ``X X^T``."""
    if _use_grouped(*x.shape):
        return _grouped_covariance(x, None)
    if x.device.type == "cpu":
        return covariance_sums_plain(x)
    out = _covariance_launch(x, None, 1)
    covariance_sums.launches += 1
    return out


def centered_covariance_sums(x, mean):
    """Unnormalized ``(X - mean)(X - mean)^T`` in one read of X."""
    if _use_grouped(*x.shape):
        return _grouped_covariance(x, mean)
    if x.device.type == "cpu":
        return centered_covariance_sums_plain(x, mean)
    out = _covariance_launch(x, mean, 1)
    centered_covariance_sums.launches += 1
    return out


def _grouped_covariance(x, mean):
    """Unnormalized covariance, centered when ``mean`` is given, with one
    partial per :data:`COV_GROUP` chunks."""
    if x.device.type == "cpu":
        return grouped_covariance_plain(x, mean)
    out = _covariance_launch(x, mean, COV_GROUP)
    _grouped_covariance.launches += 1
    return out


KERNELS = (rotated_fused_sums, rotated_moments_sums, rotated_loglik_sums,
           row_sums, centered_covariance_sums, covariance_sums,
           _grouped_covariance, streaming_fused_sums, streaming_loglik_sums,
           stream_contract_sums)


def reset_launch_counts() -> None:
    """Set every kernel's launch counter, ``rotated_fused_sums``'s and
    ``streaming_fused_sums``'s counts by tier (keyed by the tier of their
    contractions), ``rotated_fused_sums``'s by route (:data:`CORE_ROUTES`)
    and tier, ``streaming_fused_sums``'s by mode ("plain", "delta") and
    tier and its launch B's by tier, and ``streaming_loglik_sums``'s by
    tier ("bf16" on bf16 X, "f32" on f32 X) to 0."""
    for k in KERNELS:
        k.launches = 0
    rotated_fused_sums.launches_by_tier = dict.fromkeys(_TIERS, 0)
    rotated_fused_sums.launches_by_route = {r: dict.fromkeys(_TIERS, 0) for r in CORE_ROUTES}
    streaming_loglik_sums.launches_by_tier = dict.fromkeys(("bf16", "f32"), 0)
    streaming_fused_sums.launches_by_tier = dict.fromkeys(_TIERS, 0)
    streaming_fused_sums.launches_by_mode = {
        mode: dict.fromkeys(_TIERS, 0) for mode in ("plain", "delta")}
    streaming_fused_sums.contract_launches_by_tier = dict.fromkeys(_TIERS, 0)


reset_launch_counts()
