"""JADE (Joint Approximate Diagonalization of Eigenmatrices) warm start,
on torch tensors.

Counterpart of ``picard_ica_tpu/models/jade.py``, with its design
rather than the reference's (src/jade.rs):

  * the fourth-order cumulant matrices come from one Gram of pair
    products, ``Q[(i,j),(k,l)] = E[x_i x_j x_k x_l]`` for the P =
    N(N+1)/2 pairs i <= j against all N^2 pairs, one (P, chunk) x
    (chunk, N^2) product per T chunk; the delta corrections for
    whitened data are sparse updates;
  * the rotated tensor R = V^T Q V is carried and conjugated by each
    round's rotation instead of rebuilt from Q through V;
  * a sweep is N-1 round-robin rounds of N/2 disjoint planes rotated
    together by one block rotation G, with the JAX package's
    orientation fix (``docs/JADE_ORIENTATION.md``).

Everything runs on ``x``'s device in its dtype, every product in exact
f32 (or f64). Sample-sharded (``data_sharding``, a
``parallel.sharding.SampleShards``), each rank's Gram over its own
columns is all-reduced before the division by the global T: one
(P, N^2) all-reduce, the JAX package's psum.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.linalg import sym_decorrelation_with_mineig
from ..ops.precision import exact_f32
from ..parallel.sharding import all_reduced, n_samples

_ANGLE_EPS = 1e-15  # jade.rs:175


def _pair_indices(n: int):
    """All (i, j) with i <= j in the reference's order (jade.rs:101-102)."""
    ps, qs = [], []
    for i in range(n):
        for j in range(i, n):
            ps.append(i)
            qs.append(j)
    return np.asarray(ps, np.int32), np.asarray(qs, np.int32)


def _round_robin_schedule(n: int):
    """Round-robin tournament pairing: (n-1 rounds) x (n/2 disjoint
    pairs) covering every (p, q) pair exactly once per sweep.

    Returns ``(p_idx, q_idx, valid)`` arrays of shape (rounds, n//2+).
    For odd n a phantom player is added; its pairs are marked invalid
    and parked at p = q = 0 (rotated by the identity).
    """
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    p_rounds, q_rounds, valid_rounds = [], [], []
    for _ in range(m - 1):
        ps, qs, valids = [], [], []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            p, q = min(a, b), max(a, b)
            ok = q < n  # phantom = m-1 when n is odd
            ps.append(p if ok else 0)
            qs.append(q if ok else 0)
            valids.append(ok)
        p_rounds.append(ps)
        q_rounds.append(qs)
        valid_rounds.append(valids)
        players = [players[0], players[-1]] + players[1:-1]
    return (
        np.asarray(p_rounds, np.int32),
        np.asarray(q_rounds, np.int32),
        np.asarray(valid_rounds, bool),
    )


@exact_f32()
def _pair_product_gram(x, chunk_size: int = 4096):
    """Gram of pair products ``sum_t (x_i x_j)_t (x_k x_l)_t`` for the
    P rows with i <= j (row (i,j) equals row (j,i)) against all N^2
    columns: shape (P, N^2), summed over T chunks of ``chunk_size``
    columns, the last one zero-padded (zero samples add nothing), so
    only one chunk's (N^2, chunk) products are alive at a time."""
    n, t = x.shape
    pair_i, pair_j = _pair_indices(n)
    rows = torch.as_tensor(pair_i.astype(np.int64) * n + pair_j, device=x.device)
    chunk = min(chunk_size, t)
    gram = torch.zeros((rows.shape[0], n * n), dtype=x.dtype, device=x.device)
    for start in range(0, t, chunk):
        xc = x[:, start:start + chunk]
        if xc.shape[1] < chunk:
            xc = torch.nn.functional.pad(xc, (0, chunk - xc.shape[1]))
        z = (xc[:, None, :] * xc[None, :, :]).reshape(n * n, chunk)
        gram.addmm_(z[rows], z.T)  # (P, chunk) x (chunk, N^2)
        del z
    return gram


def compute_cumulant_matrices(x, chunk_size: int = 4096, data_sharding=None):
    """Symmetrized cumulant matrices for all pairs i <= j, shape (P, N, N).

    Assumes whitened input, i.e. E[x_a x_b] = delta_ab, exactly like the
    reference (jade.rs:83-86). With ``data_sharding`` ``x`` is this
    rank's column block and the Gram is all-reduced.
    """
    n = x.shape[0]
    pair_i, pair_j = _pair_indices(n)
    p_count = pair_i.shape[0]
    # Row p of the half-pair Gram is E[x_i x_j x_k x_l] * T over (k, l).
    q = all_reduced(_pair_product_gram(x, chunk_size), data_sharding)
    q = q.reshape(p_count, n, n)
    q /= n_samples(x, data_sharding)

    # Whitened-data delta corrections (jade.rs:114-120), applied sparsely:
    #   - delta_ij delta_kl: subtract I for diagonal pairs (i == j)
    #   - delta_ik delta_jl: subtract 1 at [i, j]
    #   - delta_il delta_jk: subtract 1 at [j, i]
    # The last two are separate updates, so a diagonal pair loses 2 at
    # [i, i].
    dev = x.device
    pi = torch.as_tensor(pair_i, dtype=torch.int64, device=dev)
    pj = torch.as_tensor(pair_j, dtype=torch.int64, device=dev)
    rows = torch.arange(p_count, device=dev)
    diag_pairs = torch.as_tensor(np.flatnonzero(pair_i == pair_j), device=dev)
    q.diagonal(dim1=1, dim2=2)[diag_pairs] -= 1.0
    q[rows, pi, pj] -= 1.0
    q[rows, pj, pi] -= 1.0

    # Symmetrize (jade.rs:124-125).
    return (q + q.transpose(1, 2)) / 2.0


@exact_f32()
def _jacobi_sweeps(cumulants, n: int, max_iter: int, tol: float, verbose: bool):
    """Joint diagonalization by parallel-order Jacobi sweeps; returns
    (V, n_sweeps).

    The JAX package's formulation (its ``_jacobi_sweeps`` says why the
    reference's sequential pair order is not used, and why G is
    [[c, -s], [s, c]] on each plane): a sweep is N-1 rounds of N/2
    disjoint planes; each round's angles come from the carried R =
    V^T Q V, its planes form one block rotation G, and V <- V G,
    R <- G^T R G.

    ``cumulants`` is consumed: R is conjugated in its buffer, so the
    sweeps hold two (P, N, N) tensors, R and R G. Sweeps stop after
    ``max_iter`` or once a sweep's largest angle falls below ``tol``
    (compared in ``cumulants``' dtype): one host sync a sweep.
    """
    dtype, dev = cumulants.dtype, cumulants.device
    p_sched, q_sched, valid_sched = (
        torch.as_tensor(a, device=dev) for a in _round_robin_schedule(n))
    p_sched, q_sched = p_sched.long(), q_sched.long()
    tol = float(torch.tensor(tol, dtype=dtype))
    zero = torch.zeros((), dtype=dtype, device=dev)

    v = torch.eye(n, dtype=dtype, device=dev)
    r = cumulants
    rg = torch.empty_like(r)
    sweep, last_max = 0, float("inf")
    while sweep < max_iter and last_max >= tol:
        max_theta = zero
        for p, q, valid in zip(p_sched, q_sched, valid_sched):
            # 2x2 objective per pair, accumulated over all rotated
            # cumulants (jade.rs:144-167).
            h_pq = r[:, p, q] + r[:, q, p]          # (P, n//2)
            h_ppqq = r[:, p, p] - r[:, q, q]
            g00 = torch.sum(h_pq * h_pq, dim=0)
            g01 = torch.sum(h_pq * h_ppqq, dim=0)
            g11 = torch.sum(h_ppqq * h_ppqq, dim=0)

            diff = g11 - g00
            near_zero = (g01.abs() < _ANGLE_EPS) & (diff.abs() < _ANGLE_EPS)
            angle = torch.where(valid & ~near_zero,
                                0.25 * torch.atan2(2.0 * g01, diff), zero)
            c, s = torch.cos(angle), torch.sin(angle)

            # One block rotation for all planes of the round: c at p and
            # q on the diagonal, +/- s off it. Accumulating updates, so
            # a phantom pair parked at p = q = 0 (c = 1, s = 0) adds
            # exactly nothing even where index 0 also is a real plane's.
            diag = torch.ones(n, dtype=dtype, device=dev)
            diag.index_add_(0, p, c - 1.0).index_add_(0, q, c - 1.0)
            g = torch.diag(diag)
            g.index_put_((q, p), s, accumulate=True)
            g.index_put_((p, q), -s, accumulate=True)

            v = v @ g
            torch.matmul(r, g, out=rg)
            torch.matmul(g.T, rg, out=r)
            max_theta = torch.maximum(max_theta, angle.abs().max())
        sweep += 1
        last_max = float(max_theta)
        if verbose:
            print(f"JADE iteration {sweep}: max angle = {last_max:.4e}", file=sys.stderr)
    return v, sweep


@exact_f32()
def jade(x, max_iter: int, tol: float = 1e-6, verbose: bool = False,
         data_sharding=None):
    """Run JADE on whitened data; returns (W, min_eig) (jade.rs:22-72).

    ``min_eig`` is the minimum eigenvalue of the final symmetric
    decorrelation, for the caller's singularity check. W is the
    decorrelated V^T: V's columns span the whitened mixing basis, so its
    transpose unmixes (the JAX package's fix; the reference returns V).
    With ``data_sharding`` the cumulant Gram is sample-sharded; the
    sweeps run on every rank on the same reduced cumulants.
    """
    n = x.shape[0]
    if n < 2:
        return (torch.eye(n, dtype=x.dtype, device=x.device),
                torch.ones((), dtype=x.dtype, device=x.device))

    cumulants = compute_cumulant_matrices(x, data_sharding=data_sharding)
    if verbose:
        print(f"JADE: {cumulants.shape[0]} cumulant matrices computed", file=sys.stderr)
    v, _ = _jacobi_sweeps(cumulants, n, max_iter, tol, verbose)
    del cumulants
    return sym_decorrelation_with_mineig(v.T)
