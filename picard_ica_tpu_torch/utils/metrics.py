"""Evaluation utilities: Amari distance, permutation alignment and the
density check.

Copy of ``picard_ica_tpu/utils/metrics.py`` (the reference's eval
helpers, src/utils.rs). These are
host-side, eval-time tools (tiny N x N work), so the data-dependent
swap loop in ``permute`` runs in NumPy rather than being forced into
compiler-friendly form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver import _resolve_device


def amari_distance(w, a) -> float:
    """Amari distance between unmixing W and mixing A (utils.rs:82-103).

    Zero iff ``W @ A`` is a scaled permutation, i.e. perfect separation.
    """
    p = np.abs(np.asarray(w) @ np.asarray(a))
    n = p.shape[0]

    def s(r):
        r_sq = r * r
        row_sum = r_sq.sum(axis=1)
        row_max = r_sq.max(axis=1)
        valid = row_max > 1e-15
        return float(np.sum(np.where(valid, row_sum / np.maximum(row_max, 1e-300) - 1.0, 0.0)))

    return (s(p) + s(p.T)) / (2.0 * n)


def permute(a, scale: bool = True):
    """Permute/scale a matrix toward identity (utils.rs:16-69).

    Greedy row swaps maximizing the diagonal, optional unit-diagonal
    scaling, then a column-sum reorder for deterministic output.
    """
    a = np.array(a, dtype=np.float64, copy=True)
    n = a.shape[0]

    done = False
    while not done:
        done = True
        for i in range(n):
            for j in range(i):
                diag_sq = a[i, i] ** 2 + a[j, j] ** 2
                off_sq = a[i, j] ** 2 + a[j, i] ** 2
                if diag_sq < off_sq:
                    a[[i, j], :] = a[[j, i], :]
                    done = False

    if scale:
        for i in range(n):
            d = a[i, i]
            if abs(d) > 1e-10:
                a[i, :] /= d

    col_sums = np.abs(a).sum(axis=0)
    order = np.argsort(col_sums, kind="stable")
    return a[np.ix_(order, order)]


def check_density(density, tol: float = None, dtype=torch.float64, device=None) -> bool:
    """Finite-difference check: score == d/dy log_lik (utils.rs:110-137).

    The JAX package picks the precision from its x64 flag; here it is
    ``dtype``. At float64 the reference's eps = 1e-7 and tol = 1e-5; at
    float32 eps = 1e-7 is below the resolution at the test points
    (spacing at y = 2 is 2.4e-7), so the check takes the f32-optimal
    central-difference step ~cbrt(eps_f32), 5e-3, and tol = 1e-3.
    ``device`` follows the fit's rule: CUDA unless given.
    """
    if dtype == torch.float64:
        eps, default_tol = 1e-7, 1e-5
    elif dtype == torch.float32:
        eps, default_tol = 5e-3, 1e-3
    else:
        raise ValueError(f"check_density runs at float32 or float64, not {dtype}")
    tol = default_tol if tol is None else tol
    device = _resolve_device(None, device)

    for y in (-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0):
        ll_plus = float(density.log_lik(torch.tensor(y + eps, dtype=dtype, device=device)))
        ll_minus = float(density.log_lik(torch.tensor(y - eps, dtype=dtype, device=device)))
        numerical = (ll_plus - ll_minus) / (2.0 * eps)
        score, _ = density.score_and_der(torch.tensor([[y]], dtype=dtype, device=device))
        if abs(numerical - float(score[0, 0])) > tol:
            return False
    return True
