"""N x T moment contractions of the Picard inner loop, on torch tensors.

Counterpart of ``picard_ica_tpu/ops/moments.py``. Per iteration the
optimizer needs (reference: core.rs:211-276):

  * ``G_raw  = psi(Y) Y^T / T``            — relative gradient moment
  * ``pm_raw = mean(psi'(Y), axis=1)``     — E[psi'] per component
  * ``H_raw  = psi'(Y) (Y*Y)^T / T``       — Hessian moment (non-ortho)
  * ``ysq_rowmean = mean(Y*Y, axis=1)``    — extended non-ortho loss term

The sign/+1/skew fix-ups of extended mode are N x N algebra applied in
models/core.py, which keeps these passes sign-independent. The data
passes take the sum forms (:func:`raw_moment_sums`, :func:`_row_sum`)
and divide by T once; a sample-sharded fit all-reduces the sums first
and divides by the global T (``parallel/sharding.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RawMoments(NamedTuple):
    g_raw: torch.Tensor  # (N, N)   psi(Y) Y^T / T
    pm_raw: torch.Tensor  # (N,)     E[psi'(Y)] per row
    h_raw: torch.Tensor  # (N, N)   psi'(Y) (Y^2)^T / T (zeros when unused)
    ysq_rowmean: torch.Tensor  # (N,) E[Y^2] per row (zeros when unused)


def fold_pairwise(partials):
    """Tree-fold (n_chunks, ...) leading-axis partials.

    ~log2(n) vectorized adds, in the JAX package's order: rounding error
    grows O(log n * eps) instead of a running sum's O(n * eps). Folds
    the per-block partials of the CUDA kernels (ops/kernels.py).
    """
    while partials.shape[0] > 1:
        half = partials.shape[0] // 2
        folded = partials[:half] + partials[half: 2 * half]
        if partials.shape[0] % 2:
            folded[0] = folded[0] + partials[-1]
        partials = folded
    return partials[0]


def _row_sum(m):
    """``sum(m, axis=1)``: the sum form of every row mean, over the
    columns given (a sharded fit all-reduces it before it divides)."""
    return m.sum(dim=1)


def _row_mean(m):
    """``mean(m, axis=1)`` as a row sum times 1/T (at f32 the JAX
    package's ones-vector dot)."""
    return _row_sum(m) * (1.0 / m.shape[1])


def raw_moment_sums(y, density, need_h: bool, need_ysq: bool) -> RawMoments:
    """The moments of ``y`` as sums over its columns, not divided by T
    (zeros for the outputs not needed).

    ``need_h``: the Hessian moment is only needed in the non-orthogonal
    branch (core.rs:274).
    """
    n = y.shape[0]
    psi, psi_d = density.score_and_der(y)
    zeros_nn = torch.zeros((n, n), dtype=y.dtype, device=y.device)
    zeros_n = torch.zeros((n,), dtype=y.dtype, device=y.device)
    ysq = y * y if need_h or need_ysq else None
    return RawMoments(
        psi @ y.T,
        _row_sum(psi_d),
        psi_d @ ysq.T if need_h else zeros_nn,
        _row_sum(ysq) if need_ysq else zeros_n,
    )


def compute_raw_moments(y, density, need_h: bool, need_ysq_mean: bool) -> RawMoments:
    """Moments of ``y``: :func:`raw_moment_sums` times 1/T."""
    inv_t = 1.0 / y.shape[1]
    return RawMoments(*(v * inv_t for v in raw_moment_sums(y, density, need_h, need_ysq_mean)))


def loglik_rowmeans(y, density):
    """Per-component mean log-likelihood ``mean(log_lik(Y), axis=1)``;
    the loss's density term is ``sum(signs * loglik_rowmeans)``."""
    return _row_mean(density.log_lik(y))
