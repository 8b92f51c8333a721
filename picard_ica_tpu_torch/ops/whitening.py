"""Centering and PCA whitening: the host-f64 and the device halves.

Counterpart of ``picard_ica_tpu/ops/whitening.py``. The whitening
matrix comes from the eigendecomposition of the N x N covariance
``X X^T`` in NumPy f64 on the host (the reference takes a thin SVD of X,
whitening.rs:61-65; the two are identical), with the reference's
deterministic row signs (whitening.rs:92-107). Two routes feed it:

  * :func:`preprocess_f64` centers and whitens in NumPy f64 — the
    reference-parity route the solver takes for f64 NumPy input of up
    to ``_HOST_F64_MAX_ELEMENTS`` elements with an f32 core
    (whitening.py:516-549);
  * :func:`center_whiten` works on X's device (whitening.py:62-507):
    the mean and the covariance as per-chunk partials folded pairwise,
    the host-f64 eigh, the projection ``K (X - mean)``, and for f32 data
    one refinement step in the whitened basis.

The eigenvectors of the covariance amplify its error by 1/eigengap, so
the f32 device route never takes a single f32 dot over all of T (error
~sqrt(T) eps); its reductions are chunked (error ~eps log2(n_chunks)).
Routing of the mean and the covariance (:func:`_impl_for`, the JAX
package's ``_mean_impl_for`` / ``_cov_impl_for``):

  * f64, or T <= 2048: plain torch reductions, as in the JAX package;
  * f32 on CUDA: the kernels ``ops.kernels.row_sums``,
    ``centered_covariance_sums`` and ``covariance_sums`` (the last two
    hand off to ``_grouped_covariance`` for N > 512), where the JAX
    package says "pallas";
  * f32 on the CPU: the kernels' plain versions with the JAX package's
    chunk length :func:`_chunk_len`, where it says "chunked".

The JAX package's ``max_pallas_cov_n`` and ``_warn_if_lossy_cov`` have
no counterpart: they bound its covariance kernels by the TPU's VMEM and
warn when a larger N falls back to a single f32 dot. The CUDA covariance
kernel stages 64-row slabs, so N has no shared-memory cap and there is
no fallback to warn about. Its jit packaging of the stats step
(``_prepare_stats`` / ``_center_jit``) serves the TPU and eager torch
does not need it.

Sample-sharded (``data_sharding``, a ``parallel.sharding.SampleShards``),
X is this rank's column block and the device route works in two steps:
the row sums over the local T, all-reduced, over the global T; then the
centered covariance over the local T, all-reduced (the refinement's
covariance too). The same kernels run per shard; the global T chooses
the route and the chunk length, and the host-f64 eigh on every rank
gives every rank the same K.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..errors import InvalidDimensionsError, SingularMatrixError
from .kernels import (
    centered_covariance_sums,
    covariance_sums,
    covariance_sums_plain,
    row_sums,
    row_sums_plain,
)
from ..parallel.sharding import all_reduced, n_samples as _n_samples
from . import linalg
from .linalg import rotate_rows_inplace

# Reject singular values below this (whitening.rs:77).
_MIN_SINGULAR_VALUE = 1e-10

# Covariance eigenvalues below this fraction of the largest are
# numerically zero (X X^T squares the condition number, so the rank test
# is relative; whitening.py:136-143 of the JAX package).
_RELATIVE_EIG_FLOOR = 1e-14

# Above this many elements the JAX package's "auto" whitening leaves
# the host; the port follows the same limit.
_HOST_F64_MAX_ELEMENTS = 200_000_000

# Up to this many samples the device reductions are single plain sums.
_PLAIN_MAX_T = 2048


class WhiteningResult(NamedTuple):
    """Whitened data + whitening matrix (whitening.rs:10-15)."""

    data: torch.Tensor  # (n_components, n_samples)
    whitening_matrix: torch.Tensor  # (n_components, n_features)


def whitening_matrix_from_covariance(cov, n_samples: int, n_components: int):
    """Build K from the N x N covariance ``X X^T`` (unnormalized).

    Returns ``(k_matrix, min_singular_value)`` in NumPy f64;
    ``k_matrix`` is ``None`` and ``min_singular_value`` 0.0 when the
    covariance is numerically rank-deficient. The singularity raise is
    the caller's job.
    """
    cov64 = np.asarray(cov, np.float64)
    try:
        eigenvalues, eigenvectors = np.linalg.eigh(cov64)
    except np.linalg.LinAlgError as e:
        from ..errors import ComputationError

        raise ComputationError(
            f"whitening eigendecomposition failed: {e}"
            + (
                " (input data contains non-finite values)"
                if not np.all(np.isfinite(cov64))
                else ""
            )
        ) from e
    # eigh returns ascending order; the SVD convention is descending.
    order = np.argsort(eigenvalues)[::-1][:n_components]
    top_eigs = eigenvalues[order]
    u = eigenvectors[:, order]
    s = np.sqrt(np.maximum(top_eigs, 0.0))
    min_sv = float(s[-1]) if s.size else 0.0
    if eigenvalues.size and eigenvalues[-1] > 0 and (
        top_eigs[-1] < eigenvalues[-1] * _RELATIVE_EIG_FLOOR
    ):
        min_sv = 0.0
    if min_sv < _MIN_SINGULAR_VALUE:
        return None, min_sv

    scale = np.sqrt(np.float64(n_samples))
    k = (u / s[None, :]).T * scale  # (k, n_features)
    return k * _matlab_row_signs(k), min_sv


def _matlab_row_signs(k: np.ndarray) -> np.ndarray:
    """Deterministic sign column: flip rows whose largest-|entry| is
    negative (whitening.rs:92-107, "MATLAB convention")."""
    max_idx = np.argmax(np.abs(k), axis=1)
    row_sign = np.sign(np.take_along_axis(k, max_idx[:, None], axis=1))
    return np.where(row_sign == 0, 1.0, row_sign)


def _check_components(n_features: int, n_components: int) -> None:
    if n_components > n_features:
        raise InvalidDimensionsError(
            f"n_components ({n_components}) cannot exceed n_features ({n_features})"
        )


def _whitening_matrix(cov, n_samples: int, n_components: int) -> np.ndarray:
    """K in NumPy f64 from an (N, N) covariance, or SingularMatrixError."""
    k, min_sv = whitening_matrix_from_covariance(cov, n_samples, n_components)
    if k is None or min_sv < _MIN_SINGULAR_VALUE:
        raise SingularMatrixError()
    return k


def preprocess_f64(
    x64: np.ndarray,
    n_components: int,
    centering: bool,
    whiten_flag: bool,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Host NumPy f64 centering + PCA whitening (reference parity).

    Returns ``(preprocessed_data_f64, mean_or_None, K_or_None)``; raises
    ``SingularMatrixError`` on rank-deficient data.
    """
    x64 = np.ascontiguousarray(x64, np.float64)
    mean = None
    if centering:
        mean = x64.mean(axis=1)
        x64 = x64 - mean[:, None]
    if not whiten_flag:
        return x64, mean, None
    n_features, n_samples = x64.shape
    _check_components(n_features, n_components)
    k = _whitening_matrix(x64 @ x64.T, n_samples, n_components)
    return k @ x64, mean, k


# ---------------------------------------------------------------------------
# Device path.
# ---------------------------------------------------------------------------


def _chunk_len(t: int) -> int:
    """T-chunk of the accurate f32 reductions on the CPU: small chunks
    bound the in-chunk f32 error (~eps * bt / sqrt(T) relative) while the
    pairwise fold keeps the cross-chunk error at ~eps * log2(n)."""
    if t <= _PLAIN_MAX_T:
        return t
    return max(512, min(8192, t // 512))


def _impl_for(x, shards=None) -> str:
    """``"plain"``, ``"kernel"`` or ``"chunked"`` for the mean and the
    covariance of ``x`` (see the module docstring)."""
    if x.dtype == torch.float64 or _n_samples(x, shards) <= _PLAIN_MAX_T:
        return "plain"
    return "kernel" if x.device.type == "cuda" else "chunked"


def _mean_impl(x, impl: str, shards=None):
    """Per-row mean. The chunked route sums per chunk and folds pairwise
    (error ~eps*log(T/bt) instead of ~eps*sqrt(T); the mean feeds the
    covariance)."""
    t = _n_samples(x, shards)
    if impl == "kernel":
        sums = row_sums(x)
    elif impl == "chunked":
        sums = row_sums_plain(x, _chunk_len(t))
    else:
        sums = x.sum(dim=1)
    return all_reduced(sums, shards) / t


def _covariance_impl(x, impl: str, shards=None):
    if impl == "kernel":
        cov = covariance_sums(x)
    elif impl == "chunked":
        cov = covariance_sums_plain(x, _chunk_len(_n_samples(x, shards)))
    else:
        cov = x @ x.T
    return all_reduced(cov, shards)


def _to_host(cov) -> np.ndarray:
    return cov.to(torch.float64).cpu().numpy()


def center(x, data_sharding=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subtract the per-row (per-feature) mean (whitening.rs:24-35).
    Returns ``(centered, mean)``; the centered data is a new tensor."""
    mean = _mean_impl(x, _impl_for(x, data_sharding), data_sharding)
    return x - mean[:, None], mean


def _covariance(x, shards=None):
    """``X X^T`` (unnormalized), chunked for f32 at scale."""
    return _covariance_impl(x, _impl_for(x, shards), shards)


def _should_refine(x, shards=None) -> bool:
    """Refine f32 data at scale: the f64 covariance is exact to input
    precision, and tiny-T fits are quantization-dominated anyway."""
    return x.dtype == torch.float32 and _n_samples(x, shards) > _PLAIN_MAX_T


def _refine_whitening(x1, k: np.ndarray, n_samples: int, shards=None):
    """One step of re-whitening in the whitened basis (f32 device path).

    An ill-conditioned mixture amplifies norm-scale covariance noise by
    cond(C) into its small eigendirections, so the first K whitens the
    true covariance only to the f32 quantization of C relative to its
    smallest eigenvalue. A second measurement C2 = X1 X1^T of the
    projected data is near identity (cond ~ 1); its host-f64 symmetric
    inverse square root R (symmetric, so the component order is kept)
    composes K <- R K, and the same measurement error then lands on a
    well-conditioned matrix (whitening.py:309-353).

    ``x1`` is rotated in place (one data buffer plus one block). Returns
    ``(x1, k_refined)``; on numerical trouble in the refinement eigh the
    inputs come back unchanged (the first K is already rank-checked).
    """
    cov2 = _to_host(_covariance(x1, shards)) / float(n_samples)
    try:
        w, u = np.linalg.eigh(cov2)
    except np.linalg.LinAlgError:
        return x1, k
    if not np.all(np.isfinite(w)) or w[-1] <= 0 or w[0] <= 1e-6 * w[-1]:
        # A grossly non-white first pass means the first K was already
        # untrustworthy; refinement on garbage would hide that.
        return x1, k
    r = (u / np.sqrt(w)) @ u.T  # symmetric C2^{-1/2}, f64
    k_ref = r @ np.asarray(k, np.float64)
    signs = _matlab_row_signs(k_ref)
    k_ref *= signs
    rs = torch.as_tensor(signs * r, dtype=x1.dtype, device=x1.device)
    return rotate_rows_inplace(rs, x1), k_ref


def whiten(x, n_components: int, data_sharding=None) -> WhiteningResult:
    """PCA-whiten centered data (raises on singular data).

    ``x`` is (n_features, n_samples); the output has unit variance per
    component (scaled by sqrt(T) as in whitening.rs:83).
    """
    n_features = x.shape[0]
    n_samples = _n_samples(x, data_sharding)
    _check_components(n_features, n_components)
    k = _whitening_matrix(_to_host(_covariance(x, data_sharding)), n_samples, n_components)
    x1 = torch.as_tensor(k, dtype=x.dtype, device=x.device) @ x
    if _should_refine(x, data_sharding):
        x1, k = _refine_whitening(x1, k, n_samples, data_sharding)
    return WhiteningResult(x1, torch.as_tensor(k, dtype=x.dtype, device=x.device))


def _prepare_stats(x, impl: str, centering: bool, shards=None):
    """Mean of ``x`` and the covariance of the centered data. The kernel
    route subtracts the mean inside the covariance's tile load, so no
    centered copy of X is made for it."""
    if not centering:
        return None, _covariance_impl(x, impl, shards)
    mean = _mean_impl(x, impl, shards)
    if impl == "kernel":
        return mean, all_reduced(centered_covariance_sums(x, mean), shards)
    return mean, _covariance_impl(x - mean[:, None], impl, shards)


def _project_centered(k, x, mean, centering: bool):
    """``K (X - mean)`` into one new (n, T) buffer, a column block of
    ``linalg.ROTATE_BLOCK_T`` at a time: beside X and x1 only one
    centered (nf, block) block is alive, where the JAX package's jitted
    projection fuses the centering into its product. Each element is
    computed as in one product over all of T: the subtraction in X's
    dtype, then the product (exact f32 under ``exact_f32``). The matmul
    is left outside the kernels as the JAX package leaves it outside
    Pallas."""
    t = x.shape[1]
    x1 = torch.empty((k.shape[0], t), dtype=x.dtype, device=x.device)
    block = linalg.ROTATE_BLOCK_T
    for start in range(0, t, block):
        stop = min(start + block, t)
        xb = x[:, start:stop]
        if centering:
            xb = xb - mean[:, None]
        torch.matmul(k, xb, out=x1[:, start:stop])
    return x1


def center_whiten(
    x,
    n_components: int,
    centering: bool = True,
    whiten_flag: bool = True,
    ensure_owned: bool = False,
    data_sharding=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Center and whiten ``x`` on its device: ``(x1, mean, K)``.

    The same result as :func:`center` then :func:`whiten` (the same
    chunked accuracy design, sign convention and rank test), with the
    mean and the covariance taken together. Exact f32 products need TF32
    off (``torch.backends.cuda.matmul.allow_tf32 = False``, which
    ``Picard.fit`` sets).

    ``x`` is never written. ``ensure_owned=True`` makes the returned
    ``x1`` a buffer the caller owns (safe to rotate in place): every
    transforming branch returns a new tensor already, and the one
    passthrough branch (``centering=False, whiten_flag=False``) copies.
    ``data_sharding``: ``x`` is this rank's column block of a sharded fit.
    """
    if not whiten_flag:
        if centering:
            x1, mean = center(x, data_sharding)
            return x1, mean, None
        return (x.clone() if ensure_owned else x), None, None
    n_features = x.shape[0]
    n_samples = _n_samples(x, data_sharding)
    _check_components(n_features, n_components)
    mean, cov = _prepare_stats(x, _impl_for(x, data_sharding), centering, data_sharding)
    k = _whitening_matrix(_to_host(cov), n_samples, n_components)
    x1 = _project_centered(torch.as_tensor(k, dtype=x.dtype, device=x.device),
                           x, mean, centering)
    if _should_refine(x, data_sharding):
        x1, k = _refine_whitening(x1, k, n_samples, data_sharding)
    return x1, mean, torch.as_tensor(k, dtype=x.dtype, device=x.device)
