"""Result container for a fitted Picard model.

Counterpart of ``picard_ica_tpu/results.py`` (reference:
src/result.rs:7-64). Arrays are torch tensors on the fit's device;
scalar diagnostics are Python values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ops.linalg import mixing_pinv


@dataclasses.dataclass
class PicardResult:
    """Output of ``Picard.fit`` (result.rs:7-33)."""

    # Whitening matrix K (n_components, n_features); None if whiten=False.
    whitening: Optional[torch.Tensor]
    # Unmixing matrix W (n_components, n_components).
    unmixing: torch.Tensor
    # Estimated sources (n_components, n_samples); a DTensor placed
    # Shard(1) after a sample-sharded fit.
    sources: torch.Tensor
    # Per-feature mean (n_features,); None if centering=False.
    mean: Optional[torch.Tensor]
    n_iterations: int
    converged: bool
    gradient_norm: float
    # Sub/super-Gaussian signs per component; None unless extended mode.
    signs: Optional[torch.Tensor]
    # Iteration number at which each precision stage exited.
    stage_exits: Optional[tuple] = None
    # Precision name per stage, aligned with stage_exits.
    stage_precisions: Optional[tuple] = None
    # Total fused line-search passes over the data (accepted + rejected
    # tries incl. fallbacks); each is one read of X.
    ls_calls: Optional[int] = None
    # Cumulative ls_calls at each stage exit.
    stage_ls_calls: Optional[tuple] = None
    # Wall seconds of the core loop (models/core.run_core), measured
    # between device synchronizations.
    core_seconds: Optional[float] = None

    def full_unmixing(self) -> torch.Tensor:
        """``W @ K`` when whitened, else ``W`` (result.rs:39-44)."""
        if self.whitening is not None:
            return self.unmixing @ self.whitening
        return self.unmixing

    def mixing(self) -> torch.Tensor:
        """Pseudo-inverse of the full unmixing matrix (result.rs:49-64)."""
        return mixing_pinv(self.full_unmixing())
