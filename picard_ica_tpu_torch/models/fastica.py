"""Symmetric ("parallel") FastICA warm start, on torch tensors.

Counterpart of ``picard_ica_tpu/models/fastica.py`` (reference:
src/solver.rs:218-249): a fixed number of fixed-point iterations
``C = E[g(WX) X^T] - diag(E[g'(WX)]) W`` followed by symmetric
decorrelation — no convergence test. Runs on ``x``'s device in its
dtype, every product in exact f32 (or f64). Sample-sharded
(``data_sharding``), both expectations are all-reduced sums over the
global T, in one payload an iteration.
"""

from __future__ import annotations

from ..ops.densities import Density
from ..ops.linalg import sym_decorrelation_with_mineig
from ..ops.precision import exact_f32
from ..parallel.sharding import n_samples


@exact_f32()
def ica_par(x, density: Density, max_iter: int, w_init, data_sharding=None):
    """Run FastICA pre-iterations; returns (W, min_eig_seen).

    ``min_eig_seen`` is the smallest eigenvalue encountered across all
    symmetric decorrelations, a 0-d tensor on the device, so the caller
    can reproduce the reference's singularity error (math.rs:21-24)
    without host syncs inside the loop.
    """
    inv_t = 1.0 / n_samples(x, data_sharding)
    w, min_eig = sym_decorrelation_with_mineig(w_init)
    for _ in range(max_iter):
        gwtx, g_wtx = density.score_and_der(w @ x)
        if data_sharding is None:
            c = (gwtx @ x.T) * inv_t - g_wtx.mean(dim=1)[:, None] * w
        else:
            gx, g_sum = data_sharding.reduce([gwtx @ x.T, g_wtx.sum(dim=1)])
            c = gx * inv_t - (g_sum * inv_t)[:, None] * w
        del gwtx, g_wtx
        w, me = sym_decorrelation_with_mineig(c)
        min_eig = min_eig.minimum(me)
    return w, min_eig
