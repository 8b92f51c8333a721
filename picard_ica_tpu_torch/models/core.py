"""Core Picard optimizer loop on torch tensors.

Counterpart of ``picard_ica_tpu/models/core.py`` (reference hot loop:
src/core.rs:162-401). The JAX package runs the loop as one jitted
``lax.while_loop``; here it is a Python loop over device tensors with
the same state and the same semantics:

  * **Implicit Y.** ``Y == W @ X`` holds throughout (W starts at the
    identity and accumulates every line-search transform), so the state
    holds only N x N matrices and X is read-only until the end. Every
    data pass fuses the rotation into its reduction: one read of X per
    line-search try, none for the moments of the accepted W.
  * the L-BFGS memory is a fixed (m, N, N) ring with a count;
  * over f32 data, a stage that accepts on the loss change (every tier
    but the plain-accept bf16 one) holds W in f64 (:func:`w_dtype`) and
    hands the kernels M_old and dM = M_new - M_old rounded apart: W sits
    near the identity, where an f32 diagonal drops the small steps of a
    converging fit and their loss changes drown in its rounding. The JAX
    package keeps W in f32 throughout;
  * the backtracking line search accepts the first loss decrease and
    costs one host synchronization per try (the accept flag);
  * the staged bf16 -> bf16x3 -> f32 schedule of ``kernel_precision=
    "auto"`` (:func:`_precision_stages`) with its floor-gated stage
    exits and conditional memory clears.

``CoreOptions.use_kernels`` selects the data passes: the CUDA kernels
of ``ops/kernels.py`` (their plain PyTorch versions for CPU tensors),
or the torch path — the JAX package's non-Pallas formulation
(core.py:394-440 there). The kernel wrappers pick the resident kernels
up to N = 64 and the streaming kernels above (``streaming_fused_sums``
for the tries and the moments, ``streaming_loglik_sums`` for the loss
re-baselines, the bf16 copy of X included), so this loop is the same at
every N.

Under a samples mesh (``CoreOptions.data_sharding``, a
``parallel.sharding.SampleShards``) X is this rank's column block: every
data pass's sums over the local T are all-reduced and divided by the
global T, and the N x N state stays replicated, so every branch reads
only all-reduced values. A fused pass reduces its accept payload (dll,
dysq) first and on its own, and its moment payload asynchronously
(:class:`PendingMoments`), waited on where the moments are first read
(the JAX package's ``_shard_mapped(critical_first=2)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..ops.densities import Density
from ..ops.kernels import rotated_fused_sums, rotated_loglik_sums, rotated_moments_sums, work_dtype
from ..ops.linalg import expm_pow2_chain, matrix_exp, rotate_rows_inplace, skew_symmetric
from ..ops.moments import RawMoments, _row_sum, raw_moment_sums
from ..ops.precision import matmul_tiered
from ..parallel.sharding import all_reduced, n_samples

# Penalty loss for singular/failed evaluations (core.rs:90-96).
_SINGULAR_LOSS = 1e15
# Hard-coded fallback line-search tries (core.rs:361).
_FALLBACK_LS_TRIES = 10
# The adaptive initial alpha never starts below 2^-6.
_ALPHA_EXP_CAP = 6


@dataclasses.dataclass(frozen=True)
class CoreOptions:
    """Configuration of the core loop (fields as in the JAX package)."""

    density: Density
    ortho: bool
    extended: bool
    has_cov: bool
    m: int
    ls_tries: int
    verbose: bool = False
    # Data passes through ops/kernels.py (CUDA kernels on the card,
    # their plain versions on the CPU) instead of the torch path.
    use_kernels: bool = False
    # "auto" = staged bf16 -> bf16x3 -> f32 (see _precision_stages);
    # "f32" exact throughout; "bf16x3"/"bf16" pin a single tier. All
    # tiers are exact at f64.
    kernel_precision: str = "f32"
    # Stall patience of NON-FINAL stages (0 disables; always 0 for the
    # final stage). Managed by run_core per stage.
    stage_patience: int = 0
    fallback_ls_tries: int = _FALLBACK_LS_TRIES
    # Plain (absolute log-lik) accept in the line search — the non-final
    # bf16 tier only; managed by run_core per stage.
    plain_ls: bool = False
    # Start the primary line search at min(1, 2 * last accepted alpha)
    # (non-final tiers only); managed by run_core per stage.
    adaptive_alpha: bool = False
    # The caller hands over X and does not reuse it: the final
    # Y = W @ X is then written in place through X's buffer.
    donate_data: bool = False
    # parallel.sharding.SampleShards of a sample-sharded fit (X is this
    # rank's column block), or None.
    data_sharding: Any = None


@dataclasses.dataclass
class LbfgsMemory:
    """Fixed-shape L-BFGS ring: slot j < count holds the j-th oldest pair."""

    s_mem: torch.Tensor  # (m, N, N)
    y_mem: torch.Tensor  # (m, N, N)
    r_mem: torch.Tensor  # (m,)
    count: int


@dataclasses.dataclass
class CoreState:
    w: torch.Tensor  # (N, N), of w_dtype(); Y == W @ X implicitly
    loss: torch.Tensor  # 0-d
    signs: torch.Tensor  # (N,)
    old_signs: torch.Tensor  # (N,)
    c: torch.Tensor  # (N, N) extended covariance proxy
    g_old: torch.Tensor  # (N, N)
    prev_step: torch.Tensor  # (N, N)
    memory: LbfgsMemory
    # Raw moments of Y = W @ X from the previous line search's fused
    # pass (or the init pass at it == 0).
    moments: Any  # RawMoments
    it: int
    n_iter_done: int
    gradient_norm: torch.Tensor  # 0-d
    converged: bool
    # Stall tracking for the staged-precision handoff (reset per stage).
    best_gnorm: torch.Tensor  # 0-d
    since_improve: int
    consec_fallbacks: int
    # Cumulative line-search passes over X (tries incl. fallbacks).
    ls_calls: int
    # log2 exponent of the last accepted step size.
    prev_alpha_exp: int


class CoreResult(NamedTuple):
    y: torch.Tensor
    w: torch.Tensor
    converged: bool
    gradient_norm: float
    n_iterations: int
    signs: torch.Tensor
    # Iteration count at each precision-stage exit.
    stage_exits: tuple
    ls_calls: int
    # Cumulative ls_calls at each stage exit.
    stage_ls_calls: tuple


def _scalar(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


class PendingMoments:
    """The moment sums of a sharded fused pass, all-reduced in the
    background; :meth:`wait` gives their ``RawMoments`` (computed once)."""

    def __init__(self, pending, inv_t: float):
        self._pending, self._inv_t = pending, inv_t
        self._moments = None

    def wait(self) -> RawMoments:
        if self._moments is None:
            self._moments = RawMoments(*(v * self._inv_t for v in self._pending.wait()))
        return self._moments


def _ready(moments) -> RawMoments:
    """``moments`` with its all-reduce waited on (a pass-through for the
    RawMoments of an unsharded fit). Also settles a superseded try's
    reduction, so a failed collective raises."""
    return moments.wait() if isinstance(moments, PendingMoments) else moments


def _reduce_fused(shards, inv_t, dll, dysq, moment_sums):
    """A sharded fused pass's sums all-reduced: the accept payload
    (dll, dysq), ~2N floats, first and on its own, since only it feeds
    the line search's host sync; the moment payload (G, pm, H, ysq)
    after it, asynchronously."""
    dll, dysq = shards.reduce([dll, dysq])
    return dll * inv_t, dysq * inv_t, PendingMoments(shards.reduce_async(moment_sums), inv_t)


# ---------------------------------------------------------------------------
# Data passes: rotate + score/log-lik + reduce over T.
# ---------------------------------------------------------------------------


def _all_reduced_sums(sums, shards):
    """The sums of a data pass over the mesh: themselves unsharded."""
    return list(sums) if shards is None else shards.reduce(sums)


def data_moments(w, x, opts: CoreOptions, need_h: bool, need_ysq: bool) -> RawMoments:
    """Normalized moments of Y = W @ X: G = E[psi(Y) Y^T], pm =
    E[psi'(Y)], H = E[psi'(Y) (Y^2)^T], ysq = E[Y^2]."""
    shards = opts.data_sharding
    if opts.use_kernels:
        sums = rotated_moments_sums(w, x, opts.density, need_h, need_ysq)
    else:
        sums = raw_moment_sums(w.to(x.dtype) @ x, opts.density, need_h, need_ysq)
    inv_t = 1.0 / n_samples(x, shards)
    return RawMoments(*(v * inv_t for v in _all_reduced_sums(sums, shards)))


def data_loglik(m, x, opts: CoreOptions, need_ysq: bool):
    """(E[log_lik(M X)] per row, E[(M X)^2] per row) in one pass."""
    shards = opts.data_sharding
    if opts.use_kernels:
        ll, ysq = rotated_loglik_sums(m, x, opts.density, need_ysq)
    else:
        y = m.to(x.dtype) @ x
        ll = _row_sum(opts.density.log_lik(y))
        ysq = _row_sum(y * y) if need_ysq else torch.zeros_like(ll)
    ll, ysq = _all_reduced_sums((ll, ysq), shards)
    inv_t = 1.0 / n_samples(x, shards)
    return ll * inv_t, ysq * inv_t


def data_fused_step(m_new, m_old, x, opts: CoreOptions, need_h: bool, need_ysq: bool):
    """One line-search try + the candidate's moments.

    Returns ``(dll_means, dysq_means, RawMoments(of M_new @ X))`` from
    one pass over X: the loss change (delta mode) or the candidate's
    absolute log-lik (``opts.plain_ls``), and the raw moments of the
    candidate, which an accepted try hands to the next iteration. Under a
    samples mesh the moments come as :class:`PendingMoments`.
    """
    shards = opts.data_sharding
    inv_t = 1.0 / n_samples(x, shards)
    if opts.use_kernels:
        dll, dysq, *moment_sums = rotated_fused_sums(
            m_new, m_old, x, opts.density, need_h, need_ysq,
            precision=opts.kernel_precision, absolute_ll=opts.plain_ls,
        )
    else:
        dll, dysq, moment_sums = _fused_sums_torch(m_new, m_old, x, opts, need_h, need_ysq)
    if shards is not None:
        return _reduce_fused(shards, inv_t, dll, dysq, moment_sums)
    return dll * inv_t, dysq * inv_t, RawMoments(*(v * inv_t for v in moment_sums))


def _fused_sums_torch(m_new, m_old, x, opts: CoreOptions, need_h: bool, need_ysq: bool):
    """The torch path's fused pass, as sums over ``x``'s columns: the
    kernels' formulations. Delta mode rotates the current matrix and the
    candidate delta and evaluates the loss change analytically from
    (y_old, dy); plain mode evaluates absolute row sums. The N x N x T
    products run at the stage's tier."""
    n = x.shape[0]
    dtype = work_dtype(x)

    def tdot(a, b):
        return matmul_tiered(a, b, dtype, opts.kernel_precision)

    zeros_n = torch.zeros((n,), dtype=dtype, device=x.device)
    if opts.plain_ls:
        y_new = tdot(m_new.to(dtype), x)
        psi, psi_d, ll_el = opts.density.score_der_loglik(y_new)
        dll = _row_sum(ll_el)
        dysq = _row_sum(y_new * y_new) if need_ysq else zeros_n
    else:
        y_old = tdot(m_old.to(dtype), x)
        dy = tdot((m_new - m_old).to(dtype), x)
        y_new = y_old + dy
        psi, psi_d, dll_el = opts.density.score_der_loglik_delta(y_old, dy)
        dll = _row_sum(dll_el)
        dysq = _row_sum((2.0 * y_old + dy) * dy) if need_ysq else zeros_n
    g = tdot(psi, y_new.T)
    pm = _row_sum(psi_d)
    if need_h:
        h = tdot(psi_d, (y_new * y_new).T)
    else:
        h = torch.zeros((n, n), dtype=dtype, device=x.device)
    ysq_new = _row_sum(y_new * y_new) if need_ysq else zeros_n
    return dll, dysq, (g, pm, h, ysq_new)


def _logdet_penalized(m, like):
    """``-log|det m|``, or the 1e15 penalty for a singular ``m``."""
    sign, log_abs = torch.linalg.slogdet(m)
    return torch.where(sign == 0, _scalar(_SINGULAR_LOSS, like),
                       -log_abs.to(like.dtype))


def compute_loss(w, x, signs, opts: CoreOptions):
    """Negative log-likelihood objective of Y = W @ X (core.rs:39-85);
    a singular W maps to the 1e15 penalty (core.rs:90-96)."""
    need_ysq = opts.extended and not opts.ortho
    ll_means, ysq_means = data_loglik(w, x, opts, need_ysq)
    if not opts.ortho:
        logdet_term = _logdet_penalized(w, ll_means)
    else:
        logdet_term = _scalar(0.0, ll_means)
    loss = logdet_term + torch.sum(signs * ll_means)
    if need_ysq:
        loss = loss + 0.5 * torch.sum(ysq_means)
    return loss


# ---------------------------------------------------------------------------
# N x N pieces: L-BFGS, Hessian helpers, line search.
# ---------------------------------------------------------------------------


def _push_memory(mem: LbfgsMemory, s, y, r, do_push: bool) -> LbfgsMemory:
    """Append (s, y, r); evict the oldest when full (core.rs:296-312)."""
    if not do_push:
        return mem
    m = mem.s_mem.shape[0]
    full = mem.count >= m
    s_mem, y_mem, r_mem = mem.s_mem, mem.y_mem, mem.r_mem
    if full:
        s_mem = torch.roll(s_mem, -1, dims=0)
        y_mem = torch.roll(y_mem, -1, dims=0)
        r_mem = torch.roll(r_mem, -1, dims=0)
    else:
        s_mem, y_mem, r_mem = s_mem.clone(), y_mem.clone(), r_mem.clone()
    idx = m - 1 if full else mem.count
    s_mem[idx] = s
    y_mem[idx] = y
    r_mem[idx] = r
    return LbfgsMemory(s_mem, y_mem, r_mem, min(mem.count + 1, m))


def solve_hessian_system(h, h_off, g):
    """Pairwise 2x2 Hessian solves, vectorized (lbfgs.rs:136-150).

    result[i,j] = (h[j,i]*g[i,j] - h_off[i]*g[j,i]) / det with
    det = h[i,j]*h[j,i] - h_off[i]*h_off[j]; entries with |det|<=1e-15
    are zero.
    """
    det = h * h.T - torch.outer(h_off, h_off)
    numer = h.T * g - h_off[:, None] * g.T
    ok = det.abs() > 1e-15
    safe_det = torch.where(ok, det, torch.ones_like(det))
    return torch.where(ok, numer / safe_det, torch.zeros_like(det))


def regularize_hessian(h, h_off, lambda_min):
    """Eigenvalue-floor the 2x2 Hessian blocks (lbfgs.rs:155-171).

    The reference scans entries in row-major order mutating h, so every
    upper-triangle entry sees original values and every lower entry
    (p, q) sees its ALREADY-BUMPED upper partner h[q, p]: two vectorized
    phases, upper from the original h, then lower against phase 1.
    """
    n = h.shape[0]
    i = torch.arange(n, device=h.device)
    upper = i[:, None] < i[None, :]
    lower = i[:, None] > i[None, :]
    off = torch.outer(h_off, h_off)

    def bump(entries, partners, mask):
        diff = entries - partners
        discr = torch.sqrt(diff * diff + 4.0 * off)
        eigenvalue = 0.5 * (entries + partners - discr)
        return torch.where(mask & (eigenvalue < lambda_min),
                           lambda_min - eigenvalue, torch.zeros_like(h))

    h1 = h + bump(h, h.T, upper)
    return h1 + bump(h, h1.T, lower)


def compute_direction(g, h, h_off, mem: LbfgsMemory, opts: CoreOptions):
    """L-BFGS two-loop recursion with the sparse-Hessian preconditioner
    as the initial inverse-Hessian guess (lbfgs.rs:84-133)."""
    q = g
    alphas = [None] * mem.count
    for j in range(mem.count - 1, -1, -1):
        a = mem.r_mem[j] * torch.sum(mem.s_mem[j] * q)
        alphas[j] = a
        q = q - a * mem.y_mem[j]

    if opts.ortho:
        z = q / h
        z = (z - z.T) / 2.0
    else:
        z = solve_hessian_system(h, h_off, q)

    for j in range(mem.count):
        beta = mem.r_mem[j] * torch.sum(mem.y_mem[j] * z)
        z = z + (alphas[j] - beta) * mem.s_mem[j]
    return -z


def line_search(x, w, direction, signs, current_loss, ls_tries: int,
                opts: CoreOptions, accept_slack=None, max_tries=None,
                init_alpha_exp: int = 0):
    """Backtracking line search (core.rs:99-150), Y kept implicit.

    Tries alpha = 2^-init_alpha_exp, then halves, accepting the first
    loss decrease (``delta < accept_slack``). On failure the returned
    (w, loss) are the LAST TRIED candidate's and the step uses the
    once-more-halved alpha (core.rs:117-149). Every try is one fused
    pass, whose moments always belong to the returned w.

    Returns ``(success, w, loss, step, moments, tries, last_exp)``.
    """
    n = w.shape[0]
    dtype = work_dtype(x)
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    # The candidates are formed in W's dtype (f64 in the delta stages over
    # f32 data, :func:`w_dtype`); the step and the memory stay in X's.
    d_w = direction.to(w.dtype)
    need_h = not opts.ortho
    need_ysq = opts.extended and not opts.ortho
    if accept_slack is None:
        accept_slack = _scalar(0.0, current_loss)

    # f32 ortho: every candidate rotation expm(2^-k D) comes from one
    # shared scaling-squaring chain. On final-semantics tiers
    # (adaptive_alpha off) the chain is read only when max|D| <= 2^-10,
    # where it is eps-accurate; above that each try pays matrix_exp.
    # f64 keeps the per-try matrix_exp.
    use_chain = opts.ortho and dtype != torch.float64 and max_tries is not None
    chain_accurate = True
    if use_chain:
        chain, chain_top = expm_pow2_chain(d_w, int(max_tries) + _ALPHA_EXP_CAP)
        if not opts.adaptive_alpha:
            chain_accurate = bool(direction.abs().max() <= 2.0 ** -10)

    def try_alpha(alpha, k):
        if opts.ortho:
            if use_chain and chain_accurate:
                tm = chain[chain_top - init_alpha_exp - k]
            else:
                tm = matrix_exp(d_w * alpha)
        else:
            tm = eye + alpha * d_w
        w_new = tm @ w

        dll, dysq, moments = data_fused_step(w_new, w, x, opts, need_h, need_ysq)
        if opts.plain_ls:
            # Absolute row means: accept on a direct subtraction.
            loss_new = torch.sum(signs * dll)
            if need_ysq:
                loss_new = loss_new + 0.5 * torch.sum(dysq)
            if not opts.ortho:
                loss_new = loss_new + _logdet_penalized(w_new, loss_new)
            delta = loss_new - current_loss
        else:
            delta = torch.sum(signs * dll)
            if need_ysq:
                delta = delta + 0.5 * torch.sum(dysq)
            if not opts.ortho:
                # -log|det W_new| + log|det W| == -log|det Tm|.
                delta = delta + _logdet_penalized(tm, delta)
        return w_new, delta, moments

    alpha = 2.0 ** -init_alpha_exp
    tries = 0
    success = False
    w_new = w
    delta = _scalar(0.0, current_loss)
    moments = None
    while not success and tries < ls_tries:
        w_new, delta, try_moments = try_alpha(alpha, tries)
        if moments is not None:
            _ready(moments)  # the superseded try's moment all-reduce
        moments = try_moments
        success = bool(delta < accept_slack)
        if not success:
            alpha = alpha / 2.0
        tries += 1
    if moments is None:  # ls_tries == 0
        zn = torch.zeros((n,), dtype=dtype, device=w.device)
        zz = torch.zeros((n, n), dtype=dtype, device=w.device)
        moments = RawMoments(zz, zn, zz, zn)
    step = direction * alpha
    last_exp = init_alpha_exp + tries - 1
    return success, w_new, current_loss + delta, step, moments, tries, last_exp


# ---------------------------------------------------------------------------
# The iteration body and the outer loop.
# ---------------------------------------------------------------------------


def _iteration_update(st: CoreState, x, g, h, h_off, signs, old_signs,
                      sign_change: bool, gradient_norm, covariance,
                      lambda_min, opts: CoreOptions) -> CoreState:
    """Post-convergence-check part of one iteration (core.rs:296-390)."""
    # L-BFGS memory push with the previous step (core.rs:296-313).
    y_diff = g - st.g_old
    denom = torch.sum(st.prev_step * y_diff)
    r = 1.0 / denom
    do_push = st.it > 0 and bool(torch.isfinite(r))
    memory = _push_memory(st.memory, st.prev_step, y_diff, r, do_push)

    if opts.extended:
        # Sign change: re-baseline the loss, flush memory (core.rs:317-331).
        if sign_change:
            new_loss = compute_loss(st.w, x, signs, opts)
            current_loss = torch.where(torch.isfinite(new_loss), new_loss,
                                       _scalar(_SINGULAR_LOSS, st.loss))
            memory = dataclasses.replace(memory, count=0)
        else:
            current_loss = st.loss

        # First-iteration stale baseline (reference quirk): at it == 0 a
        # sign flip does NOT re-baseline, so the line search compares
        # loss(candidate, new signs) against loss(W, ones). Reproduced as
        # current_loss = loss(W, new) plus an accept slack of
        # sum_i (1 - signs_i) E[ll_i(W)].
        if st.it == 0 and bool(torch.any(signs < 0)):
            ll_means, _ = data_loglik(st.w, x, opts, False)
            accept_slack = torch.sum((1.0 - signs) * ll_means)
        else:
            accept_slack = _scalar(0.0, st.loss)
        current_loss = current_loss - accept_slack
    else:
        current_loss = st.loss
        accept_slack = _scalar(0.0, st.loss)

    direction = compute_direction(g, h, h_off, memory, opts)

    if opts.adaptive_alpha:
        init_exp = min(max(st.prev_alpha_exp - 1, 0), _ALPHA_EXP_CAP)
    else:
        init_exp = 0

    (success, new_w, new_loss, step, new_moments, tries_total,
     new_alpha_exp) = line_search(
        x, st.w, direction, signs, current_loss, opts.ls_tries, opts,
        accept_slack=accept_slack, max_tries=opts.ls_tries,
        init_alpha_exp=init_exp,
    )
    mem_count = memory.count
    if not success:
        # Gradient-descent fallback (core.rs:349-364): clear memory and
        # retry from the PRE-search state along -G; take its result even
        # if it also fails.
        _ready(new_moments)
        _, new_w, new_loss, step, new_moments, fb_tries, _ = line_search(
            x, st.w, -g, signs, current_loss, opts.fallback_ls_tries, opts,
            accept_slack=accept_slack, max_tries=opts.fallback_ls_tries,
        )
        mem_count = 0
        tries_total += fb_tries
        new_alpha_exp = 0
    memory = dataclasses.replace(memory, count=mem_count)

    # Extended covariance proxy C = W cov W^T (core.rs:375-379).
    if opts.extended and opts.has_cov:
        w_c = new_w.to(covariance.dtype)
        c = (w_c @ covariance) @ w_c.T
    else:
        c = st.c

    if opts.verbose:
        print(f"iteration {st.it + 1}, gradient norm = "
              f"{float(gradient_norm):.4e}, loss = {float(new_loss):.4e}")

    return CoreState(
        w=new_w,
        loss=new_loss,
        signs=signs,
        old_signs=old_signs,
        c=c,
        g_old=g,
        prev_step=step,
        memory=memory,
        moments=new_moments,
        it=st.it + 1,
        n_iter_done=st.it + 1,
        gradient_norm=gradient_norm,
        converged=False,
        best_gnorm=st.best_gnorm,
        since_improve=st.since_improve,
        consec_fallbacks=0 if success else st.consec_fallbacks + 1,
        ls_calls=st.ls_calls + tries_total,
        prev_alpha_exp=new_alpha_exp,
    )


def _iteration_body(st: CoreState, x, covariance, tol, lambda_min,
                    opts: CoreOptions) -> CoreState:
    """One full optimizer iteration (core.rs:211-391); the moments of
    Y = W @ X arrive in the state."""
    n = st.w.shape[0]
    dtype = work_dtype(x)

    moments = _ready(st.moments)
    g = moments.g_raw
    pm0 = moments.pm_raw

    if opts.extended:
        # Kurtosis-based sub/super-Gaussian signs (core.rs:225-237);
        # +0.0 maps to +1 like f64::signum.
        k = pm0 * torch.diagonal(st.c) - torch.diagonal(g)
        signs = torch.where(k >= 0, 1.0, -1.0).to(dtype)
        sign_change = st.it > 0 and bool(torch.any(signs != st.old_signs))
        old_signs = signs
        g = signs[:, None] * g
        pm = pm0 * signs
    else:
        signs = st.signs
        old_signs = st.old_signs
        sign_change = False
        pm = pm0

    if opts.extended and not opts.ortho:
        g = g + st.c

    # Hessian pieces (core.rs:256-276).
    if opts.ortho:
        h_off = torch.diagonal(g)
        h = 0.5 * (pm[:, None] + pm[None, :] - h_off[:, None] - h_off[None, :])
        h = torch.maximum(h, lambda_min)
    else:
        h_off = torch.ones((n,), dtype=dtype, device=g.device)
        h = moments.h_raw
        if opts.extended:
            h = signs[:, None] * h + moments.ysq_rowmean[None, :]
        h = regularize_hessian(h, h_off, lambda_min)

    # Project the gradient (core.rs:280-286).
    if opts.ortho:
        g = skew_symmetric(g)
    else:
        g = g - torch.eye(n, dtype=dtype, device=g.device)

    gradient_norm = g.abs().max()
    converged = bool(gradient_norm < tol)

    # Non-final stages also exit when the tier stalls at its noise
    # floor: a gradient-norm plateau near the floor (or a long one
    # anywhere), a line-search fallback near the floor, or two in a row.
    best_gnorm, since_improve = st.best_gnorm, st.since_improve
    if opts.stage_patience > 0:
        improved = bool(gradient_norm < st.best_gnorm * 0.99)
        best_gnorm = torch.minimum(st.best_gnorm, gradient_norm)
        since_improve = 0 if improved else st.since_improve + 1
        near_floor = bool(gradient_norm < 20.0 * tol)
        converged = converged or (
            since_improve >= opts.stage_patience and near_floor)
        converged = converged or since_improve >= 3 * opts.stage_patience
        converged = converged or (
            st.consec_fallbacks >= 1 and bool(gradient_norm < 3.0 * tol))
        converged = converged or st.consec_fallbacks >= 2

    st = dataclasses.replace(st, best_gnorm=best_gnorm, since_improve=since_improve)

    if converged:
        return dataclasses.replace(
            st, signs=signs, old_signs=old_signs, n_iter_done=st.it + 1,
            gradient_norm=gradient_norm, converged=True,
        )
    return _iteration_update(
        st, x, g, h, h_off, signs, old_signs, sign_change,
        gradient_norm, covariance, lambda_min, opts,
    )


def w_dtype(x, opts: CoreOptions):
    """W's dtype in a stage: f64 where the stage accepts on the loss
    change (delta mode), else X's working dtype. Near the identity an f32
    W's diagonal (ulp 6e-8) drops what a small rotation changes there, and
    at gradients of a few 1e-7 that rounding raises the loss by far more
    than the step lowers it, so every try fails
    (tests/test_torch_core.py, ``test_delta_stage_holds_w_in_f64``)."""
    return work_dtype(x) if opts.plain_ls else torch.float64


def init_state(x, covariance, opts: CoreOptions, x_stage=None):
    """Build the initial state (core.rs:176-209).

    Returns ``(state, initial_singular)``. ``x_stage`` is the first
    stage's data copy (the bf16 X of the plain-accept tier): the initial
    loss and moments come from the SAME copy that stage's accept tests
    read. The extended covariance seed always uses the full ``x``.
    """
    n = x.shape[0]
    dtype = x.dtype
    dev = x.device
    xs = x if x_stage is None else x_stage
    w = torch.eye(n, dtype=w_dtype(x, opts), device=dev)
    signs = torch.ones((n,), dtype=dtype, device=dev)

    need_h = not opts.ortho
    need_ysq = opts.extended and not opts.ortho
    if opts.plain_ls:
        # One fused pass (the stage's own accept kernel) gives the loss
        # terms and iteration 0's moments; slogdet(I) == 0.
        ll_means, ysq_means, moments0 = data_fused_step(
            w, w, xs, opts, need_h, need_ysq)
        loss = torch.sum(signs * ll_means)
        if need_ysq:
            loss = loss + 0.5 * torch.sum(ysq_means)
        loss = loss.to(work_dtype(xs))
    else:
        loss = compute_loss(w, xs, signs, opts)
        moments0 = data_moments(w, xs, opts, need_h, need_ysq)
    initial_singular = bool(loss >= _SINGULAR_LOSS)

    if opts.extended and opts.has_cov:
        c = covariance
    elif opts.extended:
        c = all_reduced(x @ x.T, opts.data_sharding) / n_samples(x, opts.data_sharding)
    else:
        c = torch.eye(n, dtype=dtype, device=dev)

    zeros_nn = torch.zeros((n, n), dtype=dtype, device=dev)
    mem = LbfgsMemory(
        s_mem=torch.zeros((opts.m, n, n), dtype=dtype, device=dev),
        y_mem=torch.zeros((opts.m, n, n), dtype=dtype, device=dev),
        r_mem=torch.zeros((opts.m,), dtype=dtype, device=dev),
        count=0,
    )
    state = CoreState(
        w=w,
        loss=loss,
        signs=signs,
        old_signs=torch.ones((n,), dtype=dtype, device=dev),
        c=c,
        g_old=zeros_nn,
        prev_step=zeros_nn,
        memory=mem,
        moments=moments0,
        it=0,
        n_iter_done=0,
        gradient_norm=torch.tensor(1.0, dtype=dtype, device=dev),
        converged=False,
        best_gnorm=torch.tensor(float("inf"), dtype=dtype, device=dev),
        since_improve=0,
        consec_fallbacks=0,
        ls_calls=0,
        prev_alpha_exp=0,
    )
    return state, initial_singular


def _precision_stages(opts: CoreOptions, dtype=torch.float32):
    """Staged precision schedule for ``kernel_precision="auto"``.

    Each tier runs until the gradient norm clears a safe multiple of its
    noise floor (the density's ``bf16_handoff`` / ``bf16x3_handoff``),
    then hands W, the L-BFGS ring and the loss to the next tier; the
    moments are re-measured at each boundary. The f64 torch path (every
    tier exact) is a single stage.
    """
    if opts.kernel_precision != "auto":
        return [(opts.kernel_precision, None)]
    if not opts.use_kernels and dtype == torch.float64:
        return [("f32", None)]
    d = opts.density
    return [
        ("bf16", getattr(d, "bf16_handoff", 3e-4)),
        ("bf16x3", getattr(d, "bf16x3_handoff", 4e-7)),
        ("f32", None),
    ]


def run_core(x, covariance, tol, lambda_min, max_iter, opts: CoreOptions) -> CoreResult:
    """Run the full optimizer loop (core.rs:162-401)."""
    stages = _precision_stages(opts, x.dtype)
    need_h = not opts.ortho
    need_ysq = opts.extended and not opts.ortho
    n_stages = len(stages)

    def _stage_opts(idx: int, precision: str) -> CoreOptions:
        final_stage = idx == n_stages - 1
        return dataclasses.replace(
            opts,
            kernel_precision=precision,
            # Non-final tiers exit on a plateau and cap the FALLBACK line
            # search at 3 tries; the final tier keeps the reference's
            # semantics (run to max_iter, ls_tries, 10 fallback tries).
            stage_patience=0 if final_stage else (opts.stage_patience or 10),
            fallback_ls_tries=(
                opts.fallback_ls_tries if final_stage
                else min(opts.fallback_ls_tries, 3)
            ),
            plain_ls=(precision == "bf16" and not final_stage),
            adaptive_alpha=not final_stage,
        )

    def _stage_x(stage_opts: CoreOptions, precision: str):
        # The bf16-plain tier reads a bf16 COPY of X (half the bytes of
        # the dominant pass), alive for that stage only. The N >= 16 gate
        # is carried over from the JAX package, where it is a Mosaic
        # (TPU compiler) tiling limit.
        if (stage_opts.plain_ls and precision == "bf16"
                and x.dtype == torch.float32 and opts.use_kernels
                and x.shape[0] >= 16):
            return x.to(torch.bfloat16)
        return x

    first_opts = _stage_opts(0, stages[0][0])
    x_stage = _stage_x(first_opts, stages[0][0])
    state, _ = init_state(x, covariance, first_opts, x_stage=x_stage)
    tol = _scalar(tol, x)
    lambda_min = _scalar(lambda_min, x)

    stage_exits = []
    stage_ls = []
    for idx, (precision, floor) in enumerate(stages):
        stage_opts = _stage_opts(idx, precision)
        stage_tol = tol if floor is None else torch.maximum(_scalar(floor, x), tol)
        if idx > 0:
            # Re-measure the moments at the new tier (skipped when the
            # iteration budget is spent) and reset the stall state.
            _ready(state.moments)
            if state.it < max_iter:
                moments = data_moments(state.w, x, stage_opts, need_h, need_ysq)
            else:
                moments = state.moments
            state = dataclasses.replace(
                state, w=state.w.to(w_dtype(x, stage_opts)),
                moments=moments, converged=False,
                best_gnorm=_scalar(float("inf"), x), since_improve=0,
                consec_fallbacks=0,
            )
            if x.dtype != torch.float64:
                # Clear the cross-tier L-BFGS history unless the entering
                # gnorm is >= 10x the old tier's handoff (then its pairs
                # carry little of the old tier's noise). Never at f64,
                # where every tier is the same exact arithmetic.
                prev_handoff = stages[idx - 1][1]
                keep = prev_handoff is not None and bool(
                    state.gradient_norm >= _scalar(10.0 * prev_handoff, x))
                if not keep:
                    state = dataclasses.replace(
                        state,
                        memory=dataclasses.replace(state.memory, count=0),
                        g_old=torch.zeros_like(state.g_old),
                        prev_step=torch.zeros_like(state.prev_step),
                    )
            x_stage = _stage_x(stage_opts, precision)

        while state.it < max_iter and not state.converged:
            state = _iteration_body(state, x_stage, covariance, stage_tol,
                                    lambda_min, stage_opts)
        stage_exits.append(state.n_iter_done)
        stage_ls.append(state.ls_calls)
        x_stage = None  # the stage's bf16 copy is freed here

    # Materialize the sources once, at the end.
    _ready(state.moments)
    w = state.w.to(x.dtype)
    if opts.donate_data:
        y = rotate_rows_inplace(w, x)
    else:
        y = w @ x

    return CoreResult(
        y=y,
        w=w,
        converged=state.converged,
        gradient_norm=float(state.gradient_norm),
        n_iterations=state.n_iter_done,
        signs=state.signs,
        stage_exits=tuple(stage_exits),
        ls_calls=state.ls_calls,
        stage_ls_calls=tuple(stage_ls),
    )
