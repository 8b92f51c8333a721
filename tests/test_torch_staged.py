"""The staged schedule's bf16 stage held to the JAX package's from one
state, on the CPU.

At 64 x 100,000 (``generate_mixed_kurtosis_data(64, 100_000, 0)``, float64
NumPy, host-f64 whitening), ``random_state=0``, tol 1e-7, the port's staged
fit on the torch path with 8 torch threads leaves the separation in its
bf16 stage and ends unconverged after 200 iterations (stage exits 31, 69,
200; gradient norm 0.265, Amari 5.84 to the mixing). Entering its 21st
iteration, an L-BFGS pair measured on the bf16 tier's noisy gradients
has a curvature near zero, the two-loop recursion returns a direction of
max-norm 1.2e5, and the plain bf16 accept takes the first try (alpha
2^-5) because its loss is lower; the next moments flip 21 signs of the
extended rule and the gradient norm goes from 0.02 to 0.14.

That is the staged schedule's own behaviour, which the JAX package
shares: from the same state it takes the same step (below), and on the
same input its fits diverge about as often as the port's. A scan of 40
inputs on the CPU, data seeds 0-7 at 64 x 100k and 32 x 100k and 24
perturbations of seed 0's data (x (1 + 2e-7 n), n standard normal),
counting fits that end unconverged with Amari > 5e-3: the JAX package's
Pallas path (interpret mode) 1 of 40, its XLA path 1 of 40 (the same
perturbation), the port with one thread 0 of 40, with its default of 8
threads 3 of 40 (seed 0 itself among them). Which rounding order meets
the step is chance.

Both tests start from the port's state entering that iteration (a hook on
``models.core._iteration_body``, 8 threads):
  * from that state the port's iteration and the JAX package's (XLA path;
    Pallas in interpret mode on the bf16 copy of X) take the same number
    of tries, accept the same step size, land on the same W and flip the
    same signs after it;
  * restarted from the W after the step (``w_init``) in the exact f32
    tier, both packages follow the same gradient norms and stay together
    (Amari between the two unmixings), and neither has converged.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picard_ica_tpu as J
import picard_ica_tpu_torch as P
from picard_ica_tpu.models import core as jc
from picard_ica_tpu.ops import densities as jd
from picard_ica_tpu.ops import moments as jm
from picard_ica_tpu_torch import solver as ps
from picard_ica_tpu_torch.models import core as pc
from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

N, T, SEED = 64, 100_000, 0
# The port's default thread count here, at which its fit meets the step;
# the iteration (0-based ``it`` of the state entering it) of that step.
THREADS, STEP_IT = 8, 20
# Iterations of the restarted f32 fits.
RESTART_ITER = 8
_GNORM = re.compile(r"iteration (\d+), gradient norm = ([0-9.e+-]+)")


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def step_state():
    """The port's state entering iteration STEP_IT of the staged fit, with
    the data, options and constants that iteration reads, and the fit's
    w_init (the core's W is relative to the pre-rotated data)."""
    _, a, x = generate_mixed_kurtosis_data(N, T, SEED)
    captured = {}
    inner, rotate = pc._iteration_body, ps.rotate_rows_inplace

    def body(st, xs, cov, tol, lmin, opts):
        if st.it == STEP_IT:
            captured.update(st=st, x=xs, cov=cov, tol=tol, lmin=lmin, opts=opts)
            raise _Captured
        return inner(st, xs, cov, tol, lmin, opts)

    def pre_rotate(w_init, x1):
        captured["w_init"] = w_init.clone()
        return rotate(w_init, x1)

    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    pc._iteration_body, ps.rotate_rows_inplace = body, pre_rotate
    try:
        with pytest.raises(_Captured):
            P.Picard.fit(x, P.PicardConfig(random_state=0, tol=1e-7, max_iter=200,
                                           use_kernels=False), device="cpu")
    finally:
        pc._iteration_body, ps.rotate_rows_inplace = inner, rotate
        torch.set_num_threads(threads)
    captured.update(a=a, x_raw=x)
    return captured


def _jax_state(st):
    """The port's CoreState as the JAX package's."""
    def j(v):
        return jnp.asarray(v.numpy())

    def i32(v):
        return jnp.asarray(int(v), jnp.int32)

    mem = jc.LbfgsMemory(j(st.memory.s_mem), j(st.memory.y_mem), j(st.memory.r_mem),
                         i32(st.memory.count))
    return jc.CoreState(
        w=j(st.w), loss=j(st.loss), signs=j(st.signs), old_signs=j(st.old_signs), c=j(st.c),
        g_old=j(st.g_old), prev_step=j(st.prev_step), memory=mem,
        moments=jm.RawMoments(*(j(v) for v in st.moments)), it=i32(st.it),
        n_iter_done=i32(st.n_iter_done), gradient_norm=j(st.gradient_norm),
        converged=jnp.asarray(False), best_gnorm=j(st.best_gnorm),
        since_improve=i32(st.since_improve), consec_fallbacks=i32(st.consec_fallbacks),
        ls_calls=i32(st.ls_calls), prev_alpha_exp=i32(st.prev_alpha_exp))


def _jax_options(opts, use_pallas):
    density = {"Tanh": jd.Tanh, "Exp": jd.Exp, "Cube": jd.Cube}[type(opts.density).__name__]()
    return jc.CoreOptions(
        density=density, ortho=opts.ortho, extended=opts.extended, has_cov=opts.has_cov,
        m=opts.m, ls_tries=opts.ls_tries, use_pallas=use_pallas,
        kernel_precision=opts.kernel_precision, stage_patience=opts.stage_patience,
        fallback_ls_tries=opts.fallback_ls_tries, plain_ls=opts.plain_ls,
        adaptive_alpha=opts.adaptive_alpha)


def _f64(v):
    return np.asarray(v, np.float64)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
def test_bf16_step_from_one_state(step_state, use_pallas):
    s = step_state
    st, opts = s["st"], s["opts"]
    assert opts.kernel_precision == "bf16" and opts.plain_ls and opts.adaptive_alpha
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        p1 = pc._iteration_body(st, s["x"], s["cov"], s["tol"], s["lmin"], opts)
        p2 = pc._iteration_body(p1, s["x"], s["cov"], s["tol"], s["lmin"], opts)
    finally:
        torch.set_num_threads(threads)

    jx = jnp.asarray(s["x"].numpy())
    if use_pallas:
        jx = jx.astype(jnp.bfloat16)  # the Pallas path's bf16-stage copy
    args = (None if s["cov"] is None else jnp.asarray(s["cov"].numpy()),
            jnp.asarray(s["tol"].numpy()), jnp.asarray(s["lmin"].numpy()),
            _jax_options(opts, use_pallas))
    j0 = _jax_state(st)
    j1 = jc._iteration_body(j0, jx, *args)
    j2 = jc._iteration_body(j1, jx, *args)

    # the same decision: tries, accepted step size, no fallback
    assert int(j1.ls_calls) - int(j0.ls_calls) == p1.ls_calls - st.ls_calls == 1
    assert int(j1.prev_alpha_exp) == p1.prev_alpha_exp == 5
    assert int(j1.consec_fallbacks) == p1.consec_fallbacks == 0
    step_p, step_j = _f64(p1.prev_step), _f64(j1.prev_step)
    assert np.abs(step_p).max() > 1e3  # the direction of max-norm ~1e5, times 2^-5
    np.testing.assert_allclose(step_j, step_p, rtol=0, atol=1e-3 * np.abs(step_p).max())
    # W after it: expm of a step of max-norm ~4e3 turns the two directions'
    # f32 differences (~1e-6 relative) into ~0.05 in W; the signs and the
    # gradient norm that its moments give are the same
    np.testing.assert_allclose(_f64(j1.w), _f64(p1.w), rtol=0, atol=0.1)
    np.testing.assert_array_equal(_f64(j2.signs), _f64(p2.signs))
    assert int((_f64(p2.signs) != _f64(p1.signs)).sum()) >= 10
    assert float(p2.gradient_norm) > 0.1 and float(j2.gradient_norm) > 0.1
    np.testing.assert_allclose(float(j2.gradient_norm), float(p2.gradient_norm), rtol=0.02)
    np.testing.assert_allclose(float(j1.loss), float(p1.loss), rtol=0, atol=0.02)


def _gnorms(fit):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = fit()
        jax.effects_barrier()
    return r, [float(g) for _, g in _GNORM.findall(buf.getvalue())]


def test_restart_from_one_w(step_state):
    s = step_state
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        p1 = pc._iteration_body(s["st"], s["x"], s["cov"], s["tol"], s["lmin"], s["opts"])
    finally:
        torch.set_num_threads(threads)
    w_start = (p1.w @ s["w_init"]).double().numpy()  # in the whitened basis
    common = dict(w_init=w_start, kernel_precision="f32", tol=1e-7,
                  max_iter=RESTART_ITER, verbose=True)
    rp, gp = _gnorms(lambda: P.Picard.fit(
        s["x_raw"], P.PicardConfig(use_kernels=False, **common), device="cpu"))
    rj, gj = _gnorms(lambda: J.Picard.fit(
        s["x_raw"], J.PicardConfig(use_pallas=False, dtype=jnp.float32, **common)))
    wp, wj = rp.full_unmixing().double().numpy(), _f64(rj.full_unmixing())
    # far from the separation, both, and not converged
    assert amari_distance(wp, s["a"]) > 1.0 and amari_distance(wj, s["a"]) > 1.0
    assert not rp.converged and not bool(rj.converged)
    assert int(rp.n_iterations) == int(rj.n_iterations) == RESTART_ITER
    assert len(gp) == len(gj) >= RESTART_ITER - 1
    np.testing.assert_allclose(gj, gp, rtol=0.01)
    assert amari_distance(wp, np.linalg.inv(wj)) < 1e-3
