"""The port's core loop against the JAX package's, on the CPU.

  * f64, torch path vs JAX XLA path, for every mode: the iteration
    counts stay within the JAX package's fork bounds (<= 2 for ortho,
    <= 8 for non-ortho, whose in-place Hessian regularization amplifies
    reduction-order ulps) and W agrees to Amari < 1e-9 (the
    JAX-vs-oracle invariant).
  * one iteration from a JAX state carried over by ``convert`` gives the
    same W, loss and moments (1e-10: one iteration of f64 arithmetic in
    two BLAS orders).
  * f32 with ``kernel_precision="auto"`` and the kernels on (their plain
    versions on the CPU) against JAX with ``use_pallas=True``
    (interpret): both converge with the same stages, and the two
    unmixings agree to Amari < 1e-4 (two f32 trajectories to tol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picard_ica_tpu.models import core as jc
from picard_ica_tpu.ops.densities import Tanh as JTanh
from picard_ica_tpu_torch import convert
from picard_ica_tpu_torch.models import core as tc
from picard_ica_tpu_torch.ops.densities import Tanh as TTanh
from picard_ica_tpu_torch.utils.metrics import amari_distance

torch.set_num_threads(2)

MODES = {
    "ortho-ext": dict(ortho=True, extended=True),
    "ortho-plain": dict(ortho=True, extended=False),
    "nonortho-ext": dict(ortho=False, extended=True),
    "nonortho-plain": dict(ortho=False, extended=False),
}


def _data(n, t, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    s = np.empty((n, t))
    for i in range(n):
        if i % 2:
            s[i] = rng.uniform(-np.sqrt(3), np.sqrt(3), t)
        else:
            s[i] = rng.laplace(size=t) / np.sqrt(2.0)
    x = rng.standard_normal((n, n)) @ s
    x -= x.mean(axis=1, keepdims=True)
    evals, evecs = np.linalg.eigh(x @ x.T / t)
    x = (evecs / np.sqrt(evals)).T @ x
    return x.astype(dtype)


def _opts(mod, use_kernels_field, use_kernels, **kw):
    base = dict(density=JTanh() if mod is jc else TTanh(), has_cov=True, m=7, ls_tries=10)
    base.update(kw)
    base[use_kernels_field] = use_kernels
    return mod.CoreOptions(**base)


@pytest.mark.parametrize("mode", list(MODES))
def test_run_core_f64_matches_jax(mode):
    kw = MODES[mode]
    x = _data(5, 3000, 1)
    rj = jc.run_core(jnp.asarray(x), jnp.eye(5), 1e-8, 0.01, 200,
                     _opts(jc, "use_pallas", False, **kw))
    rt = tc.run_core(torch.from_numpy(x.copy()), torch.eye(5, dtype=torch.float64),
                     1e-8, 0.01, 200, _opts(tc, "use_kernels", False, **kw))
    assert bool(rj.converged) and rt.converged
    fork = 2 if kw["ortho"] else 8
    assert abs(int(rj.n_iterations) - rt.n_iterations) <= fork
    assert amari_distance(rt.w.numpy(), np.linalg.inv(np.asarray(rj.w))) < 1e-9
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=1e-6, atol=1e-6)
    assert rt.stage_exits == (rt.n_iterations,)


@pytest.mark.parametrize("mode", ["ortho-ext", "nonortho-ext"])
def test_one_iteration_from_carried_state(mode):
    kw = MODES[mode]
    x = _data(4, 2000, 2)
    jopts = _opts(jc, "use_pallas", False, **kw)
    topts = _opts(tc, "use_kernels", False, **kw)
    cov_j = jnp.eye(4)
    st, _ = jc.init_state(jnp.asarray(x), cov_j, jopts)
    tol, lam = jnp.asarray(1e-9), jnp.asarray(0.01)
    for _ in range(3):
        st = jc._iteration_body(st, jnp.asarray(x), cov_j, tol, lam, jopts)
    carried = convert.core_state_from_arrays(st)
    assert carried.it == 3 and carried.memory.count == int(st.memory.count)

    nj = jc._iteration_body(st, jnp.asarray(x), cov_j, tol, lam, jopts)
    nt = tc._iteration_body(carried, torch.from_numpy(x), torch.eye(4, dtype=torch.float64),
                            torch.tensor(1e-9, dtype=torch.float64),
                            torch.tensor(0.01, dtype=torch.float64), topts)
    assert nt.it == int(nj.it) and nt.ls_calls == int(nj.ls_calls)
    np.testing.assert_allclose(nt.w.numpy(), np.asarray(nj.w), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(nt.loss), float(nj.loss), rtol=1e-10)
    for a, b in zip(nj.moments, nt.moments):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(nt.signs.numpy(), np.asarray(nj.signs))


def test_loss_and_data_passes_match_jax():
    x = _data(4, 500, 4)
    w = np.random.default_rng(5).standard_normal((4, 4))
    signs = np.array([1.0, -1.0, 1.0, -1.0])
    for kw in (MODES["ortho-ext"], MODES["nonortho-ext"]):
        for use in (False, True):
            lj = jc.compute_loss(jnp.asarray(w), jnp.asarray(x), jnp.asarray(signs),
                                 _opts(jc, "use_pallas", False, **kw))
            lt = tc.compute_loss(torch.from_numpy(w), torch.from_numpy(x),
                                 torch.from_numpy(signs), _opts(tc, "use_kernels", use, **kw))
            np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
    w2 = w + 0.01
    for plain_ls in (False, True):
        oj = _opts(jc, "use_pallas", False, ortho=False, extended=True, plain_ls=plain_ls)
        ot = _opts(tc, "use_kernels", True, ortho=False, extended=True, plain_ls=plain_ls)
        dj = jc.data_fused_step(jnp.asarray(w2), jnp.asarray(w), jnp.asarray(x), oj, True, True)
        dt = tc.data_fused_step(torch.from_numpy(w2), torch.from_numpy(w),
                                torch.from_numpy(x), ot, True, True)
        flat_j = [dj[0], dj[1], *dj[2]]
        flat_t = [dt[0], dt[1], *dt[2]]
        for a, b in zip(flat_j, flat_t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10, atol=1e-12)


def test_line_search_failure_semantics_match_jax():
    """A direction that cannot decrease the loss: both return the last
    tried candidate and the once-more-halved step."""
    x = _data(4, 1000, 6)
    jopts = _opts(jc, "use_pallas", False, ortho=True, extended=False)
    topts = _opts(tc, "use_kernels", False, ortho=True, extended=False)
    d = np.random.default_rng(7).standard_normal((4, 4))
    d = 4.0 * (d - d.T)
    w = np.eye(4)
    signs = np.ones(4)
    loss = jc.compute_loss(jnp.asarray(w), jnp.asarray(x), jnp.asarray(signs), jopts)
    # The accept test is delta < accept_slack: a slack of -10 asks for a
    # decrease no candidate reaches, so every try fails.
    rj = jc.line_search(jnp.asarray(x), jnp.asarray(w), jnp.asarray(d), jnp.asarray(signs),
                        loss, jnp.asarray(3), jopts, accept_slack=jnp.asarray(-10.0),
                        max_tries=3)
    rt = tc.line_search(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(d),
                        torch.from_numpy(signs), torch.tensor(float(loss), dtype=torch.float64),
                        3, topts, accept_slack=torch.tensor(-10.0, dtype=torch.float64),
                        max_tries=3)
    assert not bool(rj[0]) and not rt[0] and int(rj[5]) == rt[5] == 3
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(rt[2]), float(rj[2]), rtol=1e-12)
    np.testing.assert_allclose(rt[3].numpy(), np.asarray(rj[3]), rtol=1e-12)
    for a, b in zip(rj[4], rt[4]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(rt[3].numpy(), d / 8.0, rtol=1e-15)


def test_precision_stages_match_jax():
    for kp in ("auto", "f32", "bf16"):
        for use in (False, True):
            for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
                sj = jc._precision_stages(_opts(jc, "use_pallas", use, ortho=True,
                                                extended=True, kernel_precision=kp), dt_j)
                st = tc._precision_stages(_opts(tc, "use_kernels", use, ortho=True,
                                                extended=True, kernel_precision=kp), dt_t)
                assert sj == st


def test_staged_f32_kernels_match_jax_pallas():
    """N=16 takes the bf16 X copy in the first tier of both packages."""
    x = _data(16, 4000, 8, np.float32)
    jopts = _opts(jc, "use_pallas", True, ortho=True, extended=True, kernel_precision="auto")
    topts = _opts(tc, "use_kernels", True, ortho=True, extended=True, kernel_precision="auto")
    rj = jc.run_core(jnp.asarray(x), jnp.eye(16, dtype=jnp.float32), 1e-6, 0.01, 200, jopts)
    rt = tc.run_core(torch.from_numpy(x.copy()), torch.eye(16), 1e-6, 0.01, 200, topts)
    assert bool(rj.converged) and rt.converged
    assert len(rt.stage_exits) == len(np.asarray(rj.stage_exits)) == 3
    assert rt.w.dtype == torch.float32 and rt.y.dtype == torch.float32
    am = amari_distance(rt.w.double().numpy(), np.linalg.inv(np.asarray(rj.w, np.float64)))
    assert am < 1e-4, am


@pytest.fixture(scope="module")
def near_identity():
    """f32 data whose optimum is the core W expm(S), |S| ~ 3e-3 (W near
    the identity, as after a warm start), and the kernel path's options."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.ops.linalg import matrix_exp

    n = 32
    x = _data(n, 20_000, 7)
    r = Picard.fit(x, PicardConfig(random_state=0, dtype=torch.float64, tol=1e-10,
                                   centering=False, whiten=False), device="cpu")
    rng = np.random.default_rng(0)

    def skew(scale):
        a = rng.standard_normal((n, n)) * scale
        return torch.from_numpy(a - a.T)

    s = skew(3e-3)
    x32 = (matrix_exp(-s) @ r.full_unmixing() @ torch.from_numpy(x)).float()
    opts = _opts(tc, "use_kernels", True, ortho=True, extended=True, has_cov=False)
    return x32, [matrix_exp(s + skew(scale)) for scale in (1e-6, 3e-7)], opts


@pytest.mark.parametrize("case", [0, 1], ids=["gnorm-6e-7", "gnorm-2e-7"])
def test_delta_stage_holds_w_in_f64(near_identity, case):
    """Near the identity an f32 W cannot take the small steps of a
    converging fit: its candidate's rounding raises the loss by ~100x
    what the step lowers it, so every try fails. The delta stages hold W
    in f64 and the kernels' f32 pass then measures the step's own loss
    change; the plain-accept stage keeps X's dtype."""
    x32, ws, opts = near_identity
    assert tc.w_dtype(x32, opts) == torch.float64
    assert tc.w_dtype(x32, tc.dataclasses.replace(opts, plain_ls=True)) == torch.float32
    w = ws[case]
    mom = tc.data_moments(w, x32, opts, False, False)
    signs = torch.where(mom.pm_raw - torch.diagonal(mom.g_raw) >= 0, 1.0, -1.0)
    g = signs[:, None] * mom.g_raw
    g = 0.5 * (g - g.T)
    assert 1e-7 < float(g.abs().max()) < 1e-6
    x64, dens = x32.double(), TTanh()

    def exact(w_new, w_old):
        ll = dens.log_lik(w_new.double() @ x64) - dens.log_lik(w_old.double() @ x64)
        return float(torch.sum(signs.double() * ll.mean(dim=1)))

    zero = torch.tensor(0.0)
    ok64, w_new, delta64, *_ = tc.line_search(x32, w, -g, signs, zero, 1, opts, max_tries=1)
    assert ok64 and w_new.dtype == torch.float64
    gain = exact(w_new, w)
    assert gain < 0
    np.testing.assert_allclose(float(delta64), gain, rtol=1e-2)
    # The same try from the f32 W: the pass measures its candidate
    # faithfully, and that candidate is worse than W.
    w32 = w.float()
    ok32, w_new32, delta32, *_ = tc.line_search(x32, w32, -g, signs, zero, 1, opts,
                                                max_tries=1)
    np.testing.assert_allclose(float(delta32), exact(w_new32, w32), rtol=1e-3)
    assert not ok32 and float(delta32) > 30 * abs(gain)
