"""The port's JADE warm start against the JAX package's, on the CPU, in f64.

  * ``_pair_indices`` and ``_round_robin_schedule`` equal the JAX
    package's for n = 1..9;
  * the half-pair Gram and the cumulant matrices agree to 1e-10 (chunk
    sizes that do and do not divide T), and the cumulants match the
    naive O(N^4 T) formula (``tests/test_jade.py``'s mirror of
    jade.rs:78-131) to 1e-8;
  * ``_jacobi_sweeps`` at n = 2, 3, 5, 8 (odd n run the phantom pair):
    the same sweep count and V to 1e-9;
  * ``jade``: the JAX result to 1e-9, the n = 1 identity, orthogonality,
    separation at 4 x 20,000 to Amari < 0.01;
  * ``Picard.fit`` with ``jade_it=50`` against the JAX facade: unmixings
    within Amari 1e-8, iteration counts within 2 (the fork bound
    ``tests/test_native.py`` allows ortho fits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picard_ica_tpu as J
import picard_ica_tpu_torch as P
from picard_ica_tpu.models import jade as jjade
from picard_ica_tpu_torch.models import jade as tjade
from picard_ica_tpu_torch.utils import (
    amari_distance,
    generate_mixed_kurtosis_data,
    generate_test_data,
)

torch.set_num_threads(2)


def _whiten(x):
    x = x - x.mean(axis=1, keepdims=True)
    e, u = np.linalg.eigh(x @ x.T / x.shape[1])
    k = (u / np.sqrt(e)) @ u.T
    return k @ x, k


def _whitened_mixture(n, t, seed):
    _, a, x = generate_mixed_kurtosis_data(n, t, seed)
    xw, k = _whiten(x)
    return xw, k, a


def _naive_cumulants(x):
    """Direct O(N^4 T) mirror of jade.rs:78-131 for small cases."""
    n, t = x.shape
    xx = np.einsum("it,jt->ijt", x, x)
    mats = []
    for i in range(n):
        for j in range(i, n):
            q = np.empty((n, n))
            for k in range(n):
                for l in range(n):
                    e = float(np.dot(xx[i, j], xx[k, l])) / t
                    d1 = 1.0 if (i == j and k == l) else 0.0
                    d2 = 1.0 if (i == k and j == l) else 0.0
                    d3 = 1.0 if (i == l and j == k) else 0.0
                    q[k, l] = e - d1 - d2 - d3
            mats.append((q + q.T) / 2)
    return np.stack(mats)


@pytest.mark.parametrize("n", range(1, 10))
def test_schedules_equal_jax(n):
    for ours, theirs in zip(tjade._pair_indices(n), jjade._pair_indices(n)):
        np.testing.assert_array_equal(ours, theirs)
        assert ours.dtype == theirs.dtype
    if n >= 2:
        for ours, theirs in zip(tjade._round_robin_schedule(n),
                                jjade._round_robin_schedule(n)):
            np.testing.assert_array_equal(ours, theirs)
            assert ours.dtype == theirs.dtype


@pytest.mark.parametrize("chunk", [500, 1000, 3000, 4096], ids=lambda c: f"chunk{c}")
def test_gram_and_cumulants_match_jax(chunk):
    """Chunk sizes that divide T = 3,000 (4,096 is clipped to T)."""
    x, _, _ = _whitened_mixture(4, 3000, 2)
    gj = np.asarray(jjade._pair_product_gram(jnp.asarray(x), chunk))
    gt = tjade._pair_product_gram(torch.from_numpy(x), chunk)
    assert gt.shape == (10, 16) and gt.dtype == torch.float64
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-10, atol=1e-10)
    cj = np.asarray(jjade.compute_cumulant_matrices(jnp.asarray(x), chunk))
    ct = tjade.compute_cumulant_matrices(torch.from_numpy(x), chunk)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-10)


@pytest.mark.parametrize("chunk", [700, 1024], ids=lambda c: f"chunk{c}")
def test_cumulants_ragged_chunks_match_jax(chunk):
    """Chunk sizes that do not divide T = 3,000: the last chunk is
    zero-padded in both packages."""
    x, _, _ = _whitened_mixture(5, 3000, 3)
    gj = np.asarray(jjade._pair_product_gram(jnp.asarray(x), chunk))
    gt = tjade._pair_product_gram(torch.from_numpy(x), chunk).numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-10, atol=1e-10)
    cj = np.asarray(jjade.compute_cumulant_matrices(jnp.asarray(x), chunk))
    ct = tjade.compute_cumulant_matrices(torch.from_numpy(x), chunk).numpy()
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [2, 3])
def test_cumulants_match_naive(n):
    x, _, _ = _whitened_mixture(n, 500, 42)
    ours = tjade.compute_cumulant_matrices(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, _naive_cumulants(x), atol=1e-8)


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_jacobi_sweeps_match_jax(n):
    x, _, _ = _whitened_mixture(n, 4000, 10 + n)
    cum = np.asarray(jjade.compute_cumulant_matrices(jnp.asarray(x)))
    vj, sj = jjade._jacobi_sweeps(jnp.asarray(cum), n, 50, jnp.asarray(1e-6), False)
    vt, st = tjade._jacobi_sweeps(torch.from_numpy(cum.copy()), n, 50, 1e-6, False)
    assert st == int(sj) and st >= 1
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-9)


def test_jacobi_sweeps_stop_at_max_iter():
    x, _, _ = _whitened_mixture(5, 2000, 4)
    cum = tjade.compute_cumulant_matrices(torch.from_numpy(x))
    v, sweeps = tjade._jacobi_sweeps(cum.clone(), 5, 1, 1e-6, False)
    assert sweeps == 1
    np.testing.assert_allclose(v.numpy() @ v.numpy().T, np.eye(5), atol=1e-12)


def test_jacobi_sweeps_carry_the_rotated_cumulants():
    """On return the consumed buffer holds V^T Q V (the carried R)."""
    x, _, _ = _whitened_mixture(5, 2000, 6)
    cum = tjade.compute_cumulant_matrices(torch.from_numpy(x))
    q = cum.clone()
    v, _ = tjade._jacobi_sweeps(cum, 5, 50, 1e-6, False)
    np.testing.assert_allclose(cum.numpy(), (v.T @ q @ v).numpy(), atol=1e-12)


@pytest.mark.parametrize("n", [3, 6])
def test_jade_matches_jax(n):
    x, _, _ = _whitened_mixture(n, 5000, 20 + n)
    wj, mj = jjade.jade(jnp.asarray(x), 50, 1e-6)
    wt, mt = tjade.jade(torch.from_numpy(x), 50, 1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-9)
    assert float(mt) == pytest.approx(float(mj), rel=1e-9)


def test_jade_single_component_identity():
    """(jade.rs:25-27) n < 2 returns the identity."""
    w, min_eig = tjade.jade(torch.ones((1, 100), dtype=torch.float64), 10, 1e-6)
    np.testing.assert_array_equal(w.numpy(), np.eye(1))
    assert float(min_eig) == 1.0


def test_jade_output_orthogonal():
    """(jade.rs:208-256) W W^T == I."""
    x, _, _ = _whitened_mixture(3, 1000, 42)
    w, _ = tjade.jade(torch.from_numpy(x), 100, 1e-6)
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(3), atol=1e-6)


def test_jade_separates_mixed_kurtosis():
    """JADE alone recovers the sources (unlike the reference, whose sweeps
    oscillate — the JAX package's orientation fix)."""
    xw, k, a = _whitened_mixture(4, 20_000, 7)
    w, _ = tjade.jade(torch.from_numpy(xw), 100, 1e-6)
    assert amari_distance(w.numpy() @ k, a) < 0.01


def test_jade_f32_on_f32_data():
    xw, k, a = _whitened_mixture(4, 20_000, 7)
    w, min_eig = tjade.jade(torch.from_numpy(xw.astype(np.float32)), 50)
    assert w.dtype == torch.float32 and float(min_eig) > 0.99
    assert amari_distance(w.double().numpy() @ k, a) < 0.01


def test_jade_prints_sweeps(capsys):
    x, _, _ = _whitened_mixture(3, 2000, 1)
    tjade.jade(torch.from_numpy(x), 50, 1e-6, verbose=True)
    err = capsys.readouterr().err
    assert "JADE: 6 cumulant matrices computed" in err
    assert "JADE iteration 1: max angle = " in err


@pytest.mark.parametrize("case", ["test_data", "mixed"])
def test_fit_with_jade_matches_jax(case):
    """tests/test_solver.py's JADE case, and an 8 x 20,000 mixed mixture,
    through both facades in f64."""
    if case == "test_data":
        _, a, x = generate_test_data(3, 2000, 42)
    else:
        _, a, x = generate_mixed_kurtosis_data(8, 20_000, 1)
    rj = J.Picard.fit(x, J.PicardConfig(jade_it=50, random_state=42))
    rt = P.Picard.fit(x, P.PicardConfig(jade_it=50, random_state=42, dtype=torch.float64),
                      device="cpu")
    assert rt.converged and bool(rj.converged)
    assert abs(rt.n_iterations - rj.n_iterations) <= 2
    w_t = rt.full_unmixing().numpy()
    assert amari_distance(w_t, np.linalg.inv(np.asarray(rj.full_unmixing()))) < 1e-8
    assert amari_distance(w_t, a) < 1e-2


def test_fit_with_jade_overrides_w_init():
    """w_init together with jade_it is allowed, and JADE overrides it."""
    _, _, x = generate_test_data(3, 2000, 42)
    cfg = P.PicardConfig(jade_it=50, random_state=42, dtype=torch.float64)
    plain = P.Picard.fit(x, cfg, device="cpu")
    w0 = np.linalg.qr(np.random.default_rng(1).standard_normal((3, 3)))[0]
    with_w = P.Picard.fit(x, cfg.replace(w_init=w0), device="cpu")
    assert with_w.n_iterations == plain.n_iterations
    np.testing.assert_array_equal(with_w.unmixing.numpy(), plain.unmixing.numpy())


def test_fit_with_jade_prints_the_jax_lines(capsys):
    _, _, x = generate_test_data(3, 1000, 4)
    P.Picard.fit(x, P.PicardConfig(jade_it=5, random_state=0, verbose=True,
                                   dtype=torch.float64), device="cpu")
    err = capsys.readouterr().err
    assert "Running 5 iterations of JADE..." in err
    assert "JADE: 6 cumulant matrices computed" in err


def test_both_warm_starts_raise_invalid_config():
    _, _, x = generate_test_data(3, 1000, 4)
    with pytest.raises(P.InvalidConfigError, match="fastica_it and jade_it"):
        P.Picard.fit(x, P.PicardConfig(jade_it=5, fastica_it=5), device="cpu")


def test_jade_singular_result_raises(monkeypatch):
    from picard_ica_tpu_torch import solver

    _, _, x = generate_test_data(3, 1000, 4)
    monkeypatch.setattr(solver, "jade", lambda x1, it, tol, verbose, data_sharding: (
        torch.eye(3, dtype=x1.dtype), torch.zeros((), dtype=x1.dtype)))
    with pytest.raises(P.SingularMatrixError):
        P.Picard.fit(x, P.PicardConfig(jade_it=5, random_state=0), device="cpu")
