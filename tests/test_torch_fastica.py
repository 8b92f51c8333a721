"""The port's FastICA warm start against the JAX package's, on the CPU.

``models/fastica.ica_par`` against ``picard_ica_tpu.models.fastica.ica_par``
for the three densities at N = 6, T = 5,000, 5 iterations, in f64: W to
1e-10 and the smallest eigenvalue seen to 1e-12 relative (the same f64
algorithm; eigh and BLAS summation orders differ). The JAX package's
f64 C++ oracle is a further reference where it is built. Then
``Picard.fit`` with ``fastica_it=10`` against the JAX facade: the
unmixings within Amari 1e-8 and the iteration counts within 2 (the fork
bound of an ortho fit that ``tests/test_native.py`` allows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picard_ica_tpu as J
import picard_ica_tpu_torch as P
from picard_ica_tpu.models import fastica as jfastica
from picard_ica_tpu_torch.models.fastica import ica_par
from picard_ica_tpu_torch.utils import amari_distance, generate_test_data

torch.set_num_threads(2)

DENSITIES = [("tanh", J.Tanh(), P.Tanh()), ("exp", J.Exp(), P.Exp()),
             ("cube", J.Cube(), P.Cube())]


def _whitened(n, t, seed):
    _, _, x = generate_test_data(n, t, seed)
    x = x - x.mean(axis=1, keepdims=True)
    e, u = np.linalg.eigh(x @ x.T / t)
    return (u / np.sqrt(e)) @ u.T @ x


@pytest.fixture(scope="module")
def data():
    x = _whitened(6, 5000, 11)
    w0 = np.random.default_rng(5).standard_normal((6, 6))
    return x, w0


@pytest.mark.parametrize("name,jd,td", DENSITIES, ids=[d[0] for d in DENSITIES])
def test_ica_par_matches_jax(data, name, jd, td):
    x, w0 = data
    wj, mj = jfastica.ica_par(jnp.asarray(x), jd, 5, jnp.asarray(w0))
    wt, mt = ica_par(torch.from_numpy(x), td, 5, torch.from_numpy(w0))
    assert wt.dtype == torch.float64 and wt.shape == (6, 6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-10)
    assert float(mt) == pytest.approx(float(mj), rel=1e-12)


@pytest.mark.parametrize("name,jd,td", DENSITIES, ids=[d[0] for d in DENSITIES])
def test_ica_par_matches_native_oracle(data, name, jd, td):
    from picard_ica_tpu import native

    if not native.available():
        pytest.skip("the JAX package's native oracle is not built")
    x, w0 = data
    w_o = native.oracle_ica_par(x, w0, 5, density=name, alpha=getattr(td, "alpha", 1.0))
    wt, _ = ica_par(torch.from_numpy(x), td, 5, torch.from_numpy(w0))
    np.testing.assert_allclose(wt.numpy(), w_o, rtol=0, atol=1e-10)


def test_ica_par_zero_iterations_decorrelates(data):
    x, w0 = data
    wt, mt = ica_par(torch.from_numpy(x), P.Tanh(), 0, torch.from_numpy(w0))
    np.testing.assert_allclose(wt.numpy() @ wt.numpy().T, np.eye(6), atol=1e-12)
    assert float(mt) == pytest.approx(float(np.linalg.eigvalsh(w0 @ w0.T).min()), rel=1e-10)


def test_fit_with_fastica_matches_jax():
    """tests/test_solver.py's FastICA case, through both facades in f64."""
    _, a, x = generate_test_data(4, 3000, 123)
    rj = J.Picard.fit(x, J.PicardConfig(fastica_it=10, random_state=42))
    rt = P.Picard.fit(x, P.PicardConfig(fastica_it=10, random_state=42,
                                        dtype=torch.float64), device="cpu")
    assert rt.converged and bool(rj.converged)
    assert abs(rt.n_iterations - rj.n_iterations) <= 2
    w_t = rt.full_unmixing().numpy()
    assert amari_distance(w_t, np.linalg.inv(np.asarray(rj.full_unmixing()))) < 1e-8
    assert amari_distance(w_t, a) < 1e-2


def test_fit_with_fastica_f32_separates():
    _, a, x = generate_test_data(4, 3000, 123)
    r = P.Picard.fit(x, P.PicardConfig(fastica_it=10, random_state=42), device="cpu")
    assert r.converged and r.unmixing.dtype == torch.float32
    assert amari_distance(r.full_unmixing().double().numpy(), a) < 1e-2


def test_fit_with_fastica_prints_the_jax_lines(capsys):
    _, _, x = generate_test_data(3, 1000, 4)
    P.Picard.fit(x, P.PicardConfig(fastica_it=3, random_state=0, verbose=True,
                                   dtype=torch.float64), device="cpu")
    err = capsys.readouterr().err
    assert "Running 3 iterations of FastICA..." in err
    assert "FastICA pre-iterations complete." in err


def test_fastica_singular_start_raises(monkeypatch):
    """A decorrelation below the singularity floor raises, as in the JAX
    package."""
    from picard_ica_tpu_torch import solver

    _, _, x = generate_test_data(3, 1000, 4)
    monkeypatch.setattr(solver, "ica_par",
                        lambda x1, d, it, w, data_sharding: (w, torch.zeros((), dtype=w.dtype)))
    with pytest.raises(P.SingularMatrixError):
        P.Picard.fit(x, P.PicardConfig(fastica_it=3, random_state=0), device="cpu")
