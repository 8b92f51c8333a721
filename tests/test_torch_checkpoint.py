"""The port's checkpoints and density check, on the CPU.

Mirrors ``tests/test_checkpoint.py``'s seven cases for
``picard_ica_tpu_torch.checkpoint`` (f64 fits, ``device="cpu"``), then
holds the file format to the JAX package's in both directions: a file
the JAX package saved loads in the port and a file the port saved loads
in the JAX package, every field equal, and both write the same keys
with the same dtypes. ``utils.check_density`` agrees with the JAX
package's for the three densities and fails a broken one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import picard_ica_tpu as J
import picard_ica_tpu_torch as P
from picard_ica_tpu.utils.metrics import check_density as jax_check_density
from picard_ica_tpu_torch.checkpoint import load_result, resume_config, save_result
from picard_ica_tpu_torch.utils import amari_distance, check_density, generate_test_data

torch.set_num_threads(2)


def _fit(x, **config):
    return P.Picard.fit(x, P.PicardConfig(dtype=torch.float64, **config), device="cpu")


def _as_np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def fitted():
    _, mixing, x = generate_test_data(5, 20_000, seed=9)
    config = P.PicardConfig(random_state=1, max_iter=200, dtype=torch.float64)
    return x, mixing, config, P.Picard.fit(x, config, device="cpu")


def _assert_fields_equal(orig, got, skip=()):
    for field in dataclasses.fields(orig):
        if field.name in skip:
            continue
        a, b = getattr(orig, field.name), getattr(got, field.name)
        if a is None:
            assert b is None, field.name
        elif hasattr(a, "shape") and len(a.shape) > 0:
            np.testing.assert_array_equal(_as_np(a), _as_np(b), err_msg=field.name)
            assert _as_np(a).dtype == _as_np(b).dtype, field.name
        else:
            assert b == a, field.name


def test_round_trip(tmp_path, fitted):
    x, _, _, result = fitted
    p = tmp_path / "fit.npz"
    save_result(p, result)
    loaded = load_result(p, device="cpu")
    for name in ("unmixing", "whitening", "sources", "mean"):
        assert isinstance(getattr(loaded, name), torch.Tensor)
        assert torch.equal(getattr(result, name), getattr(loaded, name)), name
    assert loaded.n_iterations == result.n_iterations
    assert loaded.converged == result.converged
    assert loaded.gradient_norm == pytest.approx(result.gradient_norm)


def test_round_trip_preserves_every_field(tmp_path, fitted):
    """Every field but the run's own core_seconds, which format 2 does not
    hold, comes back equal."""
    _, _, _, result = fitted
    p = tmp_path / "fit.npz"
    save_result(p, result)
    loaded = load_result(p, device="cpu")
    assert result.stage_exits is not None and result.stage_precisions is not None
    assert result.ls_calls is not None and result.stage_ls_calls is not None
    _assert_fields_equal(result, loaded, skip=("core_seconds",))
    assert result.core_seconds is not None and loaded.core_seconds is None
    with np.load(p) as z:
        assert "core_seconds" not in z


def test_version_1_checkpoint_still_loads(tmp_path, fitted):
    _, _, _, result = fitted
    p = tmp_path / "fit_v1.npz"
    with open(p, "wb") as f:
        np.savez(
            f,
            format_version=np.asarray(1),
            unmixing=result.unmixing.numpy(),
            n_iterations=np.asarray(result.n_iterations),
            converged=np.asarray(result.converged),
            gradient_norm=np.asarray(result.gradient_norm),
        )
    loaded = load_result(p, device="cpu")
    assert torch.equal(result.unmixing, loaded.unmixing)
    assert loaded.stage_exits is None and loaded.stage_precisions is None
    assert loaded.ls_calls is None and loaded.stage_ls_calls is None


def test_future_version_rejected(tmp_path):
    p = tmp_path / "future.npz"
    with open(p, "wb") as f:
        np.savez(f, format_version=np.asarray(99),
                 unmixing=np.eye(2), n_iterations=np.asarray(1),
                 converged=np.asarray(True), gradient_norm=np.asarray(0.0))
    with pytest.raises(ValueError, match="newer than supported"):
        load_result(p, device="cpu")


def test_round_trip_without_sources_and_optionals(tmp_path):
    _, _, x = generate_test_data(4, 5_000, seed=3)
    result = _fit(x, random_state=0, whiten=False, centering=False,
                  extended=False, max_iter=100)
    assert result.whitening is None and result.mean is None

    p = tmp_path / "fit.npz"
    save_result(p, result, include_sources=False)
    loaded = load_result(p, device="cpu")
    assert loaded.sources is None and loaded.whitening is None
    assert loaded.mean is None and loaded.signs is None
    assert torch.equal(result.unmixing, loaded.unmixing)
    # transform still works from the checkpoint alone.
    y = P.Picard.transform(x, loaded)
    assert y.shape == (4, 5_000)


def test_resume_reaches_tighter_tolerance(tmp_path, fitted):
    x, _, config, result = fitted
    p = tmp_path / "fit.npz"
    save_result(p, result)
    prev = load_result(p, device="cpu")

    cfg2 = resume_config(prev, config.replace(tol=1e-9, max_iter=300, jade_it=5))
    assert cfg2.jade_it is None and cfg2.fastica_it is None
    assert isinstance(cfg2.w_init, np.ndarray)
    result2 = P.Picard.fit(x, cfg2, device="cpu")
    assert result2.n_iterations <= result.n_iterations
    assert result2.gradient_norm <= result.gradient_norm * 10


def test_resume_on_fresh_data_from_same_sources():
    rng = np.random.default_rng(33)
    mixing = rng.standard_normal((4, 4))
    s_a = rng.laplace(size=(4, 20_000))
    s_b = rng.laplace(size=(4, 20_000))

    res_a = _fit(mixing @ s_a, random_state=0, tol=1e-6)
    assert res_a.converged
    cold = _fit(mixing @ s_b, random_state=0, tol=1e-6)
    cfg = P.PicardConfig(random_state=0, tol=1e-6, dtype=torch.float64)
    warm = P.Picard.fit(mixing @ s_b, resume_config(res_a, cfg), device="cpu")
    assert warm.converged
    assert warm.n_iterations <= cold.n_iterations
    assert amari_distance(warm.full_unmixing().numpy(), mixing) < 5e-3


def test_jax_file_loads_in_the_port(tmp_path, fitted):
    x, _, _, _ = fitted
    rj = J.Picard.fit(x, J.PicardConfig(random_state=1, max_iter=200))
    p = tmp_path / "jax.npz"
    J.save_result(p, rj)
    loaded = P.load_result(p, device="cpu")
    _assert_fields_equal(J.load_result(p), loaded)
    np.testing.assert_array_equal(loaded.unmixing.numpy(), np.asarray(rj.unmixing))
    assert loaded.stage_precisions == tuple(rj.stage_precisions)


def test_port_file_loads_in_the_jax_package(tmp_path, fitted):
    x, _, _, result = fitted
    p = tmp_path / "port.npz"
    P.save_result(p, result)
    loaded = J.load_result(p)
    _assert_fields_equal(result, loaded, skip=("core_seconds",))
    # The JAX package's transform runs from the port's file.
    y = np.asarray(J.Picard.transform(x[:, :200], loaded))
    np.testing.assert_allclose(y, result.sources.numpy()[:, :200], rtol=1e-9, atol=1e-9)


def test_both_packages_write_the_same_keys_and_dtypes(tmp_path, fitted):
    x, _, _, result = fitted
    rj = J.Picard.fit(x, J.PicardConfig(random_state=1, max_iter=200))
    J.save_result(tmp_path / "jax.npz", rj)
    P.save_result(tmp_path / "port.npz", result)
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert zj[key].dtype == zt[key].dtype, key
            assert zj[key].shape == zt[key].shape, key


def test_load_result_needs_cuda_or_a_device(tmp_path, fitted, monkeypatch):
    _, _, _, result = fitted
    p = tmp_path / "fit.npz"
    save_result(p, result)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_result(p)


DENSITIES = [(J.Tanh(), P.Tanh()), (J.Exp(), P.Exp()), (J.Cube(), P.Cube()),
             (J.Tanh(1.5), P.Tanh(1.5)), (J.Exp(0.5), P.Exp(0.5))]


@pytest.mark.parametrize("jd,td", DENSITIES, ids=lambda d: repr(d))
def test_check_density_matches_jax(jd, td):
    assert check_density(td, device="cpu") is jax_check_density(jd) is True
    assert check_density(td, dtype=torch.float32, device="cpu") is True


@dataclasses.dataclass(frozen=True)
class _BrokenTanh(P.Tanh):
    """Score off by a factor of 2 against its log-likelihood."""

    def score_and_der(self, y):
        score, der = super().score_and_der(y)
        return 2.0 * score, der


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_check_density_fails_a_broken_density(dtype):
    assert check_density(_BrokenTanh(), dtype=dtype, device="cpu") is False
    # A tolerance wide enough passes it.
    assert check_density(_BrokenTanh(), tol=2.0, dtype=dtype, device="cpu") is True


def test_check_density_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32 or float64"):
        check_density(P.Tanh(), dtype=torch.float16, device="cpu")
