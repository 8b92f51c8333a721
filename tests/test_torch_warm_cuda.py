"""The warm starts and checkpoints of picard_ica_tpu_torch on the card.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips
without one. Imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_warm_cuda.py -q

  * ``jade`` and ``ica_par`` on the card against the same calls on the
    CPU in f64: in f64 to 1e-9 (the same algorithm, cuBLAS / cuSOLVER
    against CPU BLAS / LAPACK summation orders), in f32 within Amari
    1e-4 of the f64 result (f32 sums over 100,000 samples);
  * ``jade`` on the card under a caller's ``allow_tf32=True`` equals the
    call with it off to 1e-6 (TF32's 10-bit mantissa would move the
    fourth-order Gram by ~1e-3), and the caller's flags come back;
  * ``load_result`` puts a checkpoint's tensors on the card, bit-equal,
    and ``transform`` runs there; ``check_density`` runs on the card.
"""

import numpy as np
import pytest
import torch

import picard_ica_tpu_torch as P
from picard_ica_tpu_torch.models.fastica import ica_par
from picard_ica_tpu_torch.models.jade import jade
from picard_ica_tpu_torch.utils import (
    amari_distance,
    check_density,
    generate_mixed_kurtosis_data,
)

pytestmark = pytest.mark.cuda

N, T = 8, 100_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def whitened():
    _, a, x = generate_mixed_kurtosis_data(N, T, 3)
    x = x - x.mean(axis=1, keepdims=True)
    e, u = np.linalg.eigh(x @ x.T / T)
    k = (u / np.sqrt(e)) @ u.T
    return k @ x, k, a


def _on(x, dev, dtype):
    return torch.from_numpy(x).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_jade_on_the_card_matches_the_cpu(dev, whitened, dtype):
    x, k, a = whitened
    w_cpu, m_cpu = jade(torch.from_numpy(x), 50)
    w_dev, m_dev = jade(_on(x, dev, dtype), 50)
    assert w_dev.device.type == "cuda" and w_dev.dtype == dtype
    w = w_dev.double().cpu().numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(w, w_cpu.numpy(), rtol=0, atol=1e-9)
        assert float(m_dev) == pytest.approx(float(m_cpu), rel=1e-9)
    else:
        assert amari_distance(w, np.linalg.inv(w_cpu.numpy())) < 1e-4
    assert amari_distance(w @ k, a) < 0.05


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("density", [P.Tanh(), P.Exp(), P.Cube()], ids=repr)
def test_ica_par_on_the_card_matches_the_cpu(dev, whitened, dtype, density):
    x, _, _ = whitened
    w0 = np.random.default_rng(1).standard_normal((N, N))
    w_cpu, m_cpu = ica_par(torch.from_numpy(x), density, 10, torch.from_numpy(w0))
    w_dev, m_dev = ica_par(_on(x, dev, dtype), density, 10, _on(w0, dev, dtype))
    assert w_dev.device.type == "cuda" and w_dev.dtype == dtype
    w = w_dev.double().cpu().numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(w, w_cpu.numpy(), rtol=0, atol=1e-9)
        assert float(m_dev) == pytest.approx(float(m_cpu), rel=1e-9)
    else:
        assert amari_distance(w, np.linalg.inv(w_cpu.numpy())) < 1e-4


def test_jade_is_exact_f32_under_a_callers_tf32(dev, whitened):
    x, _, _ = whitened
    xd = _on(x, dev, torch.float32)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        w_off, _ = jade(xd, 50)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        w_on, _ = jade(xd, 50)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert float((w_on - w_off).abs().max()) <= 1e-6


def test_fits_with_warm_starts_on_the_card(dev):
    _, a, x = generate_mixed_kurtosis_data(N, T, 5)
    for warm in ({"jade_it": 50}, {"fastica_it": 10}):
        r = P.Picard.fit(x, P.PicardConfig(random_state=0, **warm))
        assert r.converged and r.unmixing.device.type == "cuda"
        assert amari_distance(r.full_unmixing().double().cpu().numpy(), a) < 5e-3


def test_load_result_onto_the_card(dev, tmp_path):
    _, _, x = generate_mixed_kurtosis_data(N, 20_000, 6)
    r = P.Picard.fit(x, P.PicardConfig(random_state=0), device="cpu")
    p = tmp_path / "fit.npz"
    P.save_result(p, r)
    loaded = P.load_result(p)
    for name in ("unmixing", "whitening", "mean", "signs", "sources"):
        got = getattr(loaded, name)
        assert got.device.type == "cuda", name
        assert torch.equal(got.cpu(), getattr(r, name)), name
    y = P.Picard.transform(x, loaded)
    assert y.device.type == "cuda"
    scale = float(r.sources.abs().max())
    assert float((y.cpu() - r.sources).abs().max()) <= 1e-5 * scale


def test_check_density_on_the_card(dev):
    for density in (P.Tanh(), P.Exp(), P.Cube()):
        assert check_density(density)
        assert check_density(density, dtype=torch.float32)
