"""CUDA kernels of picard_ica_tpu_torch against their plain versions.

Needs an NVIDIA GPU (Hopper, sm_90a): every test here is marked
``cuda`` and skips without one. Imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the kernel and the plain version of the same tier differ
only in the order of f32 sums (products of bf16 values are exact in
f32), so outputs agree to RTOL relative to each output's largest entry.
"""

import numpy as np
import pytest
import torch

from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.ops.densities import Cube, Exp, Tanh

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# f32 sums over a few thousand columns, reordered: ~1e-6 of the largest
# entry; bf16-rounded operands can flip a rounding of psi at a few ulps.
RTOL = 2e-5

DENSITIES = [Tanh(), Exp(0.5), Cube()]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, t, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.laplace(size=(n, t)).astype(np.float32)).to(dev)
    m_old = torch.from_numpy(np.eye(n) + 0.2 * rng.standard_normal((n, n))).float().to(dev)
    m_new = m_old + torch.from_numpy(0.05 * rng.standard_normal((n, n))).float().to(dev)
    return x, m_old, m_new


def _close(out_k, out_p):
    for a, b in zip(out_k, out_p):
        assert a.dtype == torch.float32 and a.device.type == "cuda"
        assert bool(torch.isfinite(a).all())
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
def test_fused_matches_plain(dev, density, precision, absolute_ll, flags):
    x, m_old, m_new = _inputs(dev, 8, 5000)
    args = (m_new, m_old, x, density, *flags, precision, absolute_ll)
    before = K.rotated_fused_sums.launches
    out_k = K.rotated_fused_sums(*args)
    assert K.rotated_fused_sums.launches == before + 1
    _close(out_k, K.rotated_fused_sums_plain(*args))


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("absolute_ll", [False, True], ids=["delta", "plain"])
def test_fused_bf16_x_matches_plain(dev, precision, absolute_ll):
    x, m_old, m_new = _inputs(dev, 64, 4097, seed=1)
    args = (m_new, m_old, x.to(torch.bfloat16), Tanh(), True, True,
            precision, absolute_ll)
    _close(K.rotated_fused_sums(*args), K.rotated_fused_sums_plain(*args))


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["min", "h+ysq"])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_moments_matches_plain(dev, density, flags, bf16_x):
    x, m_old, _ = _inputs(dev, 33, 2049, seed=2)
    if bf16_x:
        x = x.to(torch.bfloat16)
    args = (m_old, x, density, *flags)
    _close(K.rotated_moments_sums(*args), K.rotated_moments_sums_plain(*args))


@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("need_ysq", [False, True])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32x", "bf16x"])
def test_loglik_matches_plain(dev, density, need_ysq, bf16_x):
    x, m_old, _ = _inputs(dev, 64, 255, seed=3)
    if bf16_x:
        x = x.to(torch.bfloat16)
    args = (m_old, x, density, need_ysq)
    _close(K.rotated_loglik_sums(*args), K.rotated_loglik_sums_plain(*args))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, m_old, m_new = _inputs(dev, 8, 300)
    with pytest.raises(TypeError):
        K.rotated_moments_sums(m_old.double(), x.double(), Tanh(), False, False)
    with pytest.raises(ValueError):
        K.rotated_loglik_sums(m_old, x[:, ::2], Tanh(), False)
    big = torch.zeros((K.KERNEL_MAX_N + 1, 300), device=dev)
    with pytest.raises(ValueError):
        K.rotated_loglik_sums(torch.eye(K.KERNEL_MAX_N + 1, device=dev), big,
                              Tanh(), False)


@pytest.mark.parametrize("n", [8, 33])
def test_fit_kernels_match_torch_path(dev, n):
    """End to end on the card: N=8 keeps f32 X in the bf16 tier, N=33
    takes the bf16 copy. Both paths converge to the same unmixing."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

    _, a, x = generate_mixed_kurtosis_data(n, 60_000, 5)
    K.reset_launch_counts()
    r_k = Picard.fit(x, PicardConfig(random_state=0))
    assert K.rotated_fused_sums.launches > 0 and K.rotated_moments_sums.launches > 0
    r_t = Picard.fit(x, PicardConfig(random_state=0, use_kernels=False))
    assert r_k.converged and r_t.converged
    assert r_k.sources.device.type == "cuda" and r_k.sources.shape == (n, 60_000)
    w_k = r_k.full_unmixing().double().cpu().numpy()
    w_t = r_t.full_unmixing().double().cpu().numpy()
    assert amari_distance(w_k, np.linalg.inv(w_t)) < 1e-4
    assert amari_distance(w_k, a) < 5e-3


# ---- device whitening -------------------------------------------------------

# N of the whitening kernels: one output tile, one full tile, and the
# grouped hand-off (N > 512) with a ragged last tile. T is ragged too.
STATS_SHAPES = [(4, 5001), (64, 4097), (513, 2500), (600, 3001)]


def _stats_inputs(dev, n, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.laplace(size=(n, t)) + 1.5
    mean = x.mean(axis=1)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(mean.astype(np.float32)).to(dev))


@pytest.mark.parametrize("n,t", STATS_SHAPES)
def test_row_sums_matches_plain(dev, n, t):
    x, _ = _stats_inputs(dev, n, t)
    before = K.row_sums.launches
    out = K.row_sums(x)
    assert K.row_sums.launches == before + 1
    _close([out], [K.row_sums_plain(x)])


@pytest.mark.parametrize("centered", [False, True], ids=["plain", "centered"])
@pytest.mark.parametrize("n,t", STATS_SHAPES)
def test_covariance_matches_plain(dev, n, t, centered):
    """The covariance wrappers: per-chunk kernels up to N = 512, the
    grouped kernel above."""
    x, mean = _stats_inputs(dev, n, t, seed=1)
    m = mean if centered else None
    grouped = n > K.COV_RESIDENT_MAX_N
    counter = (K._grouped_covariance if grouped else
               K.centered_covariance_sums if centered else K.covariance_sums)
    before = counter.launches
    out = K.centered_covariance_sums(x, mean) if centered else K.covariance_sums(x)
    assert counter.launches == before + 1
    if grouped:
        ref = K.grouped_covariance_plain(x, m)
    elif centered:
        ref = K.centered_covariance_sums_plain(x, mean)
    else:
        ref = K.covariance_sums_plain(x)
    assert torch.equal(out, out.T)
    _close([out], [ref])


@pytest.mark.parametrize("centered", [False, True], ids=["plain", "centered"])
@pytest.mark.parametrize("n", [4, 64, 600])
def test_grouped_covariance_matches_plain(dev, n, centered):
    """Across group boundaries: 70,001 columns are 35 chunks, 3 groups."""
    x, mean = _stats_inputs(dev, n, 70_001, seed=2)
    m = mean if centered else None
    out = K._grouped_covariance(x, m)
    assert torch.equal(out, out.T)
    _close([out], [K.grouped_covariance_plain(x, m)])


def test_whitening_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, mean = _stats_inputs(dev, 8, 3000)
    with pytest.raises(TypeError):
        K.row_sums(x.double())
    with pytest.raises(TypeError):
        K.covariance_sums(x.double())
    with pytest.raises(ValueError):
        K.row_sums(x[:, ::2])
    with pytest.raises(ValueError):
        K.centered_covariance_sums(x[:, ::2], mean)
    with pytest.raises(ValueError):
        K.centered_covariance_sums(x, mean[:4])
    with pytest.raises(ValueError):
        K._grouped_covariance(x, mean[:, None])


def test_fit_cuda_tensor_through_device_whitening(dev):
    """An f32 tensor on the card: whitened by the kernels, fitted, the
    caller's tensor untouched, and the same unmixing as the CPU fit of
    the same data."""
    from picard_ica_tpu_torch import Picard, PicardConfig
    from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

    _, a, x = generate_mixed_kurtosis_data(8, 60_000, 5)
    x32 = torch.from_numpy(x.astype(np.float32))
    x_dev = x32.to(dev)
    before = x_dev.clone()
    K.reset_launch_counts()
    r_g = Picard.fit(x_dev, PicardConfig(random_state=0))
    for k in (K.row_sums, K.centered_covariance_sums, K.covariance_sums,
              K.rotated_fused_sums, K.rotated_moments_sums):
        assert k.launches > 0, k.__name__
    assert torch.equal(x_dev, before)
    r_c = Picard.fit(x32, PicardConfig(random_state=0))
    assert r_g.converged and r_c.converged
    assert r_g.sources.device.type == "cuda" and r_c.sources.device.type == "cpu"
    w_g = r_g.full_unmixing().double().cpu().numpy()
    w_c = r_c.full_unmixing().double().numpy()
    assert amari_distance(w_g, np.linalg.inv(w_c)) < 1e-4
    assert amari_distance(w_g, a) < 5e-3
