"""Kernel 1's ``wgmma`` route (``csrc/rotated_fused_wgmma.cu``) on the card.

Needs an NVIDIA GPU (Hopper, sm_90a): every test here is marked ``cuda``
and skips without one. Imports no JAX:

    python -m pytest --noconftest tests/test_torch_core_wgmma_cuda.py -q

The main path's line-search tries (``rotated_fused_sums`` in delta mode
on f32 X at the f32 and bf16x3 tiers, without H) run the ``wgmma``
kernel. Held here:
  * against the plain version at N in {1, 17, 40, 63, 64} (one live row,
    a 16-row tile and one row, rows past 32 in one warp of four, one
    short of and the full width; the kernel's tiles hold rows below 32
    in every warp and rows 32-63 in every warp's second half) and T in
    {1, 2047, 2048, 2049, 1,000,003} (one column, short of, at and one
    past a 2,048-column partial, and the MEG's ragged length, whose rows
    are not 16-byte aligned), every density, with and without Y^2, to
    tests/test_torch_cuda.py's RTOL (the kernel's f32 tier is six bf16
    products of exact splits, summed in fresh 16-column steps and
    256-column groups as the mma.sync kernel sums them);
  * the launches by route: every pair of the resident kernel takes the
    route ``ops.kernels._core_wgmma_pair`` gives it;
  * a fit with a density plugin on the card (the auto rule sends it to
    the torch path): the CPU torch path's answer, kernel 1 not launched.
The f64 drift tests of the route's sums at 64 x 2,000,000 are
tests/test_torch_cuda.py's (the f32 tier's error, the bf16x3 rotation's
and contraction's drift), which run on this route.
"""

import numpy as np
import pytest
import torch

from picard_ica_tpu_torch import Picard, PicardConfig
from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.ops.densities import Cube, Exp, Tanh
from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

from test_torch_core_wgmma import PluginTanh

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# f32 sums in another order (tests/test_torch_cuda.py RTOL).
RTOL = 2e-5
DENSITIES = [Tanh(), Exp(0.5), Cube()]
NS = [1, 17, 40, 63, 64]
TS = [1, 2047, 2048, 2049, 1_000_003]
TIERS = ("f32", "bf16x3", "bf16")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def inputs():
    """X, M_old and M_new by (n, t), made once: Laplace X, M_old = I +
    0.2 noise, M_new = M_old + 0.05 noise (tests/test_torch_cuda.py)."""
    made = {}

    def get(n, t):
        if (n, t) not in made:
            rng = np.random.default_rng(n * 7919 + t)
            x = torch.from_numpy(rng.laplace(size=(n, t)).astype(np.float32)).cuda()
            m_old = torch.from_numpy(np.eye(n) + 0.2 * rng.standard_normal((n, n))).float().cuda()
            m_new = m_old + torch.from_numpy(0.05 * rng.standard_normal((n, n))).float().cuda()
            made[(n, t)] = (x, m_old, m_new)
        return made[(n, t)]

    return get


def _close(out_k, out_p, rtol=RTOL):
    for a, b in zip(out_k, out_p):
        assert a.dtype == torch.float32 and a.device.type == "cuda"
        assert bool(torch.isfinite(a).all())
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("need_ysq", [False, True], ids=["min", "ysq"])
@pytest.mark.parametrize("density", DENSITIES, ids=str)
@pytest.mark.parametrize("precision", ["f32", "bf16x3"])
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("n", NS)
def test_wgmma_route_matches_plain(dev, inputs, n, t, precision, density, need_ysq):
    x, m_old, m_new = inputs(n, t)
    args = (m_new, m_old, x, density, False, need_ysq, precision, False)
    K.reset_launch_counts()
    out_k = K.rotated_fused_sums(*args)
    assert K.rotated_fused_sums.launches_by_route["wgmma"][precision] == 1
    _close(out_k, K.rotated_fused_sums_plain(*args))
    if not need_ysq:
        assert not out_k[1].any() and not out_k[5].any()


# (absolute_ll, precision, bf16 X, need_h) of the resident kernel's pairs.
PAIRS = [(a, pr, xb, h) for a in (False, True) for pr in TIERS for xb in (False, True)
         for h in (False, True)]


def test_launches_by_route(dev, inputs):
    """Each pair of the resident kernel launches once, on the route of
    ``_core_wgmma_pair``, counted by route and contraction tier, and
    agrees with its plain version."""
    x, m_old, m_new = inputs(33, 2049)
    expect = {r: dict.fromkeys(TIERS, 0) for r in K.CORE_ROUTES}
    K.reset_launch_counts()
    for absolute_ll, precision, bf16_x, need_h in PAIRS:
        xx = x.to(torch.bfloat16) if bf16_x else x
        tier, rot = K._tiers(xx, precision)
        args = (m_new, m_old, xx, Tanh(), need_h, True, precision, absolute_ll)
        out = K.rotated_fused_sums(*args)
        route = ("wgmma" if K._core_wgmma_pair(not absolute_ll, rot, tier, bf16_x, need_h)
                 else "mma.sync")
        expect[route][tier] += 1
        assert K.rotated_fused_sums.launches_by_route == expect
        if tier != "bf16":
            _close(out, K.rotated_fused_sums_plain(*args))
    assert sum(expect["wgmma"].values()) == 2 and K.rotated_fused_sums.launches == len(PAIRS)


def test_plugin_density_fits_on_the_card_through_the_torch_path(dev):
    """A default fit with a density plugin on the card takes the torch
    path (the kernels implement Tanh, Exp and Cube only) and lands where
    the CPU torch path does; no kernel of the core is launched."""
    _, a, x = generate_mixed_kurtosis_data(16, 50_000, 3)
    cfg = PicardConfig(random_state=0, density=PluginTanh())
    K.reset_launch_counts()
    r_card = Picard.fit(x, cfg)
    assert K.rotated_fused_sums.launches == 0 and K.streaming_fused_sums.launches == 0
    assert K.rotated_moments_sums.launches == 0 and K.rotated_loglik_sums.launches == 0
    r_cpu = Picard.fit(x, PicardConfig(random_state=0, density=PluginTanh(), use_kernels=False),
                       device="cpu")
    assert r_card.converged and r_cpu.converged
    w_card = r_card.full_unmixing().double().cpu().numpy()
    assert amari_distance(w_card, np.linalg.inv(r_cpu.full_unmixing().double().numpy())) < 1e-3
    assert amari_distance(w_card, a) < 5e-3
