"""Kernel 1's ``wgmma`` route (``csrc/rotated_fused_wgmma.cu``), on the CPU.

The main path's line-search tries -- ``rotated_fused_sums`` in delta mode
on f32 X at the f32 and bf16x3 tiers, without H -- run a kernel on
Hopper's ``wgmma``; every other pair keeps the ``mma.sync`` kernel. The
kernels run only on the card (tests/test_torch_core_wgmma_cuda.py and
tests/test_torch_cuda.py hold the route against the plain version and
f64 there). Here, without a card:
  * the route's rule, ``ops.kernels._core_wgmma_pair``, over every pair
    (the library's ``picard_core_wgmma_pair`` is held to it when the
    library loads: tests/test_torch_stream_tc.py);
  * the wrapper on tensors on the meta device (the C entries replaced by
    a recorder): which entry each pair takes (both take the same
    arguments), and the launch counted by route and tier.
"""

import numpy as np
import pytest
import torch

from picard_ica_tpu_torch.ops import densities as td
from picard_ica_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

TIERS = ("f32", "bf16x3", "bf16")


def test_core_wgmma_pair_is_the_main_paths_tries():
    """Exactly delta mode on f32 X with both tiers f32 or both bf16x3 and
    no H takes the wgmma kernel."""
    taken = {(d, r, c, xb, h)
             for d in (False, True) for r in TIERS for c in TIERS
             for xb in (False, True) for h in (False, True)
             if K._core_wgmma_pair(d, r, c, xb, h)}
    assert taken == {(True, "f32", "f32", False, False),
                     (True, "bf16x3", "bf16x3", False, False)}
    assert K.CORE_ROUTES == ("wgmma", "mma.sync")


class PluginTanh:
    """A density plugin (the ``Density`` protocol, not a ``Tanh``) with
    tanh's formulas: the kernels cannot run it (tests/test_torch_solver.py
    and tests/test_torch_core_wgmma_cuda.py fit with it)."""

    def __init__(self):
        self._d = td.Tanh()

    def log_lik(self, y):
        return self._d.log_lik(y)

    def score_and_der(self, y):
        return self._d.score_and_der(y)

    def log_lik_delta(self, y_old, dy):
        return self._d.log_lik_delta(y_old, dy)

    def score_der_loglik_delta(self, y_old, dy):
        return self._d.score_der_loglik_delta(y_old, dy)

    def score_der_loglik(self, y):
        return self._d.score_der_loglik(y)


class _Recorder:
    """Stands in for the kernels' library and ``_run``: records each C
    entry's name and arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            return 0
        entry.__name__ = name
        return entry

    def run(self, entry, *args, device):
        self.calls.append((entry.__name__, args))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(K, "_lib", lambda: rec)
    monkeypatch.setattr(K, "_run", rec.run)
    return rec


# (absolute_ll, precision, bf16 X, need_h) of the resident kernel's pairs.
PAIRS = [(a, pr, xb, h) for a in (False, True) for pr in TIERS for xb in (False, True)
         for h in (False, True)]


@pytest.mark.parametrize("absolute_ll,precision,bf16_x,need_h", PAIRS)
def test_wrapper_routes_each_pair(recorder, absolute_ll, precision, bf16_x, need_h):
    """A non-CPU tensor takes ``picard_rotated_fused_wgmma`` for the
    route's pairs and ``picard_rotated_fused_sums`` for every other, with
    the same arguments (the mode, the tiers, the density's code, H, Y^2,
    alpha, N, T, bf16 X, ..., the partials); then the fold. The launch is
    counted by tier and by route."""
    n, t = 37, 5001
    rng = np.random.default_rng(3)
    m_old = torch.from_numpy(np.eye(n, dtype=np.float32)).to("meta")
    m_new = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to("meta")
    x = torch.empty((n, t), dtype=torch.bfloat16 if bf16_x else torch.float32, device="meta")
    K.reset_launch_counts()
    out = K.rotated_fused_sums(m_new, m_old, x, td.Exp(0.5), need_h, True, precision,
                               absolute_ll)
    assert [tuple(v.shape) for v in out] == [(n,), (n,), (n, n), (n,), (n, n), (n,)]
    tier, rot = K._tiers(x, precision)
    wgmma = K._core_wgmma_pair(not absolute_ll, rot, tier, bf16_x, need_h)
    (name, args), (fold, _) = recorder.calls
    assert fold == "picard_fold_pairwise"
    nb = -(-t // K.COLS_PER_BLOCK)
    assert name == ("picard_rotated_fused_wgmma" if wgmma else "picard_rotated_fused_sums")
    assert args[:10] == (int(not absolute_ll), K._TIERS[rot], K._TIERS[tier], 1, int(need_h),
                         1, 0.5, n, t, int(bf16_x))
    assert args[-1] == nb and len(args) == 21
    assert K.rotated_fused_sums.launches == 1
    assert K.rotated_fused_sums.launches_by_tier[tier] == 1
    route = "wgmma" if wgmma else "mma.sync"
    assert K.rotated_fused_sums.launches_by_route[route][tier] == 1
    assert sum(sum(v.values()) for v in K.rotated_fused_sums.launches_by_route.values()) == 1


def test_cpu_wrapper_launches_nothing():
    """On CPU tensors the wrapper runs the plain version for the route's
    pairs too, and counts no launch."""
    n, t = 9, 3000
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.laplace(size=(n, t)).astype(np.float32))
    m_old = torch.from_numpy((np.eye(n) + 0.1 * rng.standard_normal((n, n))).astype(np.float32))
    m_new = m_old + 0.01
    K.reset_launch_counts()
    for precision in ("f32", "bf16x3"):
        out = K.rotated_fused_sums(m_new, m_old, x, td.Tanh(), False, True, precision)
        ref = K.rotated_fused_sums_plain(m_new, m_old, x, td.Tanh(), False, True, precision)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert K.rotated_fused_sums.launches == 0
    assert K.rotated_fused_sums.launches_by_route == {
        r: dict.fromkeys(TIERS, 0) for r in K.CORE_ROUTES}
