"""Sample-sharded fits of picard_ica_tpu_torch on the card.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips
without one. Imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py -q

``chip_smoke.py``'s phases 7 and 7b at a small size:
  * two gloo ranks that share the card fit the bench mixture (the
    streaming kernels at N = 96), each its block of the samples: W
    bit-identical on both ranks, converged, within Amari 1e-3 of the
    unsharded fit and 5e-3 of the mixing;
  * one NCCL rank fits bench.py's 64-component mixture on the resident
    kernels: bit-identical to the unsharded fit of the same tensor.
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_two_gloo_ranks_on_one_card(card):
    launches = chip_smoke.phase7_sharded(n=96, t=400_000, seed=42, ranks=2)
    assert launches["streaming_fused_sums"] > 0 and launches["row_sums"] > 0


def test_one_nccl_rank_is_the_unsharded_fit(card):
    launches = chip_smoke.phase7b_nccl(n=64, t=400_000, seed=42)
    assert launches["rotated_fused_sums"] > 0
