"""Pins the port's device-memory model (``picard_ica_tpu_torch/utils/
memory_model.py``) to its buffer anatomy, to the kernels' own sizing
rules, to the JAX package's model where the two pipelines hold the same
buffers, and to the max-T boundary measured on the card.

The boundary: ``chip_smoke.py`` phase 8 ran the whole datagen -> whiten
-> fit pipeline at N = 256 for 3 iterations, each T in a fresh process,
on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit: T = 26,000,000
ran and T = 27,000,000 raised ``torch.cuda.OutOfMemoryError`` in the
projection. Its phase peaks at 64 x 4M and 256 x 10M (kernel path), and
the torch path's at 128 x 1M (its TORCH_CORE_BUFFERS measured at 64 x 4M),
matched the model within 0.1 %.
"""

import pytest

from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.utils import memory_model as mm


def test_projection_is_the_binding_phase_at_three_buffers():
    """The port centers into a new buffer and projects it into another
    while the caller's X is alive: three data buffers, more than the
    refinement's two and a block, and more than the core's two and a
    half plus the workspace."""
    n, t = 256, 6_000_000
    phases = mm.phase_peak_bytes(n, t)
    assert mm.binding_phase(n, t) == "projection"
    assert phases["projection"] == 3 * n * t * 4  # 18.432e9
    assert phases["datagen"] == n * t * 4 + 3 * n * (1 << 20) * 4
    assert phases["refine"] == 2 * n * t * 4 + n * (1 << 20) * 4
    assert phases["core"] < phases["projection"]


def test_peak_scales_linearly_in_t():
    """Linear where the projection binds; at small T the core binds
    instead, since the tensor-core route's workspace (up to
    STREAM_TC_WORKSPACE_MAX) does not shrink with T."""
    assert mm.fit_peak_bytes(256, 16_000_000) == 2 * mm.fit_peak_bytes(256, 8_000_000)
    assert mm.binding_phase(256, 2_000_000) == "core"
    assert mm.binding_phase(256, 8_000_000) == "projection"


def test_bench_shape_peaks_at_three_buffers():
    """bench.py's 64 x 4M: the projection's three whole buffers, 3.072e9
    bytes, a few percent of the card."""
    peak = mm.fit_peak_bytes(64, 4_000_000)
    assert peak == 3 * 64 * 4_000_000 * 4
    assert peak < 0.05 * mm.EFFECTIVE_ARENA_BYTES


def test_core_term_tracks_the_kernels_sizing():
    """The core's bytes beyond X and x1 are the bf16 copy plus the bf16
    stage's pass: above N = 64 the tensor-core route's workspace, its
    packed (n_parts, N^2 + 2N) partials and the weights' planes, capped by
    the route's own limits; at N <= 64 the resident kernel's partials,
    one per COLS_PER_BLOCK columns."""
    n, t = 256, 6_000_000
    plan = K.stream_tc_plan(n, t, False, "bf16")
    assert 0 < plan.ws_bytes <= K.STREAM_TC_WORKSPACE_MAX
    assert plan.n_parts * n * n * 4 <= K.STREAM_PARTIALS_MAX
    kp = -(-n // K.STREAM_TC_KC) * K.STREAM_TC_KC
    partials = plan.n_parts * (n * n + 2 * n) * 4
    assert mm.core_extra_bytes(n, t) == (n * t * 2 + plan.ws_bytes + partials
                                         + plan.n_pad * kp * 2)
    n, t = 64, 4_000_000
    assert mm.core_extra_bytes(n, t) == n * t * 2 + -(-t // K.COLS_PER_BLOCK) * (n * n + 2 * n) * 4
    # without the bf16 copy the later stages' passes set it
    assert mm.core_extra_bytes(256, 6_000_000, cheap_tier=False) <= K.STREAM_TC_WORKSPACE_MAX + 2**30
    # the torch path's (n, T) temporaries
    assert mm.core_extra_bytes(n, t, use_kernels=False) == int(mm.TORCH_CORE_BUFFERS * n * t * 4)


@pytest.mark.parametrize("n,t", [(256, 6_000_000), (64, 4_000_000), (128, 3_000_000)])
def test_shared_buffers_equal_the_jax_model(n, t):
    """datagen, projection and refine hold the JAX model's buffers to the
    byte, plus what the port adds to each:
      * datagen: two more (N, 2^20) column blocks, the temporaries of the
        in-place Laplace transform (the JAX package's is one fused op);
      * projection: the caller's X, which ``Picard.fit`` does not own, is
        alive beside X - mu and x1 (the JAX model counts the raw data and
        x1);
      * refine: the caller's X again, beside x1 and the rotation block.
    stats and core differ in kind, not by a buffer: the port's stats
    hold the covariance kernels' actual partials (the JAX model counts 64
    chunks), and its core the tensor-core route's workspace or the
    resident kernel's partials (the JAX model its grouped partials)."""
    from picard_ica_tpu.utils import memory_model as jm

    port = mm.phase_peak_bytes(n, t)
    jax = jm.phase_peak_bytes(n, t)
    data = n * t * 4
    assert port["datagen"] - 2 * n * (1 << 20) * 4 == jax["datagen"]
    assert port["projection"] - data == jax["projection"]
    assert port["refine"] - data == jax["refine"]
    assert port["stats"] != jax["stats"] and port["core"] != jax["core"]


def test_max_t_reproduces_the_measured_boundary():
    """T = 26M ran and 27M ran out of memory at N = 256 (module
    docstring): the model gives that boundary for every arena inside the
    bracket, not only the value committed."""
    assert mm.ARENA_FITS_BYTES == mm.fit_peak_bytes(256, 26_000_000)
    assert mm.ARENA_OOM_BYTES == mm.fit_peak_bytes(256, 27_000_000)
    assert mm.ARENA_FITS_BYTES <= mm.EFFECTIVE_ARENA_BYTES < mm.ARENA_OOM_BYTES
    assert mm.EFFECTIVE_ARENA_BYTES < mm.REPORTED_ARENA_BYTES
    assert mm.max_t(256) == 26_000_000
    for arena in (79.9e9, 81.0e9, 82.9e9):
        assert mm.max_t(256, arena_bytes=arena) == 26_000_000, arena
