"""Pins the port's device-memory model (``picard_ica_tpu_torch/utils/
memory_model.py``) to its buffer anatomy, to the kernels' own sizing
rules, to the JAX package's model where the two pipelines hold the same
buffers, and to the max-T boundary measured on the card.

The boundary: ``chip_smoke.py`` phase 8 ran the whole datagen -> whiten
-> fit pipeline at N = 256 for 3 iterations, each T in a fresh process,
on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit: with the
projection written into x1 a column block at a time, T = 30,000,000 ran
and 31,000,000 raised ``torch.cuda.OutOfMemoryError`` in the core (with
the three-buffer projection before it, 26,000,000 ran and 27,000,000 ran
out in the projection). Its phase peaks at 64 x 4M and 256 x 10M (kernel
path), and the torch path's at 64 x 4M and 128 x 1M (its
TORCH_CORE_BUFFERS measured at 64 x 4M), matched the model within 0.1 %.
"""

import pytest

from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.utils import memory_model as mm


def test_core_binds_above_the_two_buffer_projection():
    """The port writes ``K (X - mu)`` into x1 a column block at a time
    while the caller's X is alive: two data buffers and one centered
    block, as many as the refinement's two and a block, and fewer than
    the core's two and a half plus the workspace, which binds."""
    n, t = 256, 6_000_000
    block = n * (1 << 20) * 4
    phases = mm.phase_peak_bytes(n, t)
    assert mm.binding_phase(n, t) == "core"
    assert phases["projection"] == 2 * n * t * 4 + block  # 13.36e9
    assert phases["datagen"] == n * t * 4 + 3 * block
    assert phases["refine"] == 2 * n * t * 4 + block
    assert phases["core"] > phases["projection"]


def test_peak_scales_linearly_in_t():
    """The data buffers scale linearly in T: the projection's two above
    its one block. The core binds at every T at N = 256, 2M to 30M: its
    bf16 copy makes it two and a half buffers, and the tensor-core
    route's workspace (up to STREAM_TC_WORKSPACE_MAX), packed partials
    (up to STREAM_PARTIALS_MAX) and the weights' bf16 planes (under 2^20
    bytes) come on top."""
    block = 256 * (1 << 20) * 4
    proj = {t: mm.phase_peak_bytes(256, t)["projection"] - block
            for t in (8_000_000, 16_000_000)}
    assert proj[16_000_000] == 2 * proj[8_000_000]
    for t in (2_000_000, 8_000_000, 10_000_000, 16_000_000, 30_000_000):
        assert mm.binding_phase(256, t) == "core", t
        extra = mm.fit_peak_bytes(256, t) - 2.5 * 256 * t * 4
        assert 0 < extra <= K.STREAM_TC_WORKSPACE_MAX + K.STREAM_PARTIALS_MAX + 2**20, t


def test_bench_shape_peaks_in_the_core():
    """bench.py's 64 x 4M: the core's X, x1, bf16 copy and the resident
    kernel's partials, 2.593e9 bytes (3.072e9 at three buffers), a few
    percent of the card."""
    n, t = 64, 4_000_000
    peak = mm.fit_peak_bytes(n, t)
    assert mm.binding_phase(n, t) == "core"
    assert peak == 2 * n * t * 4 + mm.core_extra_bytes(n, t) == 2_593_014_784
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
      * projection: one centered (N, 2^20) column block beside the raw
        data and x1, which the JAX model counts (its jitted projection
        fuses the centering into the product);
      * refine: the caller's X, which ``Picard.fit`` does not own, beside
        x1 and the rotation block (the JAX model rotates the data it
        owns).
    stats and core differ in kind, not by a buffer: the port's stats
    hold the covariance kernels' actual partials (the JAX model counts 64
    chunks), and its core the tensor-core route's workspace or the
    resident kernel's partials (the JAX model its grouped partials)."""
    from picard_ica_tpu.utils import memory_model as jm

    port = mm.phase_peak_bytes(n, t)
    jax = jm.phase_peak_bytes(n, t)
    data = n * t * 4
    assert port["datagen"] - 2 * n * (1 << 20) * 4 == jax["datagen"]
    assert port["projection"] - n * min(1 << 20, t) * 4 == jax["projection"]
    assert port["refine"] - data == jax["refine"]
    assert port["stats"] != jax["stats"] and port["core"] != jax["core"]


def test_max_t_reproduces_the_measured_boundary():
    """T = 30M ran and 31M ran out of memory at N = 256 with the
    two-buffer projection (module docstring): the model gives that
    boundary for every arena inside the bracket, not only the value
    committed."""
    assert mm.ARENA_FITS_BYTES == mm.fit_peak_bytes(256, 30_000_000)
    assert mm.ARENA_OOM_BYTES == mm.fit_peak_bytes(256, 31_000_000)
    assert mm.ARENA_FITS_BYTES <= mm.EFFECTIVE_ARENA_BYTES < mm.ARENA_OOM_BYTES
    assert mm.EFFECTIVE_ARENA_BYTES < mm.REPORTED_ARENA_BYTES
    assert mm.max_t(256) == 30_000_000
    for arena in (80.1e9, 81.3e9, 82.5e9):
        assert mm.max_t(256, arena_bytes=arena) == 30_000_000, arena
