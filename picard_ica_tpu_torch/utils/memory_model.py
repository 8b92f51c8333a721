"""Device-memory peak model of the datagen -> whiten -> fit pipeline on
one card (the counterpart of ``picard_ica_tpu/utils/memory_model.py``).

The pipeline is the bench's: ``utils.datagen.generate_bench_data_device``
makes X (nf, T) f32 on the card, then ``Picard.fit(x)`` whitens it on the
card (``ops.whitening.center_whiten``) and fits it. The caller holds X
for the whole fit. Bytes of live device memory (what
``torch.cuda.max_memory_allocated`` counts) per phase, f32, ``nf`` the
features of the raw data, ``n`` the components:

  datagen     X, plus three (nf, 2^20) column blocks of the in-place
              Laplace transform (``utils/datagen.laplace_sources_device``:
              ``sign(u)`` is alive while ``-|u|``, its ``log1p`` and their
              product are made); the mixing then rotates X in place, one
              (nf, ROTATE_BLOCK_T) product a block
              (``ops/linalg.rotate_rows_inplace``).
  stats       X + the whitening kernels' partials: the mean's (n_chunks,
              nf), then the covariance's (n_chunks / group, nf, nf), one
              per COV_CHUNK columns, or per COV_GROUP chunks when they
              would pass RESIDENT_PARTIALS_MAX (``ops/kernels.py``).
  projection  X + x1 (n, T) + one centered (nf, ROTATE_BLOCK_T) column
              block: ``K (X - mu)`` is written into x1 a block at a
              time (``ops/whitening._project_centered``), the JAX
              model's two data buffers plus the block.
  refine      X + x1 + the larger of the covariance partials of x1 and
              one rotation block: C2 = x1 x1^T through the kernels, then
              x1 rotated in place (``ops/whitening._refine_whitening``).
  core        X + x1 (the pre-rotation and the final Y are written
              through it) + the bf16 copy of x1 in the staged schedule's
              first stage (half a buffer; ``cheap_tier``, N >= 16 and the
              kernel path, ``models/core.run_core``) + the largest pass's
              temporaries: on the kernel path the packed per-block
              partials (and above N = 64 the tensor-core route's
              workspace, ``ops/kernels.stream_tc_plan``, under
              STREAM_TC_WORKSPACE_MAX and STREAM_PARTIALS_MAX), on the
              torch path TORCH_CORE_BUFFERS (n, T) temporaries.

Not modelled: the JADE warm start's two (P, N, N) f32 cumulant tensors (R
and R G, 2 x 541 MB at N = 128) and its Gram chunk, the FastICA warm
start's temporaries, and host-f64 whitening (NumPy input moves only x1 to
the card). A sharded rank is the same model at its local T.

EFFECTIVE_ARENA_BYTES is the usable ceiling of one NVIDIA H100 80GB HBM3
at a 700.00 W power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``), measured by ``chip_smoke.py`` phase 8c: the
whole pipeline at N = 256 for 3 iterations, each T in a fresh child
process of the smoke run (whose own CUDA context stays alive). With the
two-buffer projection, T = 30,000,000 ran (a modelled peak of
80,011,544,576 bytes, the core; 80,065,827,840 measured) and 31,000,000
(82,573,633,536 modelled) ran out of memory in the core, 75.94 GiB
allocated, 0.99 GiB cached in segments it could not release, 0.21 GiB
free. In a process alone on the card 31M ran (82,630,528,000 measured)
and 32M ran out; with the three-buffer projection 26M ran and 27M
(82,944,000,000) ran out as phase 8c's child. The bracket, not the value
chosen inside it, is the measured fact, and :func:`max_t` reproduces the
boundary (30M runs, 31M does not) for any arena inside it.
REPORTED_ARENA_BYTES is the total that ``torch.cuda.mem_get_info()``
reports on that card.
"""

from __future__ import annotations

from ..ops import kernels as _k
from ..ops.linalg import ROTATE_BLOCK_T
from ..utils.datagen import _GEN_BLOCK_T

_ELEM = 4  # f32 bytes: the device pipeline is f32 end to end

# The measured bracket (module docstring), and the value inside it.
ARENA_FITS_BYTES = 80_011_544_576
ARENA_OOM_BYTES = 82_573_633_536
EFFECTIVE_ARENA_BYTES = 81.3e9
REPORTED_ARENA_BYTES = 85_017_493_504
# (n, T) f32 buffers of the torch path's core beyond X and x1: measured at
# 64 x 4M on the card above (chip_smoke.py phase 8, which holds it at
# 128 x 1M).
TORCH_CORE_BUFFERS = 16.5
# Column-block temporaries alive at once in the in-place Laplace transform.
_GEN_TEMPS = 3


def _meta(n: int, t: int):
    """A shape-only stand-in for X, for the kernels' sizing rules."""
    import torch

    return torch.empty((n, t), device="meta")


def _cov_partials(n: int, t: int) -> int:
    """Bytes of one covariance call's (n_parts, n, n) partials."""
    chunks = _k._n_chunks(t, _k.COV_CHUNK)
    group = _k.COV_GROUP if _k._use_grouped(n, t) else 1
    return _k._n_chunks(chunks, group) * n * n * _ELEM


def _pass_bytes(n: int, t: int, tier: str, bf16_x: bool, plain: bool) -> int:
    """Temporaries of one fused pass of a default (Picard-O) fit on the
    kernel path: its packed partials and, on the tensor-core route, the
    workspace and the weights' bf16 planes."""
    outputs = _k._fused_outputs(n, False, False)
    _, width = _k.packed_offsets(outputs)
    if not _k._streams(_meta(n, t), 1):
        return _k._n_chunks(t, _k.COLS_PER_BLOCK) * width * _ELEM
    plan = _k.stream_tc_plan(n, t, False, tier)
    rot = "bf16" if bf16_x else tier
    planes = (1 if plain else 2) * {"bf16": 1, "bf16x3": 2, "f32": 3}[rot]
    kp = _k._n_chunks(n, _k.STREAM_TC_KC) * _k.STREAM_TC_KC
    return plan.ws_bytes + plan.n_parts * width * _ELEM + planes * plan.n_pad * kp * 2


def core_extra_bytes(n: int, t: int, cheap_tier: bool = True,
                     use_kernels: bool = True) -> int:
    """The core phase's bytes beyond X and x1: the bf16 copy with its
    stage's passes, or the later stages' passes, whichever is larger."""
    comp = n * t * _ELEM
    if not use_kernels:
        return int(TORCH_CORE_BUFFERS * comp)
    if cheap_tier:
        first = _pass_bytes(n, t, "bf16", n >= 16, True) + (comp // 2 if n >= 16 else 0)
        later = ("bf16x3", "f32")
    else:
        first = 0
        later = ("f32",)
    return max([first] + [_pass_bytes(n, t, tier, False, plain)
                          for tier in later for plain in (False, True)])


def phase_peak_bytes(
    n: int,
    t: int,
    n_features: int | None = None,
    cheap_tier: bool = True,
    use_kernels: bool = True,
) -> dict:
    """Per-phase device-memory peaks (bytes) of a datagen -> whiten ->
    fit pipeline on one card (module docstring).

    ``cheap_tier``: the staged schedule's bf16 copy of x1 (half a
    buffer) in its first stage; ``use_kernels``: the kernel path's
    partials and workspace, else the torch path's temporaries.
    """
    nf = n_features if n_features is not None else n
    data = nf * t * _ELEM      # raw (n_features, T) buffer
    comp = n * t * _ELEM       # whitened (n_components, T) buffer
    gen_block = nf * min(_GEN_BLOCK_T, t) * _ELEM
    rot_block = nf * min(ROTATE_BLOCK_T, t) * _ELEM
    mean_parts = _k._n_chunks(t, _k.COV_CHUNK) * nf * _ELEM
    return {
        "datagen": data + max(_GEN_TEMPS * gen_block, rot_block),
        "stats": data + max(mean_parts, _cov_partials(nf, t)),
        "projection": data + comp + rot_block,
        "refine": data + comp + max(_cov_partials(n, t), n * min(ROTATE_BLOCK_T, t) * _ELEM),
        "core": data + comp + core_extra_bytes(n, t, cheap_tier, use_kernels),
    }


def fit_peak_bytes(n: int, t: int, **kw) -> int:
    """Pipeline peak: the max over phase peaks."""
    return max(phase_peak_bytes(n, t, **kw).values())


def binding_phase(n: int, t: int, **kw) -> str:
    """Name of the phase that sets the pipeline peak."""
    phases = phase_peak_bytes(n, t, **kw)
    return max(phases, key=phases.get)


def max_t(
    n: int,
    arena_bytes: float = EFFECTIVE_ARENA_BYTES,
    step: int = 1_000_000,
    **kw,
) -> int:
    """Largest T (multiple of ``step``) whose pipeline peak fits.

    Defaults reproduce the measurement of ``chip_smoke.py`` phase 8 on
    the H100: max_t(256) = 30M (31M runs out of memory), pinned by
    tests/test_torch_memory_model.py.
    """
    t = step
    while fit_peak_bytes(n, t + step, **kw) <= arena_bytes:
        t += step
    return t
