"""Drive the PyTorch + CUDA port of Picard ICA once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure propagates; the script then exits non-zero and
prints no result line):

  0. the card's name and power limit, torch / CUDA versions, TF32 flags;
  1. build the CUDA kernels from ``picard_ica_tpu_torch/csrc`` (nvcc,
     sm_90a), time the build and print ptxas's registers and spills;
  2. hold each kernel against its plain PyTorch version on the card at
     N = 64, T = 2,000,000, for every mode and tier the main path runs
     plus one case with the H / Y^2 outputs on per kernel, and time both
     with CUDA events (one call at a time, median of 10 after warm-up;
     the kernel also 10 calls back to back); the resident core kernels,
     all on the tensor cores (the fused pass's tiers, the moments on f32
     and bf16 X, the log-lik on f32 and bf16 X), also at ragged shapes
     (N = 17 and 63, T = 1,000,003). The fused pass's delta f32 and delta
     bf16x3 cases without H (the main path's tries) must run on the
     ``wgmma`` route (``csrc/rotated_fused_wgmma.cu``, its own row of the
     ``kernels`` line), every other case on the ``mma.sync`` kernel
     (``csrc/rotated_fused_tc.cu``). An f32 case is held to an f64
     evaluation of the same sums as well, and prints both errors against
     f64, the kernel's and the exact-f32 plain version's, beside the
     error against the plain version;
     The whitening kernels are held the same way: ``row_sums``,
     ``centered_covariance_sums`` and ``covariance_sums`` at 64 x
     4,000,000, ``_grouped_covariance`` (centered and not) at 600 x
     1,000,000, each timed in turns with the one PyTorch call that
     computes the same function (``x.sum(dim=1)``, ``torch.cov``,
     ``x @ x.T``; a yardstick the port never calls), and the fold of
     their partials on the card against ``fold_pairwise``, bit for bit;
  3. first, on its own line, a 64 x 100,000 mixed mixture fitted on the
     card at the default config with a density plugin (the ``Density``
     protocol with tanh's formulas, which the kernels do not run): the
     auto rule takes the torch path, no core kernel may launch, and the
     unmixing must match the CPU torch path's (Amari < 1e-3); then fit a
     64 x 2,000,000 mixed sub/super-Gaussian mixture (float64
     NumPy input, made from a seed: host-f64 whitening) with
     ``Picard.fit`` at the default config, through the kernels, then
     again on the torch path, and check convergence, separation,
     agreement and the kernels' launch counts (the fused pass's by tier,
     both of its routes);
  4. the device-whitening slice: the bench configuration (64 x 4,000,000
     f32 made on the card, ``generate_bench_data_device``, seed 42):
     ``center_whiten`` and its whiteness, then ``Picard.fit`` on the
     CUDA tensor — converged at tol 1e-7, Amari to the mixing, every
     whitening and core kernel launched in that fit (the fused pass in
     every tier; every delta f32 and delta bf16x3 try on the ``wgmma``
     route, none on the ``mma.sync`` kernel), the caller's tensor
     unchanged; then the same fit in the exact f32 tier alone
     (``kernel_precision="f32"``), held the same way, to weigh the staged
     schedule;
  4b. ``center_whiten`` of a 600 x 1,000,000 f32 mixture on the card,
     through ``_grouped_covariance``, with the same whiteness bounds;
  5. the large-N slice at BASELINE config 5's width: a 256 x 2,000,000
     mixed sub/super-Gaussian mixture as an f32 CUDA tensor, fitted with
     ``use_kernels=True`` through the streaming kernels at tol 1e-7 in
     the exact f32 tier (its delta passes on the tensor-core route, which
     must launch there at f32), then on the torch path: convergence,
     Amari to the mixing, agreement, launch counts (streaming > 0,
     resident core kernels 0, whitening kernels > 0) and the caller's
     tensor unchanged;
  5b. the JAX package's large-N exhibit (benchmarks/suite.py:597-627):
     1024 x 200,000 bench mixture made on the card, 10 iterations at tol
     1e-4 on both paths at the default staged schedule, so the bf16 tier
     runs through the streaming kernels (the grouped covariance whitens
     it): its plain bf16 passes on bf16 X through the tensor-core route
     (``csrc/streaming_fused_tc.cu``), which must launch there;
  5c. phase 5's 256 x 2,000,000 tensor fitted with ``use_kernels=True`` at
     the default staged schedule: converged at tol 1e-7, Amari to the
     mixing and to phase 5's torch-path fit, the tensor-core route
     launched at its four (mode, tier) pairs of a default fit (the bf16
     stage's plain passes on bf16 X, the bf16x3 and f32 stages' delta
     passes on f32 X, the plain moments at the bf16x3 and f32 stage
     boundaries) and the loglik kernel on the tensor cores (on the bf16
     stage's bf16 X at least); core seconds beside phase 5's f32-only
     kernel fit;
  5d. the same tensor fitted with the tier pinned to bf16
     (``kernel_precision="bf16"``), whose tries run delta bf16 on f32 X:
     3 iterations, every try on the tensor-core route (as many delta bf16
     launches as line-search passes), then a run to tol 1e-4 or 30
     iterations, whichever comes first; Amari to the mixing and to phase
     5's torch-path fit;
  6. BASELINE config 4 at full size (``benchmarks/suite.py:519-552``):
     ``generate_mixed_kurtosis_data(128, 1_000_000, seed=7)`` as float64
     NumPy, fitted with ``PicardConfig(jade_it=50, random_state=0,
     tol=1e-7, max_iter=200)`` on the card (auto: kernels 8 and 9) and
     again on the torch path; the seconds of host-f64 whitening, the JADE
     Gram and its sweeps (the port's own functions on the same whitened
     data) and the core, the sweep count, Amari to the mixing (< 5e-3)
     and between the two fits (< 1e-3), convergence, kernel 8 launched
     and kernel 9 too where a sign is negative;
  6b. the same input with a FastICA(10) warm start at the same settings:
     converged, Amari to the mixing (< 5e-3) and to phase 6's kernel fit
     (< 1e-3);
  6c. phase 6's result saved with and without sources and loaded onto
     the card (unmixing, whitening, mean, signs and sources bit-equal),
     ``transform`` from the file against the fit's sources (to 3 cond(A)
     f32 eps of their largest entry), and a fit resumed from the file
     with ``resume_config``, which must converge;
  7. BASELINE config 5, sample-sharded: the bench mixture (bench.py's
     generator and seed 42) at 256 x 10,000,000 f32 made on the card,
     fitted at the default config in this process, then on two gloo
     ranks that share the card (``torch.multiprocessing`` spawn, a file
     store in a temporary directory, a timeout): each makes the data,
     keeps its column block (``parallel.shard_samples``), frees the rest
     and fits it with ``mesh=parallel.sample_mesh("cuda")`` (the mesh
     must run gloo: NCCL refuses two ranks on one card). Fails when a
     rank exits non-zero or times out, W differs between the ranks in
     any bit, a fit does not converge, Amari between the sharded and the
     unsharded unmixing is >= 1e-3 or to the mixing >= 5e-3; prints per
     rank the whitening, core and fit seconds, iterations, stage exits,
     the all-reduces' count, bytes and seconds, and samples*iter/s beside
     the unsharded fit's;
  7b. bench.py's configuration (64 x 4,000,000, seed 42) through a
     one-rank NCCL mesh: bit-identical to the unsharded fit of the same
     tensor in W, sources and iterations (a one-rank all-reduce is the
     identity); the group is destroyed after the phase;
  8. profiling and the memory model (``utils/profiling.py``,
     ``utils/memory_model.py``): (a) bench.py's fit profiled with
     ``profile_fit`` after a warm-up fit: the trace's top device ops, its
     launches of kernel 1 by tier and on the ``wgmma`` route and of
     kernels 2, 4, 5 and 6, which must equal the wrappers' counters for
     the same fit, the card's busy share
     of the core span, and ``fit_with_timing``'s rate; (b) the bench data
     made on the card and fitted at 64 x 4,000,000 and 256 x 10,000,000
     (kernel path) and at 64 x 4,000,000 and 128 x 1,000,000 (torch
     path): each phase's ``max_memory_allocated`` beside
     ``phase_peak_bytes`` (fails when the binding phase differs or a
     phase is off the model by more than 0.1 %); (c) the whole pipeline
     (the bench mixture, seed ``SEED8C``) at
     N = 256 for 3 iterations in a fresh process at T = ``max_t(256)``,
     which must run, and at ``max_t(256)`` + 1,000,000, which must raise
     ``torch.cuda.OutOfMemoryError`` (any other exit fails).
  9. the native runtime (``picard_ica_tpu_torch/native``, built with g++
     in phase 1 beside the CUDA kernels): (a) the build's seconds, the
     compiler and the host CPU; the reference-RNG draw at (seed, n) in
     ``DRAWS9`` and 10,000 draws of its u64 stream bit for bit the
     pure-Python sampler, the LCG Laplace stream at 4 x 1,000,003 (its
     state bit for bit, its values within 1e-13 relative of the NumPy
     closed form), the native 1024 x 1024 draw and the plain 256 x 256
     one timed; (b) phase 5b's kernel-path fit once more (the same data)
     under ``utils.profiling.profile_fit``: its ``picard.w_init`` seconds
     beside the fit's wall and core seconds, at most ``W_INIT_MAX_S``;
     (c) the suite's five conformance cases (``SUITE_CONFORMANCE``,
     ``benchmarks/suite.py:650-659``): the bench mixture as f64 NumPy
     (``generate_bench_data``, seed 42; the 64 x 500,000 cases the mixed
     mixture), the port's f64 oracle (center,
     whiten, core from W_init = I, tol 1e-7, 500 iterations) on the host
     and ``Picard.fit`` from W_init = I on the card (host-f64 whitening,
     kernels 1-3), Amari(W_port, pinv(W_oracle)) < 1e-3 in each, with
     both iteration counts and both times.
  10. the staged schedule at 64 x 100,000 (``generate_mixed_kurtosis_data``,
     seed 0, float64 NumPy: host-f64 whitening), ``random_state=0``, tol
     1e-7, 200 iterations, auto, on the kernel path and on the torch path:
     iterations, stage exits, convergence, gradient norm and Amari to the
     mixing beside the JAX package's CPU fits of the same input
     (``JAX_CPU10``); the sources must be finite and the kernel path's
     fused pass must launch. A fit that ends unconverged does not fail
     the run: the staged schedule leaves the separation in its bf16 stage
     on some rounding orders, in the JAX package as in the port.

``python3 chip_smoke.py --phase8`` runs phases 0, 1 and 8 alone,
``--phase9`` phases 0, 1 and 9, ``--phase10`` phases 0, 1 and 10;
``--maxt-rung N T`` is phase 8c's child.

Phase 2 also holds the streaming kernels against their plain versions:
``streaming_fused_sums`` at 256 x 2,000,000 (every mode and tier a fit
runs), 306 x 1,000,003 (delta f32, plain bf16 on bf16 X, and the five
pairs only a direct call takes), 1024 x 200,000 and 72 x 1,000,003 (the
three pairs whose launch A runs on wgmma), ``streaming_loglik_sums`` at
256 x 2,000,000 and 1024 x 200,000 on both X dtypes, and at 306 and 72 x
1,000,003 on both X dtypes with and without the Y^2 sums, every loglik
case held to its plain version and to f64. Every case runs the tensor-core
route, which must launch at its mode and tier. A row each in the
``kernels`` line: ``streaming_fused_sums/tc`` (plain bf16 on bf16 X,
launches counted in phase 5b), ``streaming_fused_sums/tc_bf16x3``
(launches counted in phase 5c), ``streaming_fused_sums/tc_f32`` and
``streaming_fused_sums/tc_plain_f32`` (launches counted in phase 5,
their f32 cases held to f64 like every f32 case) and
``streaming_fused_sums/tc_bf16`` (delta bf16 on f32 X, launches counted
in phase 5d; the five direct-call pairs are its further cases). The
loglik kernel runs on wgmma on both dtypes (the log-lik modes of the two
wgmma launch A kernels), a row each (``streaming_loglik_sums/tc_f32``,
launches counted in phase 5; ``streaming_loglik_sums/tc_bf16``, launches
counted in phase 5c).

The line before the last is a JSON object describing every kernel:
launches on its path (phase 3 for the resident core kernels, phase 4
for the whitening kernels, 4b for the grouped one, 5 for the streaming
kernels' f32 routes, 5b and 5c for the bf16 and bf16x3 routes, 5d for
delta bf16 on f32 X; ``launches_by_path`` adds every other fit's,
phases 6, 6b, 9b, 9c and 10 among them, and phase 7's counted on rank 0; the fused pass's tensor-core kernel counts
the launches of its three tiers in phase 4, ``launches_by_tier``), error
against the plain version (and, for every f32 case, against f64), and
the numbers of its headline case (``_KERNELS``), and ``kernel_route``,
the instructions its products run on (``wgmma``, ``mma.sync``, or the
FP32 pipes): ``ms`` and ``plain_ms``
(CUDA events, one synchronised call at a time, median of 10),
``ms_stream`` (10 calls back
to back between two events, over the count, median of 5: the device time
without the host's launch gaps), ``bound_ms`` (the larger of X's bytes
over the HBM rate and the FMAs over the peak rate of their type,
``bound_by`` saying which), ``share`` = bound / ms and ``share_stream`` =
bound / ms_stream, and ``library_ms`` / ``library_ms_stream``, the
one-call yardstick's times taken the same two ways, or null where no
single PyTorch call computes the function; ``cases`` holds the same for
every case. The last line is ``{"ok": true, "device": {...}}``.
Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N = 64
T = 2_000_000
SEED = 0
# Absolute floor of the f32 check, per summed column: sums over T
# columns of O(1) terms carry ~1e-7 * T of f32 rounding in any order.
F32_FLOOR_PER_COL = 1e-7
# The kernel's f32 error may be this many times the plain f32 version's.
F32_ERR_FACTOR = 4.0
# bf16 tiers: the kernel and the plain version of the same tier differ
# only in the order of f32 sums of exact bf16 products.
BF16_RTOL = 1e-4
# The device-whitening slice: bench.py's configuration, and the grouped
# covariance's shape (N > 512).
N4, T4, SEED4 = 64, 4_000_000, 42
N4B, T4B = 600, 1_000_000
# Whiteness of the device path (tests/test_whitening.py:374-408): of the
# emitted data, and of K against the f64 covariance of the same input.
SELF_WHITE_MAX = 1e-4
K_RESIDUAL_MAX = 1e-3
# The large-N slice (BASELINE config 5's width on one card), the MEG
# channel count (Neuromag/MEGIN, 306) with a ragged T, and the JAX
# package's large-N exhibit.
N5, T5 = 256, 2_000_000
N_MEG, T_MEG = 306, 1_000_003
N5B, T5B, SEED5B = 1024, 200_000, 42
# The streaming route's smallest widths (65-128: one W row block) in
# phase 2.
N_SMALL2 = 72
# BASELINE config 4 (benchmarks/suite.py:519-552): JADE(50) -> Picard on a
# 128 x 1,000,000 mixed mixture, float64 NumPy, seed 7.
N6, T6, SEED6, JADE_IT6 = 128, 1_000_000, 7, 50
CONFIG6 = {"jade_it": JADE_IT6, "tol": 1e-7, "max_iter": 200}
# BASELINE config 5 (EEG/MEG scale, 256 x 10,000,000, sample-sharded) on
# two gloo ranks that share the one card: the bench mixture, bench.py's
# seed. And bench.py's configuration (bench.py:88-99) on one NCCL rank.
N7, T7, SEED7, RANKS7 = 256, 10_000_000, 42, 2
N7B, T7B, SEED7B = 64, 4_000_000, 42
# Seconds phase 7's ranks may take, and their process group's timeout.
PHASE7_TIMEOUT = 420
# Ragged columns for the tensor-core kernel's phase-2 cases.
T_RAGGED = 1_000_003
# Phase 9: the native runtime. (seed, n) of the n x n draws held bit for
# bit against the pure-Python sampler, the u64 stream's length, the LCG
# Laplace stream's rows x columns, and the sizes of the timed draws.
DRAWS9 = ((0, 64), (2**64 - 1, 33), (42, 256))
U64_COUNT9 = 10_000
LCG_N9, LCG_T9 = 4, 1_000_003
DRAW_N9, PLAIN_DRAW_N9 = 1024, 256
# The LCG values against NumPy's closed form (libm's log against NumPy's,
# 1 ulp); the states are held bit for bit.
LCG_RTOL9 = 1e-13
# Seconds the 1024 x 200,000 fit's ``picard.w_init`` step may take (the
# native draw of 1024^2 normals and their host f64 decorrelation).
W_INIT_MAX_S = 1.0
# Phase 9c: the JAX suite's oracle-conformance cases
# (benchmarks/suite.py:650-659): (label, n, t, mixed kurtosis, density),
# each fitted from W_init = I at tol 1e-7 within 500 iterations, and
# BASELINE's bound on the Amari distance to the f64 oracle. All five run:
# the two 64 x 500,000 oracle calls took 49.4 s together on the H100
# machine's 8 host cores (``port_turns.py --conformance``), under the 60 s
# that admits them.
SUITE_CONFORMANCE = (
    ("criterion_8x100k", 8, 100_000, False, "tanh"),
    ("picard_o_32x100k", 32, 100_000, False, "tanh"),
    ("extended_64x500k", 64, 500_000, True, "tanh"),
    ("exp_32x100k", 32, 100_000, False, "exp"),
    ("cube_64x500k", 64, 500_000, True, "cube"),
)
AMARI_ORACLE_MAX = 1e-3
# Phase 10: the staged schedule on a 64 x 100,000 mixed mixture (seed 0),
# where the port's CPU fit with 8 threads leaves the separation in its
# bf16 stage (tests/test_torch_staged.py). The JAX package's fits of the
# same input on the CPU (float32, x64 on, ``random_state=0``, tol 1e-7):
# path -> (iterations, stage exits, Amari to the mixing); both converged.
N10, T10, SEED10, MAX_ITER10 = 64, 100_000, 0, 200
JAX_CPU10 = {"pallas (interpret)": (77, (35, 76, 77), 6.550e-4),
             "xla": (22, (15, 21, 22), 6.543e-4)}
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s, scalar FP32 FMA/s outside the tensor cores (67 TFLOP/s), and
# dense bf16 tensor-core FMA/s (989 TFLOP/s) for the products of the
# tensor-core kernel's tiers, which are exact bf16 products.
HBM_BYTES_S = 3.35e12
F32_FMA_S = 33.5e12
BF16_FMA_S = 494.5e12


def _log(msg):
    print(msg, flush=True)


def phase0_env():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(smi)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    _log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
         f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase1_build():
    from picard_ica_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.load()
    _log(f"build: {path.name} in {seconds:.1f} s")
    # ptxas's registers and spills: every kernel of a source in one line,
    # the tensor-core kernels one line each.
    for src, kernels in _build.resource_report().items():
        regs = [k[1] for k in kernels]
        spills = sum(k[2] + k[3] for k in kernels)
        _log(f"ptxas {src}: {len(kernels)} kernels, registers {min(regs)}-{max(regs)}, "
             f"spill bytes {spills}")
        if src in ("rotated_fused_tc.cu", "rotated_fused_wgmma.cu", "streaming_fused_tc.cu"):
            for name, r, st, ld in kernels:
                _log(f"  {name}: {r} registers, spill stores {st} B, loads {ld} B")
    if any("streaming_kernel" in k[0] for ks in _build.resource_report().values() for k in ks):
        raise AssertionError("the library holds a scalar streaming kernel")
    # Kernel 8's launch A on wgmma (delta bf16x3 and f32 on f32 X): its
    # instantiations' registers at launch and spills, at a glance.
    wg = [k for k in _build.resource_report().get("streaming_fused_tc.cu", [])
          if "rotate_wgmma_kernel" in k[0]]
    _log(f"wgmma launch A: {len(wg)} instantiations, registers at launch "
         f"{sorted({k[1] for k in wg})}, spill bytes {sum(k[2] + k[3] for k in wg)}")
    # The host library (g++): the w_init draw, the data stream, the oracle.
    from picard_ica_tpu_torch import native

    native_path, native_seconds = native.build()
    native.load()
    _log(f"build: {native_path.name} in {native_seconds:.1f} s")
    return native_seconds


def _time_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _time_stream_ms(fn, count=10, reps=5, warmup=2):
    """Device time of one call: ``count`` calls back to back between two
    CUDA events, over the count (median of ``reps``), so the host's time
    to launch a call hides behind the device's work on the one before."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def _max_abs(a, b):
    return max(float((u.double() - v.double()).abs().max()) for u, v in zip(a, b))


def _bytes(tensors):
    import torch

    return sum(v.numel() * v.element_size() for v in tensors
               if isinstance(v, torch.Tensor))


# bf16 products per N^2 a column at each tier of the tensor-core kernel.
_BF16_PASSES = {"bf16": 1, "bf16x3": 3, "bf16x6": 6}


def _core_fmas(name, args, tensor_cores=True):
    """(f32 FMAs, bf16 products) a core kernel's call needs: N^2 per
    column for each rotation and each contraction it computes, tripled
    at the bf16x3 tier. Every core kernel runs every tier on the tensor
    cores, its f32 tier as six bf16 products ("bf16x6"); with
    ``tensor_cores=False`` that tier counts as f32 FMAs, a scalar FP32
    kernel's work. The density's elementwise work is not counted."""
    import torch

    if name.endswith("fused_sums"):
        _, _, x, _, need_h, _, precision, absolute_ll = args
        if x.dtype == torch.bfloat16:
            rot, con = "bf16", ("bf16" if precision == "f32" else precision)
        else:
            rot = con = precision
        work = [(rot, 1 if absolute_ll else 2), (con, 1 + need_h)]
        if tensor_cores:
            work = [("bf16x6" if tier == "f32" else tier, k) for tier, k in work]
    elif name == "rotated_moments_sums":
        _, x, _, need_h, _ = args
        con = "bf16x6" if tensor_cores else "f32"
        work = [("bf16" if x.dtype == torch.bfloat16 else con, 1), (con, 1 + need_h)]
    else:  # the loglik kernels: one rotation
        x = args[1]
        tier = "bf16" if x.dtype == torch.bfloat16 else "f32"
        if tier == "f32" and tensor_cores:
            tier = "bf16x6"
        work = [(tier, 1)]
    n, t = x.shape
    f32 = sum(k for tier, k in work if tier == "f32") * n * n * t
    bf16 = sum(k * _BF16_PASSES[tier] for tier, k in work if tier != "f32") * n * n * t
    return f32, bf16


def _bound(n_bytes, f32_fmas, bf16_fmas=0):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the FMAs over the peak rate of their type."""
    mem = n_bytes / HBM_BYTES_S * 1e3
    ops = (f32_fmas / F32_FMA_S + bf16_fmas / BF16_FMA_S) * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def _time_both(fn):
    """(one synchronised call at a time, back to back) ms of a call."""
    return _time_ms(fn), _time_stream_ms(fn)


def _time_turns(kern, library):
    """The kernel and its one-call yardstick in turns (kernel, call,
    call, kernel), each timed both ways; returns ((kernel ms, back to
    back), (call ms, back to back), every turn's pair)."""
    turns = [_time_both(fn) for fn in (kern, library, library, kern)]
    k = tuple((a + b) / 2 for a, b in zip(turns[0], turns[3]))
    lib = tuple((a + b) / 2 for a, b in zip(turns[1], turns[2]))
    return k, lib, turns


def _fmt_pair(pair):
    return f"{pair[0]:.3f} ms ({pair[1]:.3f} back to back)"


def phase2_kernels():
    """Each kernel against its plain version; returns per-kernel rows."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.ops.densities import Cube, Tanh

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.laplace(size=(N, T)) / np.sqrt(2.0)).astype(np.float32)).to(dev)
    x16 = x.to(torch.bfloat16)
    m_old = torch.from_numpy(np.eye(N) + 0.1 * rng.standard_normal((N, N))).float().to(dev)
    m_new = m_old + torch.from_numpy(0.01 * rng.standard_normal((N, N))).float().to(dev)
    d = Tanh()

    # (kernel, label, tier, args, plain fn) — the main path's modes first.
    fused, moments, loglik = (K.rotated_fused_sums, K.rotated_moments_sums,
                              K.rotated_loglik_sums)
    cases = [
        (fused, "plain bf16, bf16 X", "bf16",
         lambda m1, m0, xx: (m1, m0, xx, d, False, False, "bf16", True), x16),
        (fused, "plain bf16, bf16 X, H+ysq", "bf16",
         lambda m1, m0, xx: (m1, m0, xx, d, True, True, "bf16", True), x16),
        (fused, "delta bf16x3", "bf16x3",
         lambda m1, m0, xx: (m1, m0, xx, d, False, False, "bf16x3", False), x),
        # The tensor-core cases with the cube density (a few FP32 ops an
        # element, against tanh's exp / log1p / divides): their difference
        # is the density's share of the kernel.
        (fused, "plain bf16, bf16 X, cube", "bf16",
         lambda m1, m0, xx: (m1, m0, xx, Cube(), False, False, "bf16", True), x16),
        (fused, "delta bf16x3, cube", "bf16x3",
         lambda m1, m0, xx: (m1, m0, xx, Cube(), False, False, "bf16x3", False), x),
        (fused, "delta f32", "f32",
         lambda m1, m0, xx: (m1, m0, xx, d, False, False, "f32", False), x),
        (fused, "delta f32, H+ysq", "f32",
         lambda m1, m0, xx: (m1, m0, xx, d, True, True, "f32", False), x),
        (fused, "plain f32, H+ysq", "f32",
         lambda m1, m0, xx: (m1, m0, xx, d, True, True, "f32", True), x),
        (fused, "delta f32, cube", "f32",
         lambda m1, m0, xx: (m1, m0, xx, Cube(), False, False, "f32", False), x),
        (moments, "f32", "f32",
         lambda m1, m0, xx: (m1, xx, d, False, False), x),
        (moments, "f32, H+ysq", "f32",
         lambda m1, m0, xx: (m1, xx, d, True, True), x),
        (moments, "bf16 X", "bf16",
         lambda m1, m0, xx: (m1, xx, d, False, False), x16),
        (loglik, "f32", "f32",
         lambda m1, m0, xx: (m1, xx, d, False), x),
        (loglik, "f32, ysq", "f32",
         lambda m1, m0, xx: (m1, xx, d, True), x),
        # sign re-baselines inside the bf16 tier read its bf16 copy of X
        (loglik, "bf16 X", "bf16",
         lambda m1, m0, xx: (m1, xx, d, False), x16),
    ]
    plain_of = {
        fused: K.rotated_fused_sums_plain,
        moments: K.rotated_moments_sums_plain,
        loglik: K.rotated_loglik_sums_plain,
    }
    rows = {}
    for kern, label, tier, make, xx in cases:
        _hold(rows, kern, plain_of[kern], label, tier, make, m_new, m_old, xx)
    del x, x16
    torch.cuda.empty_cache()

    # The tensor-core kernel's tier pairs and modes at ragged shapes: N
    # past and short of a 16-row tile, T past a 64-column sub-tile, rows
    # not 16-byte aligned.
    def f(precision, absolute_ll, flags=False):
        return lambda m1, m0, xx: (m1, m0, xx, d, flags, flags, precision, absolute_ll)

    def mom(flags=False):
        return lambda m1, m0, xx: (m1, xx, d, flags, flags)

    def ll(need_ysq):
        return lambda m1, m0, xx: (m1, xx, d, need_ysq)

    for n in (17, 63):
        xr, m_old_r, m_new_r = _stream_inputs(n, T_RAGGED, n)
        xr16 = xr.to(torch.bfloat16)
        for kern, label, tier, make, xx in [
            (fused, "plain bf16, bf16 X", "bf16", f("bf16", True), xr16),
            (fused, "delta bf16x3", "bf16x3", f("bf16x3", False), xr),
            (fused, "delta bf16x3, bf16 X, H+ysq", "bf16x3", f("bf16x3", False, True), xr16),
            (fused, "delta bf16, f32 X", "bf16", f("bf16", False), xr),
            (fused, "delta f32", "f32", f("f32", False), xr),
            (fused, "delta f32, H+ysq", "f32", f("f32", False, True), xr),
            (moments, "f32", "f32", mom(), xr),
            (moments, "f32, H+ysq", "f32", mom(True), xr),
            (moments, "bf16 X, H+ysq", "bf16", mom(True), xr16),
            (loglik, "f32, ysq", "f32", ll(True), xr),
            (loglik, "bf16 X", "bf16", ll(False), xr16),
        ]:
            _hold(rows, kern, plain_of[kern], label, tier, make, m_new_r, m_old_r, xx)
        del xr, xr16
        torch.cuda.empty_cache()
    return rows


def _hold(rows, kern, plain, label, tier, make, m_new, m_old, xx, key=None, f64=False):
    """Hold one kernel call against its plain version: f32 tiers against
    an f64 evaluation of the same sums (the kernel's error may be
    F32_ERR_FACTOR x the plain f32 version's plus F32_FLOOR_PER_COL per
    summed column), bf16 tiers against the plain version of the same
    tier at BF16_RTOL of scale, and with ``f64`` also against the f64
    evaluation by the f32 rule, the plain version's error at the same
    tier taking the plain f32 version's place. ``max_abs_err`` is the
    error against the plain version; a case held against f64 also keeps
    both errors against f64. Times both; adds the case to ``rows[key]``
    (default: the kernel's name)."""
    import torch

    from picard_ica_tpu_torch.ops import kernels as K

    name = kern.__name__
    n, t = xx.shape
    args = make(m_new, m_old, xx)
    route = None
    if name == "rotated_fused_sums":
        # Kernel 1's two routes, a row each; the call must take its own.
        ct, rot = K._tiers(xx, args[6])
        route = ("wgmma" if K._core_wgmma_pair(not args[7], rot, ct,
                                                xx.dtype == torch.bfloat16, args[4])
                 else "mma.sync")
        key = key or CORE_ROUTE_ROW[route]
        before = K.rotated_fused_sums.launches_by_route[route][ct]
    out_k = kern(*args)
    torch.cuda.synchronize()
    if route and K.rotated_fused_sums.launches_by_route[route][ct] != before + 1:
        raise AssertionError(f"{name} [{label}] did not run on the {route} route")
    out_p = plain(*args)
    err_k = _max_abs(out_k, out_p)
    extra = {}
    ok = True
    detail = ""
    if tier != "f32":
        scale = max(float(v.abs().max()) for v in out_p)
        bound = BF16_RTOL * scale
        ok = err_k <= bound
        detail = f"err vs plain {tier} {err_k:.4g} (bound {bound:.4g})"
    if tier == "f32" or f64:
        args64 = make(m_new.double(), m_old.double(), xx.double())
        out_64 = plain(*args64)
        del args64
        err_k64 = _max_abs(out_k, out_64)
        err_p64 = _max_abs(out_p, out_64)
        bound = F32_ERR_FACTOR * err_p64 + F32_FLOOR_PER_COL * t
        ok = ok and err_k64 <= bound
        detail = (f"{detail}, vs f64" if detail else f"err vs plain {tier} {err_k:.4g}, vs f64")
        detail += f" {err_k64:.4g} (plain {tier} {err_p64:.4g}, bound {bound:.4g})"
        extra = {"err_vs_f64": err_k64, "plain_err_vs_f64": err_p64}
        del out_64
    finite = all(bool(torch.isfinite(v).all()) for v in out_k)
    n_bytes = _bytes(args) + _bytes(out_k)
    bound_ms, bound_by = _bound(n_bytes, *_core_fmas(name, args))
    bound_fp32 = _bound(n_bytes, *_core_fmas(name, args, False))[0]
    if bound_fp32 != bound_ms:
        # The tensor-core f32 tier: a scalar FP32 kernel's bound for the
        # same work, kept beside.
        extra["bound_fp32_ms"] = bound_fp32
        detail += f", FP32 bound {bound_fp32:.3f} ms"
    del out_k, out_p
    torch.cuda.empty_cache()
    ms, ms_stream = _time_both(lambda: kern(*args))
    plain_ms = _time_ms(lambda: plain(*args))
    _log(f"{name}{f' ({route})' if route else ''} [{label}] {n} x {t}: {detail}, finite={finite}, "
         f"kernel {_fmt_pair((ms, ms_stream))}, plain {plain_ms:.3f} ms, "
         f"bound {bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f} "
         f"({bound_ms / ms_stream:.3f} back to back)")
    if not (ok and finite):
        raise AssertionError(f"{name} [{label}] disagrees with its plain version")
    row = rows.setdefault(key or name, {"max_abs_err": 0.0, "cases": []})
    row["max_abs_err"] = max(row["max_abs_err"], err_k)
    if "err_vs_f64" in extra:
        key64 = "f32_err_vs_f64" if tier == "f32" else f"{tier}_err_vs_f64"
        row[key64] = max(row.get(key64, 0.0), extra["err_vs_f64"])
    row["cases"].append({"label": label, "case": f"{label}, {n} x {t}", "ms": ms,
                         "ms_stream": ms_stream, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "share": bound_ms / ms, "share_stream": bound_ms / ms_stream,
                         "library_ms": None, "library_ms_stream": None,
                         "max_abs_err": err_k, **extra})


def _stream_inputs(n, t, seed):
    """Unit-variance Laplace X made on the card, and weights near the
    identity whose rows keep unit scale at any N."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.utils.datagen import laplace_sources_device

    rng = np.random.default_rng(seed)
    x = laplace_sources_device(n, t, seed, "cuda").mul_(float(1.0 / np.sqrt(2.0)))
    s = 0.8 / np.sqrt(n)
    m_old = torch.from_numpy(np.eye(n) + s * rng.standard_normal((n, n))).float().cuda()
    m_new = m_old + torch.from_numpy(0.1 * s * rng.standard_normal((n, n))).float().cuda()
    return x, m_old, m_new


def _loglik_cases(loglik, ll):
    """Kernel 9's phase-2 cases at a ragged shape: f32 and bf16 X, with
    and without the Y^2 sums, each held to the plain version and to f64."""
    return [(loglik, f"{label}{', ysq' if need_ysq else ''}", tier, ll(need_ysq), bf16_x, row,
             True)
            for label, tier, bf16_x, row in ((LL_F32_LABEL, "f32", False, LL_F32_ROW),
                                             (LL_BF16_LABEL, "bf16", True, LL_BF16_ROW))
            for need_ysq in (False, True)]


def phase2_streaming_kernels():
    """The streaming kernels against their plain versions at the large-N
    shapes: every mode and tier of the 256-component fit, the MEG width
    with ragged N and T, and 1024 components."""
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.ops.densities import Tanh

    d = Tanh()
    fused, loglik = K.streaming_fused_sums, K.streaming_loglik_sums
    plain_of = {fused: K.streaming_fused_sums_plain, loglik: K.streaming_loglik_sums_plain}

    def f(precision, absolute_ll, flags=False):
        return lambda m1, m0, xx: (m1, m0, xx, d, flags, flags, precision, absolute_ll)

    def ll(need_ysq):
        return lambda m1, m0, xx: (m0, xx, d, need_ysq)

    # (kernel, label, tier, args, bf16 X, row[, held against f64 too]) —
    # the main path's modes
    # first: a fit's plain bf16 passes on bf16 X (TC_ROW) and its delta
    # bf16x3 (TC3_ROW), delta f32 (TC_F32_ROW), plain f32 (TC_PF32_ROW,
    # the moments hand-off) and delta bf16 (TC_BF16_ROW, a
    # kernel_precision="bf16" fit's tries) passes on f32 X; the five pairs
    # only a direct call takes, as cases of TC_BF16_ROW. Every case runs
    # the tensor-core route.
    plans = [
        ((N5, T5, 5), [
            (fused, TC_F32_LABEL, "f32", f("f32", False), False, TC_F32_ROW),
            (fused, TC3_LABEL, "bf16x3", f("bf16x3", False), False, TC3_ROW, True),
            (fused, TC3_LABEL + ", H+ysq", "bf16x3", f("bf16x3", False, True), False, TC3_ROW,
             True),
            (fused, TC_LABEL, "bf16", f("bf16", True), True, TC_ROW),
            (fused, TC_LABEL + ", H+ysq", "bf16", f("bf16", True, True), True, TC_ROW),
            (fused, TC_PF32_LABEL, "f32", f("f32", True), False, TC_PF32_ROW),
            (fused, TC_PF32_LABEL + ", H+ysq", "f32", f("f32", True, True), False, TC_PF32_ROW),
            (fused, TC_F32_LABEL + ", H+ysq", "f32", f("f32", False, True), False, TC_F32_ROW),
            (fused, TC_BF16_LABEL, "bf16", f("bf16", False), False, TC_BF16_ROW),
            (fused, TC_BF16_LABEL + ", H+ysq", "bf16", f("bf16", False, True), False,
             TC_BF16_ROW),
            (loglik, LL_F32_LABEL, "f32", ll(False), False, LL_F32_ROW),
            (loglik, LL_F32_LABEL + ", ysq", "f32", ll(True), False, LL_F32_ROW),
            (loglik, LL_BF16_LABEL, "bf16", ll(False), True, LL_BF16_ROW, True),
        ]),
        ((N_MEG, T_MEG, 6), [
            (fused, TC_F32_LABEL, "f32", f("f32", False), False, TC_F32_ROW),
            (fused, TC_F32_LABEL + ", H+ysq", "f32", f("f32", False, True), False, TC_F32_ROW),
            (fused, TC3_LABEL, "bf16x3", f("bf16x3", False), False, TC3_ROW, True),
            (fused, TC3_LABEL + ", H+ysq", "bf16x3", f("bf16x3", False, True), False, TC3_ROW,
             True),
            (fused, TC_LABEL, "bf16", f("bf16", True), True, TC_ROW),
            (fused, TC_LABEL + ", H+ysq", "bf16", f("bf16", True, True), True, TC_ROW),
            (fused, "plain bf16, f32 X", "bf16", f("bf16", True), False, TC_BF16_ROW),
            (fused, "plain bf16x3, f32 X", "bf16x3", f("bf16x3", True), False, TC_BF16_ROW),
            (fused, "delta bf16, bf16 X", "bf16", f("bf16", False), True, TC_BF16_ROW),
            (fused, "delta bf16x3, bf16 X", "bf16x3", f("bf16x3", False), True, TC_BF16_ROW),
            (fused, "plain bf16x3, bf16 X", "bf16x3", f("bf16x3", True), True, TC_BF16_ROW),
            *_loglik_cases(loglik, ll),
        ]),
        ((N5B, T5B, 7), [
            (fused, TC_F32_LABEL, "f32", f("f32", False), False, TC_F32_ROW),
            (fused, TC_LABEL, "bf16", f("bf16", True), True, TC_ROW),
            (fused, TC3_LABEL, "bf16x3", f("bf16x3", False), False, TC3_ROW, True),
            (fused, TC_PF32_LABEL, "f32", f("f32", True), False, TC_PF32_ROW),
            (loglik, LL_F32_LABEL, "f32", ll(False), False, LL_F32_ROW),
            (loglik, LL_BF16_LABEL, "bf16", ll(False), True, LL_BF16_ROW, True),
        ]),
        # The wgmma launch A's pairs and kernel 9 at the route's smallest
        # width: one W row block, mostly padding, and a ragged T with rows
        # not 16-byte aligned (bf16 X loaded with plain loads, f32 X's
        # rows copied as their 16-byte aligned spans).
        ((N_SMALL2, T_RAGGED, 8), [
            (fused, TC_LABEL, "bf16", f("bf16", True), True, TC_ROW),
            (fused, TC_LABEL + ", H+ysq", "bf16", f("bf16", True, True), True, TC_ROW),
            (fused, TC_F32_LABEL, "f32", f("f32", False), False, TC_F32_ROW),
            (fused, TC_F32_LABEL + ", H+ysq", "f32", f("f32", False, True), False, TC_F32_ROW),
            (fused, TC3_LABEL, "bf16x3", f("bf16x3", False), False, TC3_ROW, True),
            (fused, TC3_LABEL + ", H+ysq", "bf16x3", f("bf16x3", False, True), False, TC3_ROW,
             True),
            *_loglik_cases(loglik, ll),
        ]),
    ]
    rows = {}
    for (n, t, seed), cases in plans:
        x, m_old, m_new = _stream_inputs(n, t, seed)
        x16 = x.to(torch.bfloat16)
        for kern, label, tier, make, bf16_x, key, *f64 in cases:
            xx = x16 if bf16_x else x
            before = _case_launches(kern, make(m_new, m_old, xx))
            _hold(rows, kern, plain_of[kern], label, tier, make, m_new, m_old, xx, key=key,
                  f64=bool(f64))
            if _case_launches(kern, make(m_new, m_old, xx)) == before:
                raise AssertionError(f"[{label}] did not run its kernel at its mode and tier")
        del x, x16
        torch.cuda.empty_cache()
    return rows


def _contract_library(ws, n, tier, need_h, cols):
    """Launch B's yardstick: ``torch.bmm`` over the group views of the
    workspace's planes, one call a chunk and matrix, in the planes' dtype
    (f32 with TF32 off at f32, bf16 at bf16); None at bf16x3, whose three
    part products no one call sums."""
    import torch

    if tier == "bf16x3":
        return None
    gpc = ws.shape[-1] // cols

    def run():
        for c in range(ws.shape[0]):
            for m in range(1 + need_h):
                a = ws[c, 2 * m].unflatten(1, (gpc, cols)).transpose(0, 1)
                b = ws[c, 2 * m + 1].unflatten(1, (gpc, cols)).permute(1, 2, 0)
                torch.bmm(a, b)

    return run


def _hold_contract(rows, ws, n, t, tier, need_h, plan):
    """Launch B alone against its plain version (bf16 tiers at BF16_RTOL of
    scale; f32 against f64 sums of the same f32 operands by the f32
    rule, per group's columns), timed with its plain version and its
    yardstick; adds the case to ``rows[CONTRACT_ROW]``."""
    import torch

    from picard_ica_tpu_torch.ops import kernels as K

    args = (ws, n, tier, need_h, plan.cols_per_group, plan.n_parts)
    label = f"{CONTRACT_LABEL} {tier}{', H' if need_h else ''}"
    before = K.stream_contract_sums.launches
    out_k = K.stream_contract_sums(*args)
    torch.cuda.synchronize()
    if K.stream_contract_sums.launches != before + 1:
        raise AssertionError(f"[{label}] did not launch its kernel")
    out_p = K.stream_contract_sums_plain(*args)
    pairs = [(k, p) for k, p in zip(out_k, out_p) if k is not None]
    err_k = max(float((k - p).abs().max()) for k, p in pairs)
    finite = all(bool(torch.isfinite(k).all()) for k, _ in pairs)
    extra = {}
    if tier == "f32":
        out_64 = K.stream_contract_sums_plain(*args, acc=torch.float64)
        err_k64 = max(float((k.double() - r).abs().max()) for (k, _), r in zip(pairs, out_64))
        err_p64 = max(float((p.double() - r).abs().max()) for (_, p), r in zip(pairs, out_64))
        bound = F32_ERR_FACTOR * err_p64 + F32_FLOOR_PER_COL * plan.cols_per_group
        ok = err_k64 <= bound
        detail = (f"err vs plain f32 {err_k:.4g}, vs f64 {err_k64:.4g} (plain f32 "
                  f"{err_p64:.4g}, bound {bound:.4g})")
        extra = {"err_vs_f64": err_k64, "plain_err_vs_f64": err_p64}
        del out_64
    else:
        bound = BF16_RTOL * max(float(p.abs().max()) for _, p in pairs)
        ok = err_k <= bound
        detail = f"err vs plain {tier} {err_k:.4g} (bound {bound:.4g})"
    del out_k, out_p, pairs
    torch.cuda.empty_cache()
    # The bytes: each operand plane's N x T values read once, the partials
    # written once; the operations: the tier's bf16 products of N^2 a
    # column a matrix.
    mats = 1 + need_h
    elem = 4 if tier == "f32" else 2 * (2 if tier == "bf16x3" else 1)
    n_bytes = 2 * mats * elem * n * t + mats * plan.n_parts * n * n * 4
    bound_ms, bound_by = _bound(n_bytes, 0, _CONTRACT_PRODUCTS[tier] * mats * n * n * t)
    ms, ms_stream = _time_both(lambda: K.stream_contract_sums(*args))
    plain_ms = _time_ms(lambda: K.stream_contract_sums_plain(*args))
    library = _contract_library(ws, n, tier, need_h, plan.cols_per_group)
    lib_ms, lib_stream = _time_both(library) if library else (None, None)
    lib_text = _fmt_pair((lib_ms, lib_stream)) if library else "none"
    _log(f"{CONTRACT_ROW} [{label}] {n} x {t} ({plan.n_parts} groups of {plan.cols_per_group}, "
         f"{ws.shape[0]} chunks): {detail}, finite={finite}, kernel {_fmt_pair((ms, ms_stream))}, "
         f"plain {plain_ms:.3f} ms, bmm {lib_text}, bound {bound_ms:.3f} ms ({bound_by}), "
         f"share {bound_ms / ms:.3f} ({bound_ms / ms_stream:.3f} back to back)")
    if not (ok and finite):
        raise AssertionError(f"{CONTRACT_ROW} [{label}] disagrees with its plain version")
    row = rows.setdefault(CONTRACT_ROW, {"max_abs_err": 0.0, "cases": []})
    row["max_abs_err"] = max(row["max_abs_err"], err_k)
    if "err_vs_f64" in extra:
        row["f32_err_vs_f64"] = max(row.get("f32_err_vs_f64", 0.0), extra["err_vs_f64"])
    row["cases"].append({"label": label, "case": f"{label}, {n} x {t}", "ms": ms,
                         "ms_stream": ms_stream, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "share": bound_ms / ms,
                         "share_stream": bound_ms / ms_stream, "library_ms": lib_ms,
                         "library_ms_stream": lib_stream, "max_abs_err": err_k, **extra})


def phase2_contract():
    """Kernel 8's launch B alone at 256 x 2,000,000 and 306 x 1,000,003,
    every contraction tier without and with H, over the workspace of
    unit-variance Laplace Y and psi = tanh(Y) (psi' = 1 - psi^2 and Y^2):
    each group's partials against the plain version's."""
    import torch

    from picard_ica_tpu_torch.ops import kernels as K

    rows = {}
    for n, t, seed in ((N5, T5, 5), (N_MEG, T_MEG, 6)):
        y, _, _ = _stream_inputs(n, t, seed)
        psi = torch.tanh(y)
        for need_h in (False, True):
            ops = [psi, y] + ([1.0 - psi * psi, y * y] if need_h else [])
            for tier in CONTRACT_TIERS:
                plan = K.stream_tc_plan(n, t, need_h, tier)
                ws = K.contract_workspace(ops, tier, plan)
                _hold_contract(rows, ws, n, t, tier, need_h, plan)
                del ws
                torch.cuda.empty_cache()
            del ops
        del y, psi
        torch.cuda.empty_cache()
    return rows


def _case_launches(kern, args):
    """The launches so far of a streaming case's kernel at its mode and
    contraction tier (the fused kernel) or X's tier (the loglik kernel)."""
    import torch

    from picard_ica_tpu_torch.ops import kernels as K

    if kern is K.streaming_loglik_sums:
        return kern.launches_by_tier["bf16" if args[1].dtype == torch.bfloat16 else "f32"]
    mode = "plain" if args[7] else "delta"
    return kern.launches_by_mode[mode][K._tiers(args[2], args[6])[0]]


def _f32_check(name, label, x, fmas, run, plain, run64, library):
    """Hold a whitening kernel's f32 output against an f64 evaluation of
    the same sums: its error may be F32_ERR_FACTOR x the plain f32
    version's plus F32_FLOOR_PER_COL per summed column. Times the kernel
    in turns with ``library``, the one PyTorch call that computes the
    same function (a yardstick only: the port never calls it), both ways
    as phase 2 times every kernel, and the plain version. Returns the row
    of the case."""
    import torch

    n, t = x.shape
    out_k = run()
    torch.cuda.synchronize()
    out_p = plain()
    out_64 = run64()
    err_k = _max_abs([out_k], [out_64])
    err_p = _max_abs([out_p], [out_64])
    del out_p, out_64
    bound = F32_ERR_FACTOR * err_p + F32_FLOOR_PER_COL * t
    finite = bool(torch.isfinite(out_k).all())
    bound_ms, bound_by = _bound(_bytes([x]) + _bytes([out_k]), fmas)
    del out_k
    (ms, ms_stream), (library_ms, library_ms_stream), turns = _time_turns(run, library)
    plain_ms = _time_ms(plain)
    _log(f"{name} [{label}] {n} x {t}: err vs f64 {err_k:.4g} (plain f32 "
         f"{err_p:.4g}, bound {bound:.4g}), finite={finite}, "
         f"kernel {_fmt_pair((ms, ms_stream))}, "
         f"library {_fmt_pair((library_ms, library_ms_stream))} (turns "
         f"{', '.join(_fmt_pair(v) for v in turns)}), plain {plain_ms:.3f} ms, "
         f"bound {bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f} "
         f"({bound_ms / ms_stream:.3f} back to back)")
    if not (err_k <= bound and finite):
        raise AssertionError(f"{name} [{label}] disagrees with its plain version")
    return {"label": label, "case": f"{label}, {n} x {t}", "ms": ms,
            "ms_stream": ms_stream, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / ms,
            "share_stream": bound_ms / ms_stream, "library_ms": library_ms,
            "library_ms_stream": library_ms_stream, "turns_ms": turns,
            "max_abs_err": err_k}


def phase2_whitening_kernels():
    """The whitening kernels against their plain versions."""
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import laplace_sources_device

    rows = {}

    def add(name, row):
        entry = rows.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
        entry["cases"].append(row)

    # The whitening kernels fold their partials on the card; the fold must
    # equal fold_pairwise bit for bit at the partial counts of the path
    # (64 x 4M: 1,954 chunks; 600 x 1M grouped: 31 groups).
    from picard_ica_tpu_torch.ops.moments import fold_pairwise

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in [(1954, N4), (1954, N4, N4), (31, N4B, N4B)]:
        p = torch.randn(shape, generator=gen, device="cuda").mul_(1e3)
        same = torch.equal(K.fold_partials(p.clone()), fold_pairwise(p.clone()))
        scratch = p.clone()
        fold_ms = _time_both(lambda: K.fold_partials(scratch))
        _log(f"fold {shape}: bitwise equal to fold_pairwise: {same}, "
             f"{fold_ms[0]:.4f} ms ({fold_ms[1]:.4f} back to back)")
        if not same:
            raise AssertionError(f"the fold kernel differs from fold_pairwise at {shape}")
        del p, scratch

    def tri(x):  # the covariance's FMAs: the upper triangle, once per column
        n, t = x.shape
        return n * (n + 1) // 2 * t

    # The yardsticks: one PyTorch call each, exact f32 (TF32 is off).
    def cov(x):
        return torch.cov(x, correction=0)

    def gram(x):
        return x @ x.T

    # Laplace rows around a mean of 1.5: centering matters.
    x = laplace_sources_device(N4, T4, SEED, "cuda").add_(1.5)
    x64 = x.double()
    mean = (x64.mean(dim=1)).float()
    add("row_sums", _f32_check(
        "row_sums", "f32", x, x.numel(), lambda: K.row_sums(x),
        lambda: K.row_sums_plain(x), lambda: K.row_sums_plain(x64),
        lambda: x.sum(dim=1)))
    add("centered_covariance_sums", _f32_check(
        "centered_covariance_sums", "f32", x, tri(x),
        lambda: K.centered_covariance_sums(x, mean),
        lambda: K.centered_covariance_sums_plain(x, mean),
        lambda: K.centered_covariance_sums_plain(x64, mean.double()),
        lambda: cov(x)))
    add("covariance_sums", _f32_check(
        "covariance_sums", "f32", x, tri(x), lambda: K.covariance_sums(x),
        lambda: K.covariance_sums_plain(x), lambda: K.covariance_sums_plain(x64),
        lambda: gram(x)))
    del x, x64

    x = laplace_sources_device(N4B, T4B, SEED, "cuda").add_(1.5)
    x64 = x.double()
    mean = (x64.mean(dim=1)).float()
    add("_grouped_covariance", _f32_check(
        "_grouped_covariance", "centered", x, tri(x),
        lambda: K._grouped_covariance(x, mean),
        lambda: K.grouped_covariance_plain(x, mean),
        lambda: K.grouped_covariance_plain(x64, mean.double()),
        lambda: cov(x)))
    add("_grouped_covariance", _f32_check(
        "_grouped_covariance", "uncentered", x, tri(x),
        lambda: K._grouped_covariance(x, None),
        lambda: K.grouped_covariance_plain(x, None),
        lambda: K.grouped_covariance_plain(x64, None),
        lambda: gram(x)))
    del x, x64
    return rows


def _fit(x, use_kernels, **config):
    import torch

    from picard_ica_tpu_torch import Picard

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = Picard.fit(x, _config(use_kernels=use_kernels, **config))
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def _config(**config):
    from picard_ica_tpu_torch import PicardConfig

    return PicardConfig(**{"random_state": 0, **config})


_CORE_KERNELS = ("rotated_fused_sums", "rotated_moments_sums", "rotated_loglik_sums")
# The tensor-core route of the streaming fused kernel: the phase-2 labels
# of a fit's five (mode, tier) pairs and their rows in the kernels line.
TC_LABEL = "plain bf16, bf16 X"
TC_ROW = "streaming_fused_sums/tc"
TC3_LABEL = "delta bf16x3"
TC3_ROW = "streaming_fused_sums/tc_bf16x3"
TC_F32_LABEL = "delta f32"
TC_F32_ROW = "streaming_fused_sums/tc_f32"
TC_PF32_LABEL = "plain f32 (moments)"
TC_PF32_ROW = "streaming_fused_sums/tc_plain_f32"
# A kernel_precision="bf16" fit's tries.
TC_BF16_LABEL = "delta bf16, f32 X"
TC_BF16_ROW = "streaming_fused_sums/tc_bf16"
# The route's rows by (mode, contraction tier), as launches_by_mode
# counts them.
_TC_PAIR = {TC_ROW: ("plain", "bf16"), TC3_ROW: ("delta", "bf16x3"),
            TC_F32_ROW: ("delta", "f32"), TC_PF32_ROW: ("plain", "f32"),
            TC_BF16_ROW: ("delta", "bf16")}
# Kernel 8's launch B alone (``ops.kernels.stream_contract_sums``, the
# route's contract_wgmma_kernel), a row with a case per tier, without and
# with H, at 256 x 2M and 306 x 1,000,003; its launches are the fused
# route's launch B, one a chunk (``contract_launches_by_tier``).
CONTRACT_ROW = "stream_contract_sums"
CONTRACT_LABEL = "launch B"
CONTRACT_TIERS = ("f32", "bf16x3", "bf16")
# bf16 products of each N^2 a column at a contraction tier.
_CONTRACT_PRODUCTS = {"f32": 6, "bf16x3": 3, "bf16": 1}
# The loglik kernel on the route, a row per X dtype.
LL_F32_LABEL = "loglik f32"
LL_F32_ROW = "streaming_loglik_sums/tc_f32"
LL_BF16_LABEL = "loglik bf16 X"
LL_BF16_ROW = "streaming_loglik_sums/tc_bf16"
_LL_TIER = {LL_F32_ROW: "f32", LL_BF16_ROW: "bf16"}
# The fused pass's two routes, a row each, and the tiers each serves: the
# wgmma kernel (csrc/rotated_fused_wgmma.cu) the main path's tries, delta
# bf16x3 and delta f32 on f32 X without H; the mma.sync kernel
# (csrc/rotated_fused_tc.cu) every other pair, in all three tiers.
WG_ROW = "rotated_fused_sums/wgmma"
CORE_ROUTE_ROW = {"mma.sync": "rotated_fused_sums", "wgmma": WG_ROW}
TIER_ROWS = {"rotated_fused_sums": ("bf16", "bf16x3", "f32"), WG_ROW: ("bf16x3", "f32")}
_ROUTE_OF_ROW = {row: route for route, row in CORE_ROUTE_ROW.items()}


def _count(name, launches):
    """A kernel's launches in one phase's counts (``_launches``)."""
    if name in TIER_ROWS:
        by_route = launches["by_route"][_ROUTE_OF_ROW[name]]
        return sum(by_route[t] for t in TIER_ROWS[name])
    if name in _TC_PAIR:
        mode, tier = _TC_PAIR[name]
        return launches["stream_by_mode"][mode][tier]
    if name in _LL_TIER:
        return launches["loglik_by_tier"][_LL_TIER[name]]
    if name == CONTRACT_ROW:
        return sum(launches["contract_by_tier"].values())
    return launches.get(name, 0)
_PHASE4_KERNELS = ("row_sums", "centered_covariance_sums", "covariance_sums",
                   "rotated_fused_sums", "rotated_moments_sums")


class PluginTanh:
    """A density plugin (the ``Density`` protocol, not a ``Tanh``) with
    tanh's formulas, which the kernels do not run."""

    def __init__(self):
        from picard_ica_tpu_torch.ops.densities import Tanh

        self._d = Tanh()

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


# Phase 3's plugin fit: a 64 x 100,000 mixed mixture (a 64-channel
# recording of 100 s at 1 kHz).
N3P, T3P, SEED3P = 64, 100_000, 3


def phase3_plugin():
    """A default fit with a density plugin on the card runs the torch path
    (the kernels implement Tanh, Exp and Cube only): no core kernel
    launches, and the unmixing is the CPU torch path's."""
    import numpy as np

    from picard_ica_tpu_torch import Picard
    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import generate_mixed_kurtosis_data
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    _, a, x = generate_mixed_kurtosis_data(N3P, T3P, SEED3P)
    K.reset_launch_counts()
    r, wall = _synced_seconds(lambda: Picard.fit(x, _config(density=PluginTanh())))
    launches = _launches()
    t0 = time.perf_counter()
    r_cpu = Picard.fit(x, _config(density=PluginTanh(), use_kernels=False), device="cpu")
    wall_cpu = time.perf_counter() - t0
    w = r.full_unmixing().double().cpu().numpy()
    agree = amari_distance(w, np.linalg.inv(r_cpu.full_unmixing().double().numpy()))
    core = sum(launches[k] for k in _CORE_KERNELS + _STREAM_KERNELS)
    _log(f"plugin density {N3P} x {T3P} (card, auto): converged={r.converged} "
         f"n_iterations={r.n_iterations} fit {wall:.3f} s; CPU torch path: "
         f"converged={r_cpu.converged} n_iterations={r_cpu.n_iterations} fit {wall_cpu:.3f} s; "
         f"amari(W_card, inv(W_cpu)) = {agree:.3e}, to the mixing "
         f"{amari_distance(w, a):.3e}; core kernel launches {core}")
    if core:
        raise AssertionError(f"a density plugin ran the core kernels: {launches}")
    if not (r.converged and r_cpu.converged and agree < 1e-3):
        raise AssertionError("the plugin fit on the card is not the CPU torch path's")


def phase3_slice():
    import numpy as np
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import generate_mixed_kurtosis_data
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    phase3_plugin()
    _, a, x = generate_mixed_kurtosis_data(N, T, SEED)

    K.reset_launch_counts()
    r, wall = _fit(x, None)
    launches = _launches()
    w_k = r.full_unmixing().double().cpu().numpy()
    amari = amari_distance(w_k, a)
    _log(f"slice (kernels): converged={r.converged} n_iterations={r.n_iterations} "
         f"stage_exits={r.stage_exits} ls_calls={r.ls_calls} "
         f"gradient_norm={r.gradient_norm:.3e} amari={amari:.3e}")
    _log(f"slice (kernels): fit {wall:.3f} s, core {r.core_seconds:.4f} s, "
         f"{T * r.n_iterations / r.core_seconds:.4e} samples*iter/s (core)")
    _log(f"launches: {launches}")
    if not r.converged:
        raise AssertionError("the kernel fit did not converge at tol 1e-7")
    if not amari < 5e-3:
        raise AssertionError(f"amari {amari} >= 5e-3")
    if r.sources.device.type != "cuda" or r.unmixing.device.type != "cuda":
        raise AssertionError("the result does not lie on the card")
    if tuple(r.sources.shape) != (N, T) or not bool(torch.isfinite(r.sources).all()):
        raise AssertionError("sources are not finite (N, T)")
    # Host-f64 whitening: this path runs the three core kernels, the fused
    # pass in every tier.
    missing = [k for k in _CORE_KERNELS + tuple(TIER_ROWS) if _count(k, launches) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    del r

    r_t, wall_t = _fit(x, False)
    w_t = r_t.full_unmixing().double().cpu().numpy()
    agree = amari_distance(w_k, np.linalg.inv(w_t))
    _log(f"slice (torch path): converged={r_t.converged} n_iterations={r_t.n_iterations} "
         f"stage_exits={r_t.stage_exits} ls_calls={r_t.ls_calls} "
         f"fit {wall_t:.3f} s, core {r_t.core_seconds:.4f} s, "
         f"{T * r_t.n_iterations / r_t.core_seconds:.4e} samples*iter/s (core)")
    _log(f"amari(W_kernels, inv(W_torch)) = {agree:.3e}")
    if not r_t.converged:
        raise AssertionError("the torch-path fit did not converge at tol 1e-7")
    if not agree < 1e-3:
        raise AssertionError(f"kernel and torch fits disagree: amari {agree}")
    return launches


def _launches():
    """Every kernel's launches, the fused pass's by tier and the
    streaming fused kernel's by tier and by mode and tier."""
    from picard_ica_tpu_torch.ops import kernels as K

    counts = {k.__name__: k.launches for k in K.KERNELS}
    counts["by_tier"] = dict(K.rotated_fused_sums.launches_by_tier)
    counts["by_route"] = {route: dict(tiers) for route, tiers in
                          K.rotated_fused_sums.launches_by_route.items()}
    counts["stream_by_tier"] = dict(K.streaming_fused_sums.launches_by_tier)
    counts["stream_by_mode"] = {mode: dict(tiers) for mode, tiers in
                                K.streaming_fused_sums.launches_by_mode.items()}
    counts["loglik_by_tier"] = dict(K.streaming_loglik_sums.launches_by_tier)
    counts["contract_by_tier"] = dict(K.streaming_fused_sums.contract_launches_by_tier)
    for row in (*_TC_PAIR, *_LL_TIER, CONTRACT_ROW):
        counts[row] = _count(row, counts)
    return counts


def _checksum(x):
    """Exact sum of the tensor's bit patterns."""
    import torch

    return int(torch.sum(x.view(torch.int32), dtype=torch.int64))


def _whiteness(x, x1, k):
    """(max |X1 X1^T / T - I|, max |K (C64 / T) K^T - I|), in f64 on the
    card; C64 is the f64 centered covariance of the f32 input."""
    import torch

    t = x.shape[1]
    x1d = x1.double()
    eye = torch.eye(x1.shape[0], dtype=torch.float64, device=x1.device)
    self_white = float((x1d @ x1d.T / t - eye).abs().max())
    del x1d
    xd = x.double()
    xd -= xd.mean(dim=1, keepdim=True)
    c64 = xd @ xd.T / t
    del xd
    kd = k.double()
    resid = float((kd @ c64 @ kd.T - eye).abs().max())
    return self_white, resid


def _whiten_checked(x, label):
    """center_whiten of ``x`` with its whiteness checked; returns the
    launch counts and the seconds it took."""
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.ops.whitening import center_whiten

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x1, mean, k = center_whiten(x, x.shape[0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    self_white, resid = _whiteness(x, x1, k)
    del x1, mean
    _log(f"{label}: center_whiten {seconds:.4f} s, self-whiteness {self_white:.3e} "
         f"(< {SELF_WHITE_MAX}), K residual {resid:.3e} (< {K_RESIDUAL_MAX}), "
         f"launches {launches}")
    if not (self_white < SELF_WHITE_MAX and resid < K_RESIDUAL_MAX):
        raise AssertionError(f"{label}: device whitening is not white enough")
    return launches, seconds


def phase4_device_slice():
    """bench.py's configuration through device whitening and the fit."""
    from picard_ica_tpu_torch.utils.datagen import (
        generate_bench_data_device,
        reference_mixing_matrix,
    )
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    x = generate_bench_data_device(N4, T4, SEED4, "cuda")
    a = reference_mixing_matrix(N4, T4, SEED4)
    before = _checksum(x)
    _, whiten_s = _whiten_checked(x, f"device slice {N4} x {T4}")

    from picard_ica_tpu_torch.ops import kernels as K

    launches = None
    for precision in ("auto", "f32"):
        # The default staged schedule, then the exact f32 tier alone.
        K.reset_launch_counts()
        r, wall = _fit(x, None, kernel_precision=precision)
        counts = _launches()
        amari = amari_distance(r.full_unmixing().double().cpu().numpy(), a)
        label = f"device slice ({precision})"
        _report_fit(label, r, wall, T4)
        _log(f"{label}: whitening {whiten_s:.4f} s, amari={amari:.3e}, launches: {counts}")
        if not r.converged:
            raise AssertionError(f"{label} did not converge at tol 1e-7")
        if not amari < 5e-3:
            raise AssertionError(f"amari {amari} >= 5e-3")
        if tuple(r.sources.shape) != (N4, T4) or not bool(r.sources.isfinite().all()):
            raise AssertionError("sources are not finite (N, T)")
        # Every try of the fit is delta mode on f32 X (bf16 X in the bf16
        # stage) without H: its f32 and bf16x3 tries all on the wgmma route.
        tries = {t: counts["by_tier"][t] for t in ("bf16x3", "f32")}
        if (counts["by_route"]["wgmma"]["bf16x3"] != tries["bf16x3"]
                or counts["by_route"]["wgmma"]["f32"] != tries["f32"] or not tries["f32"]):
            raise AssertionError(f"{label}: a delta f32 or bf16x3 try left the wgmma route: "
                                 f"{counts['by_route']}")
        if launches is None:
            launches = counts
            staged = r
    # The loglik kernel re-baselines the loss at extended sign changes;
    # the bench sources are all Laplace, so no sign flips and the kernel
    # is not on this path (phase 3's mixed-kurtosis fit runs it).
    missing = [k for k in _PHASE4_KERNELS + tuple(TIER_ROWS) if _count(k, launches) == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the device-whitened fit: {missing}")
    _log(f"staged against exact f32: core {staged.core_seconds:.4f} s for "
         f"{staged.n_iterations} iterations (exits {staged.stage_exits}) against "
         f"{r.core_seconds:.4f} s for {r.n_iterations}")
    if _checksum(x) != before:
        raise AssertionError("the fit wrote the caller's tensor")
    return launches


def phase4b_grouped():
    """center_whiten at N = 600: the grouped covariance on the card."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.ops.linalg import rotate_rows_inplace
    from picard_ica_tpu_torch.utils.datagen import laplace_sources_device

    # Standard-normal mixing (seed 0), the JAX package's 600 x 1M exhibit
    # (benchmarks/whiten_accuracy_tpu.py).
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal((N4B, N4B)))
    x = rotate_rows_inplace(mix.float().cuda(), laplace_sources_device(N4B, T4B, 1, "cuda"))
    launches, _ = _whiten_checked(x, f"grouped {N4B} x {T4B}")
    if launches["_grouped_covariance"] == 0:
        raise AssertionError("_grouped_covariance never launched at N = 600")
    return launches


_STREAM_KERNELS = ("streaming_fused_sums", "streaming_loglik_sums")
_WHITENING_KERNELS = ("row_sums", "centered_covariance_sums", "covariance_sums")


def _report_fit(label, r, wall, t):
    _log(f"{label}: converged={r.converged} n_iterations={r.n_iterations} "
         f"stage_exits={r.stage_exits} ls_calls={r.ls_calls} "
         f"gradient_norm={r.gradient_norm:.3e}")
    _log(f"{label}: fit {wall:.3f} s, core {r.core_seconds:.4f} s, "
         f"{t * r.n_iterations / r.core_seconds:.4e} samples*iter/s (core)")


def phase5_large_n():
    """BASELINE config 5's width on one card through the streaming
    kernels: 256 x 2,000,000, extended + ortho, tol 1e-7.

    Both fits run the exact f32 tier; phase 5c fits the same tensor at the
    default staged schedule, under which this seed's kernel fit converges
    too. Returns the launch counts and what phase 5c compares with: the
    tensor, the mixing, the torch path's unmixing and the kernel fit's
    core seconds."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import generate_mixed_kurtosis_data
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    torch.cuda.empty_cache()  # phase 2's f64 check buffers are gone
    # Sub- and super-Gaussian sources, so extended sign flips run the
    # loglik kernel (the all-Laplace bench mixture never flips a sign).
    _, a, x_np = generate_mixed_kurtosis_data(N5, T5, SEED)
    x = torch.from_numpy(x_np.astype(np.float32)).cuda()
    del x_np
    before = _checksum(x)
    _, whiten_s = _whiten_checked(x, f"large-N slice {N5} x {T5}")

    K.reset_launch_counts()
    r, wall = _fit(x, True, kernel_precision="f32")
    launches = _launches()
    w_k = r.full_unmixing().double().cpu().numpy()
    amari = amari_distance(w_k, a)
    _report_fit("large-N slice (kernels)", r, wall, T5)
    _log(f"large-N slice: whitening {whiten_s:.4f} s, amari {amari:.3e}, "
         f"launches {launches}")
    if not r.converged:
        raise AssertionError("the streaming-kernel fit did not converge at tol 1e-7")
    if not amari < 5e-3:
        raise AssertionError(f"amari {amari} >= 5e-3")
    if tuple(r.sources.shape) != (N5, T5) or not bool(r.sources.isfinite().all()):
        raise AssertionError("sources are not finite (N, T)")
    missing = [k for k in _STREAM_KERNELS + _WHITENING_KERNELS
               + (TC_F32_ROW, TC_PF32_ROW, LL_F32_ROW) if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the large-N fit: {missing}")
    _counted_on_route("large-N slice", launches)
    resident = {k: launches[k] for k in _CORE_KERNELS if launches[k]}
    if resident:
        raise AssertionError(f"resident core kernels ran at N = {N5}: {resident}")
    f32_core = r.core_seconds
    del r
    torch.cuda.empty_cache()

    r_t, wall_t = _fit(x, False, kernel_precision="f32")
    w_t = r_t.full_unmixing().double().cpu().numpy()
    agree = amari_distance(w_k, np.linalg.inv(w_t))
    _report_fit("large-N slice (torch path)", r_t, wall_t, T5)
    _log(f"amari(W_kernels, inv(W_torch)) = {agree:.3e}")
    if not r_t.converged:
        raise AssertionError("the torch-path fit did not converge at tol 1e-7")
    if not agree < 1e-3:
        raise AssertionError(f"kernel and torch fits disagree: amari {agree}")
    if _checksum(x) != before:
        raise AssertionError("the fit wrote the caller's tensor")
    return launches, (x, a, w_t, f32_core)


def phase5c_staged(x, a, w_torch, f32_core):
    """Phase 5's tensor at the default staged schedule through the
    streaming kernels: its bf16 stage's plain passes on bf16 X and its
    bf16x3 and f32 stages' delta passes on f32 X all run the tensor-core
    route."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    torch.cuda.empty_cache()
    K.reset_launch_counts()
    r, wall = _fit(x, True)
    launches = _launches()
    w_k = r.full_unmixing().double().cpu().numpy()
    amari = amari_distance(w_k, a)
    agree = amari_distance(w_k, np.linalg.inv(w_torch))
    label = "large-N slice, staged (kernels)"
    _report_fit(label, r, wall, T5)
    _log(f"{label}: amari {amari:.3e}, amari(W_staged, inv(W_torch)) = {agree:.3e}, "
         f"negative signs {int((r.signs < 0).sum()) if r.signs is not None else None}")
    _log(f"{label}: core {r.core_seconds:.4f} s against the f32-only kernel fit's "
         f"{f32_core:.4f} s; streaming fused launches by mode and tier "
         f"{launches['stream_by_mode']}, loglik by tier {launches['loglik_by_tier']}")
    if not r.converged:
        raise AssertionError("the staged streaming-kernel fit did not converge at tol 1e-7")
    if not amari < 5e-3:
        raise AssertionError(f"amari {amari} >= 5e-3")
    if not agree < 1e-3:
        raise AssertionError(f"staged kernel and torch fits disagree: amari {agree}")
    if tuple(r.sources.shape) != (N5, T5) or not bool(r.sources.isfinite().all()):
        raise AssertionError("sources are not finite (N, T)")
    # Its bf16 stage re-baselines the loss on bf16 X; on f32 X only where
    # a sign flips in a later stage (phase 5 runs that row's path).
    missing = [row for row in (TC_ROW, TC3_ROW, TC_F32_ROW, TC_PF32_ROW, LL_BF16_ROW)
               if launches[row] == 0]
    if missing:
        raise AssertionError(f"the tensor-core route never launched in the staged fit: {missing}")
    _counted_on_route(label, launches)
    return launches


def _counted_on_route(label, launches):
    """Every streaming pass of a fit is counted by the tensor-core route's
    modes and tiers, and every loglik launch by its tiers."""
    by_mode = sum(sum(tiers.values()) for tiers in launches["stream_by_mode"].values())
    if by_mode != launches["streaming_fused_sums"]:
        raise AssertionError(f"{label}: fused launches off the tensor-core route")
    if sum(launches["loglik_by_tier"].values()) != launches["streaming_loglik_sums"]:
        raise AssertionError(f"{label}: loglik launches off the tensor cores")
    # Launch B runs once a chunk of every fused launch, at its tier.
    for tier, calls in launches["stream_by_tier"].items():
        b = launches["contract_by_tier"][tier]
        if b < calls or (b > 0) != (calls > 0):
            raise AssertionError(f"{label}: {calls} fused launches at {tier}, {b} of launch B")


def phase5d_pinned_bf16(x, a, w_torch):
    """Phase 5's tensor with the tier pinned to bf16: its tries, delta
    bf16 on f32 X, run the tensor-core route (its moments and loss
    baselines too). 3 iterations, each try counted as a delta bf16
    launch; then a run to tol 1e-4 or 30 iterations, whichever comes
    first. Amari to the mixing and to phase 5's torch-path fit are
    reported, not gated: the bf16 tier alone is not held to tol 1e-7."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    launches = None
    for caps in ({"max_iter": 3}, {"max_iter": 30, "tol": 1e-4}):
        torch.cuda.empty_cache()
        K.reset_launch_counts()
        r, wall = _fit(x, True, kernel_precision="bf16", **caps)
        counts = _launches()
        label = f"large-N slice, pinned bf16, {caps} (kernels)"
        _report_fit(label, r, wall, T5)
        w = r.full_unmixing().double().cpu().numpy()
        finite = bool(np.isfinite(w).all()) and tuple(r.unmixing.shape) == (N5, N5)
        _log(f"{label}: amari {amari_distance(w, a) if finite else float('nan'):.3e}, "
             f"amari(W_pinned, inv(W_torch)) = "
             f"{amari_distance(w, np.linalg.inv(w_torch)) if finite else float('nan'):.3e}, "
             f"streaming fused launches by mode and tier {counts['stream_by_mode']}")
        if not finite:
            raise AssertionError(f"{label}: the unmixing is not a finite ({N5}, {N5}) matrix")
        _counted_on_route(label, counts)
        tries = counts["stream_by_mode"]["delta"]["bf16"]
        if tries != r.ls_calls or tries == 0:
            raise AssertionError(f"{label}: {tries} delta bf16 launches for {r.ls_calls} tries")
        launches = launches or counts
    return launches


def phase5b_exhibit():
    """The JAX package's large-N exhibit: 1024 x 200,000, 10 iterations
    at tol 1e-4 on both paths (the suite's caps)."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import generate_bench_data_device
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    x = generate_bench_data_device(N5B, T5B, SEED5B, "cuda")
    caps = {"tol": 1e-4, "max_iter": 10}
    K.reset_launch_counts()
    r, wall = _fit(x, True, **caps)
    launches = _launches()
    _report_fit(f"exhibit {N5B} x {T5B} (kernels)", r, wall, T5B)
    _log(f"launches: {launches}")
    r_t, wall_t = _fit(x, False, **caps)
    _report_fit(f"exhibit {N5B} x {T5B} (torch path)", r_t, wall_t, T5B)
    w_k = r.full_unmixing().double().cpu().numpy()
    w_t = r_t.full_unmixing().double().cpu().numpy()
    finite = all(bool(torch.isfinite(v).all()) for v in
                 (r.unmixing, r.sources, r_t.unmixing, r_t.sources))
    agree = amari_distance(w_k, np.linalg.inv(w_t)) if finite else float("nan")
    _log(f"exhibit: amari(W_kernels, inv(W_torch)) = {agree:.3e}")
    if not finite:
        raise AssertionError("the 1024-component fits are not finite")
    if r.n_iterations != r_t.n_iterations:
        raise AssertionError(f"iterations differ: {r.n_iterations} vs {r_t.n_iterations}")
    missing = [k for k in ("streaming_fused_sums", TC_ROW, "_grouped_covariance")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched at N = {N5B}: {missing}")
    _log(f"exhibit: kernel core {r.core_seconds:.4f} s against the torch path's "
         f"{r_t.core_seconds:.4f} s; streaming fused launches by mode and tier "
         f"{launches['stream_by_mode']}")
    return launches


def _amari_inv(w, w_other):
    import numpy as np

    from picard_ica_tpu_torch.utils.metrics import amari_distance

    return amari_distance(w, np.linalg.inv(w_other))


def _synced_seconds(fn, device="cuda"):
    """(fn's result, host seconds between two synchronisations of
    ``device``)."""
    import torch

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _fit_default(x, mesh=None, device=None):
    """``Picard.fit`` of ``x`` at the default config (tol 1e-7)."""
    from picard_ica_tpu_torch import Picard

    return Picard.fit(x, _config(), device=device, mesh=mesh)


def phase6_jade_warm():
    """BASELINE config 4 at full size (benchmarks/suite.py:519-552): JADE(50)
    warm start -> Picard on 128 x 1,000,000 float64 NumPy (host-f64
    whitening, an f32 core through the streaming kernels), then the same
    on the torch path. The seconds of whitening, the JADE Gram and its
    sweeps come from the port's own functions on the same whitened data.
    Returns the kernel fit's launch counts and what phases 6b and 6c
    compare with."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.models.jade import _jacobi_sweeps, compute_cumulant_matrices
    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.ops.whitening import preprocess_f64
    from picard_ica_tpu_torch.utils.datagen import generate_mixed_kurtosis_data
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    torch.cuda.empty_cache()
    _, a, x = generate_mixed_kurtosis_data(N6, T6, SEED6)
    label = f"config 4, JADE({JADE_IT6}) -> {N6} x {T6}"

    K.reset_launch_counts()
    r, wall = _fit(x, None, **CONFIG6)
    launches = _launches()
    _report_fit(f"{label} (kernels)", r, wall, T6)
    w_k = r.full_unmixing().double().cpu().numpy()
    finite = bool(np.isfinite(w_k).all()) and bool(torch.isfinite(r.sources).all())
    amari = amari_distance(w_k, a) if finite else float("nan")
    _log(f"{label} (kernels): amari {amari:.3e}, streaming fused launches by mode and "
         f"tier {launches['stream_by_mode']}, loglik by tier {launches['loglik_by_tier']}")

    (x1_64, _, _), whiten_s = _synced_seconds(lambda: preprocess_f64(x, N6, True, True))
    x1 = torch.from_numpy(x1_64.astype(np.float32)).cuda()
    del x1_64
    cum, gram_s = _synced_seconds(lambda: compute_cumulant_matrices(x1))
    (_, sweeps), sweeps_s = _synced_seconds(
        lambda: _jacobi_sweeps(cum, N6, JADE_IT6, 1e-6, False))
    del cum, x1
    torch.cuda.empty_cache()
    _log(f"{label}: whitening (host f64) {whiten_s:.4f} s, JADE Gram and cumulants "
         f"{gram_s:.4f} s, {sweeps} sweeps {sweeps_s:.4f} s "
         f"({sweeps_s / max(sweeps, 1):.4f} s a sweep), core {r.core_seconds:.4f} s, "
         f"fit {wall:.3f} s")

    if not finite or tuple(r.sources.shape) != (N6, T6):
        raise AssertionError(f"{label}: the result is not finite ({N6}, {T6})")
    if not r.converged:
        raise AssertionError(f"{label}: the kernel fit did not converge at tol 1e-7")
    if not amari < 5e-3:
        raise AssertionError(f"{label}: amari {amari} >= 5e-3")
    if launches["streaming_fused_sums"] == 0:
        raise AssertionError(f"{label}: kernel 8 never launched")
    # A negative sign at the end was negative at iteration 0 or flipped
    # later; either re-baselines the loss through kernel 9.
    if bool((r.signs < 0).any()) and launches["streaming_loglik_sums"] == 0:
        raise AssertionError(f"{label}: signs flipped but kernel 9 never launched")
    _counted_on_route(label, launches)
    result = r
    del r

    r_t, wall_t = _fit(x, False, **CONFIG6)
    _report_fit(f"{label} (torch path)", r_t, wall_t, T6)
    w_t = r_t.full_unmixing().double().cpu().numpy()
    agree = _amari_inv(w_k, w_t)
    _log(f"{label}: amari(W_kernels, inv(W_torch)) = {agree:.3e}, torch path "
         f"amari {amari_distance(w_t, a):.3e}")
    if not r_t.converged:
        raise AssertionError(f"{label}: the torch-path fit did not converge at tol 1e-7")
    if not agree < 1e-3:
        raise AssertionError(f"{label}: kernel and torch fits disagree: amari {agree}")
    del r_t
    torch.cuda.empty_cache()
    return launches, (x, a, result)


def phase6b_fastica(x, a, jade_fit):
    """The same NumPy input with a FastICA(10) warm start at phase 6's
    settings, on the kernel path (auto)."""
    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    label = f"config 4 data, FastICA(10) -> {N6} x {T6}"
    cfg = {**CONFIG6, "jade_it": None, "fastica_it": 10}
    K.reset_launch_counts()
    r, wall = _fit(x, None, **cfg)
    launches = _launches()
    _report_fit(f"{label} (kernels)", r, wall, T6)
    w = r.full_unmixing().double().cpu().numpy()
    amari = amari_distance(w, a)
    agree = _amari_inv(w, jade_fit.full_unmixing().double().cpu().numpy())
    _log(f"{label}: amari {amari:.3e}, amari(W_fastica, inv(W_jade)) = {agree:.3e}, "
         f"streaming fused launches by mode and tier {launches['stream_by_mode']}")
    if not r.converged:
        raise AssertionError(f"{label}: did not converge at tol 1e-7")
    if not amari < 5e-3:
        raise AssertionError(f"{label}: amari {amari} >= 5e-3")
    if not agree < 1e-3:
        raise AssertionError(f"{label}: the FastICA and JADE fits disagree: amari {agree}")
    if launches["streaming_fused_sums"] == 0:
        raise AssertionError(f"{label}: kernel 8 never launched")
    _counted_on_route(label, launches)
    return launches


def phase6c_checkpoints(x, a, fit):
    """Phase 6's result through save_result / load_result on the card,
    transform from the loaded file, and a fit resumed from it."""
    import os
    import tempfile

    import numpy as np
    import torch

    from picard_ica_tpu_torch import Picard, load_result, resume_config, save_result

    label = "config 4 checkpoints"
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for sources in (True, False):
            paths[sources] = os.path.join(tmp, f"fit_{sources}.npz")
            _, save_s = _synced_seconds(
                lambda: save_result(paths[sources], fit, include_sources=sources))
            _log(f"{label}: save_result(include_sources={sources}) {save_s:.3f} s, "
                 f"{os.path.getsize(paths[sources])} bytes")
        loaded = {sources: load_result(path) for sources, path in paths.items()}
    for sources, res in loaded.items():
        for name in ("unmixing", "whitening", "mean", "signs") + (("sources",) if sources else ()):
            got = getattr(res, name)
            if got.device.type != "cuda" or not torch.equal(got, getattr(fit, name)):
                raise AssertionError(f"{label}: {name} (sources={sources}) is not bit-equal "
                                     "on the card")
        if not sources and res.sources is not None:
            raise AssertionError(f"{label}: a file without sources loaded sources")
    # transform from the file: f32 rounding of the raw input, amplified by
    # the mixing's condition, against the fit's path through host-f64
    # whitening.
    rtol = 3.0 * float(np.linalg.cond(a)) * float(np.finfo(np.float32).eps)
    y, transform_s = _synced_seconds(lambda: Picard.transform(x, loaded[False]))
    scale = float(fit.sources.abs().max())
    err = float((y - fit.sources).abs().max())
    del y
    _log(f"{label}: transform {transform_s:.4f} s, max |Y - sources| {err:.3e} "
         f"(<= {rtol:.3e} x {scale:.3f})")
    if not err <= rtol * scale:
        raise AssertionError(f"{label}: transform from the file misses the sources: {err}")

    cfg = resume_config(loaded[False], _config(**CONFIG6))
    if not isinstance(cfg.w_init, np.ndarray) or cfg.jade_it is not None:
        raise AssertionError(f"{label}: resume_config kept JADE or a device w_init")
    r, wall = _synced_seconds(lambda: Picard.fit(x, cfg))
    _report_fit(f"{label}, resumed", r, wall, T6)
    _log(f"{label}: resumed fit {r.n_iterations} iterations against phase 6's "
         f"{fit.n_iterations}")
    if not r.converged:
        raise AssertionError(f"{label}: the resumed fit did not converge at tol 1e-7")


def _phase7_rank(rank, ranks, store, out_dir, n, t, seed, device):
    """One rank of phase 7: joins the gloo world through the file store,
    makes the bench data on the card, keeps its block, whitens it once
    to time the sharded whitening, then fits it on the mesh. Writes its
    unmixing and its numbers to ``out_dir``; any failure raises, and the
    process exits non-zero."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.ops.whitening import center_whiten
    from picard_ica_tpu_torch.parallel import distributed_init, sample_mesh, shard_samples
    from picard_ica_tpu_torch.parallel import sharding
    from picard_ica_tpu_torch.utils.datagen import generate_bench_data_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The ranks share the host's cores: idle threads of one spin while
    # the other computes.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    distributed_init(backend="gloo", init_method=f"file://{store}", rank=rank,
                     world_size=ranks, timeout=datetime.timedelta(seconds=PHASE7_TIMEOUT))
    mesh = sample_mesh(torch.device(device).type)
    backend = dist.get_backend(mesh.get_group())
    if backend != "gloo":
        raise AssertionError(f"rank {rank}: the mesh runs {backend}, not gloo")
    x = generate_bench_data_device(n, t, seed, device)
    xs = shard_samples(x, mesh)
    del x
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    shards = sharding.SampleShards.of(mesh, t)
    _, whiten_s = _synced_seconds(
        lambda: center_whiten(xs.to_local(), n, data_sharding=shards), device)
    K.reset_launch_counts()
    sharding.reset_collective_counts()
    r, wall = _synced_seconds(lambda: _fit_default(xs, mesh), device)
    local = r.sources.to_local()
    info = {
        "rank": rank, "backend": backend, "converged": bool(r.converged),
        "n_iterations": r.n_iterations, "stage_exits": list(r.stage_exits),
        "ls_calls": r.ls_calls, "gradient_norm": r.gradient_norm,
        "whiten_s": whiten_s, "core_s": r.core_seconds, "fit_s": wall,
        "all_reduces": sharding.counts.calls, "all_reduce_bytes": sharding.counts.bytes,
        "all_reduce_s": sharding.counts.seconds,
        "sources_local": list(local.shape),
        "sources_finite": bool(torch.isfinite(local).all()),
        "launches": _launches(),
    }
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             w=r.unmixing.cpu().numpy(), full=r.full_unmixing().double().cpu().numpy())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


def phase7_sharded(n=N7, t=T7, seed=SEED7, ranks=RANKS7, device="cuda"):
    """BASELINE config 5 (256 x 10M, sample-sharded) on ``ranks`` gloo
    ranks that share the one card, against the unsharded fit of the same
    data in this process. Returns rank 0's launch counts."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import (
        generate_bench_data_device,
        reference_mixing_matrix,
    )
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    label = f"sharded {n} x {t} on {ranks} gloo ranks"
    a = reference_mixing_matrix(n, t, seed)
    x = generate_bench_data_device(n, t, seed, device)
    K.reset_launch_counts()
    r, wall = _synced_seconds(lambda: _fit_default(x, device=device), device)
    single = {"full": r.full_unmixing().double().cpu().numpy(), "it": r.n_iterations,
              "core": r.core_seconds, "converged": r.converged}
    _report_fit(f"{label}, unsharded", r, wall, t)
    del r, x
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the ranks' 80 GB hold no buffer of this process

    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_phase7_rank,
                             args=(rank, ranks, store, tmp, n, t, seed, device))
                 for rank in range(ranks)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + PHASE7_TIMEOUT
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
        if hung:
            raise AssertionError(f"{label}: {len(hung)} rank(s) timed out")
        failed = [rank for rank, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise AssertionError(f"{label}: rank(s) {failed} exited non-zero")
        infos, ws = [], []
        for rank in range(ranks):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                infos.append(json.load(f))
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
                ws.append((z["w"], z["full"]))
    for info in infos:
        _log(f"{label}, rank {info['rank']} ({info['backend']}): converged="
             f"{info['converged']} n_iterations={info['n_iterations']} stage_exits="
             f"{tuple(info['stage_exits'])} ls_calls={info['ls_calls']} gradient_norm="
             f"{info['gradient_norm']:.3e}; whitening {info['whiten_s']:.4f} s, core "
             f"{info['core_s']:.4f} s, fit {info['fit_s']:.3f} s; {info['all_reduces']} "
             f"all-reduces, {info['all_reduce_bytes']} bytes, {info['all_reduce_s']:.4f} s "
             f"in them; {t * info['n_iterations'] / info['core_s']:.4e} samples*iter/s "
             f"(core) against the unsharded fit's "
             f"{t * single['it'] / single['core']:.4e} ({single['it']} iterations, core "
             f"{single['core']:.4f} s)")
    amari = amari_distance(ws[0][1], a)
    agree = amari_distance(ws[0][1], np.linalg.inv(single["full"]))
    _log(f"{label}: amari to the mixing {amari:.3e} (< 5e-3), amari(W_sharded, "
         f"inv(W_unsharded)) = {agree:.3e} (< 1e-3); rank 0 launches {infos[0]['launches']}")
    if any(not np.array_equal(w, ws[0][0]) for w, _ in ws[1:]):
        raise AssertionError(f"{label}: W differs between the ranks")
    if not single["converged"] or not all(i["converged"] for i in infos):
        raise AssertionError(f"{label}: a fit did not converge at tol 1e-7")
    if any(i["sources_local"] != [n, t // ranks] or not i["sources_finite"] for i in infos):
        raise AssertionError(f"{label}: a rank's sources are not finite ({n}, {t // ranks})")
    if not agree < 1e-3:
        raise AssertionError(f"{label}: sharded and unsharded fits disagree: amari {agree}")
    if not amari < 5e-3:
        raise AssertionError(f"{label}: amari {amari} >= 5e-3")
    launches = infos[0]["launches"]
    missing = [k for k in ("streaming_fused_sums",) + _WHITENING_KERNELS if launches[k] == 0]
    if torch.device(device).type == "cuda" and missing:
        raise AssertionError(f"{label}: kernels never launched on rank 0: {missing}")
    return launches


def phase7b_nccl(n=N7B, t=T7B, seed=SEED7B):
    """bench.py's configuration through a one-rank NCCL mesh: a one-rank
    all-reduce is the identity, so the fit must equal the unsharded fit
    of the same tensor bit for bit (W, sources, iterations). Returns the
    sharded fit's launch counts."""
    import tempfile

    import torch
    import torch.distributed as dist

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.parallel import distributed_init, sample_mesh, sharding
    from picard_ica_tpu_torch.utils.datagen import generate_bench_data_device

    label = f"one NCCL rank, {n} x {t}"
    x = generate_bench_data_device(n, t, seed, "cuda")
    r1, _ = _synced_seconds(lambda: _fit_default(x))
    with tempfile.TemporaryDirectory() as tmp:
        distributed_init(backend="nccl", init_method=f"file://{tmp}/store", rank=0,
                         world_size=1)
        try:
            mesh = sample_mesh("cuda")
            backend = dist.get_backend(mesh.get_group())
            K.reset_launch_counts()
            sharding.reset_collective_counts()
            rm, wall = _synced_seconds(lambda: _fit_default(x, mesh=mesh))
            launches = _launches()
            counts = sharding.counts
        finally:
            dist.destroy_process_group()
    _report_fit(f"{label} ({backend})", rm, wall, t)
    same = (torch.equal(rm.unmixing, r1.unmixing)
            and torch.equal(rm.sources.to_local(), r1.sources)
            and rm.n_iterations == r1.n_iterations)
    _log(f"{label}: bitwise equal to the unsharded fit {same} ({rm.n_iterations} and "
         f"{r1.n_iterations} iterations); {counts.calls} all-reduces, {counts.bytes} "
         f"bytes, {counts.seconds:.4f} s in them; launches {launches}")
    if backend != "nccl":
        raise AssertionError(f"{label}: the mesh runs {backend}")
    if not rm.converged:
        raise AssertionError(f"{label}: did not converge at tol 1e-7")
    if not same:
        raise AssertionError(f"{label}: the one-rank mesh fit differs from the unsharded fit")
    missing = [k for k in _PHASE4_KERNELS + tuple(TIER_ROWS) if _count(k, launches) == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    return launches



# Phase 8: the bench fit profiled, the memory model's phase peaks, and the
# max-T boundary at N = 256. A rung's child exits with this code when, and
# only when, the pipeline raised torch.cuda.OutOfMemoryError.
OOM_EXIT = 75
MAXT_N, MAXT_STEP, MAXT_ITER = 256, 1_000_000, 3
# The rungs' bench-mixture seed. The mixing matrix depends on (N, T, seed):
# seed 42's at 256 x 30M has cond(A) = 1.8e5, a covariance of cond 3e10
# that no f32 whitening resolves (SingularMatrixError, as the bench
# mixture at 1024 x 1M for seeds 42 and 43); seed 43's is below 1.1e3
# from 28M to 33M. The child prints the rung's cond(A).
SEED8C = 43
MAXT_TIMEOUT = 300
# A phase's measured peak may be off the model by this share of the model.
PEAK_RTOL = 0.001
# The fits whose phase peaks are held to the model: (n, t, config).
PEAK_FITS = ((N4, T4, {}), (N7, T7, {}), (N4, T4, {"use_kernels": False}),
             (128, 1_000_000, {"use_kernels": False}))
# The fused pass's contraction tier in the tensor-core kernel's template
# arguments (csrc/density.cuh Tier) and its modes (rotated_fused_tc.cu Mode).
_CT_TIER = {0: "f32", 1: "bf16x3", 2: "bf16"}
_MODE_DELTA, _MODE_PLAIN, _MODE_MOMENTS = 0, 1, 2


def _trace_launches(ops):
    """The wrappers' launches as the trace shows them, from the device
    events' demangled names: kernel 1 by contraction tier (the modes
    delta and plain of ``rotated_fused_tc_kernel<MODE, ROT, CT, ...>``,
    and ``rotated_fused_wgmma_kernel<ROT, ...>``, also counted alone),
    kernel 2 (its moments mode), kernel 4 (``row_sums_kernel``) and kernels
    5 and 6 (``cov_diag_kernel<CENTERED, ...>``, launched once a call; the
    grouped covariance, kernel 7, launches it too, and is not on the bench
    fit's path)."""
    import re

    out = {"by_tier": dict.fromkeys(_CT_TIER.values(), 0), "wgmma": 0,
           "rotated_moments_sums": 0, "row_sums": 0, "centered_covariance_sums": 0,
           "covariance_sums": 0}
    for name, count in ops.items():
        fused = re.search(r"rotated_fused_tc_kernel<([^>]*)>", name)
        wgmma = re.search(r"rotated_fused_wgmma_kernel<\s*(\d+)", name)
        if wgmma:  # rotated_fused_wgmma_kernel<ROT, D>: ROT is its tier
            out["by_tier"][_CT_TIER[int(wgmma.group(1))]] += count
            out["wgmma"] += count
        cov = re.search(r"cov_diag_kernel<\s*(true|false)", name)
        if fused:
            mode, _, ct = (int(v) for v in re.findall(r"-?\d+", fused.group(1))[:3])
            if mode in (_MODE_DELTA, _MODE_PLAIN):
                out["by_tier"][_CT_TIER[ct]] += count
            elif mode == _MODE_MOMENTS:
                out["rotated_moments_sums"] += count
        elif "row_sums_kernel" in name:
            out["row_sums"] += count
        elif cov:
            out["centered_covariance_sums" if cov.group(1) == "true" else "covariance_sums"] += count
    return out


def phase8a_profiling():
    """bench.py's fit (64 x 4M, seed 42, default config) under
    ``utils.profiling.profile_fit`` after a warm-up fit: the trace's top
    device ops, its count of each kernel's launches against the wrappers'
    counters for the same fit, the card's busy share of the core, and
    ``fit_with_timing``'s rate."""
    import tempfile

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import generate_bench_data_device
    from picard_ica_tpu_torch.utils.profiling import (
        device_op_counts,
        device_trace_summary,
        fit_with_timing,
        profile_fit,
        span_summary,
    )

    label = f"profiled bench fit {N4} x {T4}"
    x = generate_bench_data_device(N4, T4, SEED4, "cuda")
    _fit_default(x)
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        r, wall = _synced_seconds(lambda: profile_fit(x, _config(), trace_dir=tmp))
        counted = _launches()
        summary = device_trace_summary(tmp, "GPU", top_k=12)
        ops = device_op_counts(tmp)
        spans = span_summary(tmp)
    fit_s = spans["picard.fit"]["wall_us"] / 1e6
    _report_fit(label, r, fit_s, T4)
    _log(f"{label}: profile_fit {wall:.3f} s with the trace's export; device total "
         f"{summary['total_us']:.1f} us in {sum(ops.values())} events; top ops (us, events):")
    for name, us in summary["by_op"].items():
        _log(f"  {us:12.1f}  {ops.get(name, 0):5d}  {name}")
    for name, span in spans.items():
        _log(f"{label}: span {name}: wall {span['wall_us']:.1f} us, device "
             f"{span['device_us']:.1f} us ({span['device_us'] / max(span['wall_us'], 1e-9):.4f} "
             f"busy), {span['launches']} device events")
    core = spans["picard.core"]
    busy = core["device_us"] / core["wall_us"]
    traced = _trace_launches(ops)
    wanted = {"by_tier": {t: counted["by_tier"][t] for t in _CT_TIER.values()},
              "wgmma": sum(counted["by_route"]["wgmma"].values()),
              **{k: counted[k] for k in traced if k not in ("by_tier", "wgmma")}}
    _log(f"{label}: launches in the trace {traced}, by the wrappers' counters {wanted}")
    _log(f"{label}: device busy {core['device_us'] / 1e6:.4f} s of the core's "
         f"{core['wall_us'] / 1e6:.4f} s host span ({busy:.4f}); fit {fit_s:.4f} s, "
         f"device total {summary['total_us'] / 1e6:.4f} s")
    if traced != wanted:
        raise AssertionError(f"{label}: the trace's launches differ from the counters")
    if not all(wanted["by_tier"].values()) or not all(wanted.values()):
        raise AssertionError(f"{label}: a kernel of the path never launched: {wanted}")
    if not r.converged or summary["total_us"] <= 0:
        raise AssertionError(f"{label}: did not converge, or the trace holds no device time")
    timing = fit_with_timing(x, _config(), reps=3)
    _log(f"{label}: fit_with_timing best of 3 {timing['wall_s']:.4f} s, "
         f"{timing['iterations']} iterations, {timing['samples_per_s']:.4e} samples*iter/s "
         f"(whole fit), n_chips {timing['n_chips']}")
    if not timing["converged"] or timing["n_chips"] != 1:
        raise AssertionError(f"{label}: fit_with_timing's fit did not converge")
    return {"trace": traced, "counters": wanted, "busy": busy, "total_us": summary["total_us"],
            "fit_s": fit_s, "rate": timing["samples_per_s"]}


def _phase_peaks(n, t, seed, **config):
    """Peak device bytes of each phase of bench data made on the card and
    fitted by ``Picard.fit``: ``max_memory_allocated`` above what was
    allocated before, reset at each phase's start. The whitening's phases
    are its functions (``_prepare_stats``, ``_project_centered``,
    ``_refine_whitening``), wrapped for the one fit; the core is the
    rest of the fit, from ``center_whiten``'s return."""
    import torch

    from picard_ica_tpu_torch import Picard, solver
    from picard_ica_tpu_torch.ops import whitening
    from picard_ica_tpu_torch.utils.datagen import generate_bench_data_device

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks = {}

    def start():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def stop(phase):
        torch.cuda.synchronize()
        peaks[phase] = torch.cuda.max_memory_allocated() - base

    def measured(fn, phase):
        # None: the core's measure starts where fn returns.
        def run(*args, **kwargs):
            if phase:
                start()
            out = fn(*args, **kwargs)
            if phase:
                stop(phase)
            else:
                start()
            return out
        return run

    patched = [(whitening, "_prepare_stats", "stats"),
               (whitening, "_project_centered", "projection"),
               (whitening, "_refine_whitening", "refine"),
               (solver, "center_whiten", None)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    start()
    x = generate_bench_data_device(n, t, seed, "cuda")
    stop("datagen")
    try:
        for mod, name, phase in patched:
            fn = getattr(mod, name)
            setattr(mod, name, measured(fn, phase))
        r = Picard.fit(x, _config(**config))
        stop("core")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    converged = r.converged
    del r, x
    torch.cuda.empty_cache()
    return peaks, converged


def phase8b_peaks():
    """Each phase's measured peak beside ``memory_model.phase_peak_bytes``:
    fails when the binding phase differs or a phase is off the model by
    more than PEAK_RTOL of it."""
    from picard_ica_tpu_torch.utils import memory_model as mm

    rows = []
    for n, t, config in PEAK_FITS:
        label = f"phase peaks {n} x {t} {config or 'default'}"
        peaks, converged = _phase_peaks(n, t, SEED4, **config)
        model = mm.phase_peak_bytes(n, t, use_kernels=config.get("use_kernels", True))
        for phase in model:
            _log(f"{label}: {phase:10s} measured {peaks[phase]:>14,d} B, model "
                 f"{model[phase]:>14,d} B ({peaks[phase] / model[phase] - 1:+.4f})")
        binding = max(peaks, key=peaks.get)
        _log(f"{label}: binding phase measured {binding}, model {mm.binding_phase(n, t, **config)}; "
             f"fit converged {converged}")
        off = {p: peaks[p] / model[p] - 1 for p in model if abs(peaks[p] / model[p] - 1) > PEAK_RTOL}
        if binding != max(model, key=model.get) or off:
            raise AssertionError(f"{label}: the memory model misses: binding {binding}, off {off}")
        rows.append({"n": n, "t": t, "config": config, "measured": peaks, "model": model})
    return rows


def _maxt_rung(n, t):
    """A max-T rung's child: bench data made on the card at (n, t) (seed
    SEED8C) and ``Picard.fit`` for MAXT_ITER iterations; prints one JSON
    line with the mixing's condition number, and exits OOM_EXIT when the
    pipeline runs out of device memory."""
    import traceback

    import numpy as np
    import torch

    from picard_ica_tpu_torch import Picard
    from picard_ica_tpu_torch.utils.datagen import (
        generate_bench_data_device,
        reference_mixing_matrix,
    )

    total = torch.cuda.mem_get_info()[1]
    cond = float(np.linalg.cond(reference_mixing_matrix(n, t, SEED8C)))
    try:
        x = generate_bench_data_device(n, t, SEED8C, "cuda")
        r = Picard.fit(x, _config(max_iter=MAXT_ITER))
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        frames = [f.name for f in traceback.extract_tb(e.__traceback__)
                  if "picard_ica_tpu_torch" in f.filename]
        print(json.dumps({"t": t, "oom": True, "where": frames[-3:], "total": total,
                          "cond_a": cond, "error": str(e).splitlines()[0]}), flush=True)
        return OOM_EXIT
    print(json.dumps({"t": t, "oom": False, "n_iterations": r.n_iterations, "total": total,
                      "cond_a": cond, "peak": torch.cuda.max_memory_allocated()}), flush=True)
    return 0


def _run_rung(n, t):
    """(exit code, the child's JSON line or None) of one rung in a fresh
    process."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--maxt-rung", str(n),
                           str(t)], capture_output=True, text=True, timeout=MAXT_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode not in (0, OOM_EXIT):
        _log(proc.stdout[-2000:] + proc.stderr[-4000:])
    return proc.returncode, json.loads(lines[-1]) if lines else None


def phase8c_max_t():
    """T = max_t(256) must run the whole pipeline (MAXT_ITER iterations)
    and T = max_t(256) + MAXT_STEP must raise torch.cuda.OutOfMemoryError,
    each in a fresh process; any other exit fails."""
    from picard_ica_tpu_torch.utils import memory_model as mm

    t_fit = mm.max_t(MAXT_N, step=MAXT_STEP)
    rungs = []
    for t, want in ((t_fit, 0), (t_fit + MAXT_STEP, OOM_EXIT)):
        (rc, info), seconds = _synced_seconds(lambda: _run_rung(MAXT_N, t), "cpu")
        _log(f"max-T rung {MAXT_N} x {t}: exit {rc} in {seconds:.1f} s, model peak "
             f"{mm.fit_peak_bytes(MAXT_N, t):,d} B ({mm.binding_phase(MAXT_N, t)}); {info}")
        if rc != want:
            raise AssertionError(f"max-T rung {MAXT_N} x {t}: exit {rc}, wanted {want}")
        rungs.append({"t": t, "rc": rc, "info": info, "seconds": seconds})
    return rungs


_TC_SOURCE = "picard_ica_tpu_torch/csrc/rotated_fused_tc.cu"
_WGMMA_SOURCE = "picard_ica_tpu_torch/csrc/rotated_fused_wgmma.cu"
_STATS_SOURCE = "picard_ica_tpu_torch/csrc/covariance_sums.cu"
_STREAM_TC_SOURCE = "picard_ica_tpu_torch/csrc/streaming_fused_tc.cu"
_PALLAS = "picard_ica_tpu/ops/pallas_kernels.py"
# name -> (source, pallas_call line of the TPU kernel it replaces, the
# phase-2 case (label, or label and shape) whose numbers head the entry)
_KERNELS = {
    WG_ROW: (_WGMMA_SOURCE, 922, "delta f32"),
    "rotated_fused_sums": (_TC_SOURCE, 922, "plain bf16, bf16 X"),
    "rotated_moments_sums": (_TC_SOURCE, 366, "f32"),
    "rotated_loglik_sums": (_TC_SOURCE, 702, "f32"),
    "row_sums": (_STATS_SOURCE, 422, "f32"),
    "centered_covariance_sums": (_STATS_SOURCE, 635, "f32"),
    "covariance_sums": (_STATS_SOURCE, 598, "f32"),
    "_grouped_covariance": (_STATS_SOURCE, 531, "centered"),
    TC_BF16_ROW: (_STREAM_TC_SOURCE, 1149, f"{TC_BF16_LABEL}, {N5} x {T5}"),
    TC_ROW: (_STREAM_TC_SOURCE, 1149, f"{TC_LABEL}, {N5B} x {T5B}"),
    TC3_ROW: (_STREAM_TC_SOURCE, 1149, f"{TC3_LABEL}, {N5} x {T5}"),
    TC_F32_ROW: (_STREAM_TC_SOURCE, 1149, f"{TC_F32_LABEL}, {N5} x {T5}"),
    TC_PF32_ROW: (_STREAM_TC_SOURCE, 1149, f"{TC_PF32_LABEL}, {N5} x {T5}"),
    LL_F32_ROW: (_STREAM_TC_SOURCE, 1247, f"{LL_F32_LABEL}, {N5} x {T5}"),
    LL_BF16_ROW: (_STREAM_TC_SOURCE, 1247, f"{LL_BF16_LABEL}, {N5} x {T5}"),
    CONTRACT_ROW: (_STREAM_TC_SOURCE, 1149, f"{CONTRACT_LABEL} f32, {N5} x {T5}"),
}
# The instructions each row's products run on: kernel 8's launch B runs
# on wgmma in every pair, its launch A in the wgmma pairs (plain bf16 on
# bf16 X, delta bf16x3 and f32 on f32 X) and on mma.sync in the others;
# kernel 9 on wgmma on both X dtypes; the whitening kernels run on the
# FP32 pipes.
_KERNEL_ROUTE = {WG_ROW: "wgmma", TC_ROW: "wgmma", TC3_ROW: "wgmma", TC_F32_ROW: "wgmma",
                 CONTRACT_ROW: "wgmma", LL_F32_ROW: "wgmma", LL_BF16_ROW: "wgmma",
                 **dict.fromkeys((TC_PF32_ROW, TC_BF16_ROW),
                                 "mma.sync (launch A), wgmma (launch B)"),
                 **dict.fromkeys(("row_sums", "centered_covariance_sums", "covariance_sums",
                                  "_grouped_covariance"), "FP32")}
# The fit whose launches each row reports.
_PATH_OF = {**dict.fromkeys(_CORE_KERNELS, "phase3"), **dict.fromkeys(TIER_ROWS, "phase4"),
            "_grouped_covariance": "phase4b", TC_BF16_ROW: "phase5d", TC_ROW: "phase5b",
            TC3_ROW: "phase5c", TC_F32_ROW: "phase5", TC_PF32_ROW: "phase5",
            LL_F32_ROW: "phase5", LL_BF16_ROW: "phase5c", CONTRACT_ROW: "phase5c"}


def phase8():
    """Phase 8: profiling, the phase peaks against the memory model, the
    max-T boundary."""
    return {"profile": phase8a_profiling(), "peaks": phase8b_peaks(), "max_t": phase8c_max_t()}


# Phase 9: the native runtime (``picard_ica_tpu_torch/native``) on the
# card's machine, the draw inside the 1024 x 200,000 fit, and the fits held
# against the port's own f64 oracle.


def _host_cpu():
    """The host CPU as ``/proc/cpuinfo`` names it (a virtual machine may
    hide the model name: then its vendor, family and model numbers),
    its core count and ``OMP_NUM_THREADS``."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id')} family "
            f"{info.get('cpu family')} model {info.get('model')}), {os.cpu_count()} cores, "
            f"OMP_NUM_THREADS={os.environ.get('OMP_NUM_THREADS')}")


def _median_seconds(fn, reps=5):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase9a_native(build_seconds):
    """The host library built with g++ from the checkout (again, into a
    fresh directory, timed): the draw and the u64 stream bit for bit the
    pure-Python sampler, the LCG Laplace stream's states bit for bit and
    its values within ``LCG_RTOL9`` of the NumPy closed form; the native
    draw and the plain one timed."""
    import tempfile

    import numpy as np

    from picard_ica_tpu_torch import native
    from picard_ica_tpu_torch.utils import datagen, reference_rng

    gxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        path, cold_seconds = native.build(tmp)
    if path.name != native.library_path().name:
        raise AssertionError(f"a fresh build is {path.name}, the loaded library "
                             f"{native.library_path().name}")
    _log(f"native: {path.name} built in {cold_seconds:.1f} s into a fresh directory "
         f"({build_seconds:.1f} s in phase 1) by {gxx}; host {_host_cpu()}")
    for seed, n in DRAWS9:
        got = native.reference_normal_matrix(seed, n, n)
        if not np.array_equal(got, reference_rng.normal_matrix_plain(seed, n, n)):
            raise AssertionError(f"the native draw ({seed}, {n} x {n}) is not the plain one")
    rng = reference_rng.StdRng(0)
    plain = np.array([rng.next_u64() for _ in range(U64_COUNT9)], np.uint64)
    if not np.array_equal(native.reference_u64_stream(0, U64_COUNT9), plain):
        raise AssertionError("the native u64 stream is not the plain one")
    count = LCG_N9 * LCG_T9
    values, state = native.lcg_laplace(SEED4, count)
    p_values, p_state = datagen._lcg_laplace(SEED4, count)
    err = float(np.max(np.abs(values - p_values) / np.abs(p_values)))
    if state != p_state or state != datagen._lcg_jump(SEED4, count):
        raise AssertionError(f"LCG states differ: {state} against {p_state}")
    if not err <= LCG_RTOL9:
        raise AssertionError(f"LCG Laplace values off by {err:.3e} relative")
    _log(f"native: draws {DRAWS9} and {U64_COUNT9} u64 bit for bit; LCG Laplace "
         f"{LCG_N9} x {LCG_T9}: end state bit for bit, values within {err:.3e} relative")
    native_s = _median_seconds(lambda: native.reference_normal_matrix(7, DRAW_N9, DRAW_N9))
    plain_s = _median_seconds(
        lambda: reference_rng.normal_matrix_plain(7, PLAIN_DRAW_N9, PLAIN_DRAW_N9), reps=1)
    _log(f"native: draw {DRAW_N9} x {DRAW_N9} {native_s:.4f} s "
         f"({native_s / DRAW_N9 ** 2 * 1e9:.1f} ns a sample); plain draw "
         f"{PLAIN_DRAW_N9} x {PLAIN_DRAW_N9} {plain_s:.4f} s "
         f"({plain_s / PLAIN_DRAW_N9 ** 2 * 1e9:.1f} ns a sample)")


def phase9b_w_init():
    """Phase 5b's kernel-path fit of the 1024 x 200,000 bench mixture (the
    same generator and seed) once more under ``profile_fit``: its
    ``picard.w_init`` step beside the fit's wall and core seconds."""
    import tempfile

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import generate_bench_data_device
    from picard_ica_tpu_torch.utils.profiling import profile_fit, span_summary

    x = generate_bench_data_device(N5B, T5B, SEED5B, "cuda")
    cfg = _config(use_kernels=True, tol=1e-4, max_iter=10)
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        r, wall = _synced_seconds(lambda: profile_fit(x, cfg, trace_dir=tmp))
        spans = span_summary(tmp)
    launches = _launches()
    w_init, fit_s, whiten_s = (spans[f"picard.{step}"]["wall_us"] / 1e6
                               for step in ("w_init", "fit", "whiten"))
    _log(f"w_init {N5B} x {T5B} (kernels, traced): picard.w_init {w_init:.4f} s, "
         f"picard.whiten {whiten_s:.4f} s, picard.fit {fit_s:.4f} s (profile_fit "
         f"{wall:.3f} s), core {r.core_seconds:.4f} s, {r.n_iterations} iterations")
    missing = [k for k in ("streaming_fused_sums", "_grouped_covariance") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the traced fit: {missing}")
    if not w_init <= W_INIT_MAX_S:
        raise AssertionError(f"picard.w_init took {w_init:.3f} s > {W_INIT_MAX_S} s")
    return launches


def conformance_case(label, n, t, mixed, density):
    """One case of the suite's oracle conformance: the port's oracle
    (center, whiten, core from W_init = I) and ``Picard.fit`` on the card
    from the same start, on the same f64 data; the Amari distance between
    the full unmixings, both iteration counts and both times."""
    import numpy as np

    from picard_ica_tpu_torch import Picard, PicardConfig, native
    from picard_ica_tpu_torch.ops.densities import Cube, Exp, Tanh
    from picard_ica_tpu_torch.utils.datagen import (
        generate_bench_data,
        generate_mixed_kurtosis_data,
    )

    x64 = (generate_mixed_kurtosis_data(n, t, seed=42)[2] if mixed
           else generate_bench_data(n, t, seed=42))
    t0 = time.perf_counter()
    xc, _ = native.oracle_center(x64)
    xw, k = native.oracle_whiten(xc, n)
    res = native.oracle_core(xw, np.eye(n), density=density, ortho=True, extended=True,
                             max_iter=500, tol=1e-7)
    oracle_s = time.perf_counter() - t0
    del xc, xw
    cfg = PicardConfig(density={"tanh": Tanh, "exp": Exp, "cube": Cube}[density](),
                       ortho=True, extended=True, tol=1e-7, max_iter=500, w_init=np.eye(n))
    r, fit_s = _synced_seconds(lambda: Picard.fit(x64, cfg))
    amari = _amari_pinv(r.full_unmixing().double().cpu().numpy(), res["w"] @ k)
    row = {"case": label, "n": n, "t": t, "density": density, "amari_vs_oracle": amari,
           "iterations": r.n_iterations, "oracle_iterations": res["n_iterations"],
           "converged": r.converged, "oracle_converged": res["converged"],
           "fit_s": fit_s, "oracle_s": oracle_s}
    _log(f"conformance {label}: amari(W_port, pinv(W_oracle)) = {amari:.3e}; "
         f"{r.n_iterations} iterations (oracle {res['n_iterations']}, converged "
         f"{r.converged} / {res['converged']}); fit {fit_s:.3f} s, oracle {oracle_s:.3f} s")
    return row


def _amari_pinv(w, w_other):
    import numpy as np

    from picard_ica_tpu_torch.utils.metrics import amari_distance

    return amari_distance(w, np.linalg.pinv(w_other))


def phase9c_conformance():
    """The suite's conformance cases against the port's oracle, each to
    Amari < ``AMARI_ORACLE_MAX``."""
    from picard_ica_tpu_torch.ops import kernels as K

    _log(f"conformance: oracle on host {_host_cpu()}")
    K.reset_launch_counts()
    rows = [conformance_case(*case) for case in SUITE_CONFORMANCE]
    launches = _launches()
    _log(f"launches: {launches}")
    bad = [r["case"] for r in rows if not r["amari_vs_oracle"] < AMARI_ORACLE_MAX]
    if bad:
        raise AssertionError(f"Amari to the oracle >= {AMARI_ORACLE_MAX}: {bad}")
    missing = [k for k in ("rotated_fused_sums", "rotated_moments_sums") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the conformance fits: {missing}")
    return launches


def phase9(build_seconds, by_path):
    """Phase 9: the native runtime, the draw in the fit, the oracle."""
    phase9a_native(build_seconds)
    by_path["phase9b"] = phase9b_w_init()
    by_path["phase9c"] = phase9c_conformance()


def phase10_staged_fault():
    """The 64 x 100,000 input on which the staged schedule can leave the
    separation, fitted on the card at the default schedule on both
    paths; returns the kernel path's launches."""
    import torch

    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import generate_mixed_kurtosis_data
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    _, a, x = generate_mixed_kurtosis_data(N10, T10, SEED10)
    jax_cpu = "; ".join(f"{path}: {it} iterations, exits {exits}, amari {am:.3e}"
                        for path, (it, exits, am) in JAX_CPU10.items())
    _log(f"staged {N10} x {T10} seed {SEED10}: the JAX package on the CPU: {jax_cpu}")
    launches = None
    for path, use_kernels in (("kernels", True), ("torch path", False)):
        K.reset_launch_counts()
        r, wall = _fit(x, use_kernels, tol=1e-7, max_iter=MAX_ITER10)
        if use_kernels:
            launches = _launches()
        amari = amari_distance(r.full_unmixing().double().cpu().numpy(), a)
        _log(f"staged {N10} x {T10} seed {SEED10} ({path}): converged={r.converged} "
             f"n_iterations={r.n_iterations} stage_exits={r.stage_exits} "
             f"ls_calls={r.ls_calls} gradient_norm={r.gradient_norm:.3e} amari={amari:.3e}; "
             f"fit {wall:.3f} s, core {r.core_seconds:.4f} s")
        if tuple(r.sources.shape) != (N10, T10) or not bool(torch.isfinite(r.sources).all()):
            raise AssertionError(f"staged {N10} x {T10} ({path}): sources not finite")
        del r
    missing = [k for k in TIER_ROWS if _count(k, launches) == 0]
    if missing:
        raise AssertionError(f"kernels never launched in phase 10: {missing}")
    return launches


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--maxt-rung"]:
        return _maxt_rung(int(argv[1]), int(argv[2]))
    phase0_env()
    native_build_s = phase1_build()
    if argv[:1] == ["--phase8"]:
        phase8()
        return 0
    if argv[:1] == ["--phase9"]:
        phase9(native_build_s, {})
        return 0
    if argv[:1] == ["--phase10"]:
        phase10_staged_fault()
        return 0
    rows = phase2_kernels()
    rows.update(phase2_whitening_kernels())
    rows.update(phase2_streaming_kernels())
    rows.update(phase2_contract())
    by_path = {"phase3": phase3_slice(), "phase4": phase4_device_slice(),
               "phase4b": phase4b_grouped()}
    by_path["phase5"], large_n = phase5_large_n()
    by_path["phase5c"] = phase5c_staged(*large_n)
    by_path["phase5d"] = phase5d_pinned_bf16(*large_n[:3])
    del large_n
    by_path["phase5b"] = phase5b_exhibit()
    by_path["phase6"], config4 = phase6_jade_warm()
    by_path["phase6b"] = phase6b_fastica(*config4)
    phase6c_checkpoints(*config4)
    del config4
    by_path["phase7"] = phase7_sharded()
    by_path["phase7b"] = phase7b_nccl()
    phase8()
    phase9(native_build_s, by_path)
    by_path["phase10"] = phase10_staged_fault()
    kernels = []
    for name, (source, line, headline) in _KERNELS.items():
        row = rows[name]
        main_case = next(c for c in row["cases"] if headline in (c["label"], c["case"]))
        path = _PATH_OF.get(name, "phase4")
        entry = {
            "name": name, "route": "cuda", "kernel_route": _KERNEL_ROUTE.get(name, "mma.sync"),
            "source": source,
            "replaces": f"{_PALLAS}:{line}", "launches": _count(name, by_path[path]),
            "max_abs_err": row["max_abs_err"], "case": main_case["case"],
            **({"f32_err_vs_f64": row["f32_err_vs_f64"]} if "f32_err_vs_f64" in row else {}),
            **{k: main_case[k] for k in ("ms", "ms_stream", "plain_ms", "bound_ms",
                                         "bound_by", "share", "share_stream",
                                         "library_ms", "library_ms_stream")},
            "cases": row["cases"],
            "launches_by_path": {p: _count(name, c) for p, c in by_path.items()},
        }
        if name in TIER_ROWS:  # kernel 1's rows: their route's launches by tier
            entry["launches_by_tier"] = {
                t: by_path["phase4"]["by_route"][_ROUTE_OF_ROW[name]][t] for t in TIER_ROWS[name]}
        if name == CONTRACT_ROW:  # launch B's launches by contraction tier
            entry["launches_by_tier"] = by_path[path]["contract_by_tier"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
