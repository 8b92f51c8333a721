"""Time two trees of the PyTorch + CUDA port in turns on one NVIDIA GPU.

    python3 port_turns.py BEFORE_DIR AFTER_DIR [--out FILE]

Each directory holds a ``picard_ica_tpu_torch`` package (a checkout, or
``git archive <commit> picard_ica_tpu_torch`` unpacked). Both libraries
are built first, side by side. Then four turns, each in a process of its
own that imports only its tree's package, in the order before, after,
after, before; each turn measures, with ``chip_smoke.py``'s helpers:

  * ``rotated_fused_sums`` at 64 x 2,000,000 (Laplace X, seed 0) in the
    three cases of the default fit's stages: plain bf16 on bf16 X (the
    ``mma.sync`` kernel, ``csrc/rotated_fused_tc.cu``), delta bf16x3 and
    delta f32 (H and Y^2 off: the ``wgmma`` kernel,
    ``csrc/rotated_fused_wgmma.cu``, in a tree that has it), each one
    synchronised call at a time (median of 10) and 10 calls back to back
    (median of 5); and delta bf16x3 and delta f32 at ``chip_smoke.py``'s
    ragged shapes (17 and 63 rows, 1,000,003 columns: rows not 16-byte
    aligned) and at the bench's 64 x 4,000,000;
  * ``rotated_moments_sums`` (kernel 2) on the same f32 X, without and
    with H and Y^2, and ``rotated_loglik_sums`` (kernel 3) on f32 X and
    on its bf16 copy, at 64 x 2,000,000, timed the same two ways;
  * ``streaming_fused_sums`` (``chip_smoke.py``'s unit-variance Laplace
    inputs) at 256 x 2,000,000, 1024 x 200,000, 306 x 1,000,003 (the
    MEG's channels, a ragged T) and 128 x 1,000,000 in the cases of a fit's
    passes, plain mode at the bf16 tier on bf16 X, delta mode at the
    bf16x3 and the f32 tier on f32 X, plain mode at the f32 tier on f32 X
    (the moments hand-off) and delta mode at the bf16 tier on f32 X (a
    kernel_precision="bf16" fit's tries), and ``streaming_loglik_sums`` on
    f32 X and on bf16 X at both shapes, timed the same two ways;
  * ``chip_smoke.py``'s phase-3 fit (64 x 2,000,000 mixed mixture, f64
    NumPy input) and phase-4 fits (the bench 64 x 4,000,000 made on the
    card) at the default staged schedule and in the exact f32 tier: core
    seconds, iterations, stage exits, and the fused pass's launches by
    tier (counted here the same way for both trees, by the tier of the
    contractions), after warm-up fits on a small mixture;
  * phase 5b's fits (the 1024 x 200,000 bench mixture, 10 iterations at
    tol 1e-4, default staged schedule) on the kernel path and the torch
    path: core seconds and iterations.

Every line of output names the tree; the last line is a JSON list of the
four turns, also written to ``--out`` (default
``chiprun_out/turns.json``). Needs one CUDA card and nvcc.

With ``--kernels-only`` the turns time the kernels alone, without the
fits; with ``--loglik`` only ``streaming_loglik_sums`` (kernel 9) at every
STREAM_SHAPES shape, on f32 X and on bf16 X, with the tanh and the cube
density, timed the same two ways and then in ``torch.profiler`` (5 calls:
each CUDA kernel's device ms a call, by name); with ``--core-only`` only
the resident core kernels' cases at
64 x 2,000,000 (kernel 1's three tiers, kernels 2 and 3) and kernel 1's
cases at the ragged shapes and at 64 x 4,000,000. With
``--large-n`` they take only the kernels (the ``rotated_fused_sums``,
moments and log-lik cases at 64 x 2,000,000 and the streaming kernels'
cases) and, unless ``--kernels-only`` is given too, phase 5's data
fitted through the streaming kernels three times, at the default staged
schedule, in the exact f32 tier (``kernel_precision="f32"``, phase 5's
fit) and 3 iterations pinned to bf16 (phase 5d's first fit): core
seconds, iterations, stage exits, launches by mode and tier; the pinned
fit's unmixing goes to ``chiprun_out/pinned_bf16_<tree>.npy``, and the
Amari distance between the two trees' is printed and kept in the output.

    python3 port_turns.py --profile [TREE] [--case LABEL ...]

traces one tree's ``streaming_fused_sums`` calls of a fit's passes
(plain bf16 on bf16 X, delta bf16x3, delta f32, plain f32 and delta bf16
on f32 X; ``--case`` keeps only the STREAM_CASES so labelled) at every
STREAM_SHAPES shape, with the tanh and cube densities, in
``torch.profiler`` and prints each CUDA kernel's device ms a call (mean
of 5 calls). Given two trees, ``--profile BEFORE AFTER`` profiles them in
turns (before, after, after, before), each in a process of its own, and
prints each case's launch A and launch B ms (``profile_turns.json``
beside ``--out``).

    python3 port_turns.py --parts [TREE ...]

splits launch A of kernel 8's three pairs on wgmma (plain bf16 on bf16
X, delta bf16x3 and delta f32 on f32 X) and kernel 9 on both X dtypes
(the same kernels' log-lik modes) at 256 x 2,000,000 into its
parts. Each TREE (default: this checkout) is
built four ways, all builds at once: as the port builds it, and with
``-DPICARD_A_SKIP`` (``csrc/streaming_fused_tc.cu``) added to the build's
``nvcc`` flags, switching off launch A's products, its density or its
workspace stores. Each build times, in
a process of its own, both pairs with the tanh and the cube density in
``torch.profiler`` (5 calls after 3 warm-up calls) and prints launch A's
and launch B's device ms a call; writes the rows to ``parts.json`` in
``--out``'s directory.

    python3 port_turns.py --config4-seeds 7,8,9,10 [TREE ...]

fits BASELINE config 4 as ``chip_smoke.py``'s phase 6 fits it on the
kernels (JADE(50) -> 128 x 1,000,000 mixed mixture, float64 NumPy, tol
1e-7, max_iter 200) at each seed, with each TREE's package in a process
of its own, one tree after the other (default: this checkout); prints a
line a fit with its tree (convergence, iterations, stage exits,
line-search passes, gradient norm, Amari to the mixing, core and fit
seconds) and writes the rows to ``config4_seeds.json`` in ``--out``'s
directory.

    python3 port_turns.py --crossover [TREE]

measures where ``use_kernels=None`` should hand a fit to the kernels: the
bench mixture made on the card (``generate_bench_data_device``, seed 42)
at T = 1,000,000 and N in CROSSOVER_N, fitted 10 iterations at tol 1e-4
on the kernel path and on the torch path, at the default staged schedule
and in the f32 tier, after warm-up fits (a draw the whitening finds
singular is logged and the next seed's fitted instead, up to seed 45; a
fit out of the card's memory is logged and loses); prints each fit's
core seconds per iteration and writes the rows to
``chiprun_out/crossover.json``.

    python3 port_turns.py --profile-fits [TREE]

profiles three fits with ``utils.profiling.profile_fit``, each after an
untraced fit of the same input: the bench 64 x 4,000,000 (made on the
card, seed 42, default config), BASELINE config 4 (JADE(50) -> 128 x
1,000,000 mixed mixture, f64 NumPy, seed 7, ``chip_smoke.py`` phase 6's
config) and the 1024 x 200,000 bench mixture (10 iterations at tol 1e-4,
phase 5b's); prints each ``picard.*`` step's host wall seconds, the
device seconds it launched and their share, the untraced fit's wall and
core seconds beside the traced one's, and the top device ops; writes the
rows to ``profile_fits.json`` in ``--out``'s directory.

    python3 port_turns.py --conformance [TREE]

runs all five of the suite's oracle-conformance cases
(``chip_smoke.SUITE_CONFORMANCE``, ``benchmarks/suite.py:650-659``, as
phase 9c runs them): the port's f64 oracle on the host and
``Picard.fit`` on the card from W_init = I on the same f64 data; prints
each case's Amari distance, iterations, oracle and fit seconds and the
host CPU, and writes the rows to ``conformance.json`` in ``--out``'s
directory.

    python3 port_turns.py --staged-fit [TREE]

fits ``chip_smoke.py``'s phase-5 data (256 x 2,000,000 mixed mixture,
seed 0, an f32 CUDA tensor) once with ``use_kernels=True`` at the default
staged schedule (with ``--f32`` in the exact f32 tier) with TREE's
package (default: this checkout), and prints
convergence, iterations, stage exits, the number of negative
(sub-Gaussian) signs, Amari distance to the mixing, and the streaming
fused kernel's launches; with ``--torch-path`` the same fit runs on the
torch path (``use_kernels=False``). With ``--trace`` it also prints each
iteration's tier, gradient norm, stall counters, line-search passes,
accepted step and negative signs; the trace syncs the host once an
iteration, so its core seconds are not comparable with an untraced
fit's. With ``--phase3`` the fit takes phase 3's data instead (64 x
2,000,000 mixed mixture, seed 0, float64 NumPy).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CASES = [  # (label, precision, absolute_ll, bf16 X)
    ("plain bf16, bf16 X", "bf16", True, True),
    ("delta bf16x3", "bf16x3", False, False),
    ("delta f32", "f32", False, False),
]
CORE_CASES = [  # (label, wrapper, H and Y^2, bf16 X) of kernels 2 and 3
    ("moments f32", "rotated_moments_sums", False, False),
    ("moments f32, H+ysq", "rotated_moments_sums", True, False),
    ("loglik f32", "rotated_loglik_sums", False, False),
    ("loglik bf16 X", "rotated_loglik_sums", False, True),
]
# (N, T) of kernel 1's cases beside 64 x 2,000,000: chip_smoke.py's
# ragged shapes (T_RAGGED: rows not 16-byte aligned) and the bench's
# 64 x 4,000,000; and the pairs timed there.
KERNEL1_SHAPES = ((17, 1_000_003), (63, 1_000_003), (64, 4_000_000))
KERNEL1_CASES = (("delta bf16x3", "bf16x3"), ("delta f32", "f32"))
# (N, T, seed of chip_smoke._stream_inputs) of the streaming fused
# kernel's cases: BASELINE config 5's width, the large-N exhibit's, the
# MEG's 306 channels at a ragged T (rows not 16-byte aligned), and
# BASELINE config 4's 128 x 1M (one output tile a group in launch B).
STREAM_SHAPES = ((256, 2_000_000, 5), (1024, 200_000, 7), (306, 1_000_003, 306),
                 (128, 1_000_000, 128))
STREAM_CASES = [  # (label, precision, absolute_ll, bf16 X)
    ("plain bf16, bf16 X", "bf16", True, True),
    ("delta bf16x3", "bf16x3", False, False),
    ("delta f32", "f32", False, False),
    ("plain f32", "f32", True, False),
    ("delta bf16, f32 X", "bf16", False, False),
]
# The crossover sweep's widths and columns.
CROSSOVER_N = (96, 128, 192, 256, 384, 512, 768, 1024, 1344)
CROSSOVER_T = 1_000_000


def _smoke():
    """This tree's chip_smoke.py, loaded by path (its helpers import the
    package at call time, so they use the turn's tree)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _count_tiers(core, kernels):
    """Wrap the fit's fused-pass entry to count calls by contraction tier."""
    by_tier = dict.fromkeys(("bf16", "bf16x3", "f32"), 0)
    inner = core.rotated_fused_sums

    def counted(m_new, m_old, x, *args, precision="f32", **kw):
        by_tier[kernels._tiers(x, precision)[0]] += 1
        return inner(m_new, m_old, x, *args, precision=precision, **kw)

    core.rotated_fused_sums = counted
    return by_tier


def one_turn(tree: str, kernels_only: bool = False, large_n: bool = False,
             core_only: bool = False, loglik: bool = False) -> dict:
    import numpy as np
    import torch

    sm = _smoke()
    sm.phase0_env()
    from picard_ica_tpu_torch.models import core
    from picard_ica_tpu_torch.ops import _build
    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.ops.densities import Tanh
    from picard_ica_tpu_torch.utils.datagen import (
        generate_bench_data_device,
        generate_mixed_kurtosis_data,
    )

    assert Path(K.__file__).resolve().is_relative_to(Path(tree).resolve()), K.__file__
    _build.load()
    turn = {"tree": tree, "kernel": {}, "fits": {}}
    if loglik:
        _loglik_turn(sm, K, tree, turn)
        return turn
    rng = np.random.default_rng(sm.SEED)
    x = torch.from_numpy((rng.laplace(size=(sm.N, sm.T)) / np.sqrt(2.0))
                         .astype(np.float32)).cuda()
    x16 = x.to(torch.bfloat16)
    m_old = torch.from_numpy(np.eye(sm.N) + 0.1 * rng.standard_normal((sm.N, sm.N))).float().cuda()
    m_new = m_old + torch.from_numpy(0.01 * rng.standard_normal((sm.N, sm.N))).float().cuda()
    for label, precision, absolute_ll, bf16_x in CASES:
        xx = x16 if bf16_x else x

        def call():
            return K.rotated_fused_sums(m_new, m_old, xx, Tanh(), False, False,
                                        precision, absolute_ll)

        ms, ms_stream = sm._time_both(call)
        turn["kernel"][label] = {"ms": ms, "ms_stream": ms_stream}
        sm._log(f"[{tree}] rotated_fused_sums [{label}] {sm.N} x {sm.T}: "
                f"{sm._fmt_pair((ms, ms_stream))}")
    for label, name, flags, bf16_x in CORE_CASES:
        xx = x16 if bf16_x else x
        kern = getattr(K, name)
        args = (flags, flags) if name == "rotated_moments_sums" else (flags,)
        ms, ms_stream = sm._time_both(lambda: kern(m_new, xx, Tanh(), *args))
        turn["kernel"][label] = {"ms": ms, "ms_stream": ms_stream}
        sm._log(f"[{tree}] {name} [{label}] {sm.N} x {sm.T}: {sm._fmt_pair((ms, ms_stream))}")
    del x, x16, xx
    torch.cuda.empty_cache()
    if core_only:
        _kernel1_turn(sm, K, tree, turn)
        return turn
    if large_n:
        _stream_turn(sm, K, tree, turn)
        if not kernels_only:
            x5, a5 = _large_n_data(sm)
            for label, precision in (("staged 256 x 2M", "auto"), ("f32 256 x 2M", "f32")):
                turn["fits"][label] = large_n_fit(tree, sm, x5, a5, precision=precision)
            turn["fits"]["pinned bf16 256 x 2M, 3 iterations"] = large_n_fit(
                tree, sm, x5, a5, precision="bf16", max_iter=3,
                save=HERE / "chiprun_out" / f"pinned_bf16_{Path(tree).name}.npy")
        return turn
    _kernel1_turn(sm, K, tree, turn)
    _stream_turn(sm, K, tree, turn)
    if kernels_only:
        return turn

    by_tier = _count_tiers(core, K)

    def fit(label, data, t, **config):
        for k in by_tier:
            by_tier[k] = 0
        r, wall = sm._fit(data, None, **config)
        sm._report_fit(f"[{tree}] {label}", r, wall, t)
        sm._log(f"[{tree}] {label}: fused launches by tier {by_tier}")
        if not r.converged:
            raise AssertionError(f"{label} did not converge")
        turn["fits"][label] = {
            "core_seconds": r.core_seconds, "fit_seconds": wall,
            "n_iterations": r.n_iterations, "stage_exits": list(r.stage_exits),
            "ls_calls": r.ls_calls, "launches_by_tier": dict(by_tier)}

    # Warm-up fits on a small mixture, on both input paths and both
    # schedules, so the timed fits below pay no first-call costs (module
    # loading of each kernel, torch's first calls), as chip_smoke.py's fits
    # come after its phase 2.
    _, _, xw = generate_mixed_kurtosis_data(sm.N, 200_000, 1)
    for data in (xw, torch.from_numpy(xw).float().cuda()):
        for precision in ("auto", "f32"):
            sm._fit(data, None, kernel_precision=precision)
    del xw, data

    _, _, x3 = generate_mixed_kurtosis_data(sm.N, sm.T, sm.SEED)
    fit("phase 3", x3, sm.T)
    del x3
    x4 = generate_bench_data_device(sm.N4, sm.T4, sm.SEED4, "cuda")
    fit("phase 4", x4, sm.T4)
    fit("phase 4, f32", x4, sm.T4, kernel_precision="f32")
    del x4
    torch.cuda.empty_cache()
    x5 = generate_bench_data_device(sm.N5B, sm.T5B, sm.SEED5B, "cuda")
    for label, use_kernels in (("phase 5b", True), ("phase 5b, torch path", False)):
        r, wall = sm._fit(x5, use_kernels, tol=1e-4, max_iter=10)
        sm._report_fit(f"[{tree}] {label}", r, wall, sm.T5B)
        turn["fits"][label] = {"core_seconds": r.core_seconds, "fit_seconds": wall,
                               "n_iterations": r.n_iterations,
                               "stage_exits": list(r.stage_exits or ())}
    return turn


def _kernel1_turn(sm, K, tree, turn):
    """Time KERNEL1_CASES of ``rotated_fused_sums`` at each of
    KERNEL1_SHAPES (``chip_smoke._stream_inputs``, seed N)."""
    import torch

    from picard_ica_tpu_torch.ops.densities import Tanh

    for n, t in KERNEL1_SHAPES:
        xr, mr_old, mr_new = sm._stream_inputs(n, t, n)
        for case, precision in KERNEL1_CASES:
            label = f"{case}, {n} x {t}"
            ms, ms_stream = sm._time_both(lambda: K.rotated_fused_sums(
                mr_new, mr_old, xr, Tanh(), False, False, precision, False))
            turn["kernel"][label] = {"ms": ms, "ms_stream": ms_stream}
            sm._log(f"[{tree}] rotated_fused_sums [{label}]: {sm._fmt_pair((ms, ms_stream))}")
        del xr
        torch.cuda.empty_cache()


def _stream_turn(sm, K, tree, turn):
    """Time STREAM_CASES and the loglik kernel on f32 X and on bf16 X,
    each shape's inputs made once."""
    import torch

    from picard_ica_tpu_torch.ops.densities import Tanh

    for n, t, seed in STREAM_SHAPES:
        xs, ms_old, ms_new = sm._stream_inputs(n, t, seed)
        xs16 = xs.to(torch.bfloat16)
        for case, precision, absolute_ll, bf16_x in STREAM_CASES:
            xx = xs16 if bf16_x else xs
            label = f"streaming {case}, {n} x {t}"
            ms, ms_stream = sm._time_both(lambda: K.streaming_fused_sums(
                ms_new, ms_old, xx, Tanh(), False, False, precision, absolute_ll))
            turn["kernel"][label] = {"ms": ms, "ms_stream": ms_stream}
            sm._log(f"[{tree}] streaming_fused_sums [{label}]: {sm._fmt_pair((ms, ms_stream))}")
        for case, xx in (("f32", xs), ("bf16 X", xs16)):
            label = f"streaming loglik {case}, {n} x {t}"
            ms, ms_stream = sm._time_both(
                lambda: K.streaming_loglik_sums(ms_old, xx, Tanh(), False))
            turn["kernel"][label] = {"ms": ms, "ms_stream": ms_stream}
            sm._log(f"[{tree}] streaming_loglik_sums [{label}]: {sm._fmt_pair((ms, ms_stream))}")
        del xs, xs16, xx
        torch.cuda.empty_cache()


def _loglik_turn(sm, K, tree, turn):
    """Time ``streaming_loglik_sums`` at each STREAM_SHAPES shape on f32 X
    and on bf16 X, with the tanh and the cube density: one synchronised
    call at a time and 10 back to back, then 5 calls in torch.profiler
    (each CUDA kernel's device ms a call, by name)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as traced

    from picard_ica_tpu_torch.ops.densities import Cube, Tanh

    for n, t, seed in STREAM_SHAPES:
        xs, ms_old, _ = sm._stream_inputs(n, t, seed)
        xs16 = xs.to(torch.bfloat16)
        for case, xx in (("f32", xs), ("bf16 X", xs16)):
            for density in (Tanh(), Cube()):
                def call():
                    return K.streaming_loglik_sums(ms_old, xx, density, False)

                label = f"streaming loglik {case}, {n} x {t}, {type(density).__name__}"
                ms, ms_stream = sm._time_both(call)
                with traced(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                kernels = {e.key[:90]: e.device_time_total / 5e3 for e in prof.key_averages()
                           if e.device_time_total > 0}
                turn["kernel"][label] = {"ms": ms, "ms_stream": ms_stream, "profile": kernels}
                sm._log(f"[{tree}] streaming_loglik_sums [{label}]: "
                        f"{sm._fmt_pair((ms, ms_stream))}; profiler "
                        + "; ".join(f"{k}: {v:.3f}" for k, v in
                                    sorted(kernels.items(), key=lambda kv: -kv[1])))
        del xs, xs16, xx
        torch.cuda.empty_cache()


def profile(tree: str, cases=None) -> dict:
    """Device ms a call of each CUDA kernel in the tensor-core route's
    calls (torch.profiler over 5 calls after 3 warm-up calls), of the
    STREAM_CASES labelled in ``cases`` (all by default)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as traced

    sm = _smoke()
    sm.phase0_env()
    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.ops.densities import Cube, Tanh

    assert Path(K.__file__).resolve().is_relative_to(Path(tree).resolve()), K.__file__
    out = {}
    for n, t, seed in STREAM_SHAPES:
        xs, ms_old, ms_new = sm._stream_inputs(n, t, seed)
        xs16 = xs.to(torch.bfloat16)
        for case, precision, absolute_ll, bf16_x in STREAM_CASES:
            if cases and case not in cases:
                continue
            xx = xs16 if bf16_x else xs
            for density in (Tanh(), Cube()):
                def call():
                    return K.streaming_fused_sums(ms_new, ms_old, xx, density, False, False,
                                                  precision, absolute_ll)

                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                with traced(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                rows = {e.key[:90]: e.device_time_total / 5e3 for e in prof.key_averages()
                        if e.device_time_total > 0}
                label = f"{case}, {n} x {t}, {type(density).__name__}"
                out[label] = rows
                sm._log(f"[{tree}] profile {label}: total {sum(rows.values()):.3f} ms a call; "
                        + "; ".join(f"{k}: {v:.3f}" for k, v in sorted(rows.items(),
                                                                     key=lambda kv: -kv[1])))
        del xs, xs16, xx
        torch.cuda.empty_cache()
    return out


# (label, PICARD_A_SKIP) of --parts' builds, and the pairs it splits
# (STREAM_CASES' rows of the three wgmma launch A pairs), and the loglik
# kernel's two X dtypes, the same kernels' log-lik modes (no stores).
PARTS = (("whole", 0), ("no products", 1), ("no density", 2), ("no stores", 4))
PARTS_CASES = [c for c in STREAM_CASES
               if c[0] in ("plain bf16, bf16 X", "delta bf16x3", "delta f32")]
PARTS_LOGLIK = (("loglik f32", False), ("loglik bf16 X", True))


def _part_flags(skip) -> tuple:
    """The ``nvcc`` flags a ``--parts`` build adds to the port's."""
    return (f"-DPICARD_A_SKIP={skip}",) if skip else ()


def _add_part_flags(skip):
    """Add a ``--parts`` build's flags to the imported tree's build, before
    its library is built or loaded."""
    from picard_ica_tpu_torch.ops import _build

    _build.NVCC_FLAGS += _part_flags(skip)


def parts_turn(tree: str) -> dict:
    """One build's launch A and launch B device ms a call (``--parts``),
    the kernels split by name: launch A's names hold ``rotate_``, launch
    B's ``contract_`` (``contract_wgmma_kernel``; ``contract_kernel`` in
    trees before it)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as traced

    sm = _smoke()
    sm.phase0_env()
    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.ops.densities import Cube, Tanh

    assert Path(K.__file__).resolve().is_relative_to(Path(tree).resolve()), K.__file__
    n, t, seed = STREAM_SHAPES[0]
    xs, ms_old, ms_new = sm._stream_inputs(n, t, seed)
    xs16 = xs.to(torch.bfloat16)
    out = {}
    for case, precision, absolute_ll, bf16_x in PARTS_CASES:
        xx = xs16 if bf16_x else xs
        for density in (Tanh(), Cube()):
            def call():
                return K.streaming_fused_sums(ms_new, ms_old, xx, density, False, False,
                                              precision, absolute_ll)

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with traced(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            a = sum(e.device_time_total for e in prof.key_averages() if "rotate_" in e.key)
            b = sum(e.device_time_total for e in prof.key_averages()
                    if "contract_" in e.key)
            out[f"{case}, {type(density).__name__}"] = {"A_ms": a / 5e3, "B_ms": b / 5e3}
    for case, bf16_x in PARTS_LOGLIK:
        xx = xs16 if bf16_x else xs
        for density in (Tanh(), Cube()):
            def call():
                return K.streaming_loglik_sums(ms_old, xx, density, False)

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with traced(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            a = sum(e.device_time_total for e in prof.key_averages() if "rotate_" in e.key)
            out[f"{case}, {type(density).__name__}"] = {"A_ms": a / 5e3, "B_ms": 0.0}
    return out


def parts(trees, out_dir: Path) -> list:
    """``--parts``: every (tree, build) of :data:`PARTS` built at once,
    then timed one process each."""
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from picard_ica_tpu_torch.ops import _build; "
         "_build.NVCC_FLAGS += tuple(sys.argv[2:]); p, s = _build.build(); "
         "print(sys.argv[1], p.name, round(s, 1), flush=True)", tree, *_part_flags(skip)])
        for tree in trees for _, skip in PARTS]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("a build failed")
    rows = []
    for tree in trees:
        for label, skip in PARTS:
            env = dict(os.environ, PYTHONPATH=tree)
            proc = subprocess.run([sys.executable, __file__, "--one-parts", tree,
                                   "--skip", str(skip)], env=env, cwd=tree,
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"the {label} build of {tree} failed")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            for case, ms in got.items():
                print(f"[{tree}] {label}: {case}: launch A {ms['A_ms']:.3f} ms, "
                      f"launch B {ms['B_ms']:.3f} ms", flush=True)
            rows.append({"tree": tree, "build": label, "skip": skip, "ms": got})
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "parts.json").write_text(json.dumps(rows, indent=1))
    return rows


def _trace_iterations(core):
    """Wrap the core loop's iteration to record, after each one, its tier,
    iteration count, gradient norm, stall counters, line-search passes,
    the log2 exponent of the accepted step (0 after a fallback) and the
    number of negative signs."""
    rows = []
    inner = core._iteration_body

    def traced(st, x, covariance, tol, lambda_min, opts):
        out = inner(st, x, covariance, tol, lambda_min, opts)
        rows.append((opts.kernel_precision, out.n_iter_done if out.converged else out.it,
                     float(out.gradient_norm), out.since_improve, out.consec_fallbacks,
                     out.ls_calls, out.prev_alpha_exp, int((out.signs < 0).sum())))
        return out

    core._iteration_body = traced
    return rows


def _large_n_data(sm):
    """Phase 5's 256 x 2,000,000 mixed mixture (seed 0) as an f32 CUDA
    tensor, and its mixing."""
    import numpy as np
    import torch

    from picard_ica_tpu_torch.utils.datagen import generate_mixed_kurtosis_data

    _, a, x_np = generate_mixed_kurtosis_data(sm.N5, sm.T5, sm.SEED)
    return torch.from_numpy(x_np.astype(np.float32)).cuda(), a


def _phase3_data(sm):
    """Phase 3's 64 x 2,000,000 mixed mixture (seed 0) as float64 NumPy
    (host-f64 whitening), and its mixing."""
    from picard_ica_tpu_torch.utils.datagen import generate_mixed_kurtosis_data

    _, a, x = generate_mixed_kurtosis_data(sm.N, sm.T, sm.SEED)
    return x, a


def large_n_fit(tree: str, sm=None, x=None, a=None, trace: bool = False,
                use_kernels: bool = True, precision: str = "auto", save=None,
                phase3: bool = False, **caps) -> dict:
    """Phase 5's 256 x 2,000,000 data (made here unless ``x`` and ``a`` are
    given; phase 3's 64 x 2,000,000 with ``phase3``) fitted once, through
    the kernels or on the torch path, at the default staged schedule or
    in one tier (``precision``), with the config's ``caps`` (e.g.
    ``max_iter``); the unmixing is saved to ``save`` when given."""
    import numpy as np
    import torch

    if sm is None:
        sm = _smoke()
        sm.phase0_env()
    from picard_ica_tpu_torch.models import core
    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    assert Path(K.__file__).resolve().is_relative_to(Path(tree).resolve()), K.__file__
    if x is None:
        x, a = _phase3_data(sm) if phase3 else _large_n_data(sm)
    n, t = x.shape
    rows = _trace_iterations(core) if trace else None
    K.reset_launch_counts()
    r, wall = sm._fit(x, use_kernels, kernel_precision=precision, **caps)
    path = "kernels" if use_kernels else "torch path"
    schedule = "staged" if precision == "auto" else precision
    sm._report_fit(f"[{tree}] {schedule} {n} x {t} ({path})", r, wall, t)
    for row in rows or ():
        sm._log(f"[{tree}] iteration: tier {row[0]}, it {row[1]}, gradient norm "
                f"{row[2]:.4e}, since_improve {row[3]}, consec_fallbacks {row[4]}, "
                f"ls_calls {row[5]}, accepted alpha 2^-{row[6]}, negative signs {row[7]}")
    if save is not None:
        Path(save).parent.mkdir(parents=True, exist_ok=True)
        np.save(save, r.full_unmixing().double().cpu().numpy())
    result = {"converged": r.converged, "n_iterations": r.n_iterations,
              "stage_exits": list(r.stage_exits or ()), "core_seconds": r.core_seconds,
              "gradient_norm": r.gradient_norm,
              "negative_signs": int((r.signs < 0).sum()) if r.signs is not None else None,
              "amari": amari_distance(r.full_unmixing().double().cpu().numpy(), a),
              "streaming_fused_launches": K.streaming_fused_sums.launches,
              "streaming_fused_by_route": getattr(K.streaming_fused_sums,
                                                  "launches_by_route", None),
              "streaming_fused_by_tier": getattr(K.streaming_fused_sums,
                                                 "launches_by_tier", None),
              "streaming_fused_by_mode": getattr(K.streaming_fused_sums,
                                                 "launches_by_mode", None),
              "streaming_loglik_launches": K.streaming_loglik_sums.launches,
              "streaming_loglik_by_tier": getattr(K.streaming_loglik_sums,
                                                  "launches_by_tier", None)}
    del r
    torch.cuda.empty_cache()
    sm._log(f"[{tree}] {schedule} fit: {result}")
    return result


def crossover(tree: str) -> list:
    """The kernel path against the torch path for ``use_kernels=None``'s
    rule (module docstring): one row per (N, schedule, path) with core
    seconds per iteration."""
    import torch

    sm = _smoke()
    sm.phase0_env()
    from picard_ica_tpu_torch.errors import SingularMatrixError
    from picard_ica_tpu_torch.ops import kernels as K
    from picard_ica_tpu_torch.utils.datagen import generate_bench_data_device

    assert Path(K.__file__).resolve().is_relative_to(Path(tree).resolve()), K.__file__
    caps = {"tol": 1e-4, "max_iter": 10}
    schedules = (("staged", "auto"), ("f32", "f32"))
    paths = (("kernels", True), ("torch path", False))
    # Warm-up fits of every (schedule, path), so no timed fit pays a first
    # call's costs (the kernels' library, cuBLAS, the host's eigh).
    xw = generate_bench_data_device(CROSSOVER_N[0], 100_000, 1, "cuda")
    for _, precision in schedules:
        for _, use_kernels in paths:
            sm._fit(xw, use_kernels, kernel_precision=precision, **caps)
    del xw
    rows = []
    for n in CROSSOVER_N:
        # A draw whose mixing the f32 covariance cannot resolve (at
        # 1024 x 1M seed 42's has condition number 3.1e4, seed 43's 1.1e5)
        # stops both paths in the whitening: it is logged, and the next
        # seed's draw is fitted.
        for seed in range(sm.SEED4, sm.SEED4 + 4):
            x = generate_bench_data_device(n, CROSSOVER_T, seed, "cuda")
            try:
                rows += [_crossover_fit(sm, K, tree, x, n, seed, schedule, precision, path,
                                        use_kernels, caps)
                         for schedule, precision in schedules for path, use_kernels in paths]
                break
            except SingularMatrixError:
                sm._log(f"[{tree}] crossover N={n}: seed {seed}'s mixture is singular to the "
                        "whitening")
            finally:
                del x
                torch.cuda.empty_cache()
    for n in CROSSOVER_N:
        per = {(r["schedule"], r["path"]): r["core_s_per_iteration"] for r in rows if r["n"] == n}
        if not per:
            continue
        wins = [per[(s, "kernels")] < per[(s, "torch path")] for s, _ in schedules]
        sm._log(f"[{tree}] crossover N={n}: kernel path wins at staged {wins[0]}, f32 {wins[1]}")
    out = HERE / "chiprun_out" / "crossover.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return rows


def _crossover_fit(sm, K, tree, x, n, seed, schedule, precision, path, use_kernels, caps):
    """One fit of the crossover sweep and its row; a fit that runs out of
    the card's memory gets a row without times, and loses."""
    import torch

    row = {"n": n, "t": CROSSOVER_T, "seed": seed, "schedule": schedule, "path": path}
    K.reset_launch_counts()
    try:
        r, wall = sm._fit(x, use_kernels, kernel_precision=precision, **caps)
    except torch.OutOfMemoryError:
        r = None
    if r is None:  # the failed fit's tensors are freed once the exception is gone
        torch.cuda.empty_cache()
        sm._log(f"[{tree}] crossover N={n} seed {seed} {schedule} {path}: out of memory")
        return {**row, "out_of_memory": True, "core_s_per_iteration": float("inf")}
    row.update({"n_iterations": r.n_iterations, "core_seconds": r.core_seconds,
                "core_s_per_iteration": r.core_seconds / r.n_iterations, "fit_seconds": wall,
                "streaming_fused_launches": K.streaming_fused_sums.launches})
    sm._log(f"[{tree}] crossover N={n} seed {seed} {schedule} {path}: {r.n_iterations} "
            f"iterations, core {r.core_seconds:.4f} s, "
            f"{row['core_s_per_iteration']:.5f} s/iteration, fit {wall:.3f} s")
    return row


def _pinned_agreement(before: str, after: str):
    """Amari distance between the two trees' pinned-bf16 unmixings, where
    both turns saved one."""
    import numpy as np

    from picard_ica_tpu_torch.utils.metrics import amari_distance

    files = [HERE / "chiprun_out" / f"pinned_bf16_{Path(t).name}.npy" for t in (before, after)]
    if not all(f.exists() for f in files):
        return None
    w_before, w_after = (np.load(f) for f in files)
    return amari_distance(w_after, np.linalg.inv(w_before))


def profile_fits(tree: str, out_dir: Path) -> list:
    """``--profile-fits``: each fit untraced, then under ``profile_fit``;
    the steps' host and device seconds (``span_summary``) and the top
    device ops (``device_trace_summary``)."""
    import tempfile

    sm = _smoke()
    from picard_ica_tpu_torch import Picard
    from picard_ica_tpu_torch.ops import _build
    from picard_ica_tpu_torch.utils.datagen import (
        generate_bench_data_device,
        generate_mixed_kurtosis_data,
    )
    from picard_ica_tpu_torch.utils.profiling import (
        device_trace_summary,
        profile_fit,
        span_summary,
    )

    _build.load()
    fits = [
        (f"bench {sm.N4} x {sm.T4}", lambda: generate_bench_data_device(sm.N4, sm.T4, sm.SEED4),
         {}),
        (f"config 4, JADE({sm.JADE_IT6}) -> {sm.N6} x {sm.T6}",
         lambda: generate_mixed_kurtosis_data(sm.N6, sm.T6, sm.SEED6)[2], sm.CONFIG6),
        (f"exhibit {sm.N5B} x {sm.T5B}",
         lambda: generate_bench_data_device(sm.N5B, sm.T5B, sm.SEED5B),
         {"tol": 1e-4, "max_iter": 10}),
    ]
    rows = []
    for label, make, config in fits:
        x = make()
        cfg = sm._config(**config)
        plain, plain_s = sm._synced_seconds(lambda: Picard.fit(x, cfg))
        with tempfile.TemporaryDirectory() as tmp:
            r, traced_s = sm._synced_seconds(lambda: profile_fit(x, cfg, trace_dir=tmp))
            spans = span_summary(tmp)
            top = device_trace_summary(tmp, "GPU", top_k=8)
        print(f"{tree} {label}: untraced fit {plain_s:.4f} s (core {plain.core_seconds:.4f} s, "
              f"{plain.n_iterations} iterations); traced fit {traced_s:.4f} s (core "
              f"{r.core_seconds:.4f} s, {r.n_iterations} iterations), device total "
              f"{top['total_us'] / 1e6:.4f} s", flush=True)
        for name, row in spans.items():
            print(f"  {name:20s} host {row['wall_us'] / 1e6:9.4f} s  device "
                  f"{row['device_us'] / 1e6:9.4f} s  ({row['device_us'] / row['wall_us']:.4f})  "
                  f"{row['launches']} device events", flush=True)
        for name, us in top["by_op"].items():
            print(f"    {us / 1e6:9.4f} s  {name[:110]}", flush=True)
        rows.append({"fit": label, "untraced_s": plain_s, "untraced_core_s": plain.core_seconds,
                     "traced_s": traced_s, "traced_core_s": r.core_seconds,
                     "iterations": r.n_iterations, "device_total_us": top["total_us"],
                     "spans": spans, "top_ops": top["by_op"]})
        del x, plain, r
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_fits.json").write_text(json.dumps(rows, indent=1))
    return rows


def conformance(tree: str, out_dir: Path) -> list:
    """``--conformance``: every case of the suite's oracle conformance."""
    sm = _smoke()
    from picard_ica_tpu_torch import native
    from picard_ica_tpu_torch.ops import _build

    _build.load()
    native.load()
    print(f"{tree}: oracle on host {sm._host_cpu()}", flush=True)
    rows = [sm.conformance_case(*case) for case in sm.SUITE_CONFORMANCE]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "conformance.json").write_text(json.dumps(rows, indent=1))
    return rows


def profile_turns(trees, cases, out_dir: Path) -> list:
    """``--profile BEFORE AFTER``: both libraries built at once, then
    :func:`profile` of each tree in a process of its own, in the order
    before, after, after, before; each turn's launch A (names holding
    ``rotate_``) and launch B (``contract_``) device ms a call printed by
    case, the rows written to ``profile_turns.json`` in ``out_dir``."""
    before, after = (str(Path(t).resolve()) for t in trees)
    _build_all([before, after])
    rows = []
    for tree in (before, after, after, before):
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run([sys.executable, __file__, "--profile", tree]
                              + [a for c in cases or () for a in ("--case", c)],
                              env=env, cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"the profile of {tree} failed")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        for label, kernels in got.items():
            a = sum(v for k, v in kernels.items() if "rotate_" in k)
            b = sum(v for k, v in kernels.items() if "contract_" in k)
            print(f"[{tree}] {label}: launch A {a:.3f} ms, launch B {b:.3f} ms, "
                  f"total {sum(kernels.values()):.3f} ms", flush=True)
        rows.append({"tree": tree, "profile": got})
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_turns.json").write_text(json.dumps(rows, indent=1))
    return rows


def config4_seeds(tree, seeds):
    """BASELINE config 4 as ``chip_smoke.py``'s phase 6 fits it on the
    kernels (JADE(50) -> 128 x 1,000,000 float64 NumPy, tol 1e-7, max_iter
    200), at each of ``seeds`` of the data: convergence, iterations, stage
    exits, line-search passes, gradient norm, Amari to the mixing, core
    and fit seconds."""
    from picard_ica_tpu_torch.utils.datagen import generate_mixed_kurtosis_data
    from picard_ica_tpu_torch.utils.metrics import amari_distance

    smoke = _smoke()
    rows = []
    for seed in seeds:
        _, a, x = generate_mixed_kurtosis_data(smoke.N6, smoke.T6, seed)
        r, wall = smoke._fit(x, None, **smoke.CONFIG6)
        row = {"tree": tree, "seed": seed, "converged": bool(r.converged),
               "n_iterations": r.n_iterations, "stage_exits": list(r.stage_exits),
               "ls_calls": r.ls_calls, "gradient_norm": r.gradient_norm,
               "amari": amari_distance(r.full_unmixing().double().cpu().numpy(), a),
               "core_s": r.core_seconds, "fit_s": wall}
        print(f"[{tree}] config 4 seed {seed}: converged={row['converged']} "
              f"n_iterations={row['n_iterations']} stage_exits={tuple(r.stage_exits)} "
              f"ls_calls={row['ls_calls']} gradient_norm={row['gradient_norm']:.4e} "
              f"amari {row['amari']:.4e} core {row['core_s']:.4f} s fit {wall:.3f} s",
              flush=True)
        rows.append(row)
        del x, r
    return rows


def _build_all(trees):
    """Build every tree's library at once (one process per tree)."""
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from picard_ica_tpu_torch.ops import _build; p, s = _build.build(); "
         "print(sys.argv[1], p.name, round(s, 1), flush=True)", t]) for t in trees]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit("a build failed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--one-parts", help=argparse.SUPPRESS)
    ap.add_argument("--skip", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--parts", action="store_true",
                    help="split launch A of kernel 8's wgmma pairs into its parts")
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "turns.json"))
    ap.add_argument("--staged-fit", action="store_true",
                    help="fit phase 5's data once at the default staged schedule")
    ap.add_argument("--profile", action="store_true",
                    help="trace the streaming tensor-core route's kernels")
    ap.add_argument("--case", action="append",
                    help="with --profile, only this STREAM_CASES label (repeatable)")
    ap.add_argument("--kernels-only", action="store_true", help="turns without the fits")
    ap.add_argument("--loglik", action="store_true",
                    help="turns of the streaming loglik kernel's cases only")
    ap.add_argument("--trace", action="store_true",
                    help="with --staged-fit, print each iteration's gradient norm")
    ap.add_argument("--torch-path", action="store_true",
                    help="with --staged-fit, fit on the torch path")
    ap.add_argument("--phase3", action="store_true",
                    help="with --staged-fit, fit phase 3's 64 x 2M data instead")
    ap.add_argument("--f32", action="store_true",
                    help="with --staged-fit, fit in the exact f32 tier instead")
    ap.add_argument("--core-only", action="store_true",
                    help="turns of the resident core kernels' cases at 64 x 2M only")
    ap.add_argument("--large-n", action="store_true",
                    help="turns of the streaming fused kernel's cases and the staged fit only")
    ap.add_argument("--profile-fits", action="store_true",
                    help="profile the bench, config 4 and 1024 x 200k fits step by step")
    ap.add_argument("--crossover", action="store_true",
                    help="sweep N on both paths for use_kernels=None's rule")
    ap.add_argument("--conformance", action="store_true",
                    help="the suite's five oracle-conformance cases against the port's oracle")
    ap.add_argument("--config4-seeds",
                    help="comma-separated seeds: config 4's kernel fit in each tree in turn")
    ap.add_argument("--one-config4", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one_parts:
        sys.path[:] = [args.one_parts] + [p for p in sys.path
                                          if p and Path(p).resolve() != HERE]
        _add_part_flags(args.skip)
        print(json.dumps(parts_turn(args.one_parts)))
        return 0
    seeds = [int(v) for v in args.config4_seeds.split(",")] if args.config4_seeds else None
    if args.one_config4:
        sys.path[:] = [args.one_config4] + [p for p in sys.path
                                            if p and Path(p).resolve() != HERE]
        print(json.dumps(config4_seeds(args.one_config4, seeds)))
        return 0
    if seeds:
        trees = [str(Path(t).resolve()) for t in args.trees or [HERE]]
        _build_all(trees)
        rows = []
        for tree in trees:
            proc = subprocess.run([sys.executable, __file__, "--one-config4", tree,
                                   "--config4-seeds", args.config4_seeds],
                                  env=dict(os.environ, PYTHONPATH=tree), cwd=tree,
                                  capture_output=True, text=True)
            sys.stdout.write(proc.stdout.rsplit("\n", 2)[0] + "\n")
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"config 4's fits in {tree} failed")
            rows += json.loads(proc.stdout.strip().splitlines()[-1])
        out = Path(args.out).parent / "config4_seeds.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
        print(json.dumps(rows))
        return 0
    if args.parts:
        trees = [str(Path(t).resolve()) for t in args.trees or [HERE]]
        print(json.dumps(parts(trees, Path(args.out).parent)))
        return 0
    if args.crossover or args.profile_fits or args.conformance:
        tree = str(Path(args.trees[0] if args.trees else HERE).resolve())
        sys.path[:] = [tree] + [p for p in sys.path if p and Path(p).resolve() != HERE]
        out_dir = Path(args.out).parent
        print(json.dumps(crossover(tree) if args.crossover
                         else conformance(tree, out_dir) if args.conformance
                         else profile_fits(tree, out_dir)))
        return 0
    if args.profile and len(args.trees) == 2:
        print(json.dumps(profile_turns(args.trees, args.case, Path(args.out).parent)))
        return 0
    if args.staged_fit or args.profile:
        tree = str(Path(args.trees[0] if args.trees else HERE).resolve())
        sys.path[:] = [tree] + [p for p in sys.path if p and Path(p).resolve() != HERE]
        print(json.dumps(large_n_fit(tree, trace=args.trace, use_kernels=not args.torch_path,
                                     precision="f32" if args.f32 else "auto",
                                     phase3=args.phase3)
                         if args.staged_fit else profile(tree, args.case)))
        return 0
    if args.one:
        # Only the turn's tree provides the package, not this script's.
        sys.path[:] = [args.one] + [p for p in sys.path if p and Path(p).resolve() != HERE]
        print(json.dumps(one_turn(args.one, args.kernels_only, args.large_n, args.core_only,
                                  args.loglik)))
        return 0
    if len(args.trees) != 2:
        ap.error("give the BEFORE and AFTER directories")
    before, after = (str(Path(t).resolve()) for t in args.trees)
    _build_all([before, after])
    turns = []
    for tree in (before, after, after, before):
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run([sys.executable, __file__, "--one", tree]
                              + ["--kernels-only"] * args.kernels_only
                              + ["--large-n"] * args.large_n
                              + ["--core-only"] * args.core_only
                              + ["--loglik"] * args.loglik, env=env,
                              cwd=tree, capture_output=True, text=True)
        sys.stdout.write(proc.stdout.rsplit("\n", 2)[0] + "\n")
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"the turn of {tree} failed")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    if args.large_n and not args.kernels_only:
        agree = _pinned_agreement(before, after)
        print(f"pinned bf16, 3 iterations: amari(W_after, inv(W_before)) = {agree}")
        turns.append({"pinned_bf16_amari_after_vs_before": agree})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(turns, indent=1))
    print(json.dumps(turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
