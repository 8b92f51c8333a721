"""Time two trees of the PyTorch + CUDA port in turns on one NVIDIA GPU.

    python3 port_turns.py BEFORE_DIR AFTER_DIR [--out FILE]

Each directory holds a ``picard_ica_tpu_torch`` package (a checkout, or
``git archive <commit> picard_ica_tpu_torch`` unpacked). Both libraries
are built first, side by side. Then four turns, each in a process of its
own that imports only its tree's package, in the order before, after,
after, before; each turn measures, with ``chip_smoke.py``'s helpers:

  * ``rotated_fused_sums`` at 64 x 2,000,000 (Laplace X, seed 0) in the
    three cases of the default fit's stages: plain bf16 on bf16 X, delta
    bf16x3, delta f32 (H and Y^2 off), each one synchronised call at a
    time (median of 10) and 10 calls back to back (median of 5); and
    delta f32 at ``chip_smoke.py``'s ragged shapes (17 and 63 rows,
    1,000,003 columns);
  * ``chip_smoke.py``'s phase-3 fit (64 x 2,000,000 mixed mixture, f64
    NumPy input) and phase-4 fits (the bench 64 x 4,000,000 made on the
    card) at the default staged schedule and in the exact f32 tier: core
    seconds, iterations, stage exits, and the fused pass's launches by
    tier (counted here the same way for both trees, by the tier of the
    contractions), after warm-up fits on a small mixture.

Every line of output names the tree; the last line is a JSON list of the
four turns, also written to ``--out`` (default
``chiprun_out/turns.json``). Needs one CUDA card and nvcc.
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
RAGGED_F32_ROWS = (17, 63)


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


def one_turn(tree: str) -> dict:
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
    del x, x16
    torch.cuda.empty_cache()
    for n in RAGGED_F32_ROWS:
        xr, mr_old, mr_new = sm._stream_inputs(n, sm.T_RAGGED, n)
        label = f"delta f32, {n} x {sm.T_RAGGED}"
        ms, ms_stream = sm._time_both(lambda: K.rotated_fused_sums(
            mr_new, mr_old, xr, Tanh(), False, False, "f32", False))
        turn["kernel"][label] = {"ms": ms, "ms_stream": ms_stream}
        sm._log(f"[{tree}] rotated_fused_sums [{label}]: {sm._fmt_pair((ms, ms_stream))}")
        del xr
    torch.cuda.empty_cache()

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
    return turn


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
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "turns.json"))
    args = ap.parse_args(argv)
    if args.one:
        # Only the turn's tree provides the package, not this script's.
        sys.path[:] = [args.one] + [p for p in sys.path if p and Path(p).resolve() != HERE]
        print(json.dumps(one_turn(args.one)))
        return 0
    if len(args.trees) != 2:
        ap.error("give the BEFORE and AFTER directories")
    before, after = (str(Path(t).resolve()) for t in args.trees)
    _build_all([before, after])
    turns = []
    for tree in (before, after, after, before):
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run([sys.executable, __file__, "--one", tree], env=env,
                              cwd=tree, capture_output=True, text=True)
        sys.stdout.write(proc.stdout.rsplit("\n", 2)[0] + "\n")
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"the turn of {tree} failed")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(turns, indent=1))
    print(json.dumps(turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
