"""Stage lengths of the port against the JAX package, on the CPU, path
against matched path.

    python tests/stage_lengths_vs_jax.py [N T [MAX_ITER [SEED [JADE_IT]]]]

Fits ``generate_mixed_kurtosis_data(N, T, SEED)`` (default 128 x
200,000, seed 7, float64 NumPy) with ``random_state=0`` at tol 1e-7 in both
packages, which whiten it the same way (host f64) and draw the same
w_init (with ``JADE_IT`` > 0 both warm-start from JADE instead), in two
pairs of matched paths:

  * kernels: the port with ``use_kernels=True, device="cpu"`` (the
    kernels' plain versions; the bf16 stage reads a bf16 copy of X)
    against the JAX package with ``use_pallas=True`` (its Pallas kernels
    in interpret mode, the same bf16 copy);
  * torch: the port with ``use_kernels=False`` against the JAX package's
    XLA path, ``use_pallas=False``; both read f32 X in every stage. On the
    CPU the XLA path's bf16x3 tier is exact f32 (``Precision.HIGH``),
    where the port's torch path runs the hi/lo split.

The JAX package runs with ``dtype=float32`` and x64 enabled, as its own
tests run it. Prints each fit's iterations, stage exits and line-search
passes, Amari distances, the bf16x3 stage's stall (where the gradient
norm first nears the floor, its last 1 % improvement, which restarts the
10-iteration stall count, and the floor's median), and each fit's
gradient norm at every iteration (``verbose``). Not a test: it takes
minutes.
"""

import contextlib
import io
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import picard_ica_tpu as J  # noqa: E402
import picard_ica_tpu_torch as P  # noqa: E402
from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data  # noqa: E402

_GNORM = re.compile(r"iteration (\d+), gradient norm = ([0-9.e+-]+)")
# (pair, the port's use_kernels, the JAX package's use_pallas)
PAIRS = (("kernels", True, True), ("torch", False, False))


def _fit_logged(fit):
    """(result, seconds, [(iteration, gradient norm)]) of one verbose fit."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        r = fit()
        jax.effects_barrier()
    seconds = time.perf_counter() - t0
    return r, seconds, [(int(i), float(g)) for i, g in _GNORM.findall(buf.getvalue())]


def _plateau(trace, exits, tol=4e-7):
    """The bf16x3 stage's stall: (first iteration near the floor, last
    1 % improvement of the stage's best gradient norm, stage exit,
    median gradient norm from the first near the floor to the exit).
    "Near" is the stall rule's 20 x the stage's hand-off tolerance. The
    stage logs iterations exits[0] to exits[1] - 1: the iteration that
    ends a stage is logged by the next one, at its tier."""
    if len(exits) < 2:
        return None, None, None, float("nan")
    start, end = int(exits[0]), int(exits[1])
    stage = [(i, g) for i, g in trace if start <= i < end]
    best, last = float("inf"), None
    for i, g in stage:
        if g < best * 0.99:
            last = i
        best = min(best, g)
    near = [i for i, g in stage if g < 20 * tol]
    first = near[0] if near else None
    floor = [g for i, g in stage if first is not None and i >= first]
    return first, last, end, float(np.median(floor)) if floor else float("nan")


def compare(x, a, pair, use_kernels, use_pallas, max_iter=200, jade_it=0):
    """One matched pair's fits of ``x``; prints the comparison."""
    common = dict(random_state=0, tol=1e-7, max_iter=max_iter, verbose=True)
    if jade_it:
        common["jade_it"] = jade_it
    rt, st, gt = _fit_logged(lambda: P.Picard.fit(
        x, P.PicardConfig(use_kernels=use_kernels, **common), device="cpu"))
    rj, sj, gj = _fit_logged(lambda: J.Picard.fit(
        x, J.PicardConfig(use_pallas=use_pallas, dtype=jnp.float32, **common)))
    print(f"{pair} pair: port use_kernels={use_kernels}, jax use_pallas={use_pallas}")
    for name, r, s in (("port", rt, st), ("jax", rj, sj)):
        print(f"  {name}: {int(r.n_iterations)} iterations, exits "
              f"{tuple(int(v) for v in r.stage_exits)}, {int(r.ls_calls)} passes (by stage "
              f"{tuple(int(v) for v in r.stage_ls_calls)}), converged {bool(r.converged)}, "
              f"gradient norm {float(r.gradient_norm):.4e}, {s:.1f} s on the CPU")
    wt = rt.full_unmixing().double().numpy()
    wj = np.asarray(rj.full_unmixing(), np.float64)
    print(f"  amari to the mixing: port {amari_distance(wt, a):.4e}, jax "
          f"{amari_distance(wj, a):.4e}; between the fits "
          f"{amari_distance(wt, np.linalg.inv(wj)):.4e}")
    for name, r, trace in (("port", rt, gt), ("jax", rj, gj)):
        first, last, end, floor = _plateau(trace, r.stage_exits)
        print(f"  {name} bf16x3 stall: near the floor from {first}, last 1 % improvement "
              f"at {last}, exit at {end}; median gradient norm there {floor:.3e}")
    for name, trace in (("port", gt), ("jax", gj)):
        print(f"  {name} gradient norms:", " ".join(f"{i}:{g:.3e}" for i, g in trace))


def main(n=128, t=200_000, max_iter=200, seed=7, jade_it=0):
    _, a, x = generate_mixed_kurtosis_data(n, t, seed)
    print(f"data seed {seed}, {n} x {t}" + (f", JADE({jade_it})" if jade_it else ""))
    for pair, use_kernels, use_pallas in PAIRS:
        compare(x, a, pair, use_kernels, use_pallas, max_iter, jade_it)


if __name__ == "__main__":
    main(*(int(v) for v in sys.argv[1:]))
