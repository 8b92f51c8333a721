"""The port's native (C++) runtime, built with g++ and bound with ctypes.

Three sources in ``src/``:

* ``rng.cpp`` — the reference's ``StdRng::seed_from_u64`` stream
  (ChaCha12) and its ziggurat ``StandardNormal`` sampler
  (solver.rs:57-60, 112-120): the random ``w_init`` draw of every fit
  without a ``w_init`` (:func:`reference_normal_matrix`), bit for bit the
  pure-Python sampler ``utils.reference_rng.normal_matrix_plain``;
* ``datagen.cpp`` — the reference harness's LCG Laplace stream and its
  uniform(-0.5, 0.5) mixing matrix (benches/benchmarks.rs:8-35),
  OpenMP-parallel with O(log k) LCG jumps (:func:`lcg_laplace`,
  :func:`lcg_uniform_centered`), which ``utils.datagen`` fills through;
* ``oracle.cpp`` — an independent f64 implementation of the whole
  algorithm (centering, whitening, the core loop, the FastICA warm
  start): the ground truth the solver's fits are held against
  (BASELINE.md: Amari < 1e-3 against the reference on the bench
  mixtures; in f64 the core matches it to Amari < 1e-9).

All of it runs on the host on NumPy f64 arrays, also where the fit runs
on the GPU: the draw and the data stream are host work, and the oracle
is a CPU f64 reference by design.

The library is compiled with g++ alone (no CUDA toolkit) at first use
into ``picard_ica_tpu_torch/_build/`` (listed in ``.gitignore``), under
a name keyed by a hash of the sources and the flags. It is built in a
temporary directory under a file lock and moved into place with
``os.replace``, so processes that build at once each load a whole
library. A failed build raises with the compiler's output: nothing
falls back to Python.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR, source_digest

SRC = Path(__file__).resolve().parent / "src"
SOURCES = ("datagen.cpp", "oracle.cpp", "rng.cpp")
CXX = "g++"
BASE_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-fopenmp", "-fPIC", "-std=c++17")
# rng.cpp must stay bit-identical to the pure-Python sampler in
# utils/reference_rng.py: FMA contraction (on by default at -O3) would
# fork its ziggurat rejection decisions.
PER_FILE_FLAGS = {"rng.cpp": ("-ffp-contract=off",)}
LINK_FLAGS = ("-shared", "-lmvec")
# Seconds one compiler process may take.
COMPILE_TIMEOUT_S = 600

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)
_U64 = ctypes.c_uint64
_SIZE = ctypes.c_size_t
_INT = ctypes.c_int
_DBL = ctypes.c_double

# (restype, argtypes) of every C entry.
_SIGNATURES = {
    "picard_lcg_laplace_fill": (_U64, [_U64, _D, _SIZE]),
    "picard_lcg_uniform_centered_fill": (_U64, [_U64, _D, _SIZE]),
    "picard_oracle_core": (_INT, [
        _D, _INT, _INT, _D,              # x, n, t, cov
        _INT, _DBL,                      # density, alpha
        _INT, _INT,                      # ortho, extended
        _INT, _DBL, _INT,                # max_iter, tol, m
        _INT, _DBL,                      # ls_tries, lambda_min
        _D, _D, _D, _I, _I, _D,          # outputs
    ]),
    "picard_oracle_center": (None, [_D, _INT, _INT, _D]),
    "picard_oracle_whiten": (_INT, [_D, _INT, _INT, _INT, _D, _D]),
    "picard_oracle_ica_par": (_INT, [_D, _INT, _INT, _INT, _DBL, _INT, _D]),
    "picard_reference_normal_fill": (None, [_U64, _D, _SIZE]),
    "picard_reference_u64_fill": (None, [_U64, ctypes.POINTER(ctypes.c_uint64), _SIZE]),
}


def _flags() -> list:
    return [*BASE_FLAGS, *(f"{name}:{' '.join(flags)}" for name, flags in PER_FILE_FLAGS.items()),
            *LINK_FLAGS]


def library_path(build_dir=None) -> Path:
    """Where the library for the current sources and flags lives."""
    digest = source_digest([SRC / name for name in SOURCES], _flags())
    return Path(build_dir or BUILD_DIR) / f"libpicard_native_{digest}.so"


def _run(cmds) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate(timeout=COMPILE_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError("%s failed (exit %d): %s\n%s\n%s" % (
                    CXX, proc.returncode, " ".join(cmd), out, err))
    finally:
        for proc in procs:  # a failed build leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build(build_dir=None) -> tuple:
    """Compile the library if it is missing. Returns ``(path, seconds)``
    with ``seconds`` 0.0 when an existing build was reused; a failed
    build raises with the compiler's output."""
    path = library_path(build_dir)
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(path.parent / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if path.exists():
            return path, 0.0
        with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
            objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
            _run([[CXX, *BASE_FLAGS, *PER_FILE_FLAGS.get(s, ()), "-c", str(SRC / s), "-o", o]
                  for s, o in zip(SOURCES, objs)])
            lib = os.path.join(tmp, "lib.so")
            _run([[CXX, *BASE_FLAGS, "-o", lib, *objs, *LINK_FLAGS]])
            os.replace(lib, path)
    return path, time.perf_counter() - t0


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry's
    ``argtypes`` and ``restype`` declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """False when no C++ compiler is on the PATH; otherwise builds and
    loads the library (a failed build raises) and returns True."""
    if shutil.which(CXX) is None:
        return False
    load()
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def lcg_laplace(seed: int, count: int) -> tuple:
    """The LCG Laplace stream seeded at ``seed``: ``(samples, next_state)``."""
    out = np.empty(count, np.float64)
    state = load().picard_lcg_laplace_fill(_U64(seed), _ptr(out), _SIZE(count))
    return out, int(state)


def lcg_uniform_centered(seed: int, count: int) -> tuple:
    """The uniform(-0.5, 0.5) stream seeded at ``seed``:
    ``(samples, next_state)``."""
    out = np.empty(count, np.float64)
    state = load().picard_lcg_uniform_centered_fill(_U64(seed), _ptr(out), _SIZE(count))
    return out, int(state)


def reference_normal_matrix(seed: int, n_rows: int, n_cols: int) -> np.ndarray:
    """Row-major StandardNormal fill from ``StdRng::seed_from_u64(seed)``:
    the reference's random W-init stream (solver.rs:112-120)."""
    out = np.empty(n_rows * n_cols, np.float64)
    load().picard_reference_normal_fill(_U64(seed), _ptr(out), _SIZE(out.size))
    return out.reshape(n_rows, n_cols)


def reference_u64_stream(seed: int, count: int) -> np.ndarray:
    """The raw ``StdRng`` u64 stream (the ChaCha12 layer alone)."""
    out = np.empty(count, np.uint64)
    load().picard_reference_u64_fill(
        _U64(seed), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), _SIZE(count))
    return out


_DENSITY_CODE = {"tanh": 0, "exp": 1, "cube": 2}


def oracle_core(
    x: np.ndarray,
    covariance: Optional[np.ndarray],
    density: str = "tanh",
    alpha: float = 1.0,
    ortho: bool = True,
    extended: bool = True,
    max_iter: int = 500,
    tol: float = 1e-7,
    m: int = 7,
    ls_tries: int = 10,
    lambda_min: float = 0.01,
) -> dict:
    """Run the f64 oracle core loop on pre-rotated data ``x`` (n, t)."""
    if ls_tries < 1 or m < 1 or max_iter < 0:
        # The C side does not validate: ls_tries <= 0 would move
        # default-constructed 0x0 matrices into the optimizer state and
        # return uninitialized buffers with rc=0.
        raise ValueError(
            f"ls_tries ({ls_tries}) and m ({m}) must be >= 1, "
            f"max_iter ({max_iter}) >= 0"
        )
    lib = load()
    x = np.ascontiguousarray(x, np.float64)
    n, t = x.shape
    cov_ptr = None
    if covariance is not None:
        covariance = np.ascontiguousarray(covariance, np.float64)
        cov_ptr = _ptr(covariance)
    w = np.empty((n, n), np.float64)
    y = np.empty((n, t), np.float64)
    signs = np.empty(n, np.float64)
    n_iter = ctypes.c_int(0)
    converged = ctypes.c_int(0)
    gnorm = ctypes.c_double(0.0)
    rc = lib.picard_oracle_core(
        _ptr(x), n, t, cov_ptr,
        _DENSITY_CODE[density], alpha,
        int(ortho), int(extended),
        max_iter, tol, m, ls_tries, lambda_min,
        _ptr(w), _ptr(y), _ptr(signs),
        ctypes.byref(n_iter), ctypes.byref(converged), ctypes.byref(gnorm),
    )
    if rc != 0:
        raise RuntimeError(f"oracle core failed with code {rc}")
    return {
        "w": w, "y": y, "signs": signs,
        "n_iterations": n_iter.value,
        "converged": bool(converged.value),
        "gradient_norm": gnorm.value,
    }


def oracle_center(x: np.ndarray) -> tuple:
    """(centered, mean) via the native oracle."""
    x = np.ascontiguousarray(x, np.float64).copy()
    n, t = x.shape
    mean = np.empty(n, np.float64)
    load().picard_oracle_center(_ptr(x), n, t, _ptr(mean))
    return x, mean


def oracle_whiten(x: np.ndarray, n_components: int) -> tuple:
    """(whitened_data, K) via the native oracle; raises on singular."""
    x = np.ascontiguousarray(x, np.float64)
    n, t = x.shape
    k = np.empty((n_components, n), np.float64)
    data = np.empty((n_components, t), np.float64)
    rc = load().picard_oracle_whiten(_ptr(x), n, t, n_components, _ptr(k), _ptr(data))
    if rc != 0:
        raise RuntimeError("oracle whitening hit singular data")
    return data, k


def oracle_ica_par(
    x: np.ndarray, w_init: np.ndarray, n_iter: int,
    density: str = "tanh", alpha: float = 1.0,
) -> np.ndarray:
    """FastICA warm start via the native oracle."""
    x = np.ascontiguousarray(x, np.float64)
    n, t = x.shape
    w = np.ascontiguousarray(w_init, np.float64).copy()
    rc = load().picard_oracle_ica_par(
        _ptr(x), n, t, _DENSITY_CODE[density], alpha, n_iter, _ptr(w)
    )
    if rc != 0:
        raise RuntimeError("oracle FastICA hit a singular decorrelation")
    return w
