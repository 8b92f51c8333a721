"""Build and bind the CUDA kernels of ``picard_ica_tpu_torch/csrc``.

Each source is compiled with ``nvcc`` to an object, all at once in
parallel, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library is built at
first use into ``picard_ica_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and the
flags, so an edited source is rebuilt and a current build is reused.
The headers the sources include (``HEADERS``) are hashed with them.
ptxas reports each kernel's registers, spills and shared memory
(``-Xptxas -v``); the report is kept beside the library
(:func:`resource_report`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rotated_fused_tc.cu", "rotated_fused_wgmma.cu", "covariance_sums.cu",
           "streaming_fused_tc.cu")
HEADERS = ("density.cuh", "mma_tiers.cuh", "hopper_async.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double

# argtypes of every C entry; every pointer and the stream are c_void_p.
_SIGNATURES = {
    "picard_max_n": [],
    "picard_cols_per_block": [],
    "picard_error_string": [_I],
    "picard_rotated_fused_sums": [
        _I, _I, _I, _I, _I, _I, _D, _I, _LL, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _P,
    ],
    "picard_core_wgmma_pair": [_I, _I, _I, _I, _I],
    "picard_rotated_fused_wgmma": [
        _I, _I, _I, _I, _I, _I, _D, _I, _LL, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _P,
    ],
    "picard_rotated_moments_sums": [
        _I, _I, _I, _I, _D, _I, _LL, _I, _P, _P, _P, _P, _P, _P, _LL, _I, _P,
    ],
    "picard_rotated_loglik_sums": [
        _I, _I, _I, _D, _I, _LL, _I, _P, _P, _P, _P, _LL, _I, _P,
    ],
    "picard_cov_chunk": [],
    "picard_row_sums": [_I, _LL, _P, _P, _I, _P, _P],
    "picard_covariance_sums": [_I, _LL, _P, _P, _I, _P, _I, _P, _P],
    "picard_fold_pairwise": [_I, _LL, _P, _P, _P],
    "picard_stream_max_n": [],
    "picard_stream_tc_tile": [],
    "picard_stream_tc_kc": [],
    "picard_stream_wgmma_ks": [],
    "picard_stream_wgmma_pair": [_I, _I, _I, _I],
    "picard_streaming_fused_tc": [
        _I, _I, _I, _I, _I, _I, _I, _D, _I, _LL, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _P,
    ],
    "picard_streaming_loglik_tc": [
        _I, _I, _I, _D, _I, _LL, _I, _I, _P, _P, _P, _P, _LL, _P,
    ],
    "picard_stream_contract_tc": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _LL, _P],
}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def source_digest(files, flags) -> str:
    """16 hex digits of a SHA-256 over each file's name and bytes and
    the flags: the key of a library built from them."""
    h = hashlib.sha256()
    for f in map(Path, files):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = source_digest([CSRC / name for name in SOURCES + HEADERS], NVCC_FLAGS)
    return BUILD_DIR / f"libpicard_kernels_{digest}.so"


def _check(cmd, proc, stdout, stderr) -> None:
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed (exit %d): %s\n%s\n%s"
            % (proc.returncode, " ".join(cmd), stdout, stderr)
        )


def build() -> tuple:
    """Compile the library if it is missing. Returns ``(path, seconds)``
    with ``seconds`` 0.0 when an existing build was reused; a failed
    build raises with the compiler's output."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]
        report = []
        try:
            for src, cmd, proc in zip(SOURCES, cmds, procs):
                out, err = proc.communicate()
                _check(cmd, proc, out, err)
                report.append(f"== {src}\n{err}")
        finally:
            for proc in procs:  # a failed build leaves no compiler running
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, proc, proc.stdout, proc.stderr)
        _report_path(path).write_text("".join(report))
        os.replace(lib, path)
    return path, time.perf_counter() - t0


def _report_path(path: Path) -> Path:
    return path.with_suffix(".ptxas.txt")


def resource_report() -> dict:
    """ptxas's report of the current build, per source: a list of
    ``(kernel, registers, spill store bytes, spill load bytes)``, kernel
    names as mangled."""
    text = _report_path(library_path()).read_text()
    usage, src, kernel, spills = {}, None, None, (0, 0)
    for line in text.splitlines():
        if line.startswith("== "):
            src = line[3:]
            usage[src] = []
        elif "Function properties for" in line:
            kernel = line.rsplit(" ", 1)[-1]
        elif "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])
        elif "Used" in line and "registers" in line and kernel:
            words = line.split()
            usage[src].append((kernel, int(words[words.index("Used") + 1]), *spills))
            kernel, spills = None, (0, 0)
    return usage


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry's
    ``argtypes`` and ``restype`` declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_char_p if name == "picard_error_string" else _I
    return lib
