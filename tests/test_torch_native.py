"""The port's native runtime (``picard_ica_tpu_torch.native``) on the CPU.

* The reference-RNG draw: bit for bit the port's pure-Python sampler and
  the JAX package's C++ twin, across ChaCha block edges and tail draws.
* The LCG data stream: states and values bit for bit the JAX package's
  native build in one process (same source, same flags, same CPU);
  against the port's NumPy closed form the states bit for bit and the
  values within rtol 1e-13 (NumPy's log against libm's, 1 ulp).
* The f64 oracle: bit-level agreement with the JAX package's oracle on
  the same inputs (iterations and ``converged`` equal, W within 1e-12
  relative: the OpenMP reductions sum in the same order under one
  ``OMP_NUM_THREADS``), and the port's f64 ``Picard.fit`` against the
  port's own oracle to Amari < 1e-9 with the iteration fork that
  ``tests/test_native.py`` allows (<= 2 ortho, <= 8 non-ortho).
* ``Picard.fit`` without a ``w_init`` draws through the native library,
  the build is atomic across processes, and a failed build raises.

Every test skips only when no C++ compiler is on the PATH; with one, a
build that fails fails them.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import picard_ica_tpu as J
import picard_ica_tpu_torch as P
from picard_ica_tpu import native as jnative
from picard_ica_tpu_torch import native
from picard_ica_tpu_torch.ops.densities import Cube, Exp, Tanh
from picard_ica_tpu_torch.ops.linalg import sym_decorrelation_with_mineig
from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data
from picard_ica_tpu_torch.utils import datagen as tdg
from picard_ica_tpu_torch.utils import reference_rng as trng

pytestmark = pytest.mark.skipif(shutil.which(native.CXX) is None,
                                reason="no C++ compiler to build the native library")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 42, 2**63 + 5, 2**64 - 1)
SHAPES = ((1, 1), (7, 9), (64, 64), (257, 3))
COUNTS = (1, 1000, 1_000_003)
DENSITIES = ("tanh", "exp", "cube")
# (density, ortho, extended): every density in both modes, extended (the
# bench mixture is super-Gaussian, so cube needs the sign flips), and
# tanh without the extended rule too.
CORE_CASES = tuple((d, o, True) for d in DENSITIES for o in (True, False)) + (
    ("tanh", True, False), ("tanh", False, False))


def _jax_native():
    assert jnative.available(), "the JAX package's native library did not build"
    return jnative


def test_available_builds_the_library():
    assert native.available()
    path, seconds = native.build()
    assert path.exists() and seconds == 0.0
    assert path.parent == native.library_path().parent
    assert path.name.startswith("libpicard_native_")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_draw_bitwise(seed, shape):
    got = native.reference_normal_matrix(seed, *shape)
    assert got.shape == shape and got.dtype == np.float64
    np.testing.assert_array_equal(got, trng.normal_matrix_plain(seed, *shape))
    np.testing.assert_array_equal(got, _jax_native().reference_normal_matrix(seed, *shape))
    np.testing.assert_array_equal(trng.normal_matrix(seed, *shape), got)


@pytest.mark.parametrize("seed", (0, 2**64 - 1))
def test_u64_stream_bitwise(seed):
    got = native.reference_u64_stream(seed, 10_000)
    rng = trng.StdRng(seed)
    plain = np.array([rng.next_u64() for _ in range(10_000)], np.uint64)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _jax_native().reference_u64_stream(seed, 10_000))


@pytest.mark.parametrize("count", COUNTS)
def test_lcg_laplace_against_jax_and_numpy(count):
    seed = 42 + count
    values, state = native.lcg_laplace(seed, count)
    j_values, j_state = _jax_native().lcg_laplace(seed, count)
    assert state == j_state
    np.testing.assert_array_equal(values, j_values)
    p_values, p_state = tdg._lcg_laplace(seed, count)
    assert state == p_state == tdg._lcg_jump(seed, count)
    np.testing.assert_allclose(values, p_values, rtol=1e-13, atol=0)


@pytest.mark.parametrize("count", COUNTS)
def test_lcg_uniform_centered_against_jax_and_numpy(count):
    seed = 7 + count
    values, state = native.lcg_uniform_centered(seed, count)
    j_values, j_state = _jax_native().lcg_uniform_centered(seed, count)
    assert state == j_state
    np.testing.assert_array_equal(values, j_values)
    states, p_state = tdg._lcg_stream(seed, count)
    assert state == p_state
    # 31 bits over 2^31, less one half: exact in f64 either way.
    np.testing.assert_array_equal(values, tdg._lcg_uniform(states) - 0.5)


def test_bench_data_and_mixing_against_the_plain_version():
    n, t = 5, 4001
    x = tdg.generate_bench_data(n, t, 9)
    np.testing.assert_allclose(x, tdg.generate_bench_data_plain(n, t, 9), rtol=1e-13, atol=1e-13)
    state = tdg._lcg_jump(9, n * t)
    states, _ = tdg._lcg_stream(state, n * n)
    np.testing.assert_array_equal(tdg.reference_mixing_matrix(n, t, 9),
                                  (tdg._lcg_uniform(states) - 0.5).reshape(n, n))


@pytest.fixture(scope="module", params=((8, 2000), (5, 3000)), ids=("8x2000", "5x3000"))
def whitened(request):
    """One f64 mixture a shape, centered and whitened by both oracles,
    which must agree bit for bit."""
    n, t = request.param
    x = tdg.generate_bench_data(n, t, seed=n)
    xc, mean = native.oracle_center(x)
    jxc, jmean = _jax_native().oracle_center(x)
    np.testing.assert_array_equal(xc, jxc)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_allclose(mean, x.mean(axis=1), rtol=1e-12, atol=1e-14)
    xw, k = native.oracle_whiten(xc, n)
    jxw, jk = _jax_native().oracle_whiten(jxc, n)
    np.testing.assert_array_equal(xw, jxw)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_allclose(xw @ xw.T / t, np.eye(n), atol=1e-10)
    return x, xw, k


def _close(a, b, rel=1e-12):
    assert np.max(np.abs(a - b)) <= rel * np.max(np.abs(b)), np.max(np.abs(a - b))


def test_oracle_center_whiten_match_jax(whitened):
    x, xw, k = whitened
    assert xw.shape == x.shape and k.shape == (x.shape[0], x.shape[0])


@pytest.mark.parametrize("density", DENSITIES)
def test_oracle_ica_par_matches_jax(whitened, density):
    _, xw, _ = whitened
    n = xw.shape[0]
    w0 = np.eye(n) + 0.1 * np.random.default_rng(n).standard_normal((n, n))
    got = native.oracle_ica_par(xw, w0, 10, density=density)
    _close(got, _jax_native().oracle_ica_par(xw, w0, 10, density=density))
    np.testing.assert_allclose(got @ got.T, np.eye(n), atol=1e-10)


@pytest.mark.parametrize("density,ortho,extended", CORE_CASES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_oracle_core_matches_jax(whitened, density, ortho, extended):
    _, xw, _ = whitened
    cov = np.eye(xw.shape[0]) if extended else None
    kw = dict(density=density, ortho=ortho, extended=extended, max_iter=200, tol=1e-7)
    got = native.oracle_core(xw, cov, **kw)
    ref = _jax_native().oracle_core(xw, cov, **kw)
    assert got["converged"] and ref["converged"]
    assert got["n_iterations"] == ref["n_iterations"] > 0
    _close(got["w"], ref["w"])
    _close(got["y"], ref["y"])
    np.testing.assert_array_equal(got["signs"], ref["signs"])


def test_oracle_core_rejects_degenerate_params():
    for kw in ({"ls_tries": 0}, {"m": 0}, {"max_iter": -1}):
        with pytest.raises(ValueError):
            native.oracle_core(np.zeros((3, 100)), np.eye(3), **kw)


@pytest.fixture(scope="module")
def mixture():
    _, a, x = generate_mixed_kurtosis_data(8, 20_000, 1)
    return a, x


@pytest.mark.parametrize("ortho", (True, False), ids=("ortho", "nonortho"))
def test_f64_fit_matches_the_ports_oracle(mixture, ortho):
    """The f64 invariant at a matched start: the port's fit (its own
    whitening, the native draw of seed 5) against the port's oracle run
    from the same draw on the oracle's whitening."""
    a, x = mixture
    n, seed = x.shape[0], 5
    r = P.Picard.fit(x, P.PicardConfig(random_state=seed, ortho=ortho, extended=True,
                                       dtype=torch.float64), device="cpu")
    assert r.converged
    xc, _ = native.oracle_center(x)
    xw, k = native.oracle_whiten(xc, n)
    w0, _ = sym_decorrelation_with_mineig(torch.from_numpy(trng.normal_matrix(seed, n, n)))
    w0 = w0.numpy()
    res = native.oracle_core(w0 @ xw, np.eye(n), ortho=ortho, extended=True,
                             max_iter=500, tol=1e-7)
    assert res["converged"]
    oracle_full = res["w"] @ w0 @ k
    ours = r.full_unmixing().numpy()
    assert amari_distance(ours, np.linalg.inv(oracle_full)) < 1e-9
    assert abs(res["n_iterations"] - r.n_iterations) <= (2 if ortho else 8)
    assert amari_distance(ours, a) < 5e-3


def test_fit_draws_w_init_natively(mixture, monkeypatch):
    """With the pure-Python sampler made to raise, a fit without a
    ``w_init`` still runs, and lands where the JAX package's fit of the
    same seed lands (tests/test_torch_solver.py's f64 tolerances)."""
    _, x = mixture

    def refuse(rng):
        raise AssertionError("the fit drew through the pure-Python sampler")

    monkeypatch.setattr(trng, "standard_normal", refuse)
    rt = P.Picard.fit(x, P.PicardConfig(random_state=3, dtype=torch.float64), device="cpu")
    rj = J.Picard.fit(x, J.PicardConfig(random_state=3))
    assert rt.converged and bool(rj.converged)
    assert rt.n_iterations == rj.n_iterations
    np.testing.assert_allclose(rt.full_unmixing().numpy(), np.asarray(rj.full_unmixing()),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("density", (Tanh(), Exp(), Cube()), ids=DENSITIES)
def test_f32_fit_against_the_ports_oracle(density):
    """The conformance check of ``chip_smoke.py`` phase 9c at a CPU size:
    the default f32 fit from W_init = I on the bench mixture, against the
    oracle from the same start, to BASELINE's Amari < 1e-3."""
    n, t = 6, 30_000
    x = tdg.generate_bench_data(n, t, seed=42)
    name = type(density).__name__.lower()
    xc, _ = native.oracle_center(x)
    xw, k = native.oracle_whiten(xc, n)
    res = native.oracle_core(xw, np.eye(n), density=name, max_iter=500, tol=1e-7)
    r = P.Picard.fit(x, P.PicardConfig(density=density, ortho=True, extended=True, tol=1e-7,
                                       max_iter=500, w_init=np.eye(n)), device="cpu")
    assert res["converged"]
    assert amari_distance(r.full_unmixing().double().numpy(),
                          np.linalg.pinv(res["w"] @ k)) < 1e-3


_BUILD_AND_CALL = """
import ctypes, sys
import numpy as np
from picard_ica_tpu_torch import native
path, seconds = native.build(sys.argv[1])
lib = ctypes.CDLL(str(path))
out = np.empty(4, np.uint64)
lib.picard_reference_u64_fill(ctypes.c_uint64(3),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                              ctypes.c_size_t(4))
print(path, seconds, int(out[3]))
"""


def test_two_processes_build_into_a_fresh_directory(tmp_path):
    build_dir = tmp_path / "_build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_CALL, str(build_dir)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    assert lines[0][0] == lines[1][0] == str(native.library_path(build_dir))
    assert lines[0][2] == lines[1][2] == str(int(native.reference_u64_stream(3, 4)[3]))
    # One process built, the other waited for it and loaded its library.
    assert sorted(float(line[1]) > 0 for line in lines) == [False, True]
    assert sorted(f.name for f in build_dir.iterdir()) == [".native.lock",
                                                           native.library_path(build_dir).name]


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(native.SRC / name, src / name)
    (src / "rng.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    with pytest.raises(RuntimeError, match="rng.cpp") as err:
        native.build(tmp_path / "_build")
    assert "error" in str(err.value)
    assert not native.library_path(tmp_path / "_build").exists()


def test_available_is_false_without_a_compiler(monkeypatch):
    monkeypatch.setattr(native, "CXX", "no-such-c++-compiler")
    assert not native.available()
