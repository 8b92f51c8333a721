"""Device whitening of the port against the JAX package's, on the CPU.

The same NumPy inputs, made from a seed, go through the JAX package and
through the port:
  * the plain versions of the whitening kernels against the Pallas
    kernels in interpret mode (``row_sums``, ``covariance_sums``,
    ``centered_covariance_sums``, ``_grouped_covariance``). f64 to 1e-12
    of each output's scale (per-chunk partials in another partition and
    order); f32 to 2e-6 of scale, the bound of the JAX package's
    ``test_chunked_f32_covariance_accuracy``;
  * ``center`` / ``whiten`` / ``center_whiten`` on the CPU, where both
    packages take their chunked f32 route: mean rtol 1e-6, K rtol 1e-5 /
    atol 1e-6, whitened data 1e-4 (tests/test_whitening.py:146-181); f64
    to 1e-12. The rows have well-separated variances: K's eigenvectors
    amplify f32 summation-order differences by 1/eigengap;
  * ``Picard.fit`` on f32 NumPy input and on a CPU tensor against the
    JAX fit of the same f32 array: both converge, Amari between the two
    unmixings < 1e-4 (two f32 staged trajectories to tol 1e-7 from
    whitenings that agree to ~1e-6);
  * the projection ``K (X - mean)``, written a column block at a time,
    against the JAX package's one product (several blocks and a ragged
    one, ``ROTATE_BLOCK_T`` patched small), and the bytes it holds: x1
    and one centered block;
  * ``Picard.transform`` of a JAX device-whitened result;
  * the reference LCG's mixing block, bit for bit.
The refinement step is checked on its own against the whiteness bounds
of tests/test_whitening.py:374-408.
"""

import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

import picard_ica_tpu as J
import picard_ica_tpu_torch as P
from picard_ica_tpu.ops import pallas_kernels as pk
from picard_ica_tpu.ops import whitening as jw
from picard_ica_tpu.utils import datagen as jdg
from picard_ica_tpu_torch import convert
from picard_ica_tpu_torch.ops import kernels as K
from picard_ica_tpu_torch.ops import linalg
from picard_ica_tpu_torch.ops import whitening as tw
from picard_ica_tpu_torch.ops.linalg import rotate_rows_inplace
from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data
from picard_ica_tpu_torch.utils import datagen as tdg

torch.set_num_threads(2)

TOL = {"f64": 1e-12, "f32": 2e-6}
DTYPES = {"f64": np.float64, "f32": np.float32}


def _data(n, t, seed, dtype, scales=None):
    """Laplace rows around 1.5 (times ``scales``), and a mean near it."""
    rng = np.random.default_rng(seed)
    x = rng.laplace(size=(n, t))
    if scales is not None:
        x *= np.asarray(scales)[:, None]
    mean = 1.5 + 0.1 * rng.standard_normal(n)
    return (x + 1.5).astype(dtype), mean.astype(dtype)


# Row scales whose variances are far apart: the relative eigengaps of the
# covariance are >= 0.3, so K compares the two implementations rather
# than the 1/eigengap amplification of f32 summation order (which the
# refinement test below meets on an ill-conditioned mixture).
SEPARATED = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0)


def _close_to_scale(ours, ref, tol):
    ref = np.asarray(ref, np.float64)
    ours = ours.double().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * np.abs(ref).max())


# (port's plain version, the Pallas kernel), both called on (x, mean).
PLAIN_VS_PALLAS = {
    "row_sums": (lambda x, m: K.row_sums_plain(x),
                 lambda x, m: pk.row_sums(x, interpret=True)),
    "covariance_sums": (lambda x, m: K.covariance_sums_plain(x),
                        lambda x, m: pk.covariance_sums(x, interpret=True)),
    "centered_covariance_sums": (
        K.centered_covariance_sums_plain,
        lambda x, m: pk.centered_covariance_sums(x, m, interpret=True)),
    "grouped_centered": (K.grouped_covariance_plain,
                         lambda x, m: pk._grouped_covariance(x, m, True)),
    "grouped": (lambda x, m: K.grouped_covariance_plain(x, None),
                lambda x, m: pk._grouped_covariance(x, None, True)),
}


# (N, T): the ragged and alignment edges the kernels' load paths split on
# (T % 4 in {0, 1, 2, 3}; one column, one chunk less or more than 2,048,
# two chunks and a tail) at one row, 6 rows and one row past a 64-row
# output tile.
PLAIN_SHAPES = [(6, 255), (6, 1000), (6, 5000), (6, 1), (6, 3), (6, 2047), (6, 2049),
                (6, 4097), (6, 4098), (1, 1), (1, 2049), (1, 4098), (65, 3), (65, 2047),
                (65, 4097)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,t", PLAIN_SHAPES)
@pytest.mark.parametrize("kernel", list(PLAIN_VS_PALLAS))
def test_plain_versions_match_pallas(kernel, n, t, dtype):
    x, mean = _data(n, t, 3, DTYPES[dtype])
    ours, theirs = PLAIN_VS_PALLAS[kernel]
    out = ours(torch.from_numpy(x), torch.from_numpy(mean))
    assert out.dtype == torch.from_numpy(x).dtype
    _close_to_scale(out, theirs(jnp.asarray(x), jnp.asarray(mean)), TOL[dtype])


# Partial counts: a single one, every parity of the rounds, the 31 groups
# of the 600 x 1M grouped covariance and the 1,954 chunks of 4M columns.
FOLD_PARTS = [1, 2, 3, 4, 5, 7, 8, 31, 33, 1954]


@pytest.mark.parametrize("shape", [(5,), (3, 3)], ids=str)
@pytest.mark.parametrize("n_parts", FOLD_PARTS)
def test_fold_order_matches_fold_pairwise_and_jax(n_parts, shape):
    """The fold of the whitening kernels' partials (on the CPU its plain
    version, fold_pairwise, whose order the fold kernel keeps bit for
    bit) adds in the JAX package's _reduce_partials order on f32
    partials."""
    from picard_ica_tpu_torch.ops.moments import fold_pairwise

    p = np.random.default_rng(n_parts).standard_normal((n_parts, *shape)).astype(np.float32)
    p *= np.float32(1e3)
    want = fold_pairwise(torch.from_numpy(p.copy()))
    got = K.fold_partials(torch.from_numpy(p.copy()))
    assert got.shape == shape and torch.equal(got, want)
    theirs = np.asarray(pk._reduce_partials(jnp.asarray(p), jnp.float32))
    np.testing.assert_array_equal(got.numpy(), theirs)


def test_cpu_whitening_wrappers_run_plain_and_count_nothing():
    """On the CPU the wrappers run the plain versions, including the
    grouped hand-off above N = 512, and launch nothing."""
    K.reset_launch_counts()
    x, mean = _data(520, 300, 4, np.float32)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mean)
    assert torch.equal(K.covariance_sums(xt), K.grouped_covariance_plain(xt))
    assert torch.equal(K.centered_covariance_sums(xt, mt), K.grouped_covariance_plain(xt, mt))
    assert torch.equal(K.row_sums(xt), K.row_sums_plain(xt))
    assert all(k.launches == 0 for k in K.KERNELS)


@pytest.mark.parametrize("t", [1000, 4000, 100_000])
def test_chunk_length_and_routing(t):
    assert tw._chunk_len(t) == jw._chunk_len(t)
    x32 = torch.zeros((2, t), dtype=torch.float32)
    assert tw._impl_for(x32) == ("plain" if t <= 2048 else "chunked")
    assert tw._impl_for(x32.double()) == "plain"


@pytest.mark.parametrize("whiten_flag", [True, False], ids=["whiten", "no-whiten"])
@pytest.mark.parametrize("centering", [True, False], ids=["center", "no-center"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_center_whiten_matches_jax(dtype, centering, whiten_flag):
    x, _ = _data(6, 4000, 21, DTYPES[dtype], SEPARATED)
    xt = torch.from_numpy(x)
    x1, mean, k = tw.center_whiten(xt, 6, centering, whiten_flag)
    jx1, jmean, jk = jw.center_whiten(jnp.asarray(x), 6, centering, whiten_flag)
    assert (mean is None) == (jmean is None) and (k is None) == (jk is None)
    if dtype == "f64":
        tol = dict(rtol=1e-12, atol=1e-12)
        tol_mean, tol_k, tol_x1 = tol, tol, tol
    else:
        tol_mean = dict(rtol=1e-6)
        tol_k = dict(rtol=1e-5, atol=1e-6)
        tol_x1 = dict(rtol=1e-4, atol=1e-4)
    if mean is not None:
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **tol_mean)
    if k is not None:
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **tol_k)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), **tol_x1)
    assert x1.dtype == xt.dtype
    np.testing.assert_array_equal(xt.numpy(), x)  # the input is not written


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_center_and_whiten_match_jax(dtype):
    x, _ = _data(5, 3000, 22, DTYPES[dtype], SEPARATED[:5])
    xc, mean = tw.center(torch.from_numpy(x))
    jxc, jmean = jw.center(jnp.asarray(x))
    rtol = 1e-12 if dtype == "f64" else 1e-6
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=rtol)
    res = tw.whiten(xc, 4)
    jres = jw.whiten(jxc, 4)
    tol_k = dict(rtol=1e-12, atol=1e-12) if dtype == "f64" else dict(rtol=1e-5, atol=1e-6)
    tol_x1 = dict(rtol=1e-12, atol=1e-12) if dtype == "f64" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.whitening_matrix.numpy(),
                               np.asarray(jres.whitening_matrix), **tol_k)
    np.testing.assert_allclose(res.data.numpy(), np.asarray(jres.data), **tol_x1)
    assert res.data.shape == (4, 3000)


def test_center_whiten_owned_passthrough_and_errors():
    x = torch.from_numpy(_data(4, 256, 3, np.float32)[0])
    x1, mean, k = tw.center_whiten(x, 4, False, False, ensure_owned=True)
    assert mean is None and k is None
    assert x1.data_ptr() != x.data_ptr() and torch.equal(x1, x)
    assert tw.center_whiten(x, 4, False, False)[0] is x
    with pytest.raises(P.InvalidDimensionsError):
        tw.center_whiten(x, 5)
    with pytest.raises(P.SingularMatrixError):
        tw.center_whiten(torch.ones((3, 3000)), 3)
    with pytest.raises(P.ComputationError, match="non-finite"):
        tw.whiten(torch.full((4, 1000), float("nan")), 4)


# Column blocks of the projection (``ops.linalg.ROTATE_BLOCK_T``, patched
# small): 4,000 columns in four whole blocks, and in two whole blocks and
# a ragged one of 928.
PROJECTION_BLOCKS = (1000, 1536)


@pytest.mark.parametrize("block", PROJECTION_BLOCKS)
@pytest.mark.parametrize("centering", [True, False], ids=["center", "no-center"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_blockwise_projection_matches_jax(monkeypatch, dtype, centering, block):
    """``K (X - mean)`` written into x1 a column block at a time matches
    the JAX package's one jitted product at the tolerances of
    ``test_center_whiten_matches_jax``, with fewer components than
    features, across several blocks and a ragged last one."""
    monkeypatch.setattr(linalg, "ROTATE_BLOCK_T", block)
    x, _ = _data(6, 4000, 23, DTYPES[dtype], SEPARATED)
    x1, mean, k = tw.center_whiten(torch.from_numpy(x), 4, centering)
    jx1, jmean, jk = jw.center_whiten(jnp.asarray(x), 4, centering)
    if dtype == "f64":
        tol_k = tol_x1 = dict(rtol=1e-12, atol=1e-12)
    else:
        tol_k, tol_x1 = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **tol_k)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), **tol_x1)
    assert x1.shape == (4, 4000) and x1.is_contiguous()
    # the blocks' product is the whole product's, up to summation order
    xt = torch.from_numpy(x)
    whole = k @ (xt - mean[:, None]) if centering else k @ xt
    _close_to_scale(tw._project_centered(k, xt, mean, centering), whole.numpy(), TOL[dtype])


class _LiveBytes(TorchDispatchMode):
    """Bytes of the tensors that the ops under this mode allocate (an
    output whose storage no input holds), alive at once: ``peak`` the
    most, ``live`` at the end."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _free(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        held = {a.untyped_storage().data_ptr() for a in tree_leaves((args, kwargs))
                if isinstance(a, torch.Tensor)}
        for o in tree_leaves(out):
            if isinstance(o, torch.Tensor) and o.untyped_storage().data_ptr() not in held:
                nbytes = o.untyped_storage().nbytes()
                held.add(o.untyped_storage().data_ptr())
                self.live += nbytes
                self.peak = max(self.peak, self.live)
                weakref.finalize(o, self._free, nbytes)
        return out


@pytest.mark.parametrize("centering", [True, False], ids=["center", "no-center"])
def test_projection_allocates_one_buffer_and_one_block(monkeypatch, centering):
    """Beside the caller's X, the projection holds x1 (n, T) and at most
    one centered (nf, block) column block at a time (none without
    centering): the memory model's projection term, where the one
    product over all of T held X - mean (nf, T) and x1 at once."""
    block = 1024
    monkeypatch.setattr(linalg, "ROTATE_BLOCK_T", block)
    nf, n, t = 6, 4, 5000
    x = torch.from_numpy(_data(nf, t, 24, np.float32)[0])
    k = torch.from_numpy(np.random.default_rng(0).standard_normal((n, nf)).astype(np.float32))
    mean = x.mean(dim=1)
    with _LiveBytes() as mode:
        x1 = tw._project_centered(k, x, mean, centering)
    assert mode.live == n * t * 4 == x1.untyped_storage().nbytes()
    assert mode.peak == n * t * 4 + (nf * block * 4 if centering else 0)
    with _LiveBytes() as mode:
        k @ (x - mean[:, None])
    assert mode.peak == (nf + n) * t * 4  # the one product: two new (., T) buffers


def test_refinement_reaches_functional_whiteness():
    """The f32 refinement on an ill-conditioned Laplace mixture (the JAX
    package's 300 x 120,000 exhibit): K whitens the f64 covariance to
    < 1e-3, the emitted data itself to < 1e-4, and the first-pass K of
    a single f32 covariance misses by far more."""
    rng = np.random.default_rng(1)
    n, t = 300, 120_000
    x64 = rng.standard_normal((n, n)) @ rng.laplace(size=(n, t))
    x64 -= x64.mean(axis=1, keepdims=True)
    cov64 = x64 @ x64.T
    x32 = x64.astype(np.float32)
    del x64

    x1, _, k = tw.center_whiten(torch.from_numpy(x32), n)
    k = k.double().numpy()
    resid = np.abs(k @ (cov64 / t) @ k.T - np.eye(n)).max()
    assert resid < 1e-3, resid
    x1_64 = x1.double()
    self_white = float((x1_64 @ x1_64.T / t - torch.eye(n, dtype=torch.float64)).abs().max())
    assert self_white < 1e-4, self_white

    k1, _ = tw.whitening_matrix_from_covariance(
        (x32 @ x32.T).astype(np.float64), t, n)
    if k1 is not None:
        assert np.abs(k1 @ (cov64 / t) @ k1.T - np.eye(n)).max() > 10 * resid


@pytest.fixture(scope="module")
def mixture32():
    _, a, x = generate_mixed_kurtosis_data(8, 20_000, 1)
    return a, x.astype(np.float32)


@pytest.fixture(scope="module")
def jax_fit32(mixture32):
    _, x32 = mixture32
    return J.Picard.fit(x32, J.PicardConfig(random_state=0))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_fit_f32_input_matches_jax(mixture32, jax_fit32, kind):
    """f32 NumPy input and a CPU tensor take the device path in both
    packages; the caller's data is left as it was."""
    a, x32 = mixture32
    x = x32.copy() if kind == "numpy" else torch.from_numpy(x32.copy())
    rt = P.Picard.fit(x, P.PicardConfig(random_state=0), device="cpu")
    np.testing.assert_array_equal(np.asarray(x), x32)
    rj = jax_fit32
    assert rt.converged and bool(rj.converged)
    assert rt.whitening.dtype == torch.float32 and rt.mean.shape == (8,)
    # The mixture's means are near 0: relative to the data's scale (~1).
    np.testing.assert_allclose(rt.mean.numpy(), np.asarray(rj.mean), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(rt.whitening.numpy(), np.asarray(rj.whitening),
                               rtol=1e-5, atol=1e-6)
    w_t = rt.full_unmixing().double().numpy()
    assert amari_distance(w_t, np.linalg.inv(np.asarray(rj.full_unmixing(), np.float64))) < 1e-4
    assert amari_distance(w_t, a) < 5e-3


def test_transform_of_jax_device_whitened_result(mixture32, jax_fit32):
    _, x32 = mixture32
    back = convert.result_from_arrays(jax_fit32)
    x_new = x32[:, :700]
    np.testing.assert_allclose(P.Picard.transform(x_new, back).numpy(),
                               np.asarray(J.Picard.transform(x_new, jax_fit32)),
                               rtol=1e-5, atol=1e-5)


def test_reference_lcg_bit_equal_to_jax():
    for state, count in [(42, 1), (42, 1000), (7, 64 * 4_000_000), (2**63 + 5, 12345)]:
        assert tdg._lcg_jump(state, count) == jdg._lcg_jump(state, count)
    states, end = tdg._lcg_stream(42, 5000)
    jstates, jend = jdg._lcg_stream(42, 5000)
    np.testing.assert_array_equal(states, jstates)
    assert end == jend == tdg._lcg_jump(42, 5000)
    np.testing.assert_array_equal(tdg._lcg_uniform(states), jdg._lcg_uniform(jstates))
    for n, t, seed in [(64, 4_000_000, 42), (600, 1_000_000, 42), (5, 77, 3)]:
        np.testing.assert_array_equal(tdg.reference_mixing_matrix(n, t, seed),
                                      jdg.reference_mixing_matrix(n, t, seed))
    # Both packages fill through a native generator of the same stream,
    # each within 1 ulp of the NumPy closed form.
    np.testing.assert_allclose(tdg.generate_bench_data(4, 3000, 42),
                               jdg.generate_bench_data(4, 3000, 42), rtol=1e-13, atol=1e-13)


def test_generate_bench_data_device():
    n, t = 6, 50_000
    x = tdg.generate_bench_data_device(n, t, 42, "cpu")
    assert x.shape == (n, t) and x.dtype == torch.float32
    assert torch.equal(x, tdg.generate_bench_data_device(n, t, 42, "cpu"))
    s = tdg.laplace_sources_device(n, t, 42, "cpu")
    mix = torch.as_tensor(tdg.reference_mixing_matrix(n, t, 42), dtype=torch.float32)
    assert torch.equal(x, rotate_rows_inplace(mix, s.clone()))
    # Standard Laplace: mean 0, variance 2, E|s| = 1 (5 sigma bounds).
    s64 = s.double()
    assert float(s64.mean(dim=1).abs().max()) < 5 * (2 / t) ** 0.5
    assert float((s64.var(dim=1) - 2).abs().max()) < 5 * (20 / t) ** 0.5
    assert float((s64.abs().mean(dim=1) - 1).abs().max()) < 5 * (1 / t) ** 0.5
