"""Sample-sharded fits of the port on gloo worlds on the CPU.

The counterparts of tests/test_sharding.py and tests/test_distributed.py.
A two-rank, a three-rank and a one-rank world are each spawned once
(module-scoped fixtures; tests/torch_parallel_worker.py, which imports
only the port) and run every case beside its unsharded counterpart on
the same data (tests/torch_parallel_data.py); this module holds what
they wrote, and the JAX package's mesh fits on the same data:
  * sharded against the single-process port, in f64: W to 1e-8 and the
    same iteration count, on the torch path and the kernels' plain
    versions, for the core and the full fit (FastICA non-ortho, cube,
    exp and JADE among them);
  * sharded port against ``picard_ica_tpu.Picard.fit(...,
    mesh=sample_mesh(jax.devices()[:k]))``: full unmixing to 1e-8;
  * the explicit psum moments and log-lik, and the JADE cumulants, to
    their dense forms (1e-12, 1e-10);
  * W bit-identical on every rank, with a seed or without one; a
    one-rank mesh bit-identical to the unsharded fit;
  * the accept payload (dll, dysq) all-reduced first and on its own,
    then the moment payload.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picard_ica_tpu as J
from picard_ica_tpu.models.jade import compute_cumulant_matrices as jax_cumulants
from picard_ica_tpu.ops.densities import Tanh as JTanh
from picard_ica_tpu.ops.moments import compute_raw_moments_xla
from picard_ica_tpu.ops.whitening import preprocess_f64 as jax_preprocess_f64
from picard_ica_tpu.parallel import sample_mesh as jax_sample_mesh
from picard_ica_tpu_torch.ops.densities import Tanh
from picard_ica_tpu_torch.ops.moments import compute_raw_moments
from picard_ica_tpu_torch.utils import amari_distance
from torch_parallel_data import FITS, fit_data, moments_data

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)
_WORKER = os.path.join(_TESTS, "torch_parallel_worker.py")
# Seconds a world may take; it takes a few.
_TIMEOUT = 240


def _run_world(tmp_path, world):
    """Spawn ``world`` ranks on one file store; returns each rank's arrays."""
    store = tmp_path / "store"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, _REPO, str(rank), str(world), str(store),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for rank in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, f"rank {rank} failed:\n{out}"
    return [dict(np.load(tmp_path / f"rank{rank}.npz")) for rank in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("world2"), 2)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("world3"), 3)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("world1"), 1)


_F64_FITS = [name for name in FITS if name != "f32"]


@pytest.mark.parametrize("name", _F64_FITS)
def test_sharded_fit_matches_single_process(world2, name):
    z = world2[0]
    assert z[f"{name}/single/converged"] and z[f"{name}/mesh/converged"]
    assert int(z[f"{name}/mesh/iters"]) == int(z[f"{name}/single/iters"])
    np.testing.assert_allclose(z[f"{name}/mesh/w"], z[f"{name}/single/w"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(z[f"{name}/mesh/sources"], z[f"{name}/single/sources"],
                               rtol=0, atol=1e-8)


def test_dtensor_input_is_the_whole_array_fit(world2):
    """A ``Shard(1)`` DTensor from ``shard_samples`` fits to the same bits
    as the whole array handed to every rank."""
    z = world2[0]
    np.testing.assert_array_equal(z["fit/dtensor/w"], z["fit/mesh/w"])
    np.testing.assert_array_equal(z["fit/dtensor/sources"], z["fit/mesh/local_sources"])


def test_three_ranks_match_single_process(world3):
    z = world3[0]
    assert z["fit/mesh/converged"]
    assert int(z["fit/mesh/iters"]) == int(z["fit/single/iters"])
    np.testing.assert_allclose(z["fit/mesh/w"], z["fit/single/w"], rtol=0, atol=1e-8)
    assert int(z["fit/mesh/local_t"]) == 4000


@pytest.mark.parametrize("path", ["torch", "kernels"])
def test_sharded_core_f64_matches_single_process(world2, path):
    z = world2[0]
    assert z[f"core/{path}/mesh/converged"]
    assert int(z[f"core/{path}/mesh/iters"]) == int(z[f"core/{path}/single/iters"])
    np.testing.assert_allclose(z[f"core/{path}/mesh/w"], z[f"core/{path}/single/w"],
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_fit_matches_jax_mesh_fit(world, request):
    """The port's sharded fit against the JAX package's on a mesh of as
    many CPU devices, f64, the same data: the full unmixing to 1e-8."""
    z = request.getfixturevalue(f"world{world}")[0]
    _, _, x = fit_data("mixed")
    rj = J.Picard.fit(x, J.PicardConfig(random_state=0),
                      mesh=jax_sample_mesh(jax.devices()[:world]))
    assert bool(rj.converged)
    assert int(z["fit/mesh/iters"]) == int(rj.n_iterations)
    np.testing.assert_allclose(z["fit/mesh/full"], np.asarray(rj.full_unmixing()),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("world", [2, 3])
def test_w_bit_identical_on_every_rank(world, request):
    ranks = request.getfixturevalue(f"world{world}")
    for key in ranks[0]:
        if key.endswith("/mesh/w"):
            for other in ranks[1:]:
                np.testing.assert_array_equal(other[key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("world", [2, 3])
def test_unseeded_fit_agrees_on_every_rank(world, request):
    """With random_state=None every rank draws its own seed; the fit
    must still start from one W_init, so W is the same bits on every
    rank and the sharded sums separate the mixture."""
    ranks = request.getfixturevalue(f"world{world}")
    _, a, _ = fit_data("mixed")
    assert ranks[0]["unseeded/converged"]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["unseeded/w"], ranks[0]["unseeded/w"])
    assert amari_distance(ranks[0]["unseeded/full"], a) < 5e-3


def test_one_rank_mesh_is_the_unsharded_fit(world1):
    z = world1[0]
    assert int(z["bitwise/mesh/iters"]) == int(z["bitwise/single/iters"])
    np.testing.assert_array_equal(z["bitwise/mesh/w"], z["bitwise/single/w"])
    np.testing.assert_array_equal(z["bitwise/mesh/sources"], z["bitwise/single/sources"])


def test_sharded_f32_fit_converges(world2):
    """The default f32 staged fit on the mesh (sums in another order than
    the single process's, so held to the mixing, not to 1e-8)."""
    z = world2[0]
    _, a, _ = fit_data("mixed")
    assert z["f32/mesh/converged"]
    assert amari_distance(z["f32/mesh/full"].astype(np.float64), a) < 5e-3
    assert amari_distance(z["f32/mesh/full"].astype(np.float64),
                          np.linalg.inv(z["f32/single/full"].astype(np.float64))) < 1e-3


@pytest.mark.parametrize("key", ["g", "pm", "h", "ysq"])
def test_psum_moments_match_dense(world2, key):
    y = moments_data()
    dense = compute_raw_moments(torch.from_numpy(y), Tanh(), True, True)._asdict()
    jax_dense = compute_raw_moments_xla(jnp.asarray(y), JTanh(), need_h=True,
                                        need_ysq_mean=True)._asdict()
    field = {"g": "g_raw", "pm": "pm_raw", "h": "h_raw", "ysq": "ysq_rowmean"}[key]
    got = world2[0][f"psum/{key}"]
    np.testing.assert_allclose(got, dense[field].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jax_dense[field]), rtol=0, atol=1e-12)


def test_psum_loglik_matches_dense(world2):
    y = moments_data()
    dense = np.asarray(jnp.mean(JTanh().log_lik(jnp.asarray(y)), axis=1))
    np.testing.assert_allclose(world2[0]["psum/loglik"], dense, rtol=0, atol=1e-12)


def test_jade_sharded_cumulants_and_w(world2):
    """The all-reduced Gram gives the cumulants to 1e-10 (and the JAX
    package's unsharded ones), and JADE's W to 1e-8."""
    z = world2[0]
    np.testing.assert_allclose(z["jade/cum/mesh"], z["jade/cum/single"], rtol=1e-10, atol=1e-10)
    _, _, x = fit_data("mixed")
    xw = jax_preprocess_f64(x, x.shape[0], True, True)[0]
    np.testing.assert_allclose(z["jade/cum/mesh"], np.asarray(jax_cumulants(jnp.asarray(xw))),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(z["jade/w/mesh"], z["jade/w/single"], rtol=1e-8, atol=1e-9)


def test_sources_placed_shard1(world2):
    z = world2[0]
    for name in FITS:
        assert z[f"{name}/mesh/placed"], name
        assert int(z[f"{name}/mesh/local_t"]) == 6000, name


def test_transform_on_dtensor(world2):
    z = world2[0]
    assert z["transform/placed"]
    np.testing.assert_allclose(z["transform/mesh"], z["transform/single"], rtol=1e-10,
                               atol=1e-10)


def test_checkpoint_gathers_sharded_sources(world2):
    z = world2[0]
    np.testing.assert_array_equal(z["checkpoint/sources"], z["fit/mesh/sources"])
    np.testing.assert_array_equal(z["checkpoint/unmixing"], z["fit/mesh/w"])


def test_sample_mesh_defaults_to_cuda(monkeypatch):
    """Like an unsharded fit, a mesh is on CUDA unless the caller asks
    for the CPU: without CUDA ``sample_mesh()`` raises, no CPU mesh."""
    from picard_ica_tpu_torch.parallel import sample_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        sample_mesh()


def test_non_divisible_samples_rejected(world2):
    assert "divisible by the mesh size" in str(world2[0]["divisible/message"])


@pytest.mark.parametrize("path", ["torch", "kernels"])
def test_accept_payload_reduced_first_and_alone(world2, path):
    """One fused pass: (dll, dysq), 2N floats, all-reduced on its own and
    synchronously, then (G, pm, H, ysq) asynchronously."""
    n = 4
    calls = world2[0][f"order/{path}"].tolist()
    assert calls == [[2, 2 * n, 0], [4, 2 * n * n + 2 * n, 1]]


def test_accept_payload_first_in_every_try_of_a_fit(world2):
    """In a sharded fit every asynchronous (moment) all-reduce follows a
    synchronous 2N accept payload, one pair a line-search try."""
    z = world2[0]
    n = int(z["order/n"])
    calls = z["order/fit"].tolist()
    moments = [i for i, c in enumerate(calls) if c[2]]
    assert len(moments) == int(z["order/fit_ls_calls"]) > 0
    for i in moments:
        assert calls[i][:2] == [4, 2 * n * n + 2 * n]
        assert calls[i - 1] == [2, 2 * n, 0]


@pytest.mark.parametrize("name", ["chunked", "grouped"])
@pytest.mark.parametrize("stat", ["mean", "cov"])
def test_sharded_whitening_statistics(world2, name, stat):
    """The mean and the centered covariance all-reduced over the ranks'
    blocks: the CPU's chunked route at N = 6, and the kernels' route
    (plain versions) at N = 520, where the covariance is the grouped one;
    f32 sums in another order, to 1e-6 of the largest entry."""
    z = world2[0]
    single = z[f"white/{name}/{stat}/single"]
    np.testing.assert_allclose(z[f"white/{name}/{stat}/mesh"], single, rtol=0,
                               atol=1e-6 * float(np.abs(single).max()))
