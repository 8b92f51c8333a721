"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py REPO RANK WORLD STORE OUT_DIR

Joins a ``WORLD``-rank gloo world through the file store ``STORE``, runs
every sharded case of the port beside its unsharded counterpart on the
same data, and writes ``OUT_DIR/rank<RANK>.npz``. Imports the port only
(torch and NumPy), never JAX; the test module compares with the JAX
package in its own process. A one-rank world runs the bitwise case
alone.
"""

import dataclasses
import sys

repo, rank, world, store, out_dir = sys.argv[1:6]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from picard_ica_tpu_torch import Picard, PicardConfig, Tanh  # noqa: E402
from picard_ica_tpu_torch.checkpoint import load_result, save_result  # noqa: E402
from picard_ica_tpu_torch.errors import InvalidDimensionsError  # noqa: E402
from picard_ica_tpu_torch.models import core  # noqa: E402
from picard_ica_tpu_torch.models.jade import compute_cumulant_matrices, jade  # noqa: E402
from picard_ica_tpu_torch.ops import whitening  # noqa: E402
from picard_ica_tpu_torch.ops.whitening import preprocess_f64  # noqa: E402
from picard_ica_tpu_torch.parallel import (  # noqa: E402
    distributed_init,
    sample_mesh,
    shard_samples,
    sharding,
)
from picard_ica_tpu_torch.parallel.mesh import local_block  # noqa: E402
from picard_ica_tpu_torch.parallel.sharding import (  # noqa: E402
    SampleShards,
    compute_raw_moments_psum,
    loglik_rowmeans_psum,
)

sys.path.insert(0, repo + "/tests")
from torch_parallel_data import FITS, fit_data, moments_data, whitening_data  # noqa: E402

distributed_init(backend="gloo", init_method="file://" + store, rank=rank,
                 world_size=world)
mesh = sample_mesh("cpu")
assert torch.distributed.get_backend(mesh.get_group()) == "gloo"
out = {}


def put(key, v):
    if isinstance(v, torch.Tensor):
        v = v.detach().numpy()
    out[key] = np.asarray(v)


def record_reduces():
    """Replace the all-reduce helper by a recorder of (tensor count,
    elements, async) per call; returns the record."""
    calls = []
    real = sharding.all_reduce_flat

    def spy(tensors, group, async_op=False):
        calls.append((len(tensors), sum(t.numel() for t in tensors), int(async_op)))
        return real(tensors, group, async_op=async_op)

    sharding.all_reduce_flat = spy
    return calls, real


def fits(names):
    """Each fit unsharded and on the mesh, f64 unless the case says."""
    for name in names:
        data_name, kw = FITS[name]
        _, _, x = fit_data(data_name)
        cfg = PicardConfig(random_state=0, **{"dtype": torch.float64, **kw})
        r1 = Picard.fit(x, cfg, device="cpu")
        rm = Picard.fit(x, cfg, mesh=mesh)
        for tag, r in (("single", r1), ("mesh", rm)):
            put(f"{name}/{tag}/w", r.unmixing)
            put(f"{name}/{tag}/full", r.full_unmixing())
            put(f"{name}/{tag}/iters", r.n_iterations)
            put(f"{name}/{tag}/converged", r.converged)
        src = rm.sources
        put(f"{name}/mesh/placed", isinstance(src, torch.distributed.tensor.DTensor)
            and tuple(src.placements) == (torch.distributed.tensor.Shard(1),))
        put(f"{name}/mesh/local_t", src.to_local().shape[1])
        put(f"{name}/mesh/sources", src.full_tensor())
        put(f"{name}/single/sources", r1.sources)
        if name == "fit":
            fitted = (x, r1, rm)
            rd = Picard.fit(shard_samples(x, mesh), cfg, mesh=mesh)
            put("fit/dtensor/w", rd.unmixing)
            put("fit/dtensor/sources", rd.sources.to_local())
            put("fit/mesh/local_sources", src.to_local())
    return fitted if "fit" in names else None


def unseeded():
    """A fit with no random_state: each rank draws its own seed, and the
    mesh's first rank's must win, or each rank starts from its own W."""
    _, _, x = fit_data("mixed")
    r = Picard.fit(x, PicardConfig(dtype=torch.float64), mesh=mesh)
    put("unseeded/w", r.unmixing)
    put("unseeded/full", r.full_unmixing())
    put("unseeded/converged", r.converged)


def one_rank_bitwise():
    """A one-rank mesh is the unsharded fit, bit for bit: the f32 fit on
    the kernels' plain versions and the chunked whitening."""
    _, _, x = fit_data("mixed")
    x32 = x.astype(np.float32)
    cfg = PicardConfig(random_state=0, use_kernels=True)
    r1 = Picard.fit(x32, cfg, device="cpu")
    rm = Picard.fit(x32, cfg, mesh=mesh)
    put("bitwise/single/w", r1.unmixing)
    put("bitwise/mesh/w", rm.unmixing)
    put("bitwise/single/sources", r1.sources)
    put("bitwise/mesh/sources", rm.sources.to_local())
    put("bitwise/single/iters", r1.n_iterations)
    put("bitwise/mesh/iters", rm.n_iterations)


def core_f64():
    """run_core on the whitened f64 data, on both paths."""
    _, _, x = fit_data("mixed")
    xw, _, _ = preprocess_f64(x, x.shape[0], True, True)
    xw = torch.from_numpy(xw)
    n, t = xw.shape
    shards = SampleShards.of(mesh, t)
    for use_kernels in (False, True):
        opts = core.CoreOptions(density=Tanh(), ortho=True, extended=True, has_cov=True,
                                m=7, ls_tries=10, use_kernels=use_kernels)
        eye = torch.eye(n, dtype=torch.float64)
        r1 = core.run_core(xw.clone(), eye, 1e-7, 0.01, 200, opts)
        opts_m = dataclasses.replace(opts, data_sharding=shards)
        rm = core.run_core(local_block(xw, mesh).clone(), eye, 1e-7, 0.01, 200, opts_m)
        path = "kernels" if use_kernels else "torch"
        for tag, r in (("single", r1), ("mesh", rm)):
            put(f"core/{path}/{tag}/w", r.w)
            put(f"core/{path}/{tag}/iters", r.n_iterations)
            put(f"core/{path}/{tag}/converged", r.converged)


def psum_moments():
    y = moments_data()
    ys = shard_samples(y, mesh)
    m = compute_raw_moments_psum(ys, Tanh(), mesh, need_h=True, need_ysq=True)
    for key, v in zip(("g", "pm", "h", "ysq"), m):
        put(f"psum/{key}", v)
    put("psum/loglik", loglik_rowmeans_psum(ys, Tanh(), mesh))


def jade_sharded():
    _, _, x = fit_data("mixed")
    xw = torch.from_numpy(preprocess_f64(x, x.shape[0], True, True)[0])
    shards = SampleShards.of(mesh, xw.shape[1])
    xl = local_block(xw, mesh).contiguous()
    put("jade/cum/single", compute_cumulant_matrices(xw))
    put("jade/cum/mesh", compute_cumulant_matrices(xl, data_sharding=shards))
    put("jade/w/single", jade(xw, 30)[0])
    put("jade/w/mesh", jade(xl, 30, data_sharding=shards)[0])


def transform_and_checkpoint(x, r1, rm):
    x_new = x[:, :1200]
    y = Picard.transform(shard_samples(x_new, mesh), rm)
    put("transform/placed", isinstance(y, torch.distributed.tensor.DTensor)
        and tuple(y.placements) == (torch.distributed.tensor.Shard(1),))
    put("transform/mesh", y.full_tensor())
    put("transform/single", Picard.transform(x_new, r1))
    path = f"{out_dir}/fit{rank}.npz"
    save_result(path, rm)  # gathers the sources: every rank calls it
    back = load_result(path, device="cpu")
    put("checkpoint/sources", back.sources)
    put("checkpoint/unmixing", back.unmixing)
    try:
        Picard.fit(x[:, :x.shape[1] - 1], PicardConfig(random_state=0), mesh=mesh)
        put("divisible/message", "")
    except InvalidDimensionsError as e:
        put("divisible/message", str(e))


def accept_order():
    """The all-reduce calls of one fused pass on each path, and of a fit."""
    y = torch.from_numpy(moments_data()[:, :800])
    n, t = y.shape
    shards = SampleShards.of(mesh, t)
    m_new = torch.eye(n, dtype=torch.float64) * 1.01
    m_old = torch.eye(n, dtype=torch.float64)
    for use_kernels in (False, True):
        opts = core.CoreOptions(density=Tanh(), ortho=True, extended=True, has_cov=True,
                                m=7, ls_tries=10, use_kernels=use_kernels,
                                data_sharding=shards)
        calls, real = record_reduces()
        try:
            *_, moments = core.data_fused_step(m_new, m_old, local_block(y, mesh), opts,
                                               False, False)
            core._ready(moments)
        finally:
            sharding.all_reduce_flat = real
        put(f"order/{'kernels' if use_kernels else 'torch'}", calls)
    _, _, x = fit_data("mixed")
    calls, real = record_reduces()
    try:
        r = Picard.fit(x, PicardConfig(random_state=0, dtype=torch.float64), mesh=mesh)
    finally:
        sharding.all_reduce_flat = real
    put("order/fit", calls)
    put("order/fit_ls_calls", r.ls_calls)
    put("order/n", x.shape[0])


def whitening_stats():
    """Mean and centered covariance, sharded against unsharded: the CPU
    route (f32, chunked), and the kernels' route through their plain
    versions at N > 512, where the covariance is the grouped one."""
    for name, impl in (("chunked", "chunked"), ("grouped", "kernel")):
        x = torch.from_numpy(whitening_data(name))
        shards = SampleShards.of(mesh, x.shape[1])
        mean1, cov1 = whitening._prepare_stats(x, impl, True)
        meanm, covm = whitening._prepare_stats(
            local_block(x, mesh).contiguous(), impl, True, shards)
        for tag, v in (("mean/single", mean1), ("cov/single", cov1),
                       ("mean/mesh", meanm), ("cov/mesh", covm)):
            put(f"white/{name}/{tag}", v)


if world == 1:
    one_rank_bitwise()
elif world == 3:
    fits(["fit"])
    unseeded()
else:
    x, r1, rm = fits(list(FITS))
    core_f64()
    psum_moments()
    jade_sharded()
    transform_and_checkpoint(x, r1, rm)
    accept_order()
    whitening_stats()
    unseeded()
np.savez(f"{out_dir}/rank{rank}.npz", **out)
torch.distributed.destroy_process_group()
print("RANK_OK", rank, flush=True)
