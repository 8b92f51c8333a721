"""All-reduces of the reductions over T, and the explicit psum forms.

Counterpart of ``picard_ica_tpu/parallel/sharding.py``. Each rank holds
a column block of X; every reduction over T is a local unnormalized sum,
all-reduced over the mesh's group, then divided by the global T, so
every rank holds the same reduced bits and the N x N state stays
replicated. :class:`SampleShards` carries the group and the global T
through ``CoreOptions.data_sharding`` and the whitening, JADE and
FastICA entry points. A payload of several tensors rides one flat
buffer: one collective per payload, not one per tensor.

The JAX module's ``shard_map`` shim has no counterpart: the port's
kernels already return unnormalized sums over the T they are given.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from ..ops.densities import Density
from ..ops.moments import RawMoments, _row_sum, raw_moment_sums


class SampleShards(NamedTuple):
    """A sample-sharded fit's reduction context: the process group that
    all-reduces, and the global number of samples the sums divide by."""

    group: object  # torch.distributed ProcessGroup
    n_samples: int

    @classmethod
    def of(cls, mesh, n_samples: int) -> "SampleShards":
        return cls(mesh.get_group(), int(n_samples))

    def reduce(self, tensors: Sequence[torch.Tensor]):
        return all_reduce_flat(tensors, self.group)

    def reduce_async(self, tensors: Sequence[torch.Tensor]) -> "PendingReduce":
        return all_reduce_flat(tensors, self.group, async_op=True)


def n_samples(x, shards) -> int:
    """The global T that sums over ``x``'s columns divide by: ``x``'s
    own, or the sharded fit's (``shards`` a :class:`SampleShards`)."""
    return x.shape[1] if shards is None else shards.n_samples


def all_reduced(v, shards):
    """``v`` summed over the mesh (``v`` itself when ``shards`` is None)."""
    return v if shards is None else shards.reduce([v])[0]


class PendingReduce:
    """An all-reduce in flight; :meth:`wait` returns its tensors (once
    reduced, the same list on every later call)."""

    def __init__(self, work, flat, shapes):
        self._work, self._flat, self._shapes = work, flat, shapes
        self._out = None

    def wait(self):
        if self._out is None:
            t0 = time.perf_counter()
            self._work.wait()
            counts.seconds += time.perf_counter() - t0
            self._out = _unflatten(self._flat, self._shapes)
        return self._out


def _unflatten(flat, shapes):
    out, start = [], 0
    for shape in shapes:
        count = shape.numel()
        out.append(flat[start:start + count].view(shape))
        start += count
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor], group, async_op: bool = False):
    """Sum ``tensors`` (one dtype, one device) over ``group`` as one flat
    buffer: one collective for the whole payload.

    Returns the reduced tensors in their shapes (views of the buffer),
    or with ``async_op=True`` a :class:`PendingReduce` to wait on. The
    inputs are not written. Each call is counted in :data:`counts`.
    """
    shapes = [t.shape for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    counts.calls += 1
    counts.bytes += flat.numel() * flat.element_size()
    t0 = time.perf_counter()
    work = dist.all_reduce(flat, group=group, async_op=async_op)
    counts.seconds += time.perf_counter() - t0
    if async_op:
        return PendingReduce(work, flat, shapes)
    return _unflatten(flat, shapes)


@dataclasses.dataclass
class CollectiveCounts:
    """This process's all-reduces: calls, bytes, and the host seconds
    spent in the calls and in the waits on the asynchronous ones."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


# Counted by all_reduce_flat, as ops.kernels counts its launches.
counts = CollectiveCounts()


def reset_collective_counts() -> None:
    counts.calls, counts.bytes, counts.seconds = 0, 0, 0.0


def _local_and_shards(y, mesh):
    """(this rank's block, SampleShards) of a ``Shard(1)`` DTensor."""
    return y.to_local(), SampleShards.of(mesh, y.shape[1])


def compute_raw_moments_psum(y, density: Density, mesh, need_h: bool,
                             need_ysq: bool) -> RawMoments:
    """Raw moments of a sample-sharded ``y`` with explicit per-shard
    partials and one all-reduce.

    ``y`` is a ``DTensor`` placed ``Shard(1)`` on ``mesh``; the result
    equals ``ops.moments.compute_raw_moments`` of the whole array, up to
    the order of the sums, and is replicated on every rank.
    """
    y_local, shards = _local_and_shards(y, mesh)
    sums = shards.reduce(raw_moment_sums(y_local, density, need_h, need_ysq))
    inv_t = 1.0 / shards.n_samples
    return RawMoments(*(v * inv_t for v in sums))


def loglik_rowmeans_psum(y, density: Density, mesh):
    """Row means of the density's log-likelihood of a sample-sharded
    ``y`` (a ``Shard(1)`` DTensor): local row sums, one all-reduce, over
    the global T."""
    y_local, shards = _local_and_shards(y, mesh)
    (ll,) = shards.reduce([_row_sum(density.log_lik(y_local))])
    return ll * (1.0 / shards.n_samples)
