"""Sample-sharded fits on ``torch.distributed``: the 1-D samples mesh
and the all-reduces of every reduction over T."""

from . import mesh, sharding
from .mesh import SAMPLE_AXIS, data_sharding, distributed_init, sample_mesh, shard_samples

__all__ = [
    "mesh",
    "sharding",
    "SAMPLE_AXIS",
    "sample_mesh",
    "data_sharding",
    "shard_samples",
    "distributed_init",
]
