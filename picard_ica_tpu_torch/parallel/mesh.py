"""Process groups and the 1-D samples mesh on ``torch.distributed``.

Counterpart of ``picard_ica_tpu/parallel/mesh.py``. Picard ICA has one
shardable axis, the i.i.d. samples, so the mesh is 1-D over every rank
of the world, one rank a device, with all N x N optimizer state
replicated. NCCL carries the collectives between GPUs, one rank a card;
gloo carries them on the CPU, and between ranks that share one card
(NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

SAMPLE_AXIS = "samples"


def distributed_init(**kwargs) -> None:
    """Initialize the default process group (idempotent wrapper over
    ``torch.distributed.init_process_group``, ``kwargs`` passed through:
    ``backend``, ``init_method`` or ``store``, ``world_size``, ``rank``).

    Call once per process before building a mesh. A no-op when the
    default group already exists; a failure to form it raises.
    """
    if not dist.is_initialized():
        dist.init_process_group(**kwargs)


def sample_mesh(device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh named "samples" over the whole world, on the default
    process group's own backend.

    ``device_type`` is where each rank's block lives: ``"cuda"`` (the
    default, as for an unsharded fit; raises when CUDA is not
    available) or ``"cpu"``, which the caller asks for. The mesh wraps
    the default group rather than creating one: on a gloo world,
    ``init_device_mesh("cuda", ...)`` would make an NCCL group for CUDA
    tensors, which two ranks on one card cannot form.
    """
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sample_mesh builds a CUDA mesh by default and CUDA is not "
            "available; pass device_type='cpu' to shard on the CPU"
        )
    return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                 mesh_dim_names=(SAMPLE_AXIS,))


def data_sharding(mesh: DeviceMesh):
    """(N replicated, T sharded) placements of an (n_components,
    n_samples) array on ``mesh``."""
    del mesh  # one layout on every 1-D samples mesh
    return (Shard(1),)


def check_divisible(t: int, size: int) -> None:
    """Raise ``InvalidDimensionsError`` unless ``t`` samples split into
    ``size`` equal blocks."""
    if t % size:
        from ..errors import InvalidDimensionsError

        raise InvalidDimensionsError(
            f"n_samples ({t}) must be divisible by the mesh size ({size}) to "
            f"shard the samples axis; trim to {t - t % size} or pad the data"
        )


def local_block(x, mesh: DeviceMesh):
    """This rank's columns of the whole (N, T) array ``x`` (a NumPy
    array or a tensor, as given: a view, not a copy). T must be
    divisible by the mesh size."""
    size, rank = mesh.size(), mesh.get_local_rank()
    check_divisible(x.shape[1], size)
    block = x.shape[1] // size
    return x[:, rank * block:(rank + 1) * block]


def shard_samples(x, mesh: DeviceMesh) -> DTensor:
    """This rank's column block of ``x`` as a ``DTensor`` placed
    ``Shard(1)`` on ``mesh``.

    ``x`` is the whole (N, T) array, identical on every rank (NumPy or a
    tensor on any device); only this rank's T / size columns are copied
    to its device (:func:`local_device`), so the rest of ``x`` can be
    freed. T must be divisible by the mesh size.
    """
    local = local_block(x, mesh)
    if not isinstance(local, torch.Tensor):
        local = torch.from_numpy(local)
    device = local_device(mesh)
    local = local.to(device, copy=local.device == device).contiguous()
    return DTensor.from_local(local, mesh, data_sharding(mesh), run_check=False)


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: the current CUDA device for a
    ``"cuda"`` mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
