"""picard_ica_tpu_torch — Picard ICA on PyTorch, with CUDA kernels.

The PyTorch + CUDA port of ``picard_ica_tpu`` (the JAX package beside
it, which stays the reference): the same ``Picard.fit`` /
``fit_with_config`` / ``transform`` facade, configuration, densities and
core loop (Picard and Picard-O, L-BFGS, extended sign logic, the staged
bf16 -> bf16x3 -> f32 schedule), the JADE and FastICA warm starts and
checkpoints (``save_result`` / ``load_result`` / ``resume_config``),
with the three data passes of the core loop as hand-written CUDA
kernels for Hopper (``csrc/``, bound in ``ops/kernels.py``). Fits run on a CUDA device by default; pass
``device="cpu"`` to run on the CPU, where the kernels' plain PyTorch
versions stand in. ``Picard.fit(x, config, mesh=parallel.sample_mesh())``
shards the samples over a ``torch.distributed`` world (``parallel``).

Example::

    import numpy as np
    from picard_ica_tpu_torch import Picard, PicardConfig

    x = np.random.laplace(size=(10, 100_000)) * 1.0   # float64 NumPy
    result = Picard.fit(x, PicardConfig(random_state=0))   # on "cuda"
    sources, unmixing = result.sources, result.unmixing
"""

from .config import ConfigBuilder, PicardConfig
from .errors import (
    AccuracyWarning,
    ComputationError,
    InvalidConfigError,
    InvalidDimensionsError,
    NotConvergedError,
    PicardError,
    SingularMatrixError,
)
from .ops.densities import Cube, Density, DensityType, Exp, Tanh
from .results import PicardResult
from .solver import Picard

from . import checkpoint, ops, parallel, utils  # noqa: E402  (public subpackages)
from .checkpoint import load_result, resume_config, save_result

__version__ = "0.1.0"

__all__ = [
    "Picard",
    "PicardConfig",
    "ConfigBuilder",
    "PicardResult",
    "PicardError",
    "NotConvergedError",
    "InvalidDimensionsError",
    "SingularMatrixError",
    "ComputationError",
    "InvalidConfigError",
    "AccuracyWarning",
    "Density",
    "DensityType",
    "Tanh",
    "Exp",
    "Cube",
    "ops",
    "parallel",
    "utils",
    "checkpoint",
    "save_result",
    "load_result",
    "resume_config",
]
