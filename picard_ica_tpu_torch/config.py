"""Configuration for the Picard solver (PyTorch port).

Field names, defaults, and validation rules mirror the reference
(src/config.rs:11-142) and ``picard_ica_tpu/config.py``; the fluent
:class:`ConfigBuilder` mirrors config.rs:147-273. Two differences from
the JAX package: ``use_pallas`` is ``use_kernels`` (the CUDA kernels of
``ops/kernels.py``, same tri-state meaning), and ``dtype`` takes a torch
dtype — ``None`` means float32, float64 only when asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .errors import InvalidConfigError
from .ops.densities import Density, Tanh


@dataclasses.dataclass(frozen=True)
class PicardConfig:
    """Configuration parameters for the Picard algorithm.

    Defaults match the reference (config.rs:64-85).
    """

    density: Density = dataclasses.field(default_factory=Tanh)
    n_components: Optional[int] = None
    ortho: bool = True
    extended: Optional[bool] = None
    whiten: bool = True
    centering: bool = True
    max_iter: int = 500
    tol: float = 1e-7
    m: int = 7
    ls_tries: int = 10
    lambda_min: float = 0.01
    w_init: Optional[Any] = None
    fastica_it: Optional[int] = None
    jade_it: Optional[int] = None
    random_state: Optional[int] = None
    verbose: bool = False
    # Compute dtype: a torch dtype, torch.float32 (the default, None)
    # or torch.float64.
    dtype: Optional[Any] = None
    # Use the CUDA kernels of ops/kernels.py for the data passes.
    # None = auto: on for an f32 fit on a CUDA device with
    # n_components <= ops.kernels.KERNEL_MAX_N (the resident kernels).
    # True also takes the streaming kernels above that, up to
    # ops.kernels.STREAM_MAX_N. On the CPU the kernel wrappers run their
    # plain PyTorch versions.
    use_kernels: Optional[bool] = None
    # Escalate non-convergence to NotConvergedError instead of the
    # reference's warn-and-return (solver.rs:171-177 semantics stay the
    # default; see errors.NotConvergedError).
    raise_on_no_convergence: bool = False
    # Dot precision of the data passes. "auto" (default) = staged
    # schedule: bf16 -> bf16x3 -> exact f32, each tier down to a safe
    # multiple of its gradient-noise floor (models/core._precision_stages);
    # "f32" pins exact f32 throughout; "bf16x3"/"bf16" pin a single
    # cheaper tier (their floors cap reachable tolerance).
    kernel_precision: str = "auto"
    # Where the one-time center+whiten pass runs. "auto" (default):
    # float64 NumPy inputs of up to 2e8 elements to an f32 fit are
    # preprocessed on the host in f64 (the whitening basis then matches
    # an all-f64 pipeline); everything else runs on the device
    # (ops/whitening.center_whiten). "f64" forces the host path (errors
    # on tensor input); "device" forces the device path.
    whiten_precision: str = "auto"

    @staticmethod
    def builder() -> "ConfigBuilder":
        return ConfigBuilder()

    def effective_extended(self) -> bool:
        """``extended`` defaults to ``ortho`` (config.rs:99-101)."""
        return self.ortho if self.extended is None else self.extended

    def validate(self) -> None:
        """Eager validation (config.rs:104-142)."""
        if self.max_iter <= 0:
            raise InvalidConfigError("max_iter", "must be greater than 0")
        if self.n_components is not None and self.n_components <= 0:
            raise InvalidConfigError("n_components", "must be at least 1")
        if self.tol <= 0.0:
            raise InvalidConfigError("tol", "must be positive")
        if self.lambda_min <= 0.0:
            raise InvalidConfigError("lambda_min", "must be positive")
        if self.m <= 0:
            raise InvalidConfigError("m", "L-BFGS memory size must be at least 1")
        if self.fastica_it is not None and self.jade_it is not None:
            raise InvalidConfigError(
                "jade_it",
                "cannot use both fastica_it and jade_it; choose one warm start method",
            )
        if self.kernel_precision not in ("auto", "f32", "bf16x3", "bf16"):
            raise InvalidConfigError(
                "kernel_precision",
                "must be 'auto', 'f32', 'bf16x3' or 'bf16'",
            )
        if self.whiten_precision not in ("auto", "f64", "device"):
            raise InvalidConfigError(
                "whiten_precision", "must be 'auto', 'f64' or 'device'"
            )

    def replace(self, **kwargs) -> "PicardConfig":
        return dataclasses.replace(self, **kwargs)


class ConfigBuilder:
    """Fluent builder mirroring the reference's ConfigBuilder."""

    def __init__(self):
        self._kwargs: dict = {}

    def density(self, density: Density) -> "ConfigBuilder":
        self._kwargs["density"] = density
        return self

    def n_components(self, n: int) -> "ConfigBuilder":
        self._kwargs["n_components"] = n
        return self

    def ortho(self, ortho: bool) -> "ConfigBuilder":
        self._kwargs["ortho"] = ortho
        return self

    def extended(self, extended: bool) -> "ConfigBuilder":
        self._kwargs["extended"] = extended
        return self

    def whiten(self, whiten: bool) -> "ConfigBuilder":
        self._kwargs["whiten"] = whiten
        return self

    def centering(self, centering: bool) -> "ConfigBuilder":
        self._kwargs["centering"] = centering
        return self

    def max_iter(self, max_iter: int) -> "ConfigBuilder":
        self._kwargs["max_iter"] = max_iter
        return self

    def tol(self, tol: float) -> "ConfigBuilder":
        self._kwargs["tol"] = tol
        return self

    def m(self, m: int) -> "ConfigBuilder":
        self._kwargs["m"] = m
        return self

    def ls_tries(self, ls_tries: int) -> "ConfigBuilder":
        self._kwargs["ls_tries"] = ls_tries
        return self

    def lambda_min(self, lambda_min: float) -> "ConfigBuilder":
        self._kwargs["lambda_min"] = lambda_min
        return self

    def w_init(self, w_init) -> "ConfigBuilder":
        self._kwargs["w_init"] = w_init
        return self

    def fastica_it(self, iterations: int) -> "ConfigBuilder":
        self._kwargs["fastica_it"] = iterations
        return self

    def jade_it(self, iterations: int) -> "ConfigBuilder":
        self._kwargs["jade_it"] = iterations
        return self

    def random_state(self, seed: int) -> "ConfigBuilder":
        self._kwargs["random_state"] = seed
        return self

    def verbose(self, verbose: bool) -> "ConfigBuilder":
        self._kwargs["verbose"] = verbose
        return self

    def dtype(self, dtype) -> "ConfigBuilder":
        self._kwargs["dtype"] = dtype
        return self

    def use_kernels(self, use_kernels: bool) -> "ConfigBuilder":
        self._kwargs["use_kernels"] = use_kernels
        return self

    def raise_on_no_convergence(self, raise_: bool) -> "ConfigBuilder":
        self._kwargs["raise_on_no_convergence"] = raise_
        return self

    def kernel_precision(self, precision: str) -> "ConfigBuilder":
        self._kwargs["kernel_precision"] = precision
        return self

    def whiten_precision(self, precision: str) -> "ConfigBuilder":
        self._kwargs["whiten_precision"] = precision
        return self

    def build(self) -> PicardConfig:
        return PicardConfig(**self._kwargs)

    def build_validated(self) -> PicardConfig:
        config = self.build()
        config.validate()
        return config
