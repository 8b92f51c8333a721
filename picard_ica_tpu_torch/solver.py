"""Public Picard solver facade (PyTorch port).

Counterpart of ``picard_ica_tpu/solver.py`` (reference:
src/solver.rs:45-189): validate -> RNG -> center + whiten -> init W
-> pre-rotate -> core loop -> compose W·W_init -> PicardResult. The
orchestration is eager Python around the device tensors of one
``device``; the core loop is ``models/core.run_core``. Centering and
whitening run in NumPy f64 on the host or on the device
(``ops/whitening.py``; ``PicardConfig.whiten_precision`` chooses).

Sample-sharded fits (``mesh``, a 1-D ``DeviceMesh`` from
``parallel.sample_mesh``): each rank holds a column block of X, every
reduction over T is all-reduced over the mesh's group and divided by the
global T, and all N x N state stays replicated (``parallel/sharding.py``);
the sources come back as a ``DTensor`` placed ``Shard(1)``.
"""

from __future__ import annotations

import sys
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .config import PicardConfig
from .errors import InvalidConfigError, InvalidDimensionsError, SingularMatrixError
from .models.core import CoreOptions, _precision_stages, run_core
from .models.fastica import ica_par
from .models.jade import jade
from .ops.densities import Tanh
from .ops.kernels import STREAM_MAX_N, kernel_density
from .ops.linalg import _SYM_DECORR_MIN_EIG, rotate_rows_inplace, sym_decorrelation_with_mineig
from .ops.precision import exact_f32
from .ops.whitening import _HOST_F64_MAX_ELEMENTS, center_whiten, preprocess_f64
from .parallel.mesh import check_divisible, local_block, local_device
from .parallel.sharding import SampleShards
from .results import PicardResult


def _resolve_device(x, device) -> torch.device:
    """The fit's device: ``device`` if given, else a CUDA tensor's own
    card, else CUDA (a CPU tensor is copied there) — the CPU only when
    the caller asks for it, never as a silent fall back."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "Picard.fit runs on a CUDA device by default and none is "
            "available; pass device='cpu' to fit on the CPU"
        )
    return torch.device("cuda")


# Auto (use_kernels=None) hands an f32 fit on the card to the kernels up
# to this many components: the largest N of port_turns.py --crossover's
# sweep (96 to 1344 at T = 1M), at every N of which the kernel path's core
# seconds per iteration beat the torch path's at the staged schedule and
# in the f32 tier on an H100 (PERF.md). It is STREAM_MAX_N; above
# KERNEL_MAX_N the streaming kernels run.
AUTO_KERNELS_MAX_N = 1344


def _auto_use_kernels(device: torch.device, dtype: torch.dtype, n_components: int,
                      density) -> bool:
    """use_kernels=None's rule: the kernels take an f32 fit on the card
    up to :data:`AUTO_KERNELS_MAX_N` components with a density that they
    implement (:func:`ops.kernels.kernel_density`: exactly ``Tanh``,
    ``Exp`` or ``Cube``); everything else, a plugin density among it,
    runs the torch path."""
    return (device.type == "cuda" and dtype == torch.float32
            and n_components <= AUTO_KERNELS_MAX_N and kernel_density(density))


def _resolve_use_kernels(use_kernels, device: torch.device, dtype: torch.dtype,
                         n_components: int, density) -> bool:
    """Whether the core runs the kernels: ``use_kernels=None`` by
    :func:`_auto_use_kernels`; ``True`` raises :class:`InvalidConfigError`
    where the kernels cannot take the fit: f64 or a density they do not
    implement on the card (on the CPU the kernels' plain versions take
    any density), more than the streaming kernels' capacity anywhere.
    ``Picard.fit`` asks before it whitens."""
    if use_kernels is None:
        return _auto_use_kernels(device, dtype, n_components, density)
    if use_kernels:
        on_cuda = device.type == "cuda"
        if on_cuda and dtype != torch.float32:
            raise InvalidConfigError(
                "use_kernels", "the CUDA kernels run f32; f64 takes the torch path"
            )
        if n_components > STREAM_MAX_N:
            raise InvalidConfigError(
                "use_kernels",
                f"n_components={n_components} exceeds the streaming "
                f"kernels' capacity ({STREAM_MAX_N})",
            )
        if on_cuda and not kernel_density(density):
            raise InvalidConfigError(
                "use_kernels",
                f"the CUDA kernels implement Tanh, Exp and Cube, not {density!r}; "
                "a plugin density takes the torch path (use_kernels=None or False)",
            )
    return bool(use_kernels)


def _resolve_dtype(config: PicardConfig) -> torch.dtype:
    dtype = torch.float32 if config.dtype is None else config.dtype
    if dtype not in (torch.float32, torch.float64):
        raise InvalidConfigError("dtype", "must be torch.float32 or torch.float64")
    return dtype


def _span(step: str):
    """A profiler annotation ``picard.<step>`` around one step of a fit
    (``utils.profiling.span_summary`` reads them); free when no profiler
    runs."""
    return torch.profiler.record_function(f"picard.{step}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise InvalidConfigError(
            "mesh", "must be a 1-D torch.distributed DeviceMesh (parallel.sample_mesh)")


def _local_input(x, mesh):
    """This rank's column block of a sharded fit's input: the local
    tensor of a ``DTensor`` placed ``Shard(1)`` on ``mesh``, else a view
    of the whole array's block (identical input on every rank)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return local_block(x, mesh)
    if tuple(x.placements) != (Shard(1),) or x.device_mesh.get_group() != mesh.get_group():
        raise InvalidDimensionsError(
            "a DTensor input must be placed Shard(1) on the fit's mesh")
    check_divisible(x.shape[1], mesh.size())
    return x.to_local()


def _agreed_seed(seed: int, mesh) -> int:
    """The mesh's first rank's ``seed``, on every rank: a sharded fit
    needs the same W_init everywhere, or each rank would rotate by its
    own W and the all-reduced sums would mix different rotations."""
    import torch.distributed as dist

    group = mesh.get_group()
    box = [seed]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return int(box[0])


class Picard:
    """Static-method facade, mirroring the reference's ``Picard`` struct."""

    @staticmethod
    def fit(x, config: Optional[PicardConfig] = None, device=None, mesh=None) -> PicardResult:
        """Fit ICA on ``x`` of shape (n_features, n_samples)."""
        with _span("fit"):
            return Picard.fit_with_config(x, config or PicardConfig(), device=device, mesh=mesh)

    @staticmethod
    @exact_f32()
    def fit_with_config(x, config: PicardConfig, device=None, mesh=None) -> PicardResult:
        """Fit ICA on ``x`` of shape (n_features, n_samples).

        ``mesh``: a 1-D samples mesh (``parallel.sample_mesh``), called
        on every rank. ``x`` is then either the whole array, identical on
        every rank (NumPy or a tensor), of which each rank takes its
        column block, or a ``DTensor`` placed ``Shard(1)`` on the mesh.
        The fit runs on this rank's device of the mesh unless ``device``
        is given.
        """
        config.validate()
        if mesh is not None:
            _check_mesh(mesh)
            device = local_device(mesh) if device is None else torch.device(device)
        else:
            device = _resolve_device(x, device)
        dtype = _resolve_dtype(config)

        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim != 2:
            raise InvalidDimensionsError("Input must be a 2-D (n_features, n_samples) matrix")
        n, p = x.shape
        if n == 0 or p == 0:
            raise InvalidDimensionsError("Input matrix cannot be empty")
        shards = None
        if mesh is not None:
            # This rank's columns; the global T divides every sum.
            x_local = _local_input(x, mesh)
            shards = SampleShards.of(mesh, p)

        # Host-f64 preprocessing: when the caller hands over float64
        # NumPy data of moderate size and the core runs in f32, the
        # one-time center+whiten pass runs in NumPy f64, so the whitening
        # basis matches an all-f64 pipeline's. Everything else is
        # centered and whitened on the device.
        x_host = x if isinstance(x, np.ndarray) else None
        host_f64 = config.whiten_precision == "f64"
        if config.whiten_precision == "auto":
            host_f64 = (
                x_host is not None
                and x_host.dtype == np.float64
                and dtype == torch.float32
                and x_host.size <= _HOST_F64_MAX_ELEMENTS
                and (config.centering or config.whiten)
            )
        if host_f64 and x_host is None:
            raise InvalidDimensionsError(
                "whiten_precision='f64' requires a host (NumPy) input array"
            )

        seed = config.random_state
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2**64))
            if mesh is not None:
                seed = _agreed_seed(seed, mesh)

        requested = min(n, p) if config.n_components is None else config.n_components
        n_components = min(requested, min(n, p))
        extended = config.effective_extended()

        # Problematic-configuration warning (solver.rs:69-74).
        if not isinstance(config.density, Tanh) and extended and not config.ortho:
            warnings.warn(
                "Using a density other than tanh with extended=True and "
                "ortho=False may result in incorrect estimation or numerical "
                "overflow",
                RuntimeWarning,
            )

        # The kernels' choice, and its refusals, before any whitening. The
        # core sees n_components rows, or all n without whitening.
        use_kernels = _resolve_use_kernels(config.use_kernels, device, dtype,
                                           n_components if config.whiten else n,
                                           config.density)

        with _span("whiten"):
            if host_f64:
                # Sharded, every rank whitens the whole array on its host and
                # keeps its block (the JAX package's rule).
                x1_64, mean_64, k_64 = preprocess_f64(
                    x_host, n_components, config.centering, config.whiten
                )
                if mesh is not None:
                    x1_64 = local_block(x1_64, mesh)
                np_dtype = np.float32 if dtype == torch.float32 else np.float64
                with _span("to_device"):
                    x1 = torch.from_numpy(np.ascontiguousarray(x1_64, np_dtype)).to(device)
                del x1_64
                x_mean = None if mean_64 is None else torch.as_tensor(mean_64, dtype=dtype, device=device)
                k_matrix = None if k_64 is None else torch.as_tensor(k_64, dtype=dtype, device=device)
            else:
                # Center (solver.rs:77-82) + whiten (solver.rs:85-93) on the
                # device. NumPy input is cast on the host and then moved; a
                # tensor is cast on its own device. x1 is a buffer the solver
                # owns (ensure_owned): the caller's data are never written.
                # Sharded, only this rank's block is cast and moved.
                xs = x if mesh is None else x_local
                with _span("to_device"):
                    if isinstance(xs, torch.Tensor):
                        x_dev = xs.to(dtype=dtype).to(device)
                    else:
                        np_dtype = np.float32 if dtype == torch.float32 else np.float64
                        x_dev = torch.from_numpy(np.ascontiguousarray(xs, np_dtype)).to(device)
                del xs
                x1, x_mean, k_matrix = center_whiten(
                    x_dev.contiguous(), n_components, config.centering, config.whiten,
                    ensure_owned=True, data_sharding=shards,
                )
                del x_dev
        x = x_host = x_local = None  # noqa: F841  (the input is not read again)
        actual_components = x1.shape[0]

        with _span("w_init"):
            # W_init: user-provided (shape-checked, solver.rs:98-111) or the
            # reference-RNG normal draw + symmetric decorrelation
            # (solver.rs:112-120).
            if config.w_init is not None:
                w_init = torch.as_tensor(np.asarray(config.w_init), dtype=dtype).to(device)
                if tuple(w_init.shape) != (actual_components, actual_components):
                    raise InvalidDimensionsError(
                        f"w_init shape {tuple(w_init.shape)} doesn't match expected "
                        f"({actual_components}, {actual_components})"
                    )
            else:
                from .utils import reference_rng

                # Decorrelated in f64 on the host for every dtype: W W^T of a
                # random draw can have cond ~1e5, where an f32 eigh leaves
                # W_init measurably non-orthogonal (torch's by ~1e-3), and
                # Picard-O carries that into the answer.
                w_raw = torch.from_numpy(
                    reference_rng.normal_matrix(seed, actual_components, actual_components)
                )
                w_init, min_eig = sym_decorrelation_with_mineig(w_raw)
                if float(min_eig) < _SYM_DECORR_MIN_EIG:
                    raise SingularMatrixError()
                w_init = w_init.to(device=device, dtype=dtype)

        with _span("warm_start"):
            # Warm starts, mutually exclusive (solver.rs:124-137), on the
            # whitened data's device; JADE overrides w_init.
            if config.jade_it is not None:
                if config.verbose:
                    print(f"Running {config.jade_it} iterations of JADE...", file=sys.stderr)
                w_init, min_eig = jade(x1, config.jade_it, 1e-6, config.verbose,
                                       data_sharding=shards)
                if float(min_eig) < _SYM_DECORR_MIN_EIG:
                    raise SingularMatrixError()
            elif config.fastica_it is not None:
                if config.verbose:
                    print(f"Running {config.fastica_it} iterations of FastICA...",
                          file=sys.stderr)
                w_init, min_eig = ica_par(x1, config.density, config.fastica_it, w_init,
                                          data_sharding=shards)
                if float(min_eig) < _SYM_DECORR_MIN_EIG:
                    raise SingularMatrixError()
                if config.verbose:
                    print("FastICA pre-iterations complete.", file=sys.stderr)

        # Pre-rotate the data in place (solver.rs:140); x1 is ours.
        with _span("pre_rotate"):
            x1 = rotate_rows_inplace(w_init, x1)

        # Whitened extended runs use the identity covariance (solver.rs:143-147).
        has_cov = extended and config.whiten
        covariance = (
            torch.eye(actual_components, dtype=dtype, device=device) if has_cov else None
        )

        if config.verbose:
            print("Running Picard...", file=sys.stderr)

        opts = CoreOptions(
            density=config.density,
            ortho=config.ortho,
            extended=extended,
            has_cov=has_cov,
            m=config.m,
            ls_tries=config.ls_tries,
            verbose=config.verbose,
            use_kernels=use_kernels,
            kernel_precision=config.kernel_precision,
            # x1 is the solver's own pre-rotation product and is not read
            # again: the final Y is written through its buffer.
            donate_data=True,
            data_sharding=shards,
        )
        _sync(device)
        t0 = time.perf_counter()
        with _span("core"):
            core = run_core(x1, covariance, config.tol, config.lambda_min,
                            config.max_iter, opts)
            _sync(device)
        core_seconds = time.perf_counter() - t0  # this rank's, after its device sync

        # Compose transforms (solver.rs:169).
        w = core.w @ w_init

        stage_precisions = tuple(pr for pr, _ in _precision_stages(opts, dtype))
        if config.verbose:
            stages = ", ".join(
                f"{pr}->it{e}" for pr, e in zip(stage_precisions, core.stage_exits)
            )
            print(
                f"Picard finished: {core.n_iterations} iterations "
                f"({core.ls_calls} line-search passes), gradient norm "
                f"{core.gradient_norm:.4e}, stages [{stages}]",
                file=sys.stderr,
            )

        if not core.converged:
            if config.raise_on_no_convergence:
                from .errors import NotConvergedError

                raise NotConvergedError(core.gradient_norm, config.tol, core.n_iterations)
            if config.verbose:
                print(
                    f"Warning: PICARD did not converge. Final gradient norm: "
                    f"{core.gradient_norm:.4e}, tolerance: {config.tol:.4e}",
                    file=sys.stderr,
                )

        sources = core.y
        if mesh is not None:
            from torch.distributed.tensor import DTensor, Shard

            sources = DTensor.from_local(sources, mesh, (Shard(1),), run_check=False)
        return PicardResult(
            whitening=k_matrix,
            unmixing=w,
            sources=sources,
            mean=x_mean,
            n_iterations=core.n_iterations,
            converged=core.converged,
            gradient_norm=core.gradient_norm,
            signs=core.signs if extended else None,
            stage_exits=core.stage_exits,
            stage_precisions=stage_precisions,
            ls_calls=core.ls_calls,
            stage_ls_calls=core.stage_ls_calls,
            core_seconds=core_seconds,
        )

    @staticmethod
    @exact_f32()
    def transform(x, result: PicardResult) -> torch.Tensor:
        """Apply a fitted model to new data (solver.rs:199-214), in exact
        f32 whatever the caller's TF32 flags. A ``DTensor`` placed
        ``Shard(1)`` gives a ``DTensor`` of the same placement, each rank's
        block transformed where it lies."""
        from torch.distributed.tensor import DTensor, Shard

        if isinstance(x, DTensor):
            if tuple(x.placements) != (Shard(1),):
                raise InvalidDimensionsError("a DTensor input must be placed Shard(1)")
            y = Picard.transform(x.to_local(), result)
            return DTensor.from_local(y, x.device_mesh, x.placements, run_check=False)
        u = result.unmixing
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        x = torch.as_tensor(x, dtype=u.dtype).to(u.device)
        if result.mean is not None:
            x = x - result.mean[:, None]
        return result.full_unmixing() @ x
