"""Checkpoint / resume for fitted Picard models (PyTorch port).

Counterpart of ``picard_ica_tpu/checkpoint.py``: a fitted
:class:`~picard_ica_tpu_torch.results.PicardResult` round-trips through
one ``.npz`` file in the JAX package's layout (format 2, the same keys
and dtypes), so a file saved by either package loads in the other, and
:func:`resume_config` turns a saved result into the warm start of a
continued run:

    result = Picard.fit(x, config)
    save_result("fit.npz", result)
    ...
    prev = load_result("fit.npz")             # tensors on "cuda"
    cfg2 = resume_config(prev, config.replace(tol=1e-9))
    result2 = Picard.fit(x, cfg2)             # starts at the previous solution

``core_seconds`` is a measurement of one run, not part of the format,
and is not stored.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import PicardConfig
from .results import PicardResult
from .solver import _resolve_device

# Version 2: the diagnostics (stage_exits, stage_precisions, ls_calls,
# stage_ls_calls) round-trip too. Version-1 files still load, their
# diagnostic fields None.
_FORMAT_VERSION = 2


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array as a host NumPy array. A
    ``DTensor`` (a sharded fit's sources) is gathered whole first: a
    collective that every rank of its mesh calls."""
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_result(path, result: PicardResult, include_sources: bool = True) -> None:
    """Serialize a fit result to ``path`` (.npz).

    ``include_sources=False`` drops the (n_components, n_samples)
    sources matrix — for large T the unmixing matrices are what a
    resume needs and the sources can be recomputed with ``transform``.
    The sources of a sample-sharded fit are gathered into the file, so
    every rank of its mesh calls this (each may write its own path).
    """
    payload = {
        "format_version": np.asarray(_FORMAT_VERSION),
        "unmixing": _host(result.unmixing),
        "n_iterations": np.asarray(result.n_iterations),
        "converged": np.asarray(result.converged),
        "gradient_norm": np.asarray(result.gradient_norm),
    }
    if include_sources:
        payload["sources"] = _host(result.sources)
    if result.whitening is not None:
        payload["whitening"] = _host(result.whitening)
    if result.mean is not None:
        payload["mean"] = _host(result.mean)
    if result.signs is not None:
        payload["signs"] = _host(result.signs)
    if result.stage_exits is not None:
        payload["stage_exits"] = np.asarray(result.stage_exits, np.int64)
    if result.stage_precisions is not None:
        payload["stage_precisions"] = np.asarray(result.stage_precisions, np.str_)
    if result.ls_calls is not None:
        payload["ls_calls"] = np.asarray(result.ls_calls, np.int64)
    if result.stage_ls_calls is not None:
        payload["stage_ls_calls"] = np.asarray(result.stage_ls_calls, np.int64)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_result(path, device=None) -> PicardResult:
    """Load a result saved by :func:`save_result` (of either package).

    Its arrays come back as tensors on ``device``: by the fit's rule,
    CUDA unless the caller passes a device, and an error without CUDA.
    """
    device = _resolve_device(None, device)

    def tensor(z, key):
        return torch.from_numpy(z[key]).to(device) if key in z else None

    with np.load(path) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {version} is newer than supported "
                f"({_FORMAT_VERSION})"
            )
        return PicardResult(
            whitening=tensor(z, "whitening"),
            unmixing=tensor(z, "unmixing"),
            sources=tensor(z, "sources"),
            mean=tensor(z, "mean"),
            n_iterations=int(z["n_iterations"]),
            converged=bool(z["converged"]),
            gradient_norm=float(z["gradient_norm"]),
            signs=tensor(z, "signs"),
            stage_exits=(tuple(int(v) for v in z["stage_exits"])
                         if "stage_exits" in z else None),
            stage_precisions=(tuple(str(v) for v in z["stage_precisions"])
                              if "stage_precisions" in z else None),
            ls_calls=int(z["ls_calls"]) if "ls_calls" in z else None,
            stage_ls_calls=(tuple(int(v) for v in z["stage_ls_calls"])
                            if "stage_ls_calls" in z else None),
        )


def resume_config(previous: PicardResult, config: PicardConfig) -> PicardConfig:
    """Derive a config that warm-starts from ``previous``'s solution.

    Sets ``w_init`` to the previous unmixing matrix, as a host NumPy
    array, and clears any JADE / FastICA warm start (they would
    overwrite it). The data passed to the resumed ``fit`` must have the
    same n_components.

    ``previous.unmixing`` lives in the whitening basis of the data it
    was fitted on, and a resumed fit applies it in the basis of its own
    data: on the same data the resume continues where the fit stopped;
    on fresh data from the same sources it is a good but inexact start
    (the bases differ by sampling noise); on unrelated data it is no
    better than random. To apply a model to other data, use
    :meth:`~picard_ica_tpu_torch.solver.Picard.transform`.
    """
    return config.replace(
        w_init=_host(previous.unmixing),
        jade_it=None,
        fastica_it=None,
    )
