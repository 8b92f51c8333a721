"""Profiling helpers on ``torch.profiler`` (the counterpart of
``picard_ica_tpu/utils/profiling.py``, which wraps ``jax.profiler``).

``profile_fit`` runs a fit under a profiler trace and writes a Chrome
trace (``*.pt.trace.json.gz``, viewable in Perfetto or
``chrome://tracing``) that ``device_trace_summary`` parses.
``fit_with_timing`` reports the numbers BASELINE.md tracks: wall time,
iterations to tolerance, and grad-loop samples/s per card.
``span_summary`` reads the ``picard.*`` spans that ``Picard.fit`` opens
around the fit and its steps (``picard.whiten``, inside it
``picard.to_device``, the cast and copy of the data to the fit's device,
then ``picard.w_init``, ``picard.warm_start``, ``picard.pre_rotate`` and
``picard.core``): each span's host wall time and the device time of the
work it launched.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import socket
import tempfile
import time
from typing import Optional

import torch

from ..config import PicardConfig
from ..parallel.mesh import local_device
from ..solver import Picard, _resolve_device

# Kineto's categories of work that ran on the device: kernels, copies and
# fills. Every other category is a host
# span (``cpu_op``, ``cuda_runtime``, ``cuda_driver``, ``python_function``,
# ``user_annotation``) or a device-side copy of a host span
# (``gpu_user_annotation``), which would count the same time twice.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# The prefix of the spans Picard.fit opens (solver._span).
SPAN_PREFIX = "picard."


def _fit_device(x, device, mesh) -> torch.device:
    """The device ``Picard.fit`` will run on (its own rule)."""
    if device is not None:
        return torch.device(device)
    if mesh is not None:
        return local_device(mesh)
    return _resolve_device(x, None)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Seconds of idle device between the trace's start or end and the fit's
# first or last launch. Without them the second trace taken in one
# process lost the fit's first kernels (the whitening's) on an H100.
TRACE_MARGIN_S = 0.05


def _settle(device: torch.device) -> None:
    _sync(device)
    if device.type == "cuda":
        time.sleep(TRACE_MARGIN_S)


def profile_fit(x, config: Optional[PicardConfig] = None, mesh=None, device=None,
                trace_dir: Optional[str] = None):
    """Run ``Picard.fit`` under a ``torch.profiler`` trace; returns the
    result.

    The host's activity is always traced, the card's when the fit runs
    on one; the device is synchronized before the trace closes, so the
    trace holds every kernel the fit launched. The trace goes to
    ``trace_dir`` (default: ``picard_trace`` in the temporary directory)
    as ``<host>.<ns>.pt.trace.json.gz``. The caller should have run the
    same fit once before (the kernels' build and load, cuBLAS's handles),
    so the trace shows the steady state.
    """
    dev = _fit_device(x, device, mesh)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        _settle(dev)
        result = Picard.fit(x, config, device=device, mesh=mesh)
        _settle(dev)
    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "picard_trace")
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{socket.gethostname()}.{time.time_ns()}.pt.trace.json.gz"))
    return result


def _newest_trace(trace_dir: str) -> str:
    paths = [p for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace dumps under {trace_dir}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def _load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _outermost(events: list) -> list:
    """The events not enclosed by another of ``events`` on their thread."""
    out = []
    by_thread: dict = {}
    for ev in events:
        by_thread.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for evs in by_thread.values():
        end = float("-inf")
        for ev in sorted(evs, key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0)))):
            ts = float(ev["ts"])
            if ts >= end:
                out.append(ev)
                end = ts + float(ev.get("dur", 0.0))
    return out


def _counted(events: list, device_substr: str) -> list:
    """The complete ("X") events that make up the summary: on the host
    (``device_substr`` naming the CPU) the outermost ``cpu_op`` of each
    thread, else the device's kernels, copies and fills."""
    complete = [ev for ev in events if ev.get("ph") == "X" and "ts" in ev]
    if "cpu" in device_substr.lower():
        return _outermost([ev for ev in complete if ev.get("cat") == "cpu_op"])
    return [ev for ev in complete if ev.get("cat") in DEVICE_CATEGORIES]


def device_trace_summary(trace_dir: str, device_substr: str = "GPU",
                         top_k: int = 12) -> dict:
    """Aggregate op time from the newest ``torch.profiler`` trace under
    ``trace_dir``::

        {"total_us": float,            # summed op duration
         "by_op":   {name: us, ...},  # per-op totals, descending, top_k
         "trace_path": str}

    Raises ``FileNotFoundError`` when there is none.

    On the card (``device_substr`` "GPU", the default, or "CUDA") only
    device events count: kernels and the memcpy / memset events. The
    host's spans of the same work (``cpu_op``, ``cudaLaunchKernel`` and the
    other ``cuda_runtime`` calls, Python frames, annotations) never do.
    On the host (``device_substr="CPU"``) only the outermost ``cpu_op`` of
    each thread counts: an ``aten::matmul`` that encloses its ``aten::mm``
    is counted once. This is the rule of the JAX parser, which keeps the
    per-op "XLA Ops" track and drops the "XLA Modules" aggregate that
    holds the same time.

    ``total_us`` over-counts when ops overlap: kernels on several streams
    of one card, or ops on several host threads. The port launches its
    work on one stream, so on the card the sum is the device busy time.
    """
    path = _newest_trace(trace_dir)
    by_op: dict = {}
    total = 0.0
    for ev in _counted(_load_events(path), device_substr):
        dur = float(ev.get("dur", 0.0))
        total += dur
        name = ev.get("name", "?")
        by_op[name] = by_op.get(name, 0.0) + dur
    by_op = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:top_k])
    return {"total_us": total, "by_op": by_op, "trace_path": path}


def device_op_counts(trace_dir: str, device_substr: str = "GPU") -> dict:
    """``{name: events}`` over every op ``device_trace_summary`` counts
    in the newest trace: on the card, the launches of each kernel (by its
    demangled name, template arguments included)."""
    counts: dict = {}
    for ev in _counted(_load_events(_newest_trace(trace_dir)), device_substr):
        name = ev.get("name", "?")
        counts[name] = counts.get(name, 0) + 1
    return counts


def span_summary(trace_dir: str, prefix: str = SPAN_PREFIX) -> dict:
    """``{span: {"wall_us", "device_us", "launches"}}`` for the host
    annotations named ``prefix``* in the newest trace (the steps of
    ``Picard.fit``, summed over repeats): the host wall time inside the
    span, and the duration and count of the device events whose launch
    (a ``cuda_runtime`` call, matched by its correlation id) ran inside
    it on the same thread. ``device_us / wall_us`` is the card's busy
    share of the step."""
    events = [ev for ev in _load_events(_newest_trace(trace_dir))
              if ev.get("ph") == "X" and "ts" in ev]
    spans = [ev for ev in events if ev.get("cat") == "user_annotation"
             and str(ev.get("name", "")).startswith(prefix)]
    device: dict = {}
    for ev in events:
        if ev.get("cat") in DEVICE_CATEGORIES:
            corr = ev.get("args", {}).get("correlation")
            d = device.setdefault(corr, [0.0, 0])
            d[0] += float(ev.get("dur", 0.0))
            d[1] += 1
    launches = [ev for ev in events if ev.get("cat") == "cuda_runtime"
                and ev.get("args", {}).get("correlation") in device]
    out: dict = {}
    for span in spans:
        lo, hi = float(span["ts"]), float(span["ts"]) + float(span.get("dur", 0.0))
        row = out.setdefault(span["name"], {"wall_us": 0.0, "device_us": 0.0, "launches": 0})
        row["wall_us"] += hi - lo
        for ev in launches:
            if (ev.get("pid"), ev.get("tid")) == (span.get("pid"), span.get("tid")) \
                    and lo <= float(ev["ts"]) <= hi:
                us, n = device[ev["args"]["correlation"]]
                row["device_us"] += us
                row["launches"] += n
    return out


def fit_with_timing(x, config: Optional[PicardConfig] = None, mesh=None, device=None,
                    reps: int = 3) -> dict:
    """Fit ``reps`` times (after one warm-up) and report throughput.

    Each fit is timed between two synchronizations of its device. Returns
    a dict with the fitted result plus ``wall_s`` (best of reps),
    ``iterations``, ``converged``, ``samples_per_s`` (T * iterations /
    wall — the grad-loop rate BASELINE.md's headline metric uses,
    attributing the whole wall time to the optimizer loop, i.e. a lower
    bound), ``samples_per_s_per_chip`` and ``n_chips`` (the mesh's world
    size, else 1).
    """
    dev = _fit_device(x, device, mesh)

    def timed():
        _sync(dev)
        t0 = time.perf_counter()
        result = Picard.fit(x, config, device=device, mesh=mesh)
        _sync(dev)
        return result, time.perf_counter() - t0

    result, _ = timed()
    best = float("inf")
    for _ in range(reps):
        result, seconds = timed()
        best = min(best, seconds)

    t = x.shape[1]
    n_chips = mesh.size() if mesh is not None else 1
    sps = t * max(result.n_iterations, 1) / best
    return {
        "result": result,
        "wall_s": best,
        "iterations": result.n_iterations,
        "converged": result.converged,
        "samples_per_s": sps,
        "samples_per_s_per_chip": sps / n_chips,
        "n_chips": n_chips,
    }
