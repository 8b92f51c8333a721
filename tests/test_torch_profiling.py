"""The port's profiling helpers (``picard_ica_tpu_torch/utils/profiling.py``)
on the CPU: the trace parser on a real ``torch.profiler`` trace and on a
synthetic one in Kineto's schema (device events against the host spans
of the same work), ``profile_fit`` and ``fit_with_timing`` against the
JAX package's ``fit_with_timing`` on the same data."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from picard_ica_tpu_torch import Picard, PicardConfig
from picard_ica_tpu_torch.utils.profiling import (
    device_op_counts,
    device_trace_summary,
    fit_with_timing,
    profile_fit,
    span_summary,
)

torch.set_num_threads(2)


def test_device_trace_summary_parses_cpu_trace(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 128)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.tanh(x @ x.T).sum()
    prof.export_chrome_trace(str(tmp_path / "cpu.pt.trace.json.gz"))
    s = device_trace_summary(str(tmp_path), device_substr="CPU")
    assert s["total_us"] > 0.0
    assert s["by_op"]
    assert all(v > 0 for v in s["by_op"].values())
    # per-op totals partition the total (top_k can only drop mass)
    assert sum(s["by_op"].values()) <= s["total_us"] + 1e-6
    assert s["trace_path"].endswith(".pt.trace.json.gz")


def test_device_trace_summary_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        device_trace_summary(str(tmp_path / "nope"))


def _synthetic_trace(path):
    """A host op enclosing its own, a kernel launch on the runtime track,
    a Python frame, and the device's two kernels and one copy, in
    Kineto's chrome-trace schema (pid = the card on the device track)."""
    host, dev = 4242, 0
    events = [
        {"ph": "M", "pid": host, "tid": 0, "name": "process_name", "args": {"name": "python"}},
        {"ph": "M", "pid": dev, "tid": 0, "name": "process_name", "args": {"name": "python"}},
        {"ph": "M", "pid": dev, "tid": 0, "name": "process_labels", "args": {"labels": "GPU 0"}},
        {"ph": "X", "cat": "user_annotation", "name": "picard.core", "pid": host, "tid": 7,
         "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "python_function", "name": "solver.py(200): fit", "pid": host,
         "tid": 7, "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "pid": host, "tid": 7,
         "ts": 10.0, "dur": 300.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": host, "tid": 7,
         "ts": 20.0, "dur": 250.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": host, "tid": 7,
         "ts": 30.0, "dur": 5.0, "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": host, "tid": 7,
         "ts": 400.0, "dur": 5.0, "args": {"correlation": 12}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": host, "tid": 7,
         "ts": 1500.0, "dur": 5.0, "args": {"correlation": 13}},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm", "pid": dev, "tid": 7,
         "ts": 40.0, "dur": 60.0, "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "name": "rotated_fused_tc_kernel<1, 2, 2, true, 0, false>",
         "pid": dev, "tid": 7, "ts": 410.0, "dur": 40.0, "args": {"correlation": 12}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "pid": dev,
         "tid": 7, "ts": 1510.0, "dur": 8.0, "args": {"correlation": 13}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "picard.core", "pid": dev, "tid": 7,
         "ts": 40.0, "dur": 410.0},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": host, "tid": 7, "ts": 30.0, "id": 11},
    ]
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def test_device_trace_summary_kineto_schema(tmp_path):
    """On the card only the kernels and the copy count, never the host
    spans of the same work; on the host the outermost op of the thread
    counts once (the matmul, not also its mm)."""
    _synthetic_trace(tmp_path / "vm.1.pt.trace.json.gz")
    gpu = device_trace_summary(str(tmp_path), device_substr="GPU")
    assert gpu["total_us"] == pytest.approx(108.0)
    assert gpu["by_op"] == {"sm90_xmma_gemm": pytest.approx(60.0),
                            "rotated_fused_tc_kernel<1, 2, 2, true, 0, false>": pytest.approx(40.0),
                            "Memcpy DtoH (Device -> Pinned)": pytest.approx(8.0)}
    assert device_op_counts(str(tmp_path)) == {
        "sm90_xmma_gemm": 1, "rotated_fused_tc_kernel<1, 2, 2, true, 0, false>": 1,
        "Memcpy DtoH (Device -> Pinned)": 1}
    cpu = device_trace_summary(str(tmp_path), device_substr="CPU")
    assert cpu["total_us"] == pytest.approx(300.0)
    assert cpu["by_op"] == {"aten::matmul": pytest.approx(300.0)}
    # the span holds the two launches made inside it, not the later copy
    assert span_summary(str(tmp_path)) == {
        "picard.core": {"wall_us": pytest.approx(1000.0), "device_us": pytest.approx(100.0),
                        "launches": 2}}


def test_profile_fit_returns_the_fit_and_its_trace(tmp_path):
    from picard_ica_tpu_torch.utils import generate_mixed_kurtosis_data

    _, _, x = generate_mixed_kurtosis_data(4, 5_000, 2)
    cfg = PicardConfig(random_state=0, dtype=torch.float64)
    ref = Picard.fit(x, cfg, device="cpu")
    r = profile_fit(x, cfg, device="cpu", trace_dir=str(tmp_path))
    assert r.n_iterations == ref.n_iterations
    assert torch.equal(r.unmixing, ref.unmixing)
    s = device_trace_summary(str(tmp_path), device_substr="CPU")
    assert s["total_us"] > 0.0
    spans = span_summary(str(tmp_path))
    assert {"picard.fit", "picard.whiten", "picard.to_device", "picard.w_init",
            "picard.warm_start", "picard.pre_rotate", "picard.core"} <= set(spans)
    steps = sum(v["wall_us"] for k, v in spans.items() if k not in ("picard.fit", "picard.to_device"))
    assert steps <= spans["picard.fit"]["wall_us"]
    assert all(v["wall_us"] > 0.0 and v["launches"] == 0 for v in spans.values())


def test_fit_with_timing_matches_jax():
    import picard_ica_tpu as J
    from picard_ica_tpu.utils import generate_test_data
    from picard_ica_tpu.utils.profiling import fit_with_timing as jax_fit_with_timing

    _, _, x = generate_test_data(4, 20_000, 3)
    out = fit_with_timing(x, PicardConfig(random_state=0, tol=1e-5, dtype=torch.float64),
                          device="cpu", reps=1)
    ref = jax_fit_with_timing(x, J.PicardConfig(random_state=0, tol=1e-5), reps=1)
    assert out["converged"] and bool(ref["converged"])
    assert out["iterations"] == ref["iterations"]
    assert out["samples_per_s"] > 0 and out["wall_s"] > 0
    assert out["n_chips"] == 1
    assert out["samples_per_s_per_chip"] == out["samples_per_s"]
    np.testing.assert_allclose(out["result"].full_unmixing().numpy(),
                               np.asarray(ref["result"].full_unmixing()), rtol=1e-8, atol=1e-8)


def test_exports_match_the_jax_package():
    import picard_ica_tpu.utils as JU
    import picard_ica_tpu_torch.utils as PU

    assert set(JU.__all__) <= set(PU.__all__)
    assert PU.profile_fit is profile_fit and PU.fit_with_timing is fit_with_timing
    assert os.path.basename(PU.memory_model.__file__) == "memory_model.py"
