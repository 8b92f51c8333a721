"""The port's ``Picard`` facade against the JAX package's, on the CPU.

End to end on an 8 x 20,000 mixed sub/super-Gaussian mixture (float64
NumPy input):
  * f64 (``dtype=torch.float64`` vs the JAX facade under x64, both
    whitened on the device in f64): the same iteration count and the
    same unmixing to 1e-9 (the same f64 algorithm; BLAS summation orders
    differ);
  * f32 (the default vs the JAX facade with ``dtype=float32``, both
    whitened on the host in f64): both converge and the full unmixings
    agree to Amari < 1e-5 (two f32 trajectories to tol 1e-7 from one f64
    whitening).
Plus the routing between host and device whitening, the typed errors,
the mesh check (sharded fits: tests/test_torch_parallel.py), the device
rule and the package's independence from JAX.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picard_ica_tpu as J
import picard_ica_tpu_torch as P
from picard_ica_tpu_torch import convert, solver
from picard_ica_tpu_torch.ops.whitening import preprocess_f64
from picard_ica_tpu_torch.utils import amari_distance, generate_mixed_kurtosis_data

from test_torch_core_wgmma import PluginTanh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mixture():
    _, a, x = generate_mixed_kurtosis_data(8, 20_000, 1)
    return a, x


def _inv(w):
    return np.linalg.inv(np.asarray(w, np.float64))


def test_fit_and_transform_f64_match_jax(mixture):
    a, x = mixture
    rj = J.Picard.fit(x, J.PicardConfig(random_state=0))
    rt = P.Picard.fit(x, P.PicardConfig(random_state=0, dtype=torch.float64), device="cpu")
    assert rt.converged and bool(rj.converged)
    assert rt.n_iterations == rj.n_iterations
    assert rt.unmixing.dtype == torch.float64 and rt.sources.shape == (8, 20_000)
    np.testing.assert_allclose(rt.full_unmixing().numpy(), np.asarray(rj.full_unmixing()),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(rt.signs.numpy(), np.asarray(rj.signs))
    np.testing.assert_allclose(rt.sources.numpy(), np.asarray(rj.sources), rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(rt.mixing().numpy(), np.asarray(rj.mixing()), rtol=1e-8, atol=1e-8)
    x_new = x[:, :500]
    np.testing.assert_allclose(P.Picard.transform(x_new, rt).numpy(),
                               np.asarray(J.Picard.transform(x_new, rj)), rtol=1e-8, atol=1e-8)
    assert amari_distance(rt.full_unmixing().numpy(), a) < 5e-3


@pytest.mark.parametrize("use_kernels", [None, True], ids=["auto", "kernels"])
def test_fit_f32_matches_jax(mixture, use_kernels):
    a, x = mixture
    rj = J.Picard.fit(x, J.PicardConfig(random_state=0, dtype=jnp.float32,
                                        use_pallas=bool(use_kernels)))
    rt = P.Picard.fit(x, P.PicardConfig(random_state=0, use_kernels=use_kernels),
                      device="cpu")
    assert rt.converged and bool(rj.converged)
    assert rt.unmixing.dtype == torch.float32
    assert rt.stage_precisions == tuple(rj.stage_precisions) == ("bf16", "bf16x3", "f32")
    assert len(rt.stage_exits) == 3 and rt.ls_calls >= rt.n_iterations
    assert rt.core_seconds > 0
    am = amari_distance(rt.full_unmixing().double().numpy(), _inv(rj.full_unmixing()))
    assert am < 1e-5, am
    assert amari_distance(rt.full_unmixing().double().numpy(), a) < 5e-3


def test_w_init_and_config_carried_from_jax(mixture):
    _, x = mixture
    w0 = np.linalg.qr(np.random.default_rng(3).standard_normal((8, 8)))[0]
    jcfg = J.PicardConfig(w_init=w0, max_iter=5, ortho=True, extended=False,
                          density=J.Exp(0.7), random_state=1)
    fields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__ if f != "density"}
    fields["density"] = {"name": type(jcfg.density).__name__, "alpha": jcfg.density.alpha}
    tcfg = convert.config_from_fields(fields).replace(dtype=torch.float64)
    assert tcfg.density == P.Exp(0.7) and tcfg.use_kernels is None
    rj = J.Picard.fit(x, jcfg)
    rt = P.Picard.fit(x, tcfg, device="cpu")
    assert rt.n_iterations == rj.n_iterations == 5
    np.testing.assert_allclose(rt.unmixing.numpy(), np.asarray(rj.unmixing), rtol=1e-9, atol=1e-9)
    back = convert.result_from_arrays(rj)
    np.testing.assert_array_equal(back.unmixing.numpy(), np.asarray(rj.unmixing))
    assert back.n_iterations == 5 and back.stage_exits == tuple(rj.stage_exits)
    np.testing.assert_array_equal(convert.w_init_from_array(w0).numpy(), w0)


def test_use_pallas_carries_to_the_streaming_kernels(monkeypatch):
    """A JAX config with use_pallas=True converts to use_kernels=True, and
    a port fit at N = 72 with it takes the streaming kernels' route."""
    from picard_ica_tpu_torch.ops import kernels as K

    jcfg = J.PicardConfig(use_pallas=True, random_state=0, max_iter=3)
    fields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__ if f != "density"}
    fields["density"] = {"name": type(jcfg.density).__name__, "alpha": jcfg.density.alpha}
    tcfg = convert.config_from_fields(fields)
    assert tcfg.use_kernels is True
    calls = []
    real = K.streaming_fused_sums

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(K, "streaming_fused_sums", spy)
    _, _, x = generate_mixed_kurtosis_data(72, 3000, 4)
    r = P.Picard.fit(x, tcfg, device="cpu")
    assert calls and r.n_iterations == 3


def test_no_preprocessing_takes_tensor_input():
    _, _, x = generate_mixed_kurtosis_data(4, 5000, 2)
    xw = np.linalg.qr(np.random.default_rng(0).standard_normal((4, 4)))[0] @ (
        x / x.std(axis=1, keepdims=True))
    xt = torch.from_numpy(xw - xw.mean(axis=1, keepdims=True))
    cfg = P.PicardConfig(random_state=0, centering=False, whiten=False, dtype=torch.float64)
    r = P.Picard.fit(xt, cfg, device="cpu")
    assert r.sources.device == xt.device and r.whitening is None and r.mean is None
    assert r.n_iterations >= 1
    assert not torch.equal(xt, r.sources)  # the input buffer is not overwritten


def test_typed_errors():
    x = np.random.default_rng(0).standard_normal((3, 200))
    with pytest.raises(P.InvalidConfigError):
        P.Picard.fit(x, P.PicardConfig(max_iter=0), device="cpu")
    with pytest.raises(P.InvalidConfigError):
        P.Picard.fit(x, P.PicardConfig(fastica_it=2, jade_it=2), device="cpu")
    with pytest.raises(P.InvalidConfigError):
        P.Picard.fit(x, P.PicardConfig(dtype=torch.float16), device="cpu")
    with pytest.raises(P.InvalidDimensionsError):
        P.Picard.fit(np.zeros(10), device="cpu")
    with pytest.raises(P.InvalidDimensionsError):
        P.Picard.fit(np.zeros((3, 0)), device="cpu")
    with pytest.raises(P.InvalidDimensionsError):
        P.Picard.fit(x, P.PicardConfig(w_init=np.eye(2)), device="cpu")
    with pytest.raises(P.InvalidDimensionsError):
        P.Picard.fit(torch.from_numpy(x), P.PicardConfig(whiten_precision="f64"),
                     device="cpu")
    with pytest.raises(P.SingularMatrixError):
        P.Picard.fit(np.ones((3, 200)), device="cpu")
    with pytest.raises(P.NotConvergedError):
        P.Picard.fit(x, P.PicardConfig(max_iter=1, raise_on_no_convergence=True,
                                       random_state=0), device="cpu")


def test_parts_not_ported_raise_not_implemented():
    """Every part is ported: a ``mesh`` that is not a 1-D DeviceMesh is a
    typed configuration error (sharded fits: tests/test_torch_parallel.py),
    and the warm starts run (tests/test_torch_jade.py,
    test_torch_fastica.py)."""
    x = np.random.default_rng(0).standard_normal((3, 200))
    for mesh in (object(), "samples"):
        with pytest.raises(P.InvalidConfigError, match="mesh"):
            P.Picard.fit_with_config(x, P.PicardConfig(), device="cpu", mesh=mesh)
        with pytest.raises(P.InvalidConfigError, match="1-D"):
            P.Picard.fit(x, P.PicardConfig(), mesh=mesh)
    for cfg in (P.PicardConfig(jade_it=3), P.PicardConfig(fastica_it=3)):
        r = P.Picard.fit(x, cfg.replace(random_state=0, max_iter=2), device="cpu")
        assert r.n_iterations >= 1


def _no_host_f64(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("took the host-f64 preprocessing")

    monkeypatch.setattr(solver, "preprocess_f64", refuse)


@pytest.mark.parametrize("kind", ["f32", "tensor", "device", "oversized-f64"])
def test_device_whitening_inputs_fit(mixture, monkeypatch, kind):
    """f32 NumPy input, a tensor, whiten_precision='device' and f64 input
    above the host limit are centered and whitened on the device."""
    a, x = mixture
    _no_host_f64(monkeypatch)
    cfg = P.PicardConfig(random_state=0)
    if kind == "f32":
        x = x.astype(np.float32)
    elif kind == "tensor":
        x = torch.from_numpy(x)
    elif kind == "device":
        cfg = cfg.replace(whiten_precision="device")
    else:
        monkeypatch.setattr(solver, "_HOST_F64_MAX_ELEMENTS", x.size - 1)
    r = P.Picard.fit(x, cfg, device="cpu")
    assert r.converged and r.unmixing.dtype == torch.float32
    assert r.whitening.shape == (8, 8) and r.mean.shape == (8,)
    assert amari_distance(r.full_unmixing().double().numpy(), a) < 5e-3


def test_auto_f64_core_whitens_on_the_device_as_jax(mixture, monkeypatch):
    """'auto' keeps the host-f64 pass for an f32 core only (the JAX
    package's rule): an f64 fit of f64 NumPy input takes the device path
    in both packages and they agree to 1e-9."""
    a, x = mixture
    calls = []
    monkeypatch.setattr(solver, "preprocess_f64",
                        lambda *args: calls.append(1) or preprocess_f64(*args))
    P.Picard.fit(x, P.PicardConfig(random_state=0, max_iter=2), device="cpu")
    assert calls == [1]  # f32 core: host f64

    _no_host_f64(monkeypatch)
    rj = J.Picard.fit(x, J.PicardConfig(random_state=0))
    rt = P.Picard.fit(x, P.PicardConfig(random_state=0, dtype=torch.float64), device="cpu")
    assert rt.converged and rt.n_iterations == rj.n_iterations
    np.testing.assert_allclose(rt.full_unmixing().numpy(), np.asarray(rj.full_unmixing()),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rt.whitening.numpy(), np.asarray(rj.whitening),
                               rtol=1e-12, atol=1e-12)


def test_fit_needs_cuda_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).standard_normal((3, 200))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Picard.fit(x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_tensor_without_device_needs_cuda(monkeypatch, dtype):
    """A CPU tensor does not pick the CPU: without ``device=`` the fit
    goes to the card, and without one it raises as NumPy input does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 200))).to(dtype)
    before = x.clone()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Picard.fit(x, P.PicardConfig(random_state=0))
    assert torch.equal(x, before)


def test_device_rule(monkeypatch):
    """``device`` wins; else a CUDA tensor's own card; else "cuda"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    x = torch.zeros((3, 10))
    assert solver._resolve_device(x, None) == torch.device("cuda")
    assert solver._resolve_device(x.numpy(), None) == torch.device("cuda")
    assert solver._resolve_device(x, "cpu") == torch.device("cpu")
    meta = torch.empty((3, 10), device="meta")
    assert solver._resolve_device(meta, None) == torch.device("cuda")


def test_import_leaves_jax_out():
    code = ("import sys, picard_ica_tpu_torch, picard_ica_tpu_torch.convert, "
            "picard_ica_tpu_torch.ops.kernels; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('picard_ica_tpu.') or m == 'picard_ica_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_public_names_match_jax_package():
    assert set(J.__all__) <= set(P.__all__)
    for name in P.__all__:
        assert hasattr(P, name)


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both TF32 flags on, as a caller may set them; the test's own
    values are put back after it."""
    saved = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _record_fused_flags(monkeypatch):
    """Record the TF32 flags at every fused-pass call of the core loop."""
    from picard_ica_tpu_torch.models import core

    seen = []
    real = core.rotated_fused_sums

    def spy(*args, **kwargs):
        seen.append(_tf32_flags())
        return real(*args, **kwargs)

    monkeypatch.setattr(core, "rotated_fused_sums", spy)
    return seen


def test_fit_and_transform_keep_the_callers_tf32_flags(mixture, monkeypatch, tf32_on):
    """Inside the fit both flags are off (exact f32); after the fit and
    after transform they hold the caller's values again."""
    _, x = mixture
    seen = _record_fused_flags(monkeypatch)
    r = P.Picard.fit(x, P.PicardConfig(random_state=0, use_kernels=True), device="cpu")
    assert r.converged and seen and set(seen) == {(False, False)}
    assert _tf32_flags() == (True, True)
    inside = []
    real_full = P.PicardResult.full_unmixing
    monkeypatch.setattr(P.PicardResult, "full_unmixing",
                        lambda self: inside.append(_tf32_flags()) or real_full(self))
    y = P.Picard.transform(x[:, :300], r)
    assert inside == [(False, False)] and y.shape == (8, 300)
    assert _tf32_flags() == (True, True)


def test_fit_restores_the_tf32_flags_when_it_raises(mixture, monkeypatch, tf32_on):
    from picard_ica_tpu_torch.models import core

    _, x = mixture
    seen = []

    def fail(*args, **kwargs):
        seen.append(_tf32_flags())
        raise RuntimeError("refused launch")

    monkeypatch.setattr(core, "rotated_fused_sums", fail)
    with pytest.raises(RuntimeError, match="refused launch"):
        P.Picard.fit(x, P.PicardConfig(random_state=0, use_kernels=True), device="cpu")
    assert seen == [(False, False)]
    assert _tf32_flags() == (True, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_auto_use_kernels_rule(dtype):
    """use_kernels=None hands an f32 fit on the card to the kernels up to
    AUTO_KERNELS_MAX_N components (past the resident kernels' capacity
    the streaming ones take it) and never an f64 fit or a fit on the
    CPU."""
    from picard_ica_tpu_torch.ops.kernels import KERNEL_MAX_N, STREAM_MAX_N

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cap = solver.AUTO_KERNELS_MAX_N
    f32 = dtype == torch.float32
    d = P.Tanh()
    assert KERNEL_MAX_N <= cap <= STREAM_MAX_N
    for n in (2, KERNEL_MAX_N, KERNEL_MAX_N + 1, cap):
        assert solver._auto_use_kernels(cuda, dtype, n, d) is f32
        assert solver._auto_use_kernels(cpu, dtype, n, d) is False
    assert solver._auto_use_kernels(cuda, dtype, cap + 1, d) is False


class DeltaTanh(P.Tanh):
    """A ``Tanh`` subclass with its own delta pass (here the direct
    difference of the log-likelihoods), which the kernels' tanh would
    silently replace."""

    def score_der_loglik_delta(self, y_old, dy):
        score, der = self.score_and_der(y_old + dy)
        return score, der, self.log_lik(y_old + dy) - self.log_lik(y_old)


PLUGINS = {"protocol plugin": PluginTanh, "Tanh subclass": DeltaTanh}


@pytest.mark.parametrize("density", [P.Tanh(), P.Tanh(0.5), P.Exp(), P.Exp(0.7), P.Cube()],
                         ids=["tanh", "tanh0.5", "exp", "exp0.7", "cube"])
def test_auto_use_kernels_takes_the_kernels_densities(density):
    """The auto rule hands an f32 fit on the card to the kernels for
    exactly the densities they implement, whatever their alpha."""
    assert solver._auto_use_kernels(torch.device("cuda"), torch.float32, 64, density) is True
    assert solver._resolve_use_kernels(None, torch.device("cuda"), torch.float32, 64,
                                       density) is True
    assert solver._resolve_use_kernels(True, torch.device("cuda"), torch.float32, 64,
                                       density) is True


@pytest.mark.parametrize("make", PLUGINS.values(), ids=PLUGINS.keys())
def test_auto_use_kernels_refuses_plugin_densities(make):
    """A plugin density, or a Tanh subclass with a formula of its own,
    runs the torch path under the auto rule; an explicit use_kernels=True
    on the card is refused, on the CPU (the kernels' plain versions call
    the density's own methods) it stands."""
    from picard_ica_tpu_torch.ops import kernels as K

    d = make()
    assert isinstance(d, P.Density)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for n in (2, 64, 65, solver.AUTO_KERNELS_MAX_N):
        assert solver._auto_use_kernels(cuda, torch.float32, n, d) is False
        assert solver._resolve_use_kernels(None, cuda, torch.float32, n, d) is False
    assert not K.kernel_density(d)
    with pytest.raises(P.InvalidConfigError, match="use_kernels"):
        solver._resolve_use_kernels(True, cuda, torch.float32, 64, d)
    assert solver._resolve_use_kernels(True, cpu, torch.float32, 64, d) is True
    assert solver._resolve_use_kernels(False, cuda, torch.float32, 64, d) is False


def test_density_code_refuses_a_tanh_subclass():
    """The kernels select their formula by exact type: a subclass that
    overrides a formula is refused, not run as the kernels' tanh."""
    from picard_ica_tpu_torch.ops import kernels as K

    assert K._density_code(P.Tanh(0.5)) == (0, 0.5)
    assert K._density_code(P.Exp(0.7)) == (1, 0.7)
    assert K._density_code(P.Cube()) == (2, 1.0)
    for make in PLUGINS.values():
        with pytest.raises(NotImplementedError, match="Tanh, Exp and Cube"):
            K._density_code(make())


@pytest.mark.parametrize("make", PLUGINS.values(), ids=PLUGINS.keys())
@pytest.mark.parametrize("whiten_precision", ["f64", "device"])
def test_use_kernels_with_a_plugin_density_raises_before_whitening(
        mixture, monkeypatch, make, whiten_precision):
    """use_kernels=True on the card with a density the kernels do not
    implement raises InvalidConfigError before either whitening path
    runs (nothing reaches the card: this sandbox has none)."""
    _, x = mixture
    called = []
    for name in ("center_whiten", "preprocess_f64"):
        monkeypatch.setattr(solver, name, lambda *a, _n=name, **k: called.append(_n))
    cfg = P.PicardConfig(random_state=0, use_kernels=True, density=make(),
                         whiten_precision=whiten_precision)
    with pytest.raises(P.InvalidConfigError, match="Tanh, Exp and Cube"):
        P.Picard.fit(x, cfg, device="cuda")
    assert called == []


def test_fit_with_a_plugin_density_on_the_cpu_kernel_path(mixture):
    """On the CPU, use_kernels=True with a plugin density runs the
    kernels' plain versions through the plugin's own methods, and lands
    where the torch path does."""
    a, x = mixture
    common = dict(random_state=0, density=PluginTanh())
    rk = P.Picard.fit(x, P.PicardConfig(use_kernels=True, **common), device="cpu")
    rt = P.Picard.fit(x, P.PicardConfig(use_kernels=False, **common), device="cpu")
    assert rk.converged and rt.converged
    assert amari_distance(rk.full_unmixing().double().numpy(),
                          _inv(rt.full_unmixing())) < 1e-3
    assert amari_distance(rk.full_unmixing().double().numpy(), a) < 5e-3
