"""Every module of the port imports without JAX and without the JAX
package: each is imported in a fresh interpreter, which then holds
neither ``jax`` nor any ``picard_ica_tpu`` module."""

import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("ops", "models", "native", "parallel", "utils")


def _modules():
    import picard_ica_tpu_torch

    return ["picard_ica_tpu_torch"] + [
        info.name for info in pkgutil.walk_packages(picard_ica_tpu_torch.__path__,
                                                    "picard_ica_tpu_torch.")]


def _group(name):
    part = name.split(".")[1] if "." in name else ""
    return part if part in SUBPACKAGES else "package"


def test_the_walk_finds_the_utils_modules():
    names = _modules()
    assert {"picard_ica_tpu_torch.utils.profiling", "picard_ica_tpu_torch.utils.memory_model",
            "picard_ica_tpu_torch.ops.kernels", "picard_ica_tpu_torch.parallel.sharding",
            "picard_ica_tpu_torch.native"} <= set(names)


@pytest.mark.parametrize("group", ("package",) + SUBPACKAGES)
def test_modules_import_without_jax(group):
    names = [m for m in _modules() if _group(m) == group]
    assert names
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'picard_ica_tpu' or m.startswith('picard_ica_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
