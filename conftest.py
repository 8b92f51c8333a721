"""Build the JAX package's native oracle once per test run, before any
xdist worker starts.

``picard_ica_tpu/native`` compiles ``libpicard_native.so`` with g++ on
first use, writing its object files to fixed paths beside the sources
and guarded only by a per-process lock. Under ``pytest -n``, every worker
evaluates the ``skipif(not native.available())`` marks of its files while
it collects, all at about the same moment: the workers overwrite and
delete each other's object files, the losers record a failed build, and
their native-gated tests skip. Building in the controller first leaves
the workers a library that is up to date, which they only load.

The module is loaded from its file path, so that the controller imports
neither ``jax`` nor ``picard_ica_tpu`` before ``tests/conftest.py`` sets
JAX's flags; it needs only ctypes, NumPy and the standard library.
"""

import importlib.util
import os


def _native_module():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "picard_ica_tpu", "native", "__init__.py")
    spec = importlib.util.spec_from_file_location("_picard_native_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pytest_configure(config):
    # xdist workers carry ``workerinput``; the controller (or a run
    # without xdist) builds.
    if not hasattr(config, "workerinput"):
        _native_module().available()
