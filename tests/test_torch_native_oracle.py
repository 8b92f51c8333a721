"""The native f64 oracle that the port's CPU tests are held against is
built before the tests run (the root ``conftest.py``), so a failed or
raced build fails here instead of skipping the oracle's tests."""

import shutil

import pytest


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler to build the oracle")
def test_native_oracle_is_available_when_a_compiler_is():
    from picard_ica_tpu import native

    assert native.available()
