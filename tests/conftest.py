"""Shared test config: optional-dependency shim for ``hypothesis``.

Several test modules import hypothesis at module scope for property
tests. The tier-1 environment does not guarantee it (see
requirements-dev.txt); rather than erroring 4 modules out of collection,
install a stub into sys.modules whose ``@given`` marks the test as
skipped — every non-property test in those modules still runs.
"""
from __future__ import annotations

import sys
import types

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "x64: enables global float64 for paper-table precision")
    config.addinivalue_line(
        "markers", "slow: spawns worker processes / builds models repeatedly")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (hand-written CUDA "
        "kernels of repro_torch); skips without one")


try:
    import hypothesis  # noqa: F401  (real library present: no shim)
except ImportError:
    def given(*_args, **_kwargs):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (see requirements-dev.txt)"
            )(fn)
        return deco

    def settings(*_args, **_kwargs):
        def deco(fn):
            return fn
        return deco

    class _AnyStrategy:
        """Stands in for any strategy constructor: st.integers(...), etc.
        Never executed — @given skips the test before the body runs."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    strategies = types.ModuleType("hypothesis.strategies")
    strategies.__getattr__ = lambda name: _AnyStrategy()

    stub = types.ModuleType("hypothesis")
    stub.given = given
    stub.settings = settings
    stub.strategies = strategies
    stub.__is_repro_stub__ = True
    sys.modules["hypothesis"] = stub
    sys.modules["hypothesis.strategies"] = strategies
