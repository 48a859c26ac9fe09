"""Shared pytest configuration for the tier-1 suite.

Two jobs:
  * register the ``slow`` marker (used by the distributed tests and the CI
    fast lane's ``-m "not slow"`` filter);
  * make ``hypothesis`` optional: when the real package is missing (it is a
    dev-only dependency, see requirements-dev.txt), install a minimal stub
    into ``sys.modules`` BEFORE test modules import it, so collection never
    hard-errors and the property tests still run as fixed-example
    parametrizations instead of being skipped wholesale.
"""
from __future__ import annotations

import sys
import types

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test, excluded from the fast CI lane "
        "(deselect with -m \"not slow\")")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where "
        "torch.cuda.is_available() is false")


def _install_hypothesis_stub() -> None:
    """Degraded-mode ``hypothesis``: @given draws a handful of boundary +
    midpoint examples per strategy and parametrizes over them."""

    class _Strategy:
        def __init__(self, examples):
            self.examples = list(examples)

    def floats(lo, hi):
        return _Strategy([lo, hi, (lo + hi) / 2.0])

    def integers(lo, hi):
        mid = (lo + hi) // 2
        return _Strategy([lo, hi, mid])

    def sampled_from(xs):
        return _Strategy(list(xs))

    def settings(*a, **kw):
        def deco(fn):
            return fn
        return deco

    def given(**kw):
        keys = sorted(kw)
        n = max(len(kw[k].examples) for k in keys)
        cases = [tuple(kw[k].examples[i % len(kw[k].examples)]
                       for k in keys) for i in range(n)]
        if len(keys) == 1:  # parametrize wants scalars for one argname
            cases = [c[0] for c in cases]

        def deco(fn):
            return pytest.mark.parametrize(",".join(keys), cases)(fn)
        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.__is_stub__ = True
    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.floats = floats
    st_mod.integers = integers
    st_mod.sampled_from = sampled_from
    mod.strategies = st_mod
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()
