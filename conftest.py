"""Test tiers, decided in one place, and what xdist's workers must not race on.

`slow` is the one marker that tier-1 (`-m 'not slow'`) leaves out. A `-m` on
the command line replaces the one in `pytest.ini`'s `addopts`, so the hook
below makes every `heavy` test `slow` before pytest deselects by `-m`.
"""

import sys

import pytest


def pytest_configure(config):
    # The JAX package builds native/libwitness.so on first use through one
    # shared temporary name, so in a fresh checkout two xdist workers can
    # interleave their builds and load a truncated library. Build it once in
    # the controller (tests/conftest.py has imported the package by now),
    # before any worker starts.
    if hasattr(config, "workerinput") or "starky_bn254_tpu" not in sys.modules:
        return
    from starky_bn254_tpu import native

    native.available()


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.get_closest_marker("heavy") is not None:
            item.add_marker(pytest.mark.slow)
