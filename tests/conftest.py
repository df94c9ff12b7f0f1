"""Shared fixtures. Platform pinning happens in the root conftest.py."""

import os

import numpy as np
import pytest

REFERENCE_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_DIR)


requires_reference = pytest.mark.skipif(
    not reference_available(),
    reason="reference implementation not mounted at /root/reference")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def stub_missing_modules(*names):
    """Insert empty stand-ins for modules the reference imports but this
    image lacks (chardet, librosa, ...) so reference oracles stay importable."""
    import sys
    import types
    for name in names:
        if name not in sys.modules:
            try:
                __import__(name)
            except ImportError:
                sys.modules[name] = types.ModuleType(name)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")

