import os
import sys

# Tests run on the default single CPU device. The dry-run (and only the
# dry-run) uses 512 placeholder devices — launched via subprocess in
# test_dryrun.py so this process's jax stays single-device.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU and nvcc (hand-written kernels); skips without one"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def unpack_view(v):
    """Pytree view of a state slot: unpack flat packed planes (recursing
    through NamedTuple containers like Inflight/PowerState), pass trees
    through. Shared by the packed-vs-per-leaf differential suites."""
    from repro.parallel.packing import Packed, unpack

    if isinstance(v, Packed):
        return unpack(v)
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(unpack_view(f) for f in v))
    return v
