"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches see
the real single CPU device; only dryrun.py forces 512 host devices."""

import os
import zlib

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def _seed_for(nodeid: str) -> int:
    """Deterministic per-test seed: stable across runs and workers, unique
    per test, overridable for replaying a failure (REPRO_TEST_SEED=N)."""
    env = os.environ.get("REPRO_TEST_SEED")
    if env is not None:
        return int(env)
    return zlib.crc32(nodeid.encode())


@pytest.fixture()
def seeded_rng(request):
    """Per-test np.random.Generator seeded from the test's nodeid.

    The seed is printed so a failing run can be replayed exactly with
    ``REPRO_TEST_SEED=<seed> pytest <nodeid>`` even if the fixture's
    consumers draw data-dependent amounts of randomness.
    """
    seed = _seed_for(request.node.nodeid)
    print(f"[seeded_rng] {request.node.nodeid} seed={seed}")
    return np.random.default_rng(seed)


@pytest.fixture(autouse=True)
def _global_numpy_seed(request):
    """Pin the legacy global NumPy RNG per test so tests that (directly or
    through a library) touch ``np.random.*`` are reproducible and isolated
    from execution order.  The seed is derived from the test's nodeid and
    printed on failure-relevant output (``-s`` / captured on failure)."""
    seed = _seed_for(request.node.nodeid) & 0x7FFFFFFF
    np.random.seed(seed)
    print(f"[np.random seed] {seed}")
    yield


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
