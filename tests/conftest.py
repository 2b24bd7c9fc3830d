"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see the real single
CPU device (only launch/dryrun.py forces 512 host devices)."""
import numpy as np
import pytest


def pytest_configure(config):
    # no pytest.ini/pyproject in this repo, so markers register here
    config.addinivalue_line(
        "markers",
        "chaos: seeded fault-injection suite for the serving guard "
        "(run explicitly in CI via `-m chaos`; part of the default run too)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the repro_torch kernels); skips without "
        "one (run on the card via `-m gpu`)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
