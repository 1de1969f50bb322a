import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (from a fixture) where there is none")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
