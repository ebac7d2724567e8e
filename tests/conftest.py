"""Test configuration: run on a virtual 8-device CPU mesh by default.

Environment must be set before jax initializes its backends, hence the
os.environ writes at module import (conftest imports before any test module).
This is the standard JAX technique for exercising pjit/Mesh code paths
without accelerators (SURVEY.md section 4). Tests marked ``gpu`` need a card:
run them there with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``;
elsewhere the ``gpu`` fixture skips them.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Tests must be deterministic and CPU-friendly.
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (the full CI tier; the default "
             "fast tier keeps `pytest -q` under ~10 minutes)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual devices, got {devs}"
    return devs


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; the test skips where JAX has none. Decided
    here, at run time, so every worker collects the same tests."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform}")
    return devs[0]
