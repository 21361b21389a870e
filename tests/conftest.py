"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators via XLA's
host-platform device-count override, the standard JAX recipe (SURVEY.md
section 4). JAX_PLATFORMS defaults to cpu; tests marked ``gpu`` need a card
and run there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_platform.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX has none")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at run time)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")


@pytest.fixture
def rng(request):
    """Per-test deterministic RNG.

    Seeded from the test id, NOT shared across tests: a session-scoped
    stream made every test's data depend on how many draws ran before it,
    so adding a test file could shift an fp-marginal case past tolerance
    in an unrelated test."""
    import zlib

    seed = zlib.crc32(request.node.nodeid.encode()) & 0xFFFF
    return np.random.default_rng(1234 + seed)
