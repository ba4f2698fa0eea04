"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding semantics are tested on CPU through XLA's
host-platform device-count flag. The ``gpu``-marked tests (``-m gpu``)
leave JAX on its default platform; each decides in a fixture whether a
card is present and skips without one.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    if config.getoption("markexpr", "") == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX sees none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu tests/ "
                    "on a machine with one")
    return dev
