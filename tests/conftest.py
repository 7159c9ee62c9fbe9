"""Test harness: the CPU, with 8 virtual devices.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); 8 virtual CPU devices
exercise the sharding and collective paths, and the Pallas kernels run in
interpret mode (tests pass ``interpret=True``).  Tests that need the card
carry the ``gpu`` marker and skip here; on the GPU machine run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

The platform is set through jax.config before any backend initialises.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; skips elsewhere (see module doc)")


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise.  The
    decision is made here, at run time, so every xdist worker collects
    the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs the GPU (platform here: {dev.platform})")
    return dev
