"""Test configuration: CPU backend with 8 virtual devices, f64 enabled.

Parity tests run in float64 on CPU (the reference is f64 C); sharding tests
use the 8 virtual CPU devices as a stand-in mesh.  Tests marked `gpu` need
the card: run them there with LIBPLL2_TEST_GPU=1 (README, "Running on the
GPU"); elsewhere they skip.
"""
import os

import pytest

if os.environ.get("LIBPLL2_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from libpll2_jax.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with LIBPLL2_TEST_GPU=1 on the card)")
    return dev
