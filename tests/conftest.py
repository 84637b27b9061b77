"""Test configuration: CPU backend, 8 virtual devices, float64.

Correctness tests run on CPU in double precision (matching the reference's R
float64 semantics).  Importing jax does not initialize a backend (that
happens lazily at first device use), so selecting the platform via
jax.config here — before any test touches a device — is reliable; XLA_FLAGS
is likewise read at backend initialization time.

Tests marked `gpu` need the card: run them with GPV_TEST_PLATFORM=gpu
(`python -m pytest -m gpu tests/`, which `chip_smoke.py` also does).  Without
it every test runs on the CPU and the `gpu` tests skip.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("GPV_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless this process runs on an NVIDIA GPU (decided per test)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: GPV_TEST_PLATFORM=gpu "
                    "python -m pytest -m gpu tests/")
    return jax.devices()[0]
