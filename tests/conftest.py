"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64.

XLA_FLAGS must be set before the first backend use; the platform is pinned
to the CPU even when JAX_PLATFORMS is unset, except under `-m gpu`.  Tests
that need the GPU carry the `gpu` marker and skip inside the test body when
there is none.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    # `python -m pytest -m gpu` on a GPU machine keeps JAX's default
    # platform; every other selection runs on the CPU
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")
