"""Test harness config: CPU backend with 8 virtual devices, x64 enabled.

Sharding tests run on a virtual 8-device CPU mesh; physics/parity tests
run in float64 on the CPU. The suite runs on the CPU unless JAX_PLATFORMS
names a platform: the tests marked ``gpu`` run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (see README).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
