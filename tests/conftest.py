"""Test environment: unless JAX_PLATFORMS names an accelerator, the suite
runs on an 8-device virtual CPU mesh, so sharding tests run anywhere. The
``gpu``-marked tests run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    # both must land before the first backend initialization
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
