"""Test configuration: run JAX on CPU with 8 virtual devices.

Multi-chip sharding tests run on an emulated 8-device CPU mesh
(``xla_force_host_platform_device_count``), the standard way to test
``jax.sharding`` code without real hardware. Must run before jax import.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Pin the platform to CPU in config too, before any backend is selected,
# so an accelerator on the test machine is never picked up; and keep the
# persistent compilation cache off, so tests never write to the checkout.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
