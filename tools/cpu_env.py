"""Import first in local scripts to force the CPU backend.

Pins JAX to the CPU (with 8 virtual devices for mesh work) even where
the environment names another platform; development drives and
quality runs use it. Usage:

    import tools.cpu_env  # noqa  (must precede any jax array op)
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
