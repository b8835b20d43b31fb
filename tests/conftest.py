"""Test config: run JAX on a virtual 8-device CPU mesh so multi-device
sharding logic is exercised without accelerators.

`jax.config.update("jax_platforms", "cpu")` before the first backend
use pins the CPU even where the environment names another platform.
Tests that need a CUDA GPU carry the `gpu` marker and skip here.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# persistent compile cache (the fused frame programs take a while to
# build on the CPU): JAX_COMPILATION_CACHE_DIR if set, else the
# checkout's .jax_cache/
from video_steganography_pcamv_tpu.utils.jaxcache import (  # noqa: E402
    setup_compile_cache)

setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop live compiled executables after each test module.

    The full suite compiles hundreds of XLA CPU programs in one
    process; keeping them all live has crashed LLVM mid-compile
    (deterministic SIGSEGV ~2/3 into the suite, reproduced twice, gone
    when the crashing test runs alone). The persistent compile cache
    makes the recompiles cheap."""
    yield
    jax.clear_caches()
