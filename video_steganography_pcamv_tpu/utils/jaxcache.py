"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, bench, chip smoke test, tools):
if `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and the
code sets nothing; otherwise the cache goes to `.jax_cache/` at the
root of the checkout, a fixed path that git ignores, so a later run
finds what an earlier one compiled.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory the cache lands in under the rule above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def setup_compile_cache() -> str:
    """Apply the rule; returns the cache directory in use."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
