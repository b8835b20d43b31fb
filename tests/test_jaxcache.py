"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR wins when set and
code sets nothing; unset, the cache lands in the fixed `.jax_cache/`
at the root of the checkout. Each case runs in a fresh interpreter so
the test process's own cache setting is untouched."""

import os
import subprocess
import sys

import pytest

from video_steganography_pcamv_tpu.utils import jaxcache

_PROBE = ("import jax; from video_steganography_pcamv_tpu.utils.jaxcache "
          "import setup_compile_cache; d = setup_compile_cache(); "
          "print(d); print(jax.config.jax_compilation_cache_dir)")


def _run(env):
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       cwd=jaxcache.CHECKOUT, capture_output=True,
                       text=True, timeout=120, check=True)
    return r.stdout.split("\n")[:2]


@pytest.mark.parametrize("where", ["set", "unset"])
def test_cache_dir_rule(where, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if where == "set":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
        assert _run(env) == [str(tmp_path), str(tmp_path)]
    else:
        want = os.path.join(jaxcache.CHECKOUT, ".jax_cache")
        assert jaxcache.DEFAULT_DIR == want
        assert _run(env) == [want, want]
        ignored = open(os.path.join(jaxcache.CHECKOUT,
                                    ".gitignore")).read().split()
        assert ".jax_cache/" in ignored
