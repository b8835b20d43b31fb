"""The accelerator a measurement runs on, as its record names it.

A measurement path never falls back to the CPU: `require_gpu` raises
when JAX's first device is not a CUDA GPU. `card_line` is what
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
(a card may be capped below its maximum power and then runs slower, so
every number is kept beside it).
"""

from __future__ import annotations

import shutil
import subprocess


def require_gpu():
    """Return JAX's first device; raise unless it is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev.platform} "
                           f"({dev.device_kind})")
    return dev


def device_record() -> dict:
    """platform / kind / count of the devices JAX runs on."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_line() -> str:
    """The cards' names and power limits, one line per card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()
