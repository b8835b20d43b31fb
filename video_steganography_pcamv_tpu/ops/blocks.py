"""Block-layout helpers.

Device-first layout decision: instead of the reference's per-macroblock
[4][4] int16 arrays walked by scalar loops (common/dct.c:122-180), every
4x4 (or NxN) block position in the frame becomes one *coefficient plane*:

    planes[..., r, c, by, bx]  ==  pixel/coefficient (4*by+r, 4*bx+c)

All transform butterflies are then elementwise ops over large [by, bx]
planes that map straight onto the VPU (8x128 lanes), and per-position
quant tables broadcast over the plane axes. This is the structure-of-arrays
trick x264's SIMD uses within a register, applied frame-wide.
"""

from __future__ import annotations

import jax.numpy as jnp


def to_blocks(x: jnp.ndarray, n: int = 4) -> jnp.ndarray:
    """[..., H, W] -> [..., n, n, H//n, W//n] coefficient-plane layout."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // n, n, w // n, n)
    # [..., by, r, bx, c] -> [..., r, c, by, bx]
    return jnp.moveaxis(x, (-3, -1), (-4, -3))


def from_blocks(x: jnp.ndarray) -> jnp.ndarray:
    """[..., n, n, BY, BX] -> [..., H, W]."""
    *lead, n, n2, by, bx = x.shape
    assert n == n2
    x = jnp.moveaxis(x, (-4, -3), (-3, -1))  # [..., by, r, bx, c]
    return x.reshape(*lead, by * n, bx * n)


def pad_to_multiple(x, my: int, mx: int, value=0):
    """Pad the last two axes up to multiples of (my, mx)."""
    h, w = x.shape[-2], x.shape[-1]
    ph = (-h) % my
    pw = (-w) % mx
    if ph == 0 and pw == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
    return jnp.pad(x, pad, mode="edge" if value is None else "constant",
                   constant_values=0 if value is None else value)
