"""Quarter-pel block tables: gather once, slice statically.

After full-pel ME, every sample any later stage wants (subpel
candidates, stego candidates and their local-optimality probes) lies on
the quarter-pel lattice within +-6 qpel of 4*mv_fp — and because the
window is anchored at a *full-pel* position, the interpolation phase of
each lattice offset is STATIC.

So: one gather fetches a per-MB window of the four half-pel planes; 169
static slice-averages then materialize every candidate block with no
further gathers; SATD against any of them uses the WHT-linearity trick
(WHT(a-b) = WHT(a)-WHT(b)) so transforms are computed once per block,
not once per comparison.

Offsets are indexed o = (oy+6)*13 + (ox+6), oy/ox in [-6, 6] qpel.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops import mc
from ..ops.blocks import to_blocks
from ..ops.transform import hadamard4x4

# window geometry: origin = fullpel base - MARGIN. Offsets in [-6,6] qpel
# reach full-pel bases [-2, 1], plus the qpel pairing offset (+1) and the
# 16-pel block: columns [MARGIN-2, MARGIN+2+15]. MARGIN=4/WIN=24 keeps
# the fetch inside the valid (non-wrapped) region of the rolled hpel planes:
# max column = W - 16 + PAD - MARGIN + 16 + (WIN-1) = W + 43 < W + 2*PAD - 3.
MARGIN = 4
WIN = 24

N_OFF = 13 * 13


def off_index(oy: int, ox: int) -> int:
    return (oy + 6) * 13 + (ox + 6)


# ---------------------------------------------------------------------------
# Static block construction from windows
# ---------------------------------------------------------------------------

def gather_windows_jnp(planes: jnp.ndarray, mv_fp: jnp.ndarray, mbh: int,
                       mbw: int) -> jnp.ndarray:
    """Per-MB window fetch: [N, 4, WIN, WIN] at (MB base + mv -
    MARGIN), one XLA gather."""
    n = mbh * mbw
    ys = ((jnp.arange(n) // mbw) * 16 + mc.PAD - MARGIN
          + mv_fp.reshape(n, 2)[:, 1])
    xs = ((jnp.arange(n) % mbw) * 16 + mc.PAD - MARGIN
          + mv_fp.reshape(n, 2)[:, 0])
    yy = ys[:, None] + jnp.arange(WIN)
    xx = xs[:, None] + jnp.arange(WIN)
    return planes[:, yy[:, :, None], xx[:, None, :]].transpose(1, 0, 2, 3)


def _phase_slices(oy: int, ox: int):
    """Static plane-pair + offsets for absolute qpel offset (ox, oy) from
    a full-pel-anchored window (same spec rules as mc.qpel_phase_tables,
    but resolved at trace time)."""
    fx, fy = ox & 3, oy & 3
    bx, by = (ox >> 2) + MARGIN, (oy >> 2) + MARGIN
    if fx % 2 == 0 and fy % 2 == 0:
        p = (fx >> 1) + 2 * (fy >> 1)
        return (p, by, bx), (p, by, bx)
    if fx % 2 == 1 and fy % 2 == 0:
        return ((1 + 2 * (fy >> 1), by, bx),
                (0 + 2 * (fy >> 1), by, bx + (1 if fx == 3 else 0)))
    if fx % 2 == 0 and fy % 2 == 1:
        return (((fx >> 1) + 2, by, bx),
                ((fx >> 1), by + (1 if fy == 3 else 0), bx))
    return ((1, by + (1 if fy == 3 else 0), bx),
            (2, by, bx + (1 if fx == 3 else 0)))


def block_table(windows: jnp.ndarray) -> jnp.ndarray:
    """[N, 4, WIN, WIN] -> [169, N, 16, 16] int32: every qpel offset in
    [-6,6]^2 as static slice-averages."""
    outs = []
    for oy in range(-6, 7):
        for ox in range(-6, 7):
            (p1, y1, x1), (p2, y2, x2) = _phase_slices(oy, ox)
            a = windows[:, p1, y1:y1 + 16, x1:x1 + 16]
            b = windows[:, p2, y2:y2 + 16, x2:x2 + 16]
            outs.append((a + b + 1) >> 1)
    return jnp.stack(outs)


def wht16(blocks: jnp.ndarray) -> jnp.ndarray:
    """Per-4x4 WHT of [..., 16, 16] blocks -> same shape (coefficient
    planes flattened back); linear, so SATD(a,b) = g(wht(a)-wht(b))."""
    pl4 = to_blocks(blocks, 4)            # [..., 4,4,4,4]
    h = hadamard4x4(pl4)
    return h


def satd_tables(wa: jnp.ndarray, wb: jnp.ndarray) -> jnp.ndarray:
    """SATD between WHT tensors [..., 4,4,4,4]: per-4x4 |sum| >> 1 then
    summed (pixel.py satd semantics). Inputs may be int16 (compact
    tables); accumulate in int32."""
    d = jnp.abs(wa.astype(jnp.int32) - wb.astype(jnp.int32))
    per_block = jnp.sum(d, axis=(-4, -3)) >> 1   # [..., BY, BX]
    return jnp.sum(per_block, axis=(-2, -1))


def select_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table: [K, N, ...]; idx: [N] in [0,K) -> [N, ...] (cheap
    contiguous take_along_axis)."""
    moved = jnp.moveaxis(table, 0, 1)            # [N, K, ...]
    shaped = idx.reshape(idx.shape[0], *([1] * (moved.ndim - 1)))
    return jnp.take_along_axis(moved, shaped, axis=1)[:, 0]
