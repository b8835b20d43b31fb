"""Adaptive quantization + zones.

Reference: x264_adaptive_quant_frame (/root/reference/encoder/
ratecontrol.c:231-249) computes a per-MB qp offset from the AC energy
(variance) of the source MB — var(16x16 luma) + var(8x8 u) +
var(8x8 v), each `sqr - (sum^2 >> log2(count))` (PIXEL_VAR_C,
common/pixel.c:140-161) — then x264_adaptive_quant (:255) assigns
qp = clip(frame_qp + offset) per MB with a +-1 hysteresis against the
previous MB's qp. Zones: parse_zones (ratecontrol.c:602-671) forces a
per-frame-range QP (q=) or rate factor (b=).

Batched redesign: the per-MB SIMD var calls become ONE batched reduction
over MB tiles; log2 is computed exactly in f32 instead of the
reference's 128-entry LUT (the LUT approximates log2 to ~1e-2 — an
encoder-side decision value, not syntax, so exactness buys nothing).
The serial hysteresis chain stays on host (trivially cheap: one pass
over the MB grid) because it feeds the entropy-coded qp_delta chain.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("mbh", "mbw"))
def aq_offsets(y, u, v, mbh: int, mbw: int, strength):
    """Per-MB AQ qp offsets [mbh, mbw] f32 from the SOURCE planes
    (int32/uint8, MB-padded). strength may be traced."""
    def var_tiles(plane, b, shift):
        t = plane[:b * mbh, :b * mbw].astype(jnp.int64)
        t = t.reshape(mbh, b, mbw, b).transpose(0, 2, 1, 3)
        s = jnp.sum(t, axis=(2, 3))
        sq = jnp.sum(t * t, axis=(2, 3))
        # uint32 wrap semantics of PIXEL_VAR_C are unreachable for
        # 8-bit inputs (sqr <= 256*255^2 < 2^32), so int64 is exact
        return sq - ((s * s) >> shift)

    energy = (var_tiles(y, 16, 8) + var_tiles(u, 8, 6)
              + var_tiles(v, 8, 6))
    energy = jnp.maximum(energy, 1).astype(jnp.float32)
    return (strength * 1.0397) * (jnp.log2(energy) - 14.427)


def assign_qp_grid(qp_frame: float, offsets: np.ndarray,
                   qp_min: int = 0, qp_max: int = 51) -> np.ndarray:
    """Per-MB integer QP grid: clip(frame_qp + offset + .5) with the
    reference's +-1 hysteresis against the previous MB in raster order
    (x264_adaptive_quant, ratecontrol.c:255-265: if the new qp is
    within 1 of the previous MB's, reuse the previous — saves the
    qp_delta bits). Returns int32 [mbh, mbw]."""
    mbh, mbw = offsets.shape
    out = np.zeros((mbh, mbw), np.int32)
    last = int(np.clip(qp_frame + 0.5, qp_min, qp_max))
    for my in range(mbh):
        for mx in range(mbw):
            q = int(np.clip(qp_frame + offsets[my, mx] + 0.5,
                            qp_min, qp_max))
            if abs(q - last) == 1:
                q = last
            out[my, mx] = q
            last = q
    return out


def effective_qp_grid(qp_grid: np.ndarray, coded: np.ndarray,
                      prev_qp: int) -> np.ndarray:
    """Decoder-visible QP per MB: an MB that codes no qp_delta (no
    residual syntax) inherits the previous MB's qp (spec 7.4.5
    mb_qp_delta; the reference resets h->mb.i_qp to i_last_qp when
    nothing is coded, encoder/macroblock.c:750-760). coded: [mbh,mbw]
    bool — MB emits a qp_delta (cbp != 0 or I_16x16). prev_qp: slice
    init qp. The deblocker must see THIS grid, not the intended one."""
    mbh, mbw = qp_grid.shape
    out = np.empty((mbh, mbw), np.int32)
    last = int(prev_qp)
    for my in range(mbh):
        for mx in range(mbw):
            if coded[my, mx]:
                last = int(qp_grid[my, mx])
            out[my, mx] = last
    return out


class Zones:
    """Parsed --zones: list of (start, end, forced_qp or None,
    rate_factor or None) (reference parse_zone, ratecontrol.c:602)."""

    def __init__(self, spec: str):
        self.zones = []
        if spec:
            for z in spec.split("/"):
                parts = z.split(",")
                if len(parts) != 3:
                    raise ValueError(f"invalid zone: {z!r}")
                start, end = int(parts[0]), int(parts[1])
                k, _, val = parts[2].partition("=")
                if k.strip() in ("q", "qp"):
                    self.zones.append((start, end, int(val), None))
                elif k.strip() == "b":
                    self.zones.append((start, end, None, float(val)))
                else:
                    raise ValueError(f"invalid zone param: {k!r}")

    def lookup(self, frame_idx: int):
        """(forced_qp, rate_factor) for the display frame; later
        zones win (reference: zones scanned last-to-first)."""
        for start, end, q, b in reversed(self.zones):
            if start <= frame_idx <= end:
                return q, b
        return None, None
