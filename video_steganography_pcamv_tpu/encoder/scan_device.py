"""Device twin of the pass-1 partition scan (encoder/scan.py).

Reference: x264_mb_predict_mv / x264_mb_predict_mv_pskip
(/root/reference/common/macroblock.c:28-165). The host scan walks MBs
serially, but its pass-1 form has NO sequential data dependency: the
committed grid values are just the analysed MV field repeated to 4x4
granularity, and cell availability is pure geometry (a cell is
available to a querying unit iff it lies in-bounds, is not intra, and
its MB precedes the current MB in raster order or IS the current MB —
within an MB, every A/B/C/D neighbour cell of a unit belongs to an
earlier unit in coding order by construction of the coding order).
That makes MVP / P_SKIP / skip-flag derivation a batched gather +
where-cascade over [mbh, mbw, 4] units — one more stage of the fused
device chain instead of a host round trip.

The stego pass-2 FORCED rescan (skip MBs substitute pskip MVs into the
grid) is genuinely sequential (pskip chains) and stays on the host C++
(native scan_p_parts_forced).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# unit geometry tables indexed [part, unit_slot]: offsets in 4x4 cells,
# unit width in 4x4 cells, slot-used mask (N_UNITS per partition type)
_OY = np.array([[0, 0, 0, 0], [0, 2, 0, 0], [0, 0, 0, 0], [0, 0, 2, 2]],
               np.int32)
_OX = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [0, 2, 0, 0], [0, 2, 0, 2]],
               np.int32)
_W4 = np.array([[4, 4, 4, 4], [4, 4, 4, 4], [2, 2, 4, 4], [2, 2, 2, 2]],
               np.int32)
_USED = np.array([[1, 0, 0, 0], [1, 1, 0, 0], [1, 1, 0, 0],
                  [1, 1, 1, 1]], np.int32)


def _median3(a, b, c):
    return a + b + c - jnp.minimum(a, jnp.minimum(b, c)) \
        - jnp.maximum(a, jnp.maximum(b, c))


def _gather_cell(mv4, ref4, ok4, ny4, nx4, cur_idx, h4, w4):
    """(mv, ref, avail) of neighbour cells [..]: avail = in-bounds and
    the cell's MB does not follow the current MB in raster order
    (same-MB cells are always earlier units). INTRA cells are
    AVAILABLE with mv 0 / ref -1 — the x264 cache keeps -1 for intra
    vs -2 for outside (macroblock.c:28-46), and only truly unavailable
    neighbours trigger the C->D fallback, the lone-A rule, and the
    P_SKIP zero-forcing."""
    inb = (ny4 >= 0) & (nx4 >= 0) & (ny4 < h4) & (nx4 < w4)
    cy = jnp.clip(ny4, 0, h4 - 1)
    cx = jnp.clip(nx4, 0, w4 - 1)
    mbw = w4 // 4
    cell_idx = (cy // 4) * mbw + (cx // 4)
    avail = inb & (cell_idx <= cur_idx)
    usable = avail & ok4[cy, cx]          # inter cells with a real MV
    mv = jnp.where(usable[..., None], mv4[cy, cx], 0)
    ref = jnp.where(usable, ref4[cy, cx], -1)
    return mv, ref, avail


def _mvp_units(mv4, ref4, ok4, part, y4u, x4u, w4u, refu, mbh, mbw):
    """MVP for every unit slot [mbh,mbw,4] (spec 8.4.1.3)."""
    h4, w4 = 4 * mbh, 4 * mbw
    my = jnp.arange(mbh)[:, None, None]
    mx = jnp.arange(mbw)[None, :, None]
    cur_idx = my * mbw + mx                       # [mbh,mbw,1]

    mva, ra, av_a = _gather_cell(mv4, ref4, ok4, y4u, x4u - 1,
                                 cur_idx, h4, w4)
    mvb, rb, av_b = _gather_cell(mv4, ref4, ok4, y4u - 1, x4u,
                                 cur_idx, h4, w4)
    mvc, rc, av_c = _gather_cell(mv4, ref4, ok4, y4u - 1, x4u + w4u,
                                 cur_idx, h4, w4)
    mvd, rd, av_d = _gather_cell(mv4, ref4, ok4, y4u - 1, x4u - 1,
                                 cur_idx, h4, w4)
    # D substitution when C is unavailable (macroblock.c:54-63)
    mvc = jnp.where(av_c[..., None], mvc, mvd)
    rc = jnp.where(av_c, rc, rd)
    av_c = av_c | av_d

    ma = av_a & (ra == refu)
    mb = av_b & (rb == refu)
    mc = av_c & (rc == refu)
    nmatch = ma.astype(jnp.int32) + mb + mc
    med = _median3(mva, mvb, mvc)
    one = jnp.where(ma[..., None], mva,
                    jnp.where(mb[..., None], mvb, mvc))
    base = jnp.where((nmatch == 1)[..., None], one, med)
    # if only A exists, take A (macroblock.c:79-80)
    only_a = (~av_b) & (~av_c) & av_a
    base = jnp.where(only_a[..., None], mva, base)

    # directional shortcuts for 16x8 / 8x16 (macroblock.c:88-103)
    u = jnp.arange(4)[None, None, :]
    p3 = part[..., None]
    s_168_0 = (p3 == 1) & (u == 0) & mb
    s_168_1 = (p3 == 1) & (u == 1) & ma
    s_816_0 = (p3 == 2) & (u == 0) & ma
    s_816_1 = (p3 == 2) & (u == 1) & mc
    mvp = jnp.where(s_168_0[..., None], mvb, base)
    mvp = jnp.where(s_168_1[..., None], mva, mvp)
    mvp = jnp.where(s_816_0[..., None], mva, mvp)
    mvp = jnp.where(s_816_1[..., None], mvc, mvp)
    return mvp


@functools.partial(jax.jit, static_argnames=("mbh", "mbw"))
def scan_p_device(part, mv8, cbp_luma, cbp_chroma, mbh: int, mbw: int,
                  intra=None, ref8=None):
    """Device pass-1 scan. Same contract as scan.scan_p_frame:
    returns (skip [mbh,mbw] bool, mvd [mbh,mbw,4,2], mvp [mbh,mbw,4,2],
    final_mv8 = mv8)."""
    return _scan_p_device(part, mv8, cbp_luma, cbp_chroma, mbh, mbw,
                          intra, ref8)


def _scan_p_device(part, mv8, cbp_luma, cbp_chroma, mbh, mbw,
                   intra=None, ref8=None):
    """jit-free body (for fusing into larger device programs)."""
    h4, w4 = 4 * mbh, 4 * mbw
    mv4 = jnp.repeat(jnp.repeat(mv8, 2, 0), 2, 1)
    if ref8 is None:
        ref4 = jnp.zeros((h4, w4), jnp.int32)
    else:
        ref4 = jnp.repeat(jnp.repeat(ref8, 2, 0), 2, 1)
    if intra is None:
        ok4 = jnp.ones((h4, w4), bool)
    else:
        ok4 = ~jnp.repeat(jnp.repeat(intra.astype(bool), 4, 0), 4, 1)

    # unit geometry by partition type [mbh,mbw,4]
    partc = jnp.clip(part, 0, 3)
    oy = jnp.asarray(_OY)[partc]
    ox = jnp.asarray(_OX)[partc]
    w4u = jnp.asarray(_W4)[partc]
    my4 = 4 * jnp.arange(mbh)[:, None, None]
    mx4 = 4 * jnp.arange(mbw)[None, :, None]
    y4u = my4 + oy
    x4u = mx4 + ox
    if ref8 is None:
        refu = jnp.zeros((mbh, mbw, 4), jnp.int32)
    else:
        refu = ref8[(y4u // 2).clip(0, 2 * mbh - 1),
                    (x4u // 2).clip(0, 2 * mbw - 1)]

    mvp = _mvp_units(mv4, ref4, ok4, part, y4u, x4u, w4u, refu,
                     mbh, mbw)

    # unit MVs from the 8x8 field (uniform per unit)
    umv = mv8[(y4u // 2).clip(0, 2 * mbh - 1),
              (x4u // 2).clip(0, 2 * mbw - 1)]
    used = jnp.asarray(_USED)[partc].astype(bool)
    mvd = jnp.where(used[..., None], umv - mvp, 0)
    mvp = jnp.where(used[..., None], mvp, 0)

    # P_SKIP MV (spec 8.4.1.1; macroblock.c:165): per MB at (4my,4mx)
    my = jnp.arange(mbh)[:, None]
    mx = jnp.arange(mbw)[None, :]
    cur_idx = (my * mbw + mx)[..., None]
    ya = (4 * my)[..., None]
    xa = (4 * mx)[..., None]
    mva, ra, av_a = _gather_cell(mv4, ref4, ok4, ya, xa - 1, cur_idx,
                                 h4, w4)
    mvb, rb, av_b = _gather_cell(mv4, ref4, ok4, ya - 1, xa, cur_idx,
                                 h4, w4)
    mva, ra, av_a = mva[..., 0, :], ra[..., 0], av_a[..., 0]
    mvb, rb, av_b = mvb[..., 0, :], rb[..., 0], av_b[..., 0]
    zero_a = (ra == 0) & (mva[..., 0] == 0) & (mva[..., 1] == 0)
    zero_b = (rb == 0) & (mvb[..., 0] == 0) & (mvb[..., 1] == 0)
    force0 = (~av_a) | (~av_b) | zero_a | zero_b
    # ref-0 16x16 MVP at the MB origin
    p16 = jnp.zeros((mbh, mbw), jnp.int32)
    mvp16 = _mvp_units(mv4, ref4, ok4, p16,
                       (4 * my)[..., None] + jnp.zeros((1, 1, 1),
                                                       jnp.int32),
                       (4 * mx)[..., None] + jnp.zeros((1, 1, 1),
                                                       jnp.int32),
                       jnp.full((mbh, mbw, 1), 4, jnp.int32),
                       jnp.zeros((mbh, mbw, 1), jnp.int32),
                       mbh, mbw)[..., 0, :]
    pskip = jnp.where(force0[..., None], 0, mvp16)

    here = mv8[::2, ::2]
    r00 = ref4[::4, ::4]
    skip = ((part == 0) & (cbp_luma == 0) & (cbp_chroma == 0)
            & (r00 == 0)
            & (here[..., 0] == pskip[..., 0])
            & (here[..., 1] == pskip[..., 1]))
    if intra is not None:
        skip = skip & ~intra.astype(bool)
    return skip, mvd, mvp, mv8
