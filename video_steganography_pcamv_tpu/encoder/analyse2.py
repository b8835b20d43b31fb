"""Table-based P-frame analysis (v2): subpel + stego costs with zero
per-MB gathers on the hot path.

Replaces the gather-per-candidate v1 paths (encoder/me.py subpel_refine,
stego/cost.py alt_mv_costs) with lookups into the static qpel block
table (encoder/qpel_table.py). Produces *identical* stego costs to v1
(equivalence-tested) and slightly different (better: exhaustive-in-box)
subpel MVs: the 2-round hex refinement becomes a full argmin over the
+-3 qpel box, which is legal and closer to x264's high-subme ESA quality.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.blocks import to_blocks
from . import qpel_table as QT
from .me import mv_bits_table
from .inter import luma_p_encode
from ..stego.cost import D_MV, D_NB, rca_decide


def _mb_tiles(y, mbh, mbw):
    return y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
            .reshape(mbh * mbw, 16, 16)


def _didx(dy: int, dx: int) -> int:
    return dy * 13 + dx


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "subpel"))
def subpel_from_table(cur_y, wht169, mv_fp, prev_mv, mbh: int, mbw: int,
                      lam=1, subpel: int = 2):
    """Pick the best qpel offset in [-3,3]^2 around 4*mv_fp by
    SATD + lambda*bits(mv - prev_mv). Returns (mv [mbh,mbw,2] qpel,
    r_idx169 [N] table index of the chosen offset)."""
    n = mbh * mbw
    wcur = QT.wht16(_mb_tiles(cur_y, mbh, mbw))
    mvfp_f = mv_fp.reshape(n, 2)
    pred = prev_mv.reshape(n, 2)
    bits_t = jnp.asarray(mv_bits_table(4 * 512))
    off = 4 * 512

    if subpel == 0:
        offsets = [(0, 0)]
    elif subpel == 1:
        offsets = [(oy, ox) for oy in (-2, 0, 2) for ox in (-2, 0, 2)]
    else:
        offsets = [(oy, ox) for oy in range(-3, 4) for ox in range(-3, 4)]

    costs = []
    for oy, ox in offsets:
        idx = QT.off_index(oy, ox)
        sat = QT.satd_tables(wcur, wht169[idx])
        qx = 4 * mvfp_f[:, 0] + ox
        qy = 4 * mvfp_f[:, 1] + oy
        mvc = (bits_t[jnp.clip(qx - pred[:, 0], -off, off) + off]
               + bits_t[jnp.clip(qy - pred[:, 1], -off, off) + off]) * lam
        costs.append(sat + mvc)
    costs = jnp.stack(costs)                       # [K, N]
    sel = jnp.argmin(costs, axis=0)                # [N]
    offs = jnp.asarray(np.array(offsets, np.int32))  # [K, 2] (oy, ox)
    oy_sel = offs[sel, 0]
    ox_sel = offs[sel, 1]
    mv = jnp.stack([4 * mvfp_f[:, 0] + ox_sel,
                    4 * mvfp_f[:, 1] + oy_sel], axis=-1)
    r_idx = (oy_sel + 6) * 13 + (ox_sel + 6)
    return mv.reshape(mbh, mbw, 2), r_idx


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel"))
def analyse_p_frame(y, ref_luma, prev_mv, rng: int, mbh: int, mbw: int,
                    lam, subpel: int):
    """Fused P-frame analysis: full-pel ME + window gather + qpel block
    table + subpel argmin, one device dispatch. Returns
    (mv [mbh,mbw,2], r_idx [N], blocks169, wht169) — the tables stay on
    device for the stego pass."""
    from . import me as ME
    from . import qpel_table as QT
    zero_pred = jnp.zeros((mbh, mbw, 2), jnp.int32)
    mv_fp, _ = ME.fullpel_search.__wrapped__(
        y, ref_luma[0], zero_pred, rng, mbh, mbw, lam)
    windows = QT.gather_windows_jnp(
        ref_luma.astype(jnp.uint8), mv_fp, mbh, mbw).astype(jnp.int32)
    blocks = QT.block_table(windows)
    wht = QT.wht16(blocks)
    mv_q, r_idx = subpel_from_table.__wrapped__(
        y, wht, mv_fp, prev_mv, mbh, mbw, lam, subpel)
    return mv_q, r_idx, blocks, wht


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate"))
def stego_costs_from_table(cur_y, blocks169, wht169, r_idx, mv, mvp,
                           cost_mv, qp, mbh: int, mbw: int,
                           decimate: bool = True):
    """Table-based x264_ih_get_mv_cost (bit-identical to
    stego/cost.py alt_mv_costs). r_idx: [N] chosen offset index; mv:
    [mbh,mbw,2] qpel; mvp: [mbh,mbw,2] predictor for the probe mv-cost.
    Returns (rho [mbh,mbw] f32, alt_mv [mbh,mbw,2], flags)."""
    n = mbh * mbw
    cur = _mb_tiles(cur_y, mbh, mbw)
    mvf = mv.reshape(n, 2)
    mvpf = mvp.reshape(n, 2)

    # pre-select the 7x7 WHT neighbourhood around r (49 cheap selections)
    sel_wht = {}
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            sel_wht[(dy, dx)] = QT.select_rows(wht169,
                                               r_idx + _didx(dy, dx))

    def mvcost(dq):  # dq: static (dy, dx) qpel delta from mv
        qx = mvf[:, 0] + dq[1]
        qy = mvf[:, 1] + dq[0]
        return (cost_mv[jnp.abs(qx - mvpf[:, 0])]
                + cost_mv[jnp.abs(qy - mvpf[:, 1])])

    def probes(wrec, center):  # center: static (dy, dx)
        out = []
        for k in range(9):
            dk = (int(D_NB[k][1]), int(D_NB[k][0]))  # (dy, dx)
            d = (center[0] + dk[0], center[1] + dk[1])
            sat = QT.satd_tables(wrec, sel_wht[d])
            out.append(sat + mvcost(d))
        return jnp.stack(out, axis=1)               # [N, 9]

    blk0 = QT.select_rows(blocks169, r_idx)
    _, rec0 = luma_p_encode(cur, blk0, qp, decimate)
    nb0 = probes(QT.wht16(rec0), (0, 0))
    orig_cost = nb0[:, 8]
    orig_opt = jnp.min(nb0, axis=1) >= orig_cost

    cand_cost, cand_opt = [], []
    for c in range(12):
        dc = (int(D_MV[c][1]), int(D_MV[c][0]))     # (dy, dx)
        blkc = QT.select_rows(blocks169, r_idx + _didx(*dc))
        _, recc = luma_p_encode(cur, blkc, qp, decimate)
        nbc = probes(QT.wht16(recc), dc)
        cand_cost.append(nbc[:, 8])
        cand_opt.append(jnp.min(nbc, axis=1) >= nbc[:, 8])
    cand_cost = jnp.stack(cand_cost, axis=1)
    cand_opt = jnp.stack(cand_opt, axis=1)

    rho, sel_delta, flags = rca_decide(nb0, orig_cost, orig_opt,
                                       cand_cost, cand_opt)
    alt = (mvf + sel_delta).reshape(mbh, mbw, 2)
    return rho.reshape(mbh, mbw), alt, flags.reshape(mbh, mbw, 3)
