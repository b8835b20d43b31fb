"""B-slice analysis, encode and host scan.

Reference: the B path of x264_macroblock_analyse (analyse.c:3110-3466:
direct + L0/L1/BI 16x16 analysis, bidir SATD refine me.c:914-997),
spatial direct derivation (common/macroblock.c x264_mb_predict_mv_direct
spatial path), and the B mb_type syntax (spec 7.4.5 / 9.3.2.5).

Batched redesign: L0 and L1 motion searches are two runs of the exhaustive
table pipeline; the BI cost is evaluated exactly at (bestL0, bestL1)
like x264's bidir refine; spatial-direct MV derivation is the host
raster scan (serial by the spec's neighbour dependences), with the
direct SAD pre-evaluated on device at the approximate (inter-field)
direct MVs — decisions are approximate where neighbours changed mode,
the committed direct MVs are always the exact decoder derivation.

Scope (documented): B MBs cover the 16x16 modes (DIRECT / L0 / L1 /
BI + B_SKIP) plus the partition family (round 2): 16x8/8x16 two-
partition list combos (spec Table 7-14 codes 4-21) and B_8x8 with
per-8x8 direct/L0/L1/BI sub modes (Table 7-18; no sub-8x8 splits).
Intra-in-B rides the post-encode refine_p_intra wavefront (core.py
_encode_b_frame); implicit weighted bipred (--weightb) threads the
POC-distance weight w1 through every BI combine. Under multi-ref the
per-MB L0 ref is the 16x16 REF_COST winner reused by every partition
shape — the exact reference model (analyse.c:1973 b16x8 loads
p_fref[0][a->l0.i_ref]). B frames are non-references unless
--b-pyramid keeps the middle B of a GOP as one; deblocking is
disabled on non-reference B slices via the slice header (a legal
encoder choice; recon drift is impossible since nothing references
them).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import mc
from ..ops import transform as T
from ..ops.blocks import to_blocks
from . import qpel_table as QT
from .me import mv_bits_table
from .scan import _Grid, unit_mvp, D_16x16
from .inter import (_zigzag_gather, decimate_score, _mb_tiles16)

# B mb_type ue() codes for the 16x16 subset (spec 7.4.5 table)
B_DIRECT, B_L0, B_L1, B_BI = 0, 1, 2, 3


def _bi_avg(p0, p1, w1):
    """Bipred combine: default average at w1 == 32, implicit weighted
    otherwise (spec 8.4.2.3.2 with log2WD=5, o=0; reference mc.c
    pixel_avg_weight_wxh: dst = clip((p0*(64-w1) + p1*w1 + 32) >> 6)).
    At w1 == 32 this is bit-identical to (p0 + p1 + 1) >> 1."""
    return jnp.clip((p0 * (64 - w1) + p1 * w1 + 32) >> 6, 0, 255)


def bipred_weight(poc_b: int, poc0: int, poc1: int,
                  weightb: bool) -> int:
    """Implicit bipred weight of the L1 prediction (w0 = 64 - w1).
    Twin of x264_macroblock_bipred_init (common/macroblock.c:
    1420-1453); the encoder and decoder derive it identically from
    the slice POCs."""
    if not weightb:
        return 32
    td = min(127, max(-128, poc1 - poc0))
    if td == 0:
        return 32
    tb = min(127, max(-128, poc_b - poc0))
    # C truncates toward zero; Python // floors — divide magnitudes
    # and reapply the sign so td < 0 (L1[0] POC below L0[0]) matches
    tx = (16384 + (abs(td) >> 1)) // abs(td) * (1 if td > 0 else -1)
    dsf = min(1023, max(-1024, (tb * tx + 32) >> 6)) >> 2
    if -64 <= dsf <= 128:
        return dsf
    return 32
# ue sizes of the mb_type codes (+1 bit per mvd pair is in the mv cost)
_B_HDR_BITS = np.array([1, 3, 3, 5], np.int32)


def _subpel_cost(cur_y, wht169, mv_fp, prev_mv, mbh, mbw, lam, subpel):
    """subpel_from_table twin that also returns the winning cost and
    offset index."""
    n = mbh * mbw
    wcur = QT.wht16(_mb_tiles16(cur_y, mbh, mbw))
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
    costs = jnp.stack(costs)
    sel = jnp.argmin(costs, axis=0)
    best = jnp.min(costs, axis=0)
    offs = jnp.asarray(np.array(offsets, np.int32))
    oy_sel = offs[sel, 0]
    ox_sel = offs[sel, 1]
    mv = jnp.stack([4 * mvfp_f[:, 0] + ox_sel,
                    4 * mvfp_f[:, 1] + oy_sel], axis=-1)
    r_idx = (oy_sel + 6) * 13 + (ox_sel + 6)
    return mv.reshape(mbh, mbw, 2), r_idx, best.reshape(mbh, mbw)


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel"))
def analyse_b_frame(y, ref0_luma, ref1_luma, rng: int, mbh: int,
                    mbw: int, lam, subpel: int, w1=32):
    """Fused B analysis: per-list exhaustive ME + subpel, BI cost at
    (bestL0, bestL1). Returns (mv0, c0, mv1, c1, cbi) — mvs qpel
    [mbh,mbw,2], costs [mbh,mbw] SATD + lambda*mvbits."""
    from . import me as ME
    n = mbh * mbw
    outs = []
    for ref_luma in (ref0_luma, ref1_luma):
        zero_pred = jnp.zeros((mbh, mbw, 2), jnp.int32)
        mv_fp, _ = ME.fullpel_search.__wrapped__(
            y, ref_luma[0], zero_pred, rng, mbh, mbw, lam)
        windows = QT.gather_windows_jnp(
            ref_luma.astype(jnp.uint8), mv_fp, mbh, mbw).astype(jnp.int32)
        blocks = QT.block_table(windows)
        wht = QT.wht16(blocks)
        zero = jnp.zeros((mbh, mbw, 2), jnp.int32)
        mv_q, r_idx, cost = _subpel_cost(y, wht, mv_fp, zero,
                                         mbh, mbw, lam, subpel)
        blk = QT.select_rows(blocks, r_idx)            # [N,16,16]
        outs.append((mv_q, cost, blk))
    (mv0, c0, blk0), (mv1, c1, blk1) = outs
    cur = _mb_tiles16(y, mbh, mbw)
    bi = _bi_avg(blk0, blk1, w1)
    satd_bi = QT.satd_tables(QT.wht16(cur), QT.wht16(bi))
    # BI pays both mv costs: approximate as (c0-satd0)+(c1-satd1) is
    # not recoverable here; use bits of both mvs against zero pred
    bits_t = jnp.asarray(mv_bits_table(4 * 512))
    off = 4 * 512
    mvc = jnp.zeros(n, jnp.int32)
    for mv in (mv0, mv1):
        f = mv.reshape(n, 2)
        mvc = mvc + (bits_t[jnp.clip(f[:, 0], -off, off) + off]
                     + bits_t[jnp.clip(f[:, 1], -off, off) + off]) * lam
    cbi = satd_bi.reshape(mbh, mbw) + mvc.reshape(mbh, mbw)
    return mv0, c0, mv1, c1, cbi


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel", "nrefs"))
def analyse_b_frame_mref(y, refs0_luma, n_valid, ref1_luma, rng: int,
                         mbh: int, mbw: int, lam, subpel: int,
                         nrefs: int, w1=32):
    """Multi-ref-L0 twin of analyse_b_frame (reference
    x264_mb_analyse_inter_b16x16, analyse.c "16x16 Search on all ref
    frame": per-MB exhaustive ME against every L0 DPB entry with
    REF_COST = lambda * te(ref) bits, argmin kept; L1 searches its
    single entry; BI evaluated at the per-list winners).

    refs0_luma: [R] stacked padded L0 planes (newest first, the
    decode-order L0 list); n_valid masks DPB padding. Returns
    (mv0, c0, ref0, mv1, c1, cbi) — ref0 [mbh,mbw] int32."""
    from . import me as ME
    from .partition import te_ref_bits
    n = mbh * mbw
    ref_bits = jnp.asarray(te_ref_bits(nrefs))
    cs, mvs, blks = [], [], []
    for r in range(nrefs):
        ref_luma = refs0_luma[r]
        zero_pred = jnp.zeros((mbh, mbw, 2), jnp.int32)
        mv_fp, _ = ME.fullpel_search.__wrapped__(
            y, ref_luma[0], zero_pred, rng, mbh, mbw, lam)
        windows = QT.gather_windows_jnp(
            ref_luma.astype(jnp.uint8), mv_fp, mbh,
            mbw).astype(jnp.int32)
        blocks = QT.block_table(windows)
        wht = QT.wht16(blocks)
        zero = jnp.zeros((mbh, mbw, 2), jnp.int32)
        mv_q, r_idx, cost = _subpel_cost(y, wht, mv_fp, zero,
                                         mbh, mbw, lam, subpel)
        cost = cost + lam * ref_bits[r]
        cost = jnp.where(r < n_valid, cost, jnp.int32(1 << 28))
        cs.append(cost)
        mvs.append(mv_q)
        blks.append(QT.select_rows(blocks, r_idx))
    c_st = jnp.stack(cs)                                  # [R,mbh,mbw]
    ref0 = jnp.argmin(c_st, axis=0).astype(jnp.int32)
    c0 = jnp.min(c_st, axis=0)
    mv0 = jnp.take_along_axis(
        jnp.stack(mvs), ref0[None, :, :, None], axis=0)[0]
    blk0 = jnp.take_along_axis(
        jnp.stack(blks).reshape(nrefs, n, 16, 16),
        ref0.reshape(n)[None, :, None, None], axis=0)[0]

    # ---- L1 (single entry) + BI at the winners ----
    zero_pred = jnp.zeros((mbh, mbw, 2), jnp.int32)
    mv_fp, _ = ME.fullpel_search.__wrapped__(
        y, ref1_luma[0], zero_pred, rng, mbh, mbw, lam)
    windows = QT.gather_windows_jnp(
        ref1_luma.astype(jnp.uint8), mv_fp, mbh, mbw).astype(jnp.int32)
    blocks = QT.block_table(windows)
    wht = QT.wht16(blocks)
    zero = jnp.zeros((mbh, mbw, 2), jnp.int32)
    mv1, r_idx1, c1 = _subpel_cost(y, wht, mv_fp, zero,
                                   mbh, mbw, lam, subpel)
    blk1 = QT.select_rows(blocks, r_idx1)

    cur = _mb_tiles16(y, mbh, mbw)
    # w1 scalar, or [R] per-L0-ref implicit weights (--weightb under
    # multi-ref: x264 h->mb.bipred_weight[i_ref0][i_ref1])
    w1v = jnp.asarray(w1)
    if w1v.ndim == 1:
        w1v = w1v[ref0.reshape(n)][:, None, None]
    bi = _bi_avg(blk0, blk1, w1v)
    satd_bi = QT.satd_tables(QT.wht16(cur), QT.wht16(bi))
    bits_t = jnp.asarray(mv_bits_table(4 * 512))
    off = 4 * 512
    mvc = jnp.zeros(n, jnp.int32)
    for mv in (mv0, mv1):
        f = mv.reshape(n, 2)
        mvc = mvc + (bits_t[jnp.clip(f[:, 0], -off, off) + off]
                     + bits_t[jnp.clip(f[:, 1], -off, off) + off]) * lam
    # BI pays the L0 ref cost too (REF_COST rides c0; fold it here
    # the same way analyse.c adds it into i_part_cost_bi)
    cbi = (satd_bi.reshape(mbh, mbw) + mvc.reshape(mbh, mbw)
           + lam * ref_bits[ref0])
    return mv0, c0, ref0, mv1, c1, cbi


def _assemble_pred_b(ref0, ref1, use0, use1, mv0_8, mv1_8,
                     mbh: int, mbw: int, w1=32, ref8_0=None):
    """Bipred luma+chroma assembly per 8x8 block. ref0/ref1: dicts with
    'luma' [4,Hp,Wp], 'u', 'v'. use0/use1: [2mbh,2mbw] int32.
    ref8_0: optional [2mbh,2mbw] per-8x8 L0 ref index — then ref0's
    planes are STACKED [R,...] DPB arrays (multi-ref B lists).
    w1: scalar, or [2mbh,2mbw] per-8x8 implicit weights (--weightb
    under multi-ref).
    Returns (pred_y [n,16,16], pred_u [n,8,8], pred_v [n,8,8])."""
    n = mbh * mbw
    n8 = 4 * n
    w1 = jnp.asarray(w1)
    if w1.ndim >= 1:
        w1 = w1.reshape(n8)[:, None, None]
    ys8 = (jnp.arange(n8) // (2 * mbw)) * 8
    xs8 = (jnp.arange(n8) % (2 * mbw)) * 8
    u0 = use0.reshape(n8)[:, None, None]
    u1 = use1.reshape(n8)[:, None, None]
    r8 = None
    if ref8_0 is not None:
        r8 = jnp.maximum(ref8_0.reshape(n8), 0)
        p0 = mc.mc_luma_multi(ref0["luma"], r8, ys8, xs8,
                              mv0_8.reshape(n8, 2), bh=8, bw=8)
    else:
        p0 = mc.mc_luma(ref0["luma"], ys8, xs8, mv0_8.reshape(n8, 2),
                        bh=8, bw=8)
    p1 = mc.mc_luma(ref1["luma"], ys8, xs8, mv1_8.reshape(n8, 2),
                    bh=8, bw=8)
    p8 = jnp.where(u0 & u1, _bi_avg(p0, p1, w1),
                   jnp.where(u0, p0, p1))
    pred = p8.reshape(2 * mbh, 2 * mbw, 8, 8).transpose(0, 2, 1, 3) \
             .reshape(16 * mbh, 16 * mbw)
    pred_y = pred.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
                 .reshape(n, 16, 16)

    ysc = (jnp.arange(n8) // (2 * mbw)) * 4
    xsc = (jnp.arange(n8) % (2 * mbw)) * 4
    preds_c = []
    for pl in ("u", "v"):
        if r8 is not None:
            c0 = mc.mc_chroma_multi(ref0[pl], r8, ysc, xsc,
                                    mv0_8.reshape(n8, 2), bh=4, bw=4)
        else:
            c0 = mc.mc_chroma(ref0[pl], ysc, xsc,
                              mv0_8.reshape(n8, 2), bh=4, bw=4)
        c1 = mc.mc_chroma(ref1[pl], ysc, xsc, mv1_8.reshape(n8, 2),
                          bh=4, bw=4)
        c8 = jnp.where(u0 & u1, _bi_avg(c0, c1, w1),
                       jnp.where(u0, c0, c1))
        pc = c8.reshape(2 * mbh, 2 * mbw, 4, 4).transpose(0, 2, 1, 3) \
               .reshape(8 * mbh, 8 * mbw)
        preds_c.append(pc.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)
                       .reshape(n, 8, 8))
    return pred_y, preds_c[0], preds_c[1]


@functools.partial(jax.jit, static_argnames=("mbh", "mbw"))
def bipred_satd_device(y, ref0_luma, ref1_luma, use0, use1, mv0_8,
                       mv1_8, mbh: int, mbw: int, w1=32):
    """SATD of the (approximate) direct prediction per MB — the batch
    stand-in for x264's serial direct cost (analyse.c B direct)."""
    n = mbh * mbw
    n8 = 4 * n
    ys8 = (jnp.arange(n8) // (2 * mbw)) * 8
    xs8 = (jnp.arange(n8) % (2 * mbw)) * 8
    u0 = use0.reshape(n8)[:, None, None]
    u1 = use1.reshape(n8)[:, None, None]
    p0 = mc.mc_luma(ref0_luma, ys8, xs8, mv0_8.reshape(n8, 2),
                    bh=8, bw=8)
    p1 = mc.mc_luma(ref1_luma, ys8, xs8, mv1_8.reshape(n8, 2),
                    bh=8, bw=8)
    p8 = jnp.where(u0 & u1, _bi_avg(p0, p1, w1), jnp.where(u0, p0, p1))
    pred = p8.reshape(2 * mbh, 2 * mbw, 8, 8).transpose(0, 2, 1, 3) \
             .reshape(16 * mbh, 16 * mbw)
    pred = pred.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)
    cur = _mb_tiles16(y, mbh, mbw)
    return QT.satd_tables(QT.wht16(cur),
                          QT.wht16(pred)).reshape(mbh, mbw)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate",
                                             "trellis"))
def encode_b_frame_device(y, u, v, ref0_luma, ref0_u, ref0_v,
                          ref1_luma, ref1_u, ref1_v,
                          use0, use1, mv0_8, mv1_8, qp, qpc,
                          mbh: int, mbw: int, decimate: bool = True,
                          trellis: bool = False, w1=32, ref8_0=None):
    """Final B encode at per-8x8 (use, mv) fields for both lists.
    ref8_0: optional per-8x8 L0 ref [2mbh,2mbw] — multi-ref B lists,
    with ref0_* passed as STACKED [R,...] DPB arrays. Same output
    dict as encode_p_frame_device8."""
    n = mbh * mbw
    qp = jnp.asarray(qp)
    qpc = jnp.asarray(qpc)
    if qp.ndim >= 1:   # per-MB AQ grids
        qp = qp.reshape(n)
        qpc = qpc.reshape(n)[:, None, None]
    ref0 = {"luma": ref0_luma, "u": ref0_u, "v": ref0_v}
    ref1 = {"luma": ref1_luma, "u": ref1_u, "v": ref1_v}
    pred_y, pred_u, pred_v = _assemble_pred_b(
        ref0, ref1, use0, use1, mv0_8, mv1_8, mbh, mbw, w1=w1,
        ref8_0=ref8_0)

    from .inter import luma_p_encode
    cur = _mb_tiles16(y, mbh, mbw)
    lev, rec = luma_p_encode(cur, pred_y, qp, decimate, trellis)
    nz_blk = jnp.any(lev != 0, axis=(1, 2))
    cbp8 = jnp.any(nz_blk.reshape(n, 2, 2, 2, 2), axis=(2, 4))
    cbp_luma = (cbp8[:, 0, 0] * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8)

    chroma_out = []
    for plane, predc in ((u, pred_u), (v, pred_v)):
        curc = plane.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                    .reshape(n, 8, 8)
        resc = to_blocks(curc - predc, 4)
        coef = T.dct4x4(resc)
        dc = coef[:, 0, 0][..., None, None]
        dch = T.hadamard2x2(dc)[..., 0, 0]
        ac = coef.at[:, 0, 0].set(0)
        if trellis:
            from .inter import (trellis_quant_chroma_dc,
                                trellis_quant_chroma_ac)
            dc_lev = trellis_quant_chroma_dc(dch, qpc)
            ac_lev = trellis_quant_chroma_ac(ac, qpc)
        else:
            dc_lev = T.quant_dc(dch, qpc, intra=False)
            ac_lev = T.quant4x4(ac, qpc, intra=False)
        if decimate:
            zzc = _zigzag_gather(ac_lev)
            scc = jnp.sum(decimate_score(zzc), axis=(1, 2))
            keep_c = scc >= 7
            ac_lev = ac_lev * keep_c[:, None, None, None, None]
        chroma_out.append((dc_lev, ac_lev, predc))

    ac_nz = jnp.stack([jnp.any(c[1] != 0, axis=(1, 2, 3, 4))
                       for c in chroma_out]).any(axis=0)
    dc_nz = jnp.stack([jnp.any(c[0] != 0, axis=(1, 2))
                       for c in chroma_out]).any(axis=0)
    cbp_chroma = jnp.where(ac_nz, 2, jnp.where(dc_nz, 1, 0))

    recs_c, levs_c = [], []
    for dc_lev, ac_lev, predc in chroma_out:
        deqc = T.dequant4x4(ac_lev, qpc)
        dc_rec = T.dequant_dc_chroma(
            T.hadamard2x2(dc_lev[..., None, None])[..., 0, 0], qpc)
        deqc = deqc.at[:, 0, 0].set(dc_rec)
        rc = T.idct4x4_add(to_blocks(predc, 4), deqc)
        rc = rc.reshape(n, 4, 4, 2, 2).transpose(0, 3, 1, 4, 2) \
               .reshape(n, 8, 8)
        recs_c.append(rc)
        levs_c.append((dc_lev, ac_lev))

    def untile(t, b):
        return t.reshape(mbh, mbw, b, b).transpose(0, 2, 1, 3) \
                .reshape(mbh * b, mbw * b)

    return {
        "luma_lev": jnp.moveaxis(lev, (1, 2), (3, 4)).reshape(
            mbh, mbw, 256).astype(jnp.int16),
        "cbp_luma": cbp_luma.reshape(mbh, mbw).astype(jnp.uint8),
        "cbp_chroma": cbp_chroma.reshape(mbh, mbw).astype(jnp.uint8),
        "chroma_dc": jnp.stack(
            [levs_c[0][0], levs_c[1][0]],
            axis=1).reshape(mbh, mbw, 8).astype(jnp.int16),
        "chroma_ac": jnp.stack(
            [jnp.moveaxis(levs_c[0][1], (1, 2), (3, 4)),
             jnp.moveaxis(levs_c[1][1], (1, 2), (3, 4))],
            axis=1).reshape(mbh, mbw, 128).astype(jnp.int16),
        "recon_y": untile(rec, 16).astype(jnp.uint8),
        "recon_u": untile(recs_c[0], 8).astype(jnp.uint8),
        "recon_v": untile(recs_c[1], 8).astype(jnp.uint8),
    }


# ---------------------------------------------------------------------------
# B partitions: 16x8 / 8x16 with per-partition list choice + B_8x8 with
# per-block sub modes (direct/L0/L1/BI).
#
# Reference: the B partition analysis of x264_macroblock_analyse
# (analyse.c:3110-3466: b8x8 -> b16x8/b8x16 from the cached per-8x8
# list costs) and the mb_type/sub_mb_type coding tables
# (encoder/cavlc.c:44-58, spec Tables 7-14/7-18). Batched redesign: the
# per-list exhaustive all-shapes scan (partition.fullpel_search_parts)
# runs once per list; BI unit costs are exact gathers at the per-list
# unit winners; the shape x list-combo decision is one batched argmin
# with ue() header-bit lambda terms; subpel refinement and the final
# SATD-level combo re-choice reuse the 8x8 qpel-table machinery.
# ---------------------------------------------------------------------------

from .partition import (fullpel_search_parts, gather_windows8_jnp,
                        gather_windows8_mref,
                        block_table8, wht8_flat, satd_flat, subpel_parts,
                        _mb_blocks8, _sp_to_z, _z_to_sp, BLOCK_UNIT,
                        N_UNITS, UNIT_BLOCKS, D_16x16 as PD16,
                        D_16x8, D_8x16, D_8x8)

# ue(k) bit size
_UE_BITS = np.array([2 * ((k + 1).bit_length() - 1) + 1
                     for k in range(64)], np.int32)

# mb_type ue codes for two-partition shapes, indexed [sel_a, sel_b]
# with sel in {0: L0, 1: L1, 2: BI} (x264 mb_type_b_to_golomb,
# encoder/cavlc.c:44-49; spec Table 7-14)
B_CODE_16X8 = np.array([[4, 8, 12], [10, 6, 14], [16, 18, 20]], np.int32)
B_CODE_8X16 = np.array([[5, 9, 13], [11, 7, 15], [17, 19, 21]], np.int32)
# sub_mb_type ue codes: sel {0:L0,1:L1,2:BI,3:direct} -> code
_B_SUB_CODE = np.array([1, 2, 3, 0], np.int32)


def _gather8_fp_mref(planes_r, r8, mv8sp, mbh: int, mbw: int):
    """Multi-ref twin of _gather8_fp: planes_r [R,Hp,Wp] full-pel
    planes, r8 [N8] per-8x8 ref index."""
    n8 = 4 * mbh * mbw
    bys = (jnp.arange(n8) // (2 * mbw)) * 8
    bxs = (jnp.arange(n8) % (2 * mbw)) * 8
    mvf = mv8sp.reshape(n8, 2)
    ys = bys + mc.PAD + mvf[:, 1]
    xs = bxs + mc.PAD + mvf[:, 0]
    yy = ys[:, None] + jnp.arange(8)
    xx = xs[:, None] + jnp.arange(8)
    return planes_r[r8[:, None, None], yy[:, :, None], xx[:, None, :]]


def _gather8_fp(plane, mv8sp, mbh: int, mbw: int):
    """Full-pel 8x8 windows at block base + mv: [N8, 8, 8] (spatial
    row-major block order). plane: padded full-pel [Hp, Wp]."""
    n8 = 4 * mbh * mbw
    bys = (jnp.arange(n8) // (2 * mbw)) * 8
    bxs = (jnp.arange(n8) % (2 * mbw)) * 8
    mvf = mv8sp.reshape(n8, 2)
    ys = bys + mc.PAD + mvf[:, 1]
    xs = bxs + mc.PAD + mvf[:, 0]
    yy = ys[:, None] + jnp.arange(8)
    xx = xs[:, None] + jnp.arange(8)
    return plane[yy[:, :, None], xx[:, None, :]]


def _shape_mv_fields(st):
    """Per-shape per-8x8 (z-order) full-pel MV fields [4, mbh, mbw, 4, 2]
    from a fullpel_search_parts state."""
    mbh, mbw = st["c16"].shape
    return jnp.stack([
        jnp.broadcast_to(st["mv16"][:, :, None, :], (mbh, mbw, 4, 2)),
        st["mv16x8"][:, :, jnp.array([0, 0, 1, 1]), :],
        st["mv8x16"][:, :, jnp.array([0, 1, 0, 1]), :],
        st["mv8"],
    ])


def _unit_reduce(per_block, part_kind: int):
    """[..., 4] per-block -> per-unit sums replicated back to blocks."""
    if part_kind == PD16:
        return jnp.broadcast_to(per_block.sum(-1, keepdims=True),
                                per_block.shape)
    if part_kind == D_16x8:
        return (per_block[..., jnp.array([0, 0, 2, 2])]
                + per_block[..., jnp.array([1, 1, 3, 3])])
    if part_kind == D_8x16:
        return (per_block[..., jnp.array([0, 1, 0, 1])]
                + per_block[..., jnp.array([2, 3, 2, 3])])
    return per_block


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw"))
def analyse_b_parts_stage1(y, ref0_luma, ref1_luma, rng: int,
                           mbh: int, mbw: int, lam):
    """Per-list all-shapes full-pel scans (stage 1 of the B partition
    analysis). Returns (st0, st1) fullpel_search_parts states; the
    host pulls only mv16 of each to seed the approximate direct
    fields, everything else stays device-resident for stage 2."""
    zero = jnp.zeros((mbh, mbw, 2), jnp.int32)
    st0 = fullpel_search_parts.__wrapped__(
        y, ref0_luma[0], zero, rng, mbh, mbw, lam)
    st1 = fullpel_search_parts.__wrapped__(
        y, ref1_luma[0], zero, rng, mbh, mbw, lam)
    return st0, st1


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "nrefs"))
def analyse_b_parts_stage1_mref(y, refs0_luma, n_valid, ref1_luma,
                                rng: int, mbh: int, mbw: int, lam,
                                nrefs: int):
    """Multi-ref twin of analyse_b_parts_stage1: the L0 all-shapes
    scan runs per DPB entry; the per-MB ref is chosen at 16x16 with
    REF_COST (the x264 b16x16 ref sweep feeding every partition shape
    of that MB, analyse.c a->l0.i_ref), and the whole L0 state is
    gathered per MB at that ref. The per-unit te(ref) bits ride the
    merged L0 cost fields so the shape decision pays them. Returns
    (st0, st1, ref0 [mbh,mbw])."""
    from .partition import te_ref_bits
    zero = jnp.zeros((mbh, mbw, 2), jnp.int32)
    ref_bits = jnp.asarray(te_ref_bits(nrefs))
    sts = [fullpel_search_parts.__wrapped__(
        y, refs0_luma[r][0], zero, rng, mbh, mbw, lam)
        for r in range(nrefs)]
    c16 = jnp.stack([
        jnp.where(r < n_valid,
                  sts[r]["c16"] + lam * ref_bits[r],
                  jnp.int32(1 << 28))
        for r in range(nrefs)])
    ref0 = jnp.argmin(c16, axis=0).astype(jnp.int32)      # [mbh,mbw]
    st0 = {}
    for k in sts[0]:
        arr = jnp.stack([sts[r][k] for r in range(nrefs)])
        idx = ref0.reshape((1, mbh, mbw) + (1,) * (arr.ndim - 3))
        st0[k] = jnp.take_along_axis(
            arr, jnp.broadcast_to(idx, (1,) + arr.shape[1:]),
            axis=0)[0]
    rb = (lam * ref_bits[ref0]).astype(st0["c16"].dtype)
    st0 = dict(st0)
    st0["c16"] = st0["c16"] + rb
    st0["c16x8"] = st0["c16x8"] + rb[..., None]
    st0["c8x16"] = st0["c8x16"] + rb[..., None]
    st0["c8"] = st0["c8"] + rb[..., None]
    st1 = fullpel_search_parts.__wrapped__(
        y, ref1_luma[0], zero, rng, mbh, mbw, lam)
    return st0, st1, ref0


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "subpel"))
def analyse_b_parts(y, ref0_luma, ref1_luma, st0, st1, c_dir8,
                    mbh: int, mbw: int, lam, subpel: int, w1=32,
                    ref0_map=None):
    """Fused B partition analysis (stage 2).

    st0/st1: per-list all-shapes states from analyse_b_parts_stage1;
    c_dir8: [mbh, mbw, 4] SATD of the approximate per-8x8 direct
    prediction (bipred_satd8_device). Returns dict:
      part   [mbh,mbw]       chosen shape (0 16x16 / 1 16x8 / 2 8x16 /
                             3 8x8)
      sel8   [mbh,mbw,4]     per-block list choice replicated per unit
                             (0 L0 / 1 L1 / 2 BI / 3 direct-8x8)
      mv0_8, mv1_8 [2mbh,2mbw,2] refined qpel MVs (valid where used)
      c_cfg  [mbh,mbw]       SATD cost of the committed config incl.
                             lambda * mb_type/sub/mvd bits
    """
    n = mbh * mbw
    n8 = 4 * n
    cur8 = _mb_blocks8(y, mbh, mbw)
    wcur8 = wht8_flat(cur8)                                # [N8,64]
    zero = jnp.zeros((mbh, mbw, 2), jnp.int32)
    # multi-ref B lists: ref0_luma is a STACKED [R,4,Hp,Wp] DPB and
    # ref0_map [mbh,mbw] selects each MB's plane for every L0 gather
    r8_map = None
    if ref0_map is not None:
        r8_map = jnp.repeat(jnp.repeat(ref0_map, 2, 0), 2, 1) \
            .reshape(n8)

    bits_t = jnp.asarray(mv_bits_table(4 * 512))
    boff = 4 * 512

    def mvc_of(mv):   # [.., 2] full-pel mv, zero pred -> lambda bits
        return (bits_t[jnp.clip(4 * mv[..., 0], -boff, boff) + boff]
                + bits_t[jnp.clip(4 * mv[..., 1], -boff, boff) + boff]) \
            * lam

    f0 = _shape_mv_fields(st0)                 # [4,mbh,mbw,4,2]
    f1 = _shape_mv_fields(st1)
    ue = jnp.asarray(_UE_BITS)

    # exact full-pel BI SAD per shape: average the two lists' windows at
    # the shape's unit MVs, SAD per 8x8, reduce per unit
    bi_unit = []                               # [4][mbh,mbw,4] unit sums
    for s in range(4):
        if r8_map is None:
            w0 = _gather8_fp(ref0_luma[0], _z_to_sp(f0[s], mbh, mbw),
                             mbh, mbw)
        else:
            w0 = _gather8_fp_mref(ref0_luma[:, 0], r8_map,
                                  _z_to_sp(f0[s], mbh, mbw), mbh, mbw)
        w1b = _gather8_fp(ref1_luma[0], _z_to_sp(f1[s], mbh, mbw),
                          mbh, mbw)
        avg = _bi_avg(w0, w1b, w1)
        sad = jnp.sum(jnp.abs(cur8 - avg), axis=(1, 2))    # [N8]
        sadz = _sp_to_z(sad.reshape(2 * mbh, 2 * mbw), mbh, mbw)
        bi_unit.append(_unit_reduce(sadz, s)
                       + mvc_of(f0[s]) + mvc_of(f1[s]))

    # ---- full-pel shape + combo decision (SAD level) ----
    # 16x16: L0 / L1 / BI with their mb_type ue bits
    c16_cands = jnp.stack([st0["c16"] + lam * ue[1],
                           st1["c16"] + lam * ue[2],
                           bi_unit[0][..., 0] + lam * ue[3]])
    sel16 = jnp.argmin(c16_cands, axis=0)                  # [mbh,mbw]
    tot16 = jnp.min(c16_cands, axis=0)

    # 16x8 / 8x16: 9 list combos, mb_type bits from the code tables
    def two_part(stk, bik, code_tab):
        ca = jnp.stack([stk[0][..., 0], stk[1][..., 0], bik[..., 0]])
        cb = jnp.stack([stk[0][..., 1], stk[1][..., 1], bik[..., 1]])
        combos = (ca[:, None] + cb[None, :]
                  + lam * ue[jnp.asarray(code_tab)][:, :, None, None])
        combos = combos.reshape(9, mbh, mbw)
        sel = jnp.argmin(combos, axis=0)
        return sel, jnp.min(combos, axis=0)

    sel_16x8, tot16x8 = two_part((st0["c16x8"], st1["c16x8"]),
                                 bi_unit[1][..., jnp.array([0, 2])],
                                 B_CODE_16X8)
    sel_8x16, tot8x16 = two_part((st0["c8x16"], st1["c8x16"]),
                                 bi_unit[2][..., jnp.array([0, 1])],
                                 B_CODE_8X16)

    # 8x8: per-block min over sub modes (direct8 joins at the SATD
    # stage below; full-pel shape choice uses the inter subs only)
    c8_cands = jnp.stack([st0["c8"] + lam * ue[1],
                          st1["c8"] + lam * ue[2],
                          bi_unit[3] + lam * ue[3]])
    tot8 = jnp.min(c8_cands, axis=0).sum(-1) + lam * ue[22]

    shape_tot = jnp.stack([tot16, tot16x8, tot8x16, tot8])
    part = jnp.argmin(shape_tot, axis=0).astype(jnp.int32)

    # per-8x8 full-pel MV fields of the chosen shape, per list
    mvfp8_0z = jnp.take_along_axis(
        f0, part[None, :, :, None, None], axis=0)[0]       # [mbh,mbw,4,2]
    mvfp8_1z = jnp.take_along_axis(
        f1, part[None, :, :, None, None], axis=0)[0]
    mvfp8_0 = _z_to_sp(mvfp8_0z, mbh, mbw)
    mvfp8_1 = _z_to_sp(mvfp8_1z, mbh, mbw)

    # ---- subpel refinement per list at the chosen shape ----
    outs = []
    for li, (ref_luma, mvfp8) in enumerate(
            ((ref0_luma, mvfp8_0), (ref1_luma, mvfp8_1))):
        if li == 0 and r8_map is not None:
            win = gather_windows8_mref(
                ref_luma.astype(jnp.uint8), mvfp8, r8_map, mbh, mbw)
        else:
            win = gather_windows8_jnp(ref_luma.astype(jnp.uint8),
                                      mvfp8, mbh, mbw)
        blocks8 = block_table8(win)                        # [169,N8,8,8]
        wtab = wht8_flat(blocks8).astype(jnp.int16)
        mv8, r_idx8, _ = subpel_parts.__wrapped__(
            y, wtab, part, mvfp8, zero, mbh, mbw, lam, subpel)
        blk = blocks8[r_idx8, jnp.arange(n8)].astype(jnp.int32)
        outs.append((mv8, blk))
    (mv8_0, blk0), (mv8_1, blk1) = outs

    # refined per-block SATDs
    satd0 = satd_flat(wcur8, wht8_flat(blk0))              # [N8]
    satd1 = satd_flat(wcur8, wht8_flat(blk1))
    satdbi = satd_flat(wcur8, wht8_flat(_bi_avg(blk0, blk1, w1)))
    s0z = _sp_to_z(satd0.reshape(2 * mbh, 2 * mbw), mbh, mbw)
    s1z = _sp_to_z(satd1.reshape(2 * mbh, 2 * mbw), mbh, mbw)
    sbz = _sp_to_z(satdbi.reshape(2 * mbh, 2 * mbw), mbh, mbw)
    mv0z = _sp_to_z(mv8_0, mbh, mbw)                       # [mbh,mbw,4,2]
    mv1z = _sp_to_z(mv8_1, mbh, mbw)

    def mvc_q(mv):    # qpel mv, zero pred
        return (bits_t[jnp.clip(mv[..., 0], -boff, boff) + boff]
                + bits_t[jnp.clip(mv[..., 1], -boff, boff) + boff]) * lam

    # per-unit refined costs per shape (replicated to member blocks)
    u0 = jnp.stack([_unit_reduce(s0z, s) for s in range(4)])
    u1 = jnp.stack([_unit_reduce(s1z, s) for s in range(4)])
    ub = jnp.stack([_unit_reduce(sbz, s) for s in range(4)])
    take = lambda a: jnp.take_along_axis(
        a, part[None, :, :, None], axis=0)[0]              # [mbh,mbw,4]
    cu0 = take(u0) + mvc_q(mv0z)
    cu1 = take(u1) + mvc_q(mv1z)
    cub = take(ub) + mvc_q(mv0z) + mvc_q(mv1z)

    # ---- final combo choice at SATD level ----
    # 16x16 (block 0 carries the unit)
    c16f = jnp.stack([cu0[..., 0] + lam * ue[1],
                      cu1[..., 0] + lam * ue[2],
                      cub[..., 0] + lam * ue[3]])
    sel16f = jnp.argmin(c16f, axis=0)
    tot16f = jnp.min(c16f, axis=0)

    def two_part_f(ua, ub2, code_tab):
        # ua/ub2: [3, mbh, mbw] unit costs (L0/L1/BI) for units 0/1
        combos = (ua[:, None] + ub2[None, :]
                  + lam * ue[jnp.asarray(code_tab)][:, :, None, None])
        combos = combos.reshape(9, mbh, mbw)
        return jnp.argmin(combos, axis=0), jnp.min(combos, axis=0)

    top = jnp.stack([cu0[..., 0], cu1[..., 0], cub[..., 0]])
    bot = jnp.stack([cu0[..., 2], cu1[..., 2], cub[..., 2]])
    sel_h, tot_h = two_part_f(top, bot, B_CODE_16X8)
    left = jnp.stack([cu0[..., 0], cu1[..., 0], cub[..., 0]])
    right = jnp.stack([cu0[..., 1], cu1[..., 1], cub[..., 1]])
    sel_v, tot_v = two_part_f(left, right, B_CODE_8X16)

    # 8x8: per-block {L0, L1, BI, direct8}
    c8f = jnp.stack([cu0 + lam * ue[3],          # sub code 1 -> 3 bits
                     cu1 + lam * ue[3],
                     cub + lam * ue[5],          # code 3 -> 5 bits
                     c_dir8 + lam * ue[1]])      # code 0 -> 1 bit
    sel8x8 = jnp.argmin(c8f, axis=0)                       # [mbh,mbw,4]
    tot8f = jnp.min(c8f, axis=0).sum(-1) + lam * ue[22]

    # final per-MB cost of the committed shape
    c_cfg = jnp.choose(part, [tot16f, tot_h, tot_v, tot8f],
                       mode="clip")

    # sel8: per-block selection replicated per unit
    sel16_8 = jnp.broadcast_to(sel16f[..., None], (mbh, mbw, 4))
    selh_8 = jnp.stack([sel_h // 3, sel_h // 3,
                        sel_h % 3, sel_h % 3], axis=-1)
    selv_8 = jnp.stack([sel_v // 3, sel_v % 3,
                        sel_v // 3, sel_v % 3], axis=-1)
    sel8 = jnp.choose(part[..., None],
                      [sel16_8, selh_8, selv_8, sel8x8], mode="clip") \
              .astype(jnp.int32)
    return dict(part=part, sel8=sel8,
                mv0_8=mv8_0, mv1_8=mv8_1, c_cfg=c_cfg)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw"))
def bipred_satd8_device(y, ref0_luma, ref1_luma, use0, use1, mv0_8,
                        mv1_8, mbh: int, mbw: int, w1=32):
    """Per-8x8 SATD of the (approximate) direct prediction
    [mbh, mbw, 4] (z-order) — per-8x8 granular twin of
    bipred_satd_device for the B_8x8 direct sub-mode."""
    n8 = 4 * mbh * mbw
    ys8 = (jnp.arange(n8) // (2 * mbw)) * 8
    xs8 = (jnp.arange(n8) % (2 * mbw)) * 8
    u0 = use0.reshape(n8)[:, None, None]
    u1 = use1.reshape(n8)[:, None, None]
    p0 = mc.mc_luma(ref0_luma, ys8, xs8, mv0_8.reshape(n8, 2),
                    bh=8, bw=8)
    p1 = mc.mc_luma(ref1_luma, ys8, xs8, mv1_8.reshape(n8, 2),
                    bh=8, bw=8)
    p8 = jnp.where(u0 & u1, _bi_avg(p0, p1, w1), jnp.where(u0, p0, p1))
    cur8 = _mb_blocks8(y, mbh, mbw)
    satd = satd_flat(wht8_flat(cur8), wht8_flat(p8))       # [N8]
    return _sp_to_z(satd.reshape(2 * mbh, 2 * mbw), mbh, mbw)


# ---------------------------------------------------------------------------
# Spatial direct derivation + host raster scan (spec 8.4.1.2.2)
# ---------------------------------------------------------------------------

# per-8x8 colocated corner 4x4 (direct_8x8_inference_flag == 1)
_COL_CORNERS = [(0, 0), (0, 3), (3, 0), (3, 3)]


def spatial_direct(g0: _Grid, g1: _Grid, col_mv4, col_ref4,
                   my: int, mx: int, with_refs: bool = False):
    """Spatial direct MVs for one MB (spec 8.4.1.2.2: refIdxLX =
    MinPositive over the A/B/C neighbours, ref-matched median MVP).
    col_mv4/col_ref4: the L1[0] anchor's own motion field.
    Returns (use0, use1, mv0 [4,2] per 8x8 z-order, mv1 [4,2]);
    with_refs appends (refIdxL0, refIdxL1) — the derived refs, 0 when
    directZeroPrediction."""
    y4, x4 = 4 * my, 4 * mx
    refs, mvps = [], []
    for g in (g0, g1):
        mva, ra, av_a = g.nb(y4, x4 - 1)
        mvb, rb, av_b = g.nb(y4 - 1, x4)
        mvc, rc, av_c = g.nb(y4 - 1, x4 + 4)
        if not av_c:
            mvc, rc, av_c = g.nb(y4 - 1, x4 - 1)
        cand = [r for r in (ra, rb, rc) if r >= 0]
        ref = min(cand) if cand else -1
        refs.append(ref)
        if ref >= 0:
            mvps.append(unit_mvp(g, y4, x4, 4, D_16x16, 0, ref=ref))
        else:
            mvps.append(np.zeros(2, np.int32))
    mv0 = np.zeros((4, 2), np.int32)
    mv1 = np.zeros((4, 2), np.int32)
    if refs[0] < 0 and refs[1] < 0:
        # directZeroPredictionFlag: both lists, zero MVs, refs 0
        if with_refs:
            return True, True, mv0, mv1, 0, 0
        return True, True, mv0, mv1
    use0, use1 = refs[0] >= 0, refs[1] >= 0
    for b, (cy, cx) in enumerate(_COL_CORNERS):
        colr = int(col_ref4[y4 + cy, x4 + cx])
        colm = col_mv4[y4 + cy, x4 + cx]
        col_zero = (colr == 0 and abs(int(colm[0])) <= 1
                    and abs(int(colm[1])) <= 1)
        for use, ref, mvp, out in ((use0, refs[0], mvps[0], mv0),
                                   (use1, refs[1], mvps[1], mv1)):
            if use:
                out[b] = 0 if (ref == 0 and col_zero) else mvp
    if with_refs:
        return use0, use1, mv0, mv1, max(refs[0], 0), max(refs[1], 0)
    return use0, use1, mv0, mv1


def dist_scale_factor(poc_b, poc0, poc1) -> int:
    """DistScaleFactor for temporal direct (spec 8.4.1.2.3; reference
    x264_macroblock_bipred_init common/macroblock.c dist_scale_factor
    derivation). poc0 = L0[0]'s poc, poc1 = L1[0]'s."""
    td = int(np.clip(poc1 - poc0, -128, 127))
    tb = int(np.clip(poc_b - poc0, -128, 127))
    if td == 0:
        return 256
    # trunc-toward-zero division (spec 8.4.1.2.3 / C semantics), not
    # Python floor — matters when td < 0
    tx = (16384 + abs(td) // 2) // abs(td) * (1 if td > 0 else -1)
    return int(np.clip((tb * tx + 32) >> 6, -1024, 1023))


def temporal_direct_fields(col_mv4, col_ref4, dsf, col_map=None):
    """Temporal direct fields, whole frame (spec 8.4.1.2.3; reference
    x264_mb_predict_mv_direct16x16_temporal, common/macroblock.c:165).

    Per 8x8 (direct_8x8_inference) the colocated corner 4x4 of L1[0]'s
    own motion field scales by POC distances: mvL0 = (DSF*mvCol+128)>>8,
    mvL1 = mvL0 - mvCol; colocated intra -> zeros with refs 0.

    dsf scalar (single-ref L0): a colocated ref > 0 has no image in
    the one-entry B L0 list (map_col_to_list0 < 0, macroblock.c:
    187-207) -> the whole MB is direct-unavailable.
    dsf [R] array (multi-ref B lists): refIdxL0 = map_col_to_list0 of
    the colocated ref, and each block scales by ITS mapped ref's
    DistScaleFactor.

    col_map (optional [Rcol] int array): map_col_to_list0 — colocated
    ref idx -> the B's L0 idx, -1 where the colocated ref has no image
    in the active L0 (macroblock.c:830-841 built by POC matching;
    :199 returns 0 = the whole MB is direct-unavailable). None keeps
    the legacy identity rule (the B's L0 IS the colocated frame's L0
    — true for every non-pyramid GOP).

    Unlike spatial, nothing depends on neighbour commits, so the field
    is computed once per frame, vectorized. Returns (avail [mbh,mbw]
    bool, mv0_8 [2mbh,2mbw,2], mv1_8, ref8_0 [2mbh,2mbw])."""
    h4, w4 = col_ref4.shape
    mbh, mbw = h4 // 4, w4 // 4
    iy = np.arange(2 * mbh)
    ix = np.arange(2 * mbw)
    cy = (iy // 2) * 4 + (iy % 2) * 3   # corner 4x4 per 8x8
    cx = (ix // 2) * 4 + (ix % 2) * 3
    colm = col_mv4[np.ix_(cy, cx)].astype(np.int64)   # [2mbh,2mbw,2]
    colr = col_ref4[np.ix_(cy, cx)]                   # [2mbh,2mbw]
    # -1 = colocated intra (available with zeros/ref 0); <= -2 = the
    # colocated block carries no L0 motion (a reference B's L1-only
    # block: x264's cache reads ref[0] = -1 there and the whole MB is
    # direct-unavailable, macroblock.c:199)
    intra = colr == -1
    unused = colr <= -2
    mref = isinstance(dsf, np.ndarray) and dsf.ndim == 1
    if col_map is not None:
        cm = np.asarray(col_map, np.int32)
        mapped = np.where(colr < 0, 0,
                          cm[np.clip(colr, 0, len(cm) - 1)])
        ok8 = intra | (~unused & (mapped >= 0))
        ref8 = np.maximum(mapped, 0).astype(np.int32)
        avail = ok8.reshape(mbh, 2, mbw, 2).all(axis=(1, 3))
    elif mref:
        ref8 = np.where(colr < 0, 0, colr).astype(np.int32)
        avail = (intra | ~unused).reshape(mbh, 2, mbw, 2) \
            .all(axis=(1, 3))
    else:
        ref8 = np.zeros_like(colr, np.int32)
        ok8 = intra | (colr == 0)
        avail = ok8.reshape(mbh, 2, mbw, 2).all(axis=(1, 3))
    intra = colr < 0    # zeros for every no-L0-motion cell
    dsf_b = (dsf[np.clip(ref8, 0, len(dsf) - 1)][..., None]
             if mref else dsf)
    mv0 = (dsf_b * colm + 128) >> 8     # arithmetic shift, C twin
    mv1 = mv0 - colm
    mv0 = np.where(intra[..., None], 0, mv0).astype(np.int32)
    mv1 = np.where(intra[..., None], 0, mv1).astype(np.int32)
    return avail, mv0, mv1, ref8


def _tdir_mb(tdir, my, mx):
    """One MB's direct derivation from the precomputed temporal field
    (same return shape as spatial_direct + per-8x8 L0 refs)."""
    avail, tmv0, tmv1, tref = tdir
    ok = bool(avail[my, mx])
    dmv0 = tmv0[2 * my:2 * my + 2, 2 * mx:2 * mx + 2].reshape(4, 2)
    dmv1 = tmv1[2 * my:2 * my + 2, 2 * mx:2 * mx + 2].reshape(4, 2)
    dr8 = tref[2 * my:2 * my + 2, 2 * mx:2 * mx + 2].reshape(4)
    return ok, ok, dmv0, dmv1, dr8


def approx_direct_fields(mv0, mv1, col_mv4, col_ref4):
    """Approximate direct fields for the device direct-cost
    pre-evaluation: every MB is assumed committed L0@mv0 / L1@mv1
    (the 'inter-field' approximation — exact only where neighbours
    end up choosing those modes; the committed direct MVs are always
    re-derived exactly in scan_b_frame). Returns (use0, use1,
    mv0_8 [2mbh,2mbw,2], mv1_8) per 8x8."""
    mbh, mbw = mv0.shape[:2]
    outs = []
    for mv in (mv0, mv1):
        g = _Grid(mbh, mbw)
        g.mv[:] = np.repeat(np.repeat(mv, 4, 0), 4, 1)
        g.ref[:] = 0
        g.dec[:] = True
        dmv8 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
        for my in range(mbh):
            for mx in range(mbw):
                y4, x4 = 4 * my, 4 * mx
                mvp = unit_mvp(g, y4, x4, 4, D_16x16, 0, ref=0)
                for b, (cy, cx) in enumerate(_COL_CORNERS):
                    colr = int(col_ref4[y4 + cy, x4 + cx])
                    colm = col_mv4[y4 + cy, x4 + cx]
                    cz = (colr == 0 and abs(int(colm[0])) <= 1
                          and abs(int(colm[1])) <= 1)
                    dmv8[2 * my + (b >> 1), 2 * mx + (b & 1)] = \
                        0 if cz else mvp
        outs.append(dmv8)
    ones = np.ones((2 * mbh, 2 * mbw), np.int32)
    return ones, ones.copy(), outs[0], outs[1]


# unit geometry per B shape: (member blocks, oy4, ox4, h4, w4, mvp kind)
_B_UNIT_GEOM = {
    0: [((0, 1, 2, 3), 0, 0, 4, 4, D_16x16)],
    1: [((0, 1), 0, 0, 2, 4, D_16x8), ((2, 3), 2, 0, 2, 4, D_16x8)],
    2: [((0, 2), 0, 0, 4, 2, D_8x16), ((1, 3), 0, 2, 4, 2, D_8x16)],
    3: [((0,), 0, 0, 2, 2, D_8x8), ((1,), 0, 2, 2, 2, D_8x8),
        ((2,), 2, 0, 2, 2, D_8x8), ((3,), 2, 2, 2, 2, D_8x8)],
}


def scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir, col_mv4,
                 col_ref4, lam: int, intra=None, tdir=None,
                 ref0=None):
    """Host raster commit for the B partition path: exact spatial
    direct derivation, direct-vs-config decision, per-unit MVP/mvd for
    both lists (all-L0-then-all-L1 syntax order; within a list the MVP
    of a later unit sees this MB's earlier units, spec 8.4.1.3).
    ref0: optional [mbh,mbw] per-MB L0 ref (multi-ref B lists: every
    L0/BI unit of the MB codes that ref, the x264 per-MB ref model);
    appends ref8_0 [2mbh,2mbw] to the returns (-1 where L0 unused).

    part/sel8/c_cfg: analyse_b_parts outputs (numpy); mv0z/mv1z
    [mbh,mbw,4,2] z-order per-block qpel fields; c_dir [mbh,mbw]
    16x16-direct SATD. Returns (code [mbh,mbw] spec ue mb_type value,
    subs [mbh,mbw,4] sub_mb_type ue codes (part 3 only), use0/use1
    [2mbh,2mbw], fmv0/fmv1 [2mbh,2mbw,2], mvd0/mvd1 [mbh,mbw,4,2]
    per-unit in coding order). intra: optional [mbh,mbw] mask — intra
    MBs carry no MVs but ARE committed as available neighbours with
    mv 0 / ref -1 in BOTH lists (x264 cache ref -1 for intra vs -2 for
    outside, macroblock.c:28-46; spec 8.4.1.3): they join the MVP
    median and the spatial-direct ref derivation without triggering
    the C->D fallback or the lone-A rule — same convention as the
    decoder's dec4/ref4 state and the P-path scans."""
    mbh, mbw = part.shape
    g0, g1 = _Grid(mbh, mbw), _Grid(mbh, mbw)
    code = np.zeros((mbh, mbw), np.int32)
    subs = np.zeros((mbh, mbw, 4), np.int32)
    use0 = np.zeros((2 * mbh, 2 * mbw), np.int32)
    use1 = np.zeros((2 * mbh, 2 * mbw), np.int32)
    fmv0 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
    fmv1 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
    mvd0 = np.zeros((mbh, mbw, 4, 2), np.int32)
    mvd1 = np.zeros((mbh, mbw, 4, 2), np.int32)
    ref8_0 = np.full((2 * mbh, 2 * mbw), -1, np.int32)
    for my in range(mbh):
        for mx in range(mbw):
            if intra is not None and intra[my, mx]:
                # available with mv 0 / ref -1 in both lists (x264
                # cache -1 vs -2 outside; decoder dec4 twin)
                g0.commit(4 * my, 4 * mx, 4, 4, 0, ref=-1)
                g1.commit(4 * my, 4 * mx, 4, 4, 0, ref=-1)
                continue
            y4, x4 = 4 * my, 4 * mx
            dr8 = np.zeros(4, np.int32)
            if tdir is None:
                du0, du1, dmv0, dmv1, dsr0, _dr1 = spatial_direct(
                    g0, g1, col_mv4, col_ref4, my, mx, with_refs=True)
                dr8[:] = dsr0
            else:
                du0, du1, dmv0, dmv1, dr8 = _tdir_mb(tdir, my, mx)
            r0 = int(ref0[my, mx]) if ref0 is not None else 0
            if du0 and c_dir[my, mx] + lam <= c_cfg[my, mx]:
                # B_Direct_16x16 (code 0): commit per 8x8
                u0i, u1i = int(du0), int(du1)
                for b in range(4):
                    by, bx = y4 + 2 * (b >> 1), x4 + 2 * (b & 1)
                    sy, sx = 2 * my + (b >> 1), 2 * mx + (b & 1)
                    use0[sy, sx] = u0i
                    use1[sy, sx] = u1i
                    if u0i:
                        fmv0[sy, sx] = dmv0[b]
                        ref8_0[sy, sx] = int(dr8[b])
                    if u1i:
                        fmv1[sy, sx] = dmv1[b]
                    g0.commit(by, bx, 2, 2, dmv0[b],
                              ref=int(dr8[b]) if u0i else -1)
                    g1.commit(by, bx, 2, 2, dmv1[b],
                              ref=0 if u1i else -1)
                continue
            p = int(part[my, mx])
            units = _B_UNIT_GEOM[p]
            # mb_type code from shape + per-unit selections
            if p == 0:
                s = int(sel8[my, mx, 0])
                code[my, mx] = 1 + s
            elif p == 1:
                code[my, mx] = B_CODE_16X8[int(sel8[my, mx, 0]),
                                           int(sel8[my, mx, 2])]
            elif p == 2:
                code[my, mx] = B_CODE_8X16[int(sel8[my, mx, 0]),
                                           int(sel8[my, mx, 1])]
            else:
                code[my, mx] = 22
                for b in range(4):
                    subs[my, mx, b] = _B_SUB_CODE[int(sel8[my, mx, b])]
            for l, (g, mvz, duse, dmv, usearr, fmvarr, mvdarr) in \
                    enumerate(((g0, mv0z, du0, dmv0, use0, fmv0, mvd0),
                               (g1, mv1z, du1, dmv1, use1, fmv1, mvd1))):
                for u, (blocks, oy, ox, h4, w4, kind) in \
                        enumerate(units):
                    b0 = blocks[0]
                    s = int(sel8[my, mx, b0])
                    if s == 3:    # direct 8x8 sub-mode (part 3 only)
                        ui = int(duse)
                        for b in blocks:
                            sy = 2 * my + (b >> 1)
                            sx = 2 * mx + (b & 1)
                            usearr[sy, sx] = ui
                            if ui:
                                fmvarr[sy, sx] = dmv[b]
                                if l == 0:
                                    ref8_0[sy, sx] = int(dr8[b])
                            g.commit(y4 + 2 * (b >> 1), x4 + 2 * (b & 1),
                                     2, 2, dmv[b],
                                     ref=(int(dr8[b]) if l == 0 else 0)
                                     if ui else -1)
                        continue
                    uses = (s == l) or (s == 2)
                    ur = r0 if l == 0 else 0
                    mv = mvz[my, mx, b0].copy() if uses \
                        else np.zeros(2, np.int32)
                    if uses:
                        mvp = unit_mvp(g, y4 + oy, x4 + ox, w4, kind,
                                       u, ref=ur)
                        mvdarr[my, mx, u] = mv - mvp
                    for b in blocks:
                        sy, sx = 2 * my + (b >> 1), 2 * mx + (b & 1)
                        usearr[sy, sx] = 1 if uses else 0
                        if uses:
                            fmvarr[sy, sx] = mv
                            if l == 0:
                                ref8_0[sy, sx] = ur
                    g.commit(y4 + oy, x4 + ox, h4, w4, mv,
                             ref=ur if uses else -1)
    return code, subs, use0, use1, fmv0, fmv1, mvd0, mvd1, ref8_0


def scan_b_frame(c_dir, c0, c1, cbi, mv0, mv1, col_mv4, col_ref4,
                 lam: int, intra=None, tdir=None, ref0=None):
    """Host raster scan for a B frame: per-MB mode decision + exact
    direct derivation + mvd/mvp. ref0: optional [mbh,mbw] per-MB L0
    ref (multi-ref B lists; None = all 0 — the L0 MVP is ref-matched
    per 8.4.1.3.1 either way). Returns (mode [mbh,mbw] in
    {0 direct,1 L0,2 L1,3 BI}, use0/use1 [2mbh,2mbw] int32,
    fmv0/fmv1 [2mbh,2mbw,2], mvd0/mvd1 [mbh,mbw,2], ref8_0
    [2mbh,2mbw] per-8x8 L0 ref, -1 where L0 unused)."""
    mbh, mbw = c0.shape
    g0, g1 = _Grid(mbh, mbw), _Grid(mbh, mbw)
    mode = np.zeros((mbh, mbw), np.int32)
    use0 = np.zeros((2 * mbh, 2 * mbw), np.int32)
    use1 = np.zeros((2 * mbh, 2 * mbw), np.int32)
    fmv0 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
    fmv1 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
    mvd0 = np.zeros((mbh, mbw, 2), np.int32)
    mvd1 = np.zeros((mbh, mbw, 2), np.int32)
    ref8_0 = np.full((2 * mbh, 2 * mbw), -1, np.int32)
    hdr = _B_HDR_BITS
    for my in range(mbh):
        for mx in range(mbw):
            if intra is not None and intra[my, mx]:
                # available with mv 0 / ref -1 in both lists (x264
                # cache -1 vs -2 outside; decoder dec4 twin)
                g0.commit(4 * my, 4 * mx, 4, 4, 0, ref=-1)
                g1.commit(4 * my, 4 * mx, 4, 4, 0, ref=-1)
                continue
            y4, x4 = 4 * my, 4 * mx
            dr1 = 0
            dr8 = np.zeros(4, np.int32)
            if tdir is None:
                du0, du1, dmv0, dmv1, dr0, dr1 = spatial_direct(
                    g0, g1, col_mv4, col_ref4, my, mx, with_refs=True)
                dr8[:] = dr0
            else:
                du0, du1, dmv0, dmv1, dr8 = _tdir_mb(tdir, my, mx)
            cands = np.array([
                (c_dir[my, mx] if du0 or du1 else (1 << 60))
                + lam * hdr[0],
                c0[my, mx] + lam * hdr[1],
                c1[my, mx] + lam * hdr[2],
                cbi[my, mx] + lam * hdr[3]], np.int64)
            m = int(np.argmin(cands))
            mode[my, mx] = m
            sy, sx = slice(2 * my, 2 * my + 2), slice(2 * mx, 2 * mx + 2)
            if m == B_DIRECT:
                u0i, u1i = int(du0), int(du1)
                use0[sy, sx] = u0i
                use1[sy, sx] = u1i
                fmv0[sy, sx] = dmv0.reshape(2, 2, 2)
                fmv1[sy, sx] = dmv1.reshape(2, 2, 2)
                if u0i:
                    ref8_0[sy, sx] = dr8.reshape(2, 2)
                # commit per 8x8 (direct MVs/refs can differ per block)
                for b in range(4):
                    by, bx = y4 + 2 * (b >> 1), x4 + 2 * (b & 1)
                    g0.commit(by, bx, 2, 2, dmv0[b],
                              ref=int(dr8[b]) if u0i else -1)
                    g1.commit(by, bx, 2, 2, dmv1[b],
                              ref=dr1 if u1i else -1)
                continue
            r0 = int(ref0[my, mx]) if ref0 is not None else 0
            if m in (B_L0, B_BI):
                mvp = unit_mvp(g0, y4, x4, 4, D_16x16, 0, ref=r0)
                mvd0[my, mx] = mv0[my, mx] - mvp
            if m in (B_L1, B_BI):
                mvp = unit_mvp(g1, y4, x4, 4, D_16x16, 0, ref=0)
                mvd1[my, mx] = mv1[my, mx] - mvp
            u0i = 1 if m in (B_L0, B_BI) else 0
            u1i = 1 if m in (B_L1, B_BI) else 0
            use0[sy, sx] = u0i
            use1[sy, sx] = u1i
            if u0i:
                fmv0[sy, sx] = mv0[my, mx]
                ref8_0[sy, sx] = r0
            if u1i:
                fmv1[sy, sx] = mv1[my, mx]
            g0.commit(y4, x4, 4, 4,
                      mv0[my, mx] if u0i else np.zeros(2, np.int32),
                      ref=r0 if u0i else -1)
            g1.commit(y4, x4, 4, 4,
                      mv1[my, mx] if u1i else np.zeros(2, np.int32),
                      ref=0 if u1i else -1)
    return mode, use0, use1, fmv0, fmv1, mvd0, mvd1, ref8_0
