"""I-frame encoder: wavefront-batched i16x16 + i4x4 analysis.

The reference walks macroblocks serially (encoder/encoder.c:1240-2060),
each MB consuming its left/top neighbours' *reconstructed* pixels
(common/macroblock.c:914 cache_load). The device design schedules the MB
grid in waves: every MB in wave d = mb_x + 2*mb_y is independent — the
factor 2 (a "knight's move" wavefront) also satisfies the i4x4
above-RIGHT dependency (spec 6.4.8: top-right 4x4 samples come from the
above-right MB). One `lax.fori_loop` step analyses, transforms and
reconstructs a whole wave as a batch (SURVEY.md §7 "wavefront
scheduling"). All wave membership tables are static, so the loop body
compiles once with fixed shapes; inactive lanes scatter out of bounds
and are dropped.

Per-MB pipeline (reference: x264_mb_analyse_intra analyse.c:628 +
x264_mb_encode_i16x16 encoder/macroblock.c:189-275, i4x4
x264_mb_encode_i4x4 :116-136 + the 16-block sweep analyse.c:698-750):
  i16x16: 4 luma modes -> SATD+mode-bits argmin -> fDCT -> DC Hadamard
  i4x4:   16 sub-blocks in z-scan order, each: 9 modes -> SATD +
          lambda*(1|4) predicted-mode bits -> transform/recon feeding
          the next block's borders (a static 16-step unroll inside the
          wave body — the in-MB serial chain the reference hides in its
          MB loop, batched across the whole wave here)
  winner by cost (i4x4 carries x264's +24*lambda overhead), then the
  same chroma pipeline with a joint U+V mode decision.

QP and lambda are traced scalars: one compiled program serves every
frame under rate control.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import transform as T
from ..ops import predict as P
from ..ops.transform import hadamard4x4, hadamard2x2
from ..ops.blocks import to_blocks

# z-scan of 4x4 luma blocks inside a MB (spec 6.4.3)
LUMA_SCAN = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3),
             (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]
_SCAN_IDX = {pos: i for i, pos in enumerate(LUMA_SCAN)}

# ue(v) bit sizes for mode numbers 0..3 (i16x16 / chroma mode cost,
# reference x264_mb_analyse_intra's `a->i_lambda * bs_size_ue(...)`)
_UE_SIZE4 = np.array([1, 3, 3, 5], np.int32)


def wave_tables(mbw: int, mbh: int):
    """Static knight-move wave membership (d = mx + 2*my): returns
    (mx, my, active) arrays of shape [n_waves, W]."""
    n_waves = mbw + 2 * (mbh - 1)
    rows = [[] for _ in range(n_waves)]
    for my in range(mbh):
        for mx in range(mbw):
            rows[mx + 2 * my].append((mx, my))
    w = max(len(r) for r in rows)
    mx_t = np.zeros((n_waves, w), np.int32)
    my_t = np.zeros((n_waves, w), np.int32)
    act = np.zeros((n_waves, w), bool)
    for d, r in enumerate(rows):
        for lane, (x, y) in enumerate(r):
            mx_t[d, lane] = x
            my_t[d, lane] = y
            act[d, lane] = True
    return mx_t, my_t, act


def _tile(img: jnp.ndarray, n: int) -> jnp.ndarray:
    """[H, W] -> [H/n, W/n, n, n] macroblock tiles."""
    h, w = img.shape
    return img.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)


def _untile(t: jnp.ndarray) -> jnp.ndarray:
    mh, mw, n, _ = t.shape
    return t.transpose(0, 2, 1, 3).reshape(mh * n, mw * n)


def _i16_mb(enc, top, left, topleft, at, al, qp, lam,
            trellis: bool = False):
    """Batched i16x16 encode for one wave.

    enc: [W,16,16]; top/left: [W,16]; topleft, at, al: [W].
    trellis: RD-quantize DC + AC (x264 --trellis at the final intra
    encode, encoder/macroblock.c:229,252 — mode choice stays SATD).
    Returns (mode, dc_lev [W,4,4], ac_lev [W,4,4,4,4], cbp_luma_flag,
    recon [W,16,16], cost [W])."""
    preds = P.predict_i16x16_all(top, left, topleft, at, al)  # [W,4,16,16]
    d = to_blocks(enc[:, None] - preds, 4)            # [W,4m,4,4,4,4]
    satd = jnp.sum(jnp.abs(hadamard4x4(d)), axis=(-4, -3, -2, -1)) >> 1
    satd = satd + lam * jnp.asarray(_UE_SIZE4)[None, :]
    valid = jnp.stack([at, al, jnp.ones_like(at), at & al], axis=1)
    cost = jnp.where(valid, satd, jnp.int32(1 << 30))
    mode = jnp.argmin(cost, axis=1)                   # [W]
    best_cost = jnp.min(cost, axis=1)
    pred = jnp.take_along_axis(
        preds, mode[:, None, None, None], axis=1)[:, 0]  # [W,16,16]

    res = to_blocks(enc - pred, 4)                    # [W,4,4,4,4]
    coef = T.dct4x4(res)
    dc = coef[:, 0, 0, :, :]                          # [W,4,4]
    dc_t = hadamard4x4(dc[..., None, None], final_shift=True)[..., 0, 0]
    qpb = qp if jnp.ndim(qp) == 0 else qp[:, None, None]  # per-MB AQ
    ac = coef.at[:, 0, 0].set(0)
    if trellis:
        from .inter import trellis_quant_luma_dc, trellis_quant_luma_ac
        dc_lev = trellis_quant_luma_dc(dc_t, qp)      # [W,4,4]
        ac_lev = trellis_quant_luma_ac(ac, qp, intra=True)
    else:
        dc_lev = T.quant_dc(dc_t, qpb, intra=True)    # [W,4,4]
        ac_lev = T.quant4x4(ac, qpb, intra=True)
    cbp_luma = jnp.any(ac_lev != 0, axis=(1, 2, 3, 4))  # [W]

    deq = T.dequant4x4(ac_lev, qpb, intra=True)
    dc_rec = hadamard4x4(dc_lev[..., None, None])[..., 0, 0]
    dc_rec = T.dequant_dc_luma(dc_rec, qpb)           # [W,4,4]
    deq = deq.at[:, 0, 0].set(dc_rec)
    recon = T.idct4x4_add(to_blocks(pred, 4), deq)
    recon = recon.reshape(-1, 4, 4, 4, 4).transpose(0, 3, 1, 4, 2) \
                 .reshape(-1, 16, 16)
    return mode, dc_lev, ac_lev, cbp_luma, recon, best_cost


def _satd4(a, b):
    """a: [W,4,4], b: [W,M,4,4] -> [W,M]."""
    d = (a[:, None] - b)[..., None, None]             # [W,M,4,4,1,1]
    return jnp.sum(jnp.abs(hadamard4x4(d)), axis=(-4, -3, -2, -1)) >> 1


def _i4_mb(enc, top20, left, topleft, at, al, atr, qp, lam,
           nb_left_modes, nb_top_modes, trellis: bool = False):
    """Batched i4x4 encode for one wave: static 16-step z-scan unroll.

    enc: [W,16,16]; top20: [W,20] (above MB row15 + above-right MB's
    first 4, masked by atr); left: [W,16]; topleft: [W];
    nb_left_modes: [W,4] left MB's column-3 block modes (2 = not i4);
    nb_top_modes: [W,4] above MB's row-3 block modes.
    Returns (modes [W,16] z-order, lev [W,4,4,4,4] (by,bx,r,c) full
    16-coeff blocks, cbp_luma [W] 4-bit, recon [W,16,16], cost [W])."""
    W = enc.shape[0]
    ones = jnp.ones(W, bool)
    wt = jnp.zeros((W, 16, 16), jnp.int32)      # working recon tile
    m4 = jnp.full((W, 4, 4), 2, jnp.int32)      # chosen modes (DC init)
    lev_out = jnp.zeros((W, 4, 4, 4, 4), jnp.int32)
    modes_out = []
    cost = jnp.zeros(W, jnp.int32)
    modebits = jnp.zeros(W, jnp.int32)
    needs_t = jnp.asarray(P.I4_NEEDS_TOP)
    needs_l = jnp.asarray(P.I4_NEEDS_LEFT)

    for blk, (by, bx) in enumerate(LUMA_SCAN):
        # ---- borders ----
        if by == 0:
            t8 = top20[:, 4 * bx:4 * bx + 8]
            t_av = at
            if bx == 3:  # top-right from the above-RIGHT MB (atr)
                rep = jnp.repeat(t8[:, 3:4], 4, axis=1)
                t8 = jnp.where(atr[:, None],
                               t8, jnp.concatenate([t8[:, :4], rep], 1))
        else:
            row = wt[:, 4 * by - 1, :]
            t4 = row[:, 4 * bx:4 * bx + 4]
            tr_ok = (bx < 3
                     and _SCAN_IDX[(by - 1, bx + 1)] < _SCAN_IDX[(by, bx)])
            if tr_ok:
                t8 = row[:, 4 * bx:4 * bx + 8]
            else:  # spec sample substitution: replicate t3
                t8 = jnp.concatenate(
                    [t4, jnp.repeat(t4[:, 3:4], 4, axis=1)], 1)
            t_av = ones
        if bx == 0:
            l4 = left[:, 4 * by:4 * by + 4]
            l_av = al
        else:
            l4 = wt[:, 4 * by:4 * by + 4, 4 * bx - 1]
            l_av = ones
        if by == 0 and bx == 0:
            lt = topleft
        elif by == 0:
            lt = top20[:, 4 * bx - 1]
        elif bx == 0:
            lt = left[:, 4 * by - 1]
        else:
            lt = wt[:, 4 * by - 1, 4 * bx - 1]

        preds = P.predict_i4x4_all(t8, l4, lt, t_av, l_av)  # [W,9,4,4]
        eblk = enc[:, 4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
        satd = _satd4(eblk, preds)                          # [W,9]

        # predicted mode (spec 8.3.1.1): min(left, top); DC if EITHER
        # neighbour block is unavailable (dcPredModePredictedFlag)
        mA = nb_left_modes[:, by] if bx == 0 else m4[:, by, bx - 1]
        mB = nb_top_modes[:, bx] if by == 0 else m4[:, by - 1, bx]
        av_a = al if bx == 0 else ones
        av_b = at if by == 0 else ones
        pm = jnp.where(av_a & av_b, jnp.minimum(mA, mB), 2)
        bits = jnp.where(jnp.arange(9)[None, :] == pm[:, None], 1, 4)
        valid = ~((needs_t[None, :] & ~t_av[:, None])
                  | (needs_l[None, :] & ~l_av[:, None]))
        mcost = jnp.where(valid, satd + lam * bits, jnp.int32(1 << 30))
        mode = jnp.argmin(mcost, axis=1)
        cost = cost + jnp.min(mcost, axis=1)
        modebits = modebits + jnp.where(mode == pm, 1, 4)
        pred = jnp.take_along_axis(
            preds, mode[:, None, None, None], axis=1)[:, 0]  # [W,4,4]

        coef = T.dct4x4((eblk - pred)[..., None, None])      # [W,4,4,1,1]
        qpb = qp if jnp.ndim(qp) == 0 else qp[:, None, None]
        if trellis:
            from .inter import trellis_quant4x4_planes
            lev = trellis_quant4x4_planes(coef, qp, intra=True)
        else:
            lev = T.quant4x4(coef, qpb, intra=True)
        deq = T.dequant4x4(lev, qpb, intra=True)
        rec = T.idct4x4_add(pred[..., None, None], deq)[..., 0, 0]
        wt = wt.at[:, 4 * by:4 * by + 4, 4 * bx:4 * bx + 4].set(rec)
        m4 = m4.at[:, by, bx].set(mode)
        lev_out = lev_out.at[:, by, bx].set(lev[..., 0, 0])
        modes_out.append(mode)

    cost = cost + 24 * lam   # i4x4 header overhead (analyse.c:750)
    nz = jnp.any(lev_out != 0, axis=(3, 4))                 # [W,4,4]
    cbp8 = jnp.any(nz.reshape(W, 2, 2, 2, 2), axis=(2, 4))  # [W,2,2]
    cbp_luma = (cbp8[:, 0, 0] * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8).astype(jnp.int32)
    # CBP-zeroed blocks must not be transmitted NOR reconstructed with
    # residual? No: cbp bit 0 <=> all four blocks are zero, so recon is
    # unaffected; lev stays as computed.
    return (jnp.stack(modes_out, axis=1), lev_out, cbp_luma, wt, cost,
            modebits)


def _i8_mb(enc, top24, left, topleft, at, al, atr, qp, lam,
           nb_left_modes, nb_top_modes, trellis: bool = False):
    """Batched Intra_8x8 encode for one wave: static 4-step z-scan over
    the MB's 8x8 blocks (reference: x264_mb_analyse_intra's i8x8 sweep
    analyse.c:659-697 + x264_mb_encode_i8x8 encoder/macroblock.c:156).

    enc: [W,16,16]; top24: [W,24] (above MB row15 + above-right MB's
    first 8, pre-substituted when atr is false); left: [W,16];
    topleft: [W]; nb_left_modes/[W,4] nb_top_modes: neighbour MBs'
    border 4x4-ctx mode cells (i8x8 modes are replicated into the 4x4
    ctx grid exactly as x264 caches them).
    Returns (modes [W,4] z-order, lev [W,2,2,8,8], cbp_luma [W] 4-bit,
    recon [W,16,16], cost [W], ctx4 [W,4,4])."""
    from ..ops import predict8 as P8
    from ..ops import transform8 as T8
    W = enc.shape[0]
    ones = jnp.ones(W, bool)
    wt = jnp.zeros((W, 16, 16), jnp.int32)
    ctx4 = jnp.full((W, 4, 4), 2, jnp.int32)
    lev_out = jnp.zeros((W, 2, 2, 8, 8), jnp.int32)
    modes_out = []
    cost = jnp.zeros(W, jnp.int32)
    modebits = jnp.zeros(W, jnp.int32)
    needs_t = jnp.asarray(P8.I8_NEEDS_TOP)
    needs_l = jnp.asarray(P8.I8_NEEDS_LEFT)

    for b, (by8, bx8) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        y0, x0 = 8 * by8, 8 * bx8
        # ---- raw borders (16 top incl. top-right, 8 left, lt) ----
        if by8 == 0:
            t16 = top24[:, x0:x0 + 16]
            t_av = at
            have_tr = at if bx8 == 0 else atr
        else:
            row = wt[:, 7, :]
            if bx8 == 0:
                t16 = row[:, 0:16]     # block 1's recon fills t8..15
                have_tr = ones
            else:
                t8 = row[:, 8:16]
                t16 = jnp.concatenate(
                    [t8, jnp.repeat(t8[:, 7:8], 8, 1)], axis=1)
                have_tr = jnp.zeros(W, bool)
            t_av = ones
        if bx8 == 0:
            l8 = left[:, y0:y0 + 8]
            l_av = al
        else:
            l8 = wt[:, y0:y0 + 8, 7]
            l_av = ones
        if by8 == 0 and bx8 == 0:
            lt = topleft
            have_lt = at & al
        elif by8 == 0:
            lt = top24[:, 7]
            have_lt = at
        elif bx8 == 0:
            lt = left[:, 7]
            have_lt = al
        else:
            lt = wt[:, 7, 7]
            have_lt = ones
        # !have_tr raw substitution (t8.. = t7) before the filter
        t16 = jnp.where(have_tr[:, None], t16,
                        jnp.concatenate(
                            [t16[:, :8],
                             jnp.repeat(t16[:, 7:8], 8, 1)], axis=1))

        edge = P8.filter_edges(lt, t16, l8, have_lt, have_tr)
        preds = P8.predict_i8x8_all(edge, t_av, l_av)      # [W,9,8,8]
        eblk = enc[:, y0:y0 + 8, x0:x0 + 8]
        d = to_blocks(eblk[:, None] - preds, 4)
        satd = jnp.sum(jnp.abs(hadamard4x4(d)),
                       axis=(-4, -3, -2, -1)) >> 1         # [W,9]

        # predicted mode (spec 8.3.2.1, same rule as i4x4 over the
        # replicated 4x4 ctx cells)
        cy, cx = 2 * by8, 2 * bx8
        mA = nb_left_modes[:, cy] if bx8 == 0 else ctx4[:, cy, cx - 1]
        mB = nb_top_modes[:, cx] if by8 == 0 else ctx4[:, cy - 1, cx]
        av_a = al if bx8 == 0 else ones
        av_b = at if by8 == 0 else ones
        pm = jnp.where(av_a & av_b, jnp.minimum(mA, mB), 2)
        bits = jnp.where(jnp.arange(9)[None, :] == pm[:, None], 1, 4)
        valid = ~((needs_t[None, :] & ~t_av[:, None])
                  | (needs_l[None, :] & ~l_av[:, None]))
        mcost = jnp.where(valid, satd + lam * bits, jnp.int32(1 << 30))
        mode = jnp.argmin(mcost, axis=1)
        cost = cost + jnp.min(mcost, axis=1)
        modebits = modebits + jnp.where(mode == pm, 1, 4)
        pred = jnp.take_along_axis(
            preds, mode[:, None, None, None], axis=1)[:, 0]  # [W,8,8]

        coef = T8.dct8x8(eblk - pred)
        if trellis:
            from ..ops import trellis as TR
            zz8 = jnp.asarray(T8.ZIGZAG_8x8)
            vz = coef[:, zz8[:, 0], zz8[:, 1]]          # [W,64]
            qp8b = qp if jnp.ndim(qp) == 0 else jnp.reshape(qp, (-1,))
            lv = TR.trellis_quant(vz, qp8b, TR.CAT_LUMA_8x8, True)
            izig8 = np.zeros((8, 8), np.int64)
            izig8[T8.ZIGZAG_8x8[:, 0], T8.ZIGZAG_8x8[:, 1]] = \
                np.arange(64)
            lev = lv[:, izig8]
        else:
            lev = T8.quant8x8(coef, qp, intra=True)
        deq = T8.dequant8x8(lev, qp, intra=True)
        rec = T8.idct8x8_add(pred, deq)
        wt = wt.at[:, y0:y0 + 8, x0:x0 + 8].set(rec)
        ctx4 = ctx4.at[:, cy:cy + 2, cx:cx + 2].set(
            mode[:, None, None])
        lev_out = lev_out.at[:, by8, bx8].set(lev)
        modes_out.append(mode)

    nz8 = jnp.any(lev_out != 0, axis=(3, 4))                # [W,2,2]
    cbp_luma = (nz8[:, 0, 0] * 1 + nz8[:, 0, 1] * 2
                + nz8[:, 1, 0] * 4 + nz8[:, 1, 1] * 8).astype(jnp.int32)
    return (jnp.stack(modes_out, axis=1), lev_out, cbp_luma, wt, cost,
            ctx4, modebits)


def _chroma_mb(enc_u, enc_v, tops, lefts, topleft_u, topleft_v, at, al,
               qpc, lam, trellis: bool = False):
    """Batched chroma encode, joint U+V mode decision.

    enc_*: [W,8,8]; tops/lefts: ((top_u, top_v), (left_u, left_v)).
    Returns (mode, dc_lev [W,2,2,2], ac_lev [W,2,4,4,2,2], cbp_flags,
    recon_u, recon_v)."""
    (top_u, top_v), (left_u, left_v) = tops, lefts
    pu = P.predict_chroma_all(top_u, left_u, topleft_u, at, al)
    pv = P.predict_chroma_all(top_v, left_v, topleft_v, at, al)
    du = to_blocks(enc_u[:, None] - pu, 4)
    dv = to_blocks(enc_v[:, None] - pv, 4)
    satd = (jnp.sum(jnp.abs(hadamard4x4(du)), axis=(-4, -3, -2, -1))
            + jnp.sum(jnp.abs(hadamard4x4(dv)), axis=(-4, -3, -2, -1))) >> 1
    satd = satd + lam * jnp.asarray(_UE_SIZE4)[None, :]
    valid = jnp.stack([jnp.ones_like(at), al, at, at & al], axis=1)
    cost = jnp.where(valid, satd, jnp.int32(1 << 30))
    mode = jnp.argmin(cost, axis=1)

    qpcb = qpc if jnp.ndim(qpc) == 0 else qpc[:, None, None]

    def encode_plane(enc, preds):
        pred = jnp.take_along_axis(
            preds, mode[:, None, None, None], axis=1)[:, 0]  # [W,8,8]
        res = to_blocks(enc - pred, 4)                # [W,4,4,2,2]
        coef = T.dct4x4(res)
        dc = coef[:, 0, 0][..., None, None]           # [W,2(by),2(bx),1,1]
        dc_t = hadamard2x2(dc)
        ac = coef.at[:, 0, 0].set(0)
        if trellis:
            from .inter import (trellis_quant_chroma_dc,
                                trellis_quant_chroma_ac)
            dc_lev = trellis_quant_chroma_dc(dc_t[..., 0, 0], qpc,
                                             intra=True)   # [W,2,2]
            ac_lev = trellis_quant_chroma_ac(ac, qpc, intra=True)
        else:
            dc_lev = T.quant_dc(dc_t[..., 0, 0], qpcb,
                                intra=True)                 # [W,2,2]
            ac_lev = T.quant4x4(ac, qpcb, intra=True)
        # recon
        deq = T.dequant4x4(ac_lev, qpcb, intra=True)
        dc_rec = hadamard2x2(dc_lev[..., None, None])[..., 0, 0]  # [W,2,2]
        dc_rec = T.dequant_dc_chroma(dc_rec, qpcb, intra=True)
        deq = deq.at[:, 0, 0].set(dc_rec)
        recon = T.idct4x4_add(to_blocks(pred, 4), deq)
        recon = recon.reshape(-1, 4, 4, 2, 2).transpose(0, 3, 1, 4, 2) \
                     .reshape(-1, 8, 8)
        return dc_lev, ac_lev, recon

    dcu, acu, ru = encode_plane(enc_u, pu)
    dcv, acv, rv = encode_plane(enc_v, pv)
    dc_lev = jnp.stack([dcu, dcv], axis=1)            # [W,2(uv),2,2]
    ac_lev = jnp.stack([acu, acv], axis=1)            # [W,2(uv),4,4,2,2]
    ac_nz = jnp.any(ac_lev != 0, axis=(1, 2, 3, 4, 5))
    dc_nz = jnp.any(dc_lev != 0, axis=(1, 2, 3))
    cbp_chroma = jnp.where(ac_nz, 2, jnp.where(dc_nz, 1, 0))
    return mode, dc_lev, ac_lev, cbp_chroma, ru, rv


@functools.partial(jax.jit, static_argnames=("mbw", "mbh", "i4x4",
                                             "i8x8", "rd", "trellis"))
def encode_i_frame(y, u, v, qp, qpc, mbw: int, mbh: int, lam=0,
                   i4x4: bool = True, i8x8: bool = False,
                   rd: bool = False, trellis: bool = False):
    """Encode one I-frame. y: [16*mbh, 16*mbw] int32; u, v: half size.
    qp/qpc/lam are traced scalars (per-frame rate control re-uses one
    compiled program across QPs).

    Returns dict of per-MB decision/level arrays + recon planes:
    mb_i4 [mbh,mbw] bool, i4_modes [mbh,mbw,16] (z-order; 2-filled for
    i16 MBs), luma_ac holds 15-coeff AC planes for i16 MBs and full
    16-coeff blocks for i4 MBs.
    """
    mx_t, my_t, act_t = wave_tables(mbw, mbh)
    n_waves, W = mx_t.shape
    mx_t, my_t = jnp.asarray(mx_t), jnp.asarray(my_t)
    act_t = jnp.asarray(act_t)

    ty = _tile(y, 16)       # [mbh, mbw, 16, 16]
    tu = _tile(u, 8)
    tv = _tile(v, 8)

    state = dict(
        ry=jnp.zeros((mbh, mbw, 16, 16), jnp.int32),
        ru=jnp.zeros((mbh, mbw, 8, 8), jnp.int32),
        rv=jnp.zeros((mbh, mbw, 8, 8), jnp.int32),
        mode=jnp.zeros((mbh, mbw), jnp.int32),
        cmode=jnp.zeros((mbh, mbw), jnp.int32),
        mb_i4=jnp.zeros((mbh, mbw), bool),
        i4_modes=jnp.full((mbh, mbw, 16), 2, jnp.int32),
        modes4=jnp.full((mbh, mbw, 4, 4), 2, jnp.int32),  # ctx (2=not i4)
        cbp_luma=jnp.zeros((mbh, mbw), jnp.int32),
        cbp_chroma=jnp.zeros((mbh, mbw), jnp.int32),
        luma_dc=jnp.zeros((mbh, mbw, 4, 4), jnp.int32),
        luma_ac=jnp.zeros((mbh, mbw, 4, 4, 4, 4), jnp.int32),
        chroma_dc=jnp.zeros((mbh, mbw, 2, 2, 2), jnp.int32),
        chroma_ac=jnp.zeros((mbh, mbw, 2, 2, 2, 4, 4), jnp.int32),
        mb_i8=jnp.zeros((mbh, mbw), bool),
        i8_modes=jnp.full((mbh, mbw, 4), 2, jnp.int32),
        luma8_lev=jnp.zeros((mbh, mbw, 2, 2, 8, 8),
                            jnp.int32 if i8x8 else jnp.int8),
    )

    def body(d, st):
        mx = jax.lax.dynamic_slice(mx_t, (d, 0), (1, W))[0]
        my = jax.lax.dynamic_slice(my_t, (d, 0), (1, W))[0]
        act = jax.lax.dynamic_slice(act_t, (d, 0), (1, W))[0]
        at = act & (my > 0)
        al = act & (mx > 0)
        atr = at & (mx < mbw - 1)
        mxc = jnp.maximum(mx - 1, 0)
        myc = jnp.maximum(my - 1, 0)
        mxr = jnp.minimum(mx + 1, mbw - 1)

        enc = ty[my, mx]                                  # [W,16,16]
        top = st["ry"][myc, mx, 15, :]
        left = st["ry"][my, mxc, :, 15]
        tl = st["ry"][myc, mxc, 15, 15]
        # per-MB AQ: qp/qpc may be [mbh,mbw] grids
        qpw = qp if jnp.ndim(qp) == 0 else qp[my, mx]
        qpcw = qpc if jnp.ndim(qpc) == 0 else qpc[my, mx]
        mode16, dc_lev, ac_lev, cbpl16, rec16, cost16 = _i16_mb(
            enc, top, left, tl, at, al, qpw, lam, trellis=trellis)

        nb_lm = st["modes4"][my, mxc, :, 3]               # [W,4]
        nb_tm = st["modes4"][myc, mx, 3, :]
        if i4x4:
            tr4 = st["ry"][myc, mxr, 15, 0:4]
            top20 = jnp.concatenate([top, tr4], axis=1)   # [W,20]
            m4, lev4, cbpl4, rec4, cost4, mb4bits = _i4_mb(
                enc, top20, left, tl, at, al, atr, qpw, lam,
                nb_lm, nb_tm, trellis=trellis)
            use4 = cost4 < cost16
        else:
            use4 = jnp.zeros_like(cost16, dtype=bool)
            m4 = jnp.full((W, 16), 2, jnp.int32)
            lev4 = jnp.zeros((W, 4, 4, 4, 4), jnp.int32)
            cbpl4 = jnp.zeros((W,), jnp.int32)
            rec4 = rec16
            cost4 = jnp.full_like(cost16, 1 << 30)
            mb4bits = jnp.zeros(W, jnp.int32)
        if i8x8:
            tr8 = st["ry"][myc, mxr, 15, 0:8]
            top24 = jnp.concatenate([top, tr8], axis=1)   # [W,24]
            m8, lev8, cbpl8, rec8, cost8, ctx8, mb8bits = _i8_mb(
                enc, top24, left, tl, at, al, atr, qpw, lam,
                nb_lm, nb_tm, trellis=trellis)
            use8 = (cost8 < cost16) & (cost8 <= cost4)
            use4 = use4 & ~use8
        else:
            use8 = jnp.zeros_like(cost16, dtype=bool)
            m8 = jnp.full((W, 4), 2, jnp.int32)
            lev8 = jnp.zeros((W, 2, 2, 8, 8), jnp.int32)
            cbpl8 = jnp.zeros((W,), jnp.int32)
            rec8 = rec16
            ctx8 = jnp.full((W, 4, 4), 2, jnp.int32)
            mb8bits = jnp.zeros(W, jnp.int32)

        if rd:
            # true-RD intra ranking (x264_intra_rd, analyse.c:881 /
            # rdo.c:139): SSD + lambda2 * exact CAVLC residual bits
            # replaces the SATD totals for the i16/i4/i8 choice. nC
            # approximated as 0; chroma cbp term omitted (common to
            # all three candidates).
            from ..ops.rdcost import cavlc_block_bits, ue_len
            from .inter import LAMBDA2_TAB, _zigzag_gather
            from ..ops import transform8 as T8
            lam2 = jnp.asarray(LAMBDA2_TAB)[qpw]

            def rdc(ssd, bits):
                return ssd + ((lam2 * bits + 128) >> 8)

            nc0 = jnp.zeros(W * 16, jnp.int32)
            dcz = dc_lev[:, jnp.asarray(T.ZIGZAG_4x4[:, 0]),
                         jnp.asarray(T.ZIGZAG_4x4[:, 1])]
            bits_dc = cavlc_block_bits(dcz, jnp.zeros(W, jnp.int32))
            acz = _zigzag_gather(ac_lev)[:, 1:]          # [W,15,4,4]
            vac = acz.transpose(0, 2, 3, 1).reshape(W * 16, 15)
            bits_ac = cavlc_block_bits(vac, nc0, max_coeff=15) \
                .reshape(W, 16).sum(1)
            b16 = (bits_dc + jnp.where(cbpl16, bits_ac, 0)
                   + ue_len(1 + mode16 + 12 * cbpl16.astype(jnp.int32)))
            ssd16 = jnp.sum((rec16 - enc) ** 2, axis=(1, 2))
            c16r = rdc(ssd16, b16)

            z4 = _zigzag_gather(jnp.moveaxis(lev4, (1, 2), (3, 4)))
            v4 = z4.transpose(0, 2, 3, 1).reshape(W * 16, 16)
            b4 = (cavlc_block_bits(v4, nc0).reshape(W, 16).sum(1)
                  + mb4bits + 1 + 6)
            ssd4 = jnp.sum((rec4 - enc) ** 2, axis=(1, 2))
            c4r = jnp.where(cost4 < (1 << 29), rdc(ssd4, b4),
                            jnp.int32(1 << 30))

            zz8c = jnp.asarray(T8.ZIGZAG_8x8)
            z8 = lev8[..., zz8c[:, 0], zz8c[:, 1]]
            v8 = z8.reshape(W, 2, 2, 16, 4).transpose(0, 1, 2, 4, 3) \
                .reshape(W * 16, 16)
            b8 = (cavlc_block_bits(v8, nc0).reshape(W, 16).sum(1)
                  + mb8bits + 2 + 6)
            ssd8 = jnp.sum((rec8 - enc) ** 2, axis=(1, 2))
            c8r = (rdc(ssd8, b8) if i8x8
                   else jnp.full(W, 1 << 30, jnp.int32))

            use8 = i8x8 & (c8r < c16r) & (c8r <= c4r)
            use4 = i4x4 & (c4r < c16r) & ~use8

        rec = jnp.where(use4[:, None, None], rec4, rec16)
        rec = jnp.where(use8[:, None, None], rec8, rec)
        luma_ac16 = jnp.moveaxis(ac_lev, (1, 2), (3, 4))  # [W,by,bx,r,c]
        luma_ac = jnp.where(use4[:, None, None, None, None],
                            lev4, luma_ac16)
        luma_ac = jnp.where(use8[:, None, None, None, None],
                            0, luma_ac)
        cbp_luma = jnp.where(use4, cbpl4, cbpl16.astype(jnp.int32) * 15)
        cbp_luma = jnp.where(use8, cbpl8, cbp_luma)
        dc_out = jnp.where((use4 | use8)[:, None, None],
                           jnp.zeros_like(dc_lev), dc_lev)
        ctx4 = jnp.where(use4[:, None, None],
                         _z_to_grid(m4), jnp.full((W, 4, 4), 2, jnp.int32))
        ctx4 = jnp.where(use8[:, None, None], ctx8, ctx4)

        cu, cvv = tu[my, mx], tv[my, mx]
        top_u = st["ru"][myc, mx, 7, :]
        top_v = st["rv"][myc, mx, 7, :]
        left_u = st["ru"][my, mxc, :, 7]
        left_v = st["rv"][my, mxc, :, 7]
        tlu = st["ru"][myc, mxc, 7, 7]
        tlv = st["rv"][myc, mxc, 7, 7]
        cmode, cdc, cac, cbpc, ruu, rvv = _chroma_mb(
            cu, cvv, (top_u, top_v), (left_u, left_v), tlu, tlv, at, al,
            qpcw, lam, trellis=trellis)

        # inactive lanes scatter out of bounds -> dropped
        sy = jnp.where(act, my, mbh)
        sx = jnp.where(act, mx, mbw)
        st = dict(st)
        st["ry"] = st["ry"].at[sy, sx].set(rec, mode="drop")
        st["ru"] = st["ru"].at[sy, sx].set(ruu, mode="drop")
        st["rv"] = st["rv"].at[sy, sx].set(rvv, mode="drop")
        st["mode"] = st["mode"].at[sy, sx].set(mode16, mode="drop")
        st["cmode"] = st["cmode"].at[sy, sx].set(cmode, mode="drop")
        st["mb_i4"] = st["mb_i4"].at[sy, sx].set(use4, mode="drop")
        st["i4_modes"] = st["i4_modes"].at[sy, sx].set(m4, mode="drop")
        st["mb_i8"] = st["mb_i8"].at[sy, sx].set(use8, mode="drop")
        st["i8_modes"] = st["i8_modes"].at[sy, sx].set(m8, mode="drop")
        st["luma8_lev"] = st["luma8_lev"].at[sy, sx].set(
            lev8.astype(st["luma8_lev"].dtype), mode="drop")
        st["modes4"] = st["modes4"].at[sy, sx].set(ctx4, mode="drop")
        st["cbp_luma"] = st["cbp_luma"].at[sy, sx].set(cbp_luma,
                                                       mode="drop")
        st["cbp_chroma"] = st["cbp_chroma"].at[sy, sx].set(cbpc, mode="drop")
        st["luma_dc"] = st["luma_dc"].at[sy, sx].set(dc_out, mode="drop")
        st["luma_ac"] = st["luma_ac"].at[sy, sx].set(luma_ac, mode="drop")
        st["chroma_dc"] = st["chroma_dc"].at[sy, sx].set(cdc, mode="drop")
        st["chroma_ac"] = st["chroma_ac"].at[sy, sx].set(
            jnp.moveaxis(cac, (2, 3), (4, 5)), mode="drop")
        return st

    state = jax.lax.fori_loop(0, n_waves, body, state)
    out = dict(state)
    out.pop("modes4")
    out["recon_y"] = _untile(out.pop("ry"))
    out["recon_u"] = _untile(out.pop("ru"))
    out["recon_v"] = _untile(out.pop("rv"))
    return out


def _z_to_grid(m4_z):
    """[W,16] z-order modes -> [W,4,4] (by,bx) grid."""
    g = jnp.zeros((m4_z.shape[0], 4, 4), jnp.int32)
    for blk, (by, bx) in enumerate(LUMA_SCAN):
        g = g.at[:, by, bx].set(m4_z[:, blk])
    return g


@functools.partial(jax.jit, static_argnames=("mbw", "mbh", "i4x4",
                                             "trellis"))
def refine_p_intra(y, u, v, recon_y, recon_u, recon_v, inter_cost,
                   qp, qpc, mbw: int, mbh: int, lam=0,
                   i4x4: bool = True, trellis: bool = False):
    """Intra-vs-inter refinement for P frames (the final intra compare
    of x264_macroblock_analyse's P path, analyse.c:2812-2825 — skipped
    by the reference when embedding, analyse.c:2862-2863).

    Runs the same knight-wavefront as encode_i_frame but over the
    ALREADY-ENCODED inter frame: each wave evaluates i16x16/i4x4/chroma
    candidates against the true neighbour reconstruction (inter recon
    for inter MBs — which is neighbour-independent — and committed
    intra recon for earlier intra MBs), switches a MB to intra iff its
    intra SATD cost beats `inter_cost[my, mx]`, and commits the
    reconstruction accordingly. Exact raster-order semantics, batched.

    Returns dict with intra_kind [mbh,mbw] (0 inter, 1 i16, 2 i4) and
    the intra decision/level arrays (valid where intra_kind > 0) plus
    the merged recon planes.
    """
    mx_t, my_t, act_t = wave_tables(mbw, mbh)
    n_waves, W = mx_t.shape
    mx_t, my_t = jnp.asarray(mx_t), jnp.asarray(my_t)
    act_t = jnp.asarray(act_t)

    ty = _tile(y, 16)
    tu = _tile(u, 8)
    tv = _tile(v, 8)

    state = dict(
        ry=_tile(recon_y.astype(jnp.int32), 16),
        ru=_tile(recon_u.astype(jnp.int32), 8),
        rv=_tile(recon_v.astype(jnp.int32), 8),
        kind=jnp.zeros((mbh, mbw), jnp.int32),
        mode=jnp.zeros((mbh, mbw), jnp.int32),
        cmode=jnp.zeros((mbh, mbw), jnp.int32),
        i4_modes=jnp.full((mbh, mbw, 16), 2, jnp.int32),
        modes4=jnp.full((mbh, mbw, 4, 4), 2, jnp.int32),
        cbp_luma=jnp.zeros((mbh, mbw), jnp.int32),
        cbp_chroma=jnp.zeros((mbh, mbw), jnp.int32),
        luma_dc=jnp.zeros((mbh, mbw, 4, 4), jnp.int32),
        luma_ac=jnp.zeros((mbh, mbw, 4, 4, 4, 4), jnp.int32),
        chroma_dc=jnp.zeros((mbh, mbw, 2, 2, 2), jnp.int32),
        chroma_ac=jnp.zeros((mbh, mbw, 2, 2, 2, 4, 4), jnp.int32),
    )

    def body(d, st):
        mx = jax.lax.dynamic_slice(mx_t, (d, 0), (1, W))[0]
        my = jax.lax.dynamic_slice(my_t, (d, 0), (1, W))[0]
        act = jax.lax.dynamic_slice(act_t, (d, 0), (1, W))[0]
        at = act & (my > 0)
        al = act & (mx > 0)
        atr = at & (mx < mbw - 1)
        mxc = jnp.maximum(mx - 1, 0)
        myc = jnp.maximum(my - 1, 0)
        mxr = jnp.minimum(mx + 1, mbw - 1)

        enc = ty[my, mx]
        inter_rec = st["ry"][my, mx]          # state holds inter recon
        top = st["ry"][myc, mx, 15, :]
        left = st["ry"][my, mxc, :, 15]
        tl = st["ry"][myc, mxc, 15, 15]
        mode16, dc_lev, ac_lev, cbpl16, rec16, cost16 = _i16_mb(
            enc, top, left, tl, at, al, qp, lam, trellis=trellis)
        if i4x4:
            tr4 = st["ry"][myc, mxr, 15, 0:4]
            top20 = jnp.concatenate([top, tr4], axis=1)
            nb_lm = st["modes4"][my, mxc, :, 3]
            nb_tm = st["modes4"][myc, mx, 3, :]
            m4, lev4, cbpl4, rec4, cost4, _mb4b = _i4_mb(
                enc, top20, left, tl, at, al, atr, qp, lam,
                nb_lm, nb_tm, trellis=trellis)
            use4 = cost4 < cost16
            cost_intra = jnp.minimum(cost4, cost16)
        else:
            use4 = jnp.zeros_like(cost16, dtype=bool)
            m4 = jnp.full((W, 16), 2, jnp.int32)
            lev4 = jnp.zeros((W, 4, 4, 4, 4), jnp.int32)
            cbpl4 = jnp.zeros((W,), jnp.int32)
            rec4 = rec16
            cost_intra = cost16

        icost = inter_cost[my, mx]
        use_intra = act & (cost_intra < icost)

        rec_i = jnp.where(use4[:, None, None], rec4, rec16)
        rec = jnp.where(use_intra[:, None, None], rec_i, inter_rec)
        luma_ac16 = jnp.moveaxis(ac_lev, (1, 2), (3, 4))
        luma_ac = jnp.where(use4[:, None, None, None, None],
                            lev4, luma_ac16)
        cbp_luma = jnp.where(use4, cbpl4, cbpl16.astype(jnp.int32) * 15)
        dc_out = jnp.where(use4[:, None, None],
                           jnp.zeros_like(dc_lev), dc_lev)
        ctx4 = jnp.where((use_intra & use4)[:, None, None],
                         _z_to_grid(m4), jnp.full((W, 4, 4), 2,
                                                  jnp.int32))

        cu, cvv = tu[my, mx], tv[my, mx]
        inter_ru = st["ru"][my, mx]
        inter_rv = st["rv"][my, mx]
        top_u = st["ru"][myc, mx, 7, :]
        top_v = st["rv"][myc, mx, 7, :]
        left_u = st["ru"][my, mxc, :, 7]
        left_v = st["rv"][my, mxc, :, 7]
        tlu = st["ru"][myc, mxc, 7, 7]
        tlv = st["rv"][myc, mxc, 7, 7]
        cmode, cdc, cac, cbpc, ruu, rvv = _chroma_mb(
            cu, cvv, (top_u, top_v), (left_u, left_v), tlu, tlv, at, al,
            qpc, lam, trellis=trellis)
        ruu = jnp.where(use_intra[:, None, None], ruu, inter_ru)
        rvv = jnp.where(use_intra[:, None, None], rvv, inter_rv)

        kind = jnp.where(use_intra, jnp.where(use4, 2, 1), 0)
        sy = jnp.where(act, my, mbh)
        sx = jnp.where(act, mx, mbw)
        st = dict(st)
        st["ry"] = st["ry"].at[sy, sx].set(rec, mode="drop")
        st["ru"] = st["ru"].at[sy, sx].set(ruu, mode="drop")
        st["rv"] = st["rv"].at[sy, sx].set(rvv, mode="drop")
        st["kind"] = st["kind"].at[sy, sx].set(kind, mode="drop")
        st["mode"] = st["mode"].at[sy, sx].set(mode16, mode="drop")
        st["cmode"] = st["cmode"].at[sy, sx].set(cmode, mode="drop")
        st["i4_modes"] = st["i4_modes"].at[sy, sx].set(m4, mode="drop")
        st["modes4"] = st["modes4"].at[sy, sx].set(ctx4, mode="drop")
        st["cbp_luma"] = st["cbp_luma"].at[sy, sx].set(cbp_luma,
                                                       mode="drop")
        st["cbp_chroma"] = st["cbp_chroma"].at[sy, sx].set(cbpc,
                                                           mode="drop")
        st["luma_dc"] = st["luma_dc"].at[sy, sx].set(dc_out, mode="drop")
        st["luma_ac"] = st["luma_ac"].at[sy, sx].set(luma_ac,
                                                     mode="drop")
        st["chroma_dc"] = st["chroma_dc"].at[sy, sx].set(cdc, mode="drop")
        st["chroma_ac"] = st["chroma_ac"].at[sy, sx].set(
            jnp.moveaxis(cac, (2, 3), (4, 5)), mode="drop")
        return st

    state = jax.lax.fori_loop(0, n_waves, body, state)
    out = dict(state)
    out.pop("modes4")
    out["intra_kind"] = out.pop("kind")
    out["recon_y"] = _untile(out.pop("ry")).astype(jnp.uint8)
    out["recon_u"] = _untile(out.pop("ru")).astype(jnp.uint8)
    out["recon_v"] = _untile(out.pop("rv")).astype(jnp.uint8)
    return out
