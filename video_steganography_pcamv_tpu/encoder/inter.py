"""P-frame encoder: batched MC/transform + host MVP/skip scan.

Reference: P-path of x264_macroblock_analyse (analyse.c:2613-2810),
x264_macroblock_encode (encoder/macroblock.c:484-700), decimation
(quant.c decimate_score, JVT-B118), pskip rules (common/macroblock.c:
x264_mb_predict_mv_pskip:165).

Device pipeline per frame (no serial MB loop):
  phase D1 (device): exhaustive full-pel ME + subpel refine  -> MV field
  phase D2 (device): MC + residual transform/quant/decimate/recon at the
                     final MVs, all MBs batched
  phase H  (host):   raster scan deriving the spatial-median MVPs, P_SKIP
                     eligibility and mvd stream (cheap integer work over
                     [mbh*mbw]; C++ twin planned)

Because P MBs only depend on the *previous* frame's reconstruction,
nothing in D1/D2 is wavefront-constrained — this is where the batched device path wins.

Divergences from the reference (documented):
- intra modes are never chosen inside P frames (the stego config also
  forces this in the reference, analyse.c:2862-2863);
- x264's "try pskip-mv first and exit early" probe (analyse.c:2620-2643)
  is replaced by an exact post-hoc test: a MB becomes P_SKIP iff its
  chosen MV equals the pskip MV and its (decimated) residual is empty.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import mc
from ..ops import transform as T
from ..ops.blocks import to_blocks

# JVT-B118 decimation table (quant.c x264_mb_decimate_score)
_DS_TAB = np.array([3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                   np.int32)


def _mb_tiles16(y, mbh: int, mbw: int):
    """Frame plane -> per-MB 16x16 tiles [mbh*mbw, 16, 16]."""
    return y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
            .reshape(mbh * mbw, 16, 16)


def _zigzag_gather(levels):
    """[..., 4, 4, ...]-plane levels -> [..., 16, ...] zigzag order.
    levels: [N, 4(r), 4(c), BY, BX] -> [N, 16, BY, BX]."""
    zz = T.ZIGZAG_4x4
    return levels[:, zz[:, 0], zz[:, 1]]


def decimate_score(levels):
    """Vectorized x264_mb_decimate_score over zigzag levels
    [N, 16, BY, BX] -> score [N, BY, BX]."""
    a = jnp.abs(levels)
    anybig = jnp.any(a > 1, axis=1)
    nz = a > 0
    idx = jnp.arange(16)[None, :, None, None]
    marked = jnp.where(nz, idx, -1)
    # previous nonzero position (exclusive) per scan index
    prev = jax.lax.cummax(marked, axis=1)
    prev_excl = jnp.concatenate(
        [jnp.full_like(prev[:, :1], -1), prev[:, :-1]], axis=1)
    run = idx - prev_excl - 1
    contrib = jnp.where(nz, jnp.asarray(_DS_TAB)[jnp.clip(run, 0, 15)], 0)
    score = jnp.sum(contrib, axis=1)
    return jnp.where(anybig, 9, score)


def trellis_quant4x4_planes(coef, qp, intra: bool):
    """Trellis-quantize [N,4,4,BY,BX] coefficient planes (luma 4x4
    cat); returns levels in the same plane layout. qp: scalar or
    per-MB [N] (any trailing singleton dims tolerated)."""
    from ..ops import trellis as TR
    n, _, _, by, bx = coef.shape
    zz = _zigzag_gather(coef)                     # [N,16,BY,BX]
    v = zz.transpose(0, 2, 3, 1).reshape(n * by * bx, 16)
    qp_b = qp if jnp.ndim(qp) == 0 \
        else jnp.repeat(jnp.reshape(qp, (n,)), by * bx)
    lev = TR.trellis_quant(v, qp_b, TR.CAT_LUMA_4x4, intra)
    lev = lev.reshape(n, by, bx, 16).transpose(0, 3, 1, 2)  # [N,16,BY,BX]
    izig = np.zeros((4, 4), np.int64)
    izig[T.ZIGZAG_4x4[:, 0], T.ZIGZAG_4x4[:, 1]] = np.arange(16)
    return lev[:, izig]                           # [N,4,4,BY,BX]


def trellis_quant_chroma_dc(dch, qpc, intra: bool = False):
    """Chroma-DC trellis (2x2 hadamard domain, raster scan; rdo.c
    x264_quant_dc_trellis DCT_CHROMA_DC, b_intra = !b_inter).
    dch: [N,2,2]."""
    from ..ops import trellis as TR
    n = dch.shape[0]
    qpc_b = qpc if jnp.ndim(qpc) == 0 else jnp.reshape(qpc, (n,))
    lev = TR.trellis_quant(dch.reshape(n, 4), qpc_b, TR.CAT_CHROMA_DC,
                           intra)
    return lev.reshape(n, 2, 2)


def trellis_quant_luma_dc(dct, qp):
    """i16x16 luma-DC trellis (4x4 hadamard domain, zigzag scan;
    rdo.c x264_quant_dc_trellis DCT_LUMA_DC, intra only —
    encoder/macroblock.c:252-253). dct: [N,4,4]."""
    from ..ops import trellis as TR
    n = dct.shape[0]
    zz = jnp.asarray(T.ZIGZAG_4x4)
    v = dct[:, zz[:, 0], zz[:, 1]]                # [N,16]
    qp_b = qp if jnp.ndim(qp) == 0 else jnp.reshape(qp, (n,))
    lev = TR.trellis_quant(v, qp_b, TR.CAT_LUMA_DC, True)
    izig = np.zeros((4, 4), np.int64)
    izig[T.ZIGZAG_4x4[:, 0], T.ZIGZAG_4x4[:, 1]] = np.arange(16)
    return lev[:, izig]                           # [N,4,4]


def trellis_quant_luma_ac(ac, qp, intra: bool = True):
    """i16x16 luma-AC trellis (DCT_LUMA_AC cat, 15 coefs;
    encoder/macroblock.c:229 x264_quant_4x4 -> trellis). ac:
    [N,4,4,BY,BX] coefficient planes with DC already zeroed."""
    from ..ops import trellis as TR
    n, _, _, by, bx = ac.shape
    zz = _zigzag_gather(ac)[:, 1:]                # [N,15,BY,BX]
    v = zz.transpose(0, 2, 3, 1).reshape(n * by * bx, 15)
    qp_b = qp if jnp.ndim(qp) == 0 \
        else jnp.repeat(jnp.reshape(qp, (n,)), by * bx)
    lev = TR.trellis_quant(v, qp_b, TR.CAT_LUMA_AC, intra)
    lev = jnp.concatenate(
        [jnp.zeros((n * by * bx, 1), lev.dtype), lev], axis=1)
    lev = lev.reshape(n, by, bx, 16).transpose(0, 3, 1, 2)
    izig = np.zeros((4, 4), np.int64)
    izig[T.ZIGZAG_4x4[:, 0], T.ZIGZAG_4x4[:, 1]] = np.arange(16)
    return lev[:, izig]                           # [N,4,4,BY,BX]


def trellis_quant_chroma_ac(ac, qpc, intra: bool = False):
    """Chroma-AC trellis (DCT_CHROMA_AC cat, 15 coefs). ac:
    [N,4,4,BY,BX] coefficient planes with DC already zeroed."""
    from ..ops import trellis as TR
    n, _, _, by, bx = ac.shape
    zz = _zigzag_gather(ac)[:, 1:]                # [N,15,BY,BX]
    v = zz.transpose(0, 2, 3, 1).reshape(n * by * bx, 15)
    qpc_b = qpc if jnp.ndim(qpc) == 0 \
        else jnp.repeat(jnp.reshape(qpc, (n,)), by * bx)
    lev = TR.trellis_quant(v, qpc_b, TR.CAT_CHROMA_AC, intra)
    lev = jnp.concatenate(
        [jnp.zeros((n * by * bx, 1), lev.dtype), lev], axis=1)
    lev = lev.reshape(n, by, bx, 16).transpose(0, 3, 1, 2)
    izig = np.zeros((4, 4), np.int64)
    izig[T.ZIGZAG_4x4[:, 0], T.ZIGZAG_4x4[:, 1]] = np.arange(16)
    return lev[:, izig]


def luma_p_encode(cur, pred, qp, decimate: bool,
                  trellis: bool = False, nr_offset=None):
    """Shared inter-luma encode: residual -> quant/trellis ->
    (decimate) -> levels + recon. cur/pred: [N,16,16]. Used by both the
    real P encode and the stego alt-MV probe (the reference's probe
    calls the full x264_macroblock_encode, so decimation behaviour must
    match). trellis follows the reference's --trellis 1 placement: the
    final MB encode only (encoder/macroblock.c:90-91). qp: traced
    scalar, or [N] per-MB (adaptive quantization; the trellis DP
    gathers its tables per row)."""
    n = cur.shape[0]
    qp = jnp.asarray(qp)
    if qp.ndim == 1:       # per-MB AQ: broadcast over block coords
        qp = qp[:, None, None]
    res = to_blocks(cur - pred, 4)                        # [N,4,4,4,4]
    coef = T.dct4x4(res)
    nrsum = None
    if nr_offset is not None:
        # x264_denoise_dct (common/quant.c:180): accumulate |coef| and
        # subtract the running offset, AC positions only
        absx = jnp.abs(coef)
        nrsum = jnp.sum(absx, axis=(0, 3, 4))             # [4,4]
        ac_mask = jnp.ones((4, 4), jnp.int32).at[0, 0].set(0)
        newabs = jnp.maximum(
            absx - nr_offset[None, :, :, None, None], 0)
        coef = jnp.where(ac_mask[None, :, :, None, None] == 1,
                         jnp.sign(coef) * newabs, coef)
    if trellis:
        lev = trellis_quant4x4_planes(coef, qp, intra=False)
    else:
        lev = T.quant4x4(coef, qp, intra=False)
    if decimate:
        zz = _zigzag_gather(lev)                          # [N,16,4,4]
        sc = decimate_score(zz)                           # [N,4,4]
        sc8 = sc.reshape(n, 2, 2, 2, 2).sum(axis=(2, 4))  # [N,2,2] per 8x8
        keep8 = sc8 >= 4
        keep_mb = jnp.sum(jnp.where(keep8, sc8, 0), axis=(1, 2)) >= 6
        keep = keep8 & keep_mb[:, None, None]             # [N,2,2]
        keep_blk = jnp.repeat(jnp.repeat(keep, 2, 1), 2, 2)  # [N,4,4]
        lev = lev * keep_blk[:, None, None, :, :]
    deq = T.dequant4x4(lev, qp)
    rec = T.idct4x4_add(to_blocks(pred, 4), deq)
    rec = rec.reshape(n, 4, 4, 4, 4).transpose(0, 3, 1, 4, 2) \
             .reshape(n, 16, 16)
    if nr_offset is not None:
        return lev, rec, nrsum
    return lev, rec


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate", "trellis"))
def encode_p_frame_device(y, u, v, ref_luma, ref_u, ref_v, mv,
                          qp, qpc, mbh: int, mbw: int,
                          decimate: bool = True, force_zero=None,
                          trellis: bool = False, nr_offset=None):
    """Final P encode at given MVs. mv: [mbh, mbw, 2] qpel.
    force_zero: optional [mbh, mbw] bool — MBs whose residual must be
    dropped entirely (forced P_SKIP in the stego second pass: the decoder
    reconstructs them without residual, so the encoder must too).

    Returns per-MB levels (16-coeff luma blocks), cbp decisions, recon.
    """
    n = mbh * mbw
    ys = (jnp.arange(n) // mbw) * 16
    xs = (jnp.arange(n) % mbw) * 16
    mvf = mv.reshape(n, 2)
    fz = (jnp.zeros(n, bool) if force_zero is None
          else force_zero.reshape(n))

    cur = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(n, 16, 16)
    pred = mc.mc_luma(ref_luma, ys, xs, mvf)              # [N,16,16]
    if nr_offset is not None:
        lev, rec, nrsum = luma_p_encode(cur, pred, qp, decimate,
                                        trellis, nr_offset)
    else:
        lev, rec = luma_p_encode(cur, pred, qp, decimate, trellis)
        nrsum = None
    lev = lev * ~fz[:, None, None, None, None]
    rec = jnp.where(fz[:, None, None], pred, rec)
    nz_blk = jnp.any(lev != 0, axis=(1, 2))               # [N,4,4]
    cbp8 = jnp.any(nz_blk.reshape(n, 2, 2, 2, 2), axis=(2, 4))  # [N,2,2]
    cbp_luma = (cbp8[:, 0, 0] * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8)

    # ---- chroma ----
    ysc, xsc = ys // 2, xs // 2
    chroma_out = []
    for plane, refp in ((u, ref_u), (v, ref_v)):
        curc = plane.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                    .reshape(n, 8, 8)
        predc = mc.mc_chroma(refp, ysc, xsc, mvf)
        resc = to_blocks(curc - predc, 4)                 # [N,4,4,2,2]
        coef = T.dct4x4(resc)
        dc = coef[:, 0, 0][..., None, None]               # [N,2,2,1,1]
        dch = T.hadamard2x2(dc)[..., 0, 0]
        ac = coef.at[:, 0, 0].set(0)
        if trellis:
            dc_lev = trellis_quant_chroma_dc(dch, qpc)
            ac_lev = trellis_quant_chroma_ac(ac, qpc)
        else:
            dc_lev = T.quant_dc(dch, qpc, intra=False)
            ac_lev = T.quant4x4(ac, qpc, intra=False)
        if decimate:
            zzc = _zigzag_gather(ac_lev)                  # [N,16,2,2]
            scc = jnp.sum(decimate_score(zzc), axis=(1, 2))  # [N]
            keep_c = scc >= 7
            ac_lev = ac_lev * keep_c[:, None, None, None, None]
        dc_lev = dc_lev * ~fz[:, None, None]
        ac_lev = ac_lev * ~fz[:, None, None, None, None]
        chroma_out.append((dc_lev, ac_lev, predc, curc))

    ac_nz = jnp.stack([jnp.any(c[1] != 0, axis=(1, 2, 3, 4))
                       for c in chroma_out]).any(axis=0)
    dc_nz = jnp.stack([jnp.any(c[0] != 0, axis=(1, 2))
                       for c in chroma_out]).any(axis=0)
    cbp_chroma = jnp.where(ac_nz, 2, jnp.where(dc_nz, 1, 0))

    recs_c = []
    levs_c = []
    for dc_lev, ac_lev, predc, curc in chroma_out:
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

    # transfer-lean dtypes (int16/uint8) AND flat trailing dims: a
    # [..,4,4] trailing tile pads 64x in HBM; [.., 256] pads ~0
    # (host reshapes back for free)
    return {
        "luma_lev": jnp.moveaxis(lev, (1, 2), (3, 4)).reshape(
            mbh, mbw, 256).astype(jnp.int16),            # (by,bx,r,c)
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
        **({"nr_sum": nrsum} if nrsum is not None else {}),
    }


def assemble_pred_luma(ref_luma, mv8, mbh: int, mbw: int):
    """Per-8x8-block MC -> [N,16,16] MB preds. mv8: [2mbh,2mbw,2] qpel."""
    n8 = 4 * mbh * mbw
    ys8 = (jnp.arange(n8) // (2 * mbw)) * 8
    xs8 = (jnp.arange(n8) % (2 * mbw)) * 8
    p8 = mc.mc_luma(ref_luma, ys8, xs8, mv8.reshape(n8, 2), bh=8, bw=8)
    pred = p8.reshape(2 * mbh, 2 * mbw, 8, 8).transpose(0, 2, 1, 3) \
             .reshape(16 * mbh, 16 * mbw)
    n = mbh * mbw
    return pred.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)


# lambda2 = pow(lambda,2) * .9 * 256 (reference encoder/analyse.c
# x264_lambda2_tab; RD cost = ssd + (lambda2 * bits + 128) >> 8,
# rdo.c:139)
LAMBDA2_TAB = np.array([
    14, 18, 22, 28, 36, 45, 57, 72,
    91, 115, 145, 182, 230, 290, 365, 460,
    580, 731, 921, 1161, 1462, 1843, 2322, 2925,
    3686, 4644, 5851, 7372, 9289, 11703, 14745, 18578,
    23407, 29491, 37156, 46814, 58982, 74313, 93628, 117964,
    148626, 187257, 235929, 297252, 374514, 471859, 594505, 749029,
    943718, 1189010, 1498059, 1887436], np.int64)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate",
                                             "trellis", "cbp_only",
                                             "trans8", "rd"))
def encode_p_frame_device8(y, u, v, ref_luma, ref_u, ref_v, mv8,
                           qp, qpc, mbh: int, mbw: int,
                           decimate: bool = True, force_zero=None,
                           trellis: bool = False, nr_offset=None,
                           cbp_only: bool = False,
                           trans8: bool = False, rd: bool = False,
                           t8_allow=None):
    """Partitioned final P encode: mv per 8x8 block ([2mbh,2mbw,2] qpel,
    uniform within each partition unit). Same outputs as
    encode_p_frame_device (the 16x16 path is the mv8-uniform case).

    cbp_only: emit just cbp_luma/cbp_chroma (+nr_sum) — the stego
    pass-1 needs only the skip/cover decisions, so the recon and level
    materialization (dequant/idct chains + the int16 HBM copies) are
    dead code XLA prunes from the fused stage-1 program.

    qp/qpc: traced scalars, or [mbh,mbw] per-MB grids (adaptive
    quantization, x264_adaptive_quant ratecontrol.c:255)."""
    n = mbh * mbw
    qp = jnp.asarray(qp)
    qpc = jnp.asarray(qpc)
    if qp.ndim >= 1:   # per-MB AQ grids
        qp = qp.reshape(n)
        qpc = qpc.reshape(n)[:, None, None]
    fz = (jnp.zeros(n, bool) if force_zero is None
          else force_zero.reshape(n))

    cur = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(n, 16, 16)
    pred = assemble_pred_luma(ref_luma, mv8, mbh, mbw)
    if nr_offset is not None:
        lev, rec, nrsum = luma_p_encode(cur, pred, qp, decimate,
                                        trellis, nr_offset)
    else:
        lev, rec = luma_p_encode(cur, pred, qp, decimate, trellis)
        nrsum = None
    lev = lev * ~fz[:, None, None, None, None]
    rec = jnp.where(fz[:, None, None], pred, rec)
    nz_blk = jnp.any(lev != 0, axis=(1, 2))
    cbp8 = jnp.any(nz_blk.reshape(n, 2, 2, 2, 2), axis=(2, 4))
    cbp_luma = (cbp8[:, 0, 0] * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8)

    if trans8:
        # High profile adaptive transform (x264_mb_analyse_transform,
        # analyse.c:2291-2303: b_transform_8x8 = sa8d < satd on the MC
        # residual) + the 8x8 inter encode (macroblock.c sub16x16_dct8
        # path with decimate_score64, per-8x8 >= 4 / MB >= 6 rules)
        from ..ops import transform8 as T8
        from ..ops.pixel import sa8d_16x16
        from ..ops.transform import hadamard4x4
        d4 = to_blocks(cur - pred, 4)
        satd16 = jnp.sum(jnp.abs(hadamard4x4(d4)),
                         axis=(1, 2, 3, 4)) >> 1
        sa8d16 = sa8d_16x16(cur, pred)
        t8 = (sa8d16 < satd16) & ~fz
        if t8_allow is not None:
            # caller-side eligibility (x264_mb_transform_8x8_allowed,
            # macroblock.h:462: sub-8x8 partitions exclude trans8)
            t8 = t8 & t8_allow.reshape(n)

        blk8 = (cur - pred).reshape(n, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4)
        pred8 = pred.reshape(n, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4)
        coef8 = T8.dct8x8(blk8)
        if trellis:
            # cat-5 trellis (x264 quant_8x8_trellis, rdo.c: the same
            # Viterbi with the 8x8 significance maps + dct8 weights)
            from ..ops import trellis as TR
            from ..ops.transform8 import ZIGZAG_8x8
            zz8 = jnp.asarray(ZIGZAG_8x8)
            vz = coef8.reshape(n * 4, 8, 8)[:, zz8[:, 0], zz8[:, 1]]
            qp8b = qp if jnp.ndim(qp) == 0 \
                else jnp.repeat(jnp.reshape(qp, (n,)), 4)
            lv = TR.trellis_quant(vz, qp8b, TR.CAT_LUMA_8x8, False)
            lev8 = jnp.zeros((n * 4, 8, 8), jnp.int32) \
                .at[:, zz8[:, 0], zz8[:, 1]].set(lv) \
                .reshape(n, 2, 2, 8, 8)
        else:
            lev8 = T8.quant8x8(coef8, qp, intra=False)
        nz8 = jnp.any(lev8 != 0, axis=(3, 4))              # [n,2,2]
        if decimate:
            sc8 = T8.decimate_score64(lev8)                # [n,2,2]
            keep8 = nz8 & (sc8 >= 4)
            tot = jnp.sum(jnp.where(nz8, sc8, 0), axis=(1, 2))
            keep8 = keep8 & (tot >= 6)[:, None, None]
        else:
            keep8 = nz8
        lev8 = lev8 * keep8[:, :, :, None, None]
        deq8 = T8.dequant8x8(lev8, qp, intra=False)
        rec8b = T8.idct8x8_add(pred8, deq8)
        rec8 = rec8b.transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
        cbp8_t = (keep8[:, 0, 0] * 1 + keep8[:, 0, 1] * 2
                  + keep8[:, 1, 0] * 4 + keep8[:, 1, 1] * 8)

        if rd:
            # true RD transform decision (x264_mb_analyse_transform_rd,
            # analyse.c:2309: exact bits via the entropy size estimator
            # + SSD, replacing the sa8d heuristic). nC approximated as
            # 0 (same-table shift applies to both candidates; the real
            # context depends on neighbours' own RD choices).
            from ..ops.rdcost import cavlc_block_bits
            lam2 = jnp.asarray(LAMBDA2_TAB)[qp]
            zz4 = _zigzag_gather(lev)               # [n,16,BY,BX]
            v4 = zz4.transpose(0, 3, 4, 1).reshape(n * 16, 16) \
                if zz4.ndim == 5 else \
                zz4.transpose(0, 2, 3, 1).reshape(n * 16, 16)
            nc0 = jnp.zeros(n * 16, jnp.int32)
            bits4 = cavlc_block_bits(v4, nc0).reshape(n, 16).sum(1)
            zz8c = jnp.asarray(T8.ZIGZAG_8x8)
            z8 = lev8[..., zz8c[:, 0], zz8c[:, 1]]  # [n,2,2,64]
            sub = z8.reshape(n, 2, 2, 16, 4).transpose(0, 1, 2, 4, 3) \
                .reshape(n * 16, 16)
            bits8 = cavlc_block_bits(sub, nc0).reshape(n, 16).sum(1)
            ssd4 = jnp.sum((rec - cur) ** 2, axis=(1, 2))
            ssd8v = jnp.sum((rec8 - cur) ** 2, axis=(1, 2))
            cost4 = ssd4 + ((lam2 * bits4 + 128) >> 8)
            cost8 = ssd8v + ((lam2 * bits8 + 128) >> 8)
            t8 = (cost8 < cost4) & ~fz
            if t8_allow is not None:
                t8 = t8 & t8_allow.reshape(n)

        lev = lev * ~t8[:, None, None, None, None]
        lev8 = lev8 * t8[:, None, None, None, None]
        rec = jnp.where(t8[:, None, None], rec8, rec)
        cbp_luma = jnp.where(t8, cbp8_t, cbp_luma)
        # the cover/skip rule is unaffected (MVs only), but skip also
        # requires an empty residual -> uses the selected cbp
    else:
        t8 = None
        lev8 = None

    # ---- chroma: 4x4 blocks, one per luma 8x8 partition cell ----
    n8 = 4 * mbh * mbw
    ysc = (jnp.arange(n8) // (2 * mbw)) * 4
    xsc = (jnp.arange(n8) % (2 * mbw)) * 4
    mvf8 = mv8.reshape(n8, 2)
    chroma_out = []
    for plane, refp in ((u, ref_u), (v, ref_v)):
        curc = plane.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                    .reshape(n, 8, 8)
        pc4 = mc.mc_chroma(refp, ysc, xsc, mvf8, bh=4, bw=4)
        predc = pc4.reshape(2 * mbh, 2 * mbw, 4, 4).transpose(0, 2, 1, 3) \
                   .reshape(8 * mbh, 8 * mbw)
        predc = predc.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                     .reshape(n, 8, 8)
        resc = to_blocks(curc - predc, 4)
        coef = T.dct4x4(resc)
        dc = coef[:, 0, 0][..., None, None]
        dch = T.hadamard2x2(dc)[..., 0, 0]
        ac = coef.at[:, 0, 0].set(0)
        if trellis:
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
        dc_lev = dc_lev * ~fz[:, None, None]
        ac_lev = ac_lev * ~fz[:, None, None, None, None]
        chroma_out.append((dc_lev, ac_lev, predc, curc))

    ac_nz = jnp.stack([jnp.any(c[1] != 0, axis=(1, 2, 3, 4))
                       for c in chroma_out]).any(axis=0)
    dc_nz = jnp.stack([jnp.any(c[0] != 0, axis=(1, 2))
                       for c in chroma_out]).any(axis=0)
    cbp_chroma = jnp.where(ac_nz, 2, jnp.where(dc_nz, 1, 0))

    if cbp_only:
        return {
            "cbp_luma": cbp_luma.reshape(mbh, mbw).astype(jnp.uint8),
            "cbp_chroma": cbp_chroma.reshape(mbh, mbw).astype(jnp.uint8),
            **({"nr_sum": nrsum} if nrsum is not None else {}),
        }

    recs_c = []
    levs_c = []
    for dc_lev, ac_lev, predc, curc in chroma_out:
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
        **({"trans8": t8.reshape(mbh, mbw),
            "luma8_lev": lev8.reshape(mbh, mbw, 256).astype(jnp.int16)}
           if trans8 else {}),
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
        **({"nr_sum": nrsum} if nrsum is not None else {}),
    }


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate", "trellis"))
def encode_p_frame_device8_mref(y, u, v, refs_luma, refs_u, refs_v,
                                mv8, ref8, qp, qpc, mbh: int, mbw: int,
                                decimate: bool = True, force_zero=None,
                                trellis: bool = False, nr_offset=None):
    """Multi-reference partitioned final P encode. refs_*: stacked DPB
    ([R,4,Hp,Wp] luma, [R,Hp,Wp] chroma); ref8: [2mbh,2mbw] per-8x8
    L0 index. Same outputs as encode_p_frame_device8."""
    n = mbh * mbw
    qp = jnp.asarray(qp)
    qpc = jnp.asarray(qpc)
    if qp.ndim >= 1:   # per-MB AQ grids
        qp = qp.reshape(n)
        qpc = qpc.reshape(n)[:, None, None]
    fz = (jnp.zeros(n, bool) if force_zero is None
          else force_zero.reshape(n))

    n8 = 4 * mbh * mbw
    ys8 = (jnp.arange(n8) // (2 * mbw)) * 8
    xs8 = (jnp.arange(n8) % (2 * mbw)) * 8
    reff = ref8.reshape(n8)
    p8 = mc.mc_luma_multi(refs_luma, reff, ys8, xs8,
                          mv8.reshape(n8, 2), bh=8, bw=8)
    pred = p8.reshape(2 * mbh, 2 * mbw, 8, 8).transpose(0, 2, 1, 3) \
             .reshape(16 * mbh, 16 * mbw)
    pred = pred.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)
    cur = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(n, 16, 16)
    if nr_offset is not None:
        lev, rec, nrsum = luma_p_encode(cur, pred, qp, decimate,
                                        trellis, nr_offset)
    else:
        lev, rec = luma_p_encode(cur, pred, qp, decimate, trellis)
        nrsum = None
    lev = lev * ~fz[:, None, None, None, None]
    rec = jnp.where(fz[:, None, None], pred, rec)
    nz_blk = jnp.any(lev != 0, axis=(1, 2))
    cbp8 = jnp.any(nz_blk.reshape(n, 2, 2, 2, 2), axis=(2, 4))
    cbp_luma = (cbp8[:, 0, 0] * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8)

    ysc = (jnp.arange(n8) // (2 * mbw)) * 4
    xsc = (jnp.arange(n8) % (2 * mbw)) * 4
    mvf8 = mv8.reshape(n8, 2)
    chroma_out = []
    for plane, refp in ((u, refs_u), (v, refs_v)):
        curc = plane.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                    .reshape(n, 8, 8)
        pc4 = mc.mc_chroma_multi(refp, reff, ysc, xsc, mvf8, bh=4, bw=4)
        predc = pc4.reshape(2 * mbh, 2 * mbw, 4, 4).transpose(0, 2, 1, 3) \
                   .reshape(8 * mbh, 8 * mbw)
        predc = predc.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                     .reshape(n, 8, 8)
        resc = to_blocks(curc - predc, 4)
        coef = T.dct4x4(resc)
        dc = coef[:, 0, 0][..., None, None]
        dch = T.hadamard2x2(dc)[..., 0, 0]
        ac = coef.at[:, 0, 0].set(0)
        if trellis:
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
        dc_lev = dc_lev * ~fz[:, None, None]
        ac_lev = ac_lev * ~fz[:, None, None, None, None]
        chroma_out.append((dc_lev, ac_lev, predc, curc))

    ac_nz = jnp.stack([jnp.any(c[1] != 0, axis=(1, 2, 3, 4))
                       for c in chroma_out]).any(axis=0)
    dc_nz = jnp.stack([jnp.any(c[0] != 0, axis=(1, 2))
                       for c in chroma_out]).any(axis=0)
    cbp_chroma = jnp.where(ac_nz, 2, jnp.where(dc_nz, 1, 0))

    recs_c = []
    levs_c = []
    for dc_lev, ac_lev, predc, curc in chroma_out:
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
        **({"nr_sum": nrsum} if nrsum is not None else {}),
    }


def assemble_pred_luma4(ref_luma, mv4, mbh: int, mbw: int):
    """Per-4x4-block MC -> [N,16,16] MB preds. mv4: [4mbh,4mbw,2] qpel
    (sub-8x8 partitions; identical to the 8x8 path when uniform)."""
    n4 = 16 * mbh * mbw
    ys4 = (jnp.arange(n4) // (4 * mbw)) * 4
    xs4 = (jnp.arange(n4) % (4 * mbw)) * 4
    p4 = mc.mc_luma(ref_luma, ys4, xs4, mv4.reshape(n4, 2), bh=4, bw=4)
    pred = p4.reshape(4 * mbh, 4 * mbw, 4, 4).transpose(0, 2, 1, 3) \
             .reshape(16 * mbh, 16 * mbw)
    n = mbh * mbw
    return pred.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)


def _finish_p4(chroma_out, lev, rec, cbp_luma, qpc, nrsum,
               mbh: int, mbw: int):
    """Shared tail of the sub-partitioned P encodes: chroma cbp +
    recon + packed output dict."""
    n = mbh * mbw
    ac_nz = jnp.stack([jnp.any(c[1] != 0, axis=(1, 2, 3, 4))
                       for c in chroma_out]).any(axis=0)
    dc_nz = jnp.stack([jnp.any(c[0] != 0, axis=(1, 2))
                       for c in chroma_out]).any(axis=0)
    cbp_chroma = jnp.where(ac_nz, 2, jnp.where(dc_nz, 1, 0))

    recs_c = []
    levs_c = []
    for dc_lev, ac_lev, predc, curc in chroma_out:
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
        **({"nr_sum": nrsum} if nrsum is not None else {}),
    }


def assemble_pred_luma4_mref(refs_luma, mv4, ref4, mbh: int, mbw: int):
    """Multi-ref twin of assemble_pred_luma4: per-4x4 MC from the
    block's DPB entry (ref4 [4mbh,4mbw])."""
    n4 = 16 * mbh * mbw
    ys4 = (jnp.arange(n4) // (4 * mbw)) * 4
    xs4 = (jnp.arange(n4) % (4 * mbw)) * 4
    p4 = mc.mc_luma_multi(refs_luma, ref4.reshape(n4), ys4, xs4,
                          mv4.reshape(n4, 2), bh=4, bw=4)
    pred = p4.reshape(4 * mbh, 4 * mbw, 4, 4).transpose(0, 2, 1, 3) \
             .reshape(16 * mbh, 16 * mbw)
    n = mbh * mbw
    return pred.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate",
                                             "trellis"))
def encode_p_frame_device4_mref(y, u, v, refs_luma, refs_u, refs_v,
                                mv4, ref4, qp, qpc, mbh: int, mbw: int,
                                decimate: bool = True, force_zero=None,
                                trellis: bool = False, nr_offset=None):
    """Multi-reference sub-partitioned final P encode: per-4x4 luma MC
    and 2x2 chroma MC from each block's DPB entry (ref4 [4mbh,4mbw] is
    the per-8x8 ref repeated). Same outputs as encode_p_frame_device4."""
    n = mbh * mbw
    qp = jnp.asarray(qp)
    qpc = jnp.asarray(qpc)
    if qp.ndim >= 1:   # per-MB AQ grids
        qp = qp.reshape(n)
        qpc = qpc.reshape(n)[:, None, None]
    fz = (jnp.zeros(n, bool) if force_zero is None
          else force_zero.reshape(n))

    cur = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
           .reshape(n, 16, 16)
    pred = assemble_pred_luma4_mref(refs_luma, mv4, ref4, mbh, mbw)
    if nr_offset is not None:
        lev, rec, nrsum = luma_p_encode(cur, pred, qp, decimate,
                                        trellis, nr_offset)
    else:
        lev, rec = luma_p_encode(cur, pred, qp, decimate, trellis)
        nrsum = None
    lev = lev * ~fz[:, None, None, None, None]
    rec = jnp.where(fz[:, None, None], pred, rec)
    nz_blk = jnp.any(lev != 0, axis=(1, 2))
    cbp8 = jnp.any(nz_blk.reshape(n, 2, 2, 2, 2), axis=(2, 4))
    cbp_luma = (cbp8[:, 0, 0] * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8)

    n4 = 16 * mbh * mbw
    ysc = (jnp.arange(n4) // (4 * mbw)) * 2
    xsc = (jnp.arange(n4) % (4 * mbw)) * 2
    mvf4 = mv4.reshape(n4, 2)
    reff4 = ref4.reshape(n4)
    chroma_out = []
    for plane, refp in ((u, refs_u), (v, refs_v)):
        curc = plane.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                    .reshape(n, 8, 8)
        pc2 = mc.mc_chroma_multi(refp, reff4, ysc, xsc, mvf4,
                                 bh=2, bw=2)
        predc = pc2.reshape(4 * mbh, 4 * mbw, 2, 2) \
                   .transpose(0, 2, 1, 3).reshape(8 * mbh, 8 * mbw)
        predc = predc.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                     .reshape(n, 8, 8)
        resc = to_blocks(curc - predc, 4)
        coef = T.dct4x4(resc)
        dc = coef[:, 0, 0][..., None, None]
        dch = T.hadamard2x2(dc)[..., 0, 0]
        ac = coef.at[:, 0, 0].set(0)
        if trellis:
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
        dc_lev = dc_lev * ~fz[:, None, None]
        ac_lev = ac_lev * ~fz[:, None, None, None, None]
        chroma_out.append((dc_lev, ac_lev, predc, curc))
    return _finish_p4(chroma_out, lev, rec, cbp_luma, qpc, nrsum,
                      mbh, mbw)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate", "trellis"))
def encode_p_frame_device4(y, u, v, ref_luma, ref_u, ref_v, mv4,
                           qp, qpc, mbh: int, mbw: int,
                           decimate: bool = True, force_zero=None,
                           trellis: bool = False, nr_offset=None):
    """Sub-partitioned final P encode: mv per 4x4 luma block
    ([4mbh,4mbw,2] qpel, uniform within each partition unit); chroma MC
    at 2x2 granularity (the spec's partition mapping — equal to the
    coarser paths wherever the MV field is uniform). Same outputs as
    encode_p_frame_device8."""
    n = mbh * mbw
    qp = jnp.asarray(qp)
    qpc = jnp.asarray(qpc)
    if qp.ndim >= 1:   # per-MB AQ grids
        qp = qp.reshape(n)
        qpc = qpc.reshape(n)[:, None, None]
    fz = (jnp.zeros(n, bool) if force_zero is None
          else force_zero.reshape(n))

    cur = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(n, 16, 16)
    pred = assemble_pred_luma4(ref_luma, mv4, mbh, mbw)
    if nr_offset is not None:
        lev, rec, nrsum = luma_p_encode(cur, pred, qp, decimate,
                                        trellis, nr_offset)
    else:
        lev, rec = luma_p_encode(cur, pred, qp, decimate, trellis)
        nrsum = None
    lev = lev * ~fz[:, None, None, None, None]
    rec = jnp.where(fz[:, None, None], pred, rec)
    nz_blk = jnp.any(lev != 0, axis=(1, 2))
    cbp8 = jnp.any(nz_blk.reshape(n, 2, 2, 2, 2), axis=(2, 4))
    cbp_luma = (cbp8[:, 0, 0] * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8)

    # ---- chroma: 2x2 blocks, one per luma 4x4 cell ----
    n4 = 16 * mbh * mbw
    ysc = (jnp.arange(n4) // (4 * mbw)) * 2
    xsc = (jnp.arange(n4) % (4 * mbw)) * 2
    mvf4 = mv4.reshape(n4, 2)
    chroma_out = []
    for plane, refp in ((u, ref_u), (v, ref_v)):
        curc = plane.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                    .reshape(n, 8, 8)
        pc2 = mc.mc_chroma(refp, ysc, xsc, mvf4, bh=2, bw=2)
        predc = pc2.reshape(4 * mbh, 4 * mbw, 2, 2).transpose(0, 2, 1, 3) \
                   .reshape(8 * mbh, 8 * mbw)
        predc = predc.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                     .reshape(n, 8, 8)
        resc = to_blocks(curc - predc, 4)
        coef = T.dct4x4(resc)
        dc = coef[:, 0, 0][..., None, None]
        dch = T.hadamard2x2(dc)[..., 0, 0]
        ac = coef.at[:, 0, 0].set(0)
        if trellis:
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
        dc_lev = dc_lev * ~fz[:, None, None]
        ac_lev = ac_lev * ~fz[:, None, None, None, None]
        chroma_out.append((dc_lev, ac_lev, predc, curc))

    return _finish_p4(chroma_out, lev, rec, cbp_luma, qpc, nrsum,
                      mbh, mbw)


# ---------------------------------------------------------------------------
# Host scan: MVP / P_SKIP / mvd derivation (spec 8.4.1.1, 8.4.1.3)
# ---------------------------------------------------------------------------

def median_mvp(mvs: np.ndarray, avail: np.ndarray, my: int, mx: int):
    """MVP for 16x16 L0, single reference (all refIdx 0).

    mvs: [mbh, mbw, 2] final MVs so far (raster order guarantees
    A/B/C/D are final). avail: [mbh, mbw] bool (decoded & inter)."""
    mbh, mbw = avail.shape
    a_ok = mx > 0 and avail[my, mx - 1]
    b_ok = my > 0 and avail[my - 1, mx]
    c_ok = my > 0 and mx + 1 < mbw and avail[my - 1, mx + 1]
    d_ok = my > 0 and mx > 0 and avail[my - 1, mx - 1]
    mva = mvs[my, mx - 1] if a_ok else np.zeros(2, np.int32)
    mvb = mvs[my - 1, mx] if b_ok else np.zeros(2, np.int32)
    if c_ok:
        mvc = mvs[my - 1, mx + 1]
        c_use = True
    elif d_ok:
        mvc = mvs[my - 1, mx - 1]
        c_use = True
    else:
        mvc = np.zeros(2, np.int32)
        c_use = False
    # spec: B and C (incl. D substitution) unavailable & A available -> A
    if not b_ok and not c_use and a_ok:
        return mva.copy()
    # all refs equal (0); with exactly one "available" the median still
    # includes zeros for the others, per the same-ref rule reduced to:
    n_ok = int(a_ok) + int(b_ok) + int(c_use)
    if n_ok == 1:
        # exactly one neighbour with matching ref -> its MV
        return (mva if a_ok else mvb if b_ok else mvc).copy()
    stack = np.stack([mva, mvb, mvc])
    return np.median(stack, axis=0).astype(np.int32)


def pskip_mv(mvs: np.ndarray, avail: np.ndarray, zero_ref0: np.ndarray,
             my: int, mx: int):
    """P_SKIP motion vector (spec 8.4.1.1): zero if A/B missing or a
    zero-MV-ref0 neighbour, else the median MVP.
    zero_ref0[my, mx]: MB is inter ref0 with mv == (0,0)."""
    a_ok = mx > 0 and avail[my, mx - 1]
    b_ok = my > 0 and avail[my - 1, mx]
    if not a_ok or not b_ok:
        return np.zeros(2, np.int32)
    if zero_ref0[my, mx - 1] or zero_ref0[my - 1, mx]:
        return np.zeros(2, np.int32)
    return median_mvp(mvs, avail, my, mx)


def host_scan_p_forced(mv: np.ndarray, skip: np.ndarray):
    """Stego second-pass scan: skip decisions are FORCED to the pass-1
    flags (the reference's pass-2 forcing, analyse.c:2658-2674). Skipped
    MBs take the pskip MV derived in the *new* MV context (their decoded
    value); coded MBs keep their (possibly flipped) MV.

    Returns (final_mv, mvd) — final_mv feeds the device re-encode so the
    encoder reconstruction matches the decoder."""
    mbh, mbw = skip.shape
    final_mv = mv.copy()
    avail = np.zeros((mbh, mbw), bool)
    mvd = np.zeros((mbh, mbw, 2), np.int32)
    for my in range(mbh):
        for mx in range(mbw):
            zero_ref0 = (avail & (final_mv[..., 0] == 0)
                         & (final_mv[..., 1] == 0))
            if skip[my, mx]:
                final_mv[my, mx] = pskip_mv(final_mv, avail, zero_ref0,
                                            my, mx)
            else:
                mvp = median_mvp(final_mv, avail, my, mx)
                mvd[my, mx] = final_mv[my, mx] - mvp
            avail[my, mx] = True
    return final_mv, mvd


def host_scan_p(mv: np.ndarray, cbp_luma: np.ndarray,
                cbp_chroma: np.ndarray):
    """Raster scan producing skip flags + mvd stream.

    mv: [mbh, mbw, 2] chosen qpel MVs (these remain the final MVs).
    Returns (skip [mbh,mbw] bool, mvd [mbh,mbw,2], mvp [mbh,mbw,2])."""
    mbh, mbw = cbp_luma.shape
    avail = np.zeros((mbh, mbw), bool)
    zero_ref0 = np.zeros((mbh, mbw), bool)
    skip = np.zeros((mbh, mbw), bool)
    mvd = np.zeros((mbh, mbw, 2), np.int32)
    mvp_out = np.zeros((mbh, mbw, 2), np.int32)
    for my in range(mbh):
        for mx in range(mbw):
            mvp = median_mvp(mv, avail, my, mx)
            ps = pskip_mv(mv, avail, zero_ref0, my, mx)
            here = mv[my, mx]
            if (cbp_luma[my, mx] == 0 and cbp_chroma[my, mx] == 0
                    and here[0] == ps[0] and here[1] == ps[1]):
                skip[my, mx] = True
            mvd[my, mx] = here - mvp
            mvp_out[my, mx] = mvp
            avail[my, mx] = True
            zero_ref0[my, mx] = (here[0] == 0 and here[1] == 0)
    return skip, mvd, mvp_out


def _rd_coded_cost(y, u, v, luma_lev, chroma_dc, chroma_ac,
                   recon_y, recon_u, recon_v, mvd, part, qp,
                   mbh: int, mbw: int):
    """RD cost of a coded P configuration, per MB [mbh,mbw] int64:
    SSD(recon, source) + lambda2 * (exact CAVLC residual bits + mb_type
    ue + per-unit mvd se bits), nC approximated 0 (see rd_skip_eval).
    Shared by the --rd 2 P_SKIP probe and the qpel RD refine."""
    from ..ops.rdcost import cavlc_block_bits, se_len, ue_len
    from ..ops.transform import ZIGZAG_4x4
    n = mbh * mbw
    lam2 = jnp.asarray(LAMBDA2_TAB)[qp].astype(jnp.int64)
    cur = _mb_tiles16(y, mbh, mbw).astype(jnp.int64)
    rec = _mb_tiles16(recon_y, mbh, mbw).astype(jnp.int64)

    def tiles8(pl):
        return pl.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                 .reshape(n, 8, 8).astype(jnp.int64)

    ssd = (jnp.sum((rec - cur) ** 2, axis=(1, 2))
           + jnp.sum((tiles8(recon_u) - tiles8(u)) ** 2, (1, 2))
           + jnp.sum((tiles8(recon_v) - tiles8(v)) ** 2, (1, 2)))
    zz = jnp.asarray(ZIGZAG_4x4)
    blk = luma_lev.reshape(n * 16, 4, 4).astype(jnp.int32)
    bz = blk[:, zz[:, 0], zz[:, 1]]
    nc0 = jnp.zeros(n * 16, jnp.int32)
    bits = cavlc_block_bits(bz, nc0).reshape(n, 16) \
        .sum(1).astype(jnp.int64)
    cdc = chroma_dc.reshape(n * 2, 4).astype(jnp.int32)
    bits = bits + cavlc_block_bits(
        cdc, jnp.full(n * 2, -1, jnp.int32), max_coeff=4) \
        .reshape(n, 2).sum(1).astype(jnp.int64)
    cac = chroma_ac.reshape(n * 8, 4, 4).astype(jnp.int32)
    caz = cac[:, zz[:, 0], zz[:, 1]][:, 1:]
    bits = bits + cavlc_block_bits(
        caz, jnp.zeros(n * 8, jnp.int32), max_coeff=15) \
        .reshape(n, 8).sum(1).astype(jnp.int64)
    pt = part.reshape(n)
    nu = jnp.asarray(np.array([1, 2, 2, 4], np.int32))[pt]
    um = (jnp.arange(4)[None, :] < nu[:, None])
    md = mvd.reshape(n, 4, 2)
    mvd_bits = jnp.sum(jnp.where(
        um, se_len(md[:, :, 0]) + se_len(md[:, :, 1]), 0), axis=1)
    hdr = ue_len(pt) + mvd_bits
    cost = ssd + ((lam2 * (bits + hdr) + 128) >> 8)
    return cost.reshape(mbh, mbw)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw"))
def rd_coded_cost(y, u, v, luma_lev, chroma_dc, chroma_ac,
                  recon_y, recon_u, recon_v, mvd, part, qp,
                  mbh: int, mbw: int):
    return _rd_coded_cost(y, u, v, luma_lev, chroma_dc, chroma_ac,
                          recon_y, recon_u, recon_v, mvd, part, qp,
                          mbh, mbw)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw"))
def rd_skip_eval(y, u, v, ref_luma, ref_u, ref_v, pskip_mv,
                 luma_lev, chroma_dc, chroma_ac,
                 recon_y, recon_u, recon_v, mvd, part, qp,
                 mbh: int, mbw: int):
    """P_SKIP RD probe (--rd 2; the x264 i_mbrd skip-decision analog,
    rdo.c x264_rd_cost_mb with the P_SKIP candidate): per MB, cost of
    the coded configuration (SSD + lambda2 * exact CAVLC residual bits
    + mvd/mode header bits, nC approximated 0 like the rd-1 transform
    decision) vs encoding as P_SKIP at the committed field's pskip MV
    (SSD + a 1-bit skip-run amortization). The winners are forced and
    re-derived exactly by the forced rescan. Returns
    (cost_coded, cost_skip) [mbh, mbw] int64."""
    n = mbh * mbw
    lam2 = jnp.asarray(LAMBDA2_TAB)[qp].astype(jnp.int64)
    cur = _mb_tiles16(y, mbh, mbw).astype(jnp.int64)

    def tiles8(pl):
        return pl.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                 .reshape(n, 8, 8).astype(jnp.int64)

    cost_coded = _rd_coded_cost(y, u, v, luma_lev, chroma_dc,
                                chroma_ac, recon_y, recon_u, recon_v,
                                mvd, part, qp, mbh, mbw)

    ys = (jnp.arange(n) // mbw) * 16
    xs = (jnp.arange(n) % mbw) * 16
    mvf = pskip_mv.reshape(n, 2)
    sp = mc.mc_luma(ref_luma, ys, xs, mvf, bh=16, bw=16) \
        .astype(jnp.int64)
    ssd_skip = jnp.sum((sp - cur) ** 2, axis=(1, 2))
    for pl, refp in ((u, ref_u), (v, ref_v)):
        pc = mc.mc_chroma(refp, ys // 2, xs // 2, mvf, bh=8, bw=8) \
            .astype(jnp.int64)
        ssd_skip = ssd_skip + jnp.sum((pc - tiles8(pl)) ** 2, (1, 2))
    cost_skip = ssd_skip + ((lam2 * 1 + 128) >> 8)
    return cost_coded, cost_skip.reshape(mbh, mbw)
