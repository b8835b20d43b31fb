"""Incremental P re-encode: only the MBs the stego flips touched.

The reference's pass 2 re-runs x264_macroblock_encode for every MB of
the frame (embed path re-encode after stc_embed; the goto-re-encode in
encoder/analyse.c drives the whole slice again). On the device the final
re-encode was likewise a full-frame batched program (~136 ms at 1080p)
— but at serving payloads (tens of bits/frame) the STC flips change
the motion of only a handful of MBs. Pass 1 now materializes the full
levels/recon (the cbp-only DCE saved little — the DCT/quant dominates),
and pass 2 re-encodes ONLY the changed MB subset (gather -> encode ->
scatter, one dispatch, capacity-padded so each distinct cap compiles
once).

Exactness argument: an MB is re-encoded iff any of its four 8x8 units'
final MV differs from pass 1 or its skip flag changed. Unchanged MBs
keep pass-1 levels/recon; unchanged SKIP MBs had cbp==0 in pass 1 (the
P_SKIP rule requires an empty residual), so their levels are already
zero and recon == pred — identical to the full re-encode's force_zero
semantics. v1 scope mirrors the serving config: single ref, no
trellis/nr/AQ/8x8dct (callers fall back to the full re-encode
otherwise)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import mc
from ..ops import transform as T
from .inter import to_blocks, luma_p_encode


@functools.partial(jax.jit,
                   static_argnames=("mbh", "mbw", "cap", "decimate"))
def reencode_p_incremental(res, y, u, v, ref_luma, ref_u, ref_v, mv8,
                           idx, fz, qp, qpc, mbh: int, mbw: int,
                           cap: int, decimate: bool = True):
    """Re-encode the MB subset `idx` with the final (post-flip) MV
    field and scatter into the pass-1 result dict.

    res: pass-1 output of encode_p_frame_device8 (full, not cbp_only);
    mv8: FINAL per-8x8 qpel MVs [2mbh,2mbw,2]; idx: [cap] flat MB
    indices, padded with values >= mbh*mbw (scatter mode="drop" only
    drops out-of-bounds HIGH — negative indices wrap in JAX); fz:
    [cap] force-zero (final skip) flags. Returns a res dict with the
    subset replaced (recon included)."""
    n = mbh * mbw
    idxc = jnp.minimum(idx, n - 1)
    my = idxc // mbw
    mx = idxc % mbw

    # ---- luma: 4 8x8 units per MB ----
    dy = jnp.array([0, 0, 1, 1])
    dx = jnp.array([0, 1, 0, 1])
    ys8 = (16 * my[:, None] + 8 * dy[None, :]).reshape(-1)
    xs8 = (16 * mx[:, None] + 8 * dx[None, :]).reshape(-1)
    uy = (2 * my[:, None] + dy[None, :]).reshape(-1)
    ux = (2 * mx[:, None] + dx[None, :]).reshape(-1)
    mvu = mv8[uy, ux]                                     # [4cap,2]
    zeros = jnp.zeros(4 * cap, jnp.int32)
    p8 = mc.mc_luma_multi(ref_luma[None], zeros, ys8, xs8, mvu,
                          bh=8, bw=8)
    pred = p8.reshape(cap, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4) \
             .reshape(cap, 16, 16)
    ytiles = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
              .reshape(n, 16, 16)
    cur = ytiles[idxc]
    lev, rec = luma_p_encode(cur, pred, qp, decimate)
    lev = lev * ~fz[:, None, None, None, None]
    rec = jnp.where(fz[:, None, None], pred, rec)
    nz_blk = jnp.any(lev != 0, axis=(1, 2))
    cbp8 = jnp.any(nz_blk.reshape(cap, 2, 2, 2, 2), axis=(2, 4))
    cbp_luma = (cbp8[:, 0, 0] * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8)

    # ---- chroma: one 4x4 per luma unit ----
    ysc = (8 * my[:, None] + 4 * dy[None, :]).reshape(-1)
    xsc = (8 * mx[:, None] + 4 * dx[None, :]).reshape(-1)
    chroma = []
    for plane, refp in ((u, ref_u), (v, ref_v)):
        ctiles = plane.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
                      .reshape(n, 8, 8)
        curc = ctiles[idxc]
        pc4 = mc.mc_chroma_multi(refp[None], zeros, ysc, xsc, mvu,
                                 bh=4, bw=4)
        predc = pc4.reshape(cap, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4) \
                   .reshape(cap, 8, 8)
        resc = to_blocks(curc - predc, 4)
        coef = T.dct4x4(resc)
        dc = coef[:, 0, 0][..., None, None]
        dch = T.hadamard2x2(dc)[..., 0, 0]
        ac = coef.at[:, 0, 0].set(0)
        dc_lev = T.quant_dc(dch, qpc, intra=False)
        ac_lev = T.quant4x4(ac, qpc, intra=False)
        if decimate:
            from .inter import _zigzag_gather, decimate_score
            zzc = _zigzag_gather(ac_lev)
            scc = jnp.sum(decimate_score(zzc), axis=(1, 2))
            keep_c = scc >= 7
            ac_lev = ac_lev * keep_c[:, None, None, None, None]
        dc_lev = dc_lev * ~fz[:, None, None]
        ac_lev = ac_lev * ~fz[:, None, None, None, None]
        deqc = T.dequant4x4(ac_lev, qpc)
        dc_rec = T.dequant_dc_chroma(
            T.hadamard2x2(dc_lev[..., None, None])[..., 0, 0], qpc)
        deqc = deqc.at[:, 0, 0].set(dc_rec)
        rc = T.idct4x4_add(to_blocks(predc, 4), deqc)
        rc = rc.reshape(cap, 4, 4, 2, 2).transpose(0, 3, 1, 4, 2) \
               .reshape(cap, 8, 8)
        chroma.append((dc_lev, ac_lev, rc))

    ac_nz = jnp.stack([jnp.any(c[1] != 0, axis=(1, 2, 3, 4))
                       for c in chroma]).any(axis=0)
    dc_nz = jnp.stack([jnp.any(c[0] != 0, axis=(1, 2))
                       for c in chroma]).any(axis=0)
    cbp_chroma = jnp.where(ac_nz, 2, jnp.where(dc_nz, 1, 0))

    # ---- scatter into the pass-1 dict (idx == -1 rows drop) ----
    out = dict(res)
    out["luma_lev"] = res["luma_lev"].reshape(n, 256).at[idx].set(
        jnp.moveaxis(lev, (1, 2), (3, 4)).reshape(cap, 256)
        .astype(res["luma_lev"].dtype), mode="drop") \
        .reshape(res["luma_lev"].shape)
    out["cbp_luma"] = res["cbp_luma"].reshape(n).at[idx].set(
        cbp_luma.astype(res["cbp_luma"].dtype), mode="drop") \
        .reshape(mbh, mbw)
    out["cbp_chroma"] = res["cbp_chroma"].reshape(n).at[idx].set(
        cbp_chroma.astype(res["cbp_chroma"].dtype), mode="drop") \
        .reshape(mbh, mbw)
    out["chroma_dc"] = res["chroma_dc"].reshape(n, 8).at[idx].set(
        jnp.stack([chroma[0][0], chroma[1][0]], axis=1)
        .reshape(cap, 8).astype(res["chroma_dc"].dtype), mode="drop") \
        .reshape(res["chroma_dc"].shape)
    out["chroma_ac"] = res["chroma_ac"].reshape(n, 128).at[idx].set(
        jnp.stack([jnp.moveaxis(chroma[0][1], (1, 2), (3, 4)),
                   jnp.moveaxis(chroma[1][1], (1, 2), (3, 4))],
                  axis=1).reshape(cap, 128)
        .astype(res["chroma_ac"].dtype), mode="drop") \
        .reshape(res["chroma_ac"].shape)

    ry = res["recon_y"].reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
        .reshape(n, 16, 16).at[idx].set(
            rec.astype(res["recon_y"].dtype), mode="drop")
    out["recon_y"] = ry.reshape(mbh, mbw, 16, 16).transpose(0, 2, 1, 3) \
        .reshape(16 * mbh, 16 * mbw)
    for key, (_, _, rc) in zip(("recon_u", "recon_v"), chroma):
        rp = res[key].reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3) \
            .reshape(n, 8, 8).at[idx].set(
                rc.astype(res[key].dtype), mode="drop")
        out[key] = rp.reshape(mbh, mbw, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(8 * mbh, 8 * mbw)
    return out


def changed_mbs(mv8_pass1, final8, skip_pass1, skip_final, mbh, mbw):
    """Host-side changed-MB set: any unit MV differs or skip flag
    flipped. Returns (flat indices int32 [k], force_zero bool [k])."""
    import numpy as np
    ch8 = (mv8_pass1 != final8).any(-1)
    chmb = ch8.reshape(mbh, 2, mbw, 2).any(axis=(1, 3))
    chmb |= skip_pass1 != skip_final
    idx = np.flatnonzero(chmb).astype(np.int32)
    return idx, skip_final.reshape(-1)[idx].astype(bool)


def pad_subset(idx, fz, n: int):
    """Pad (idx, fz) to the next power-of-two capacity (min 32) with
    out-of-bounds-HIGH indices (n) so scatters drop the padding rows.
    Returns (idx_padded, fz_padded, cap)."""
    import numpy as np
    cap = 32
    while cap < len(idx):
        cap *= 2
    idx_p = np.full(cap, n, np.int32)
    idx_p[:len(idx)] = idx
    fz_p = np.zeros(cap, bool)
    fz_p[:len(fz)] = fz
    return idx_p, fz_p, cap
