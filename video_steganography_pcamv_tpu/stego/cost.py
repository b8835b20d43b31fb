"""RCA cost assignment: batched alternative-MV search.

Reference: x264_ih_get_mv_cost (/root/reference/encoder/analyse.c:2391-2550)
with MV_SATD_FDEC_IH (:2364-2385) and the candidate tables (:2561-2565).
Per covered MV the reference serially performs up to 13 full MB re-encodes
and 117 SATD probes; here the whole frame is a single device program over
a [N_mb, 13, 9] tensor (SURVEY.md §3.5: the part the rebuild must batch).

Semantics reproduced exactly:
- "distortion" of probing mv q against a candidate's *reconstruction*:
  SATD(recon_at_candidate, MC(ref, q)) + lambda_cost_mv(q - mvp)
  (the recon-vs-reference comparison is the scheme's local-optimality
  measure; reference snapshots fdec into p_fenc_ih, analyse.c:3880).
- candidate is locally optimal iff none of its 8 unit neighbours beats
  its own cost (strict <, ties keep optimality).
- the alternative MV must preserve the original MV's optimality class;
  candidates 0-3 (|d|=1) are preferred — 4-11 (|d|=3) are only
  considered when no |d|=1 candidate preserves the class (the
  reference's early-exit after ii==3, analyse.c:2443).
- fallback ("error position"): cheapest of the original's 4 unit
  neighbours, costed against the *original* reconstruction.
- rho = max(min_cost - orig_cost, 1); x beta1=1.4 if a |d|=3 candidate
  was used; x beta2=4 on fallback (analyse.c:2530-2545; int truncation
  after the float multiply is preserved).

All candidate deltas have odd |dx|+|dy|, so the alternative always flips
LSB(mvx+mvy) — the cover bit.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import mc
from ..ops import transform as T
from ..ops.blocks import to_blocks
from ..ops.transform import hadamard4x4

# candidate tables (analyse.c:2561-2565)
D_MV = np.array([(0, -1), (1, 0), (0, 1), (-1, 0),
                 (-2, 1), (-1, 2), (1, 2), (2, 1),
                 (2, -1), (1, -2), (-1, -2), (-2, -1)], np.int32)
D_NB = np.array([(0, -1), (1, 0), (0, 1), (-1, 0),
                 (-1, -1), (-1, 1), (1, -1), (1, 1), (0, 0)], np.int32)


def cost_mv_table(lam: int, max_abs: int = 512) -> np.ndarray:
    """x264 p_cost_mv (x264_mb_analyse_load_costs, analyse.c:193):
    lambda * (log2(|d|+1)*2 + 0.718 + (|d|!=0)) + .5, indexed by qpel
    distance."""
    d = np.arange(0, 4 * max_abs + 1)
    return (lam * (np.log2(d + 1) * 2 + 0.718 + (d != 0)) + 0.5) \
        .astype(np.int32)


def _satd(a, b):
    d = to_blocks(a - b, 4)
    return jnp.sum(jnp.abs(hadamard4x4(d)), axis=(-4, -3, -2, -1)) >> 1


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate"))
def alt_mv_costs(cur_y, ref_luma, mv, mvp, cost_mv, qp,
                 mbh: int, mbw: int, decimate: bool = True):
    """Batched x264_ih_get_mv_cost over the whole MB grid.

    cur_y: [16mbh, 16mbw]; mv/mvp: [mbh, mbw, 2] qpel; cost_mv: the
    lambda-weighted qpel distance table.
    Returns (rho [mbh,mbw] float32, alt_mv [mbh,mbw,2]).
    """
    n = mbh * mbw
    ys = (jnp.arange(n) // mbw) * 16
    xs = (jnp.arange(n) % mbw) * 16
    cur = cur_y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)
    mvf = mv.reshape(n, 2)
    mvpf = mvp.reshape(n, 2)

    def mvcost(q):  # q: [n, 2] qpel
        dx = jnp.abs(q[:, 0] - mvpf[:, 0])
        dy = jnp.abs(q[:, 1] - mvpf[:, 1])
        return cost_mv[dx] + cost_mv[dy]

    def probe_costs(recon, center):
        """[n,9] costs of the unit neighbourhood of `center` against a
        fixed reconstruction."""
        out = []
        for k in range(9):
            q = center + jnp.asarray(D_NB[k])
            blk = mc.mc_luma(ref_luma, ys, xs, q)
            out.append(_satd(recon, blk) + mvcost(q))
        return jnp.stack(out, axis=1)

    from ..encoder.inter import luma_p_encode

    # original reconstruction + its neighbourhood
    pred0 = mc.mc_luma(ref_luma, ys, xs, mvf)
    _, rec0 = luma_p_encode(cur, pred0, qp, decimate)
    nb0 = probe_costs(rec0, mvf)                  # [n, 9]
    orig_cost = nb0[:, 8]
    orig_opt = jnp.min(nb0, axis=1) >= orig_cost  # self is the min

    # 12 candidates: recon + self-cost + optimality class
    cand_cost = []
    cand_opt = []
    for c in range(12):
        cmv = mvf + jnp.asarray(D_MV[c])
        predc = mc.mc_luma(ref_luma, ys, xs, cmv)
        _, recc = luma_p_encode(cur, predc, qp, decimate)
        nbc = probe_costs(recc, cmv)              # [n, 9]
        cand_cost.append(nbc[:, 8])
        cand_opt.append(jnp.min(nbc, axis=1) >= nbc[:, 8])
    cand_cost = jnp.stack(cand_cost, axis=1)      # [n, 12]
    cand_opt = jnp.stack(cand_opt, axis=1)        # [n, 12]

    cost_opt, sel_delta, flags = rca_decide(nb0, orig_cost, orig_opt,
                                            cand_cost, cand_opt)
    alt = (mvf + sel_delta).reshape(mbh, mbw, 2)
    return (cost_opt.reshape(mbh, mbw), alt,
            flags.reshape(mbh, mbw, 3))


def rca_decide(nb0, orig_cost, orig_opt, cand_cost, cand_opt):
    """Shared RCA selection logic (analyse.c:2412-2549): class-preserving
    candidate choice with the first-4 early exit, error-position
    fallback, beta1/beta2 penalties. Returns (rho f32 [n],
    sel_delta [n,2], flags [n,3])."""
    valid = cand_opt == orig_opt[:, None]
    big = jnp.int32(1 << 29)
    masked = jnp.where(valid, cand_cost, big)
    # early-exit semantics: if any of the first 4 is valid, candidates
    # 4..11 are never considered
    any4 = jnp.any(valid[:, :4], axis=1)
    masked = jnp.where(any4[:, None] & (jnp.arange(12) >= 4)[None, :],
                       big, masked)
    best_idx = jnp.argmin(masked, axis=1)         # first min wins ties
    best_cost = jnp.take_along_axis(masked, best_idx[:, None], 1)[:, 0]
    found = best_cost < big

    # fallback: cheapest of the original's first 4 neighbours
    fb_idx = jnp.argmin(nb0[:, :4], axis=1)
    fb_cost = jnp.take_along_axis(nb0, fb_idx[:, None], 1)[:, 0]

    sel_delta = jnp.where(found[:, None],
                          jnp.asarray(D_MV)[best_idx],
                          jnp.asarray(D_NB)[fb_idx])
    sel_cost = jnp.where(found, best_cost, fb_cost)
    b_2_neighbor = found & (best_idx >= 4)
    b_error = ~found

    cost_opt = jnp.maximum(sel_cost - orig_cost, 1)
    cost_opt = jnp.where(b_2_neighbor,
                         (1.4 * cost_opt.astype(jnp.float32))
                         .astype(jnp.int32), cost_opt)
    cost_opt = jnp.where(b_error,
                         (4.0 * cost_opt.astype(jnp.float32))
                         .astype(jnp.int32), cost_opt)
    flags = jnp.stack([orig_opt, b_2_neighbor, b_error], 1)
    return cost_opt.astype(jnp.float32), sel_delta, flags
