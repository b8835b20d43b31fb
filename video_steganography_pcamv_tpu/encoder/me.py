"""Batched motion estimation over the whole MB grid.

Reference: /root/reference/encoder/me.c (x264_me_search_ref:158, DIA:248,
HEX:262, UMH:342, ESA:483; refine_subpel:715). Batched redesign (SURVEY.md §7):
instead of per-MB early-exit searches, every candidate displacement is
evaluated for every macroblock simultaneously:

- Full-pel: a lax.scan over the (2R+1)^2 window; each step is one
  whole-frame |cur - shifted(ref)| + per-MB reduction (VPU-bound, no
  gathers). Equivalent coverage to ESA (me.c:483) — the per-MB exhaustive
  search x264 only affords at high effort comes free with batching.
- Sub-pel: two batched refinement rounds (half then quarter, the
  structure of refine_subpel me.c:715) evaluating the 8 neighbours of
  the running best with SATD via the qpel gather path.

MV cost = lambda * golomb_bits(mvd) measured against a per-MB predictor
(the median MVP is only known after the host scan; the search uses the
previous frame's MV field as predictor — temporal predictor seeding, a
deliberate divergence from x264's spatial-median-in-loop, documented).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import mc
from ..ops.blocks import to_blocks
from ..ops.transform import hadamard4x4


def lambda_tab(qp: int) -> int:
    """SAD lambda (x264 lambda table semantics: 0.85 * 2^((qp-12)/6),
    min 1)."""
    return max(1, int(round(0.85 * 2.0 ** ((qp - 12) / 6.0))))


def mv_bits_table(max_abs: int) -> np.ndarray:
    """bits(se(v)) for v in [-max_abs, max_abs] (index v + max_abs)."""
    out = np.zeros(2 * max_abs + 1, np.int32)
    for v in range(-max_abs, max_abs + 1):
        ue = -2 * v if v <= 0 else 2 * v - 1
        out[v + max_abs] = 2 * int(np.floor(np.log2(ue + 1))) + 1
    return out


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw"))
def fullpel_search(cur_y: jnp.ndarray, ref_fp: jnp.ndarray,
                   pred_mv_fp: jnp.ndarray, rng: int, mbh: int, mbw: int,
                   lam=1):
    """Exhaustive full-pel 16x16 search.

    cur_y: [16*mbh, 16*mbw]; ref_fp: padded full-pel plane ([Hp, Wp]);
    pred_mv_fp: [mbh, mbw, 2] full-pel predictor for the mv-cost term.
    Returns best mv (full-pel) [mbh, mbw, 2] and its SAD cost.
    """
    n_c = (2 * rng + 1) ** 2
    dys, dxs = np.meshgrid(np.arange(-rng, rng + 1),
                           np.arange(-rng, rng + 1), indexing="ij")
    dys = jnp.asarray(dys.ravel())
    dxs = jnp.asarray(dxs.ravel())
    h, w = 16 * mbh, 16 * mbw

    bits_t = jnp.asarray(mv_bits_table(4 * (rng + 64)))
    off = 4 * (rng + 64)

    def step(carry, i):
        best_cost, best_mv = carry
        dy, dx = dys[i], dxs[i]
        win = jax.lax.dynamic_slice(
            ref_fp, (mc.PAD + dy, mc.PAD + dx), (h, w))
        sad = jnp.sum(
            to_blocks(jnp.abs(cur_y - win), 16), axis=(-4, -3))  # [mbh,mbw]
        mvc = (bits_t[4 * dx - 4 * pred_mv_fp[..., 0] + off]
               + bits_t[4 * dy - 4 * pred_mv_fp[..., 1] + off]) * lam
        cost = sad + mvc
        better = cost < best_cost
        best_cost = jnp.where(better, cost, best_cost)
        mv_i = jnp.stack([jnp.broadcast_to(dx, (mbh, mbw)),
                          jnp.broadcast_to(dy, (mbh, mbw))], axis=-1)
        best_mv = jnp.where(better[..., None], mv_i, best_mv)
        return (best_cost, best_mv), None

    init = (jnp.full((mbh, mbw), 1 << 30, jnp.int32),
            jnp.zeros((mbh, mbw, 2), jnp.int32))
    (cost, mv), _ = jax.lax.scan(step, init, jnp.arange(n_c))
    return mv, cost


def _satd16(a, b):
    d = to_blocks(a - b, 4)
    return jnp.sum(jnp.abs(hadamard4x4(d)), axis=(-4, -3, -2, -1)) >> 1


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "steps"))
def subpel_refine(cur_y: jnp.ndarray, planes: jnp.ndarray,
                  mv_fp: jnp.ndarray, pred_mv: jnp.ndarray,
                  mbh: int, mbw: int, lam=1, steps: int = 2):
    """Half- then quarter-pel refinement with SATD (refine_subpel
    me.c:715). mv_fp: [mbh,mbw,2] full-pel; pred_mv: qpel predictor.
    Returns qpel mv [mbh,mbw,2] + final SATD cost [mbh,mbw]."""
    n = mbh * mbw
    ys = (jnp.arange(n) // mbw) * 16
    xs = (jnp.arange(n) % mbw) * 16
    cur_blocks = cur_y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
                      .reshape(n, 16, 16)
    pred_flat = pred_mv.reshape(n, 2)
    bits_t = jnp.asarray(mv_bits_table(4 * 512))
    off = 4 * 512

    mv = (mv_fp.reshape(n, 2) * 4).astype(jnp.int32)

    def eval_cost(mv_q):
        blk = mc.mc_luma(planes, ys, xs, mv_q)
        satd = _satd16(cur_blocks, blk)
        mvc = (bits_t[jnp.clip(mv_q[:, 0] - pred_flat[:, 0], -off, off) + off]
               + bits_t[jnp.clip(mv_q[:, 1] - pred_flat[:, 1], -off, off)
                        + off]) * lam
        return satd + mvc

    cost = eval_cost(mv)
    rounds = ([2] if steps >= 1 else []) + ([1] if steps >= 2 else [])
    for d in rounds:
        for ddx, ddy in ((-d, 0), (d, 0), (0, -d), (0, d),
                         (-d, -d), (d, -d), (-d, d), (d, d)):
            cand = mv + jnp.asarray([ddx, ddy])
            c = eval_cost(cand)
            better = c < cost
            cost = jnp.where(better, c, cost)
            mv = jnp.where(better[:, None], cand, mv)
    return mv.reshape(mbh, mbw, 2), cost.reshape(mbh, mbw)
