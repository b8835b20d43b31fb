"""RD-optimal (trellis) quantization.

Reference: quant_trellis_cabac (encoder/rdo.c:411-648) — a Viterbi DP
over zigzag positions whose 8 states are the CABAC abs-level context
pairs, scoring SSD (transform-domain, weighted back to pixel scale)
plus lambda2 * CABAC entropy of the sig/last/abs-level bins.

Batched redesign: one `lax.scan` over the zigzag positions (reverse order,
exactly the reference's iteration), batched over EVERY 4x4 block of the
frame at once — [M, 8] node tensors instead of the reference's per-block
serial loop; traceback is a second reverse scan over recorded
[n, M, 8] decision tables. Documented divergences (decision-only; the
bitstream stays conformant either way):
 - scores are float32 (reference: int64);
 - sig/last/abs contexts start from the slice-initial CABAC states
   (reference consults the live per-MB states during RDO);
 - entropy table computed from the CABAC state model
   pLPS(s) = 0.5 * alpha^s, alpha = (0.01875/0.5)^(1/63) — identical
   derivation to the reference's x264_cabac_entropy to ~1/256-bit
   rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import transform as _T
from .transform import ZIGZAG_4x4
from ..encoder.cabac_tables import TRANS_IDX_MPS, TRANS_IDX_LPS

CABAC_SIZE_BITS = 8          # bit costs in 1/256 bit units
LAMBDA_BITS = 4

# ctxBlockCat ids matching encoder/cabac.py (cat 5 = 8x8 luma)
(CAT_LUMA_DC, CAT_LUMA_AC, CAT_LUMA_4x4, CAT_CHROMA_DC, CAT_CHROMA_AC,
 CAT_LUMA_8x8) = range(6)
_SIG_OFF = [105, 120, 134, 149, 152, 402]
_LAST_OFF = [166, 181, 195, 210, 213, 417]
_ABS_OFF = [227, 237, 247, 257, 266, 426]

# abs-level node machine (spec 9.3.3.1.1.9; rdo.c coeff_abs_level_*)
_LEVEL1_CTX = np.array([1, 2, 3, 4, 0, 0, 0, 0], np.int32)
_LEVELGT1_CTX = np.array([5, 5, 5, 5, 6, 7, 8, 9], np.int32)
_LEVEL_TRANS = np.array([[1, 2, 3, 3, 4, 5, 6, 7],
                         [4, 4, 4, 4, 5, 6, 7, 7]], np.int32)

_INF = np.float32(3e38) / 4


# ---------------------------------------------------------------------------
# Host-precomputed tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entropy_tables():
    """(ENT [128,2] int32 1/256-bit costs, TRANS [128,2] int32 packed
    next states) over packed state s = 2*pStateIdx + valMPS."""
    alpha = (0.01875 / 0.5) ** (1.0 / 63)
    p_lps = 0.5 * alpha ** np.arange(64)
    c_lps = np.round(-np.log2(p_lps) * 256).astype(np.int64)
    c_mps = np.round(-np.log2(1 - p_lps) * 256).astype(np.int64)
    ent = np.zeros((128, 2), np.int32)
    trans = np.zeros((128, 2), np.int32)
    for ps in range(64):
        for mps in range(2):
            s = 2 * ps + mps
            for b in range(2):
                if b == mps:
                    ent[s, b] = c_mps[ps]
                    trans[s, b] = 2 * int(TRANS_IDX_MPS[ps]) + mps
                else:
                    ent[s, b] = c_lps[ps]
                    nm = mps ^ 1 if ps == 0 else mps
                    trans[s, b] = 2 * int(TRANS_IDX_LPS[ps]) + nm
    return ent, trans


@functools.lru_cache(maxsize=None)
def _unary_tables():
    """cabac_size_unary / cabac_transition_unary twins (rdo.c:318-344):
    cost of the gt1 unary suffix for prefix p (bits 2..p as '1', a
    trailing '0' when p<14) plus the bypass sign bit; packed-state in,
    packed-state out."""
    ent, trans = _entropy_tables()
    cost = np.zeros((15, 128), np.int32)
    nxt = np.zeros((15, 128), np.int32)
    for prefix in range(15):
        for s0 in range(128):
            s = s0
            bits = 0
            for _ in range(1, prefix):
                bits += ent[s, 1]
                s = trans[s, 1]
            if 0 < prefix < 14:
                bits += ent[s, 0]
                s = trans[s, 0]
            bits += 1 << CABAC_SIZE_BITS   # bypass sign
            cost[prefix, s0] = bits
            nxt[prefix, s0] = s
    return cost, nxt


@functools.lru_cache(maxsize=None)
def _ctx_state_tables():
    """Packed slice-initial CABAC states for every qp: dict of
    [52, n] arrays per ctx block we need (P/B model 0 table)."""
    from ..encoder.cabac_tables import init_states
    from ..encoder.cabac import SIG8_CTX, LAST8_CTX
    # POSITION-indexed initial states per cat: sig_c[qp, cat, i] is
    # the packed state of the sig ctx coded at scan position i (cats
    # 0-4: identity map clipped to the ctx count; cat 5: the 8x8
    # significance maps, cabac.c:551-568)
    absl = np.zeros((52, 6, 10), np.int32)
    sig_c = np.zeros((52, 6, 64), np.int32)
    last_c = np.zeros((52, 6, 64), np.int32)
    for qp in range(52):
        st, mps = init_states(qp, False, 0)
        packed = 2 * st + mps
        for cat in range(6):
            n = [16, 15, 16, 4, 15, 64][cat]
            if cat == CAT_LUMA_8x8:
                for i in range(n):
                    m = min(i, 62)
                    sig_c[qp, cat, i] = packed[402 + SIG8_CTX[m]]
                    last_c[qp, cat, i] = packed[417 + LAST8_CTX[m]]
            else:
                nctx = min(n, 15) if cat != CAT_CHROMA_DC else 3
                for i in range(n):
                    m = min(i, nctx - 1)
                    sig_c[qp, cat, i] = packed[_SIG_OFF[cat] + m]
                    last_c[qp, cat, i] = packed[_LAST_OFF[cat] + m]
            absl[qp, cat] = packed[_ABS_OFF[cat]:_ABS_OFF[cat] + 10]
    return sig_c, last_c, absl


@functools.lru_cache(maxsize=None)
def _lambda2_tab():
    """lambda2 per qp (rdo.c:356-384 formulas, recomputed):
    inter .85^2 * 2^(qp/3 + 10 - LAMBDA_BITS); intra .65^2 * ..."""
    qp = np.arange(52)
    inter = np.floor(0.85 * 0.85 * 2.0 ** (qp / 3.0 + 10 - LAMBDA_BITS))
    intra = np.floor(0.65 * 0.65 * 2.0 ** (qp / 3.0 + 10 - LAMBDA_BITS))
    return np.stack([inter, intra]).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _mf_unq_zig(cqm_version: int = 0):
    """Per-list per-qp quant MF and direct-inverse unquant in zigzag
    order: [2,52,16] each (list 0 = intra, 1 = inter — reading the live
    CQM-scaled tables, so trellis rates against the same quantizer the
    encode path uses). unq = round(2^24 / mf) so (lvl*unq + 128) >> 8
    inverts lvl = coef*mf >> 16 (rdo.c:405-410 semantics). Keyed on the
    CQM version so set_cqm invalidates."""
    zz = ZIGZAG_4x4
    mf = np.stack([np.asarray(_T.QUANT4_MF_I), np.asarray(_T.QUANT4_MF_P)]) \
        [:, :, zz[:, 0], zz[:, 1]].astype(np.int64)         # [2,52,16]
    unq = np.round((1 << 24) / np.maximum(mf, 1)).astype(np.int64)
    return mf.astype(np.int32), unq.astype(np.int32)


@functools.lru_cache(maxsize=4)
def _mf_unq_zig8(cqm_version: int = 0):
    """8x8 quant MF + direct-inverse unquant, zigzag8 order, per list:
    [2,52,64] each (unq = 2^24/mf inverts lvl = coef*mf >> 16, the
    rdo.c unquant8_mf semantics with the q/6 shift baked in)."""
    from . import transform8 as _T8
    zz = _T8.ZIGZAG_8x8
    mf = np.asarray(_T8.QUANT8_MF)[:, :, zz[:, 0], zz[:, 1]] \
        .astype(np.int64)                                  # [2,52,64]
    unq = np.round((1 << 24) / np.maximum(mf, 1)).astype(np.int64)
    return mf.astype(np.int32), unq.astype(np.int32)


def _weight2_zig8():
    """dct8 weight2 (common/dct.h:67-83 x264_dct8_weight2_tab: FIX8 of
    the squared inverse DCT8 basis norms, 6 classes on a 4x4-periodic
    grid), zigzag8 order."""
    from .transform8 import ZIGZAG_8x8
    cls4 = np.array([[0, 3, 4, 3], [3, 1, 5, 1],
                     [4, 5, 2, 5], [3, 1, 5, 1]])
    vals = np.array([1.00000, 0.78487, 2.56132,
                     0.88637, 1.60040, 1.41850], np.float64)
    w = np.floor(vals * 256 + 0.5)[cls4[np.arange(8)[:, None] % 4,
                                        np.arange(8)[None, :] % 4]]
    return w[ZIGZAG_8x8[:, 0], ZIGZAG_8x8[:, 1]].astype(np.float32)


def _weight2_zig():
    """dct4 weight2 (common/dct.h:55-64: FIX8 of 3.125/1.25/0.5 by
    frequency parity — the squared inverse DCT basis norms), zigzag."""
    w = np.zeros((4, 4), np.float32)
    for i in range(4):
        for j in range(4):
            k = (i & 1) + (j & 1)
            w[i, j] = [3.125, 1.25, 0.5][k] * 256
    return w[ZIGZAG_4x4[:, 0], ZIGZAG_4x4[:, 1]]


# ---------------------------------------------------------------------------
# The DP
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cat", "intra"))
def trellis_quant(zz, qp, cat: int, intra: bool):
    """Trellis-quantize zigzag-ordered coefficient vectors.

    zz: [M, n] int32 transform coefficients in scan order (n = 16 for
    LUMA_DC/LUMA_4x4, 15 for *_AC, 4 for CHROMA_DC; AC vectors are the
    scan positions 1..15 — the gathered tables account for the offset).
    qp: traced scalar, or [M] per-BLOCK qp (adaptive quantization: the
    lambda2, quantizer, and context-init tables are gathered per row).
    Returns [M, n] int32 signed levels.
    """
    n = {CAT_LUMA_DC: 16, CAT_LUMA_AC: 15, CAT_LUMA_4x4: 16,
         CAT_CHROMA_DC: 4, CAT_CHROMA_AC: 15, CAT_LUMA_8x8: 64}[cat]
    off = 1 if cat in (CAT_LUMA_AC, CAT_CHROMA_AC) else 0
    dc = cat in (CAT_LUMA_DC, CAT_CHROMA_DC)
    m = zz.shape[0]

    ent, trans = _entropy_tables()
    ucost, utrans = _unary_tables()
    sig_t, last_t, abs_t = _ctx_state_tables()
    from . import cqm as _CQM
    mf_t, unq_t = _mf_unq_zig(_CQM.version())
    lam2_t = _lambda2_tab()

    ent = jnp.asarray(ent)
    trans = jnp.asarray(trans)
    ucost = jnp.asarray(ucost)
    utrans = jnp.asarray(utrans)
    # scalar qp broadcasts to one row per block; [M] gathers per row
    qp_b = jnp.broadcast_to(jnp.reshape(jnp.asarray(qp), (-1,)), (m,))
    lam2 = jnp.asarray(lam2_t)[1 if intra else 0, qp_b]   # [M]

    li = 0 if intra else 1
    if cat == CAT_LUMA_8x8:
        mf8_t, unq8_t = _mf_unq_zig8(_CQM.version())
        mf = jnp.asarray(mf8_t)[li, qp_b]                 # [M,64]
        unq = jnp.asarray(unq8_t)[li, qp_b]
        w = jnp.asarray(_weight2_zig8())
    elif dc:
        mf = jnp.broadcast_to(
            (jnp.asarray(mf_t)[li, qp_b, 0] >> 1)[:, None], (m, n))
        unq = jnp.broadcast_to(
            (jnp.asarray(unq_t)[li, qp_b, 0] << 1)[:, None], (m, n))
        w = jnp.full((n,), 256.0, jnp.float32)
    else:
        mf = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(mf_t)[li, qp_b], off, n, axis=1)
        unq = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(unq_t)[li, qp_b], off, n, axis=1)
        w = jnp.asarray(_weight2_zig()[off:off + n])
    sig_st = jnp.asarray(sig_t)[qp_b, cat]    # [M,64] per-POS states
    last_st = jnp.asarray(last_t)[qp_b, cat]
    abs_st0 = jnp.asarray(abs_t)[qp_b, cat]   # [M,10]

    a = jnp.abs(zz)                                       # [M,n]
    sgn = jnp.sign(zz)
    f = 1 << 15
    q = (a * mf.astype(jnp.int64) + f).astype(jnp.int64) >> 16
    q = q.astype(jnp.int32)
    nz = q > 0
    idxs = jnp.arange(n)
    lastnz = jnp.max(jnp.where(nz, idxs[None, :], -1), axis=1)  # [M]

    lvl1_ctx = jnp.asarray(_LEVEL1_CTX)
    gt1_ctx = jnp.asarray(_LEVELGT1_CTX)
    lvl_trans = jnp.asarray(_LEVEL_TRANS)

    def ue_big_bits(v):
        """bs_size_ue_big(v) << 8: bypass bits of ue(v)."""
        nb = 32 - jax.lax.clz((v + 1).astype(jnp.uint32)).astype(
            jnp.int32)
        return ((2 * nb - 1) << CABAC_SIZE_BITS).astype(jnp.int32)

    def step(carry, i):
        scores, states = carry          # [M,8] f32, [M,8,10] i32
        active = (i <= lastnz)          # [M]
        qi = q[:, i]                    # [M]
        ai = a[:, i].astype(jnp.float32)
        # sig/last bin costs at this position (0 at the final
        # position; the tables are position-indexed per cat, gathered
        # per row under per-block qp)
        s_sig = sig_st[:, i]                                # [M]
        s_last = last_st[:, i]
        is_final = i == n - 1
        cost_sig = jnp.where(is_final, 0, ent[s_sig])       # [M,2]
        cost_last = jnp.where(is_final, 0, ent[s_last])     # [M,2]

        # ---- q == 0 path: every node keeps ctx, j>0 pay sig(0) ----
        zero_scores = scores + jnp.where(
            jnp.arange(8)[None, :] > 0,
            (cost_sig[:, 0].astype(jnp.float32) * lam2
             / 16.0)[:, None], 0.0)

        # ---- q > 0 path: candidates {q, q-1} x prev nodes ----
        cands = jnp.stack([qi, jnp.maximum(qi - 1, 0)], axis=1)  # [M,2]
        unq_lvl = ((cands.astype(jnp.int64) * unq[:, i][:, None]
                    + 128) >> 8).astype(jnp.float32)              # [M,2]
        d = ai[:, None] - unq_lvl
        ssd = d * d * w[i]                                        # [M,2]

        prefix = jnp.minimum(cands - 1, 14)                       # [M,2]
        j8 = jnp.arange(8)
        # level-1 flag per prev node on its own state copy
        l1c = lvl1_ctx[j8]                                        # [8]
        l1_state = jnp.take_along_axis(
            states, l1c[None, :, None], axis=2)[..., 0]           # [M,8]
        gt = prefix > 0                                           # [M,2]
        l1_bits = ent[l1_state[:, None, :],
                      gt.astype(jnp.int32)[:, :, None]]           # [M,2,8]
        l1_next = trans[l1_state[:, None, :],
                        gt.astype(jnp.int32)[:, :, None]]
        g1c = gt1_ctx[j8]
        g1_state = jnp.take_along_axis(
            states, g1c[None, :, None], axis=2)[..., 0]           # [M,8]
        pfx = jnp.clip(prefix, 0, 14)
        un_bits = ucost[pfx[:, :, None], g1_state[:, None, :]]    # [M,2,8]
        un_next = utrans[pfx[:, :, None], g1_state[:, None, :]]
        big = jnp.where(cands >= 15, ue_big_bits(cands - 15), 0)  # [M,2]

        lvl_bits = l1_bits + jnp.where(
            gt[:, :, None], un_bits,
            1 << CABAC_SIZE_BITS)            # prefix==0: just the sign
        nonzero = (cands > 0)[:, :, None]                         # [M,2,1]
        bits = jnp.where(
            nonzero,
            cost_sig[:, 1, None, None].astype(jnp.int32)
            + jnp.where(j8[None, None, :] == 0,
                        cost_last[:, 1, None, None],
                        cost_last[:, 0, None, None]).astype(jnp.int32)
            + lvl_bits + big[:, :, None],
            jnp.where(j8[None, None, :] == 0, 0,
                      cost_sig[:, 0, None, None]).astype(jnp.int32))
        # reference quirk: last flag bit value is (node_ctx == 0) —
        # cost_last[j==0 -> 1] already selected above.

        cand_scores = scores[:, None, :] + ssd[:, :, None] \
            + bits.astype(jnp.float32) * lam2[:, None, None] / 16.0
        next_ctx = jnp.where(
            nonzero,
            lvl_trans[(cands > 1).astype(jnp.int32)[:, :, None],
                      j8[None, None, :]],
            j8[None, None, :])                                    # [M,2,8]
        # candidate states: update l1 ctx slot; update gt1 slot if gt
        cand_states = jnp.broadcast_to(states[:, None, :, :],
                                       (m, 2, 8, 10))
        upd_l1 = jnp.where(nonzero, l1_next, l1_state[:, None, :])
        cand_states = _set_slot(cand_states, l1c, upd_l1)
        upd_g1 = jnp.where(gt[:, :, None], un_next,
                           g1_state[:, None, :])
        cand_states = _set_slot(cand_states, g1c, upd_g1)

        flat_scores = cand_scores.reshape(m, 16)
        flat_ctx = next_ctx.reshape(m, 16)
        flat_states = cand_states.reshape(m, 16, 10)
        flat_lev = jnp.broadcast_to(cands[:, :, None],
                                    (m, 2, 8)).reshape(m, 16)
        flat_prev = jnp.broadcast_to(j8[None, None, :],
                                     (m, 2, 8)).reshape(m, 16)

        t8 = jnp.arange(8)
        mask = flat_ctx[:, None, :] == t8[None, :, None]          # [M,8,16]
        masked = jnp.where(mask, flat_scores[:, None, :], _INF)
        new_scores = jnp.min(masked, axis=2)                      # [M,8]
        win = jnp.argmin(masked, axis=2)                          # [M,8]
        new_states = jnp.take_along_axis(
            flat_states, win[:, :, None], axis=1)                 # [M,8,10]
        lev_sel = jnp.take_along_axis(flat_lev, win, axis=1)      # [M,8]
        prev_sel = jnp.take_along_axis(flat_prev, win, axis=1)

        qz = (qi == 0)[:, None]                                   # [M,1]
        new_scores = jnp.where(qz, zero_scores, new_scores)
        new_states = jnp.where(qz[:, :, None], states, new_states)
        lev_sel = jnp.where(qz, 0, lev_sel)
        prev_sel = jnp.where(qz, j8[None, :], prev_sel)

        act = active[:, None]
        out_scores = jnp.where(act, new_scores, scores)
        out_states = jnp.where(act[:, :, None], new_states, states)
        e_lev = jnp.where(act, lev_sel, 0)
        e_prev = jnp.where(act, prev_sel, j8[None, :])
        return (out_scores, out_states), (e_lev.astype(jnp.int32),
                                          e_prev.astype(jnp.int32))

    init_scores = jnp.full((m, 8), _INF, jnp.float32) \
        .at[:, 0].set(0.0)
    init_states_ = jnp.broadcast_to(abs_st0[:, None, :],
                                    (m, 8, 10)).astype(jnp.int32)
    (scores, _), (E_lev, E_prev) = jax.lax.scan(
        step, (init_scores, init_states_),
        jnp.arange(n - 1, -1, -1))
    # E_* are [n, M, 8] for i = n-1..0; flip so F[i] is position i
    F_lev = E_lev[::-1]
    F_prev = E_prev[::-1]
    best = jnp.argmin(scores, axis=1)                             # [M]

    def back(node, fs):
        f_lev, f_prev = fs
        lev = jnp.take_along_axis(f_lev, node[:, None], axis=1)[:, 0]
        nxt = jnp.take_along_axis(f_prev, node[:, None], axis=1)[:, 0]
        return nxt, lev

    _, levs = jax.lax.scan(back, best, (F_lev, F_prev))           # [n,M]
    return (levs.T * sgn).astype(jnp.int32)


def _set_slot(states, slot_per_node, values):
    """states [M,2,8,10]; slot_per_node [8]; values [M,2,8] ->
    states with states[m,c,j,slot[j]] = values[m,c,j]."""
    onehot = (jnp.arange(10)[None, :] ==
              slot_per_node[:, None])                             # [8,10]
    return jnp.where(onehot[None, None, :, :],
                     values[:, :, :, None], states)
