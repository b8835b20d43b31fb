"""P-frame partition analysis at 8x8 granularity (16x16 / 16x8 / 8x16 /
8x8), one fused device program.

Reference: the P-mode cascade of x264_macroblock_analyse
(analyse.c:2613-2810: p16x16 -> p8x8 -> p16x8/p8x16 threshold checks)
and the per-partition ME helpers (x264_mb_analyse_inter_p16x8:1428,
p8x16:1482, p8x8:1371). Batched redesign: instead of per-MB cascades with
early exits, ONE exhaustive full-pel scan produces per-8x8-block SAD
planes for every displacement; every partition unit's cost for every
displacement is a cheap partial sum of those planes, so all four
partition shapes get their exhaustive-search best MV from the same
pass. The partition decision is then a 4-way argmin with x264's
mb_type/sub_mb_type header-bit lambda terms.

Subpel + stego reuse the qpel-table trick (encoder/qpel_table.py) at
8x8 granularity: one window per 8x8 block around its unit's full-pel
MV, 169 static slice-averages, WHT-linear SATD. Member blocks of a
unit share their offset argmin (their windows share the anchor, so
offset k means the same displacement for both).

Block index convention: per MB, 8x8 blocks b ∈ {0: TL, 1: TR, 2: BL,
3: BR} (z-order, matching the reference's sub-block order).
Units per partition:
  D_16x16(0): unit0 = {0,1,2,3}
  D_16x8 (1): unit0 = {0,1}, unit1 = {2,3}     (top, bottom)
  D_8x16 (2): unit0 = {0,2}, unit1 = {1,3}     (left, right)
  D_8x8  (3): unit b = {b}
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import fullpel as FP
from ..ops import mc
from ..ops import transform as T
from ..ops.blocks import to_blocks
from .me import mv_bits_table
from . import qpel_table as QT

D_16x16, D_16x8, D_8x16, D_8x8 = 0, 1, 2, 3

# mb_type/sub_mb_type header cost in bits (ue sizes): P_L0_16x16 ue(0)=1;
# 16x8/8x16 ue=3; P_8x8 ue(3)=5 + 4x sub_mb_type ue(0)=1
_HDR_BITS = np.array([1, 3, 3, 9], np.int32)

# unit -> member blocks (z-order), per partition type
UNIT_BLOCKS = {
    D_16x16: [(0, 1, 2, 3)],
    D_16x8: [(0, 1), (2, 3)],
    D_8x16: [(0, 2), (1, 3)],
    D_8x8: [(0,), (1,), (2,), (3,)],
}
# number of units per partition type
N_UNITS = np.array([1, 2, 2, 4], np.int32)
# block -> its unit index, per partition type
BLOCK_UNIT = np.array([
    [0, 0, 0, 0],
    [0, 0, 1, 1],
    [0, 1, 0, 1],
    [0, 1, 2, 3]], np.int32)


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw"))
def fullpel_search_parts(cur_y, ref_fp, pred_mv_fp, rng: int,
                         mbh: int, mbw: int, lam=1):
    """Exhaustive full-pel scan producing the best MV per partition
    unit for all four shapes at once.

    cur_y: [16mbh, 16mbw]; ref_fp: padded plane; pred_mv_fp:
    [mbh, mbw, 2] full-pel predictor (temporal).
    Returns dict: mv16 [mbh,mbw,2], c16 [mbh,mbw];
    mv16x8/c16x8 [mbh,mbw,2(unit),..]; mv8x16/c8x16; mv8 [mbh,mbw,4,2],
    c8 [mbh,mbw,4] (all full-pel MVs, costs = SAD + lam*bits(se(4d)))."""
    h, w = 16 * mbh, 16 * mbw
    n_c = (2 * rng + 1) ** 2
    dys, dxs = np.meshgrid(np.arange(-rng, rng + 1),
                           np.arange(-rng, rng + 1), indexing="ij")
    dys = jnp.asarray(dys.ravel())
    dxs = jnp.asarray(dxs.ravel())
    bits_t = jnp.asarray(mv_bits_table(4 * (rng + 64)))
    off = 4 * (rng + 64)
    pmx = pred_mv_fp[..., 0]
    pmy = pred_mv_fp[..., 1]

    def unit_shapes():
        return dict(
            c16=jnp.full((mbh, mbw), 1 << 30, jnp.int32),
            mv16=jnp.zeros((mbh, mbw, 2), jnp.int32),
            c16x8=jnp.full((mbh, mbw, 2), 1 << 30, jnp.int32),
            mv16x8=jnp.zeros((mbh, mbw, 2, 2), jnp.int32),
            c8x16=jnp.full((mbh, mbw, 2), 1 << 30, jnp.int32),
            mv8x16=jnp.zeros((mbh, mbw, 2, 2), jnp.int32),
            c8=jnp.full((mbh, mbw, 4), 1 << 30, jnp.int32),
            mv8=jnp.zeros((mbh, mbw, 4, 2), jnp.int32),
        )

    def step(carry, i):
        st = carry
        dy, dx = dys[i], dxs[i]
        win = jax.lax.dynamic_slice(
            ref_fp, (mc.PAD + dy, mc.PAD + dx), (h, w))
        sad8 = jnp.sum(to_blocks(jnp.abs(cur_y - win), 8),
                       axis=(-4, -3))                     # [2mbh, 2mbw]
        q = sad8.reshape(mbh, 2, mbw, 2).transpose(0, 2, 1, 3)  # [mbh,mbw,2,2]
        # mv cost per MB (one predictor for all units of the MB)
        mvc = (bits_t[4 * dx - 4 * pmx + off]
               + bits_t[4 * dy - 4 * pmy + off]) * lam    # [mbh,mbw]
        mv_i = jnp.stack([jnp.broadcast_to(dx, (mbh, mbw)),
                          jnp.broadcast_to(dy, (mbh, mbw))], axis=-1)

        def upd(cost_key, mv_key, cost):
            c = st[cost_key]
            better = cost < c
            st[cost_key] = jnp.where(better, cost, c)
            bmv = jnp.broadcast_to(
                mv_i.reshape((mbh, mbw) + (1,) * (c.ndim - 2) + (2,)),
                st[mv_key].shape)
            st[mv_key] = jnp.where(better[..., None], bmv, st[mv_key])

        upd("c16", "mv16", q.sum(axis=(2, 3)) + mvc)
        upd("c16x8", "mv16x8", q.sum(axis=3) + mvc[..., None])
        upd("c8x16", "mv8x16", q.sum(axis=2) + mvc[..., None])
        upd("c8", "mv8", q.reshape(mbh, mbw, 4) + mvc[..., None])
        return st, None

    st, _ = jax.lax.scan(step, unit_shapes(), jnp.arange(n_c))
    return st


@functools.partial(jax.jit, static_argnames=("mbh", "mbw",
                                             "allow_parts"))
def decide_partition(st, mbh: int, mbw: int, lam=1,
                     allow_parts: bool = True):
    """4-way partition decision from the full-pel unit costs + header
    lambda terms (the SAD-level analog of analyse.c's cascade compare).
    Returns (part [mbh,mbw] in {0..3}, mvfp8 [2mbh,2mbw,2])."""
    hdr = jnp.asarray(_HDR_BITS)
    tot = jnp.stack([
        st["c16"] + lam * hdr[0],
        st["c16x8"].sum(-1) + lam * hdr[1],
        st["c8x16"].sum(-1) + lam * hdr[2],
        st["c8"].sum(-1) + lam * hdr[3],
    ])                                                     # [4,mbh,mbw]
    if not allow_parts:
        part = jnp.zeros((mbh, mbw), jnp.int32)
    else:
        part = jnp.argmin(tot, axis=0).astype(jnp.int32)

    # per-8x8-block full-pel MV under the chosen partition
    mv_by_part = jnp.stack([
        jnp.broadcast_to(st["mv16"][:, :, None, :], (mbh, mbw, 4, 2)),
        st["mv16x8"][:, :, [0, 0, 1, 1], :],
        st["mv8x16"][:, :, [0, 1, 0, 1], :],
        st["mv8"],
    ])                                                     # [4,mbh,mbw,4,2]
    mv8 = jnp.take_along_axis(
        mv_by_part, part[None, :, :, None, None], axis=0)[0]
    # [mbh,mbw,4,2] z-order -> [2mbh,2mbw,2] spatial
    mvsp = mv8.reshape(mbh, mbw, 2, 2, 2).transpose(0, 2, 1, 3, 4) \
              .reshape(2 * mbh, 2 * mbw, 2)
    return part, mvsp


def gather_windows8_jnp(planes, mvfp8, mbh: int, mbw: int):
    """Per-8x8-block window fetch: [N8, 4, 16, 16] at
    (block base + mv - MARGIN). Twin of QT.gather_windows_jnp."""
    n8 = 4 * mbh * mbw
    bys = (jnp.arange(n8) // (2 * mbw)) * 8
    bxs = (jnp.arange(n8) % (2 * mbw)) * 8
    mvf = mvfp8.reshape(n8, 2)
    ys = bys + mc.PAD - QT.MARGIN + mvf[:, 1]
    xs = bxs + mc.PAD - QT.MARGIN + mvf[:, 0]
    W8 = 16   # 8 + 2*MARGIN
    yy = ys[:, None] + jnp.arange(W8)
    xx = xs[:, None] + jnp.arange(W8)
    return planes[:, yy[:, :, None], xx[:, None, :]].transpose(1, 0, 2, 3)


def block_table8(windows):
    """[N8, 4, 16, 16] -> [169, N8, 8, 8] uint8: every qpel offset in
    [-6,6]^2 as static slice-averages (QT.block_table at 8x8). uint8
    storage: the table is the pipeline's largest resident (1.4 GB at
    1080p in int32 — 4x smaller here; 2-stream batching OOM'd without
    this)."""
    outs = []
    w16 = windows.astype(jnp.int16)
    for oy in range(-6, 7):
        for ox in range(-6, 7):
            (p1, y1, x1), (p2, y2, x2) = QT._phase_slices(oy, ox)
            a = w16[:, p1, y1:y1 + 8, x1:x1 + 8]
            b = w16[:, p2, y2:y2 + 8, x2:x2 + 8]
            outs.append(((a + b + 1) >> 1).astype(jnp.uint8))
    return jnp.stack(outs)


def wht8_flat(blocks):
    """Per-8x8-block WHT in a padding-friendly flat layout:
    [..., 8, 8] -> [..., 64] ordered (sub-block by*2+bx major, then the
    16 (r,c) coefficients): one contiguous 64-wide trailing dim
    instead of the [..., 4,4,2,2] tail."""
    w = QT.wht16(blocks.astype(jnp.int32))       # [..., 4,4,2,2]
    w = jnp.moveaxis(w, (-4, -3), (-2, -1))       # [..., by,bx?, r,c]
    # moveaxis gives [..., 2(by),2(bx),4(r),4(c)]
    return w.reshape(*w.shape[:-4], 64)


def satd_flat(wa, wb):
    """SATD between flat WHT tensors [..., 64]: per-sub |sum| >> 1 then
    summed; int32 accumulation (inputs may be int16)."""
    d = jnp.abs(wa.astype(jnp.int32) - wb.astype(jnp.int32))
    per_sub = d.reshape(*d.shape[:-1], 4, 16).sum(-1) >> 1
    return per_sub.sum(-1)


def _mb_blocks8(y, mbh, mbw):
    """[16mbh,16mbw] -> [N8, 8, 8] z-consistent spatial order (row-major
    over the 2mbh x 2mbw grid of 8x8 blocks)."""
    return y.reshape(2 * mbh, 8, 2 * mbw, 8).transpose(0, 2, 1, 3) \
            .reshape(4 * mbh * mbw, 8, 8)


def _sp_to_z(a, mbh, mbw):
    """[2mbh, 2mbw, ...] spatial block grid -> [mbh, mbw, 4, ...]
    z-order block axis."""
    rest = a.shape[2:]
    return a.reshape(mbh, 2, mbw, 2, *rest).transpose(
        0, 2, 1, 3, *range(4, 4 + len(rest))).reshape(mbh, mbw, 4, *rest)


def _z_to_sp(a, mbh, mbw):
    """[mbh, mbw, 4, ...] -> [2mbh, 2mbw, ...]."""
    rest = a.shape[3:]
    return a.reshape(mbh, mbw, 2, 2, *rest).transpose(
        0, 2, 1, 3, *range(4, 4 + len(rest))).reshape(
        2 * mbh, 2 * mbw, *rest)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "subpel"))
def subpel_parts(cur_y, wht8, part, mvfp8, prev_mv, mbh: int, mbw: int,
                 lam=1, subpel: int = 2):
    """Subpel refinement per partition unit from the 8x8 qpel tables.

    wht8: [169, N8, 4, 4, 2, 2] (WHT planes of the offset blocks, spatial
    row-major N8); part: [mbh,mbw]; mvfp8: [2mbh,2mbw,2] full-pel;
    prev_mv: [mbh,mbw,2] qpel predictor.
    Returns (mv8 [2mbh,2mbw,2] qpel, r_idx8 [N8] chosen table index)."""
    n8 = 4 * mbh * mbw
    cur8 = _mb_blocks8(cur_y, mbh, mbw)
    wcur = wht8_flat(cur8)                      # [N8,64]
    mvf = mvfp8.reshape(n8, 2)
    bits_t = jnp.asarray(mv_bits_table(4 * 512))
    off = 4 * 512
    pred8 = jnp.repeat(jnp.repeat(prev_mv, 2, 0), 2, 1).reshape(n8, 2)

    if subpel == 0:
        offsets = [(0, 0)]
    elif subpel == 1:
        offsets = [(oy, ox) for oy in (-2, 0, 2) for ox in (-2, 0, 2)]
    else:
        offsets = [(oy, ox) for oy in range(-3, 4) for ox in range(-3, 4)]

    # per-block SATD for each candidate offset
    satds = []
    mvcs = []
    for oy, ox in offsets:
        idx = QT.off_index(oy, ox)
        satds.append(satd_flat(wcur, wht8[idx]))           # [N8]
        qx = 4 * mvf[:, 0] + ox
        qy = 4 * mvf[:, 1] + oy
        mvcs.append((bits_t[jnp.clip(qx - pred8[:, 0], -off, off) + off]
                     + bits_t[jnp.clip(qy - pred8[:, 1], -off, off)
                              + off]) * lam)
    satds = jnp.stack(satds)                               # [K, N8]
    mvcs = jnp.stack(mvcs)                                 # [K, N8]

    # combine per unit: for each partition type, the unit cost of a
    # block is the sum of member-block SATDs + ONE mv cost (the unit's).
    satz = jax.vmap(lambda s: _sp_to_z(s, mbh, mbw))(
        satds.reshape(-1, 2 * mbh, 2 * mbw))               # [K,mbh,mbw,4]
    mvcz = jax.vmap(lambda s: _sp_to_z(s, mbh, mbw))(
        mvcs.reshape(-1, 2 * mbh, 2 * mbw))

    sums = jnp.stack([
        jnp.broadcast_to(satz.sum(-1, keepdims=True), satz.shape),
        satz[..., [0, 0, 2, 2]] + satz[..., [1, 1, 3, 3]],
        satz[..., [0, 1, 0, 1]] + satz[..., [2, 3, 2, 3]],
        satz,
    ])                                  # [4(part), K, mbh, mbw, 4(blk)]
    cost = jnp.take_along_axis(
        sums, part[None, None, :, :, None], axis=0)[0] + mvcz
    sel = jnp.argmin(cost, axis=0)                         # [mbh,mbw,4]
    best = jnp.min(cost, axis=0)                           # [mbh,mbw,4]
    offs = jnp.asarray(np.array(offsets, np.int32))        # [K,2] (oy,ox)
    oy_sel = offs[sel, 0]
    ox_sel = offs[sel, 1]
    mvz = _sp_to_z(mvfp8, mbh, mbw)                        # [mbh,mbw,4,2]
    mvq = jnp.stack([4 * mvz[..., 0] + ox_sel,
                     4 * mvz[..., 1] + oy_sel], axis=-1)
    r_idx = (oy_sel + 6) * 13 + (ox_sel + 6)               # [mbh,mbw,4]
    mv8 = _z_to_sp(mvq, mbh, mbw)                          # [2mbh,2mbw,2]
    r_idx8 = _z_to_sp(r_idx[..., None], mbh, mbw)[..., 0].reshape(n8)
    # per-MB inter cost for the intra compare: each block carries its
    # UNIT's cost (identical across members), so summing only each
    # unit's FIRST member gives the exact per-unit sum
    first = jnp.asarray(np.array([[1, 0, 0, 0], [1, 0, 1, 0],
                                  [1, 1, 0, 0], [1, 1, 1, 1]], np.int32))
    mb_cost = jnp.sum(best * first[part], axis=-1)         # [mbh,mbw]
    return mv8, r_idx8, mb_cost


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate"))
def stego_costs_parts_ref(cur_y, blocks8, wht8, r_idx8, part, mv8, mvp_u,
                          cost_mv, qp, mbh: int, mbw: int,
                          decimate: bool = True):
    """Reference twin of stego_costs_parts (bit-identical, slower):
    one full-MB re-encode per (slot, candidate) = 49 encode programs.
    Kept as the oracle for tests/test_stego_costs_v2.py; the serving
    path uses the per-block shared-encode rewrite below (13 block-level
    encode passes instead of 49 MB-level ones — the same DCT volume
    deduped across slots, measured ~3x on the probe stage).

    Partition-aware x264_ih_get_mv_cost (analyse.c:2391-2550): RCA
    alternative-MV cost for EVERY partition unit, batched.

    blocks8/wht8: [169, N8, ...] per-8x8 qpel tables; r_idx8: [N8]
    chosen offset index; part: [mbh,mbw]; mv8: [2mbh,2mbw,2] qpel;
    mvp_u: [mbh,mbw,4,2] per-unit MVPs (probe mv-cost anchor);
    cost_mv: lambda-weighted qpel distance table.
    Returns (rho [mbh,mbw,4] f32, alt_mv [mbh,mbw,4,2], valid
    [mbh,mbw,4] slot-exists mask).

    Semantics per unit: candidate MV deltas apply to the unit's member
    8x8 blocks; each candidate re-encodes the WHOLE MB (decimation
    couples blocks, matching the reference's full-MB probe encode);
    probe SATD is summed over member blocks only (the reference's
    partition-area MV_SATD_FDEC_IH).
    """
    from .inter import luma_p_encode
    from ..stego.cost import D_MV, D_NB, rca_decide

    n = mbh * mbw
    cur = cur_y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)
    r_z = _sp_to_z(r_idx8.reshape(2 * mbh, 2 * mbw), mbh, mbw) \
        .reshape(n, 4)                                    # [n,4] blk idx
    mvz = _sp_to_z(mv8, mbh, mbw).reshape(n, 4, 2)
    partf = part.reshape(n)
    block_unit = jnp.asarray(BLOCK_UNIT)[partf]           # [n,4]

    def didx(dy, dx):
        return dy * 13 + dx

    # every (slot, candidate) pred is assembled from the SAME 13 block
    # selections (delta applied to member blocks, identity elsewhere):
    # 13 table reads instead of 4x13 (the select is the HBM-bound part)
    def blocks_at(delta):
        idx8 = r_idx8 + didx(*delta)
        b8 = QT.select_rows(blocks8, idx8).astype(jnp.int32)  # [N8,8,8]
        return _sp_to_z(b8.reshape(2 * mbh, 2 * mbw, 8, 8),
                        mbh, mbw).reshape(n, 4, 8, 8)

    def mb_pred(blkz):
        """[n,4,8,8] z-order blocks -> [n,16,16] MB preds."""
        pl = blkz.reshape(mbh, mbw, 2, 2, 8, 8) \
                 .transpose(0, 2, 4, 1, 3, 5) \
                 .reshape(16 * mbh, 16 * mbw)
        return pl.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
                 .reshape(n, 16, 16)

    def wht_blocks_z(rec):
        """[n,16,16] MB recon -> [n,4,64] per-8x8 flat WHT (z order)."""
        r8 = rec.reshape(n, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4) \
                .reshape(n, 4, 8, 8)
        return wht8_flat(r8)                              # [n,4,64]

    # pre-select WHT rows for the 7x7 probe lattice of each block,
    # re-laid-out to z-order [n, 4(blk), 64]
    sel_whtz = {}
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            w = QT.select_rows(wht8, r_idx8 + didx(dy, dx))  # [N8,64]
            sel_whtz[(dy, dx)] = _sp_to_z(
                w.reshape(2 * mbh, 2 * mbw, 64),
                mbh, mbw).reshape(n, 4, 64)

    mvpz = mvp_u.reshape(n, 4, 2)

    member = {}
    for u in range(4):
        member[u] = (block_unit == u)                     # [n,4] bool

    blk0z = blocks_at((0, 0))                             # [n,4,8,8]
    cand_blkz = [blocks_at((int(D_MV[c][1]), int(D_MV[c][0])))
                 for c in range(12)]
    # the original-MV encode is slot-independent: one shared recon
    from .inter import luma_p_encode as _lpe
    cur_shared = cur
    _, rec0_shared = _lpe(cur_shared, mb_pred(blk0z), qp, decimate)

    out_rho, out_alt, out_valid = [], [], []
    for u in range(4):
        mem = member[u]                                   # [n,4]
        valid_u = jnp.any(mem, axis=1)                    # slot exists
        # unit mv = mv of its first member block
        first = jnp.argmax(mem, axis=1)                   # [n]
        mvu = jnp.take_along_axis(
            mvz, first[:, None, None], axis=1)[:, 0]      # [n,2]
        mvpu = mvpz[:, u]                                 # [n,2]

        def mvcost(dq):
            qx = mvu[:, 0] + dq[1]
            qy = mvu[:, 1] + dq[0]
            return (cost_mv[jnp.abs(qx - mvpu[:, 0])]
                    + cost_mv[jnp.abs(qy - mvpu[:, 1])])

        def probes(wrec_z, center):
            """wrec_z: [n,4,...] per-block WHT of a recon. Probe cost
            over MEMBER blocks at the 9 unit-neighbourhood MVs."""
            outp = []
            for k in range(9):
                dk = (int(D_NB[k][1]), int(D_NB[k][0]))   # (dy,dx)
                d = (center[0] + dk[0], center[1] + dk[1])
                wt = sel_whtz[d]                          # [n,4,64]
                per_blk = satd_flat(wrec_z, wt)           # [n,4]
                sat = jnp.sum(per_blk * mem, axis=1)      # member sum
                outp.append(sat + mvcost(d))
            return jnp.stack(outp, axis=1)                # [n,9]

        def encode_cand(c):
            """Re-encode MB with unit u's blocks at candidate c."""
            m4 = mem[:, :, None, None]
            blkz = jnp.where(m4, cand_blkz[c], blk0z)
            _, rec = luma_p_encode(cur, mb_pred(blkz), qp, decimate)
            return wht_blocks_z(rec)

        w0 = wht_blocks_z(rec0_shared)
        nb0 = probes(w0, (0, 0))
        orig_cost = nb0[:, 8]
        orig_opt = jnp.min(nb0, axis=1) >= orig_cost

        cand_cost, cand_opt = [], []
        for c in range(12):
            dc = (int(D_MV[c][1]), int(D_MV[c][0]))       # (dy,dx)
            wc = encode_cand(c)
            nbc = probes(wc, dc)
            cand_cost.append(nbc[:, 8])
            cand_opt.append(jnp.min(nbc, axis=1) >= nbc[:, 8])
        cand_cost = jnp.stack(cand_cost, axis=1)
        cand_opt = jnp.stack(cand_opt, axis=1)

        rho, sel_delta, _flags = rca_decide(nb0, orig_cost, orig_opt,
                                            cand_cost, cand_opt)
        out_rho.append(rho)
        out_alt.append(mvu + sel_delta)
        out_valid.append(valid_u)

    rho = jnp.stack(out_rho, axis=1).reshape(mbh, mbw, 4)
    alt = jnp.stack(out_alt, axis=1).reshape(mbh, mbw, 4, 2)
    valid = jnp.stack(out_valid, axis=1).reshape(mbh, mbw, 4)
    return rho, alt, valid


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate"))
def stego_costs_parts(cur_y, blocks8, wht8, r_idx8, part, mv8, mvp_u,
                      cost_mv, qp, mbh: int, mbw: int,
                      decimate: bool = True):
    """Per-block shared-encode RCA probe stage (bit-identical to
    stego_costs_parts_ref — fuzzed by tests/test_stego_costs_v2.py).

    Key identity exploited: the 4x4 DCT/quant/recon of an 8x8 block
    depends only on (cur block, pred block), and every (slot,
    candidate) combination assembles its MB from per-block VERSIONS
    v in {0 (chosen MV), 1..12 (D_MV candidates)}. So the transform
    chain runs ONCE per (block, version) — 13 block-level passes —
    and each combination reduces to cheap selects:
      - per-block decimate scores sc8[v] and keep8[v] (JVT-B118 is
        per-4x4/per-8x8; only the keep_mb >= 6 gate couples the MB,
        and that is a sum of selected per-block scores);
      - recon WHT per block = kept ? WK[v] : WP[v]  (zeroed levels
        reconstruct to the prediction exactly).
    Reference semantics per unit unchanged: candidate deltas apply to
    member blocks, decimation couples the whole MB, probe SATD sums
    member blocks only (analyse.c:2391-2550 MV_SATD_FDEC_IH).

    Split into probe_maps_xla (the heavy, unit/mvp-independent SATD
    maps) + probe_combine (the cheap per-unit RCA logic); the deep
    pipeline computes the maps before the MVPs are known."""
    SK, SP, sc8 = probe_maps_xla(cur_y, blocks8, wht8, r_idx8, qp,
                                 mbh, mbw, decimate)
    return probe_combine(SK, SP, sc8, part, mv8, mvp_u, cost_mv,
                         mbh, mbw, decimate)


def probe_maps_xla(cur_y, blocks8, wht8, r_idx8, qp, mbh: int,
                   mbw: int, decimate: bool = True):
    """Per-version probe SATD maps + decimate scores (the
    unit-independent heavy half of the RCA probe stage).  Returns
    (SK [13,9,n,4], SP [13,9,n,4], sc8 [13,n,4]); SP == SK when
    decimate is off."""
    from ..stego.cost import D_MV, D_NB

    n = mbh * mbw
    cur = cur_y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)

    def didx(dy, dx):
        return dy * 13 + dx

    # ---- table rows: 13 block versions + 49 probe-lattice WHT rows
    off13 = [0] + [didx(int(D_MV[c][1]), int(D_MV[c][0]))
                   for c in range(12)]
    blk13 = [_sp_to_z(QT.select_rows(blocks8, r_idx8 + o)
                      .astype(jnp.int32).reshape(2 * mbh, 2 * mbw, 8, 8),
                      mbh, mbw).reshape(n, 4, 8, 8)
             for o in off13]
    sel_whtz = {}
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            sel_whtz[(dy, dx)] = _sp_to_z(
                QT.select_rows(wht8, r_idx8 + didx(dy, dx))
                .reshape(2 * mbh, 2 * mbw, 64),
                mbh, mbw).reshape(n, 4, 64)

    # ---- per-(block, version) shared encode: 13 versions, each a
    # separately-fused DCT/quant/recon chain over [n*4] 8x8 blocks
    from .inter import _zigzag_gather, decimate_score
    from ..ops.blocks import from_blocks
    curz = cur.reshape(n, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4) \
              .reshape(n, 4, 8, 8)
    qp_a = jnp.asarray(qp)
    if qp_a.ndim == 1:   # per-MB AQ: expand over the 4 blocks
        qp_b = jnp.broadcast_to(qp_a[:, None],
                                (n, 4)).reshape(n * 4)[:, None, None]
    else:
        qp_b = qp_a

    def encode_v(pv):
        """pv: [n,4,8,8] pred blocks -> (WK [n,4,64], WP, sc8 [n,4])."""
        pv4 = pv.reshape(n * 4, 8, 8)
        res = to_blocks(curz.reshape(n * 4, 8, 8) - pv4, 4)
        lev = T.quant4x4(T.dct4x4(res), qp_b, intra=False)
        rec = T.idct4x4_add(to_blocks(pv4, 4),
                            T.dequant4x4(lev, qp_b))
        wk = wht8_flat(from_blocks(rec)).reshape(n, 4, 64)
        wp = wht8_flat(pv)
        if decimate:
            sc = decimate_score(_zigzag_gather(lev))       # [n*4,2,2]
            sc8_v = sc.sum((1, 2)).reshape(n, 4)
        else:
            sc8_v = jnp.zeros((n, 4), jnp.int32)
        return wk, wp, sc8_v

    outs = [encode_v(blk13[v]) for v in range(13)]
    WK = [o[0] for o in outs]
    WP = [o[1] for o in outs]
    sc8 = [o[2] for o in outs]

    nb_d = [(int(D_NB[k][1]), int(D_NB[k][0])) for k in range(9)]
    centers = [(0, 0)] + [(int(D_MV[c][1]), int(D_MV[c][0]))
                          for c in range(12)]

    # Per-version probe SATD maps, unit-independent: a member block of
    # any (unit, candidate c) combination reconstructs to WK[c+1]
    # (kept) or WP[c+1] (decimated) regardless of the unit, and the
    # probe sum masks non-members out anyway — so the 9-point probe
    # SATDs collapse to 26 precomputed maps + per-combination [n,4]
    # selects (the previous form re-ran 52 stacked [9,n,4,64] SATDs,
    # ~2 GB of HBM traffic per frame at 1080p).
    SK, SP = [], []
    for v, cen in enumerate(centers):
        sels = jnp.stack([sel_whtz[(cen[0] + dk0, cen[1] + dk1)]
                          for dk0, dk1 in nb_d])       # [9,n,4,64]
        SK.append(satd_flat(WK[v][None], sels))        # [9,n,4]
        SP.append(satd_flat(WP[v][None], sels) if decimate else SK[v])
    return jnp.stack(SK), jnp.stack(SP), jnp.stack(sc8)


def probe_combine(SK, SP, sc8, part, mv8, mvp_u, cost_mv, mbh: int,
                  mbw: int, decimate: bool = True):
    """Per-unit RCA selection from precomputed probe SATD maps
    (analyse.c:2391-2550 semantics; the cheap half of the probe
    stage).

    SK/SP: [13, 9, n, 4] kept/decimated probe SATD maps (version 0 =
    the chosen MV, 1..12 = the D_MV candidates); sc8: [13, n, 4]
    per-version per-8x8 decimate scores.
    Returns (rho [mbh,mbw,4] f32, alt [mbh,mbw,4,2], valid)."""
    from ..stego.cost import D_MV, D_NB, rca_decide

    n = mbh * mbw
    mvz = _sp_to_z(mv8, mbh, mbw).reshape(n, 4, 2)
    partf = part.reshape(n)
    block_unit = jnp.asarray(BLOCK_UNIT)[partf]           # [n,4]
    mvpz = mvp_u.reshape(n, 4, 2)
    member = {u: (block_unit == u) for u in range(4)}      # [n,4] bool

    keep8 = [sc8[v] >= 4 for v in range(13)]
    if decimate:
        keep_mb0 = jnp.sum(jnp.where(keep8[0], sc8[0], 0), axis=1) >= 6
        kept0 = keep8[0] & keep_mb0[:, None]

    nb_d = [(int(D_NB[k][1]), int(D_NB[k][0])) for k in range(9)]
    centers = [(0, 0)] + [(int(D_MV[c][1]), int(D_MV[c][0]))
                          for c in range(12)]

    # version-0 decimation is combination-independent
    P0 = jnp.where(kept0[None], SK[0], SP[0]) if decimate else SK[0]

    out_rho, out_alt, out_valid = [], [], []
    for u in range(4):
        mem = member[u]                                   # [n,4]
        valid_u = jnp.any(mem, axis=1)
        first = jnp.argmax(mem, axis=1)
        mvu = jnp.take_along_axis(
            mvz, first[:, None, None], axis=1)[:, 0]      # [n,2]
        mvpu = mvpz[:, u]

        def mvcost(dq):
            qx = mvu[:, 0] + dq[1]
            qy = mvu[:, 1] + dq[0]
            return (cost_mv[jnp.abs(qx - mvpu[:, 0])]
                    + cost_mv[jnp.abs(qy - mvpu[:, 1])])

        def probes_from(per_blk, center):
            """per_blk: [9,n,4] precomputed SATD map -> [n,9] costs."""
            sat = jnp.sum(per_blk * mem[None], axis=2)    # [9,n]
            mvc = jnp.stack([mvcost((center[0] + dk0, center[1] + dk1))
                             for dk0, dk1 in nb_d])       # [9,n]
            return (sat + mvc).T                          # [n,9]

        def per_blk_for(c):
            """SATD map of the (u, candidate c) combination (member
            blocks only are meaningful; the rest are masked)."""
            if not decimate:
                return SK[c + 1]
            sc_sel = jnp.where(mem, sc8[c + 1], sc8[0])
            k8_sel = jnp.where(mem, keep8[c + 1], keep8[0])
            keep_mb = jnp.sum(jnp.where(k8_sel, sc_sel, 0),
                              axis=1) >= 6
            kept = k8_sel & keep_mb[:, None]
            return jnp.where(kept[None], SK[c + 1], SP[c + 1])

        nb0 = probes_from(P0, (0, 0))
        orig_cost = nb0[:, 8]
        orig_opt = jnp.min(nb0, axis=1) >= orig_cost

        cand_cost, cand_opt = [], []
        for c in range(12):
            nbc = probes_from(per_blk_for(c), centers[c + 1])
            cand_cost.append(nbc[:, 8])
            cand_opt.append(jnp.min(nbc, axis=1) >= nbc[:, 8])
        cand_cost = jnp.stack(cand_cost, axis=1)
        cand_opt = jnp.stack(cand_opt, axis=1)

        rho, sel_delta, _flags = rca_decide(nb0, orig_cost, orig_opt,
                                            cand_cost, cand_opt)
        out_rho.append(rho)
        out_alt.append(mvu + sel_delta)
        out_valid.append(valid_u)

    rho = jnp.stack(out_rho, axis=1).reshape(mbh, mbw, 4)
    alt = jnp.stack(out_alt, axis=1).reshape(mbh, mbw, 4, 2)
    valid = jnp.stack(out_valid, axis=1).reshape(mbh, mbw, 4)
    return rho, alt, valid


# ---------------------------------------------------------------------------
# Multi-reference ME (x264 i_frame_reference > 1; per-ref search loop of
# x264_mb_analyse_inter_p16x16 analyse.c:1122-1200 and the mixed-ref
# p8x8 analysis :1291-1370). Batched redesign: the exhaustive scan runs once
# per DPB entry; per-unit (cost, mv, ref) merge is a masked argmin with
# the te(v) ref-bit lambda term. Invalid DPB slots (early frames after
# an IDR, padded by repeating entries) are masked out with a +inf
# penalty keyed on the traced n_valid — one compiled program serves
# every DPB fill level.
# ---------------------------------------------------------------------------

def te_ref_bits(num_ref: int) -> np.ndarray:
    """Bit cost of ref_idx te(v) per index (spec 9.1.1): one bit when
    the range is 0..1, else ue(v) size."""
    if num_ref <= 1:
        return np.zeros(num_ref, np.int32)
    if num_ref == 2:
        return np.ones(2, np.int32)
    return np.array([2 * int(np.floor(np.log2(i + 1))) + 1
                     for i in range(num_ref)], np.int32)


def merge_ref_states(sts, lam, ref_bits, n_valid):
    """Merge per-ref fullpel states into (cost, mv, ref) per unit.
    sts: list of fullpel_search_parts dicts; ref_bits: [R] te bits;
    n_valid: traced count of valid DPB slots. Ties keep the lower
    ref (strictly-better update, ascending scan order)."""
    out = {}
    for ck in ("c16", "c16x8", "c8x16", "c8"):
        mk = "mv" + ck[1:]
        rk = "r" + ck[1:]
        best_c = best_mv = best_r = None
        for r, st in enumerate(sts):
            pen = jnp.where(r < n_valid, 0, 1 << 28)
            c = st[ck] + lam * int(ref_bits[r]) + pen
            if best_c is None:
                best_c, best_mv = c, st[mk]
                best_r = jnp.zeros_like(c)
            else:
                better = c < best_c
                best_c = jnp.where(better, c, best_c)
                best_mv = jnp.where(better[..., None], st[mk], best_mv)
                best_r = jnp.where(better, r, best_r)
        out[ck], out[mk], out[rk] = best_c, best_mv, best_r
    return out


def ref8_from_partition(st, part, mbh: int, mbw: int):
    """Per-8x8-block ref under the chosen partition (take_along twin of
    decide_partition's mv selection)."""
    ref_by_part = jnp.stack([
        jnp.broadcast_to(st["r16"][:, :, None], (mbh, mbw, 4)),
        st["r16x8"][:, :, [0, 0, 1, 1]],
        st["r8x16"][:, :, [0, 1, 0, 1]],
        st["r8"],
    ])                                              # [4,mbh,mbw,4]
    r8 = jnp.take_along_axis(
        ref_by_part, part[None, :, :, None], axis=0)[0]
    return _z_to_sp(r8[..., None], mbh, mbw)[..., 0]  # [2mbh,2mbw]


def gather_windows8_mref(planes_r, mvfp8, ref8, mbh: int, mbw: int):
    """Multi-ref twin of gather_windows8_jnp: planes_r [R,4,Hp,Wp],
    ref8 [2mbh,2mbw] per-block DPB index."""
    n8 = 4 * mbh * mbw
    bys = (jnp.arange(n8) // (2 * mbw)) * 8
    bxs = (jnp.arange(n8) % (2 * mbw)) * 8
    mvf = mvfp8.reshape(n8, 2)
    ys = bys + mc.PAD - QT.MARGIN + mvf[:, 1]
    xs = bxs + mc.PAD - QT.MARGIN + mvf[:, 0]
    W8 = 16
    r = ref8.reshape(n8)[:, None, None, None]
    pp = jnp.arange(4)[None, :, None, None]
    yy = (ys[:, None] + jnp.arange(W8))[:, None, :, None]
    xx = (xs[:, None] + jnp.arange(W8))[:, None, None, :]
    return planes_r[r, pp, yy, xx]                  # [n8,4,W8,W8]


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel", "allow_parts",
                                             "num_ref"))
def analyse_p_frame_parts_mref(y, refs_luma, n_valid, prev_mv, rng: int,
                               mbh: int, mbw: int, lam, subpel: int,
                               num_ref: int,
                               allow_parts: bool = True):
    """Multi-reference fused partition analysis. refs_luma:
    [R, 4, Hp, Wp] stacked DPB (newest = index 0); n_valid: traced
    valid-slot count. Returns (part, mv8, ref8, r_idx8, blocks8, wht8,
    mb_cost)."""
    ref_bits = te_ref_bits(num_ref)
    sts = [FP.fullpel_parts(y, refs_luma[r, 0], prev_mv >> 2, rng, mbh,
                            mbw, lam)
           for r in range(num_ref)]
    st = merge_ref_states(sts, lam, ref_bits, n_valid)
    part, mvfp8 = decide_partition.__wrapped__(
        st, mbh, mbw, lam, allow_parts)
    ref8 = ref8_from_partition(st, part, mbh, mbw)
    windows = gather_windows8_mref(
        refs_luma.astype(jnp.uint8), mvfp8, ref8, mbh, mbw)
    blocks8 = block_table8(windows)
    wht8 = wht8_flat(blocks8).astype(jnp.int16)
    mv8, r_idx8, mb_cost = subpel_parts.__wrapped__(
        y, wht8, part, mvfp8, prev_mv, mbh, mbw, lam, subpel)
    return part, mv8, ref8, r_idx8, blocks8, wht8, mb_cost


# ---------------------------------------------------------------------------
# Sub-8x8 partitions (P_8x8 sub_mb_types 8x4 / 4x8 / 4x4)
#
# Reference: the p4x4/p8x4/p4x8 analysis helpers
# (analyse.c x264_mb_analyse_inter_p4x4:1569, p8x4:1613, p4x8:1654) and
# the D_L0_4x4/8x4/4x8 stego-capture cases (analyse.c:3518-3689).
# Batched redesign: the exhaustive full-pel scan accumulates per-4x4 SAD planes,
# so every sub-unit of every 8x8 block gets its exhaustive best MV from
# the same pass; the sub_mb_type decision is a 4-way argmin per 8x8
# block with ue() header-bit lambda terms, and the MB partition decision
# consumes the sub-optimized 8x8 cost.
# ---------------------------------------------------------------------------

# sub_mb_type header bits: ue(0)=1, ue(1)=3, ue(2)=3, ue(3)=5
_SUB_HDR_BITS = np.array([1, 3, 3, 5], np.int32)
# mb_type header bits with the P_8x8 sub bits counted separately
_HDR_BITS_SUB = np.array([1, 3, 3, 5], np.int32)

# per-4x4-block (z order within MB, 0..15) unit-slot id (= z index of
# the unit's first member block) for MB partitions 0..2
_UNIT_ID_PART = np.array([
    [0] * 16,
    [0] * 8 + [8] * 8,                      # 16x8: top, bottom
    [0, 0, 0, 0, 4, 4, 4, 4] * 2,           # 8x16: left(blk0,2) right(1,3)
], np.int32)
# relative slot id within an 8x8 block per sub_mb_type
_SUB_UNIT_ID = np.array([
    [0, 0, 0, 0],       # 8x8
    [0, 0, 2, 2],       # 8x4: top pair, bottom pair
    [0, 1, 0, 1],       # 4x8: left pair, right pair
    [0, 1, 2, 3],       # 4x4
], np.int32)


def unit_id_map(part, sub_type):
    """[mbh,mbw] part + [mbh,mbw,4] sub_type -> [mbh,mbw,16] unit-slot
    id per 4x4 block (z order). Slot id = z index of the unit's first
    member block, so slot s exists iff unit_id[..., s] == s."""
    mbh, mbw = part.shape
    base = jnp.asarray(_UNIT_ID_PART)[jnp.clip(part, 0, 2)]  # [mbh,mbw,16]
    rel = jnp.asarray(_SUB_UNIT_ID)[sub_type]                # [mbh,mbw,4,4]
    blk_base = jnp.arange(4, dtype=jnp.int32)[:, None] * 4
    sub_ids = (rel + blk_base).reshape(mbh, mbw, 16)
    return jnp.where((part == 3)[..., None], sub_ids, base)


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw"))
def fullpel_search_sub(cur_y, ref_fp, pred_mv_fp, rng: int,
                       mbh: int, mbw: int, lam=1):
    """Exhaustive full-pel scan with per-4x4 accumulation: best MV per
    unit for all MB partition shapes AND all sub-8x8 shapes at once.

    Returns the fullpel_search_parts dict plus c84/mv84 [mbh,mbw,4,2,..]
    (8x4 sub-units per 8x8 block), c48/mv48, c44/mv44 [mbh,mbw,4,4,..]."""
    h, w = 16 * mbh, 16 * mbw
    n_c = (2 * rng + 1) ** 2
    dys, dxs = np.meshgrid(np.arange(-rng, rng + 1),
                           np.arange(-rng, rng + 1), indexing="ij")
    dys = jnp.asarray(dys.ravel())
    dxs = jnp.asarray(dxs.ravel())
    bits_t = jnp.asarray(mv_bits_table(4 * (rng + 64)))
    off = 4 * (rng + 64)
    pmx = pred_mv_fp[..., 0]
    pmy = pred_mv_fp[..., 1]

    def init_state():
        st = dict(
            c16=jnp.full((mbh, mbw), 1 << 30, jnp.int32),
            mv16=jnp.zeros((mbh, mbw, 2), jnp.int32),
            c16x8=jnp.full((mbh, mbw, 2), 1 << 30, jnp.int32),
            mv16x8=jnp.zeros((mbh, mbw, 2, 2), jnp.int32),
            c8x16=jnp.full((mbh, mbw, 2), 1 << 30, jnp.int32),
            mv8x16=jnp.zeros((mbh, mbw, 2, 2), jnp.int32),
            c8=jnp.full((mbh, mbw, 4), 1 << 30, jnp.int32),
            mv8=jnp.zeros((mbh, mbw, 4, 2), jnp.int32),
            c84=jnp.full((mbh, mbw, 4, 2), 1 << 30, jnp.int32),
            mv84=jnp.zeros((mbh, mbw, 4, 2, 2), jnp.int32),
            c48=jnp.full((mbh, mbw, 4, 2), 1 << 30, jnp.int32),
            mv48=jnp.zeros((mbh, mbw, 4, 2, 2), jnp.int32),
            c44=jnp.full((mbh, mbw, 4, 4), 1 << 30, jnp.int32),
            mv44=jnp.zeros((mbh, mbw, 4, 4, 2), jnp.int32),
        )
        return st

    def step(st, i):
        dy, dx = dys[i], dxs[i]
        win = jax.lax.dynamic_slice(
            ref_fp, (mc.PAD + dy, mc.PAD + dx), (h, w))
        sad4 = jnp.sum(to_blocks(jnp.abs(cur_y - win), 4),
                       axis=(-4, -3))                     # [4mbh, 4mbw]
        # z layout: [mbh, mbw, 4(blk z), 4(sub z)]
        q4 = sad4.reshape(mbh, 2, 2, mbw, 2, 2) \
                 .transpose(0, 3, 1, 4, 2, 5).reshape(mbh, mbw, 4, 4)
        q8 = q4.sum(-1)                                   # [mbh,mbw,4]
        mvc = (bits_t[4 * dx - 4 * pmx + off]
               + bits_t[4 * dy - 4 * pmy + off]) * lam    # [mbh,mbw]
        mv_i = jnp.stack([jnp.broadcast_to(dx, (mbh, mbw)),
                          jnp.broadcast_to(dy, (mbh, mbw))], axis=-1)

        def upd(cost_key, mv_key, cost):
            c = st[cost_key]
            better = cost < c
            st[cost_key] = jnp.where(better, cost, c)
            bmv = jnp.broadcast_to(
                mv_i.reshape((mbh, mbw) + (1,) * (c.ndim - 2) + (2,)),
                st[mv_key].shape)
            st[mv_key] = jnp.where(better[..., None], bmv, st[mv_key])

        upd("c16", "mv16", q8.sum(-1) + mvc)
        qz = q8.reshape(mbh, mbw, 2, 2)                   # [.,.,row,col]
        upd("c16x8", "mv16x8", qz.sum(3) + mvc[..., None])
        upd("c8x16", "mv8x16", qz.sum(2) + mvc[..., None])
        upd("c8", "mv8", q8 + mvc[..., None])
        m1 = mvc[..., None, None]
        # sub z order within 8x8: 0 TL, 1 TR, 2 BL, 3 BR
        upd("c84", "mv84",
            q4[..., [0, 2]] + q4[..., [1, 3]] + m1)       # top, bottom
        upd("c48", "mv48",
            q4[..., [0, 1]] + q4[..., [2, 3]] + m1)       # left, right
        upd("c44", "mv44", q4 + m1)
        return st, None

    st, _ = jax.lax.scan(step, init_state(), jnp.arange(n_c))
    return st


@functools.partial(jax.jit, static_argnames=("mbh", "mbw",
                                             "allow_parts"))
def decide_partition_sub(st, mbh: int, mbw: int, lam=1,
                         allow_parts: bool = True):
    """Two-level partition decision: per-8x8 sub_mb_type argmin, then
    the 4-way MB decision consuming the sub-optimized 8x8 cost.
    Returns (part [mbh,mbw], sub_type [mbh,mbw,4], mv4fp
    [4mbh,4mbw,2] full-pel per 4x4 block)."""
    shdr = jnp.asarray(_SUB_HDR_BITS)
    sub_tot = jnp.stack([
        st["c8"] + lam * shdr[0],
        st["c84"].sum(-1) + lam * shdr[1],
        st["c48"].sum(-1) + lam * shdr[2],
        st["c44"].sum(-1) + lam * shdr[3],
    ])                                             # [4(sub),mbh,mbw,4]
    sub_type = jnp.argmin(sub_tot, axis=0).astype(jnp.int32)
    c8best = jnp.min(sub_tot, axis=0)              # [mbh,mbw,4]

    hdr = jnp.asarray(_HDR_BITS_SUB)
    tot = jnp.stack([
        st["c16"] + lam * hdr[0],
        st["c16x8"].sum(-1) + lam * hdr[1],
        st["c8x16"].sum(-1) + lam * hdr[2],
        c8best.sum(-1) + lam * hdr[3],
    ])
    if not allow_parts:
        part = jnp.zeros((mbh, mbw), jnp.int32)
    else:
        part = jnp.argmin(tot, axis=0).astype(jnp.int32)
    sub_type = jnp.where((part == 3)[..., None], sub_type, 0)

    # per-4x4-block (z order) MV under the chosen sub shape
    mv44_by_sub = jnp.stack([
        jnp.broadcast_to(st["mv8"][:, :, :, None, :], (mbh, mbw, 4, 4, 2)),
        st["mv84"][:, :, :, [0, 1, 0, 1], :][:, :, :, [0, 2, 1, 3], :],
        st["mv48"][:, :, :, [0, 1, 0, 1], :],
        st["mv44"],
    ])                                       # [4(sub),mbh,mbw,4,4,2]
    mv44_p3 = jnp.take_along_axis(
        mv44_by_sub, sub_type[None, :, :, :, None, None], axis=0)[0]
    mv44_by_part = jnp.stack([
        jnp.broadcast_to(st["mv16"][:, :, None, None, :],
                         (mbh, mbw, 4, 4, 2)),
        jnp.broadcast_to(st["mv16x8"][:, :, [0, 0, 1, 1], None, :],
                         (mbh, mbw, 4, 4, 2)),
        jnp.broadcast_to(st["mv8x16"][:, :, [0, 1, 0, 1], None, :],
                         (mbh, mbw, 4, 4, 2)),
        mv44_p3,
    ])                                       # [4(part),mbh,mbw,4,4,2]
    mv44 = jnp.take_along_axis(
        mv44_by_part, part[None, :, :, None, None, None], axis=0)[0]
    # [mbh,mbw,4(blk z),4(sub z),2] -> [4mbh,4mbw,2] spatial
    mv4 = mv44.reshape(mbh, mbw, 2, 2, 2, 2, 2) \
              .transpose(0, 2, 4, 1, 3, 5, 6) \
              .reshape(4 * mbh, 4 * mbw, 2)
    return part, sub_type, mv4


def gather_windows4_jnp(planes, mv4fp, mbh: int, mbw: int):
    """Per-4x4-block window fetch: [N4, 4, 12, 12] at
    (block base + mv - MARGIN)."""
    n4 = 16 * mbh * mbw
    bys = (jnp.arange(n4) // (4 * mbw)) * 4
    bxs = (jnp.arange(n4) % (4 * mbw)) * 4
    mvf = mv4fp.reshape(n4, 2)
    ys = bys + mc.PAD - QT.MARGIN + mvf[:, 1]
    xs = bxs + mc.PAD - QT.MARGIN + mvf[:, 0]
    W4 = 12   # 4 + 2*MARGIN
    yy = ys[:, None] + jnp.arange(W4)
    xx = xs[:, None] + jnp.arange(W4)
    return planes[:, yy[:, :, None], xx[:, None, :]].transpose(1, 0, 2, 3)


def block_table4(windows):
    """[N4, 4, 12, 12] -> [169, N4, 4, 4] uint8 qpel offset blocks."""
    outs = []
    w16 = windows.astype(jnp.int16)
    for oy in range(-6, 7):
        for ox in range(-6, 7):
            (p1, y1, x1), (p2, y2, x2) = QT._phase_slices(oy, ox)
            a = w16[:, p1, y1:y1 + 4, x1:x1 + 4]
            b = w16[:, p2, y2:y2 + 4, x2:x2 + 4]
            outs.append(((a + b + 1) >> 1).astype(jnp.uint8))
    return jnp.stack(outs)


def wht4_flat(blocks):
    """Per-4x4-block WHT, flat: [..., 4, 4] -> [..., 16]."""
    h = QT.wht16(blocks.astype(jnp.int32))        # [..., 4,4,1,1]
    return h.reshape(*blocks.shape[:-2], 16)


def satd_flat4(wa, wb):
    """SATD between flat 4x4 WHT tensors [..., 16]."""
    d = jnp.abs(wa.astype(jnp.int32) - wb.astype(jnp.int32))
    return d.sum(-1) >> 1


def _blocks4_z(y, mbh, mbw):
    """[16mbh,16mbw] -> [N4, 4, 4] spatial row-major 4x4 blocks."""
    return y.reshape(4 * mbh, 4, 4 * mbw, 4).transpose(0, 2, 1, 3) \
            .reshape(16 * mbh * mbw, 4, 4)


def _sp4_to_z(a, mbh, mbw):
    """[4mbh, 4mbw, ...] -> [mbh, mbw, 16, ...] z-order block axis
    (blk8-z major, sub-z minor — matches LUMA_SCAN)."""
    rest = a.shape[2:]
    return a.reshape(mbh, 2, 2, mbw, 2, 2, *rest).transpose(
        0, 3, 1, 4, 2, 5, *range(6, 6 + len(rest))).reshape(
        mbh, mbw, 16, *rest)


def _z_to_sp4(a, mbh, mbw):
    """[mbh, mbw, 16, ...] -> [4mbh, 4mbw, ...]."""
    rest = a.shape[3:]
    return a.reshape(mbh, mbw, 2, 2, 2, 2, *rest).transpose(
        0, 2, 4, 1, 3, 5, *range(6, 6 + len(rest))).reshape(
        4 * mbh, 4 * mbw, *rest)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "subpel"))
def subpel_sub(cur_y, wht4, part, sub_type, mv4fp, prev_mv, mbh: int,
               mbw: int, lam=1, subpel: int = 2):
    """Subpel refinement per unit at 4x4 granularity from the 4x4 qpel
    tables. wht4: [169, N4, 16]; mv4fp: [4mbh,4mbw,2] full-pel.
    Returns (mv4 qpel [4mbh,4mbw,2], r_idx4 [N4], mb_cost [mbh,mbw])."""
    n = mbh * mbw
    n4 = 16 * n
    cur4 = _blocks4_z(cur_y, mbh, mbw)
    wcur = wht4_flat(cur4)                       # [N4,16]
    mvf = mv4fp.reshape(n4, 2)
    bits_t = jnp.asarray(mv_bits_table(4 * 512))
    off = 4 * 512
    pred4 = jnp.repeat(jnp.repeat(prev_mv, 4, 0), 4, 1).reshape(n4, 2)

    if subpel == 0:
        offsets = [(0, 0)]
    elif subpel == 1:
        offsets = [(oy, ox) for oy in (-2, 0, 2) for ox in (-2, 0, 2)]
    else:
        offsets = [(oy, ox) for oy in range(-3, 4) for ox in range(-3, 4)]

    satds, mvcs = [], []
    for oy, ox in offsets:
        idx = QT.off_index(oy, ox)
        satds.append(satd_flat4(wcur, wht4[idx]))          # [N4]
        qx = 4 * mvf[:, 0] + ox
        qy = 4 * mvf[:, 1] + oy
        mvcs.append((bits_t[jnp.clip(qx - pred4[:, 0], -off, off) + off]
                     + bits_t[jnp.clip(qy - pred4[:, 1], -off, off)
                              + off]) * lam)
    satds = jnp.stack(satds)                               # [K, N4]
    mvcs = jnp.stack(mvcs)                                 # [K, N4]

    uid = unit_id_map(part, sub_type)                      # [mbh,mbw,16]
    member = (uid[..., None] == jnp.arange(16)) \
        .astype(jnp.int32)                                 # [mbh,mbw,16,16]
    satz = jax.vmap(lambda s: _sp4_to_z(
        s.reshape(4 * mbh, 4 * mbw), mbh, mbw))(satds)     # [K,mbh,mbw,16]
    mvcz = jax.vmap(lambda s: _sp4_to_z(
        s.reshape(4 * mbh, 4 * mbw), mbh, mbw))(mvcs)
    # unit SATD sums: contract the block axis against the member matrix
    unit_satd = jnp.einsum("kyxb,yxbs->kyxs", satz, member)
    cost = unit_satd + mvcz                                # [K,mbh,mbw,16]
    sel_slot = jnp.argmin(cost, axis=0)                    # [mbh,mbw,16]
    best = jnp.min(cost, axis=0)
    # every block inherits its unit's argmin
    sel_blk = jnp.take_along_axis(sel_slot, uid, axis=-1)  # [mbh,mbw,16]
    offs = jnp.asarray(np.array(offsets, np.int32))
    oy_sel = offs[sel_blk, 0]
    ox_sel = offs[sel_blk, 1]
    mvz = _sp4_to_z(mv4fp, mbh, mbw)                       # [mbh,mbw,16,2]
    mvq = jnp.stack([4 * mvz[..., 0] + ox_sel,
                     4 * mvz[..., 1] + oy_sel], axis=-1)
    r_idx = (oy_sel + 6) * 13 + (ox_sel + 6)
    mv4 = _z_to_sp4(mvq, mbh, mbw)
    r_idx4 = _z_to_sp4(r_idx[..., None], mbh, mbw)[..., 0].reshape(n4)
    valid = uid == jnp.arange(16)                          # slot exists
    mb_cost = jnp.sum(jnp.where(valid, best, 0), axis=-1)  # [mbh,mbw]
    return mv4, r_idx4, mb_cost


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate"))
def stego_costs_sub(cur_y, blocks4, wht4, r_idx4, part, sub_type, mv4,
                    mvp_s, cost_mv, qp, mbh: int, mbw: int,
                    decimate: bool = True):
    """Sub-partition-aware x264_ih_get_mv_cost (analyse.c:2391-2550):
    RCA alternative-MV cost for every partition unit including the
    sub-8x8 shapes (the reference's D_L0_8x4/4x8/4x4 capture cases,
    analyse.c:3518-3689), batched over unit SLOTS.

    Slot convention: a unit's slot = z index of its first member 4x4
    block (unit_id_map); up to 16 slots/MB. blocks4/wht4: [169,N4,...]
    per-4x4 qpel tables; mvp_s: [mbh,mbw,16,2] per-slot MVPs.
    Returns (rho [mbh,mbw,16] f32, alt_mv [mbh,mbw,16,2], valid
    [mbh,mbw,16])."""
    from .inter import luma_p_encode
    from .cavlc import LUMA_SCAN
    from ..stego.cost import D_MV, D_NB, rca_decide

    n = mbh * mbw
    cur = cur_y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
               .reshape(n, 16, 16)
    uid = unit_id_map(part, sub_type).reshape(n, 16)
    mvz = _sp4_to_z(mv4, mbh, mbw).reshape(n, 16, 2)
    mvps = mvp_s.reshape(n, 16, 2)
    lsj = jnp.asarray(np.array([p[0] for p in LUMA_SCAN], np.int32))
    lsi = jnp.asarray(np.array([p[1] for p in LUMA_SCAN], np.int32))

    def didx(dy, dx):
        return dy * 13 + dx

    def blocks_at(delta):
        idx4 = r_idx4 + didx(*delta)
        b4 = QT.select_rows(blocks4, idx4).astype(jnp.int32)  # [N4,4,4]
        return _sp4_to_z(b4.reshape(4 * mbh, 4 * mbw, 4, 4),
                         mbh, mbw).reshape(n, 16, 4, 4)

    def mb_pred(blkz):
        """[n,16,4,4] z-order blocks -> [n,16,16] MB preds."""
        sp = _z_to_sp4(blkz.reshape(mbh, mbw, 16, 4, 4), mbh, mbw)
        pl = sp.transpose(0, 2, 1, 3).reshape(16 * mbh, 16 * mbw)
        return pl.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3) \
                 .reshape(n, 16, 16)

    def wht_blocks_z(rec):
        """[n,16,16] MB recon -> [n,16,16] per-4x4 flat WHT (z order)."""
        r44 = rec.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
        rz = r44[:, lsj, lsi]                         # [n,16,4,4]
        return wht4_flat(rz)

    sel_whtz = {}
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            w = QT.select_rows(wht4, r_idx4 + didx(dy, dx))  # [N4,16]
            sel_whtz[(dy, dx)] = _sp4_to_z(
                w.reshape(4 * mbh, 4 * mbw, 16),
                mbh, mbw).reshape(n, 16, 16)

    blk0z = blocks_at((0, 0))                          # [n,16,4,4]
    cand_blkz = [blocks_at((int(D_MV[c][1]), int(D_MV[c][0])))
                 for c in range(12)]
    _, rec0_shared = luma_p_encode(cur, mb_pred(blk0z), qp, decimate)
    w0 = wht_blocks_z(rec0_shared)

    out_rho, out_alt, out_valid = [], [], []
    for s in range(16):
        mem = uid == s                                 # [n,16]
        valid_u = mem[:, s]                            # slot exists
        mvu = mvz[:, s]                                # unit MV
        mvpu = mvps[:, s]

        def mvcost(dq):
            qx = mvu[:, 0] + dq[1]
            qy = mvu[:, 1] + dq[0]
            return (cost_mv[jnp.abs(qx - mvpu[:, 0])]
                    + cost_mv[jnp.abs(qy - mvpu[:, 1])])

        def probes(wrec_z, center):
            outp = []
            for k in range(9):
                dk = (int(D_NB[k][1]), int(D_NB[k][0]))
                d = (center[0] + dk[0], center[1] + dk[1])
                wt = sel_whtz[d]                       # [n,16,16]
                per_blk = satd_flat4(wrec_z, wt)       # [n,16]
                sat = jnp.sum(per_blk * mem, axis=1)
                outp.append(sat + mvcost(d))
            return jnp.stack(outp, axis=1)             # [n,9]

        def encode_cand(c):
            m4 = mem[:, :, None, None]
            blkz = jnp.where(m4, cand_blkz[c], blk0z)
            _, rec = luma_p_encode(cur, mb_pred(blkz), qp, decimate)
            return wht_blocks_z(rec)

        nb0 = probes(w0, (0, 0))
        orig_cost = nb0[:, 8]
        orig_opt = jnp.min(nb0, axis=1) >= orig_cost

        cand_cost, cand_opt = [], []
        for c in range(12):
            dc = (int(D_MV[c][1]), int(D_MV[c][0]))
            wc = encode_cand(c)
            nbc = probes(wc, dc)
            cand_cost.append(nbc[:, 8])
            cand_opt.append(jnp.min(nbc, axis=1) >= nbc[:, 8])
        cand_cost = jnp.stack(cand_cost, axis=1)
        cand_opt = jnp.stack(cand_opt, axis=1)

        rho, sel_delta, _flags = rca_decide(nb0, orig_cost, orig_opt,
                                            cand_cost, cand_opt)
        out_rho.append(rho)
        out_alt.append(mvu + sel_delta)
        out_valid.append(valid_u)

    rho = jnp.stack(out_rho, axis=1).reshape(mbh, mbw, 16)
    alt = jnp.stack(out_alt, axis=1).reshape(mbh, mbw, 16, 2)
    valid = jnp.stack(out_valid, axis=1).reshape(mbh, mbw, 16)
    return rho, alt, valid


def gather_windows4_mref(planes_r, mv4fp, ref4, mbh: int, mbw: int):
    """Multi-ref twin of gather_windows4_jnp: planes_r [R,4,Hp,Wp],
    ref4 [4mbh,4mbw] per-4x4 DPB index (block's 8x8 ref repeated)."""
    n4 = 16 * mbh * mbw
    bys = (jnp.arange(n4) // (4 * mbw)) * 4
    bxs = (jnp.arange(n4) % (4 * mbw)) * 4
    mvf = mv4fp.reshape(n4, 2)
    ys = bys + mc.PAD - QT.MARGIN + mvf[:, 1]
    xs = bxs + mc.PAD - QT.MARGIN + mvf[:, 0]
    W4 = 12
    r = ref4.reshape(n4)[:, None, None, None]
    pp = jnp.arange(4)[None, :, None, None]
    yy = (ys[:, None] + jnp.arange(W4))[:, None, :, None]
    xx = (xs[:, None] + jnp.arange(W4))[:, None, None, :]
    return planes_r[r, pp, yy, xx]                 # [n4,4,12,12]


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel", "num_ref",
                                             "allow_parts"))
def analyse_p_frame_sub_mref(y, refs_luma, n_valid, prev_mv, rng: int,
                             mbh: int, mbw: int, lam, subpel: int,
                             num_ref: int, allow_parts: bool = True):
    """Multi-reference sub-8x8-aware P analysis (the mixed-ref p8x8
    rule, analyse.c:1291-1370 generalized to sub shapes): the MB-level
    shapes merge per unit across the DPB like the parts path; each
    8x8's reference is its own masked argmin, and the sub-split
    decision inside that block evaluates THAT reference's per-4x4
    costs (H.264 codes one ref per sub-MB, so sub units cannot mix
    refs within an 8x8). Returns (part, sub_type, mv4 qpel, ref8,
    r_idx4, blocks4, wht4, mb_cost)."""
    ref_bits = te_ref_bits(num_ref)
    sts = [fullpel_search_sub.__wrapped__(
        y, refs_luma[r, 0], prev_mv >> 2, rng, mbh, mbw, lam)
        for r in range(num_ref)]
    stm = merge_ref_states(sts, lam, ref_bits, n_valid)
    r8blk_z = stm["r8"]                             # [mbh,mbw,4] z
    # gather the block-ref's sub costs/mvs + the block's te bits so
    # the split decision competes on equal ref-cost footing with c8
    rb = jnp.asarray(ref_bits)[r8blk_z] * lam       # [mbh,mbw,4]
    for ck, nsub in (("c84", 2), ("c48", 2), ("c44", 4)):
        mk = "mv" + ck[1:]
        cs = jnp.stack([st[ck] for st in sts])      # [R,mbh,mbw,4,S]
        ms = jnp.stack([st[mk] for st in sts])
        sel = r8blk_z[None, :, :, :, None]
        stm[ck] = jnp.take_along_axis(cs, sel, axis=0)[0] \
            + rb[..., None]
        stm[mk] = jnp.take_along_axis(
            ms, sel[..., None], axis=0)[0]
    part, sub_type, mv4fp = decide_partition_sub.__wrapped__(
        stm, mbh, mbw, lam, allow_parts)
    ref8 = ref8_from_partition(stm, part, mbh, mbw)  # [2mbh,2mbw]
    ref4 = jnp.repeat(jnp.repeat(ref8, 2, 0), 2, 1)  # [4mbh,4mbw]
    windows = gather_windows4_mref(
        refs_luma.astype(jnp.uint8), mv4fp, ref4, mbh, mbw)
    blocks4 = block_table4(windows)
    wht4 = wht4_flat(blocks4).astype(jnp.int16)
    mv4, r_idx4, mb_cost = subpel_sub.__wrapped__(
        y, wht4, part, sub_type, mv4fp, prev_mv, mbh, mbw, lam, subpel)
    return part, sub_type, mv4, ref8, r_idx4, blocks4, wht4, mb_cost


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel", "allow_parts"))
def analyse_p_frame_sub(y, ref_luma, prev_mv, rng: int, mbh: int,
                        mbw: int, lam, subpel: int,
                        allow_parts: bool = True):
    """Fused sub-8x8-aware P analysis: full-pel all-shapes scan (incl.
    per-4x4 sub shapes) -> two-level partition decision -> per-4x4
    windows -> qpel tables -> per-unit subpel. Returns (part, sub_type,
    mv4 qpel, r_idx4, blocks4, wht4, mb_cost)."""
    st = fullpel_search_sub.__wrapped__(
        y, ref_luma[0], prev_mv >> 2, rng, mbh, mbw, lam)
    part, sub_type, mv4fp = decide_partition_sub.__wrapped__(
        st, mbh, mbw, lam, allow_parts)
    windows = gather_windows4_jnp(
        ref_luma.astype(jnp.uint8), mv4fp, mbh, mbw)
    blocks4 = block_table4(windows)               # uint8 [169,N4,4,4]
    wht4 = wht4_flat(blocks4).astype(jnp.int16)   # [169,N4,16]
    mv4, r_idx4, mb_cost = subpel_sub.__wrapped__(
        y, wht4, part, sub_type, mv4fp, prev_mv, mbh, mbw, lam, subpel)
    return part, sub_type, mv4, r_idx4, blocks4, wht4, mb_cost


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel", "allow_parts"))
def analyse_p_frame_parts(y, ref_luma, prev_mv, rng: int, mbh: int,
                          mbw: int, lam, subpel: int,
                          allow_parts: bool = True):
    """Fused partition-aware P analysis: full-pel all-shapes scan ->
    partition decision -> per-8x8 windows -> qpel tables -> per-unit
    subpel. Returns (part [mbh,mbw], mv8 [2mbh,2mbw,2] qpel, r_idx8,
    blocks8 [169,N8,8,8], wht8)."""
    st = FP.fullpel_parts(y, ref_luma[0], prev_mv >> 2, rng, mbh, mbw,
                          lam)
    part, mvfp8 = decide_partition.__wrapped__(
        st, mbh, mbw, lam, allow_parts)
    windows = gather_windows8_jnp(
        ref_luma.astype(jnp.uint8), mvfp8, mbh, mbw)
    blocks8 = block_table8(windows)                # uint8
    # WHT of uint8 blocks fits int16 (|coef| <= 16*255); flat [.., 64]
    # layout; consumers promote to int32 on use
    wht8 = wht8_flat(blocks8).astype(jnp.int16)
    mv8, r_idx8, mb_cost = subpel_parts.__wrapped__(
        y, wht8, part, mvfp8, prev_mv, mbh, mbw, lam, subpel)
    return part, mv8, r_idx8, blocks8, wht8, mb_cost


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel", "decimate",
                                             "trellis", "trans8", "rd",
                                             "full_pass1"))
def p_stage1_stego(y, u, v, ref_luma, ref_u, ref_v, prev_mv, qp, qpc,
                   lam, cost_mv, rng: int, mbh: int, mbw: int,
                   subpel: int, decimate: bool,
                   trellis: bool, nr_offset=None, extra=None,
                   trans8: bool = False, rd: bool = False,
                   full_pass1: bool = False):
    """Fused P-frame stage 1 for the stego serving path: analyse ->
    pass-1 encode -> device scan (MVP/P_SKIP/skip) -> per-unit RCA
    stego costs, ONE dispatch. Everything the host STC step needs
    comes back as ONE packed f32 array (all packed quantities are
    small integers or native f32, exact in f32):

      [part n | mv8 8n | cbp_l n | cbp_c n | skip n | alt 8n | rho 4n]

    The per-8x8 qpel tables and the pass-1 result stay device-resident
    for the re-encode: one blocking device-to-host pull per frame
    instead of a meta pull, a host scan and a second rho pull."""
    from . import inter as INTER
    from .scan_device import _scan_p_device

    part, mv8, r_idx8, blocks8, wht8, _mb_cost = \
        analyse_p_frame_parts.__wrapped__(
            y, ref_luma, prev_mv, rng, mbh, mbw, lam, subpel)
    # full_pass1: materialize levels/recon so the pass-2 re-encode can
    # be incremental (inter_incr.py) — the cbp-only DCE saves little
    # (the DCT/quant dominates, not the level/recon stores)
    res = INTER.encode_p_frame_device8.__wrapped__(
        y, u, v, ref_luma, ref_u, ref_v, mv8, qp, qpc, mbh, mbw,
        decimate, None, trellis, nr_offset, cbp_only=not full_pass1,
        trans8=trans8, rd=rd)
    cbp_l = res["cbp_luma"].astype(jnp.int32)
    cbp_c = res["cbp_chroma"].astype(jnp.int32)
    skip, _mvd, mvp_u, _ = _scan_p_device(part, mv8, cbp_l, cbp_c,
                                          mbh, mbw)
    rho, alt, _valid = stego_costs_parts.__wrapped__(
        y, blocks8, wht8, r_idx8, part, mv8, mvp_u, cost_mv, qp,
        mbh, mbw, decimate)
    f32 = jnp.float32
    pieces = [
        part.reshape(-1).astype(f32),
        mv8.reshape(-1).astype(f32),
        cbp_l.reshape(-1).astype(f32),
        cbp_c.reshape(-1).astype(f32),
        skip.reshape(-1).astype(f32),
        alt.reshape(-1).astype(f32),
        rho.reshape(-1).astype(f32),
    ]
    if extra is not None:
        # e.g. the lookahead's [2] (cost_i, cost_p): the slice-type
        # decision rides this pull instead of its own round trip
        # (speculative-P; f32 rounding of the lowres sums is ~1e-7
        # relative, far inside the scenecut threshold's granularity)
        pieces.append(extra.reshape(-1).astype(f32))
    packed = jnp.concatenate(pieces)
    return packed, res, blocks8, wht8, r_idx8


# ---------------------------------------------------------------------------
# Deep-pipelined serving path (Params.pipeline_deep): the per-frame
# blocking pull + host STC sit on the critical path of the standard
# pipelined driver (the device idles across them). The deep driver
# speculates the NEXT frame's analysis against the PREVIOUS frame's
# PASS-1 (pre-flip) reconstruction, so the device is busy with frame
# N+1's analysis while frame N's packed pull and STC run. After
# frame N's flips land, a PATCH re-runs frame N+1's pass-1 encode
# against the TRUE (post-flip, deblocked) reference — levels, cbp,
# skip and the packed stego inputs are therefore exact; the only
# divergence from the canonical path is the ANALYSIS (mv/partition
# choices and the probe SATD maps), which saw the pre-flip recon.
# The bitstream stays conformant, forced pass-2 MVs keep the blind
# extraction contract, and x264 itself ships analysis-divergent speed
# modes (--non-deterministic; sliced-threads MV range cuts).
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel", "decimate"))
def p_stage1_spec(y, ref_luma, prev_mv, qp, lam, rng: int, mbh: int,
                  mbw: int, subpel: int, decimate: bool):
    """Speculative analyse half of the deep pipeline: partition
    decision + subpel MVs + the mvp-independent RCA probe SATD maps,
    all against the (possibly pre-flip) reference. No pass-1 encode,
    no scan, no packing — those happen post-patch (p_patch_pack).
    Returns (part, mv8, SK, SP, sc8), all device-resident."""
    part, mv8, r_idx8, blocks8, wht8, _mb_cost = \
        analyse_p_frame_parts.__wrapped__(
            y, ref_luma, prev_mv, rng, mbh, mbw, lam, subpel)
    SK, SP, sc8 = probe_maps_xla(y, blocks8, wht8, r_idx8, qp,
                                 mbh, mbw, decimate)
    return part, mv8, SK, SP, sc8


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate",
                                             "trellis"))
def p_patch_pack(y, u, v, ref_luma, ref_u, ref_v, part, mv8, SK, SP,
                 sc8, qp, qpc, cost_mv, extra, mbh: int, mbw: int,
                 decimate: bool, trellis: bool, nr_offset=None):
    """Patch half of the deep pipeline: once the previous frame's
    flips are applied and its TRUE deblocked reference exists, re-run
    this frame's pass-1 encode against it (a full frame encode — the
    conservative superset of the flip-dirty MB set), derive scan/skip from the patched cbp,
    finish the RCA costs with the true-ref MVPs, and assemble the SAME
    packed layout as p_stage1_stego. Returns (packed, res)."""
    from . import inter as INTER
    from .scan_device import _scan_p_device

    res = INTER.encode_p_frame_device8.__wrapped__(
        y, u, v, ref_luma, ref_u, ref_v, mv8, qp, qpc, mbh, mbw,
        decimate, None, trellis, nr_offset, cbp_only=False,
        trans8=False, rd=False)
    cbp_l = res["cbp_luma"].astype(jnp.int32)
    cbp_c = res["cbp_chroma"].astype(jnp.int32)
    skip, _mvd, mvp_u, _ = _scan_p_device(part, mv8, cbp_l, cbp_c,
                                          mbh, mbw)
    rho, alt, _valid = probe_combine(SK, SP, sc8, part, mv8, mvp_u,
                                     cost_mv, mbh, mbw, decimate)
    f32 = jnp.float32
    pieces = [
        part.reshape(-1).astype(f32),
        mv8.reshape(-1).astype(f32),
        cbp_l.reshape(-1).astype(f32),
        cbp_c.reshape(-1).astype(f32),
        skip.reshape(-1).astype(f32),
        alt.reshape(-1).astype(f32),
        rho.reshape(-1).astype(f32),
        extra.reshape(-1).astype(f32),
    ]
    packed = jnp.concatenate(pieces)
    return packed, res


# ---------------------------------------------------------------------------
# Partition-shape RD re-rank (--rd >= 1)
#
# Reference: x264_mb_analyse_p_rd (analyse.c:2117-2186) — after the
# SATD cascade, every partition shape whose SATD total is within 5/4 of
# the best is FULLY encoded and re-ranked by SSD + lambda2 * exact bits
# (x264_rd_cost_mb, rdo.c:139). Batched redesign: each shape becomes one
# uniform-part frame probe (subpel refine + full device encode + device
# scan for exact per-unit mvds + exact CAVLC residual bits), and the
# per-MB argmin mixes shapes. Divergences from the serial original,
# both documented PARITY.md-style: per-unit MVPs come from the probe's
# own uniform-shape field rather than the mixed final cache (the
# batched analog of the rdo.c FIXME about stale NNZ), and nC starts at
# 0 like every other rd estimator in ops/rdcost.py.
# ---------------------------------------------------------------------------

def rd_rerank_parts(y, u, v, ref_luma, ref_u, ref_v, prev_mv, qp, qpc,
                    rng: int, mbh: int, mbw: int, lam, subpel: int,
                    decimate: bool, trellis: bool, nr_offset,
                    trans8: bool):
    """Returns (part, mv8, r_idx8, blocks8, wht8, mb_cost) — the same
    contract as analyse_p_frame_parts, with `part` re-ranked by exact
    RD and `mv8` the winning shapes' refined unit MVs."""
    from . import inter as P
    from .scan_device import scan_p_device

    st = jax.jit(FP.fullpel_parts, static_argnums=(3, 4, 5))(
        y, ref_luma[0], prev_mv >> 2, rng, mbh, mbw, lam)

    hdr = jnp.asarray(_HDR_BITS)
    tot = jnp.stack([
        st["c16"] + lam * hdr[0],
        st["c16x8"].sum(-1) + lam * hdr[1],
        st["c8x16"].sum(-1) + lam * hdr[2],
        st["c8"].sum(-1) + lam * hdr[3],
    ])                                              # [4,mbh,mbw]
    # analyse.c:2119 thresh = i_satd * 5/4 (candidate gate)
    thresh = (tot.min(0) * 5) // 4

    mv_by_part = jnp.stack([
        jnp.broadcast_to(st["mv16"][:, :, None, :], (mbh, mbw, 4, 2)),
        st["mv16x8"][:, :, [0, 0, 1, 1], :],
        st["mv8x16"][:, :, [0, 1, 0, 1], :],
        st["mv8"],
    ])                                              # [4,mbh,mbw,4,2]

    costs, mv8s, aux = [], [], []
    for s in range(4):
        part_s = jnp.full((mbh, mbw), s, jnp.int32)
        mvsp = mv_by_part[s].reshape(mbh, mbw, 2, 2, 2) \
            .transpose(0, 2, 1, 3, 4).reshape(2 * mbh, 2 * mbw, 2)
        windows = gather_windows8_jnp(ref_luma.astype(jnp.uint8),
                                      mvsp, mbh, mbw)
        blocks8 = block_table8(windows)
        wht8 = wht8_flat(blocks8).astype(jnp.int16)
        mv8_s, r_idx_s, cost_s = subpel_parts(
            y, wht8, part_s, mvsp, prev_mv, mbh, mbw, lam, subpel)
        res = P.encode_p_frame_device8(
            y, u, v, ref_luma, ref_u, ref_v, mv8_s, qp, qpc, mbh, mbw,
            decimate=decimate, trellis=trellis, nr_offset=nr_offset,
            trans8=trans8, rd=True)
        _, mvd_s, _, _ = scan_p_device(part_s, mv8_s,
                                       res["cbp_luma"],
                                       res["cbp_chroma"], mbh, mbw)
        rd = P.rd_coded_cost(
            y, u, v, res["luma_lev"], res["chroma_dc"],
            res["chroma_ac"], res["recon_y"], res["recon_u"],
            res["recon_v"], mvd_s, part_s, qp, mbh, mbw)
        # int32-safe sentinel (jax_enable_x64 is off; a 16x16 MB's max
        # SSD+bits cost is ~6e7, well under 2^30)
        gated = jnp.where(tot[s] <= thresh, rd.astype(jnp.int32),
                          jnp.int32(1) << 30)
        costs.append(gated)
        mv8s.append(mv8_s)
        aux.append((r_idx_s, blocks8, wht8, cost_s))

    allc = jnp.stack(costs)                         # [4,mbh,mbw]
    part = jnp.argmin(allc, axis=0).astype(jnp.int32)
    sel8 = jnp.repeat(jnp.repeat(part, 2, 0), 2, 1)  # [2mbh,2mbw]
    mv8 = jnp.take_along_axis(
        jnp.stack(mv8s), sel8[None, :, :, None], axis=0)[0]
    # downstream tables (stego probes / rd-2 refine) from the winning
    # shapes: per-8x8 select over the per-shape tables
    n8 = 4 * mbh * mbw
    sel_n8 = sel8.reshape(2 * mbh, 2 * mbw).reshape(-1)
    r_idx8 = jnp.take_along_axis(
        jnp.stack([a[0] for a in aux]), sel_n8[None, :], axis=0)[0]
    blocks8 = jnp.take_along_axis(
        jnp.stack([a[1] for a in aux]),
        sel_n8[None, None, :, None, None], axis=0)[0]
    wht8 = jnp.take_along_axis(
        jnp.stack([a[2] for a in aux]), sel_n8[None, None, :, None],
        axis=0)[0]
    mb_cost = jnp.take_along_axis(
        jnp.stack([a[3] for a in aux]), part[None], axis=0)[0]
    return part, mv8, r_idx8, blocks8, wht8, mb_cost


# ---------------------------------------------------------------------------
# Sub-8x8 RD re-rank (--rd >= 1 with --p4x4)
#
# Reference: the P_8x8 branch of x264_mb_analyse_p_rd
# (analyse.c:2150-2180): per 8x8 block, every sub_mb_type whose SATD
# is within 5/4 of the block's best is cached and re-ranked by the
# partial RD cost x264_rd_cost_part (rdo.c: SSD of the partition's
# luma+chroma + lambda2 * the partition's bits); the MB then competes
# against 16x16/16x8/8x16 by full-MB RD (x264_rd_cost_mb) exactly like
# the pure-parts path. Batched redesign: each of the 7 candidates
# (3 MB shapes + 4 uniform sub shapes) becomes one uniform-shape frame
# probe (subpel refine + full device encode); per-8x8 partial RD is a
# batched decomposition of the frame encode (per-4x4 CAVLC bits
# grouped by 8x8, SSD over the 8x8's luma + its chroma 4x4s), and one
# more mixed-subtype encode prices the recomposed P_8x8 frame exactly.
# Probe MVPs come from the probe's own uniform field (scan_p_device)
# with every sub unit inheriting its 8x8's MVP — the batched analog of
# the rdo.c stale-cache FIXME; nC starts at 0 like every rd estimator
# in ops/rdcost.py.
# ---------------------------------------------------------------------------


def _z44_to_sp(mv44, mbh, mbw):
    """[mbh,mbw,4(blk z),4(sub z),2] -> [4mbh,4mbw,2] spatial."""
    return mv44.reshape(mbh, mbw, 2, 2, 2, 2, 2) \
               .transpose(0, 2, 4, 1, 3, 5, 6) \
               .reshape(4 * mbh, 4 * mbw, 2)


def _bits_per8(luma_lev, chroma_ac, n):
    """Residual CAVLC bits grouped by 8x8 z block [n,4] int32: the
    8x8's 4 luma 4x4s + its colocated chroma AC 4x4 per plane (chroma
    DC is MB-level syntax and near subtype-invariant, so it cancels in
    the per-block argmin). luma_lev [mbh,mbw,256] / chroma_ac
    [mbh,mbw,128] in the _finish_p4 packing (by,bx block grid major)."""
    from ..ops.rdcost import cavlc_block_bits
    from ..ops.transform import ZIGZAG_4x4
    zz = jnp.asarray(ZIGZAG_4x4)
    blk = luma_lev.reshape(n * 16, 4, 4).astype(jnp.int32)
    bz = blk[:, zz[:, 0], zz[:, 1]]
    bl = cavlc_block_bits(bz, jnp.zeros(n * 16, jnp.int32)) \
        .reshape(n, 4, 4)                          # [n, by, bx]
    per8 = bl.reshape(n, 2, 2, 2, 2).sum((2, 4)).reshape(n, 4)
    ca = chroma_ac.reshape(n, 2, 4, 4, 4).astype(jnp.int32)
    caz = ca[..., zz[:, 0], zz[:, 1]][..., 1:].reshape(n * 8, 15)
    cb = cavlc_block_bits(caz, jnp.zeros(n * 8, jnp.int32),
                          max_coeff=15).reshape(n, 2, 4)
    return per8 + cb.sum(1)


def _ssd_per8(y, u, v, res, mbh, mbw):
    """SSD grouped by 8x8 z block [n,4] int32: the 8x8 luma region +
    its 4x4 chroma region per plane (the x264_rd_cost_part measure)."""
    n = mbh * mbw

    def group(plane, rec, b):
        t = lambda p: p.reshape(mbh, 2 * b, mbw, 2 * b) \
            .transpose(0, 2, 1, 3).reshape(n, 2 * b, 2 * b)
        d = t(rec).astype(jnp.int32) - t(plane).astype(jnp.int32)
        return (d * d).reshape(n, 2, b, 2, b).sum((2, 4)) \
            .reshape(n, 4)

    return (group(y, res["recon_y"], 8)
            + group(u, res["recon_u"], 4)
            + group(v, res["recon_v"], 4))


@functools.partial(jax.jit, static_argnames=(
    "rng", "mbh", "mbw", "subpel", "decimate", "trellis"))
def rd_rerank_sub(y, u, v, ref_luma, ref_u, ref_v, prev_mv, qp, qpc,
                  rng: int, mbh: int, mbw: int, lam, subpel: int,
                  decimate: bool, trellis: bool, nr_offset):
    """Same contract as analyse_p_frame_sub, with `part` re-ranked by
    exact full-MB RD, `sub_type` re-ranked by per-8x8 partial RD and
    `mv4` the winning shapes' refined unit MVs."""
    from . import inter as P
    from .scan_device import scan_p_device
    from ..ops.rdcost import se_len

    n = mbh * mbw
    lam2 = jnp.asarray(P.LAMBDA2_TAB)[qp].astype(jnp.int32)
    st = fullpel_search_sub.__wrapped__(
        y, ref_luma[0], prev_mv >> 2, rng, mbh, mbw, lam)

    # SATD gates (full-pel totals, like rd_rerank_parts)
    shdr = jnp.asarray(_SUB_HDR_BITS)
    sub_tot = jnp.stack([
        st["c8"] + lam * shdr[0],
        st["c84"].sum(-1) + lam * shdr[1],
        st["c48"].sum(-1) + lam * shdr[2],
        st["c44"].sum(-1) + lam * shdr[3],
    ])                                            # [4(sub),mbh,mbw,4]
    sub_thresh = (sub_tot.min(0) * 5) // 4
    hdr = jnp.asarray(_HDR_BITS_SUB)
    tot = jnp.stack([
        st["c16"] + lam * hdr[0],
        st["c16x8"].sum(-1) + lam * hdr[1],
        st["c8x16"].sum(-1) + lam * hdr[2],
        sub_tot.min(0).sum(-1) + lam * hdr[3],
    ])                                            # [4(part),mbh,mbw]
    mb_thresh = (tot.min(0) * 5) // 4

    # candidate full-pel per-4x4 fields (z44 layout)
    b44 = (mbh, mbw, 4, 4, 2)
    mv_cands44 = [
        jnp.broadcast_to(st["mv16"][:, :, None, None, :], b44),
        jnp.broadcast_to(st["mv16x8"][:, :, [0, 0, 1, 1], None, :],
                         b44),
        jnp.broadcast_to(st["mv8x16"][:, :, [0, 1, 0, 1], None, :],
                         b44),
        jnp.broadcast_to(st["mv8"][:, :, :, None, :], b44),
        st["mv84"][:, :, :, [0, 1, 0, 1], :][:, :, :, [0, 2, 1, 3], :],
        st["mv48"][:, :, :, [0, 1, 0, 1], :],
        st["mv44"],
    ]

    def probe(ci):
        """One uniform-shape frame probe: subpel + encode + scan."""
        part_c = jnp.full((mbh, mbw), min(ci, 3), jnp.int32)
        subt_c = jnp.full((mbh, mbw, 4), max(ci - 3, 0), jnp.int32)
        mv4fp = _z44_to_sp(mv_cands44[ci], mbh, mbw)
        windows = gather_windows4_jnp(ref_luma.astype(jnp.uint8),
                                      mv4fp, mbh, mbw)
        wht4 = wht4_flat(block_table4(windows)).astype(jnp.int16)
        mv4_c, r_idx4_c, mb_cost_c = subpel_sub.__wrapped__(
            y, wht4, part_c, subt_c, mv4fp, prev_mv, mbh, mbw, lam,
            subpel)
        res = P.encode_p_frame_device4.__wrapped__(
            y, u, v, ref_luma, ref_u, ref_v, mv4_c, qp, qpc, mbh, mbw,
            decimate, None, trellis, nr_offset)
        _, mvd_c, mvp_c, _ = scan_p_device(
            part_c, mv4_c[::2, ::2], res["cbp_luma"],
            res["cbp_chroma"], mbh, mbw)
        return mv4_c, r_idx4_c, mb_cost_c, res, mvd_c, mvp_c

    # int32-safe sentinel (jax_enable_x64 is off; a 16x16 MB's
    # max SSD+bits cost is ~6e7, well under 2^30)
    BIG = jnp.int32(1) << 30
    shape_rd, cand_fields = [], []
    for ci in range(3):
        mv4_c, r_idx4_c, mb_cost_c, res, mvd_c, _ = probe(ci)
        rd = P.rd_coded_cost(
            y, u, v, res["luma_lev"], res["chroma_dc"],
            res["chroma_ac"], res["recon_y"], res["recon_u"],
            res["recon_v"], mvd_c,
            jnp.full((mbh, mbw), ci, jnp.int32), qp, mbh, mbw)
        shape_rd.append(jnp.where(tot[ci] <= mb_thresh,
                                  rd.astype(jnp.int32), BIG))
        cand_fields.append((mv4_c, r_idx4_c, mb_cost_c))

    # per-8x8 partial RD of the 4 uniform sub probes
    slots = jnp.arange(4)
    sub_part_rd, sub_fields = [], []
    for t in range(4):
        mv4_c, r_idx4_c, mb_cost_c, res, _, mvp_c = probe(3 + t)
        bits8 = _bits_per8(res["luma_lev"], res["chroma_ac"], n)
        ssd8 = _ssd_per8(y, u, v, res, mbh, mbw)
        # mvd bits: each sub unit against its 8x8's probe MVP
        mvz = _sp4_to_z(mv4_c, mbh, mbw).reshape(n, 4, 4, 2)
        d = mvz - mvp_c.reshape(n, 4, 1, 2)
        is_unit = (jnp.asarray(_SUB_UNIT_ID)[t][None, None]
                   == slots[None, None, :])       # [1,1,4] slot mask
        mvd_bits = jnp.sum(jnp.where(
            is_unit, se_len(d[..., 0]) + se_len(d[..., 1]), 0),
            axis=2)                                      # [n,4]
        bits = bits8 + mvd_bits + jnp.int32(int(_SUB_HDR_BITS[t]))
        prd = (ssd8 + ((lam2 * bits + 128) >> 8)).reshape(mbh, mbw, 4)
        sub_part_rd.append(jnp.where(sub_tot[t] <= sub_thresh,
                                     prd, BIG))
        sub_fields.append((mv4_c, r_idx4_c, mb_cost_c))

    sub_rd = jnp.stack(sub_part_rd)                 # [4,mbh,mbw,4]
    sub_type = jnp.argmin(sub_rd, axis=0).astype(jnp.int32)

    # recompose the mixed-subtype P_8x8 frame and price it exactly
    sub44 = jnp.stack([_sp4_to_z(f[0], mbh, mbw) for f in sub_fields])
    sel44 = jnp.repeat(sub_type, 4, axis=-1).reshape(mbh, mbw, 16)
    mv4_mixz = jnp.take_along_axis(
        sub44, sel44[None, :, :, :, None], axis=0)[0]
    mv4_mix = _z_to_sp4(mv4_mixz, mbh, mbw)
    res_m = P.encode_p_frame_device4.__wrapped__(
        y, u, v, ref_luma, ref_u, ref_v, mv4_mix, qp, qpc, mbh, mbw,
        decimate, None, trellis, nr_offset)
    _, _, mvp_m, _ = scan_p_device(
        jnp.full((mbh, mbw), 3, jnp.int32), mv4_mix[::2, ::2],
        res_m["cbp_luma"], res_m["cbp_chroma"], mbh, mbw)
    bits8_m = _bits_per8(res_m["luma_lev"], res_m["chroma_ac"], n)
    mvz_m = _sp4_to_z(mv4_mix, mbh, mbw).reshape(n, 4, 4, 2)
    d_m = mvz_m - mvp_m.reshape(n, 4, 1, 2)
    subt_f = sub_type.reshape(n, 4)
    is_unit_m = (jnp.asarray(_SUB_UNIT_ID)[subt_f]
                 == slots[None, None, :])                # [n,4,4]
    mvd_bits_m = jnp.sum(jnp.where(
        is_unit_m, se_len(d_m[..., 0]) + se_len(d_m[..., 1]), 0),
        axis=(1, 2))
    sub_hdr_m = jnp.sum(jnp.asarray(_SUB_HDR_BITS)[subt_f], axis=1)
    bits_m = (bits8_m.sum(1) + mvd_bits_m + sub_hdr_m
              + jnp.int32(int(_HDR_BITS_SUB[3])))        # ue(P_8x8)
    ssd_m = _ssd_per8(y, u, v, res_m, mbh, mbw).sum(1)
    rd_mix = (ssd_m + ((lam2 * bits_m + 128) >> 8)).reshape(mbh, mbw)
    shape_rd.append(jnp.where(tot[3] <= mb_thresh, rd_mix, BIG))

    allc = jnp.stack(shape_rd)                       # [4,mbh,mbw]
    part = jnp.argmin(allc, axis=0).astype(jnp.int32)
    sub_type = jnp.where((part == 3)[..., None], sub_type, 0)

    # winner index per 4x4 block over the 7 candidates
    widx16 = jnp.where(
        (part == 3)[..., None],
        3 + jnp.repeat(sub_type, 4, axis=-1).reshape(mbh, mbw, 16),
        jnp.broadcast_to(part[..., None], (mbh, mbw, 16)))
    all_mv44 = jnp.stack(
        [_sp4_to_z(f[0], mbh, mbw) for f in cand_fields] + list(sub44))
    mv4z = jnp.take_along_axis(
        all_mv44, widx16[None, :, :, :, None], axis=0)[0]
    mv4 = _z_to_sp4(mv4z, mbh, mbw)
    all_ri = jnp.stack(
        [_sp4_to_z(f[1].reshape(4 * mbh, 4 * mbw, 1),
                   mbh, mbw)[..., 0]
         for f in cand_fields + sub_fields])
    r_idx4z = jnp.take_along_axis(all_ri, widx16[None], axis=0)[0]
    r_idx4 = _z_to_sp4(r_idx4z[..., None], mbh, mbw)[..., 0] \
        .reshape(16 * n)
    # intra-refine threshold: the winning shape's SATD cost (part 3:
    # best uniform sub candidate — a tight bound for the mixed field)
    cost3 = jnp.min(jnp.stack([f[2] for f in sub_fields]), axis=0)
    costs_by_part = jnp.stack([f[2] for f in cand_fields] + [cost3])
    mb_cost = jnp.take_along_axis(costs_by_part, part[None], axis=0)[0]

    # downstream tables at the final full-pel field (base = qpel mv
    # minus its refine offset, exact by construction of r_idx)
    offs_y = r_idx4.reshape(4 * mbh, 4 * mbw) // 13 - 6
    offs_x = r_idx4.reshape(4 * mbh, 4 * mbw) % 13 - 6
    mv4fp_fin = jnp.stack([(mv4[..., 0] - offs_x) >> 2,
                           (mv4[..., 1] - offs_y) >> 2], axis=-1)
    windows = gather_windows4_jnp(ref_luma.astype(jnp.uint8),
                                  mv4fp_fin, mbh, mbw)
    blocks4 = block_table4(windows)
    wht4 = wht4_flat(blocks4).astype(jnp.int16)
    return part, sub_type, mv4, r_idx4, blocks4, wht4, mb_cost
