"""Frame-tile (model-parallel) mesh axis: one frame's MB rows sharded
across cards, reference-plane halos exchanged between them.

This is the second scaling axis of the SURVEY §5 design (dp = streams
across chips; tile = MB rows of ONE stream across chips). The
reference's analog is its frame-parallel pthreads protocol, where each
thread encodes a whole frame but may only reference COMPLETED rows of
in-flight frames and therefore clamps vertical MV range
(reference doc/threads.txt:10-18). The tile axis has the
same shape: each chip encodes its row band against the previous
frame's recon, holding only its own band plus a PAD-row halo from the
neighbouring chips — so the vertical MV predictor is clamped to keep
every reference access inside the halo (the threads.txt mv-range
clamp, now set by halo width instead of row-completion lag).

Communication pattern per frame (the collective audit's expectation):
exactly TWO jax.lax.ppermute calls — one shifting each tile's bottom
edge rows down-neighbourward, one shifting top edge rows up — carrying
the packed (recon Y | U | V) halo buffer. Everything else (6-tap hpel
pyramid build, full analyse -> encode -> stego-probe stage-1) is
tile-local compute. Frame edges replicate rows like
x264_frame_expand_border (frame.c:246-310); interior tile edges read
REAL neighbour rows from the halo, so interior results are bit-exact
vs the single-chip step (tests/test_tile_mesh.py asserts equality).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import mc


def pred_clamp_fp(rng: int) -> int:
    """Max |vertical full-pel predictor| that keeps every window fetch
    inside a PAD-row halo: the full-pel scan reaches pred+rng, the
    qpel window adds its 4-px margin, and the hpel build leaves the
    outer 3 halo rows invalid (ops/mc.py hpel_planes)."""
    return max(0, mc.PAD - rng - 7)


def _halo_exchange(planes, h_y: int, h_c: int, axis: str, n_tiles: int):
    """planes: (y [Hl,W], u [Hl/2,W/2], v) int32 tile-local rows.
    Returns ((top_y, bot_y), (top_u, bot_u), (top_v, bot_v)) halo rows
    via exactly two ppermutes of ONE packed buffer each direction."""
    y, u, v = planes
    W = y.shape[1]
    Wc = u.shape[1]

    def pack(yy, uu, vv):
        return jnp.concatenate(
            [yy.reshape(-1), uu.reshape(-1), vv.reshape(-1)])

    def unpack(buf):
        ny = h_y * W
        nc = h_c * Wc
        return (buf[:ny].reshape(h_y, W),
                buf[ny:ny + nc].reshape(h_c, Wc),
                buf[ny + nc:].reshape(h_c, Wc))

    down = [(i, i + 1) for i in range(n_tiles - 1)]
    up = [(i, i - 1) for i in range(1, n_tiles)]
    # my bottom rows travel DOWN -> arrive as the receiver's top halo
    top_buf = lax.ppermute(pack(y[-h_y:], u[-h_c:], v[-h_c:]),
                           axis, down)
    # my top rows travel UP -> arrive as the receiver's bottom halo
    bot_buf = lax.ppermute(pack(y[:h_y], u[:h_c], v[:h_c]),
                           axis, up)
    t = lax.axis_index(axis)

    def edge_fix(got, local, h, is_top):
        # missing neighbour (frame edge): replicate the edge row, the
        # x264_frame_expand_border behaviour
        rep = (jnp.broadcast_to(local[:1], (h,) + local.shape[1:])
               if is_top else
               jnp.broadcast_to(local[-1:], (h,) + local.shape[1:]))
        cond = (t == 0) if is_top else (t == n_tiles - 1)
        return jnp.where(cond, rep, got)

    ty, tu, tv = unpack(top_buf)
    by, bu, bv = unpack(bot_buf)
    return ((edge_fix(ty, y, h_y, True), edge_fix(by, y, h_y, False)),
            (edge_fix(tu, u, h_c, True), edge_fix(bu, u, h_c, False)),
            (edge_fix(tv, v, h_c, True), edge_fix(bv, v, h_c, False)))


def _local_ref(y_l, u_l, v_l, halos):
    """Build the tile-local padded reference (full-pel + hpel pyramid +
    chroma), shaped exactly like mc.build_ref's output for a frame of
    the tile's height — vertical pad rows are REAL neighbour rows from
    the halo (interior) or edge replicas (frame edges)."""
    (ty, by), (tu, bu), (tv, bv) = halos
    slab_y = jnp.concatenate([ty, y_l, by], axis=0)
    slab_u = jnp.concatenate([tu, u_l, bu], axis=0)
    slab_v = jnp.concatenate([tv, v_l, bv], axis=0)
    fp = jnp.pad(slab_y.astype(jnp.int32),
                 ((0, 0), (mc.PAD, mc.PAD)), mode="edge")
    h, v, c = mc.hpel_planes(fp)
    return {
        "luma": jnp.stack([fp, h, v, c]),
        "u": jnp.pad(slab_u.astype(jnp.int32),
                     ((0, 0), (mc.PAD, mc.PAD)), mode="edge"),
        "v": jnp.pad(slab_v.astype(jnp.int32),
                     ((0, 0), (mc.PAD, mc.PAD)), mode="edge"),
    }


def p_frame_step_tiled(mesh: Mesh, y, u, v, ry, ru, rv, prev_mv,
                       qp: int, qpc: int, mbh: int, mbw: int,
                       rng: int = 8, lam=4, subpel: int = 2,
                       decimate: bool = True, with_stego: bool = True,
                       axis: str = "tile"):
    """Run the fused P-frame stage-1 (analyse -> encode -> stego probe
    costs) with the MB rows of ONE frame sharded over `mesh`'s `axis`.

    y/u/v: current planes ([16mbh,16mbw] luma); ry/ru/rv: previous
    frame's reconstruction (unpadded); prev_mv: [mbh,mbw,2] qpel
    predictor field. mbh must divide by the tile count. Returns the
    same dict as models.pipeline.p_frame_step_parts, row-sharded."""
    from ..models import pipeline

    n_tiles = mesh.shape[axis]
    assert mbh % n_tiles == 0, "MB rows must split evenly over tiles"
    mbh_l = mbh // n_tiles
    # halo rows come from the ADJACENT tile only: each tile must be at
    # least one halo tall (chroma is the binding side: 8 rows/MB row)
    assert 8 * mbh_l >= mc.PAD, \
        f"tile too short: need >= {-(-mc.PAD // 8)} MB rows per tile"
    clamp_q = 4 * pred_clamp_fp(rng)
    h_y, h_c = mc.PAD, mc.PAD

    def local(y_l, u_l, v_l, ry_l, ru_l, rv_l, pmv_l):
        halos = _halo_exchange(
            (ry_l.astype(jnp.int32), ru_l.astype(jnp.int32),
             rv_l.astype(jnp.int32)), h_y, h_c, axis, n_tiles)
        ref = _local_ref(ry_l.astype(jnp.int32), ru_l.astype(jnp.int32),
                         rv_l.astype(jnp.int32), halos)
        # vertical predictor clamp (doc/threads.txt mv-range analog):
        # keeps every window fetch inside the PAD-row halo
        pmv = pmv_l.at[..., 1].set(
            jnp.clip(pmv_l[..., 1], -clamp_q, clamp_q))
        return pipeline.p_frame_step_parts(
            y_l, u_l, v_l, ref["luma"], ref["u"], ref["v"], pmv,
            qp=qp, qpc=qpc, mbh=mbh_l, mbw=mbw, rng=rng, lam=lam,
            subpel=subpel, decimate=decimate, with_stego=with_stego)

    row = P(axis)          # leading axis sharded over tiles
    in_specs = (row,) * 7
    # every output's leading axis is a row-scaled grid -> same spec
    probe = jax.eval_shape(
        lambda: pipeline.p_frame_step_parts(
            jnp.zeros((16 * mbh_l, 16 * mbw), jnp.int32),
            jnp.zeros((8 * mbh_l, 8 * mbw), jnp.int32),
            jnp.zeros((8 * mbh_l, 8 * mbw), jnp.int32),
            jnp.zeros((4, 16 * mbh_l + 2 * mc.PAD,
                       16 * mbw + 2 * mc.PAD), jnp.int32),
            jnp.zeros((8 * mbh_l + 2 * mc.PAD,
                       8 * mbw + 2 * mc.PAD), jnp.int32),
            jnp.zeros((8 * mbh_l + 2 * mc.PAD,
                       8 * mbw + 2 * mc.PAD), jnp.int32),
            jnp.zeros((mbh_l, mbw, 2), jnp.int32),
            qp=qp, qpc=qpc, mbh=mbh_l, mbw=mbw, rng=rng, lam=lam,
            subpel=subpel, decimate=decimate, with_stego=with_stego))
    out_specs = {k: row for k in probe}

    step = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False))
    sh = NamedSharding(mesh, row)
    args = [jax.device_put(np.asarray(a), sh)
            for a in (y, u, v, ry, ru, rv, prev_mv)]
    return step(*args)


def lower_tiled_hlo(mesh: Mesh, mbh: int, mbw: int, rng: int = 8,
                    axis: str = "tile"):
    """Lower + compile the tiled step and return the optimized HLO
    text for the collective audit (tests/test_tile_mesh.py and the
    dryrun assert: collective-permutes only, no all-gathers on the hot
    path)."""
    from ..models import pipeline

    n_tiles = mesh.shape[axis]
    mbh_l = mbh // n_tiles
    clamp_q = 4 * pred_clamp_fp(rng)

    def local(y_l, u_l, v_l, ry_l, ru_l, rv_l, pmv_l):
        halos = _halo_exchange((ry_l, ru_l, rv_l), mc.PAD, mc.PAD,
                               axis, n_tiles)
        ref = _local_ref(ry_l, ru_l, rv_l, halos)
        pmv = pmv_l.at[..., 1].set(
            jnp.clip(pmv_l[..., 1], -clamp_q, clamp_q))
        return pipeline.p_frame_step_parts(
            y_l, u_l, v_l, ref["luma"], ref["u"], ref["v"], pmv,
            qp=26, qpc=26, mbh=mbh_l, mbw=mbw, rng=rng, lam=4)

    row = P(axis)
    # learn the output tree from a single-tile trace (local shapes)
    probe = jax.eval_shape(
        local,
        jnp.zeros((16 * mbh_l, 16 * mbw), jnp.int32),
        jnp.zeros((8 * mbh_l, 8 * mbw), jnp.int32),
        jnp.zeros((8 * mbh_l, 8 * mbw), jnp.int32),
        jnp.zeros((16 * mbh_l, 16 * mbw), jnp.int32),
        jnp.zeros((8 * mbh_l, 8 * mbw), jnp.int32),
        jnp.zeros((8 * mbh_l, 8 * mbw), jnp.int32),
        jnp.zeros((mbh_l, mbw, 2), jnp.int32)) \
        if n_tiles == 1 else None
    # (eval_shape inside shard_map context can't see the axis; instead
    #  trace the sharded fn directly — abstract eval needs the mesh)
    dummy = (jnp.zeros((16 * mbh, 16 * mbw), jnp.int32),
             jnp.zeros((8 * mbh, 8 * mbw), jnp.int32),
             jnp.zeros((8 * mbh, 8 * mbw), jnp.int32),
             jnp.zeros((16 * mbh, 16 * mbw), jnp.int32),
             jnp.zeros((8 * mbh, 8 * mbw), jnp.int32),
             jnp.zeros((8 * mbh, 8 * mbw), jnp.int32),
             jnp.zeros((mbh, mbw, 2), jnp.int32))
    del probe
    out_specs = {k: row for k in _TILED_OUT_KEYS}
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(row,) * 7,
                               out_specs=out_specs, check_vma=False))
    return fn.lower(*dummy).compile().as_text()


# output tree of pipeline.p_frame_step_parts (with_stego=True)
_TILED_OUT_KEYS = ("luma_lev", "cbp_luma", "cbp_chroma", "chroma_dc",
                   "chroma_ac", "recon_y", "recon_u", "recon_v",
                   "part", "mv8", "stego_rho", "stego_alt_mv",
                   "stego_valid")
