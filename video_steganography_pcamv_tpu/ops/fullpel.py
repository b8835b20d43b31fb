"""Exhaustive full-pel search for all partition shapes: a Pallas kernel
for the GPU (Triton route) and the choice between it and the plain
reference.

The reference is `encoder.partition.fullpel_search_parts`: a `lax.scan`
over the (2R+1)^2 displacements in dy-major order, each step reading
the current and the shifted reference plane and updating the best
(cost, mv) of the nine partition units of every macroblock (16x16,
16x8 top/bottom, 8x16 left/right, four 8x8) with a strict `<`.

The kernel computes the same thing with the loop inside the block:

- One block owns one macroblock row and a tile of `TW` macroblocks
  (`TW` a power of two); blocks run in parallel, in no order. The last
  tile of a row is masked where `mbw` is not a multiple of `TW`.
- The current tile is loaded once as [2(by), 8, TW, 2(bx), 8] so that
  one 5-D abs-diff plus a sum over the two in-block axes gives every
  8x8 SAD of the tile; the displaced reference tile is reloaded for
  each displacement and is served from L1/L2, since neighbouring
  displacements touch almost the same bytes.
- The mv cost is precomputed outside as two lambda-weighted
  [span, mbh, mbw] tables (one per axis) with the reference's own
  table lookup, so the kernel adds two loaded vectors and reproduces
  the reference's predictor term and index arithmetic exactly.
- The best displacement is carried as its scan index; ties resolve as
  in the reference (strict `<`, dy-major order).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import mc

_BIG = 1 << 30   # the reference's initial cost


def mv_cost_tables(pred_mv_fp, rng: int, lam):
    """Lambda-weighted mv-bit tables [span, mbh, mbw] for the x and y
    components of every displacement, indexed exactly as
    fullpel_search_parts does (bits_t[4*d - 4*pred + off])."""
    from ..encoder.me import mv_bits_table
    bits_t = jnp.asarray(mv_bits_table(4 * (rng + 64)))
    off = 4 * (rng + 64)
    d = jnp.arange(-rng, rng + 1)[:, None, None]
    lam = jnp.asarray(lam, jnp.int32)
    mvx = bits_t[4 * d - 4 * pred_mv_fp[None, ..., 0] + off] * lam
    mvy = bits_t[4 * d - 4 * pred_mv_fp[None, ..., 1] + off] * lam
    return mvx.astype(jnp.int32), mvy.astype(jnp.int32)


def _fullpel_kernel(cur_ref, ref_ref, mvx_ref, mvy_ref,
                    c16_ref, i16_ref, c168_ref, i168_ref,
                    c816_ref, i816_ref, c8_ref, i8_ref, *,
                    rng: int, tw: int, mbw: int):
    r = pl.program_id(0)
    t = pl.program_id(1)
    span = 2 * rng + 1
    shape5 = (2, 8, tw, 2, 8)

    def iota(dim):
        return jax.lax.broadcasted_iota(jnp.int32, shape5, dim)

    col_mb = t * tw + iota(2)                                  # mb col
    rows = 16 * r + 8 * iota(0) + iota(1)
    cols = 16 * col_mb + 8 * iota(3) + iota(4)
    mask5 = col_mb < mbw
    cur = plgpu.load(cur_ref.at[rows, cols], mask=mask5,
                     other=0).astype(jnp.int32)

    mb = t * tw + jnp.arange(tw, dtype=jnp.int32)              # [TW]
    mmask = mb < mbw

    def unit_costs(q, mvc):
        # q: [2(by), TW, 2(bx)] 8x8 SADs; mvc: [TW]
        return (q.sum(axis=(0, 2)) + mvc,                      # 16x16
                q.sum(axis=2) + mvc[None, :],                  # 16x8
                q.sum(axis=0) + mvc[:, None],                  # 8x16
                q + mvc[None, :, None])                        # 8x8

    def dy_body(dyi, carry):
        mvy = plgpu.load(mvy_ref.at[dyi, r, mb], mask=mmask, other=0)
        rows_d = rows + (mc.PAD - rng) + dyi

        def dx_body(dxi, carry):
            costs, idxs = carry
            ref = plgpu.load(
                ref_ref.at[rows_d, cols + (mc.PAD - rng) + dxi],
                mask=mask5, other=0).astype(jnp.int32)
            q = jnp.abs(cur - ref).sum(axis=(1, 4))           # [2,TW,2]
            mvx = plgpu.load(mvx_ref.at[dxi, r, mb], mask=mmask,
                             other=0)
            i = dyi * span + dxi
            new_c, new_i = [], []
            for c, ix, u in zip(costs, idxs, unit_costs(q, mvx + mvy)):
                better = u < c
                new_c.append(jnp.where(better, u, c))
                new_i.append(jnp.where(better, i, ix))
            return tuple(new_c), tuple(new_i)

        return jax.lax.fori_loop(0, span, dx_body, carry)

    shapes = ((tw,), (2, tw), (tw, 2), (2, tw, 2))
    init = (tuple(jnp.full(s, _BIG, jnp.int32) for s in shapes),
            tuple(jnp.full(s, rng * span + rng, jnp.int32) for s in shapes))
    costs, idxs = jax.lax.fori_loop(0, span, dy_body, init)

    by2 = jax.lax.broadcasted_iota(jnp.int32, (2, tw), 0)
    mb2 = t * tw + jax.lax.broadcasted_iota(jnp.int32, (2, tw), 1)
    mbc = t * tw + jax.lax.broadcasted_iota(jnp.int32, (tw, 2), 0)
    bxc = jax.lax.broadcasted_iota(jnp.int32, (tw, 2), 1)
    by3 = jax.lax.broadcasted_iota(jnp.int32, (2, tw, 2), 0)
    mb3 = t * tw + jax.lax.broadcasted_iota(jnp.int32, (2, tw, 2), 1)
    bx3 = jax.lax.broadcasted_iota(jnp.int32, (2, tw, 2), 2)
    outs = ((c16_ref, i16_ref, (r, mb), mmask),
            (c168_ref, i168_ref, (r, by2, mb2), mb2 < mbw),
            (c816_ref, i816_ref, (r, mbc, bxc), mbc < mbw),
            (c8_ref, i8_ref, (r, by3, mb3, bx3), mb3 < mbw))
    for (c_ref, i_ref, at, m), c, ix in zip(outs, costs, idxs):
        plgpu.store(c_ref.at[at], c, mask=m)
        plgpu.store(i_ref.at[at], ix, mask=m)


# warps per block: 2 was the fastest of {2, 4, 8} with TW = 8 at 1080p,
# rng 16 on an H100 SXM (80 GB HBM3, 400 W limit)
_NUM_WARPS = 2


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw", "tw",
                                             "interpret"))
def fullpel_parts_kernel(cur_y, ref_fp, pred_mv_fp, rng: int, mbh: int,
                         mbw: int, lam=1, tw: int = 8,
                         interpret: bool = False):
    """Pallas (Triton) twin of fullpel_search_parts: same arguments,
    same result dict, bit-exact including ties. `tw` is the number of
    macroblocks per block (a power of two; 8 was the fastest of
    {4, 8, 16} on the card above)."""
    span = 2 * rng + 1
    mvx, mvy = mv_cost_tables(pred_mv_fp, rng, lam)
    i32 = jnp.int32
    out_shape = []
    for s in ((mbh, mbw), (mbh, 2, mbw), (mbh, mbw, 2), (mbh, 2, mbw, 2)):
        out_shape += [jax.ShapeDtypeStruct(s, i32)] * 2
    c16, i16, c168, i168, c816, i816, c8, i8 = pl.pallas_call(
        functools.partial(_fullpel_kernel, rng=rng, tw=tw, mbw=mbw),
        grid=(mbh, pl.cdiv(mbw, tw)),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="fullpel_parts",
    )(cur_y, ref_fp, mvx, mvy)

    def mv(i):
        return jnp.stack([i % span - rng, i // span - rng], axis=-1)

    def z8(a):       # [mbh, 2(by), mbw, 2(bx)] -> [mbh, mbw, 4] z order
        return a.transpose(0, 2, 1, 3).reshape(mbh, mbw, 4)

    return dict(
        c16=c16, mv16=mv(i16),
        c16x8=c168.transpose(0, 2, 1), mv16x8=mv(i168.transpose(0, 2, 1)),
        c8x16=c816, mv8x16=mv(i816),
        c8=z8(c8), mv8=mv(z8(i8)),
    )


def fullpel_parts(cur_y, ref_fp, pred_mv_fp, rng: int, mbh: int,
                  mbw: int, lam=1):
    """The full-pel stage as the encoder calls it: the Pallas kernel
    when the computation is lowered for a CUDA GPU, the plain scan when
    it is lowered for the CPU. The choice is made per lowering, so one
    process can run both (the GPU-vs-CPU stream comparison does)."""
    from ..encoder.partition import fullpel_search_parts

    def on_gpu(cur_y, ref_fp, pred_mv_fp, lam):
        return fullpel_parts_kernel.__wrapped__(
            cur_y, ref_fp, pred_mv_fp, rng, mbh, mbw, lam)

    def on_cpu(cur_y, ref_fp, pred_mv_fp, lam):
        return fullpel_search_parts.__wrapped__(
            cur_y, ref_fp, pred_mv_fp, rng, mbh, mbw, lam)

    return jax.lax.platform_dependent(
        cur_y, ref_fp, pred_mv_fp, jnp.asarray(lam, jnp.int32),
        cpu=on_cpu, cuda=on_gpu)
