"""Flagship device pipeline: the fused P-frame analyse+embed-cost+encode
step as one jittable function, plus the multi-stream batched variant.

This is the "model" of this framework in ML terms: the computation whose
throughput defines the benchmark (BASELINE.json north star: 1080p
encode+embed fps/chip). v2 design: full-pel search -> per-MB qpel window
gather -> static 169-offset block table -> table-based subpel + RCA
stego costs (encoder/qpel_table.py, encoder/analyse2.py) -> batched
transform/encode. The partition-aware step's full-pel stage runs the
Pallas kernel when lowered for the GPU and the plain scan on the CPU
(ops/fullpel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..encoder import me as ME
from ..encoder import inter as INTER
from ..encoder import qpel_table as QT
from ..encoder import analyse2 as A2
from ..stego import cost as COST


@functools.partial(jax.jit, static_argnames=(
    "mbh", "mbw", "rng", "subpel", "decimate",
    "with_stego"))
def p_frame_step(y, u, v, ref_luma, ref_u, ref_v, prev_mv,
                 qp, qpc, mbh: int, mbw: int, rng: int,
                 lam, subpel: int = 2, decimate: bool = True,
                 with_stego: bool = True, cost_mv=None):
    """One P frame, all device stages fused.

    Returns dict with mv field, levels/cbp, recon planes, stego rho/alt.
    """
    zero_pred = jnp.zeros((mbh, mbw, 2), jnp.int32)
    mv_fp, _ = ME.fullpel_search.__wrapped__(
        y, ref_luma[0], zero_pred, rng, mbh, mbw, lam)
    windows = QT.gather_windows_jnp(ref_luma, mv_fp, mbh, mbw)

    blocks = QT.block_table(windows)
    wht = QT.wht16(blocks)
    mv_q, r_idx = A2.subpel_from_table.__wrapped__(
        y, wht, mv_fp, prev_mv, mbh, mbw, lam, subpel)

    out = INTER.encode_p_frame_device.__wrapped__(
        y, u, v, ref_luma, ref_u, ref_v, mv_q, qp, qpc, mbh, mbw,
        decimate, None)
    out["mv"] = mv_q
    if with_stego:
        if cost_mv is None:
            # qp/lam are traced (rate control): bit-exact int table from
            # a lam-independent f64 base would need x64; callers that
            # need exact parity with the host path pass cost_mv in.
            d = jnp.arange(0, 4 * 512 + 1)
            base = (2.0 * jnp.log2(d.astype(jnp.float32) + 1.0)
                    + 0.718 + (d != 0))
            cost_mv = (lam * base + 0.5).astype(jnp.int32)
        rho, alt, _ = A2.stego_costs_from_table.__wrapped__(
            y, blocks, wht, r_idx, mv_q, prev_mv, cost_mv, qp, mbh, mbw,
            decimate)
        out["stego_rho"] = rho
        out["stego_alt_mv"] = alt
    return out


def multi_stream_step(ys, us, vs, ref_lumas, ref_us, ref_vs, prev_mvs,
                      parts: bool = False, **kw):
    """vmapped p_frame_step over a leading stream axis [S, ...]."""
    base = p_frame_step_parts if parts else p_frame_step
    fn = functools.partial(base.__wrapped__, **kw)
    return jax.vmap(fn)(ys, us, vs, ref_lumas, ref_us, ref_vs, prev_mvs)


@functools.partial(jax.jit, static_argnames=(
    "mbh", "mbw", "rng", "subpel", "decimate", "with_stego"))
def p_frame_step_parts(y, u, v, ref_luma, ref_u, ref_v, prev_mv,
                       qp, qpc, mbh: int, mbw: int, rng: int,
                       lam, subpel: int = 2, decimate: bool = True,
                       with_stego: bool = True, cost_mv=None):
    """Partition-aware flagship step: all-shapes full-pel scan ->
    partition decision -> per-8x8 qpel tables -> per-unit subpel ->
    partitioned encode -> per-unit RCA stego costs, one dispatch.
    This is the production P-frame program (encoder/core.py
    _encode_p_parts runs the same stages)."""
    from ..encoder import partition as PT

    part, mv8, r_idx8, blocks8, wht8, _mb_cost = \
        PT.analyse_p_frame_parts.__wrapped__(
            y, ref_luma, prev_mv, rng, mbh, mbw, lam, subpel)
    out = INTER.encode_p_frame_device8.__wrapped__(
        y, u, v, ref_luma, ref_u, ref_v, mv8, qp, qpc, mbh, mbw,
        decimate, None)
    out["part"] = part
    out["mv8"] = mv8
    if with_stego:
        if cost_mv is None:
            d = jnp.arange(0, 4 * 512 + 1)
            base = (2.0 * jnp.log2(d.astype(jnp.float32) + 1.0)
                    + 0.718 + (d != 0))
            cost_mv = (lam * base + 0.5).astype(jnp.int32)
        mvp_u = jnp.zeros((mbh, mbw, 4, 2), jnp.int32)
        rho, alt, valid = PT.stego_costs_parts.__wrapped__(
            y, blocks8, wht8, r_idx8, part, mv8, mvp_u, cost_mv, qp,
            mbh, mbw, decimate)
        out["stego_rho"] = rho
        out["stego_alt_mv"] = alt
        out["stego_valid"] = valid
    return out
