"""Device-side CAVLC residual bit-size estimation for RD decisions.

Reference: x264's RD mode decision re-includes the entropy writers as
size estimators (/root/reference/encoder/rdo.c:46-59, used by
x264_rd_cost_mb :139). The device equivalent computes the EXACT CAVLC bit
count of 4x4 residual blocks fully batched: table lookups for
coeff_token / total_zeros / run_before plus one 16-step lax.scan
carrying the level-suffix state (spec 9.2; twin of
encoder/cavlc.write_residual, which is the oracle in tests).

The only approximation made by callers is the nC context (neighbour
total_coeff), which in true raster coding depends on the neighbours'
own RD choices; batched RD uses the pre-RD nnz field (documented).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..encoder import vlc_tables as VT


def _len_tab2(rows, row_len):
    out = np.zeros((len(rows), row_len), np.int32)
    for i, row in enumerate(rows):
        for j, code in enumerate(row):
            out[i, j] = len(code) if code else 0
    return out


LEN_COEFF0 = np.array([len(c) for c in VT.COEFF0], np.int32)
LEN_COEFF_TOKEN = _len_tab2(VT.COEFF_TOKEN, 64)
LEN_TOTAL_ZEROS = _len_tab2(VT.TOTAL_ZEROS, 16)
LEN_TOTAL_ZEROS_DC = _len_tab2(VT.TOTAL_ZEROS_DC, 4)
LEN_RUN_BEFORE = _len_tab2(VT.RUN_BEFORE, 15)


def _level_bits(code, sl):
    """Bit length of one level code at suffix length sl (twin of
    cavlc._write_level). Codes beyond the prefix-15 escape window are
    costed at the prefix-16 size (unreachable for real quant output)."""
    # sl == 0 branch
    b0 = jnp.where(code < 14, code + 1,
                   jnp.where(code < 30, 19,
                             16 + 12))          # escape after code-=15
    # sl > 0 branch
    b1 = jnp.where(code < (15 << sl), (code >> sl) + 1 + sl, 16 + 12)
    return jnp.where(sl == 0, b0, b1)


@functools.partial(jax.jit, static_argnames=("max_coeff",))
def cavlc_block_bits(lev_zz, nc, max_coeff: int = 16):
    """Exact CAVLC bit count per block.

    lev_zz: [N, max_coeff] levels in scan order; nc: [N] neighbour
    context (use -1 for chroma DC). Returns [N] int32 bits."""
    lev = lev_zz.astype(jnp.int32)
    n, mc = lev.shape
    nz = lev != 0
    total = jnp.sum(nz, axis=1)
    last = jnp.max(jnp.where(nz, jnp.arange(mc)[None, :], -1), axis=1)
    tz = last + 1 - total

    # trailing ones (capped 3; zeros between nz don't break the run)
    rev = lev[:, ::-1]
    nzr = rev != 0
    bad = nzr & (jnp.abs(rev) != 1)
    seen_bad = jnp.cumsum(bad, axis=1) - bad  # exclusive
    is_t1_pos = nzr & (jnp.abs(rev) == 1) & (seen_bad == 0)
    rank = jnp.cumsum(nzr, axis=1) - nzr      # nz rank from high freq
    t1s = jnp.minimum(3, jnp.sum(is_t1_pos & (rank < 3), axis=1))

    tab = jnp.where(nc < 0, 4,
                    jnp.where(nc < 2, 0,
                              jnp.where(nc < 4, 1,
                                        jnp.where(nc < 8, 2, 3))))
    tok_idx = jnp.clip((total - 1) * 4 + t1s, 0, 63)
    bits = jnp.where(
        total == 0,
        jnp.asarray(LEN_COEFF0)[tab],
        jnp.asarray(LEN_COEFF_TOKEN)[tab, tok_idx])
    bits = bits + jnp.minimum(total, t1s)     # trailing-one signs

    # reverse 16-step scan: levels (suffix-length chain) + run_before
    sl0 = jnp.where((total > 10) & (t1s < 3), 1, 0)
    lrtab = (jnp.asarray(LEN_RUN_BEFORE) if max_coeff != 4
             else jnp.asarray(LEN_RUN_BEFORE))

    def step(carry, i):
        sl, first, t1c, blocked, zl, prev, b = carry
        v = lev[:, i]
        isnz = v != 0
        one = jnp.abs(v) == 1
        is_t1 = isnz & one & (~blocked) & (t1c < 3)
        is_lvl = isnz & ~is_t1
        # level code
        code = jnp.where(v > 0, 2 * v - 2, -2 * v - 1)
        code = jnp.where(first & (t1s < 3), code - 2, code)
        lb = _level_bits(code, sl)
        sl_next = jnp.where(sl == 0, 1, sl)
        sl_next = jnp.where(
            (jnp.abs(v) > (3 << jnp.maximum(sl_next - 1, 0)))
            & (sl_next < 6), sl_next + 1, sl_next)
        b = b + jnp.where(is_lvl, lb, 0)
        sl = jnp.where(is_lvl, sl_next, sl)
        first = first & ~is_lvl
        t1c = t1c + is_t1
        blocked = blocked | is_lvl
        # run_before of the PREVIOUSLY seen nz (higher scan pos): its
        # run = prev - i - 1, emitted because a lower nz exists
        has_prev = prev >= 0
        run = jnp.clip(prev - i - 1, 0, 14)
        emit_run = isnz & has_prev & (zl > 0) & (total < mc + 1)
        rb = lrtab[jnp.clip(jnp.minimum(zl, 7) - 1, 0, 6), run]
        b = b + jnp.where(emit_run, rb, 0)
        zl = jnp.where(emit_run, zl - run, zl)
        prev = jnp.where(isnz, i, prev)
        return (sl, first, t1c, blocked, zl, prev, b), None

    init = (sl0, jnp.ones(n, bool), jnp.zeros(n, jnp.int32),
            jnp.zeros(n, bool), tz, jnp.full(n, -1), bits)
    (sl, first, t1c, blocked, zl, prev, bits), _ = jax.lax.scan(
        step, init, jnp.arange(mc - 1, -1, -1))

    # total_zeros (only when the block isn't full)
    tztab = (jnp.asarray(LEN_TOTAL_ZEROS_DC) if max_coeff == 4
             else jnp.asarray(LEN_TOTAL_ZEROS))
    tzb = tztab[jnp.clip(total - 1, 0, tztab.shape[0] - 1),
                jnp.clip(tz, 0, tztab.shape[1] - 1)]
    bits = bits + jnp.where((total > 0) & (total < max_coeff), tzb, 0)
    return bits.astype(jnp.int32)


def ue_len(v):
    """Bit length of ue(v) (Exp-Golomb)."""
    n = jnp.floor(jnp.log2(v.astype(jnp.float32) + 1.0)).astype(jnp.int32)
    # exact for v < 2^23 (f32 mantissa); MB-header values are tiny
    return 2 * n + 1


def se_len(v):
    return ue_len(jnp.where(v > 0, 2 * v - 1, -2 * v))
