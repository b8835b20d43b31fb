"""Lookahead / slice-type decision over half-resolution frames.

Reference: encoder/slicetype.c — x264_slicetype_decide (:578),
x264_slicetype_analyse (:476), scenecut (:437), per-MB lowres cost
x264_slicetype_mb_cost (:43) over the half-res pyramid built by
x264_frame_init_lowres (common/mc.c:350-404).

Batched redesign: the reference runs a serial per-8x8-MB diamond ME in the
lowres plane. Here the whole lowres frame is costed in one device
dispatch: an exhaustive +-R full-pel SAD scan batched over every 8x8
block (same structure as the main fullpel search, at quarter the area),
plus a DC-prediction intra cost per block. The frame-level outputs
(cost_i, cost_p) feed both the scenecut decision and the rate
controller's complexity estimate (x264_rc_analyse_slice semantics).

No B-frames yet, so the B-adapt Viterbi (slicetype.c:476 trellis path)
is not required; the decision per frame is IDR-vs-P only.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.blocks import to_blocks


def lowres(y: jnp.ndarray) -> jnp.ndarray:
    """Half-res decimation of a luma plane (common/mc.c:380
    frame_init_lowres_core's 2x2 average, rounding up)."""
    h, w = y.shape
    t = y.reshape(h // 2, 2, w // 2, 2)
    return (t[:, 0, :, 0] + t[:, 0, :, 1] + t[:, 1, :, 0]
            + t[:, 1, :, 1] + 2) >> 2


@functools.partial(jax.jit, static_argnames=("bh", "bw", "rng"))
def lowres_costs(cur_lr, ref_lr, bh: int, bw: int, rng: int = 8):
    """Frame cost at lowres: per-8x8-block exhaustive inter SAD vs the
    previous lowres frame + DC intra SAD (x264_slicetype_mb_cost,
    slicetype.c:43; intra_satd_x3 analog simplified to the DC mode —
    the scenecut *ratio* is what matters, slicetype.c:437).

    cur_lr/ref_lr: [8*bh, 8*bw] int32 lowres planes.
    Returns (cost_i, cost_p) int32 scalars.
    """
    h, w = 8 * bh, 8 * bw
    ref_pad = jnp.pad(ref_lr, rng, mode="edge")

    def step(carry, i):
        best = carry
        dy = i // (2 * rng + 1) - rng
        dx = i % (2 * rng + 1) - rng
        win = jax.lax.dynamic_slice(ref_pad, (rng + dy, rng + dx), (h, w))
        sad = jnp.sum(to_blocks(jnp.abs(cur_lr - win), 8),
                      axis=(-4, -3))                       # [bh, bw]
        # lambda-ish mv penalty keeps the zero-mv tie-break stable
        pen = 4 * (jnp.abs(dy) + jnp.abs(dx))
        return jnp.minimum(best, sad + pen), None

    init = jnp.full((bh, bw), 1 << 30, jnp.int32)
    inter, _ = jax.lax.scan(step, init, jnp.arange((2 * rng + 1) ** 2))

    blocks = to_blocks(cur_lr, 8)                          # [8,8,bh,bw]
    dc = jnp.sum(blocks, axis=(-4, -3), keepdims=True) // 64
    intra = jnp.sum(jnp.abs(blocks - dc), axis=(-4, -3))   # [bh,bw]

    cost_p = jnp.sum(jnp.minimum(inter, intra))
    cost_i = jnp.sum(intra)
    return jnp.stack([cost_i, cost_p])


@functools.partial(jax.jit, static_argnames=("bh", "bw", "rng", "t"))
def lowres_costs_window(stack, cur_i, fwd_i, bwd_i, has_b, bh: int,
                        bw: int, rng: int, t: int):
    """Batched lowres frame-cost estimates over a lookahead window.

    Reference: x264_slicetype_frame_cost (slicetype.c:43-190) cached
    per (p0, b, p1) triple by x264_slicetype_analyse. Batched redesign: the
    b-adapt trellis needs O(window * bframes) triples — ALL of them are
    estimated in ONE dispatch (vmapped exhaustive lowres scan over the
    stacked window planes) and come back as one [t] pull.

    stack: [L, 8bh, 8bw] lowres planes (device). cur_i/fwd_i/bwd_i:
    [t] indices into the stack (bwd ignored where has_b == 0).
    Returns [t] int64 frame costs: per-8x8 min(intra, fwd, bwd, bidir)
    — bidir as the average-of-preds analog (BI of slicetype_mb_cost)."""
    rr = 2 * rng + 1

    def one(ci, fi, bi, hb):
        cur = stack[ci]
        reff = jnp.pad(stack[fi], rng, mode="edge")
        refb = jnp.pad(stack[bi], rng, mode="edge")
        h, w = cur.shape

        def step(carry, i):
            bf, bb, bavg = carry
            dy = i // rr - rng
            dx = i % rr - rng
            pen = 4 * (jnp.abs(dy) + jnp.abs(dx))
            wf = jax.lax.dynamic_slice(reff, (rng + dy, rng + dx), (h, w))
            wb = jax.lax.dynamic_slice(refb, (rng + dy, rng + dx), (h, w))
            sf = jnp.sum(to_blocks(jnp.abs(cur - wf), 8),
                         axis=(-4, -3)) + pen
            sb = jnp.sum(to_blocks(jnp.abs(cur - wb), 8),
                         axis=(-4, -3)) + pen
            # bidir analog: average of the co-located fwd/bwd windows
            # (slicetype BI probe at the merged mv; the structure
            # RATIO is what the trellis consumes)
            sa = jnp.sum(to_blocks(jnp.abs(cur - ((wf + wb + 1) >> 1)),
                                   8), axis=(-4, -3)) + pen
            return (jnp.minimum(bf, sf), jnp.minimum(bb, sb),
                    jnp.minimum(bavg, sa)), None

        init = tuple(jnp.full((bh, bw), 1 << 30, jnp.int32)
                     for _ in range(3))
        (bf, bb, bavg), _ = jax.lax.scan(step, init, jnp.arange(rr * rr))
        blocks = to_blocks(cur, 8)
        dc = jnp.sum(blocks, axis=(-4, -3), keepdims=True) // 64
        intra = jnp.sum(jnp.abs(blocks - dc), axis=(-4, -3))
        best = jnp.minimum(intra, bf)
        best_b = jnp.minimum(best, jnp.minimum(bb, bavg))
        return jnp.sum(jnp.where(hb, best_b, best).astype(jnp.int64))

    return jax.vmap(one)(cur_i, fwd_i, bwd_i, has_b)


def slicetype_path(costs, n: int, bframes: int):
    """B-placement DP over the window (x264 x264_slicetype_path /
    slicetype_path_search, slicetype.c:476 B_ADAPT_TRELLIS semantics):
    choose anchor positions minimizing the summed frame-cost estimate.

    costs: dict[(kind, i, a, b)] -> est cost, kind in ('P','B'); frame
    indices are window positions with the previous anchor at -1. Paths
    end with an anchor at the window's last frame (x264's candidate
    strings all end in P). Returns the first anchor position k
    (buf[:k] become B frames)."""
    INF = float("inf")
    # dp[j] = best cost of typing frames 0..j with an anchor at j
    dp = [INF] * n
    first = [0] * n
    for j in range(n):
        for a in range(max(-1, j - 1 - bframes), j):
            seg = costs[("P", j, a, -2)]
            for i in range(a + 1, j):
                seg += costs[("B", i, a, j)]
            prev = 0.0 if a == -1 else dp[a]
            if prev + seg < dp[j]:
                dp[j] = prev + seg
                first[j] = j if a == -1 else first[a]
    return first[n - 1]


class Lookahead:
    """Per-frame slice-type decision + complexity estimate.

    x264_slicetype_decide reduced to the bframes=0 case: IDR on keyint
    expiry or scenecut (scenecut threshold semantics of slicetype.c:437).
    """

    def __init__(self, params):
        self.p = params
        self.prev_lr = None
        self.last_keyframe = -(10 ** 9)
        self.frame_idx = -1
        # B-adapt signal: True when the incoming frame predicts poorly
        # from its predecessor (close the GOP, code it as the P anchor)
        self.bad_b_candidate = False

    def costs_device(self, y: jnp.ndarray):
        """Dispatch the lowres frame-cost program WITHOUT pulling: the
        fused P driver appends the [2] (cost_i, cost_p) array to its
        stage-1 packed pull so the slice-type decision costs no extra
        blocking pull (speculative-P under CQP). Pair with
        decide_from_costs once the values are host-side. Requires a
        previous frame (prev_lr not None)."""
        p = self.p
        bh, bw = p.mb_height, p.mb_width
        cur_lr = lowres(y)
        out = lowres_costs(cur_lr, self.prev_lr, bh, bw,
                           rng=p.lookahead_me_range)
        self._pending_lr = cur_lr
        return out

    def decide_from_costs(self, ci: int, cp: int):
        """Host half of decide() for costs pulled elsewhere."""
        self.frame_idx += 1
        self.prev_lr = self._pending_lr
        return self._decide_host(self.frame_idx, ci, cp)

    def decide(self, y: jnp.ndarray):
        """Returns (is_idr, satd_complexity) for the incoming frame.
        y: padded luma [16*mbh, 16*mbw] int32 device array."""
        p = self.p
        self.frame_idx += 1
        idx = self.frame_idx
        bh, bw = p.mb_height, p.mb_width       # 8x8 lowres blocks = MBs
        cur_lr = lowres(y)

        if self.prev_lr is None:
            self.prev_lr = cur_lr
            self.last_keyframe = idx
            # first frame: intra cost only
            both = np.asarray(lowres_costs(cur_lr, cur_lr, bh, bw,
                                           rng=0))
            return True, int(both[0])

        both = np.asarray(lowres_costs(cur_lr, self.prev_lr, bh, bw,
                                       rng=p.lookahead_me_range))
        ci, cp = int(both[0]), int(both[1])
        self.prev_lr = cur_lr
        return self._decide_host(idx, ci, cp)

    def decide_b_placement(self, anchor_lr, buf_lrs, bframes: int):
        """b-adapt 2 trellis over the lookahead window: batched lowres
        cost estimates for every (p0, b, p1) triple the DP can touch
        (ONE dispatch + ONE pull), then slicetype_path. anchor_lr: the
        previous anchor's lowres plane; buf_lrs: lowres of the buffered
        display-order frames. Returns the window position of the next
        anchor (frames before it are coded as B)."""
        p = self.p
        n = len(buf_lrs)
        if n == 1:
            return 0
        stack = jnp.stack([anchor_lr] + list(buf_lrs))
        triples, keys = [], []
        for j in range(n):
            for a in range(max(-1, j - 1 - bframes), j):
                triples.append((j + 1, a + 1, a + 1, 0))
                keys.append(("P", j, a, -2))
                for i in range(a + 1, j):
                    triples.append((i + 1, a + 1, j + 1, 1))
                    keys.append(("B", i, a, j))
        t = len(triples)
        tp = -(-t // 16) * 16        # pad: few distinct compiles
        arr = np.zeros((tp, 4), np.int32)
        arr[:t] = triples
        vals = np.asarray(lowres_costs_window(
            stack, jnp.asarray(arr[:, 0]), jnp.asarray(arr[:, 1]),
            jnp.asarray(arr[:, 2]), jnp.asarray(arr[:, 3]),
            p.mb_height, p.mb_width, p.lookahead_me_range, tp))
        costs = {k: float(v) for k, v in zip(keys, vals[:t])}
        return slicetype_path(costs, n, bframes)

    def _decide_host(self, idx: int, ci: int, cp: int):
        p = self.p
        since_key = idx - self.last_keyframe
        is_idr = since_key >= p.keyint_max
        if (not is_idr and p.scenecut_threshold > 0
                and since_key >= p.keyint_min):
            # scenecut (slicetype.c:437): P cost close to I cost => cut.
            # bias grows toward keyint expiry exactly as the reference's
            # f_bias schedule (simplified linear form).
            thresh = p.scenecut_threshold / 100.0
            bias = min(thresh * 4,
                       thresh + thresh * (since_key / p.keyint_max))
            if cp >= (1.0 - bias) * ci:
                is_idr = True
        # adaptive-B signal (role of slicetype.c:476 B_ADAPT_FAST,
        # redesigned for the 1-frame lookahead: a frame whose lowres
        # inter cost approaches its intra cost interpolates badly and
        # should anchor the GOP instead of riding as a B)
        self.bad_b_candidate = cp * 10 > ci * 9
        if is_idr:
            self.last_keyframe = idx
            return True, ci
        return False, cp
