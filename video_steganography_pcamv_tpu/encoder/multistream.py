"""Multi-stream batched encoder: N independent video streams encoded in
lockstep, every device stage vmapped over the stream axis.

Reference analog: x264's frame-parallel threading (encoder.c:2358-2362,
doc/threads.txt) — its way of turning per-frame serial work into
throughput. On the device the same idea is a batch axis: the analyse / encode /
stego-cost / re-encode programs run once per frame-step over [S, ...]
stacked inputs, amortizing dispatch latency, transfer syncs and filling
the chip; the cheap serial host work (scans, STC, entropy, deblock)
loops per stream.

Constraints (bench-oriented): all streams share Params and start
together, so GOP phase stays aligned (same is_idr per step). Rate
control runs per stream.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..params import Params, SLICE_I, SLICE_P
from ..utils.bitstream import (BitWriter, nal_unit, NAL_SLICE,
                               NAL_SLICE_IDR, NAL_PRIORITY_HIGHEST,
                               NAL_PRIORITY_HIGH)
from ..ops import mc
from ..ops.transform import chroma_qp
from . import headers as H
from . import intra as I
from . import inter as P
from . import me as ME
from . import partition as PT
from .core import Encoder
from ..stego.cost import cost_mv_table


@functools.partial(jax.jit, static_argnames=("rng", "mbh", "mbw",
                                             "subpel", "decimate"))
def _analyse_encode_s(ys, us, vs, refl, refu, refv, prev_mvs, qps, qpcs,
                      lams, rng, mbh, mbw, subpel, decimate):
    """vmapped analyse + first encode over the stream axis."""
    def one(y, u, v, rl, ru, rv, pm, qp, qpc, lam):
        part, mv8, r_idx8, blocks8, wht8, mbc = \
            PT.analyse_p_frame_parts.__wrapped__(
                y, rl, pm, rng, mbh, mbw, lam, subpel)
        res = P.encode_p_frame_device8.__wrapped__(
            y, u, v, rl, ru, rv, mv8, qp, qpc, mbh, mbw, decimate, None)
        return part, mv8, r_idx8, blocks8, wht8, res
    return jax.vmap(one)(ys, us, vs, refl, refu, refv, prev_mvs,
                         qps, qpcs, lams)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate"))
def _stego_costs_s(ys, blocks8, wht8, r_idx8, parts, mv8s, mvps, cmvs,
                   qps, mbh, mbw, decimate):
    def one(y, b, w, r, p, m, mvp, cmv, qp):
        return PT.stego_costs_parts.__wrapped__(
            y, b, w, r, p, m, mvp, cmv, qp, mbh, mbw, decimate)
    return jax.vmap(one)(ys, blocks8, wht8, r_idx8, parts, mv8s, mvps,
                         cmvs, qps)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "decimate"))
def _reencode_s(ys, us, vs, refl, refu, refv, final8s, qps, qpcs,
                skips, mbh, mbw, decimate):
    def one(y, u, v, rl, ru, rv, f8, qp, qpc, sk):
        return P.encode_p_frame_device8.__wrapped__(
            y, u, v, rl, ru, rv, f8, qp, qpc, mbh, mbw, decimate, sk)
    return jax.vmap(one)(ys, us, vs, refl, refu, refv, final8s, qps,
                         qpcs, skips)


@jax.jit
def _build_refs_s(rys, rus, rvs):
    return jax.vmap(mc.build_ref)(rys, rus, rvs)


class MultiEncoder:
    """Encode S independent streams in lockstep (one frame from each
    per step). Device stages batch over streams; host stages loop."""

    def __init__(self, params: Params, n_streams: int, sharding=None):
        self.S = n_streams
        # intra-in-P refinement isn't batched here yet; keep device
        # stages identical across the stream axis
        params.intra_in_p = False
        self.encs = [Encoder(params) for _ in range(n_streams)]
        self.p = params
        self._refs = None  # stacked device refs {luma/u/v: [S, ...]}
        # optional jax.sharding.Sharding for the stream axis: when set,
        # every stacked device input is placed with it so XLA partitions
        # the vmapped stages across the mesh (one stream per chip)
        self._put = ((lambda x: jax.device_put(x, sharding))
                     if sharding is not None else (lambda x: x))

    def encode_step(self, frames) -> list[bytes]:
        """frames: one Frame per stream. Returns per-stream chunks."""
        assert len(frames) == self.S
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        encs = self.encs

        padded = [e._pad(f) for e, f in zip(encs, frames)]
        decisions = []
        for e, (y, u, v) in zip(encs, padded):
            is_idr, satd = e.lookahead.decide(y)
            if e.ref is None and self._refs is None:
                is_idr = True
            qp = e.rc.start(SLICE_I if is_idr else SLICE_P, satd)
            e._cur_qp = qp
            decisions.append((is_idr, qp))
        idrs = {d[0] for d in decisions}
        assert len(idrs) == 1, "streams out of GOP lockstep"
        is_idr = decisions[0][0]

        outs = []
        if is_idr:
            # I frames: per-stream (amortized over keyint)
            for e, (y, u, v), (_, qp) in zip(encs, padded, decisions):
                e.frame_num = 0
                chunk = e.headers()
                nal = e._encode_i(y, u, v, qp)
                chunk += nal_unit(NAL_SLICE_IDR, NAL_PRIORITY_HIGHEST,
                                  nal)
                self._finish(e, chunk)
                outs.append(chunk)
            self._stack_refs()
            return outs

        qps = self._put(jnp.asarray([d[1] for d in decisions]))
        qpcs = self._put(jnp.asarray([chroma_qp(d[1], p.chroma_qp_offset)
                                      for d in decisions]))
        lams = self._put(jnp.asarray([ME.lambda_tab(d[1])
                                      for d in decisions]))
        ys = self._put(jnp.stack([t[0] for t in padded]))
        us = self._put(jnp.stack([t[1] for t in padded]))
        vs = self._put(jnp.stack([t[2] for t in padded]))
        prev = self._put(jnp.stack([jnp.asarray(e.prev_mv)
                                    for e in encs]))
        part, mv8, r_idx8, blocks8, wht8, res = _analyse_encode_s(
            ys, us, vs, self._refs["luma"], self._refs["u"],
            self._refs["v"], prev, qps, qpcs, lams, p.me_range, mbh,
            mbw, p.subpel, p.dct_decimate)

        part_np = np.asarray(part)
        mv8_np = np.asarray(mv8)
        cbp_l = np.asarray(res["cbp_luma"])
        cbp_c = np.asarray(res["cbp_chroma"])

        from .. import native
        from . import scan as SCAN
        scans = []
        for s in range(self.S):
            if native.load() is not None:
                scans.append(native.scan_p_parts(
                    part_np[s], mv8_np[s], cbp_l[s], cbp_c[s]))
            else:
                scans.append(SCAN.scan_p_frame(
                    part_np[s], mv8_np[s], cbp_l[s], cbp_c[s]))

        if encs[0]._stego is not None:
            # the stego probe stage holds the largest working set (qpel
            # tables + candidate recons); vmapping it over streams OOMs
            # HBM at 1080p, and batching buys nothing on a single
            # sequential core — dispatch per stream (they still queue
            # back-to-back on device)
            rhos = []
            for s in range(self.S):
                rho, alt, _v = PT.stego_costs_parts(
                    ys[s], blocks8[s], wht8[s], r_idx8[s], part[s],
                    mv8[s], jnp.asarray(scans[s][2]),
                    jnp.asarray(cost_mv_table(
                        ME.lambda_tab(decisions[s][1]))),
                    decisions[s][1], mbh, mbw,
                    decimate=p.dct_decimate)
                rhos.append((rho, alt))
            final8s, skips, mvds = [], [], []
            for s, e in enumerate(encs):
                skip1 = scans[s][0]
                f8, sk, md = e._stego.apply_costs(
                    e, part_np[s], mv8_np[s], skip1,
                    np.asarray(rhos[s][0]), np.asarray(rhos[s][1]))
                final8s.append(f8)
                skips.append(sk)
                mvds.append(md)
            res = _reencode_s(
                ys, us, vs, self._refs["luma"], self._refs["u"],
                self._refs["v"],
                self._put(jnp.stack([jnp.asarray(f) for f in final8s])),
                qps, qpcs,
                self._put(jnp.stack([jnp.asarray(s_) for s_ in skips])),
                mbh, mbw, p.dct_decimate)
        else:
            final8s = [sc[3] for sc in scans]
            skips = [sc[0] for sc in scans]
            mvds = [sc[1] for sc in scans]

        from .core import _res_to_host
        res_np = {k: np.asarray(v) for k, v in res.items()}
        recons = []
        for s, e in enumerate(encs):
            sub = {k: v[s] for k, v in res_np.items()}
            sub["luma_lev"] = sub["luma_lev"].reshape(
                mbh, mbw, 4, 4, 4, 4)
            sub["chroma_dc"] = sub["chroma_dc"].reshape(mbh, mbw, 2, 2, 2)
            sub["chroma_ac"] = sub["chroma_ac"].reshape(
                mbh, mbw, 2, 2, 2, 4, 4)
            mv4 = np.repeat(np.repeat(final8s[s], 2, 0), 2, 1)
            e._deblock(sub, intra=False, mv=mv4,
                       skip=skips[s].astype(np.uint8), qp=decisions[s][1])
            recons.append((jnp.asarray(e.recon_prev[0]),
                           jnp.asarray(e.recon_prev[1]),
                           jnp.asarray(e.recon_prev[2])))
            e.prev_mv = np.ascontiguousarray(final8s[s][::2, ::2])

            bw = BitWriter()
            H.write_slice_header(bw, e.sps, e.pps, H.SLICE_TYPE_P,
                                 e.frame_num, decisions[s][1],
                                 idr=False,
                                 disable_deblock=0 if p.deblock else 1)
            n = mbh * mbw
            if p.cabac:
                chunk = e._write_p_slice_cabac(
                    bw, sub, decisions[s][1], part_np[s], mvds[s],
                    skips[s])
            else:
                hdr, nbits = bw.partial_bytes()
                chunk = native.write_slice(
                    hdr, nbits, H.SLICE_TYPE_P, mbw, mbh,
                    skip=skips[s].reshape(n).astype(np.uint8),
                    part=part_np[s].reshape(n),
                    mvd4=mvds[s].reshape(n, 4, 2),
                    cbp_luma=sub["cbp_luma"],
                    cbp_chroma=sub["cbp_chroma"],
                    luma_blocks=sub["luma_lev"].reshape(n, 16, 16),
                    chroma_dc=sub["chroma_dc"].reshape(n, 2, 4),
                    chroma_ac=sub["chroma_ac"].reshape(n, 2, 4, 16))
            chunk = nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH, chunk)
            self._finish(e, chunk)
            outs.append(chunk)

        self._refs = _build_refs_s(
            self._put(jnp.stack([r[0] for r in recons])),
            self._put(jnp.stack([r[1] for r in recons])),
            self._put(jnp.stack([r[2] for r in recons])))
        return outs

    def _finish(self, e, chunk):
        e.frame_num += 1
        e._frame_idx += 1
        e.stats.frames += 1
        e.stats.bits += 8 * len(chunk)
        e.rc.end(8 * len(chunk))

    def _stack_refs(self):
        """After per-stream I frames (each built its own ref)."""
        self._refs = {
            "luma": self._put(jnp.stack([e.ref["luma"]
                                         for e in self.encs])),
            "u": self._put(jnp.stack([e.ref["u"] for e in self.encs])),
            "v": self._put(jnp.stack([e.ref["v"] for e in self.encs])),
        }


class PipelinedMultiEncoder:
    """Single-chip multi-stream driver: S independent Encoders driven
    round-robin through the fused pipelined serving path (params.
    pipeline=True). Each encode_frame dispatches its stream's fused
    stage-1 and defers entropy one frame, so the host's serial work
    (STC, CAVLC/CABAC, muxing) for stream s-1 runs while the device
    processes stream s's queue — the device analog of x264's
    one-thread-per-frame throughput model (doc/threads.txt), with the
    device queue as the pipeline. Unlike MultiEncoder there is no GOP
    lockstep requirement: streams are fully independent.

    This replaces the batched path for the single-card many-streams
    case: there, host deblock + per-stream meta pulls serialize the
    device; the fused path has neither."""

    def __init__(self, params: Params, n_streams: int):
        self.S = n_streams
        self.encs = [Encoder(params) for _ in range(n_streams)]

    def encode_step(self, frames) -> list[bytes]:
        """frames: one Frame per stream. Returns per-stream chunks
        (entropy may lag one frame per stream; flush() drains)."""
        assert len(frames) == self.S
        return [e.encode_frame(f) for e, f in zip(self.encs, frames)]

    def flush(self) -> list[bytes]:
        return [e.flush() for e in self.encs]
