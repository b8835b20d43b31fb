"""Encoder lifecycle + frame driver.

Reference: x264_encoder_open/encode/close (encoder/encoder.c:630, 2113,
2670) and the slice writer (:1176). Device re-design: per frame, one jitted
device program produces all decisions/levels/recon; the host then runs
the serial entropy back-end and NAL packaging. No second encode pass is
ever needed — stego flips are applied to the analysis results before the
(single) reconstruction/entropy stage.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from ..params import Params, SLICE_I, SLICE_P, SLICE_B
from ..utils.bitstream import (BitWriter, nal_unit, NAL_SLICE, NAL_SLICE_IDR,
                               NAL_SPS, NAL_PPS, NAL_PRIORITY_HIGHEST,
                               NAL_PRIORITY_HIGH, NAL_PRIORITY_DISPOSABLE)
from ..utils.yuv import Frame
from ..ops import mc
from ..ops.transform import chroma_qp
from . import headers as H
from . import intra as I
from . import inter as P
from . import me as ME
from .cavlc import FrameCavlc


import functools
import jax as _jax


_LEAN_EXC_CAP = 4096


@functools.partial(_jax.jit, static_argnames=("n", "has8"))
def _pack_levels_lean(res, n: int, has8: bool):
    """int8 level packing for the device-to-host pull: levels clamp to
    int8 (~2x fewer bytes) plus a fixed-capacity exception list of
    out-of-range coefficients (|lev| > 127 is rare above QP ~20). The
    exception (idx, val) pairs are bitcast into the same int8 buffer so
    everything still rides ONE transfer."""
    pieces = [res["luma_lev"].reshape(n, 256).astype(jnp.int16),
              res["chroma_dc"].reshape(n, 8).astype(jnp.int16),
              res["chroma_ac"].reshape(n, 128).astype(jnp.int16)]
    if has8:
        pieces.append(res["luma8_lev"].reshape(n, 256).astype(jnp.int16))
        pieces.append(res["trans8"].reshape(n, 1).astype(jnp.int16))
    flat = jnp.concatenate(pieces, axis=1).reshape(-1)
    big = jnp.abs(flat) > 127
    count = jnp.sum(big.astype(jnp.int32))
    (idx,) = jnp.nonzero(big, size=_LEAN_EXC_CAP, fill_value=-1)
    vals = jnp.where(idx >= 0, flat[jnp.clip(idx, 0)], 0)
    lo = jnp.clip(flat, -128, 127).astype(jnp.int8)
    meta = jnp.concatenate([
        jnp.array([count], jnp.int32), idx.astype(jnp.int32)])
    meta8 = _jax.lax.bitcast_convert_type(meta, jnp.int8).reshape(-1)
    vals8 = _jax.lax.bitcast_convert_type(
        vals.astype(jnp.int16), jnp.int8).reshape(-1)
    return jnp.concatenate([lo, meta8, vals8])


def _res_to_host(res, mbh, mbw, with_recon: bool = True):
    """Pull the per-frame result dict and restore the structured level
    shapes (the device emits flat trailing dims; np reshape is free).

    The three level tensors ride ONE device concat + ONE transfer (each
    blocking pull costs a host-device round trip); recon planes are skipped when the
    reference stays on-device (with_recon=False). The serving path
    (with_recon=False) additionally packs levels to int8 + exceptions."""
    n = mbh * mbw
    has8 = "luma8_lev" in res
    width = 392 + (257 if has8 else 0)
    packed = None
    if not with_recon:
        flat_len = n * width
        lev_in = {k: res[k] for k in
                  ("luma_lev", "chroma_dc", "chroma_ac", "luma8_lev",
                   "trans8") if k in res}
        buf = np.asarray(_pack_levels_lean(lev_in, n, has8))
        lo = buf[:flat_len].astype(np.int16)
        meta = buf[flat_len:flat_len + 4 * (1 + _LEAN_EXC_CAP)] \
            .view(np.int32)
        count = int(meta[0])
        if count <= _LEAN_EXC_CAP:
            idx = meta[1:]
            vals = buf[flat_len + 4 * (1 + _LEAN_EXC_CAP):].view(np.int16)
            sel = idx >= 0
            lo[idx[sel]] = vals[sel]
            packed = lo.reshape(n, width)
        # else: fall through to the exact int16 pull (rare: very low QP)
    if packed is None:
        pieces = [res["luma_lev"].reshape(n, 256).astype(jnp.int16),
                  res["chroma_dc"].reshape(n, 8).astype(jnp.int16),
                  res["chroma_ac"].reshape(n, 128).astype(jnp.int16)]
        if has8:
            pieces.append(res["luma8_lev"].reshape(n, 256)
                          .astype(jnp.int16))
            pieces.append(res["trans8"].reshape(n, 1).astype(jnp.int16))
        packed = np.asarray(jnp.concatenate(pieces, axis=1))
    out = {}
    for k, v in res.items():
        if k in ("luma_lev", "chroma_dc", "chroma_ac", "luma8_lev",
                 "trans8"):
            continue
        if not with_recon and k.startswith("recon_"):
            continue
        out[k] = np.asarray(v)
    out["luma_lev"] = np.ascontiguousarray(packed[:, :256]) \
        .reshape(mbh, mbw, 4, 4, 4, 4)
    out["chroma_dc"] = np.ascontiguousarray(packed[:, 256:264]) \
        .reshape(mbh, mbw, 2, 2, 2)
    out["chroma_ac"] = np.ascontiguousarray(packed[:, 264:392]) \
        .reshape(mbh, mbw, 2, 2, 2, 4, 4)
    if has8:
        out["luma8_lev"] = np.ascontiguousarray(packed[:, 392:648]) \
            .reshape(mbh, mbw, 2, 2, 8, 8)
        out["trans8"] = packed[:, 648].astype(bool).reshape(mbh, mbw)
    return out


@functools.partial(_jax.jit, static_argnames=("n", "has8"))
def _pack_frame_lean(res, n: int, has8: bool):
    """Everything the entropy writer needs in ONE int8 buffer: levels
    (int8 + exception list, as _pack_levels_lean) plus the cbp columns.
    The pipelined driver enqueues this at re-encode time and fetches it
    one frame later (the buffer is materialized by then, so the fetch
    does not wait behind the next frame's stage-1 in the FIFO)."""
    pieces = [res["luma_lev"].reshape(n, 256).astype(jnp.int16),
              res["chroma_dc"].reshape(n, 8).astype(jnp.int16),
              res["chroma_ac"].reshape(n, 128).astype(jnp.int16),
              res["cbp_luma"].reshape(n, 1).astype(jnp.int16),
              res["cbp_chroma"].reshape(n, 1).astype(jnp.int16)]
    if has8:
        pieces.append(res["luma8_lev"].reshape(n, 256).astype(jnp.int16))
        pieces.append(res["trans8"].reshape(n, 1).astype(jnp.int16))
    flat = jnp.concatenate(pieces, axis=1).reshape(-1)
    big = jnp.abs(flat) > 127
    count = jnp.sum(big.astype(jnp.int32))
    (idx,) = jnp.nonzero(big, size=_LEAN_EXC_CAP, fill_value=-1)
    vals = jnp.where(idx >= 0, flat[jnp.clip(idx, 0)], 0)
    lo = jnp.clip(flat, -128, 127).astype(jnp.int8)
    meta = jnp.concatenate([
        jnp.array([count], jnp.int32), idx.astype(jnp.int32)])
    meta8 = _jax.lax.bitcast_convert_type(meta, jnp.int8).reshape(-1)
    vals8 = _jax.lax.bitcast_convert_type(
        vals.astype(jnp.int16), jnp.int8).reshape(-1)
    return jnp.concatenate([lo, meta8, vals8])


def _unpack_frame_lean(buf: np.ndarray, mbh: int, mbw: int, has8: bool):
    """Host half of _pack_frame_lean -> res_np dict (no recon keys).
    Returns None if the exception list overflowed (caller must fall
    back to an exact pull — unreachable above QP ~20)."""
    n = mbh * mbw
    width = 394 + (257 if has8 else 0)
    flat_len = n * width
    lo = buf[:flat_len].astype(np.int16)
    meta = buf[flat_len:flat_len + 4 * (1 + _LEAN_EXC_CAP)].view(np.int32)
    count = int(meta[0])
    if count > _LEAN_EXC_CAP:
        return None
    idx = meta[1:]
    vals = buf[flat_len + 4 * (1 + _LEAN_EXC_CAP):].view(np.int16)
    sel = idx >= 0
    lo[idx[sel]] = vals[sel]
    packed = lo.reshape(n, width)
    out = {
        "luma_lev": np.ascontiguousarray(packed[:, :256])
        .reshape(mbh, mbw, 4, 4, 4, 4),
        "chroma_dc": np.ascontiguousarray(packed[:, 256:264])
        .reshape(mbh, mbw, 2, 2, 2),
        "chroma_ac": np.ascontiguousarray(packed[:, 264:392])
        .reshape(mbh, mbw, 2, 2, 2, 4, 4),
        "cbp_luma": packed[:, 392].astype(np.uint8).reshape(mbh, mbw),
        "cbp_chroma": packed[:, 393].astype(np.uint8).reshape(mbh, mbw),
    }
    if has8:
        out["luma8_lev"] = np.ascontiguousarray(packed[:, 394:650]) \
            .reshape(mbh, mbw, 2, 2, 8, 8)
        out["trans8"] = packed[:, 650].astype(bool).reshape(mbh, mbw)
    return out


@functools.partial(_jax.jit, static_argnames=("mbh", "mbw"))
def _nnz4_device(lev, mbh: int, mbw: int):
    """Per-4x4 total_coeff map for the deblocker, on device.
    lev: [mbh, mbw, 256] flat (by,bx,r,c)."""
    l6 = lev.reshape(mbh, mbw, 4, 4, 16)
    return jnp.count_nonzero(l6, axis=4).transpose(0, 2, 1, 3) \
        .reshape(4 * mbh, 4 * mbw).astype(jnp.int32)


@functools.partial(_jax.jit, static_argnames=("mbh", "mbw"))
def _merge_res_trans8(res4, res8, elig, mbh: int, mbw: int):
    """Per-MB merge of the 4x4-transform sub-path encode (res4) with
    the 8x8-capable encode (res8) on trans8-eligible MBs (all
    partitions >= 8x8 — x264_mb_transform_8x8_allowed). For eligible
    MBs res8's own 4x4 branch is bit-identical to res4 (same MVs ->
    same prediction -> same levels), so res8 is taken wholesale
    there."""
    out = dict(res4)
    for k in ("luma_lev", "cbp_luma", "cbp_chroma", "chroma_dc",
              "chroma_ac"):
        mm = elig.reshape(mbh, mbw, *([1] * (res4[k].ndim - 2)))
        out[k] = jnp.where(mm, res8[k], res4[k])
    m16 = jnp.repeat(jnp.repeat(elig, 16, 0), 16, 1)
    m8 = jnp.repeat(jnp.repeat(elig, 8, 0), 8, 1)
    out["recon_y"] = jnp.where(m16, res8["recon_y"], res4["recon_y"])
    out["recon_u"] = jnp.where(m8, res8["recon_u"], res4["recon_u"])
    out["recon_v"] = jnp.where(m8, res8["recon_v"], res4["recon_v"])
    out["luma8_lev"] = res8["luma8_lev"] * elig[:, :, None]
    out["trans8"] = res8["trans8"] & elig
    return out


@functools.partial(_jax.jit, static_argnames=("mbh", "mbw"))
def _nnz4_t8_device(lev4, lev8, t8_eff, mbh: int, mbw: int):
    """Per-4x4 nnz map under the 8x8 transform, on device: every 4x4
    cell of an effective-trans8 MB carries its covering 8x8 block's
    coefficient count (bS at 8x8 edges reads any covered cell; the
    internal 4x4-only edges are skipped by the deblocker's trans8
    rule). Device twin of the host merge in _p_finalize."""
    nz4 = jnp.count_nonzero(lev4.reshape(mbh, mbw, 4, 4, 16), axis=4) \
        .transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
    nz8 = jnp.count_nonzero(lev8.reshape(mbh, mbw, 2, 2, 64), axis=4) \
        .transpose(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)
    t8r = jnp.repeat(jnp.repeat(t8_eff.astype(bool), 4, 0), 4, 1)
    nz8r = jnp.repeat(jnp.repeat(nz8, 2, 0), 2, 1)
    return jnp.where(t8r, nz8r, nz4).astype(jnp.int32)


@dataclass
class EncodeStats:
    frames: int = 0
    bits: int = 0
    ssd_y: int = 0
    ssd_u: int = 0
    ssd_v: int = 0
    ssim_sum: float = 0.0
    i_frames: int = 0
    p_frames: int = 0
    b_frames: int = 0
    # stego counters (reference: h->stat.info, common/common.h:692-697)
    mv_covers: int = 0
    message_bits: int = 0
    mv_flips: int = 0
    elapsed: float = 0.0


class Encoder:
    """x264-style lifecycle: construct -> encode_frame per frame -> close."""

    def __init__(self, params: Params):
        params.validate()
        self.p = params
        # open-time ceilings for reconfig() clamps (encoder.c:840,851)
        self._open_ref_frames = params.ref_frames
        self._open_me_range = params.me_range
        self.sps = H.SPS(params.width, params.height,
                         num_ref_frames=params.ref_frames,
                         log2_max_frame_num=8)
        self.pps = H.PPS(pic_init_qp=params.qp,
                         chroma_qp_index_offset=params.chroma_qp_offset,
                         num_ref_idx_l0_active=params.ref_frames,
                         cabac=params.cabac,
                         weighted_bipred_idc=2 if params.weightb else 0)
        if params.bframes > 0:
            # out-of-order output needs real POCs; B slices need main
            # profile; the decoder must hold both anchors (plus the
            # full L0 window when multi-ref P is on too)
            self.sps.poc_type = 0
            self.sps.profile = H.PROFILE_MAIN
            # pyramid needs the extra window slot so the sliding
            # window doesn't forget the previous anchor before the
            # next GOP's early Bs reference it (set.c:198-201: "extra
            # slot with pyramid so that we don't have to override the
            # order of forgetting old pictures")
            self.sps.num_ref_frames = max(
                4 if params.b_pyramid else 2, params.ref_frames)
            if params.ref_frames > 1:
                # multi-ref B lists: the future anchor occupies a DPB
                # slot while the Bs still reference ALL ref_frames
                # past entries — same extra-slot trick as the pyramid;
                # under the pyramid the window also holds the current
                # BREF on top of the R-deep past list
                self.sps.num_ref_frames = max(
                    self.sps.num_ref_frames,
                    params.ref_frames + (2 if params.b_pyramid else 1))
        # custom quantization matrices (x264 --cqm): swap the active
        # quant/dequant tables (process-level encoder state; see
        # ops/cqm.py) and signal the lists in the SPS (High profile)
        from ..ops import cqm as CQM
        if params.cqm == "jvt":
            lists = [params.cqm4i if params.cqm4i is not None
                     else CQM.JVT4I,
                     params.cqm4p if params.cqm4p is not None
                     else CQM.JVT4P,
                     params.cqm8i if params.cqm8i is not None
                     else CQM.JVT8I,
                     params.cqm8p if params.cqm8p is not None
                     else CQM.JVT8P]
        else:
            lists = [params.cqm4i, params.cqm4p, params.cqm8i,
                     params.cqm8p]
        CQM.set_cqm(*lists, dz_intra=32 - params.deadzone_intra,
                    dz_inter=32 - params.deadzone_inter)
        if not CQM.is_flat():
            i4l, p4l, i8l, p8l = CQM.active_lists()
            self.sps.scaling4_intra = i4l
            self.sps.scaling4_inter = p4l
            self.sps.scaling8_intra = i8l
            self.sps.scaling8_inter = p8l
            self.sps.profile = H.PROFILE_HIGH
        if params.transform_8x8:
            self.sps.profile = H.PROFILE_HIGH
            self.pps.transform_8x8 = True
        # VUI + level (x264_sps_init, encoder/set.c:147-211; levels
        # x264_validate_levels set.c:537)
        self.sps.sps_id = params.sps_id
        self.pps.sps_id = params.sps_id
        self.sps.vui = H.VUI(
            sar_width=params.sar_width, sar_height=params.sar_height,
            overscan=params.overscan, videoformat=params.videoformat,
            fullrange=params.fullrange, colorprim=params.colorprim,
            transfer=params.transfer, colmatrix=params.colmatrix,
            chromaloc=params.chromaloc,
            fps_num=params.fps_num, fps_den=params.fps_den,
            # reference set.c:197: pyramid holds a reference B, so
            # display reordering is 2 deep (FFmpeg trusts this and
            # DROPS late b frames if it reads 1)
            num_reorder_frames=(2 if params.b_pyramid else
                                1 if params.bframes else 0),
            max_dec_frame_buffering=self.sps.num_ref_frames,
            mv_range=params.me_range)
        if params.level_idc:
            self.sps.level_idc = params.level_idc
        else:
            self.sps.level_idc = H.pick_level(
                params.mb_width, params.mb_height, params.fps_num,
                params.fps_den, self.sps.num_ref_frames, params.me_range)
        from ..utils.log import log, LOG_WARNING
        for msg in H.validate_levels(
                self.sps.level_idc, params.mb_width, params.mb_height,
                params.fps_num, params.fps_den, self.sps.num_ref_frames,
                params.me_range, params.vbv_maxrate, params.vbv_bufsize,
                self.sps.profile >= H.PROFILE_HIGH):
            log(LOG_WARNING, msg)
        self.dpb = []   # device ref dicts, newest first (L0 order)
        # decode-order reference store (sliding window, spec 8.2.5.3):
        # self.dpb is the derived P-list VIEW ([newest anchor] + rest
        # PicNum-descending — exactly the reference's one-op reordered
        # list, encoder.c:138-150); B slices derive POC-descending L0
        # stacks per frame from the same store. With b-pyramid the
        # store holds reference Bs too.
        self._dpb_store = []
        self._ref_meta = None  # staged (disp, fn, anchor, ref_poc0)
        # effective P L0 count for the CURRENT slice (the reference
        # signals sh->i_num_ref_idx_l0_active = h->i_ref0, the ACTUAL
        # list length — FFmpeg pads short lists with a 'missing
        # reference picture' default otherwise)
        self._p_l0_eff = params.ref_frames
        self._bbuf = []        # pending display-order frames (B pipe)
        self._disp_idx = 0     # display index of the next input frame
        self._last_idr_disp = 0
        self._col = None       # (mv4, ref4) of the newest anchor
        self._anchor_lr = None  # lowres of the newest anchor (b-adapt 2)
        self._anchor_disp = 0   # display index of the newest anchor
        self._dpb_disps = []    # display index per DPB entry (newest
                                # first, aligned with self.dpb)
                                # (implicit bipred weights)
        self._poc_lsb = 0      # poc of the slice being written
        self._pending_p = None  # pipelined driver: deferred entropy
        self._direct_score = [0, 0]  # --direct auto running score
        self._reorder_next_p = False  # emit L0 reordering on the next
        #                               P slice (after a pyramid GOP)
        self._last_anchor_fn = 0
        #                      [0]=temporal, [1]=spatial (x264 stat)
        self.keep_recon = False     # tests: record recon per display idx
        self.recon_by_disp = {}
        self._aus = None       # when a list: (disp, bytes, kind) per AU
        # noise-reduction running state (x264 nr_residual_sum/nr_count)
        self._nr_sum = np.zeros((4, 4), np.float64)
        self._nr_count = 0
        self.frame_num = 0
        self.idr_pic_id = 0
        self.stats = EncodeStats()
        self.recon_prev = None  # reference planes (numpy) of last frame
        self.ref = None         # device reference (padded + hpel planes)
        self.prev_mv = None     # temporal MV predictor field [mbh,mbw,2]
        self._headers_written = False
        self._aq_grids = None   # (qp_grid, qpc_grid) of the current
                                # P frame when --aq-mode is on
        from ..ops.aq import Zones
        self._zones = Zones(params.zones)
        self._stego = None
        if params.stego.enabled:
            from ..stego.embed import StegoEngine
            self._stego = StegoEngine(params)
        from .. import native
        self._native = native.load()  # None -> Python fallbacks
        from .ratecontrol import RateControl
        from .slicetype import Lookahead
        self.rc = RateControl(params)
        self.lookahead = Lookahead(params)
        self._frame_idx = 0       # absolute input frame counter
        self._cur_qp = params.qp  # qp of the frame being encoded

    # ------------------------------------------------------------------
    # -- live reconfiguration ------------------------------------------
    # Analog of x264_encoder_reconfig (/root/reference/encoder/encoder.c:
    # 837-878): a whitelist of analysis/filter knobs may change between
    # frames without reopening; everything baked into SPS/PPS
    # (resolution, entropy mode, profile, GOP structure) is rejected.
    # Guards mirror the reference's: me_range only shrinks (scratch
    # buffers, encoder.c:851), ref_frames never exceeds the SPS window
    # (encoder.c:840), transform_8x8 only toggles if the PPS enabled it
    # at open (encoder.c:869).
    _RECONFIG_OK = frozenset((
        "ref_frames", "scenecut_threshold", "deblock", "deblock_alpha",
        "deblock_beta", "me_range", "noise_reduction", "trellis",
        "fast_pskip", "partitions", "p4x4", "transform_8x8", "rd",
        "deadzone_intra", "deadzone_inter", "intra_in_p", "dct_decimate",
    ))

    def reconfig(self, **changes) -> None:
        """Apply a parameter delta mid-stream. Raises PcamvError for
        non-reconfigurable keys or illegal transitions; later frames
        use the new settings (jit caches re-key on changed statics)."""
        from ..utils.log import PcamvError
        p = self.p
        bad = sorted(set(changes) - self._RECONFIG_OK)
        if bad:
            raise PcamvError(
                "not reconfigurable without reopening: " + ", ".join(bad))
        if "ref_frames" in changes:
            changes["ref_frames"] = max(
                1, min(int(changes["ref_frames"]),
                       self.sps.num_ref_frames, self._open_ref_frames))
        if "me_range" in changes:
            changes["me_range"] = max(
                1, min(int(changes["me_range"]), self._open_me_range))
        if changes.get("transform_8x8") and not self.pps.transform_8x8:
            raise PcamvError(
                "transform_8x8 can only be enabled at open (PPS "
                "transform_8x8_mode_flag already written)")
        for k, v in changes.items():
            setattr(p, k, v)
        p.validate()

    def headers(self) -> bytes:
        """SPS+PPS+SEI Annex-B chunk (x264_encoder_headers,
        encoder.c:901; SEI version encoder/set.c:475)."""
        from ..params import param2string
        out = nal_unit(NAL_SPS, NAL_PRIORITY_HIGHEST, self.sps.write())
        out += nal_unit(NAL_PPS, NAL_PRIORITY_HIGHEST, self.pps.write())
        out += nal_unit(H.NAL_SEI, 0,
                        H.sei_version_payload(param2string(self.p)))
        return out

    def _pad(self, frame: Frame):
        """Pad planes to MB multiples (edge replicate) and lift to int32
        device arrays."""
        mbw, mbh = self.p.mb_width, self.p.mb_height
        y = np.asarray(frame.y, np.int32)
        u = np.asarray(frame.u, np.int32)
        v = np.asarray(frame.v, np.int32)
        py, px = mbh * 16 - y.shape[0], mbw * 16 - y.shape[1]
        if py or px:
            y = np.pad(y, ((0, py), (0, px)), mode="edge")
            u = np.pad(u, ((0, py // 2), (0, px // 2)), mode="edge")
            v = np.pad(v, ((0, py // 2), (0, px // 2)), mode="edge")
        return jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)

    def encode_frame(self, frame: Frame) -> bytes:
        """Encode one input (display-order) frame. With bframes > 0
        frames are buffered for reordering: the returned bytes are the
        NALs ready so far, in decode order (may be empty; call flush()
        after the last input)."""
        if self.p.bframes > 0:
            return self._encode_frame_bpipe(frame)
        return self._encode_frame_ipp(frame)

    def encode_frame_aus(self, frame: Frame):
        """Like encode_frame, but returns the access units emitted by
        this call as a list of (display_idx, annexb_bytes, kind) with
        kind in {"I","P","B"} — what a muxer needs (per-AU blocks +
        display-order timestamps) instead of one opaque chunk."""
        self._aus = []
        self.encode_frame(frame)
        aus, self._aus = self._aus, None
        return aus

    def flush_aus(self):
        """flush(), AU-granular (see encode_frame_aus)."""
        self._aus = []
        self.flush()
        aus, self._aus = self._aus, None
        return aus

    def _emit_au(self, disp: int, chunk: bytes, kind: str):
        if self._aus is not None and chunk:
            self._aus.append((disp, chunk, kind))

    def _aud(self, slice_type: int) -> bytes:
        """Access-unit delimiter NAL when --aud is on (x264 b_aud)."""
        if not self.p.aud:
            return b""
        return nal_unit(H.NAL_AUD, 0, H.aud_payload(slice_type))

    # ------------------------------------------------------------------
    # B pipeline (x264 frame reordering, encoder.c:2179-2228: display
    # order in, decode order out; anchor first, then its B frames)
    # ------------------------------------------------------------------
    def _encode_frame_bpipe(self, frame: Frame) -> bytes:
        y, u, v = self._pad(frame)
        is_idr, satd = self.lookahead.decide(y)
        if self.ref is None:
            is_idr = True
        disp = self._disp_idx
        self._disp_idx += 1
        # --qpfile forced slice types steer the GOP structure here too
        # (x264 parse_qpfile, x264.c:862-868); forced QPs apply at the
        # per-frame encodes below
        forced = self.rc.forced(disp)
        force_anchor = False
        if forced is not None:
            ftype = forced[0]
            if ftype in ("I", "i", "K"):
                is_idr = True
                self.lookahead.last_keyframe = disp
            elif ftype in ("P", "p"):
                is_idr = False
                force_anchor = True
            elif ftype in ("B", "b"):
                is_idr = False
        out = b""
        if is_idr:
            # display-before-IDR constraint: pending frames cannot be
            # coded as B against an IDR anchor; flush them as P chain
            out += self._flush_pending_as_p()
            self._last_idr_disp = disp
            out += self._encode_anchor(frame, y, u, v, True, satd, disp)
            self._anchor_lr = self.lookahead.prev_lr
            return out
        self._bbuf.append((frame, y, u, v, satd, disp,
                           self.lookahead.prev_lr))
        if force_anchor:
            return out + self._flush_gop()
        if self.p.b_adapt >= 2:
            # B-placement trellis over the lookahead window
            # (x264_slicetype_analyse B_ADAPT_TRELLIS, slicetype.c:476;
            # window sizing encoder.c:713-726)
            window = max(self.p.bframes + 1,
                         min(self.p.rc_lookahead, 12))
            if len(self._bbuf) < window:
                return out
            k = self.lookahead.decide_b_placement(
                self._anchor_lr, [b[6] for b in self._bbuf],
                self.p.bframes)
            return out + self._flush_gop_k(k)
        adapt_close = (self.p.b_adapt == 1 and len(self._bbuf) > 1
                       and self.lookahead.bad_b_candidate)
        if len(self._bbuf) <= self.p.bframes and not adapt_close:
            return out
        return out + self._flush_gop()

    def flush(self) -> bytes:
        """Emit any frames still buffered for B reordering or deferred
        by the pipelined driver (call after the last encode_frame;
        x264's delayed-frames drain)."""
        out = self._deep_drain()
        out += self._drain_pending()
        # b-adapt 2 windows can hold more than bframes+1 frames: keep
        # running the placement DP until one GOP remains
        while len(self._bbuf) > self.p.bframes + 1:
            k = self.lookahead.decide_b_placement(
                self._anchor_lr, [b[6] for b in self._bbuf],
                self.p.bframes)
            out += self._flush_gop_k(k)
        if self._bbuf:
            out += self._flush_gop()
        return out

    def _flush_pending_as_p(self) -> bytes:
        out = b""
        for (f, y, u, v, satd, disp, lr) in self._bbuf:
            out += self._encode_anchor(f, y, u, v, False, satd, disp)
            self._anchor_lr = lr
        self._bbuf = []
        return out

    def _flush_gop(self) -> bytes:
        """Encode the newest buffered frame as the P anchor, then the
        remaining buffered frames as B (decode order)."""
        return self._flush_gop_k(len(self._bbuf) - 1)

    def _flush_gop_k(self, k: int) -> bytes:
        """Encode buffered frame k as the P anchor and frames [0, k)
        as its B frames (decode order); frames after k stay buffered
        (the b-adapt trellis window keeps sliding)."""
        from . import bslice as BSW
        items = self._bbuf
        self._bbuf = items[k + 1:]
        f, y, u, v, satd, disp, lr = items[k]
        ref_l0 = self.ref                 # previous anchor (device)
        l0_disp = self._anchor_disp
        mref = self.p.ref_frames > 1
        self._b_l0_stack = ((self._dpb_stacked()
                             + (list(self._dpb_disps),))
                            if mref and not self.p.b_pyramid else None)
        out = self._encode_anchor(f, y, u, v, False, satd, disp)
        self._anchor_lr = lr
        ref_l1 = self.ref                 # the new anchor
        col = self._col
        anchor_qp = self._cur_qp
        if self.p.b_pyramid and k >= 2:
            # keep the middle B as a reference (x264 encoder.c:2207:
            # anchor, then BREF, then the remaining Bs in display
            # order); the outer Bs reference it through the default
            # POC-ordered lists, and the NEXT anchor emits one L0
            # reordering op to stay on the previous anchor
            mid = k // 2
            bf, by, bu, bv, bsatd, mdisp, _ = items[mid]
            # the anchor's own L0 disp list, for map_col_to_list0 of
            # every B whose colocated frame (L1[0]) is the anchor
            anchor_poc0 = self._dpb_store[0]["_ref_poc0"]
            # pre-GOP L0 window (POC-descending past refs, incl. any
            # previous BREFs still in the sliding window)
            past0, disps0 = self._b_l0_view(mdisp)
            stack0 = (self._b_l0_stack_of(past0) + (disps0,)
                      if mref else None)
            w1 = BSW.bipred_weight(2 * mdisp, 2 * l0_disp, 2 * disp,
                                   self.p.weightb)
            nal, bref_ref, bref_col, bref_col_l0 = self._encode_b_frame(
                bf, by, bu, bv, ref_l0, ref_l1, col, anchor_qp, bsatd,
                mdisp, w1=w1,
                pocs=(2 * mdisp, 2 * l0_disp, 2 * disp), is_ref=True,
                l0_stack=stack0, col_poc0=anchor_poc0)
            out += nal
            # the BREF enters the sliding window (a reference B):
            # late Bs lead L0 with it, the next P sees it at list
            # position 1 after the reordering op
            self._ref_meta = (mdisp, self.frame_num - 1, False,
                              disps0)
            self._push_ref(bref_ref)
            stack1 = None
            if mref:
                past1, disps1 = self._b_l0_view(disp)   # BREF + past
                stack1 = self._b_l0_stack_of(past1) + (disps1,)
            for i, (bf, by, bu, bv, bsatd, bdisp, _) in \
                    enumerate(items[:k]):
                if i == mid:
                    continue
                if bdisp < mdisp:   # L1[0] = BREF (nearest future)
                    r0, r1, c = ref_l0, bref_ref, bref_col
                    pocs = (2 * bdisp, 2 * l0_disp, 2 * mdisp)
                    stk, cp0, ct = stack0, disps0, bref_col_l0
                else:               # L0[0] = BREF (nearest past)
                    r0, r1, c = bref_ref, ref_l1, col
                    pocs = (2 * bdisp, 2 * mdisp, 2 * disp)
                    stk, cp0, ct = stack1, anchor_poc0, None
                w1 = BSW.bipred_weight(*pocs, self.p.weightb)
                out += self._encode_b_frame(bf, by, bu, bv, r0, r1, c,
                                            anchor_qp, bsatd, bdisp,
                                            w1=w1, pocs=pocs,
                                            l0_stack=stk, col_poc0=cp0,
                                            col_t=ct)
            self._reorder_next_p = True
            return out
        # multi-ref B lists: the L0 list is the past-ref DPB as it
        # stood BEFORE this GOP's anchor entered (newest first — the
        # default B L0 order, POC descending past; spec 8.2.4.2.3)
        l0_stack = self._b_l0_stack
        # colocated (the anchor)'s L0 = the same window: map is the
        # identity; pass the disp list so the derivation stays uniform
        anchor_poc0 = self._dpb_store[0]["_ref_poc0"]
        for (bf, by, bu, bv, bsatd, bdisp, _) in items[:k]:
            # implicit bipred weight from the display (=POC/2)
            # distances (x264_macroblock_bipred_init)
            w1 = BSW.bipred_weight(2 * bdisp, 2 * l0_disp, 2 * disp,
                                   self.p.weightb)
            out += self._encode_b_frame(bf, by, bu, bv, ref_l0, ref_l1,
                                        col, anchor_qp, bsatd, bdisp,
                                        w1=w1,
                                        pocs=(2 * bdisp, 2 * l0_disp,
                                              2 * disp),
                                        l0_stack=l0_stack,
                                        col_poc0=anchor_poc0)
        return out

    def _zone_qp(self, qp: int, disp: int) -> int:
        """Apply --zones to a frame QP (reference parse_zone q=/b=,
        ratecontrol.c:602-640: q= forces the QP; b= scales qscale by
        1/b, i.e. qp -= 6*log2(b))."""
        zq, zb = self._zones.lookup(disp)
        if zq is not None:
            return zq
        if zb is not None:
            import math
            return int(np.clip(round(qp - 6.0 * math.log2(zb)),
                               self.p.qp_min, self.p.qp_max))
        return qp

    def _take_reorder_l0(self):
        """One-shot L0 reordering ops for the next P slice. After a
        pyramid GOP the default PicNum-descending list leads with the
        BREF; one op puts the previous anchor first (x264
        encoder/encoder.c:138-150 emits the same)."""
        if not self._reorder_next_p:
            return None
        self._reorder_next_p = False
        diff = self._last_anchor_fn - self.frame_num
        if diff == 0:
            return None
        return [(0 if diff < 0 else 1, abs(diff) - 1)]

    def _encode_anchor(self, frame, y, u, v, is_idr: bool, satd,
                       disp: int) -> bytes:
        t0 = time.time()
        qp = self.rc.start(SLICE_I if is_idr else SLICE_P, satd)
        forced = self.rc.forced(disp)
        if forced is not None and forced[1] >= 0:
            qp = forced[1]
        qp = self._zone_qp(qp, disp)
        self._cur_qp = qp
        self._poc_lsb = 2 * (disp - self._last_idr_disp)
        out = self._aud(SLICE_I if is_idr else SLICE_P)
        if is_idr:
            self.frame_num = 0
            self.dpb = []
            self._dpb_store = []
            self._dpb_disps = []
            self._reorder_next_p = False   # IDR resets the DPB
            self.lookahead.last_keyframe = disp
            out += self.headers()
            self._ref_meta = (disp, 0, True, [])
            nal = self._encode_i(y, u, v, qp)
            out += nal_unit(NAL_SLICE_IDR, NAL_PRIORITY_HIGHEST, nal)
            self.stats.i_frames += 1
        else:
            self._ref_meta = (disp, self.frame_num, True,
                              list(self._dpb_disps))
            nal = self._encode_p(y, u, v, qp)
            out += nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH, nal)
            self.stats.p_frames += 1
        self._last_anchor_fn = self.frame_num
        self._save_col()
        self._anchor_disp = disp
        self._accumulate_psnr(frame)
        if self.keep_recon:
            self.recon_by_disp[disp] = tuple(
                np.asarray(x).copy() for x in self.recon_prev)
        self.frame_num += 1
        self._frame_idx += 1
        self.stats.frames += 1
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        self._emit_au(disp, out, "I" if is_idr else "P")
        return out

    def _save_col(self):
        """Record the anchor's 4x4 motion field for B spatial-direct
        colocated checks (decoder twin keeps the same field)."""
        p = self.p
        info = self.last_frame_info
        h4, w4 = 4 * p.mb_height, 4 * p.mb_width
        if info.get("mv8") is None:    # I anchor: all intra
            self._col = (np.zeros((h4, w4, 2), np.int32),
                         np.full((h4, w4), -1, np.int32))
            return
        # sub-8x8 anchors carry a true per-4x4 field; the decoder's
        # colocated corner checks (8.4.1.2.2) read that exact field, so
        # never coarsen it to 8x8 granularity here
        mv4 = info.get("mv4")
        if mv4 is None:
            mv4 = np.repeat(np.repeat(info["mv8"], 2, 0), 2, 1)
        intra4 = np.repeat(np.repeat(info["kind"] >= 2, 4, 0), 4, 1)
        ref8 = info.get("ref8")
        ref4 = (np.zeros((h4, w4), np.int32) if ref8 is None
                else np.repeat(np.repeat(ref8, 2, 0), 2, 1))
        self._col = (mv4, np.where(intra4, -1, ref4).astype(np.int32))

    def _encode_frame_ipp(self, frame: Frame) -> bytes:
        t0 = time.time()
        y, u, v = self._pad(frame)
        p = self.p
        if (self._stego is not None and p.partitions and not p.p4x4
                and p.ref_frames == 1 and p.rc_mode == 0
                and not p.aq_mode          # AQ rides the non-fused path
                and self.ref is not None
                and self.lookahead.prev_lr is not None
                and self.rc.forced(self._frame_idx) is None):
            if (p.pipeline_deep and p.pipeline and p.deblock
                    and self._deblock_on_device() and not p.trellis
                    and not p.transform_8x8 and not p.rd
                    and self.p.noise_reduction == 0
                    and not (p.psnr or p.ssim or self.keep_recon)):
                return self._encode_frame_ipp_deep(frame, y, u, v, t0)
            return self._encode_frame_ipp_fast(frame, y, u, v, t0)
        # leaving the fast path (forced frame / config change): keep AU
        # order by draining any deferred entropy first
        out_pend = self._deep_drain() + self._drain_pending()
        # slicetype decision: lookahead scenecut/keyint (slicetype.c:578)
        is_idr, satd = self.lookahead.decide(y)
        if self.ref is None:
            is_idr = True
        forced = self.rc.forced(self._frame_idx)
        if forced is not None:
            ftype, fqp = forced
            is_idr = ftype in ("I", "i", "K")
            if is_idr:
                self.lookahead.last_keyframe = self._frame_idx
        qp = self.rc.start(SLICE_I if is_idr else SLICE_P, satd)
        if forced is not None and forced[1] >= 0:
            qp = forced[1]
        qp = self._zone_qp(qp, self._frame_idx)
        self._cur_qp = qp
        out = self._aud(SLICE_I if is_idr else SLICE_P)
        if is_idr:
            self.frame_num = 0
            self.dpb = []   # IDR resets the DPB
            self._dpb_store = []
            self._dpb_disps = []
            out += self.headers()
            self._ref_meta = (self._frame_idx, 0, True, [])
            nal = self._encode_i(y, u, v, qp)
            out += nal_unit(NAL_SLICE_IDR, NAL_PRIORITY_HIGHEST, nal)
            self.stats.i_frames += 1
        else:
            self._ref_meta = (self._frame_idx, self.frame_num, True,
                              list(self._dpb_disps))
            nal = self._encode_p(y, u, v, qp)
            out += nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH, nal)
            self.stats.p_frames += 1
        self._accumulate_psnr(frame)
        if self.keep_recon:
            self.recon_by_disp[self._frame_idx] = tuple(
                np.asarray(x).copy() for x in self.recon_prev)
        self._emit_au(self._frame_idx, out, "I" if is_idr else "P")
        self.frame_num += 1
        self._frame_idx += 1
        self.stats.frames += 1
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        return out_pend + out

    def _encode_frame_ipp_fast(self, frame: Frame, y, u, v, t0) -> bytes:
        """Speculative-P IPPP step for the stego serving path (CQP):
        the lowres slice-type costs ride the fused stage-1 packed pull,
        so a steady-state P frame costs exactly TWO blocking pulls
        (stage-1 packed, then levels). On the rare IDR decision
        (keyint expiry / scenecut) the speculative stage-1 work is
        discarded and the I path runs as usual.

        Pipelined mode (p.pipeline, metrics off, device deblock): the
        level pull + entropy of frame N are deferred to frame N+1's
        call, where they overlap the device's stage-1 — ONE blocking
        pull per steady-state frame. Output AUs lag one frame; flush()
        drains the tail (same contract as the B pipe)."""
        p = self.p
        out_spec = self._deep_drain()   # mode switch: drain the spec
        pipelined = (p.pipeline and p.deblock and self._deblock_on_device()
                     and not (p.psnr or p.ssim or self.keep_recon))
        lr2 = self.lookahead.costs_device(y)     # dispatch only
        qp = self.rc.start(SLICE_P, 1)           # CQP: satd unused
        qp = self._zone_qp(qp, self._frame_idx)
        self._cur_qp = qp
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        d = self._fused_dispatch(y, u, v, qp, qpc, extra=lr2)
        # previous frame's entropy runs while the device is busy with
        # this frame's stage-1
        out_prev = out_spec + self._drain_pending()
        n = p.mb_height * p.mb_width
        packed = np.asarray(d["packed"])         # ONE pull, costs ride
        ci, cp = int(packed[24 * n]), int(packed[24 * n + 1])
        is_idr, satd = self.lookahead.decide_from_costs(ci, cp)
        out = self._aud(SLICE_I if is_idr else SLICE_P)
        if is_idr:
            qp = self._zone_qp(self.rc.start(SLICE_I, satd),
                               self._frame_idx)
            self._cur_qp = qp
            self.frame_num = 0
            self.dpb = []
            self._dpb_store = []
            self._dpb_disps = []
            out += self.headers()
            self._ref_meta = (self._frame_idx, 0, True, [])
            nal = self._encode_i(y, u, v, qp)
            out += nal_unit(NAL_SLICE_IDR, NAL_PRIORITY_HIGHEST, nal)
            self.stats.i_frames += 1
        elif pipelined:
            d["packed"] = packed
            pend = self._fused_complete(d, pipelined=True)
            pend.update(frame_num=self.frame_num,
                        poc_lsb=self._poc_lsb, disp=self._frame_idx,
                        aud=out)
            self._pending_p = pend
            self.stats.p_frames += 1
            self.frame_num += 1
            self._frame_idx += 1
            self.stats.frames += 1
            self.stats.elapsed += time.time() - t0
            return out_prev
        else:
            d["packed"] = packed
            res_np, part_np, mvd, skip, final8, intra_kind = \
                self._fused_complete(d)
            nal = self._finish_p_slice(
                res_np, qp, part_np, mvd, skip, intra_kind, None, None,
                final8, intra_kind > 0, False, update_state=False)
            out += nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH, nal)
            self.stats.p_frames += 1
        self._accumulate_psnr(frame)
        if self.keep_recon:
            self.recon_by_disp[self._frame_idx] = tuple(
                np.asarray(x).copy() for x in self.recon_prev)
        self._emit_au(self._frame_idx, out, "I" if is_idr else "P")
        self.frame_num += 1
        self._frame_idx += 1
        self.stats.frames += 1
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        return out_prev + out

    def _drain_pending(self) -> bytes:
        """Pipelined driver: pull the deferred frame's lean entropy
        buffer (enqueued before last frame's deblock waves — already
        materialized, the fetch does not wait on the device queue) and
        write its slice NAL."""
        pd = self._pending_p
        if pd is None:
            return b""
        self._pending_p = None
        t0 = time.time()
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        res_np = _unpack_frame_lean(np.asarray(pd["buf"]), mbh, mbw,
                                    pd["has8"])
        if res_np is None:   # exception overflow (very low QP): exact
            res_np = _res_to_host(pd["res"], mbh, mbw,
                                  with_recon=False)
        nal = self._finish_p_slice(
            res_np, pd["qp"], pd["part"], pd["mvd"], pd["skip"],
            np.zeros((mbh, mbw), np.int32), None, None, pd["final8"],
            np.zeros((mbh, mbw), bool), False,
            frame_num=pd["frame_num"], poc_lsb=pd["poc_lsb"],
            update_state=False)
        out = pd["aud"] + nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH, nal)
        self._emit_au(pd["disp"], out, "P")
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        return out

    # ------------------------------------------------------------------
    # Deep-pipelined IPP serving step (Params.pipeline_deep; design
    # note at partition.py p_stage1_spec): the NEXT frame's analysis
    # is speculated against the previous frame's PASS-1 (pre-flip)
    # reconstruction so the packed pull and the host STC overlap
    # device work; once the previous frame's flips land, a
    # PATCH re-runs this frame's pass-1 encode against the TRUE
    # deblocked reference — levels/cbp/skip and the packed stego
    # inputs are exact; only the mv/partition choices and probe SATD
    # maps saw the pre-flip recon (conformant bitstream, blind
    # extraction contract intact). Output AUs lag TWO frames.
    # ------------------------------------------------------------------
    def _encode_frame_ipp_deep(self, frame: Frame, y, u, v,
                               t0) -> bytes:
        from . import partition as PT
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        qp = self._zone_qp(self.rc.start(SLICE_P, 1), self._frame_idx)
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        lam = ME.lambda_tab(qp)
        spec = getattr(self, "_spec", None)
        if spec is None:
            spec = self._spec = dict(ref=None, prev_mv=None, pend=None)
        ref_s = spec["ref"] if spec["ref"] is not None else self.ref
        pmv = spec["prev_mv"]
        if pmv is None:
            pmv = jnp.asarray(self.prev_mv)
        part, mv8, SK, SP, sc8 = PT.p_stage1_spec(
            y, ref_s["luma"], pmv, qp, lam, p.me_range, mbh, mbw,
            p.subpel, p.dct_decimate)
        out = self._drain_pending()

        pend = spec["pend"]
        spec["pend"] = None
        if pend is not None:
            done, idr_bytes = self._deep_complete(pend)
            out += idr_bytes
            if not done:
                # IDR fallback invalidated this frame's speculative
                # analysis (stale reference): redo it against the IDR
                part, mv8, SK, SP, sc8 = PT.p_stage1_spec(
                    y, self.ref["luma"], jnp.asarray(self.prev_mv),
                    qp, lam, p.me_range, mbh, mbw, p.subpel,
                    p.dct_decimate)

        # ---- patch this frame against the TRUE reference + pack ----
        lr2 = self.lookahead.costs_device(y)   # prev_lr is now F_{k-1}
        cmv = self._cost_mv_dev(qp, lam)
        packed2, res = PT.p_patch_pack(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
            part, mv8, SK, SP, sc8, qp, qpc, cmv, lr2, mbh, mbw,
            p.dct_decimate, False, nr_offset=None)
        n = mbh * mbw
        skip_dev = packed2[11 * n:12 * n].astype(jnp.int32) \
            .reshape(mbh, mbw)
        spec["ref"] = self._spec_deblock_ref(res, skip_dev, mv8, qp,
                                             qpc)
        spec["prev_mv"] = mv8[::2, ::2]
        incr_ok = p.incremental and not p.trellis \
            and p.noise_reduction == 0 and not p.transform_8x8 \
            and self._aq_grids is None
        # the packed pull happens at the next call's completion step
        spec["pend"] = dict(
            d=dict(packed=packed2, res=res, y=y, u=u, v=v, qp=qp,
                   qpc=qpc, incr_ok=incr_ok),
            disp=self._frame_idx, frame_num=self.frame_num,
            poc_lsb=self._poc_lsb, aud=self._aud(SLICE_P))
        self.frame_num += 1
        self._frame_idx += 1
        self.stats.frames += 1
        self.stats.elapsed += time.time() - t0
        return out

    def _deep_complete(self, pend) -> tuple:
        """Finish a speculated frame: pull its patched packed array,
        decide its slice type, and either run the pipelined completion
        (STC + flips + re-encode + deblock; entropy deferred to
        _drain_pending) or fall back to an IDR encode (speculative
        work discarded — keyint/scenecut, rare). Returns
        (completed_as_p, idr_bytes)."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        d = pend["d"]
        packed = np.asarray(d["packed"])
        ci, cp = int(packed[24 * n]), int(packed[24 * n + 1])
        is_idr, satd = self.lookahead.decide_from_costs(ci, cp)
        if is_idr:
            qp_i = self._zone_qp(self.rc.start(SLICE_I, satd),
                                 pend["disp"])
            self._cur_qp = qp_i
            self.frame_num = 0
            self.dpb = []
            self._dpb_store = []
            self._dpb_disps = []
            out = self._aud(SLICE_I) + self.headers()
            self._ref_meta = (pend["disp"], 0, True, [])
            nal = self._encode_i(d["y"], d["u"], d["v"], qp_i)
            out += nal_unit(NAL_SLICE_IDR, NAL_PRIORITY_HIGHEST, nal)
            self.stats.i_frames += 1
            self.frame_num = 1
            self._emit_au(pend["disp"], out, "I")
            self.stats.bits += 8 * len(out)
            self.rc.end(8 * len(out))
            # the spec chain restarts from the IDR reference
            self._spec.update(ref=None, prev_mv=None)
            return False, out
        d["packed"] = packed
        self._cur_qp = d["qp"]
        self._ref_meta = (pend["disp"], pend["frame_num"], True, [])
        rec = self._fused_complete(d, pipelined=True)
        rec.update(frame_num=pend["frame_num"],
                   poc_lsb=pend["poc_lsb"], disp=pend["disp"],
                   aud=pend["aud"])
        self._pending_p = rec
        self.stats.p_frames += 1
        return True, b""

    def _deep_drain(self) -> bytes:
        """Complete + drain any speculated frame (flush / fast-path
        exit)."""
        spec = getattr(self, "_spec", None)
        if spec is None or spec["pend"] is None:
            return b""
        pend = spec["pend"]
        spec["pend"] = None
        # the deferred entropy slot may still hold the PREVIOUS frame:
        # drain it before the completion claims the slot
        out = self._drain_pending()
        done, idr_bytes = self._deep_complete(pend)
        out += idr_bytes
        out += self._drain_pending()
        spec.update(ref=None, prev_mv=None)
        return out

    def _spec_deblock_ref(self, res, skip_dev, mv8, qp, qpc):
        """Deblock the (patched) pass-1 recon into the speculative
        reference for the next frame's analysis (device-resident;
        mirrors _deblock_device without touching the DPB)."""
        from ..ops.deblock_jax import deblock_frame_device
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        nnz_dev = _nnz4_device(res["luma_lev"], mbh, mbw)
        mv4 = jnp.repeat(jnp.repeat(mv8, 2, 0), 2, 1)
        intra = jnp.zeros((mbh, mbw), jnp.int32)
        off_a, off_b = 2 * p.deblock_alpha, 2 * p.deblock_beta
        dy, du, dv = deblock_frame_device(
            res["recon_y"].astype(jnp.int32),
            res["recon_u"].astype(jnp.int32),
            res["recon_v"].astype(jnp.int32),
            intra, skip_dev, nnz_dev, mv4, qp, qpc, mbh, mbw,
            qp_thresh=(15 - min(off_a, off_b)
                       - max(0, p.chroma_qp_offset)),
            ref4=None, trans8=None, off_a=off_a, off_b=off_b)
        return mc.build_ref(dy, du, dv)

    # ------------------------------------------------------------------
    def _encode_i(self, y, u, v, qp: int) -> bytes:
        p = self.p
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        qp_enc, qpc_enc = qp, qpc
        self._aq_grids = None
        if p.aq_mode:
            # per-MB QP on I frames too (x264 applies AQ to all types)
            from ..ops.aq import aq_offsets, assign_qp_grid
            from ..ops.transform import CHROMA_QP_TABLE
            offs = np.asarray(aq_offsets(
                y, u, v, p.mb_height, p.mb_width,
                jnp.float32(p.aq_strength)))
            qp_grid = assign_qp_grid(qp, offs, p.qp_min, p.qp_max)
            qpc_grid = CHROMA_QP_TABLE[np.clip(
                qp_grid + p.chroma_qp_offset, 0, 51)].astype(np.int32)
            self._aq_grids = (qp_grid, qpc_grid)
            qp_enc = jnp.asarray(qp_grid)
            qpc_enc = jnp.asarray(qpc_grid)
        res_dev = I.encode_i_frame(y, u, v, qp_enc, qpc_enc, p.mb_width,
                                   p.mb_height, lam=ME.lambda_tab(qp),
                                   i4x4=p.i4x4, i8x8=p.transform_8x8,
                                   rd=bool(p.rd), trellis=bool(p.trellis))
        res = {k: np.asarray(val) for k, val in res_dev.items()}
        qp_maps = (None, None)
        if self._aq_grids is not None:
            # decoder-visible chain: I16 always codes mb_qp_delta;
            # I_NxN only with residual (spec 7.4.5)
            from ..ops.aq import effective_qp_grid
            from ..ops.transform import CHROMA_QP_TABLE
            i16 = ~res["mb_i4"].astype(bool)
            if p.transform_8x8:
                i16 &= ~res["mb_i8"].astype(bool)
            coded = i16 | ((res["cbp_luma"] | res["cbp_chroma"]) != 0)
            eff = effective_qp_grid(self._aq_grids[0], coded, qp)
            eff_c = CHROMA_QP_TABLE[np.clip(
                eff + p.chroma_qp_offset, 0, 51)].astype(np.int32)
            qp_maps = (eff, eff_c)
        if p.deblock and self._deblock_on_device():
            mbh2, mbw2 = p.mb_height, p.mb_width
            t8_i = None
            if p.transform_8x8:
                # I_8x8 MBs carry transform_size_8x8_flag = 1
                # regardless of cbp (spec 7.3.5 intra I_NxN signalling)
                t8_i = res_dev["mb_i8"]
                nnz_i = _nnz4_t8_device(res_dev["luma_ac"],
                                        res_dev["luma8_lev"], t8_i,
                                        mbh2, mbw2)
            else:
                nnz_i = _nnz4_device(res_dev["luma_ac"], mbh2, mbw2)
            self._deblock_device(
                res_dev, np.ones((mbh2, mbw2), np.int32),
                np.zeros((mbh2, mbw2), np.int32),
                np.zeros((4 * mbh2, 4 * mbw2, 2), np.int32), qp,
                nnz_i, qp_maps=qp_maps, trans8=t8_i)
        elif p.deblock and self._native is not None:
            self._deblock(res, intra=True, qp=qp,
                          trans8=(res["mb_i8"].astype(np.uint8)
                                  if p.transform_8x8 else None),
                          qp_maps=qp_maps)
        else:
            self._update_ref(res_dev)
            self.recon_prev = (res["recon_y"], res["recon_u"],
                               res["recon_v"])
        self.prev_mv = np.zeros((p.mb_height, p.mb_width, 2), np.int32)
        self.last_frame_info = {
            "kind": np.where(np.asarray(res["mb_i4"]), 3, 2),
            "part": None, "mv8": None}

        bw = BitWriter()
        H.write_slice_header(bw, self.sps, self.pps, H.SLICE_TYPE_I,
                             self.frame_num, qp, idr=True,
                             idr_pic_id=self.idr_pic_id,
                             disable_deblock=0 if self.p.deblock else 1,
                             alpha_div2=self.p.deblock_alpha,
                             beta_div2=self.p.deblock_beta,
                             poc_lsb=self._poc_lsb)
        self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        if p.cabac:
            return self._write_i_slice_cabac(bw, res, qp)
        if self._native is not None and self._aq_grids is None:
            from .. import native
            hdr, nbits = bw.partial_bytes()
            return native.write_slice(
                hdr, nbits, H.SLICE_TYPE_I, mbw, mbh,
                mode=res["mode"].reshape(n), cmode=res["cmode"].reshape(n),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_dc=res["luma_dc"].reshape(n, 16),
                luma_blocks=res["luma_ac"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16),
                mb_i4=res["mb_i4"].reshape(n) if p.i4x4 else None,
                i4_modes=res["i4_modes"].reshape(n, 16) if p.i4x4 else None,
                mb_i8=(res["mb_i8"].reshape(n).astype(np.uint8)
                       if p.transform_8x8 else None),
                i8_modes=(res["i8_modes"].reshape(n, 4)
                          if p.transform_8x8 else None),
                luma8_lev=(res["luma8_lev"]
                           if p.transform_8x8 else None),
                trans8_mode=p.transform_8x8)
        fc = FrameCavlc(mbw, mbh, trans8_mode=p.transform_8x8)
        aqg = self._aq_grids[0] if self._aq_grids is not None else None
        last_qp = qp
        for my in range(mbh):
            for mx in range(mbw):
                dq = 0
                has_cbp = (int(res["cbp_luma"][my, mx])
                           or int(res["cbp_chroma"][my, mx]))
                is_i16 = not ((p.i4x4 and res["mb_i4"][my, mx])
                              or (p.transform_8x8
                                  and res["mb_i8"][my, mx]))
                if aqg is not None and (has_cbp or is_i16):
                    # spec 7.4.5 modular fold (see the P twin)
                    dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                    last_qp = int(aqg[my, mx])
                if p.transform_8x8 and res["mb_i8"][my, mx]:
                    fc.write_i8x8_mb(
                        bw, mx, my, res["i8_modes"][my, mx],
                        int(res["cmode"][my, mx]),
                        int(res["cbp_luma"][my, mx]),
                        int(res["cbp_chroma"][my, mx]),
                        res["luma8_lev"][my, mx],
                        res["chroma_dc"][my, mx],
                        res["chroma_ac"][my, mx], qp_delta=dq)
                    continue
                if p.i4x4 and res["mb_i4"][my, mx]:
                    fc.write_i4x4_mb(
                        bw, mx, my, res["i4_modes"][my, mx],
                        int(res["cmode"][my, mx]),
                        int(res["cbp_luma"][my, mx]),
                        int(res["cbp_chroma"][my, mx]),
                        res["luma_ac"][my, mx],
                        res["chroma_dc"][my, mx],
                        res["chroma_ac"][my, mx], qp_delta=dq)
                    continue
                fc.write_i16x16_mb(
                    bw, mx, my,
                    int(res["mode"][my, mx]), int(res["cmode"][my, mx]),
                    int(res["cbp_luma"][my, mx]),
                    int(res["cbp_chroma"][my, mx]),
                    res["luma_dc"][my, mx], res["luma_ac"][my, mx],
                    res["chroma_dc"][my, mx], res["chroma_ac"][my, mx],
                    qp_delta=dq)
        bw.rbsp_trailing()
        return bw.get_bytes()

    def _write_i_slice_cabac(self, bw, res, qp) -> bytes:
        """CABAC I slice (encoder/cabac.c:781 I path)."""
        from .cabac import CabacSliceWriter
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        if self._native is not None and self._aq_grids is None:
            from .. import native
            hdr, nbits = bw.partial_bytes()
            return native.write_slice_cabac(
                hdr, nbits, H.SLICE_TYPE_I, mbw, mbh, qp,
                mode=res["mode"].reshape(n),
                cmode=res["cmode"].reshape(n),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_dc=res["luma_dc"].reshape(n, 16),
                luma_blocks=res["luma_ac"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16),
                mb_i4=res["mb_i4"].reshape(n) if p.i4x4 else None,
                i4_modes=(res["i4_modes"].reshape(n, 16)
                          if p.i4x4 else None),
                mb_i8=(res["mb_i8"].reshape(n)
                       if p.transform_8x8 else None),
                i8_modes=(res["i8_modes"].reshape(n, 4)
                          if p.transform_8x8 else None),
                luma8_lev=(res["luma8_lev"].reshape(n, 256)
                           if p.transform_8x8 else None),
                trans8_mode=p.transform_8x8)
        while not bw.byte_aligned():
            bw.write1(1)  # cabac_alignment_one_bit
        w = CabacSliceWriter(mbw, mbh, qp, slice_is_i=True,
                             trans8_mode=p.transform_8x8)
        aqg = self._aq_grids[0] if self._aq_grids is not None else None
        last_qp = qp
        n = mbh * mbw
        for a in range(n):
            my, mx = a // mbw, a % mbw
            dq = 0
            has_cbp = (int(res["cbp_luma"][my, mx])
                       or int(res["cbp_chroma"][my, mx]))
            is_i16 = not ((p.i4x4 and res["mb_i4"][my, mx])
                          or (p.transform_8x8
                              and res["mb_i8"][my, mx]))
            if aqg is not None and (has_cbp or is_i16):
                dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                last_qp = int(aqg[my, mx])
            if p.transform_8x8 and res["mb_i8"][my, mx]:
                w.write_i8_mb(my, mx, res["i8_modes"][my, mx],
                              int(res["cmode"][my, mx]),
                              int(res["cbp_luma"][my, mx]),
                              int(res["cbp_chroma"][my, mx]),
                              res["luma8_lev"][my, mx],
                              res["chroma_dc"][my, mx],
                              res["chroma_ac"][my, mx], dqp=dq)
                w.end_mb(a == n - 1)
                continue
            if p.i4x4 and res["mb_i4"][my, mx]:
                w.write_i4_mb(my, mx, res["i4_modes"][my, mx],
                              int(res["cmode"][my, mx]),
                              int(res["cbp_luma"][my, mx]),
                              int(res["cbp_chroma"][my, mx]),
                              res["luma_ac"][my, mx],
                              res["chroma_dc"][my, mx],
                              res["chroma_ac"][my, mx], dqp=dq)
            else:
                w.write_i16_mb(my, mx, int(res["mode"][my, mx]),
                               int(res["cmode"][my, mx]),
                               int(res["cbp_luma"][my, mx]) != 0,
                               int(res["cbp_chroma"][my, mx]),
                               res["luma_dc"][my, mx],
                               res["luma_ac"][my, mx],
                               res["chroma_dc"][my, mx],
                               res["chroma_ac"][my, mx], dqp=dq)
            w.end_mb(a == n - 1)
        w.end_slice(bw)
        return bw.get_bytes()

    @staticmethod
    def _refs4(part_np, ref8):
        """[mbh,mbw,4] per-ref-slot L0 refs for the native writers
        (slot layout of _refs_of; unused slots are 0)."""
        mbh, mbw = part_np.shape
        tl = ref8[::2, ::2]
        tr = ref8[::2, 1::2]
        bl = ref8[1::2, ::2]
        br = ref8[1::2, 1::2]
        r = np.zeros((mbh, mbw, 4), np.int32)
        r[..., 0] = tl
        r[..., 1] = np.where(part_np == 1, bl, tr)
        r[..., 2] = bl
        r[..., 3] = br
        return r

    @staticmethod
    def _refs_of(part: int, ref8, my: int, mx: int):
        """Per-ref-slot L0 refs of one MB from the per-8x8 field."""
        tl = ref8[2 * my, 2 * mx]
        if part == 0:
            return [tl]
        if part == 1:
            return [tl, ref8[2 * my + 1, 2 * mx]]
        if part == 2:
            return [tl, ref8[2 * my, 2 * mx + 1]]
        return [tl, ref8[2 * my, 2 * mx + 1],
                ref8[2 * my + 1, 2 * mx], ref8[2 * my + 1, 2 * mx + 1]]

    def _write_p_slice_cavlc_mref(self, bw, res, qp, part, mvd, skip,
                                  ref8, intra_kind=None,
                                  intra_res=None) -> bytes:
        """CAVLC P slice with multi-reference ref_idx syntax (native
        C++ twin when no intra MBs; Python writer otherwise)."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        if self._native is not None and intra_res is None \
                and self._aq_grids is None:
            from .. import native
            n = mbh * mbw
            hdr, nbits = bw.partial_bytes()
            return native.write_slice(
                hdr, nbits, H.SLICE_TYPE_P, mbw, mbh,
                skip=skip.reshape(n).astype(np.uint8),
                part=part.reshape(n), mvd4=mvd.reshape(n, 4, 2),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_blocks=res["luma_lev"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16),
                refs=self._refs4(part, ref8), num_ref=self._p_l0_eff,
                trans8=(res["trans8"].reshape(n).astype(np.uint8)
                        if p.transform_8x8 else None),
                luma8_lev=(res["luma8_lev"]
                           if p.transform_8x8 else None),
                trans8_mode=p.transform_8x8)
        fc = FrameCavlc(mbw, mbh, trans8_mode=p.transform_8x8)
        skip_run = 0
        aqg = self._aq_grids[0] if self._aq_grids is not None else None
        last_qp = qp
        for my in range(mbh):
            for mx in range(mbw):
                if skip[my, mx]:
                    skip_run += 1
                    fc.set_mb_nnz_zero(mx, my)
                    continue
                bw.write_ue(skip_run)
                skip_run = 0
                k = (0 if intra_kind is None
                     else int(intra_kind[my, mx]))
                if k == 2:
                    fc.write_i4x4_mb(
                        bw, mx, my, intra_res["i4_modes"][my, mx],
                        int(intra_res["cmode"][my, mx]),
                        int(intra_res["cbp_luma"][my, mx]),
                        int(intra_res["cbp_chroma"][my, mx]),
                        intra_res["luma_ac"][my, mx],
                        intra_res["chroma_dc"][my, mx],
                        intra_res["chroma_ac"][my, mx], qp_delta=0,
                        in_p_slice=True)
                    continue
                if k == 1:
                    fc.write_i16x16_mb(
                        bw, mx, my, int(intra_res["mode"][my, mx]),
                        int(intra_res["cmode"][my, mx]),
                        int(intra_res["cbp_luma"][my, mx]),
                        int(intra_res["cbp_chroma"][my, mx]),
                        intra_res["luma_dc"][my, mx],
                        intra_res["luma_ac"][my, mx],
                        intra_res["chroma_dc"][my, mx],
                        intra_res["chroma_ac"][my, mx], qp_delta=0,
                        in_p_slice=True)
                    continue
                pt = int(part[my, mx])
                dq = 0
                if aqg is not None and (
                        int(res["cbp_luma"][my, mx])
                        or int(res["cbp_chroma"][my, mx])):
                    # spec 7.4.5 modular fold (see the single-ref twin)
                    dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                    last_qp = int(aqg[my, mx])
                fc.write_p_mb(
                    bw, mx, my, pt, mvd[my, mx],
                    int(res["cbp_luma"][my, mx]),
                    int(res["cbp_chroma"][my, mx]),
                    res["luma_lev"][my, mx],
                    res["chroma_dc"][my, mx],
                    res["chroma_ac"][my, mx], qp_delta=dq,
                    refs=self._refs_of(pt, ref8, my, mx),
                    num_ref=self._p_l0_eff,
                    trans8=bool(p.transform_8x8
                                and res["trans8"][my, mx]),
                    luma8_lev=(res["luma8_lev"][my, mx]
                               if p.transform_8x8 else None))
        if skip_run:
            bw.write_ue(skip_run)
        bw.rbsp_trailing()
        return bw.get_bytes()

    def _write_p_slice_cabac(self, bw, res, qp, part, mvd, skip,
                             intra_kind=None, intra_res=None,
                             ref8=None) -> bytes:
        """CABAC P slice; part=None means 16x16-only (mvd [mbh,mbw,2])."""
        from .cabac import CabacSliceWriter
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        if self._native is not None and intra_res is None \
                and self._aq_grids is None:
            from .. import native
            hdr, nbits = bw.partial_bytes()
            if part is None:
                part_a = np.zeros((mbh, mbw), np.int32)
                mvd4 = np.zeros((mbh, mbw, 4, 2), np.int32)
                mvd4[:, :, 0, :] = mvd
            else:
                part_a, mvd4 = part, mvd
            return native.write_slice_cabac(
                hdr, nbits, H.SLICE_TYPE_P, mbw, mbh, qp,
                skip=skip.reshape(n).astype(np.uint8),
                part=part_a.reshape(n), mvd4=mvd4.reshape(n, 4, 2),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_blocks=res["luma_lev"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16),
                refs=(None if ref8 is None
                      else self._refs4(part_a, ref8)),
                num_ref=self._p_l0_eff,
                luma8_lev=(res["luma8_lev"].reshape(n, 256)
                           if p.transform_8x8 else None),
                trans8=(res["trans8"].astype(np.int32)
                        if p.transform_8x8 else None),
                trans8_mode=p.transform_8x8)
        while not bw.byte_aligned():
            bw.write1(1)
        w = CabacSliceWriter(mbw, mbh, qp, slice_is_i=False,
                             trans8_mode=p.transform_8x8)
        aqg = self._aq_grids[0] if self._aq_grids is not None else None
        last_qp = qp
        for a in range(n):
            my, mx = a // mbw, a % mbw
            k = 0 if intra_kind is None else int(intra_kind[my, mx])
            if skip[my, mx]:
                w.write_skip_mb(my, mx)
            elif k == 2:
                w.write_i4_mb(my, mx, intra_res["i4_modes"][my, mx],
                              int(intra_res["cmode"][my, mx]),
                              int(intra_res["cbp_luma"][my, mx]),
                              int(intra_res["cbp_chroma"][my, mx]),
                              intra_res["luma_ac"][my, mx],
                              intra_res["chroma_dc"][my, mx],
                              intra_res["chroma_ac"][my, mx], in_p=True)
            elif k == 1:
                w.write_i16_mb(my, mx, int(intra_res["mode"][my, mx]),
                               int(intra_res["cmode"][my, mx]),
                               int(intra_res["cbp_luma"][my, mx]) != 0,
                               int(intra_res["cbp_chroma"][my, mx]),
                               intra_res["luma_dc"][my, mx],
                               intra_res["luma_ac"][my, mx],
                               intra_res["chroma_dc"][my, mx],
                               intra_res["chroma_ac"][my, mx],
                               in_p=True)
            else:
                if part is None:
                    pt = 0
                    mvds = np.array([[mvd[my, mx, 0], mvd[my, mx, 1]],
                                     [0, 0], [0, 0], [0, 0]], np.int32)
                else:
                    pt = int(part[my, mx])
                    mvds = mvd[my, mx]
                dq = 0
                if aqg is not None and (
                        int(res["cbp_luma"][my, mx])
                        or int(res["cbp_chroma"][my, mx])):
                    # spec 7.4.5 modular fold (see the CAVLC twin)
                    dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                    last_qp = int(aqg[my, mx])
                w.write_p_mb(my, mx, pt, mvds,
                             int(res["cbp_luma"][my, mx]),
                             int(res["cbp_chroma"][my, mx]),
                             res["luma_lev"][my, mx],
                             res["chroma_dc"][my, mx],
                             res["chroma_ac"][my, mx],
                             refs=(None if ref8 is None
                                   else self._refs_of(pt, ref8, my, mx)),
                             num_ref=self._p_l0_eff,
                             trans8=bool(p.transform_8x8
                                         and res["trans8"][my, mx]),
                             luma8_lev=(res["luma8_lev"][my, mx]
                                        if p.transform_8x8 else None),
                             dqp=dq)
            w.end_mb(a == n - 1)
        w.end_slice(bw)
        return bw.get_bytes()

    def _write_p_slice_cabac_sub(self, bw, res, qp, part, sub_type, mvd,
                                 skip, intra_kind=None,
                                 intra_res=None, ref8=None) -> bytes:
        """CABAC P slice with sub-8x8 partitions (native twin when
        no intra MBs; Python oracle otherwise). mvd: [mbh,mbw,16,2]
        coding-order unit mvds."""
        from .cabac import CabacSliceWriter
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        if self._native is not None and intra_res is None \
                and self._aq_grids is None and not p.transform_8x8:
            from .. import native
            hdr, nbits = bw.partial_bytes()
            return native.write_slice_cabac(
                hdr, nbits, H.SLICE_TYPE_P, mbw, mbh, qp,
                skip=skip.reshape(n).astype(np.uint8),
                part=part.reshape(n), mvd4=mvd.reshape(n, 16, 2),
                sub_type=sub_type.reshape(n, 4),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_blocks=res["luma_lev"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16),
                refs=(None if ref8 is None
                      else self._refs4(part, ref8)),
                num_ref=self._p_l0_eff)
        while not bw.byte_aligned():
            bw.write1(1)
        w = CabacSliceWriter(mbw, mbh, qp, slice_is_i=False,
                             trans8_mode=p.transform_8x8)
        aqg = self._aq_grids[0] if self._aq_grids is not None else None
        last_qp = qp
        for a in range(n):
            my, mx = a // mbw, a % mbw
            k = 0 if intra_kind is None else int(intra_kind[my, mx])
            if skip[my, mx]:
                w.write_skip_mb(my, mx)
            elif k == 2:
                w.write_i4_mb(my, mx, intra_res["i4_modes"][my, mx],
                              int(intra_res["cmode"][my, mx]),
                              int(intra_res["cbp_luma"][my, mx]),
                              int(intra_res["cbp_chroma"][my, mx]),
                              intra_res["luma_ac"][my, mx],
                              intra_res["chroma_dc"][my, mx],
                              intra_res["chroma_ac"][my, mx], in_p=True)
            elif k == 1:
                w.write_i16_mb(my, mx, int(intra_res["mode"][my, mx]),
                               int(intra_res["cmode"][my, mx]),
                               int(intra_res["cbp_luma"][my, mx]) != 0,
                               int(intra_res["cbp_chroma"][my, mx]),
                               intra_res["luma_dc"][my, mx],
                               intra_res["luma_ac"][my, mx],
                               intra_res["chroma_dc"][my, mx],
                               intra_res["chroma_ac"][my, mx],
                               in_p=True)
            else:
                pt = int(part[my, mx])
                dq = 0
                if aqg is not None and (
                        int(res["cbp_luma"][my, mx])
                        or int(res["cbp_chroma"][my, mx])):
                    # spec 7.4.5 modular fold (see the 16x16 twin)
                    dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                    last_qp = int(aqg[my, mx])
                w.write_p_mb(my, mx, pt, mvd[my, mx],
                             int(res["cbp_luma"][my, mx]),
                             int(res["cbp_chroma"][my, mx]),
                             res["luma_lev"][my, mx],
                             res["chroma_dc"][my, mx],
                             res["chroma_ac"][my, mx],
                             sub_types=(sub_type[my, mx]
                                        if pt == 3 else None),
                             refs=(None if ref8 is None
                                   else self._refs_of(pt, ref8, my,
                                                      mx)),
                             num_ref=self._p_l0_eff,
                             trans8=bool(p.transform_8x8
                                         and "trans8" in res
                                         and res["trans8"][my, mx]),
                             luma8_lev=(res["luma8_lev"][my, mx]
                                        if p.transform_8x8
                                        and "luma8_lev" in res
                                        else None),
                             dqp=dq)
            w.end_mb(a == n - 1)
        w.end_slice(bw)
        return bw.get_bytes()

    def _deblock_on_device(self) -> bool:
        """True when the in-loop deblocker runs on the device (the
        bit-exact wavefront twin of the host C++ filter, full High
        profile: 8x8 transform-edge rule + alpha/beta offsets). It is
        the pipelined driver's requirement: the filtered reference
        then never leaves the device."""
        return self.p.deblock_device

    def _deblock_device(self, res, intra, skip, mv4, qp, nnz4_dev,
                        ref4=None, qp_maps=(None, None), trans8=None):
        """Device wavefront deblock (bit-exact C++ twin): the filtered
        reference never leaves the chip; recon is downloaded once for
        PSNR/dump only. qp_maps: effective per-MB (qp, qpc) grids
        under AQ (the decoder-visible chain)."""
        from ..ops.deblock_jax import deblock_frame_device
        p = self.p
        qp_arg = qp
        qpc_arg = chroma_qp(qp, p.chroma_qp_offset)
        if qp_maps[0] is not None:
            qp_arg = jnp.asarray(qp_maps[0])
            qpc_arg = jnp.asarray(qp_maps[1])
        off_a, off_b = 2 * p.deblock_alpha, 2 * p.deblock_beta
        dy, du, dv = deblock_frame_device(
            res["recon_y"].astype(jnp.int32),
            res["recon_u"].astype(jnp.int32),
            res["recon_v"].astype(jnp.int32),
            jnp.asarray(intra.astype(np.int32)),
            jnp.asarray(skip.astype(np.int32)),
            nnz4_dev, jnp.asarray(mv4), qp_arg, qpc_arg,
            p.mb_height, p.mb_width,
            # deblock.cpp qp_thresh = 15 - min(offA, offB) - max(cqo, 0)
            qp_thresh=(15 - min(off_a, off_b)
                       - max(0, p.chroma_qp_offset)),
            ref4=(jnp.asarray(ref4) if ref4 is not None else None),
            trans8=(jnp.asarray(trans8).astype(jnp.int32)
                    if trans8 is not None else None),
            off_a=off_a, off_b=off_b)
        self._push_ref(mc.build_ref(dy, du, dv))
        if self.p.psnr or self.p.ssim or self.keep_recon:
            self.recon_prev = (np.asarray(dy), np.asarray(du),
                               np.asarray(dv))
        else:
            # no metrics: the reference never leaves the chip; keep
            # device handles for --dump-yuv-style consumers
            self.recon_prev = (dy, du, dv)

    def _push_ref(self, refdict):
        """Sliding-window DPB update (newest first; spec 8.2.5.3).
        Consumes the meta staged by the encoding frame (display index,
        frame_num, anchor/BREF kind, the frame's own L0 disp list for
        map_col_to_list0) and re-derives the P-list view."""
        e = dict(refdict)
        disp, fn, anchor, ref_poc0 = (self._ref_meta
                                      or (0, 0, True, []))
        self._ref_meta = None
        e.update(_disp=disp, _fn=fn, _anchor=anchor,
                 _ref_poc0=list(ref_poc0))
        self._dpb_store.insert(0, e)
        del self._dpb_store[self.sps.num_ref_frames:]
        self._refresh_dpb_view()

    def _refresh_dpb_view(self):
        """P-list view over the store: [newest anchor] + the rest in
        PicNum-descending order, truncated to ref_frames — byte-equal
        to the decoder's default list after the single reordering op
        (_take_reorder_l0). Without a pyramid this IS decode order."""
        st = self._dpb_store
        if not st:
            self.dpb, self._dpb_disps, self.ref = [], [], None
            return
        head = next((e for e in st if e["_anchor"]), st[0])
        rest = sorted((e for e in st if e is not head),
                      key=lambda e: -e["_fn"])
        view = ([head] + rest)[:self.p.ref_frames]
        self.dpb = view
        self._dpb_disps = [e["_disp"] for e in view]
        self.ref = view[0]

    def _b_l0_view(self, bdisp: int):
        """B-slice L0 over the store: POC-descending past refs (spec
        8.2.4.2.3), truncated to ref_frames. Returns (entries, disps)."""
        past = sorted((e for e in self._dpb_store
                       if e["_disp"] < bdisp),
                      key=lambda e: -e["_disp"])[:self.p.ref_frames]
        return past, [e["_disp"] for e in past]

    def _b_l0_stack_of(self, entries):
        """Stack B L0 entries padded to ref_frames slots (same shape
        contract as _dpb_stacked)."""
        R = self.p.ref_frames
        es = list(entries) + [entries[0]] * (R - len(entries))
        return (jnp.stack([d["luma"] for d in es]),
                jnp.stack([d["u"] for d in es]),
                jnp.stack([d["v"] for d in es]),
                len(entries))

    def _dpb_stacked(self):
        """Stacked DPB arrays padded to ref_frames slots by repeating
        the newest entry (padding is masked out of the ref decision by
        n_valid; ties already resolve to the lower index)."""
        R = self.p.ref_frames
        dpb = list(self.dpb) + [self.dpb[0]] * (R - len(self.dpb))
        return (jnp.stack([d["luma"] for d in dpb]),
                jnp.stack([d["u"] for d in dpb]),
                jnp.stack([d["v"] for d in dpb]),
                len(self.dpb))

    def _update_ref(self, res):
        """Build padded + hpel reference planes from recon (device)."""
        self._push_ref(mc.build_ref(res["recon_y"], res["recon_u"],
                                    res["recon_v"]))

    def _deblock(self, res_np, intra, mv=None, skip=None, qp=None,
                 nnz4=None, ref4=None, trans8=None,
                 qp_maps=(None, None)):
        """In-loop deblocking on the host recon (native C++; reference
        x264_fdec_filter_row -> x264_frame_deblock_row, encoder.c:1035).
        Returns (y, u, v) uint8 deblocked planes and re-derives the
        device reference from them."""
        from .. import native
        p = self.p
        ry = np.ascontiguousarray(res_np["recon_y"], np.uint8)
        ru = np.ascontiguousarray(res_np["recon_u"], np.uint8)
        rv = np.ascontiguousarray(res_np["recon_v"], np.uint8)
        if nnz4 is None:
            key = "luma_ac" if intra is True else "luma_lev"
            nnz4 = np.count_nonzero(res_np[key], axis=(4, 5)) \
                .transpose(0, 2, 1, 3) \
                .reshape(4 * p.mb_height, 4 * p.mb_width)
        mbsh = (p.mb_height, p.mb_width)
        if isinstance(intra, np.ndarray):
            intra_a = intra.astype(np.uint8)
        else:
            intra_a = np.full(mbsh, 1 if intra else 0, np.uint8)
        mv_a = (np.zeros((*mbsh, 2), np.int32) if mv is None
                else np.ascontiguousarray(mv, np.int32))
        if qp is None:
            qp = self._cur_qp
        native.deblock_frame(ry, ru, rv, intra_a, nnz4.astype(np.int32),
                             mv_a, skip, qp,
                             chroma_qp(qp, p.chroma_qp_offset),
                             ref4=ref4, trans8=trans8,
                             alpha_off=2 * p.deblock_alpha,
                             beta_off=2 * p.deblock_beta,
                             qp_map=qp_maps[0], qpc_map=qp_maps[1],
                             chroma_qp_offset=p.chroma_qp_offset)
        self.recon_prev = (ry, ru, rv)
        # upload as uint8 (4x fewer bytes); build_ref casts on device
        self._push_ref(mc.build_ref(jnp.asarray(ry), jnp.asarray(ru),
                                    jnp.asarray(rv)))

    def analyse_p(self, y, qp=None):
        """Device motion analysis for a P frame (v2 table pipeline:
        full-pel search -> window gather -> qpel block table -> subpel
        argmin). Returns qpel MV field [mbh, mbw, 2] and caches the
        block tables for the stego pass."""
        from . import analyse2 as A2
        p = self.p
        lam = ME.lambda_tab(qp if qp is not None else self._cur_qp)
        mbh, mbw = p.mb_height, p.mb_width
        mv_q, r_idx, blocks, wht = A2.analyse_p_frame(
            y, self.ref["luma"], jnp.asarray(self.prev_mv), p.me_range,
            mbh, mbw, lam, p.subpel)
        self._ptables = {"blocks": blocks, "wht": wht, "r_idx": r_idx}
        return mv_q, None

    def _encode_p_parts(self, y, u, v, qp: int, qpc: int) -> bytes:
        """Partitioned P path (16x16/16x8/8x16/8x8)."""
        from . import partition as PT
        from . import scan as SCAN
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        lam = ME.lambda_tab(qp)
        multiref = p.ref_frames > 1
        if not multiref:
            # reconfig can shrink ref_frames mid-stream: the effective
            # L0 count must track the CURRENT path, not a stale mref
            # frame's n_valid (sh->i_num_ref_idx_l0_active = i_ref0)
            self._p_l0_eff = 1
        if self._stego is not None and not multiref and not p.aq_mode:
            return self._encode_p_parts_fused(y, u, v, qp, qpc)
        if multiref:
            refs_luma, refs_u, refs_v, n_valid = self._dpb_stacked()
            self._p_l0_eff = max(1, min(p.ref_frames, int(n_valid)))
            part, mv8, ref8, r_idx8, blocks8, wht8, mb_cost = \
                PT.analyse_p_frame_parts_mref(
                    y, refs_luma, jnp.asarray(n_valid),
                    jnp.asarray(self.prev_mv), p.me_range, mbh, mbw,
                    lam, p.subpel, p.ref_frames,
                    allow_parts=p.partitions)
        elif (p.rd >= 1 and self._stego is None and not p.aq_mode):
            # partition-shape RD re-rank (x264_mb_analyse_p_rd,
            # analyse.c:2117: shapes within 5/4 of the SATD best are
            # fully encoded and re-ranked by SSD + lambda2*exact bits).
            # Probe quantization uses trellis only at --trellis 2
            # (analyse.c:248 b_trellis = i_trellis > 1 && i_mbrd); the
            # final encode below trellises at any --trellis >= 1.
            part, mv8, r_idx8, blocks8, wht8, mb_cost = \
                PT.rd_rerank_parts(
                    y, u, v, self.ref["luma"], self.ref["u"],
                    self.ref["v"], jnp.asarray(self.prev_mv), qp, qpc,
                    p.me_range, mbh, mbw, lam, p.subpel,
                    decimate=p.dct_decimate, trellis=p.trellis > 1,
                    nr_offset=self._nr_offset(),
                    trans8=p.transform_8x8)
            ref8 = None
        else:
            part, mv8, r_idx8, blocks8, wht8, mb_cost = \
                PT.analyse_p_frame_parts(
                    y, self.ref["luma"], jnp.asarray(self.prev_mv),
                    p.me_range, mbh, mbw, lam, p.subpel)
            ref8 = None
        self._ptables8 = {"blocks": blocks8, "wht": wht8, "r_idx": r_idx8}
        qp_enc, qpc_enc = qp, qpc
        self._aq_grids = None
        if p.aq_mode:
            # per-MB QP from source AC energy
            # (x264_adaptive_quant_frame, ratecontrol.c:231)
            from ..ops.aq import aq_offsets, assign_qp_grid
            from ..ops.transform import CHROMA_QP_TABLE
            offs = np.asarray(aq_offsets(
                y, u, v, mbh, mbw, jnp.float32(p.aq_strength)))
            qp_grid = assign_qp_grid(qp, offs, p.qp_min, p.qp_max)
            qpc_grid = CHROMA_QP_TABLE[np.clip(
                qp_grid + p.chroma_qp_offset, 0, 51)].astype(np.int32)
            self._aq_grids = (qp_grid, qpc_grid)
            qp_enc = jnp.asarray(qp_grid)
            qpc_enc = jnp.asarray(qpc_grid)
        if multiref:
            res = P.encode_p_frame_device8_mref(
                y, u, v, refs_luma, refs_u, refs_v, mv8, ref8,
                qp_enc, qpc_enc, mbh, mbw, decimate=p.dct_decimate,
                trellis=bool(p.trellis), nr_offset=self._nr_offset())
            self._mref_stack = (refs_luma, refs_u, refs_v)
        else:
            res = P.encode_p_frame_device8(
                y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
                mv8, qp_enc, qpc_enc, mbh, mbw, decimate=p.dct_decimate,
                trellis=bool(p.trellis), nr_offset=self._nr_offset(),
                trans8=p.transform_8x8, rd=bool(p.rd))

        self._nr_update(res, 16 * mbh * mbw)
        # intra-vs-inter refinement (off while embedding — the
        # reference disables intra in P too, analyse.c:2862-2863;
        # off under AQ — the intra refine encodes at the frame QP)
        intra_res = None
        intra_kind = np.zeros((mbh, mbw), np.int32)
        if p.intra_in_p and self._stego is None and not p.aq_mode:
            ir = I.refine_p_intra(
                y, u, v, res["recon_y"], res["recon_u"], res["recon_v"],
                mb_cost, qp, qpc, mbw, mbh, lam=lam, i4x4=p.i4x4,
                trellis=bool(p.trellis))
            intra_kind = np.asarray(ir["intra_kind"])
            if intra_kind.any():
                intra_res = {k: np.asarray(val) for k, val in ir.items()}
                res = dict(res)
                for k in ("recon_y", "recon_u", "recon_v"):
                    res[k] = ir[k]

        # ONE pull for all per-MB metadata (part + mv + cbp + refs):
        # each blocking pull is a host-device round trip, so everything
        # the host scan needs crosses together; the bulky level arrays
        # cross once more after a possible stego re-encode
        n_mb = mbh * mbw
        metas = [part.reshape(-1), mv8.reshape(-1),
                 res["cbp_luma"].reshape(-1).astype(jnp.int32),
                 res["cbp_chroma"].reshape(-1).astype(jnp.int32)]
        if multiref:
            metas.append(ref8.reshape(-1))
        meta = np.asarray(jnp.concatenate(
            [m.astype(jnp.int32) for m in metas]))
        part_np = np.ascontiguousarray(meta[:n_mb]).reshape(mbh, mbw)
        mv8_np = np.ascontiguousarray(meta[n_mb:9 * n_mb]) \
            .reshape(2 * mbh, 2 * mbw, 2)
        cbp_l = np.ascontiguousarray(
            meta[9 * n_mb:10 * n_mb]).reshape(mbh, mbw)
        cbp_c = np.ascontiguousarray(
            meta[10 * n_mb:11 * n_mb]).reshape(mbh, mbw)
        ref8_np = (np.ascontiguousarray(meta[11 * n_mb:15 * n_mb])
                   .reshape(2 * mbh, 2 * mbw) if multiref else None)
        intra_mask = intra_kind > 0
        if self._native is not None:
            from .. import native
            skip, mvd, mvp, final8 = native.scan_p_parts(
                part_np, mv8_np, cbp_l, cbp_c,
                intra=intra_mask if intra_mask.any() else None,
                ref8=ref8_np)
        else:
            skip, mvd, mvp, final8 = SCAN.scan_p_frame(
                part_np, mv8_np, cbp_l, cbp_c,
                intra=intra_mask if intra_mask.any() else None,
                ref8=ref8_np)
        skip &= ~intra_mask
        if (p.rd >= 2 and self._stego is None and not multiref
                and not p.aq_mode):
            forced = self._rd_skip_force(y, u, v, qp, qpc, part_np,
                                         final8, skip, mvd, res,
                                         intra_mask)
            if forced is not None:
                final8, skip, mvd, res = forced
            refined = self._rd_qpel_refine(y, u, v, qp, qpc, part_np,
                                           final8, skip, mvd, res,
                                           intra_mask)
            if refined is not None:
                final8, skip, mvd, res = refined

        if self._stego is not None:
            replaced = self._stego.embed_frame_parts(
                self, y, u, v, part_np, mv8_np, None, skip, mvp,
                ref8=ref8_np)
            if replaced is not None:
                final8, skip, mvd, res = replaced
        return self._p_finalize(res, qp, part_np, mvd, skip, intra_kind,
                                intra_res, ref8_np, final8, intra_mask,
                                multiref)

    def _rd_qpel_refine(self, y, u, v, qp, qpc, part_np, final8,
                        skip, mvd, res, intra_mask):
        """--rd 2: qpel RD refine (the x264 subme>=7
        x264_me_refine_qpel_rd analog, one cross iteration): for each
        coded 16x16 MB, the frame re-encodes at the four +-1-qpel
        neighbours of the committed MV — per-MB costs from a uniformly
        shifted field ARE the per-MB individual-shift costs, since a P
        MB's residual depends only on its own MV — and the exact-RD
        winner (SSD + lambda2*(residual + header bits)) is kept.
        Winners commit, the rescan re-derives every mvd and P_SKIP MV
        in the new neighbour context, and the frame re-encodes once.
        Returns (final8, skip, mvd, res) or None."""
        from . import scan as SCAN
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        base = np.asarray(P.rd_coded_cost(
            y, u, v, res["luma_lev"], res["chroma_dc"],
            res["chroma_ac"], res["recon_y"], res["recon_u"],
            res["recon_v"], jnp.asarray(mvd), jnp.asarray(part_np),
            qp, mbh, mbw))
        elig = (part_np == 0) & ~skip & ~intra_mask
        if intra_mask.any():
            # an MB a committed intra MB predicts from may not change
            # its recon (same dep rule as the P_SKIP probe)
            dep = np.zeros_like(intra_mask)
            dep[:, :-1] |= intra_mask[:, 1:]
            dep[:-1, :] |= intra_mask[1:, :]
            dep[:-1, 1:] |= intra_mask[1:, :-1]
            dep[:-1, :-1] |= intra_mask[1:, 1:]
            elig &= ~dep
        if not elig.any():
            return None
        best = base.copy()
        best_off = np.zeros((mbh, mbw, 2), np.int32)
        for d in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            off = np.array(d, np.int32)
            mv8_d = final8 + off
            res_d = P.encode_p_frame_device8(
                y, u, v, self.ref["luma"], self.ref["u"],
                self.ref["v"], jnp.asarray(mv8_d), qp, qpc, mbh, mbw,
                decimate=p.dct_decimate, force_zero=jnp.asarray(skip),
                trellis=bool(p.trellis), nr_offset=self._nr_offset(),
                trans8=p.transform_8x8, rd=bool(p.rd))
            # mvd bits approximated at the pre-rescan predictors (the
            # rescan re-derives exactly; neighbours' recon is
            # untouched by an mvd-only change)
            cost_d = np.asarray(P.rd_coded_cost(
                y, u, v, res_d["luma_lev"], res_d["chroma_dc"],
                res_d["chroma_ac"], res_d["recon_y"],
                res_d["recon_u"], res_d["recon_v"],
                jnp.asarray(mvd + off), jnp.asarray(part_np),
                qp, mbh, mbw))
            upd = (cost_d < best) & elig
            best_off = np.where(upd[..., None], off, best_off)
            best = np.where(upd, cost_d, best)
        if not (best_off != 0).any():
            self._last_qpel_changed = 0
            return None
        self._last_qpel_changed = int((best_off != 0).any(-1).sum())
        off8 = np.repeat(np.repeat(best_off, 2, 0), 2, 1)
        final_new = (final8 + off8).astype(np.int32)
        final2, mvd2, _ = SCAN.scan_p_frame_forced(
            part_np, final_new, skip,
            intra=intra_mask if intra_mask.any() else None)
        res2 = P.encode_p_frame_device8(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
            jnp.asarray(final2), qp, qpc, mbh, mbw,
            decimate=p.dct_decimate, force_zero=jnp.asarray(skip),
            trellis=bool(p.trellis), nr_offset=self._nr_offset(),
            trans8=p.transform_8x8, rd=bool(p.rd))
        if intra_mask.any():
            res2 = dict(res2)
            m_y = jnp.asarray(
                np.repeat(np.repeat(intra_mask, 16, 0), 16, 1))
            res2["recon_y"] = jnp.where(m_y, res["recon_y"],
                                        res2["recon_y"])
            m_c = jnp.asarray(
                np.repeat(np.repeat(intra_mask, 8, 0), 8, 1))
            res2["recon_u"] = jnp.where(m_c, res["recon_u"],
                                        res2["recon_u"])
            res2["recon_v"] = jnp.where(m_c, res["recon_v"],
                                        res2["recon_v"])
        return final2, skip, mvd2, res2

    def _rd_skip_force(self, y, u, v, qp, qpc, part_np, final8,
                       skip, mvd, res, intra_mask):
        """--rd 2: P_SKIP RD probe (x264 i_mbrd skip decision analog).
        Per coded MB, compare SSD + lambda2*bits of the coded config
        against encoding as P_SKIP at the committed field's pskip MV;
        force the winners, rescan (exact pskip re-derivation in the
        new context) and re-encode with the residual dropped. Returns
        (final8, skip, mvd, res) or None when nothing flips."""
        from . import scan as SCAN
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        pskip = SCAN.pskip_field(part_np, final8, skip)
        cost_c, cost_s = P.rd_skip_eval(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
            jnp.asarray(pskip), res["luma_lev"], res["chroma_dc"],
            res["chroma_ac"], res["recon_y"], res["recon_u"],
            res["recon_v"], jnp.asarray(mvd), jnp.asarray(part_np),
            qp, mbh, mbw)
        force = (np.asarray(cost_s) < np.asarray(cost_c)) \
            & ~skip & ~intra_mask
        if intra_mask.any():
            # an MB whose recon a committed intra MB predicts from
            # (its A/B/C/D neighbour) may not change recon
            dep = np.zeros_like(intra_mask)
            dep[:, :-1] |= intra_mask[:, 1:]
            dep[:-1, :] |= intra_mask[1:, :]
            dep[:-1, 1:] |= intra_mask[1:, :-1]
            dep[:-1, :-1] |= intra_mask[1:, 1:]
            force &= ~dep
        if not force.any():
            return None
        skip2 = skip | force
        final2, mvd2, _ = SCAN.scan_p_frame_forced(
            part_np, final8, skip2,
            intra=intra_mask if intra_mask.any() else None)
        res2 = P.encode_p_frame_device8(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
            jnp.asarray(final2), qp, qpc, mbh, mbw,
            decimate=p.dct_decimate, force_zero=jnp.asarray(skip2),
            trellis=bool(p.trellis), nr_offset=self._nr_offset(),
            trans8=p.transform_8x8, rd=bool(p.rd))
        if intra_mask.any():
            # re-graft the intra patches: their predicted-from
            # neighbourhood recon is unchanged by the dep mask above
            res2 = dict(res2)
            m_y = jnp.asarray(
                np.repeat(np.repeat(intra_mask, 16, 0), 16, 1))
            res2["recon_y"] = jnp.where(m_y, res["recon_y"],
                                        res2["recon_y"])
            m_c = jnp.asarray(
                np.repeat(np.repeat(intra_mask, 8, 0), 8, 1))
            res2["recon_u"] = jnp.where(m_c, res["recon_u"],
                                        res2["recon_u"])
            res2["recon_v"] = jnp.where(m_c, res["recon_v"],
                                        res2["recon_v"])
        return final2, skip2, mvd2, res2

    def _p_state_update(self, part_np, skip, final8, intra_kind,
                        ref8_np, intra_mask):
        """Predictor + frame-info state of a coded P frame."""
        self.prev_mv = np.where(intra_mask[..., None], 0,
                                np.ascontiguousarray(final8[::2, ::2]))
        kind = np.where(skip, 0, 1).astype(np.int32)
        kind = np.where(intra_kind == 1, 2, kind)
        kind = np.where(intra_kind == 2, 3, kind)
        self.last_frame_info = {"kind": kind, "part": part_np,
                                "mv8": final8, "ref8": ref8_np}

    def _encode_p_parts_fused(self, y, u, v, qp: int, qpc: int) -> bytes:
        """Stego serving path: ONE fused dispatch (analyse + pass-1
        encode + device scan + RCA probe costs) and ONE packed pull
        feed the host STC; the re-encode rides a second dispatch and
        the packed level pull. Two blocking pulls per frame total
        (was four: meta pull + host scan + probe pull + level pull)."""
        d = self._fused_dispatch(y, u, v, qp, qpc)
        res_np, part_np, mvd, skip, final8, intra_kind = \
            self._fused_complete(d)
        return self._finish_p_slice(res_np, qp, part_np, mvd, skip,
                                    intra_kind, None, None, final8,
                                    intra_kind > 0, False,
                                    update_state=False)

    def _fused_dispatch(self, y, u, v, qp: int, qpc: int,
                        extra=None) -> dict:
        """Enqueue the fused stage-1 program; returns the context the
        completion half consumes. No blocking pulls here — the
        pipelined driver runs the previous frame's entropy between
        this dispatch and _fused_complete's pull."""
        from . import partition as PT
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        self._p_l0_eff = 1   # the fused stego path is single-ref
        lam = ME.lambda_tab(qp)
        cmv = self._cost_mv_dev(qp, lam)
        # pass-1 materializes levels/recon whenever the pass-2
        # re-encode can be incremental (inter_incr.py exactness scope)
        incr_ok = (p.incremental and not p.trellis
                   and p.noise_reduction == 0
                   and not p.transform_8x8 and self._aq_grids is None)
        packed_dev, res, blocks8, wht8, r_idx8 = PT.p_stage1_stego(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
            jnp.asarray(self.prev_mv), qp, qpc, lam, cmv,
            p.me_range, mbh, mbw, p.subpel, p.dct_decimate,
            bool(p.trellis), nr_offset=self._nr_offset(), extra=extra,
            trans8=p.transform_8x8, rd=bool(p.rd), full_pass1=incr_ok)
        self._ptables8 = {"blocks": blocks8, "wht": wht8,
                          "r_idx": r_idx8}
        return dict(packed=packed_dev, res=res, y=y, u=u, v=v,
                    qp=qp, qpc=qpc, incr_ok=incr_ok)

    def _fused_complete(self, d, pipelined: bool = False):
        """Pull the packed stage-1 results, run host STC + flips,
        dispatch the re-encode (incremental: only flip-touched MBs),
        dispatch the deblocker, and update predictor/frame state.
        Entropy is NOT written here. pipelined=True skips the blocking
        level pull: the lean buffer is enqueued and returned as a
        pending record the NEXT frame's call drains (overlapping this
        host's entropy with the device's stage-1)."""
        from . import inter as P
        from .inter_incr import (reencode_p_incremental, changed_mbs,
                                 pad_subset)
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        qp, qpc, y, u, v = d["qp"], d["qpc"], d["y"], d["u"], d["v"]
        n = mbh * mbw
        packed = np.asarray(d["packed"])
        self._nr_update(d["res"], 16 * mbh * mbw)
        part_np = packed[:n].astype(np.int32).reshape(mbh, mbw)
        mv8_np = packed[n:9 * n].astype(np.int32) \
            .reshape(2 * mbh, 2 * mbw, 2)
        skip1 = packed[11 * n:12 * n].astype(bool).reshape(mbh, mbw)
        alt_u = packed[12 * n:20 * n].astype(np.int32) \
            .reshape(mbh, mbw, 4, 2)
        rho_u = np.ascontiguousarray(packed[20 * n:24 * n]) \
            .reshape(mbh, mbw, 4).astype(np.float64)

        final8, skip, mvd = self._stego.apply_costs(
            self, part_np, mv8_np, skip1, rho_u, alt_u)
        idx, fzs = changed_mbs(mv8_np, final8, skip1, skip, mbh, mbw)
        if d.get("incr_ok") and "luma_lev" in d["res"] \
                and len(idx) <= n // 4:
            idx_p, fz_p, cap = pad_subset(idx, fzs, n)
            res2 = reencode_p_incremental(
                d["res"], y, u, v, self.ref["luma"], self.ref["u"],
                self.ref["v"], jnp.asarray(final8), jnp.asarray(idx_p),
                jnp.asarray(fz_p), qp, qpc, mbh, mbw, cap,
                decimate=p.dct_decimate)
        else:
            res2 = P.encode_p_frame_device8(
                y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
                jnp.asarray(final8), qp, qpc, mbh, mbw,
                decimate=p.dct_decimate, force_zero=jnp.asarray(skip),
                trellis=bool(p.trellis), nr_offset=self._nr_offset(),
                trans8=p.transform_8x8, rd=bool(p.rd))
        intra_kind = np.zeros((mbh, mbw), np.int32)
        intra_mask = intra_kind > 0

        # trans8-aware device nnz/flag inputs for the deblocker (the
        # effective flag is decision AND cbp_luma > 0, spec 7.4.5 —
        # intra_mask is all-false on this path)
        t8_dev = None
        if p.transform_8x8 and "trans8" in res2:
            t8_dev = (res2["trans8"].astype(bool)
                      & (res2["cbp_luma"] != 0))
            nnz_dev = _nnz4_t8_device(res2["luma_lev"],
                                      res2["luma8_lev"], t8_dev,
                                      mbh, mbw)
        else:
            nnz_dev = _nnz4_device(res2["luma_lev"], mbh, mbw)

        if pipelined:
            # enqueue the lean entropy buffer BEFORE the deblock waves
            # (FIFO device queue; the fetch happens next frame)
            has8 = "luma8_lev" in res2
            lev_in = {k: res2[k] for k in
                      ("luma_lev", "chroma_dc", "chroma_ac", "cbp_luma",
                       "cbp_chroma", "luma8_lev", "trans8") if k in res2}
            buf_dev = _pack_frame_lean(lev_in, n, has8)
            mv4 = np.repeat(np.repeat(final8, 2, 0), 2, 1)
            self._deblock_device(res2, intra_mask, skip, mv4, qp,
                                 nnz_dev, trans8=t8_dev)
            self._p_state_update(part_np, skip, final8, intra_kind,
                                 None, intra_mask)
            return dict(buf=buf_dev, res=res2, has8=has8, qp=qp,
                        part=part_np, mvd=mvd, skip=skip,
                        final8=final8)

        need_recon = (self.keep_recon
                      or not (p.deblock and self._deblock_on_device()))
        mv4 = np.repeat(np.repeat(final8, 2, 0), 2, 1)
        res_np = _res_to_host(res2, mbh, mbw, with_recon=need_recon)
        nnz4 = None
        trans8_mask = None
        if p.transform_8x8 and "trans8" in res_np:
            # effective trans8 = analysis decision AND cbp_luma > 0:
            # with no luma residual the flag is never transmitted and
            # the decoder infers 0 (spec 7.4.5) — deblock must agree
            t8_eff = (res_np["trans8"] & (res_np["cbp_luma"] != 0)
                      & ~intra_mask)
            nz4 = np.count_nonzero(res_np["luma_lev"], axis=(4, 5)) \
                .transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
            nz8 = np.count_nonzero(res_np["luma8_lev"], axis=(4, 5)) \
                .transpose(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)
            nnz4 = np.where(
                np.repeat(np.repeat(t8_eff, 4, 0), 4, 1),
                np.repeat(np.repeat(nz8, 2, 0), 2, 1),
                nz4).astype(np.int32)
            trans8_mask = t8_eff.astype(np.uint8)
        if p.deblock and self._deblock_on_device():
            self._deblock_device(res2, intra_mask, skip, mv4, qp,
                                 nnz_dev, trans8=t8_dev)
        elif p.deblock and self._native is not None:
            self._deblock(res_np, intra=intra_mask, mv=mv4,
                          skip=skip.astype(np.uint8), qp=qp, nnz4=nnz4,
                          trans8=trans8_mask)
        else:
            self._update_ref(res2)
            self.recon_prev = (res_np["recon_y"], res_np["recon_u"],
                               res_np["recon_v"])
        self._p_state_update(part_np, skip, final8, intra_kind, None,
                             intra_mask)
        return res_np, part_np, mvd, skip, final8, intra_kind

    def _cost_mv_dev(self, qp, lam):
        """Device-cached lambda-weighted mv cost table per QP."""
        if not hasattr(self, "_cmv_cache"):
            self._cmv_cache = {}
        if qp not in self._cmv_cache:
            from ..stego.cost import cost_mv_table
            self._cmv_cache[qp] = jnp.asarray(cost_mv_table(lam))
        return self._cmv_cache[qp]

    def _p_finalize(self, res, qp, part_np, mvd, skip, intra_kind,
                    intra_res, ref8_np, final8, intra_mask, multiref):
        """Common P tail: level pull, deblock/ref update, entropy."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        need_recon = (self.keep_recon
                      or not (p.deblock and self._deblock_on_device()))
        mv4 = np.repeat(np.repeat(final8, 2, 0), 2, 1)
        ref4 = (np.repeat(np.repeat(ref8_np, 2, 0), 2, 1)
                if multiref else None)
        # level pull before the deblock dispatch: the device drains
        # its queue in order, so enqueueing the 254-wave deblock first
        # would put it ahead of the transfer
        res_np = _res_to_host(res, mbh, mbw, with_recon=need_recon)

        nnz4 = None
        trans8_mask = None
        if p.transform_8x8 and "trans8" in res_np:
            # trans8 MBs: every 4x4 cell carries its 8x8's coeff count
            # (bS at 8x8 edges reads any covered cell; internal edges
            # are skipped by the deblocker's trans8 rule).
            # effective trans8 = decision AND cbp_luma > 0 AND coded
            # inter: with no luma residual (or an intra re-decision)
            # the flag is never transmitted and the decoder infers 0
            # (spec 7.4.5) — deblock must agree
            t8_eff = (res_np["trans8"] & (res_np["cbp_luma"] != 0)
                      & ~intra_mask)
            nz4 = np.count_nonzero(res_np["luma_lev"], axis=(4, 5)) \
                .transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
            nz8 = np.count_nonzero(res_np["luma8_lev"], axis=(4, 5)) \
                .transpose(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)
            nz8r = np.repeat(np.repeat(nz8, 2, 0), 2, 1)
            t8r = np.repeat(np.repeat(t8_eff, 4, 0), 4, 1)
            nnz4 = np.where(t8r, nz8r, nz4).astype(np.int32)
            trans8_mask = t8_eff.astype(np.uint8)
        if intra_res is not None:
            # deblock nnz: inter MBs from luma_lev, intra from luma_ac
            if nnz4 is None:
                nnz4 = np.count_nonzero(res_np["luma_lev"],
                                        axis=(4, 5)) \
                    .transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
            nz_intra = np.count_nonzero(intra_res["luma_ac"],
                                        axis=(4, 5)) \
                .transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
            m4 = np.repeat(np.repeat(intra_mask, 4, 0), 4, 1)
            nnz4 = np.where(m4, nz_intra, nnz4).astype(np.int32)
        qp_maps = (None, None)
        if self._aq_grids is not None:
            # decoder-visible per-MB QP: MBs that code no qp_delta
            # inherit the previous MB's (spec 7.4.5; the deblocker
            # must see THIS chain, not the intended grid)
            from ..ops.aq import effective_qp_grid
            from ..ops.transform import CHROMA_QP_TABLE
            coded = (((res_np["cbp_luma"] | res_np["cbp_chroma"]) != 0)
                     & ~skip)
            eff = effective_qp_grid(self._aq_grids[0], coded, qp)
            eff_c = CHROMA_QP_TABLE[np.clip(
                eff + p.chroma_qp_offset, 0, 51)].astype(np.int32)
            qp_maps = (eff, eff_c)
        if p.deblock and self._deblock_on_device():
            self._deblock_device(
                res, intra_mask, skip, mv4, qp,
                jnp.asarray(nnz4) if nnz4 is not None else
                _nnz4_device(res["luma_lev"], mbh, mbw), ref4=ref4,
                qp_maps=qp_maps, trans8=trans8_mask)
        elif p.deblock and self._native is not None:
            self._deblock(res_np, intra=intra_mask, mv=mv4,
                          skip=skip.astype(np.uint8), qp=qp, nnz4=nnz4,
                          ref4=ref4, trans8=trans8_mask,
                          qp_maps=qp_maps)
        else:
            self._update_ref(res)
            self.recon_prev = (res_np["recon_y"], res_np["recon_u"],
                               res_np["recon_v"])
        return self._finish_p_slice(res_np, qp, part_np, mvd, skip,
                                    intra_kind, intra_res, ref8_np,
                                    final8, intra_mask, multiref)

    def _finish_p_slice(self, res_np, qp, part_np, mvd, skip,
                        intra_kind, intra_res, ref8_np, final8,
                        intra_mask, multiref, frame_num=None,
                        poc_lsb=None, update_state=True):
        """Host tail of the partitioned P path: predictor update,
        frame info, slice header + entropy. The pipelined driver
        defers this entropy half to the NEXT frame's call (overlapping
        the device's stage-1 compute), passing the captured frame_num/
        poc_lsb and update_state=False (state was updated at dispatch
        time)."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        if update_state:
            self._p_state_update(part_np, skip, final8, intra_kind,
                                 ref8_np, intra_mask)

        bw = BitWriter()
        H.write_slice_header(bw, self.sps, self.pps, H.SLICE_TYPE_P,
                             self.frame_num if frame_num is None
                             else frame_num, qp, idr=False,
                             disable_deblock=0 if p.deblock else 1,
                             alpha_div2=p.deblock_alpha,
                             beta_div2=p.deblock_beta,
                             poc_lsb=self._poc_lsb if poc_lsb is None
                             else poc_lsb,
                             reorder_l0=self._take_reorder_l0(),
                             p_l0_active=self._p_l0_eff)
        n = mbh * mbw
        if p.cabac:
            return self._write_p_slice_cabac(bw, res_np, qp, part_np,
                                             mvd, skip, intra_kind,
                                             intra_res, ref8=ref8_np)
        if multiref:
            return self._write_p_slice_cavlc_mref(
                bw, res_np, qp, part_np, mvd, skip, ref8_np,
                intra_kind, intra_res)
        if (self._native is not None and intra_res is None
                and self._aq_grids is None):
            from .. import native
            hdr, nbits = bw.partial_bytes()
            return native.write_slice(
                hdr, nbits, H.SLICE_TYPE_P, mbw, mbh,
                skip=skip.reshape(n).astype(np.uint8),
                part=part_np.reshape(n), mvd4=mvd.reshape(n, 4, 2),
                cbp_luma=res_np["cbp_luma"],
                cbp_chroma=res_np["cbp_chroma"],
                luma_blocks=res_np["luma_lev"].reshape(n, 16, 16),
                chroma_dc=res_np["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res_np["chroma_ac"].reshape(n, 2, 4, 16),
                trans8=(res_np["trans8"].reshape(n).astype(np.uint8)
                        if p.transform_8x8 else None),
                luma8_lev=(res_np["luma8_lev"]
                           if p.transform_8x8 else None),
                trans8_mode=p.transform_8x8)
        fc = FrameCavlc(mbw, mbh, trans8_mode=p.transform_8x8)
        skip_run = 0
        aqg = self._aq_grids[0] if self._aq_grids is not None else None
        last_qp = qp
        for my in range(mbh):
            for mx in range(mbw):
                if skip[my, mx]:
                    skip_run += 1
                    fc.set_mb_nnz_zero(mx, my)
                    continue
                bw.write_ue(skip_run)
                skip_run = 0
                k = int(intra_kind[my, mx])
                if k == 2:  # I_NxN in P (mb_type 5)
                    fc.write_i4x4_mb(
                        bw, mx, my, intra_res["i4_modes"][my, mx],
                        int(intra_res["cmode"][my, mx]),
                        int(intra_res["cbp_luma"][my, mx]),
                        int(intra_res["cbp_chroma"][my, mx]),
                        intra_res["luma_ac"][my, mx],
                        intra_res["chroma_dc"][my, mx],
                        intra_res["chroma_ac"][my, mx], qp_delta=0,
                        in_p_slice=True)
                    continue
                if k == 1:  # I_16x16 in P
                    fc.write_i16x16_mb(
                        bw, mx, my, int(intra_res["mode"][my, mx]),
                        int(intra_res["cmode"][my, mx]),
                        int(intra_res["cbp_luma"][my, mx]),
                        int(intra_res["cbp_chroma"][my, mx]),
                        intra_res["luma_dc"][my, mx],
                        intra_res["luma_ac"][my, mx],
                        intra_res["chroma_dc"][my, mx],
                        intra_res["chroma_ac"][my, mx], qp_delta=0,
                        in_p_slice=True)
                    continue
                dq = 0
                if aqg is not None and (
                        int(res_np["cbp_luma"][my, mx])
                        or int(res_np["cbp_chroma"][my, mx])):
                    # mb_qp_delta is specified in [-26, 25] with the QP
                    # chain modulo 52 (spec 7.4.5) — fold large swings
                    dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                    last_qp = int(aqg[my, mx])
                fc.write_p_mb(
                    bw, mx, my, int(part_np[my, mx]), mvd[my, mx],
                    int(res_np["cbp_luma"][my, mx]),
                    int(res_np["cbp_chroma"][my, mx]),
                    res_np["luma_lev"][my, mx],
                    res_np["chroma_dc"][my, mx],
                    res_np["chroma_ac"][my, mx], qp_delta=dq,
                    trans8=bool(p.transform_8x8
                                and res_np["trans8"][my, mx]),
                    luma8_lev=(res_np["luma8_lev"][my, mx]
                               if p.transform_8x8 else None))
        if skip_run:
            bw.write_ue(skip_run)
        bw.rbsp_trailing()
        return bw.get_bytes()

    def _encode_p_sub(self, y, u, v, qp: int, qpc: int) -> bytes:
        """Sub-8x8-partitioned P path (P_8x8 sub_mb_types 8x4/4x8/4x4;
        reference analyse helpers p8x4/p4x8/p4x4, analyse.c:1569-1693).
        Entropy coding runs the Python oracle writers (the native twins
        don't speak sub partitions yet)."""
        from . import partition as PT
        from . import scan as SCAN
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        lam = ME.lambda_tab(qp)
        multiref = p.ref_frames > 1
        if not multiref:
            self._p_l0_eff = 1   # see _encode_p_parts (reconfig shrink)
        ref8_np = None
        if multiref:
            # mixed-ref sub-8x8 (analyse.c:1291-1370 generalized):
            # each 8x8's ref is its own masked argmin; sub splits
            # evaluate that ref's per-4x4 costs
            refs_luma, refs_u, refs_v, n_valid = self._dpb_stacked()
            self._p_l0_eff = max(1, min(p.ref_frames, int(n_valid)))
            part, sub_type, mv4, ref8, r_idx4, blocks4, wht4, \
                mb_cost = PT.analyse_p_frame_sub_mref(
                    y, refs_luma, jnp.asarray(n_valid),
                    jnp.asarray(self.prev_mv), p.me_range, mbh, mbw,
                    lam, p.subpel, p.ref_frames)
            ref8_np = np.asarray(ref8)
        elif p.rd >= 1 and self._stego is None and not p.aq_mode:
            # sub-8x8 RD re-rank (x264_mb_analyse_p_rd P_8x8 branch,
            # analyse.c:2150: per-8x8 sub types within 5/4 of the SATD
            # best re-ranked by partial RD, MB shapes by full RD).
            # Probe quant trellises only at --trellis 2 (analyse.c:248)
            part, sub_type, mv4, r_idx4, blocks4, wht4, mb_cost = \
                PT.rd_rerank_sub(
                    y, u, v, self.ref["luma"], self.ref["u"],
                    self.ref["v"], jnp.asarray(self.prev_mv), qp, qpc,
                    p.me_range, mbh, mbw, lam, p.subpel,
                    decimate=p.dct_decimate, trellis=p.trellis > 1,
                    nr_offset=self._nr_offset())
        else:
            part, sub_type, mv4, r_idx4, blocks4, wht4, mb_cost = \
                PT.analyse_p_frame_sub(
                    y, self.ref["luma"], jnp.asarray(self.prev_mv),
                    p.me_range, mbh, mbw, lam, p.subpel)
        self._ptables4 = {"blocks": blocks4, "wht": wht4, "r_idx": r_idx4}
        part_np = np.asarray(part)
        sub_np = np.asarray(sub_type)
        mv4_np = np.asarray(mv4)
        qp_enc, qpc_enc = qp, qpc
        self._aq_grids = None
        if p.aq_mode:
            # per-MB QP on the sub-partitioned path too
            # (x264_adaptive_quant_frame, ratecontrol.c:231)
            from ..ops.aq import aq_offsets, assign_qp_grid
            from ..ops.transform import CHROMA_QP_TABLE
            offs = np.asarray(aq_offsets(
                y, u, v, mbh, mbw, jnp.float32(p.aq_strength)))
            qp_grid = assign_qp_grid(qp, offs, p.qp_min, p.qp_max)
            qpc_grid = CHROMA_QP_TABLE[np.clip(
                qp_grid + p.chroma_qp_offset, 0, 51)].astype(np.int32)
            self._aq_grids = (qp_grid, qpc_grid)
            qp_enc = jnp.asarray(qp_grid)
            qpc_enc = jnp.asarray(qpc_grid)
        if multiref:
            ref4_dev = jnp.repeat(jnp.repeat(jnp.asarray(ref8_np),
                                             2, 0), 2, 1)
            res = P.encode_p_frame_device4_mref(
                y, u, v, refs_luma, refs_u, refs_v, mv4, ref4_dev,
                qp_enc, qpc_enc, mbh, mbw, decimate=p.dct_decimate,
                trellis=bool(p.trellis), nr_offset=self._nr_offset())
        else:
            res = P.encode_p_frame_device4(
                y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
                mv4, qp_enc, qpc_enc, mbh, mbw, decimate=p.dct_decimate,
                trellis=bool(p.trellis), nr_offset=self._nr_offset())
        if p.transform_8x8 and not multiref:
            # 8x8 transform on the sub-partitioned path (b66:
            # x264_mb_transform_8x8_allowed, macroblock.h:462 — trans8
            # coexists with p4x4; only MBs whose partitions are all
            # >= 8x8 may use it). Re-encode those MBs through the 8x8
            # path (same MVs -> identical 4x4 results where it decides
            # against trans8) and merge per MB. (mref + p4x4 + 8x8dct
            # stays 4x4-only: a legal stream, documented quality
            # divergence — docs/PARITY.md)
            elig = (part_np != 3) | np.all(sub_np == 0, axis=-1)
            if elig.any():
                mv8_e = jnp.asarray(
                    np.ascontiguousarray(mv4_np[::2, ::2]))
                res8 = P.encode_p_frame_device8(
                    y, u, v, self.ref["luma"], self.ref["u"],
                    self.ref["v"], mv8_e, qp_enc, qpc_enc, mbh, mbw,
                    decimate=p.dct_decimate, trellis=bool(p.trellis),
                    nr_offset=self._nr_offset(), trans8=True,
                    rd=bool(p.rd), t8_allow=jnp.asarray(elig))
                res = _merge_res_trans8(res, res8, jnp.asarray(elig),
                                        mbh, mbw)

        intra_res = None
        intra_kind = np.zeros((mbh, mbw), np.int32)
        if p.intra_in_p and self._stego is None and not p.aq_mode:
            ir = I.refine_p_intra(
                y, u, v, res["recon_y"], res["recon_u"], res["recon_v"],
                mb_cost, qp, qpc, mbw, mbh, lam=lam, i4x4=p.i4x4,
                trellis=bool(p.trellis))
            intra_kind = np.asarray(ir["intra_kind"])
            if intra_kind.any():
                intra_res = {k: np.asarray(val) for k, val in ir.items()}
                res = dict(res)
                for k in ("recon_y", "recon_u", "recon_v"):
                    res[k] = ir[k]

        cbp_l = np.asarray(res["cbp_luma"])
        cbp_c = np.asarray(res["cbp_chroma"])
        intra_mask = intra_kind > 0
        skip, mvd, mvp, final4 = SCAN.scan_p_frame_sub(
            part_np, sub_np, mv4_np, cbp_l, cbp_c,
            intra=intra_mask if intra_mask.any() else None,
            ref8=ref8_np)
        skip &= ~intra_mask

        if self._stego is not None:
            if multiref:
                self._mref_stack4 = (refs_luma, refs_u, refs_v)
            replaced = self._stego.embed_frame_sub(
                self, y, u, v, part_np, sub_np, mv4_np, skip, mvp,
                ref8=ref8_np)
            if replaced is not None:
                final4, skip, mvd, res = replaced
        need_recon = (self.keep_recon
                      or not (p.deblock and self._deblock_on_device()))
        res_np = _res_to_host(res, mbh, mbw, with_recon=need_recon)

        nnz4 = None
        trans8_mask = None
        if p.transform_8x8 and "trans8" in res_np:
            # effective trans8 = decision AND cbp_luma > 0 AND not an
            # intra re-decision (spec 7.4.5; see _p_finalize)
            t8_eff = (res_np["trans8"] & (res_np["cbp_luma"] != 0)
                      & ~intra_mask)
            nz4 = np.count_nonzero(res_np["luma_lev"], axis=(4, 5)) \
                .transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
            nz8 = np.count_nonzero(res_np["luma8_lev"], axis=(4, 5)) \
                .transpose(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)
            nnz4 = np.where(
                np.repeat(np.repeat(t8_eff, 4, 0), 4, 1),
                np.repeat(np.repeat(nz8, 2, 0), 2, 1),
                nz4).astype(np.int32)
            trans8_mask = t8_eff.astype(np.uint8)
        if intra_res is not None:
            if nnz4 is None:
                nnz4 = np.count_nonzero(res_np["luma_lev"],
                                        axis=(4, 5)) \
                    .transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
            nz_intra = np.count_nonzero(intra_res["luma_ac"],
                                        axis=(4, 5)) \
                .transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
            m4 = np.repeat(np.repeat(intra_mask, 4, 0), 4, 1)
            nnz4 = np.where(m4, nz_intra, nnz4).astype(np.int32)
        qp_maps = (None, None)
        if self._aq_grids is not None:
            # decoder-visible per-MB QP chain (see _p_finalize)
            from ..ops.aq import effective_qp_grid
            from ..ops.transform import CHROMA_QP_TABLE
            coded = (((res_np["cbp_luma"] | res_np["cbp_chroma"]) != 0)
                     & ~skip)
            eff = effective_qp_grid(self._aq_grids[0], coded, qp)
            eff_c = CHROMA_QP_TABLE[np.clip(
                eff + p.chroma_qp_offset, 0, 51)].astype(np.int32)
            qp_maps = (eff, eff_c)
        if p.deblock and self._deblock_on_device():
            self._deblock_device(
                res, intra_mask, skip, final4, qp,
                jnp.asarray(nnz4) if nnz4 is not None else
                _nnz4_device(res["luma_lev"], mbh, mbw),
                qp_maps=qp_maps, trans8=trans8_mask)
        elif p.deblock and self._native is not None:
            self._deblock(res_np, intra=intra_mask, mv=final4,
                          skip=skip.astype(np.uint8), qp=qp, nnz4=nnz4,
                          ref4=(np.repeat(np.repeat(ref8_np, 2, 0),
                                          2, 1)
                                if ref8_np is not None else None),
                          trans8=trans8_mask,
                          qp_maps=qp_maps)
        else:
            self._update_ref(res)
            self.recon_prev = (res_np["recon_y"], res_np["recon_u"],
                               res_np["recon_v"])
        self.prev_mv = np.where(intra_mask[..., None], 0,
                                np.ascontiguousarray(final4[::4, ::4]))
        kind = np.where(skip, 0, 1).astype(np.int32)
        kind = np.where(intra_kind == 1, 2, kind)
        kind = np.where(intra_kind == 2, 3, kind)
        self.last_frame_info = {"kind": kind, "part": part_np,
                                "mv8": np.ascontiguousarray(
                                    final4[::2, ::2]),
                                "mv4": np.ascontiguousarray(final4),
                                "ref8": ref8_np}
        self._last_sub_types = sub_np

        bw = BitWriter()
        H.write_slice_header(bw, self.sps, self.pps, H.SLICE_TYPE_P,
                             self.frame_num, qp, idr=False,
                             disable_deblock=0 if p.deblock else 1,
                             alpha_div2=p.deblock_alpha,
                             beta_div2=p.deblock_beta,
                             poc_lsb=self._poc_lsb,
                             reorder_l0=self._take_reorder_l0(),
                             p_l0_active=self._p_l0_eff)
        if p.cabac:
            return self._write_p_slice_cabac_sub(
                bw, res_np, qp, part_np, sub_np, mvd, skip, intra_kind,
                intra_res, ref8=ref8_np)
        if self._native is not None and intra_res is None \
                and self._aq_grids is None and not p.transform_8x8:
            from .. import native
            n = mbh * mbw
            hdr, nbits = bw.partial_bytes()
            return native.write_slice(
                hdr, nbits, H.SLICE_TYPE_P, mbw, mbh,
                skip=skip.reshape(n).astype(np.uint8),
                part=part_np.reshape(n),
                mvd4=mvd.reshape(n, 16, 2),
                sub_type=sub_np.reshape(n, 4),
                cbp_luma=res_np["cbp_luma"],
                cbp_chroma=res_np["cbp_chroma"],
                luma_blocks=res_np["luma_lev"].reshape(n, 16, 16),
                chroma_dc=res_np["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res_np["chroma_ac"].reshape(n, 2, 4, 16),
                refs=(None if ref8_np is None
                      else self._refs4(part_np, ref8_np)),
                num_ref=self._p_l0_eff)
        fc = FrameCavlc(mbw, mbh, trans8_mode=p.transform_8x8)
        skip_run = 0
        aqg = self._aq_grids[0] if self._aq_grids is not None else None
        last_qp = qp
        for my in range(mbh):
            for mx in range(mbw):
                if skip[my, mx]:
                    skip_run += 1
                    fc.set_mb_nnz_zero(mx, my)
                    continue
                bw.write_ue(skip_run)
                skip_run = 0
                k = int(intra_kind[my, mx])
                if k == 2:
                    fc.write_i4x4_mb(
                        bw, mx, my, intra_res["i4_modes"][my, mx],
                        int(intra_res["cmode"][my, mx]),
                        int(intra_res["cbp_luma"][my, mx]),
                        int(intra_res["cbp_chroma"][my, mx]),
                        intra_res["luma_ac"][my, mx],
                        intra_res["chroma_dc"][my, mx],
                        intra_res["chroma_ac"][my, mx], qp_delta=0,
                        in_p_slice=True)
                    continue
                if k == 1:
                    fc.write_i16x16_mb(
                        bw, mx, my, int(intra_res["mode"][my, mx]),
                        int(intra_res["cmode"][my, mx]),
                        int(intra_res["cbp_luma"][my, mx]),
                        int(intra_res["cbp_chroma"][my, mx]),
                        intra_res["luma_dc"][my, mx],
                        intra_res["luma_ac"][my, mx],
                        intra_res["chroma_dc"][my, mx],
                        intra_res["chroma_ac"][my, mx], qp_delta=0,
                        in_p_slice=True)
                    continue
                ptk = int(part_np[my, mx])
                dq = 0
                if aqg is not None and (
                        int(res_np["cbp_luma"][my, mx])
                        or int(res_np["cbp_chroma"][my, mx])):
                    # spec 7.4.5 modular fold (see _write_p_slice_cabac)
                    dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                    last_qp = int(aqg[my, mx])
                fc.write_p_mb(
                    bw, mx, my, ptk, mvd[my, mx],
                    int(res_np["cbp_luma"][my, mx]),
                    int(res_np["cbp_chroma"][my, mx]),
                    res_np["luma_lev"][my, mx],
                    res_np["chroma_dc"][my, mx],
                    res_np["chroma_ac"][my, mx], qp_delta=dq,
                    sub_types=(sub_np[my, mx] if ptk == 3 else None),
                    refs=(None if ref8_np is None
                          else self._refs_of(ptk, ref8_np, my, mx)),
                    num_ref=self._p_l0_eff,
                    trans8=bool(p.transform_8x8
                                and "trans8" in res_np
                                and res_np["trans8"][my, mx]),
                    luma8_lev=(res_np["luma8_lev"][my, mx]
                               if p.transform_8x8
                               and "luma8_lev" in res_np else None))
        if skip_run:
            bw.write_ue(skip_run)
        bw.rbsp_trailing()
        return bw.get_bytes()

    def _direct_auto_score(self, y, ref0, ref1, spatial_pred,
                           tfields, approx_mvs, col_mv4, col_ref4,
                           c_act, c_best, lam, w1, parts: bool):
        """--direct auto: accumulate per-mode would-direct counts
        (analog of x264's per-MB bskip probe under both modes,
        analyse.c:3185-3199, with the 9/10 decay encoder.c:2569-2580).
        The active mode's direct cost is already computed; evaluate
        the alternate mode's field with one extra device dispatch."""
        from . import bslice as BS
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        if spatial_pred:
            av8 = np.repeat(np.repeat(
                tfields[0].astype(np.int32), 2, 0), 2, 1)
            au0, au1, adv0, adv1 = av8, av8, tfields[1], tfields[2]
            alt_avail = tfields[0]
        else:
            au0, au1, adv0, adv1 = BS.approx_direct_fields(
                approx_mvs[0], approx_mvs[1], col_mv4, col_ref4)
            alt_avail = np.ones((mbh, mbw), bool)
        fn = BS.bipred_satd8_device if parts else BS.bipred_satd_device
        c_alt = np.asarray(fn(
            y, ref0["luma"], ref1["luma"], jnp.asarray(au0),
            jnp.asarray(au1), jnp.asarray(adv0), jnp.asarray(adv1),
            mbh, mbw, w1=w1))
        if parts:
            c_alt = c_alt.sum(-1)
        act_avail = (np.ones((mbh, mbw), bool) if spatial_pred
                     else tfields[0])
        s_act = int(((c_act + lam <= c_best) & act_avail).sum())
        s_alt = int(((c_alt + lam <= c_best) & alt_avail).sum())
        sc = self._direct_score
        if sc[0] + sc[1] > mbh * mbw:
            sc[0] = sc[0] * 9 // 10
            sc[1] = sc[1] * 9 // 10
        ai = 1 if spatial_pred else 0
        sc[ai] += s_act
        sc[1 - ai] += s_alt

    def _encode_b_frame(self, frame, y, u, v, ref0, ref1, col,
                        anchor_qp: int, satd, disp: int,
                        w1: int = 32, pocs=None,
                        is_ref: bool = False, l0_stack=None,
                        col_poc0=None, col_t=None):
        """Non-reference B frame between two anchors (bslice.py:
        two-list exhaustive ME + BI at the per-list winners + spatial
        direct; reference B path analyse.c:3110-3466). l0_stack:
        stacked past-anchor DPB (luma, u, v, n_valid) — multi-ref B
        lists: per-MB best L0 ref at 16x16 with REF_COST like
        x264_mb_analyse_inter_b16x16 (B partitions are single-ref and
        disabled under mref — documented analysis-scope delta)."""
        from . import bslice as BS
        t0 = time.time()
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        qp = self.rc.start(SLICE_B, satd)
        forced = self.rc.forced(disp)   # --qpfile in the B pipe too
        if forced is not None and forced[1] >= 0:
            qp = forced[1]
        qp = self._zone_qp(qp, disp)
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        lam = ME.lambda_tab(qp)
        qp_enc, qpc_enc = qp, qpc
        aqg = None
        if p.aq_mode:
            # per-MB QP on B frames too (x264 adaptive_quant all types)
            from ..ops.aq import aq_offsets, assign_qp_grid
            from ..ops.transform import CHROMA_QP_TABLE
            offs = np.asarray(aq_offsets(
                y, u, v, p.mb_height, p.mb_width,
                jnp.float32(p.aq_strength)))
            aqg = assign_qp_grid(qp, offs, p.qp_min, p.qp_max)
            qpc_grid = CHROMA_QP_TABLE[np.clip(
                aqg + p.chroma_qp_offset, 0, 51)].astype(np.int32)
            qp_enc = jnp.asarray(aqg)
            qpc_enc = jnp.asarray(qpc_grid)
        col_mv4, col_ref4 = col
        # --direct mode for this slice (x264 encoder.c:120-127; auto
        # keeps a running would-skip score per mode, analyse.c:3188)
        dmode = p.direct
        if dmode == 3:
            spatial_pred = self._direct_score[1] > self._direct_score[0]
        else:
            spatial_pred = dmode == 1
        tdir = None        # active temporal field
        tfields = None     # computed temporal field (active or alt)
        if dmode in (2, 3) and pocs is not None:
            # the B's active L0 disp list (for DistScaleFactors and
            # map_col_to_list0)
            if l0_stack is not None:
                disps_l0 = list(l0_stack[4])
                dsf = np.array([
                    BS.dist_scale_factor(
                        pocs[0],
                        2 * disps_l0[min(r, len(disps_l0) - 1)],
                        pocs[2])
                    for r in range(p.ref_frames)], np.int64)
            else:
                disps_l0 = [pocs[1] // 2]
                dsf = BS.dist_scale_factor(*pocs)
            cmap = None
            if col_poc0 is not None:
                # map_col_to_list0 by POC matching within the active
                # L0 window (spec 8.4.1.2.3; reference
                # common/macroblock.c:830-841) — identity whenever the
                # B's L0 IS the colocated frame's L0 (every
                # non-pyramid GOP); -1 entries mark colocated refs
                # with no image in L0 (the macroblock.c:199 "return 0"
                # case: those MBs are direct-unavailable)
                n_act = max(1, min(len(disps_l0), p.ref_frames))
                act = disps_l0[:n_act]
                cmap = np.array(
                    [act.index(d0) if d0 in act else -1
                     for d0 in col_poc0] or [-1], np.int32)
            # temporal reads the L0-only colocated field when the
            # colocated picture is a reference B (x264's fref1 cache
            # stores list 0 only, macroblock.c:187); for P colocated
            # frames the two fields coincide
            tmv4, tref4 = col_t if col_t is not None else col
            tfields = BS.temporal_direct_fields(tmv4, tref4, dsf,
                                                col_map=cmap)
            if not spatial_pred:
                tdir = tfields
        if dmode == 0:
            # direct disabled: every MB direct-unavailable
            tdir = (np.zeros((p.mb_height, p.mb_width), bool),
                    np.zeros((2 * p.mb_height, 2 * p.mb_width, 2),
                             np.int32),
                    np.zeros((2 * p.mb_height, 2 * p.mb_width, 2),
                             np.int32),
                    np.zeros((2 * p.mb_height, 2 * p.mb_width),
                             np.int32))
        subs = None
        b_mref = l0_stack is not None
        use_parts = p.partitions
        ref0_16 = None
        ref8_0 = None
        if b_mref:
            refs0_l, refs0_u, refs0_v, n_valid, l0_disps = l0_stack
            # the slice may only signal as many L0 entries as the
            # DPB actually holds (first GOPs after an IDR)
            b_l0_eff = max(1, min(int(n_valid), p.ref_frames))
            # implicit bipred weight PER L0 REF (x264
            # h->mb.bipred_weight[i_ref0][i_ref1]); scalar 32 when
            # --weightb is off
            w_tab = np.array([
                BS.bipred_weight(
                    2 * disp,
                    2 * l0_disps[min(r, len(l0_disps) - 1)],
                    pocs[2] if pocs is not None else 2 * disp + 2,
                    p.weightb)
                for r in range(p.ref_frames)], np.int32)
        # intra-in-B (analyse.c:3110+ considers intra in B MBs too);
        # same gating as intra-in-P
        do_intra = (p.intra_in_p and self._stego is None
                    and not p.aq_mode)
        inter_cost = None
        direct_c = None
        if use_parts:
            # B partitions (16x8/8x16 combos + B_8x8 subs): two-stage
            # device analysis, host commit scan (bslice.py); under
            # multi-ref the per-MB L0 ref is the 16x16 REF_COST
            # winner, reused by every shape (analyse.c a->l0.i_ref)
            from .partition import _sp_to_z
            if b_mref:
                st0, st1, ref0_d = BS.analyse_b_parts_stage1_mref(
                    y, refs0_l, jnp.asarray(n_valid), ref1["luma"],
                    p.me_range, mbh, mbw, lam, p.ref_frames)
                ref0_16 = np.asarray(ref0_d)
            else:
                st0, st1 = BS.analyse_b_parts_stage1(
                    y, ref0["luma"], ref1["luma"], p.me_range, mbh,
                    mbw, lam)
            if tdir is not None:
                av8 = np.repeat(np.repeat(
                    tdir[0].astype(np.int32), 2, 0), 2, 1)
                au0, au1, adv0, adv1 = av8, av8, tdir[1], tdir[2]
            else:
                au0, au1, adv0, adv1 = BS.approx_direct_fields(
                    4 * np.asarray(st0["mv16"]),
                    4 * np.asarray(st1["mv16"]),
                    col_mv4, col_ref4)
            c_dir8 = BS.bipred_satd8_device(
                y, ref0["luma"], ref1["luma"], jnp.asarray(au0),
                jnp.asarray(au1), jnp.asarray(adv0), jnp.asarray(adv1),
                mbh, mbw, w1=w1)
            if tdir is not None:
                # direct-unavailable MBs must never win (16x16 direct
                # or B_8x8 direct subs)
                c_dir8 = jnp.where(jnp.asarray(tdir[0])[:, :, None],
                                   c_dir8, 1 << 20)
            if b_mref:
                stres = BS.analyse_b_parts(
                    y, refs0_l, ref1["luma"], st0, st1, c_dir8,
                    mbh, mbw, lam, p.subpel, w1=w1,
                    ref0_map=jnp.asarray(ref0_16))
            else:
                stres = BS.analyse_b_parts(
                    y, ref0["luma"], ref1["luma"], st0, st1, c_dir8,
                    mbh, mbw, lam, p.subpel, w1=w1)
            mv0z = np.asarray(_sp_to_z(stres["mv0_8"], mbh, mbw))
            mv1z = np.asarray(_sp_to_z(stres["mv1_8"], mbh, mbw))
            part_np = np.asarray(stres["part"])
            sel8_np = np.asarray(stres["sel8"])
            c_cfg_np = np.asarray(stres["c_cfg"])
            c_dir_mb = np.asarray(c_dir8).sum(-1)
            if dmode == 3 and tfields is not None:
                self._direct_auto_score(
                    y, ref0, ref1, spatial_pred, tfields,
                    (4 * np.asarray(st0["mv16"]),
                     4 * np.asarray(st1["mv16"])),
                    col_mv4, col_ref4, c_dir_mb, c_cfg_np, lam, w1,
                    parts=True)
            rescan_args = (part_np, sel8_np, mv0z, mv1z, c_cfg_np,
                           c_dir_mb, col_mv4, col_ref4, lam)
            (mode, subs, use0, use1, fmv0, fmv1, mvd0, mvd1,
             ref8_0) = BS.scan_b_parts(*rescan_args, tdir=tdir,
                                       ref0=ref0_16)
            self._last_b_ref0 = ref0_16
            if do_intra:
                inter_cost = np.minimum(c_dir_mb + lam, c_cfg_np)
                direct_c = (mode == 0) | ((mode == 22)
                                          & (subs == 0).any(-1))
        else:
            if b_mref:
                mv0, c0, ref0_d, mv1, c1, cbi = \
                    BS.analyse_b_frame_mref(
                        y, refs0_l, jnp.asarray(n_valid),
                        ref1["luma"], p.me_range, mbh, mbw, lam,
                        p.subpel, p.ref_frames,
                        w1=jnp.asarray(w_tab))
                ref0_16 = np.asarray(ref0_d)
            else:
                mv0, c0, mv1, c1, cbi = BS.analyse_b_frame(
                    y, ref0["luma"], ref1["luma"], p.me_range, mbh,
                    mbw, lam, p.subpel, w1=w1)
            mv0_np, mv1_np = np.asarray(mv0), np.asarray(mv1)
            if tdir is not None:
                av8 = np.repeat(np.repeat(
                    tdir[0].astype(np.int32), 2, 0), 2, 1)
                au0, au1, adv0, adv1 = av8, av8, tdir[1], tdir[2]
            else:
                au0, au1, adv0, adv1 = BS.approx_direct_fields(
                    mv0_np, mv1_np, col_mv4, col_ref4)
            c_dir = BS.bipred_satd_device(
                y, ref0["luma"], ref1["luma"], jnp.asarray(au0),
                jnp.asarray(au1), jnp.asarray(adv0), jnp.asarray(adv1),
                mbh, mbw, w1=w1)
            rescan_args = (np.asarray(c_dir), np.asarray(c0),
                           np.asarray(c1), np.asarray(cbi), mv0_np,
                           mv1_np, col_mv4, col_ref4, lam)
            if dmode == 3 and tfields is not None:
                hdrb = np.asarray(BS._B_HDR_BITS, np.int64)
                best_cfg = np.minimum(
                    np.minimum(rescan_args[1] + lam * hdrb[1],
                               rescan_args[2] + lam * hdrb[2]),
                    rescan_args[3] + lam * hdrb[3])
                self._direct_auto_score(
                    y, ref0, ref1, spatial_pred, tfields,
                    (mv0_np, mv1_np), col_mv4, col_ref4,
                    rescan_args[0] + lam * hdrb[0], best_cfg, lam, w1,
                    parts=False)
            (mode, use0, use1, fmv0, fmv1, mvd0, mvd1,
             ref8_0) = BS.scan_b_frame(*rescan_args, tdir=tdir,
                                       ref0=ref0_16)
            self._last_b_ref0 = ref0_16   # introspection (tests/CLI)
            if do_intra:
                hdr = np.asarray(BS._B_HDR_BITS, np.int64)
                cands = np.stack([
                    rescan_args[0] + lam * hdr[0],
                    rescan_args[1] + lam * hdr[1],
                    rescan_args[2] + lam * hdr[2],
                    rescan_args[3] + lam * hdr[3]])
                inter_cost = cands.min(0)
                direct_c = mode == 0
        if b_mref:
            w8 = w_tab[np.maximum(ref8_0, 0)]     # per-8x8 weight
            res = BS.encode_b_frame_device(
                y, u, v, refs0_l, refs0_u, refs0_v,
                ref1["luma"], ref1["u"], ref1["v"],
                jnp.asarray(use0), jnp.asarray(use1),
                jnp.asarray(fmv0), jnp.asarray(fmv1), qp_enc, qpc_enc,
                mbh, mbw, decimate=p.dct_decimate,
                trellis=bool(p.trellis),
                w1=(jnp.asarray(w8) if p.weightb else w1),
                ref8_0=jnp.asarray(ref8_0))
        else:
            res = BS.encode_b_frame_device(
                y, u, v, ref0["luma"], ref0["u"], ref0["v"],
                ref1["luma"], ref1["u"], ref1["v"],
                jnp.asarray(use0), jnp.asarray(use1),
                jnp.asarray(fmv0), jnp.asarray(fmv1), qp_enc, qpc_enc,
                mbh, mbw, decimate=p.dct_decimate,
                trellis=bool(p.trellis), w1=w1)
        # intra-vs-inter refinement over the committed B recon. An MB
        # may switch to intra only if no later raster MB reads it in a
        # spatial-direct derivation (dependents: right uses it as A,
        # below as B, below-left as C, below-right as D) — switched
        # MBs become unavailable to neighbours (decoder convention),
        # which would change a dependent direct MB's derived MVs and
        # desync the recon. MVPs of non-direct dependents only affect
        # mvd, which the rescan below re-derives.
        intra_kind = np.zeros((mbh, mbw), np.int32)
        intra_res = None
        if do_intra:
            dep = np.zeros_like(direct_c)
            if tdir is None:
                # spatial direct reads neighbours A/B/C/D — an MB a
                # later direct MB reads may not switch to intra.
                # temporal direct has no neighbour dependence.
                dep[:, :-1] |= direct_c[:, 1:]
                dep[:-1, :] |= direct_c[1:, :]
                dep[:-1, 1:] |= direct_c[1:, :-1]
                dep[:-1, :-1] |= direct_c[1:, 1:]
            cost_masked = np.where(dep, -1,
                                   inter_cost).astype(np.int32)
            ir = I.refine_p_intra(
                y, u, v, res["recon_y"], res["recon_u"],
                res["recon_v"], jnp.asarray(cost_masked), qp, qpc,
                mbw, mbh, lam=lam, i4x4=p.i4x4,
                trellis=bool(p.trellis))
            intra_kind = np.asarray(ir["intra_kind"])
            if intra_kind.any():
                intra_res = {k: np.asarray(val) for k, val in ir.items()}
                res = dict(res)
                for k in ("recon_y", "recon_u", "recon_v"):
                    res[k] = ir[k]
                imask = intra_kind > 0
                if use_parts:
                    (mode, subs, use0, use1, fmv0, fmv1, mvd0, mvd1,
                     ref8_0) = BS.scan_b_parts(
                        *rescan_args, intra=imask, tdir=tdir,
                        ref0=ref0_16)
                else:
                    (mode, use0, use1, fmv0, fmv1, mvd0, mvd1,
                     ref8_0) = BS.scan_b_frame(
                        *rescan_args, intra=imask, tdir=tdir,
                        ref0=ref0_16)
        need_recon = self.keep_recon or p.psnr or p.ssim
        res_np = _res_to_host(res, mbh, mbw, with_recon=need_recon)
        # B never enters the DPB: PSNR directly against the source
        h, w = frame.y.shape
        if need_recon and p.psnr:
            dy = (res_np["recon_y"][:h, :w].astype(np.int64)
                  - frame.y.astype(np.int64))
            du = (res_np["recon_u"][:h // 2, :w // 2].astype(np.int64)
                  - frame.u.astype(np.int64))
            dv = (res_np["recon_v"][:h // 2, :w // 2].astype(np.int64)
                  - frame.v.astype(np.int64))
            self.stats.ssd_y += int(np.sum(dy * dy))
            self.stats.ssd_u += int(np.sum(du * du))
            self.stats.ssd_v += int(np.sum(dv * dv))
        if p.ssim:
            from ..ops.pixel import ssim_wxh
            self.stats.ssim_sum += float(ssim_wxh(
                jnp.asarray(np.ascontiguousarray(
                    res_np["recon_y"][2:h, 2:w], np.int32)),
                jnp.asarray(np.ascontiguousarray(frame.y[2:, 2:],
                                                 np.int32))))
        if self.keep_recon:
            self.recon_by_disp[disp] = (res_np["recon_y"].copy(),
                                        res_np["recon_u"].copy(),
                                        res_np["recon_v"].copy())

        bref_ref = None
        bref_col = None
        bref_col_l0 = None
        if is_ref:
            # materialize the BREF as a reference picture: padded +
            # hpel planes on device, plus the colocated motion fields
            # dependent Bs' direct derivation reads. Spatial reads the
            # combined L0-else-L1 field per spec 8.4.1.2.2
            # (refIdxL0Col < 0 falls back to list 1; refs are the
            # TRUE per-8x8 L0 refs — colZeroFlag compares against 0);
            # temporal reads the L0-ONLY field, exactly the reference
            # cache (macroblock.c:187 fref1[0]->ref[0]): intra -> -1
            # (available, zeros), L1-only inter -> -2 (the
            # macroblock.c:199 map[-1] branch: direct-unavailable).
            # The decoder stores the identical fields at DPB insert.
            bref_ref = mc.build_ref(res["recon_y"], res["recon_u"],
                                    res["recon_v"])
            u0r = np.repeat(np.repeat(
                np.asarray(use0), 2, 0), 2, 1).astype(bool)
            u1r = np.repeat(np.repeat(
                np.asarray(use1), 2, 0), 2, 1).astype(bool)
            f0r = np.repeat(np.repeat(np.asarray(fmv0), 2, 0), 2, 1)
            f1r = np.repeat(np.repeat(np.asarray(fmv1), 2, 0), 2, 1)
            im4 = np.repeat(np.repeat(intra_kind > 0, 4, 0), 4, 1)
            r0_4 = (np.zeros((4 * mbh, 4 * mbw), np.int32)
                    if ref8_0 is None else
                    np.repeat(np.repeat(np.asarray(ref8_0), 2, 0),
                              2, 1).astype(np.int32))
            dead = im4 | ~(u0r | u1r)
            col_mv = np.where(u0r[..., None], f0r, f1r)
            col_mv = np.where(dead[..., None], 0,
                              col_mv).astype(np.int32)
            col_ref = np.where(dead, -1,
                               np.where(u0r, r0_4, 0)).astype(np.int32)
            bref_col = (col_mv, col_ref)
            col_mv0 = np.where((dead | ~u0r)[..., None], 0, f0r) \
                .astype(np.int32)
            col_ref0 = np.where(im4 | ~(u0r | u1r), -1,
                                np.where(u0r, r0_4, -2)) \
                .astype(np.int32)
            bref_col_l0 = (col_mv0, col_ref0)

        bw = BitWriter()
        H.write_slice_header(
            bw, self.sps, self.pps, H.SLICE_TYPE_B, self.frame_num,
            qp, idr=False, disable_deblock=1,
            poc_lsb=2 * (disp - self._last_idr_disp), is_ref=is_ref,
            direct_spatial=bool(spatial_pred),
            b_l0_active=b_l0_eff if b_mref else 1)
        if p.cabac:
            nal = self._write_b_slice_cabac(bw, res_np, qp, mode,
                                            mvd0, mvd1, subs=subs,
                                            intra_kind=intra_kind,
                                            intra_res=intra_res,
                                            aqg=aqg, ref0=ref0_16,
                                            num_ref=b_l0_eff
                                            if b_mref else 1)
        else:
            nal = self._write_b_slice_cavlc(bw, res_np, qp, mode,
                                            mvd0, mvd1, subs=subs,
                                            intra_kind=intra_kind,
                                            intra_res=intra_res,
                                            aqg=aqg, ref0=ref0_16,
                                            num_ref=b_l0_eff
                                            if b_mref else 1)
        out = self._aud(SLICE_B) \
            + nal_unit(NAL_SLICE,
                       NAL_PRIORITY_HIGH if is_ref
                       else NAL_PRIORITY_DISPOSABLE, nal)
        if is_ref:
            self.frame_num += 1   # reference pictures advance frame_num
        self.stats.b_frames += 1
        self.stats.frames += 1
        self.stats.bits += 8 * len(out)
        self._frame_idx += 1
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        self._emit_au(disp, out, "B")
        if is_ref:
            return out, bref_ref, bref_col, bref_col_l0
        return out

    def _write_b_slice_cavlc(self, bw, res, qp, mode, mvd0,
                             mvd1, subs=None, intra_kind=None,
                             intra_res=None, aqg=None, ref0=None,
                             num_ref: int = 1) -> bytes:
        """CAVLC B slice: B_SKIP runs + B MBs (16x16 subset rides the
        native twin; partition codes 4-22 and intra MBs take the
        Python writer). Skip rule: direct mode with no residual (spec
        7.4.4 mb_skip_run in B = B_Skip, decoded as direct)."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        if self._native is not None and intra_res is None \
                and np.all(mode <= 3) and not p.transform_8x8 \
                and aqg is None and ref0 is None:
            from .. import native
            n = mbh * mbw
            hdr, nbits = bw.partial_bytes()
            m0 = mvd0 if mvd0.ndim == 3 else mvd0[:, :, 0]
            m1 = mvd1 if mvd1.ndim == 3 else mvd1[:, :, 0]
            return native.write_slice_b(
                hdr, nbits, mbw, mbh, mode=mode.reshape(n),
                mvd0=np.ascontiguousarray(m0).reshape(n, 2),
                mvd1=np.ascontiguousarray(m1).reshape(n, 2),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_blocks=res["luma_lev"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16))
        fc = FrameCavlc(mbw, mbh, trans8_mode=p.transform_8x8)
        skip_run = 0
        last_qp = qp
        for my in range(mbh):
            for mx in range(mbw):
                k = (0 if intra_kind is None
                     else int(intra_kind[my, mx]))
                if k:
                    bw.write_ue(skip_run)
                    skip_run = 0
                    if k == 2:
                        fc.write_i4x4_mb(
                            bw, mx, my, intra_res["i4_modes"][my, mx],
                            int(intra_res["cmode"][my, mx]),
                            int(intra_res["cbp_luma"][my, mx]),
                            int(intra_res["cbp_chroma"][my, mx]),
                            intra_res["luma_ac"][my, mx],
                            intra_res["chroma_dc"][my, mx],
                            intra_res["chroma_ac"][my, mx], qp_delta=0,
                            in_b_slice=True)
                    else:
                        fc.write_i16x16_mb(
                            bw, mx, my, int(intra_res["mode"][my, mx]),
                            int(intra_res["cmode"][my, mx]),
                            int(intra_res["cbp_luma"][my, mx]),
                            int(intra_res["cbp_chroma"][my, mx]),
                            intra_res["luma_dc"][my, mx],
                            intra_res["luma_ac"][my, mx],
                            intra_res["chroma_dc"][my, mx],
                            intra_res["chroma_ac"][my, mx], qp_delta=0,
                            in_b_slice=True)
                    continue
                m = int(mode[my, mx])
                cl = int(res["cbp_luma"][my, mx])
                cc = int(res["cbp_chroma"][my, mx])
                if m == 0 and cl == 0 and cc == 0:
                    skip_run += 1
                    fc.set_mb_nnz_zero(mx, my)
                    continue
                bw.write_ue(skip_run)
                skip_run = 0
                dq = 0
                if aqg is not None and (cl or cc):
                    # spec 7.4.5 modular fold (see the P twin)
                    dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                    last_qp = int(aqg[my, mx])
                fc.write_b_mb(bw, mx, my, m, mvd0[my, mx],
                              mvd1[my, mx], cl, cc,
                              res["luma_lev"][my, mx],
                              res["chroma_dc"][my, mx],
                              res["chroma_ac"][my, mx], qp_delta=dq,
                              subs=None if subs is None
                              else subs[my, mx],
                              ref0=0 if ref0 is None
                              else int(ref0[my, mx]),
                              num_ref=num_ref)
        if skip_run:
            bw.write_ue(skip_run)
        bw.rbsp_trailing()
        return bw.get_bytes()

    def _write_b_slice_cabac(self, bw, res, qp, mode, mvd0,
                             mvd1, subs=None, intra_kind=None,
                             intra_res=None, aqg=None, ref0=None,
                             num_ref: int = 1) -> bytes:
        """CABAC B slice (reference encoder/cabac.c B branch). The
        16x16 subset rides the native twin; partition codes 4-22 and
        intra MBs take the Python writer (write_b_mb_ext /
        write_i*_mb in_b)."""
        from .cabac import CabacSliceWriter
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        if self._native is not None and intra_res is None \
                and np.all(mode <= 3) and not p.transform_8x8 \
                and aqg is None and ref0 is None:
            from .. import native
            hdr, nbits = bw.partial_bytes()
            m0 = mvd0 if mvd0.ndim == 3 else mvd0[:, :, 0]
            m1 = mvd1 if mvd1.ndim == 3 else mvd1[:, :, 0]
            return native.write_slice_cabac_b(
                hdr, nbits, mbw, mbh, qp, mode=mode.reshape(n),
                mvd0=np.ascontiguousarray(m0).reshape(n, 2),
                mvd1=np.ascontiguousarray(m1).reshape(n, 2),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_blocks=res["luma_lev"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16))
        while not bw.byte_aligned():
            bw.write1(1)
        per_unit = mvd0.ndim == 4     # B-partition path: [mbh,mbw,4,2]
        w = CabacSliceWriter(mbw, mbh, qp, slice_is_i=False,
                             slice_is_b=True,
                             trans8_mode=p.transform_8x8)
        last_qp = qp
        for a in range(n):
            my, mx = a // mbw, a % mbw
            k = 0 if intra_kind is None else int(intra_kind[my, mx])
            m = int(mode[my, mx])
            cl = int(res["cbp_luma"][my, mx])
            cc = int(res["cbp_chroma"][my, mx])
            if k == 2:
                w.write_i4_mb(my, mx, intra_res["i4_modes"][my, mx],
                              int(intra_res["cmode"][my, mx]),
                              int(intra_res["cbp_luma"][my, mx]),
                              int(intra_res["cbp_chroma"][my, mx]),
                              intra_res["luma_ac"][my, mx],
                              intra_res["chroma_dc"][my, mx],
                              intra_res["chroma_ac"][my, mx],
                              in_b=True)
            elif k == 1:
                w.write_i16_mb(my, mx, int(intra_res["mode"][my, mx]),
                               int(intra_res["cmode"][my, mx]),
                               int(intra_res["cbp_luma"][my, mx]),
                               int(intra_res["cbp_chroma"][my, mx]),
                               intra_res["luma_dc"][my, mx],
                               intra_res["luma_ac"][my, mx],
                               intra_res["chroma_dc"][my, mx],
                               intra_res["chroma_ac"][my, mx],
                               in_b=True)
            elif m == 0 and cl == 0 and cc == 0:
                w.write_b_skip_mb(my, mx)
            else:
                dq = 0
                if aqg is not None and (cl or cc):
                    dq = ((int(aqg[my, mx]) - last_qp + 26) % 52) - 26
                    last_qp = int(aqg[my, mx])
                if m <= 3:
                    d0 = mvd0[my, mx, 0] if per_unit else mvd0[my, mx]
                    d1 = mvd1[my, mx, 0] if per_unit else mvd1[my, mx]
                    w.write_b_mb(my, mx, m, d0, d1,
                                 cl, cc, res["luma_lev"][my, mx],
                                 res["chroma_dc"][my, mx],
                                 res["chroma_ac"][my, mx], dqp=dq,
                                 ref0=0 if ref0 is None
                                 else int(ref0[my, mx]),
                                 num_ref=num_ref)
                else:
                    w.write_b_mb_ext(my, mx, m,
                                     None if subs is None
                                     else subs[my, mx],
                                     mvd0[my, mx], mvd1[my, mx], cl, cc,
                                     res["luma_lev"][my, mx],
                                     res["chroma_dc"][my, mx],
                                     res["chroma_ac"][my, mx],
                                     dqp=dq,
                                     ref0=0 if ref0 is None
                                     else int(ref0[my, mx]),
                                     num_ref=num_ref)
            w.end_mb(a == n - 1)
        w.end_slice(bw)
        return bw.get_bytes()

    def _encode_p(self, y, u, v, qp: int) -> bytes:
        p = self.p
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        if p.p4x4 and p.partitions:
            return self._encode_p_sub(y, u, v, qp, qpc)
        if p.partitions or p.ref_frames > 1:
            # multi-ref without partitions (b66 --ref N --partitions
            # none): the mref machinery with the shape choice pinned
            # to 16x16 (allow_parts=False) — per-ref 16x16 ME + te(v)
            # ref_idx, like analyse.c:1122's per-ref loop alone
            return self._encode_p_parts(y, u, v, qp, qpc)

        self._p_l0_eff = 1   # unpartitioned path is single-ref
        mv_q, _ = self.analyse_p(y, qp)
        mv_np = np.asarray(mv_q)
        res = P.encode_p_frame_device(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
            jnp.asarray(mv_np), qp, qpc, p.mb_height, p.mb_width,
            decimate=p.dct_decimate, trellis=bool(p.trellis),
            nr_offset=self._nr_offset())
        self._nr_update(res, 16 * p.mb_height * p.mb_width)
        cbp_l = np.asarray(res["cbp_luma"])
        cbp_c = np.asarray(res["cbp_chroma"])
        if self._native is not None:
            from .. import native
            skip, mvd, mvp = native.host_scan_p(mv_np, cbp_l, cbp_c)
        else:
            skip, mvd, mvp = P.host_scan_p(mv_np, cbp_l, cbp_c)

        if self._stego is not None:
            replaced = self._stego.embed_frame(self, y, u, v, mv_np,
                                               None, skip, mvp)
            if replaced is not None:
                mv_np, skip, mvd, res = replaced
        need_recon = (self.keep_recon
                      or not (p.deblock and self._deblock_on_device()))
        res_np = _res_to_host(res, p.mb_height, p.mb_width,
                              with_recon=need_recon)

        if p.deblock and self._native is not None:
            self._deblock(res_np, intra=False, mv=mv_np,
                          skip=skip.astype(np.uint8), qp=qp)
        else:
            self._update_ref(res)
            self.recon_prev = (res_np["recon_y"], res_np["recon_u"],
                               res_np["recon_v"])
        res = res_np
        self.prev_mv = mv_np

        bw = BitWriter()
        H.write_slice_header(bw, self.sps, self.pps, H.SLICE_TYPE_P,
                             self.frame_num, qp, idr=False,
                             disable_deblock=0 if self.p.deblock else 1,
                             alpha_div2=self.p.deblock_alpha,
                             beta_div2=self.p.deblock_beta,
                             poc_lsb=self._poc_lsb,
                             reorder_l0=self._take_reorder_l0(),
                             p_l0_active=self._p_l0_eff)
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        if p.cabac:
            return self._write_p_slice_cabac(bw, res, qp, None, mvd,
                                             skip)
        if self._native is not None:
            from .. import native
            hdr, nbits = bw.partial_bytes()
            return native.write_slice(
                hdr, nbits, H.SLICE_TYPE_P, mbw, mbh,
                skip=skip.reshape(n).astype(np.uint8),
                mvd=mvd.reshape(n, 2),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_blocks=res["luma_lev"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16),
                trans8_mode=p.transform_8x8)
        fc = FrameCavlc(p.mb_width, p.mb_height,
                        trans8_mode=p.transform_8x8)
        skip_run = 0
        for my in range(p.mb_height):
            for mx in range(p.mb_width):
                if skip[my, mx]:
                    skip_run += 1
                    fc.set_mb_nnz_zero(mx, my)
                    continue
                bw.write_ue(skip_run)
                skip_run = 0
                fc.write_p16x16_mb(
                    bw, mx, my, (mvd[my, mx, 0], mvd[my, mx, 1]),
                    int(res["cbp_luma"][my, mx]),
                    int(res["cbp_chroma"][my, mx]),
                    res["luma_lev"][my, mx],
                    res["chroma_dc"][my, mx], res["chroma_ac"][my, mx],
                    qp_delta=0)
        if skip_run:
            bw.write_ue(skip_run)
        bw.rbsp_trailing()
        return bw.get_bytes()

    # ------------------------------------------------------------------
    # noise reduction (x264_noise_reduction_update, macroblock.c:902-922;
    # divergence: offsets lag by one frame — the reference updates its
    # running sums MB by MB, we accumulate per frame batch)
    _NR_W2 = np.array([[800, 320, 800, 320], [320, 128, 320, 128],
                       [800, 320, 800, 320], [320, 128, 320, 128]],
                      np.float64)   # FIX8(3.125/1.25/0.5), dct.h:55-64

    def _nr_offset(self):
        if not self.p.noise_reduction:
            return None
        num = (float(self.p.noise_reduction) * self._nr_count
               + self._nr_sum / 2)
        den = self._nr_sum * self._NR_W2 / 256.0 + 1.0
        return jnp.asarray((num / den).astype(np.int32))

    def _nr_update(self, res, n_blocks: int):
        if "nr_sum" not in res:
            return
        self._nr_sum += np.asarray(res["nr_sum"], np.float64)
        self._nr_count += n_blocks
        if self._nr_count > (1 << 18):
            self._nr_sum /= 2
            self._nr_count >>= 1

    def _accumulate_psnr(self, frame: Frame):
        if self.recon_prev is None or not (self.p.psnr or self.p.ssim):
            return
        h, w = frame.y.shape
        if self.p.psnr:
            ry, ru, rv = (np.asarray(x) for x in self.recon_prev)
            dy = ry[:h, :w].astype(np.int64) - frame.y.astype(np.int64)
            du = (ru[:h // 2, :w // 2].astype(np.int64)
                  - frame.u.astype(np.int64))
            dv = (rv[:h // 2, :w // 2].astype(np.int64)
                  - frame.v.astype(np.int64))
            self.stats.ssd_y += int(np.sum(dy * dy))
            self.stats.ssd_u += int(np.sum(du * du))
            self.stats.ssd_v += int(np.sum(dv * dv))
        if self.p.ssim:
            # SSIM must accumulate regardless of p.psnr — the serving
            # config --ssim --no-psnr depends on it (close() divides by
            # every encoded frame)
            from ..ops.pixel import ssim_wxh
            ry = np.asarray(self.recon_prev[0])
            self.stats.ssim_sum += float(ssim_wxh(
                jnp.asarray(np.ascontiguousarray(ry[2:h, 2:w], np.int32)),
                jnp.asarray(np.ascontiguousarray(frame.y[2:, 2:],
                                                 np.int32))))

    def close(self) -> dict:
        """Final summary (x264_encoder_close, encoder.c:2795-2884) +
        pass-1 stat flush (ratecontrol stat_out)."""
        from ..ops.pixel import psnr_from_ssd
        self.rc.write_stats()
        st = self.stats
        n = max(1, st.frames)
        npix_y = n * self.p.width * self.p.height
        fps = st.frames / st.elapsed if st.elapsed > 0 else 0.0
        return {
            "frames": st.frames,
            "fps": fps,
            "kbps": (st.bits * self.p.fps_num / self.p.fps_den / n / 1000.0
                     if n else 0.0),
            "psnr_y": psnr_from_ssd(st.ssd_y, npix_y),
            "psnr_u": psnr_from_ssd(st.ssd_u, npix_y // 4),
            "psnr_v": psnr_from_ssd(st.ssd_v, npix_y // 4),
            "ssim_y": (st.ssim_sum / max(1, st.frames)
                       / max(1, ((self.p.width - 6) >> 2)
                             * ((self.p.height - 6) >> 2))
                       if self.p.ssim else 0.0),
            "mv_covers": st.mv_covers,
            "message_bits": st.message_bits,
            "mv_flips": st.mv_flips,
        }
