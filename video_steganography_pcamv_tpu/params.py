"""Encoder parameter system.

Mirrors the reference's `x264_param_t` (/root/reference/x264.h:154-311) and
its string-keyed parser `x264_param_parse` (/root/reference/common/common.c:208):
every option is settable by name. Only the subset of options this build
implements is accepted; unknown keys raise.

The stego options mirror `eparam` (/root/reference/x264.h:299-309). Unlike
the reference — where `--key` and `--emfile` are parsed but never consumed
(x264.c:518,525) — here they are functional: `key` seeds both the message
generator and the STC parity matrix; `emfile` supplies the message bytes.
This divergence is deliberate and documented.
"""

from __future__ import annotations

from dataclasses import dataclass, field


# slice types
SLICE_I = 0
SLICE_P = 1
SLICE_B = 2

# ME methods (reference: x264.h X264_ME_*)
ME_DIA = 0
ME_HEX = 1
ME_UMH = 2
ME_ESA = 3

_ME_NAMES = {"dia": ME_DIA, "hex": ME_HEX, "umh": ME_UMH, "esa": ME_ESA}


@dataclass
class StegoParams:
    """Reference: eparam struct /root/reference/x264.h:299-309."""
    em_rate: float = 0.0   # >1: bits/frame; (0,1]: bits per cover MV
                           # (encoder.c:1828-1836)
    key: int = 0           # seeds message + parity matrix (functional here)
    em_file: str = ""      # message bytes from file (functional here)
    stc_h: int = 10        # STC constraint height (encoder.c:1843 uses 10)
    alpha_loc: float = 1.0  # local-optimality cost weight (encoder.c:1651)
    alpha_com: float = 0.0  # MV-field complexity weight (encoder.c:1652, off)
    mvc_c1: float = 2.0    # MVC multiplier, 2-MV partitions (encoder.c:1653)
    mvc_c2: float = 0.7    # MVC multiplier slope, 4-MV groups
    beta1: float = 1.4     # 2-neighbourhood candidate penalty (analyse.c:2393)
    beta2: float = 4.0     # optimality-class-broken penalty (analyse.c:2394)

    @property
    def enabled(self) -> bool:
        return self.em_rate > 0


@dataclass
class Params:
    width: int = 0
    height: int = 0
    fps_num: int = 25
    fps_den: int = 1

    # GOP structure
    keyint_max: int = 250
    keyint_min: int = 25
    scenecut_threshold: int = 40   # reference default i_scenecut_threshold
    lookahead_me_range: int = 8
    bframes: int = 0
    b_adapt: int = 1               # adaptive B placement (x264
                                   # i_bframe_adaptive: 0 off, 1 fast
                                   # heuristic, 2 trellis over the
                                   # lookahead window)
    rc_lookahead: int = 0          # lookahead window (x264
                                   # --rc-lookahead; frames.i_delay
                                   # sizing encoder.c:713-726). With
                                   # --b-adapt 2 the B-placement DP
                                   # sees max(bframes+1, this) frames
                                   # (clamped to 12 here)
    b_pyramid: bool = False        # keep the middle B of each GOP as
                                   # a reference (x264 --b-pyramid)
    direct: int = 1                # B direct MV prediction (x264
                                   # --direct): 0 none, 1 spatial,
                                   # 2 temporal, 3 auto
    weightb: bool = False          # implicit weighted bipred (x264
                                   # --weightb b_weighted_bipred;
                                   # PPS weighted_bipred_idc=2,
                                   # macroblock.c:1420 weight init)

    # rate control (reference: x264_param_t.rc, ratecontrol.c)
    rc_mode: int = 0               # 0 CQP / 1 CRF / 2 ABR (RC_* below)
    qp: int = 26
    qp_min: int = 10
    qp_max: int = 51
    qp_step: int = 4
    ip_ratio: float = 1.4          # qscale ratio I:P (f_ip_factor);
                                   # CQP derives the I offset as
                                   # 6*log2(ip_ratio) (ratecontrol.c:369)
    pb_ratio: float = 1.3          # qscale ratio P:B (f_pb_factor)
    bitrate: int = 0               # kbps (ABR target)
    crf: float = 0.0               # CRF quality target
    rate_tolerance: float = 1.0
    qcomp: float = 0.6
    vbv_maxrate: int = 0           # kbps
    vbv_bufsize: int = 0           # kbits
    vbv_init: float = 0.9
    stat_out: str = ""             # 2-pass: pass-1 stat file to write
    stat_in: str = ""              # 2-pass: stat file to read (pass 2)
    qpfile: str = ""               # forced per-frame types/QPs
    # Default 0 = the reference's PPS value at its default/low-subme
    # settings: b66 ZEROES f_psy_rd whenever subme < 6
    # (encoder.c:513-514), so the psy chroma compensation
    # (encoder.c:520-521, offset -= 2) never fires there — verified by
    # parsing the built binary's PPS (chroma_qp_index_offset = 0 at
    # subme 2/default 5). Only a subme >= 6 reference run carries -2;
    # pass --chroma-qp-offset -2 when matching THOSE flags.
    chroma_qp_offset: int = 0

    # analysis
    i4x4: bool = True          # intra 4x4 partitions (x264 analyse default)
    intra_in_p: bool = True    # intra compare in P MBs (reference default;
                               # force-disabled while embedding,
                               # analyse.c:2862-2863)
    me_method: int = ME_ESA
    me_range: int = 16
    ref_frames: int = 1        # L0 DPB size (x264 --ref, i_frame_reference)
    subpel: int = 2          # 0: fullpel, 1: halfpel, 2: quarterpel
    dct_decimate: bool = True  # reference analyse.b_dct_decimate default on
    trellis: int = 0           # 0 off, 1 final-encode trellis quant
                               # (x264 --trellis; rdo.c quant_trellis_cabac)
    partitions: bool = True    # P 16x8/8x16/8x8 trees (x264 default
                               # analyse=p8x8)
    p4x4: bool = False         # sub-8x8 splits 8x4/4x8/4x4 (x264
                               # analyse=p4x4, off by default there too)
    deadzone_inter: int = 21     # inter luma quant deadzone (x264
                                 # --deadzone-inter; bias = 32-dz
                                 # chroma follows luma — doc'd
                                 # divergence, x264 is luma-only)
    deadzone_intra: int = 11     # intra luma quant deadzone
    fast_pskip: bool = True      # accepted for x264 CLI compat; the
                                 # exhaustive analysis subsumes it
    cqm: str = "flat"            # quant matrix preset (x264 --cqm:
                                 # flat | jvt); custom lists override
    cqm4i: tuple = None          # custom 4x4 intra list (16, raster)
    cqm4p: tuple = None          # custom 4x4 inter list
    cqm8i: tuple = None          # custom 8x8 intra list (64, raster)
    cqm8p: tuple = None          # custom 8x8 inter list
    transform_8x8: bool = False  # High profile 8x8 transform + i8x8
                                 # intra (x264 --8x8dct)
    rd: int = 0                # 2 adds the P_SKIP RD probe (forced-
                               # skip re-encode; i_mbrd=2 analog)
                               # RD mode decision (x264 i_mbrd, subme>=6:
                               # exact-bits+SSD refinement; currently the
                               # transform decision + intra mode ranking)

    # entropy / tools
    psnr: bool = True          # in-loop PSNR (x264 b_psnr; off skips
                               # the recon download when the reference
                               # stays on-device)
    ssim: bool = False         # in-loop SSIM metric (x264 --ssim,
                               # encoder.c:1069-1080)
    noise_reduction: int = 0   # denoise_dct strength (x264 --nr,
                               # quant.c:180 / macroblock.c:902)
    cabac: bool = False
    deblock: bool = True     # in-loop deblocking (reference default: on)
    deblock_alpha: int = 0   # slice_alpha_c0_offset_div2 (x264
                             # --deblock A:B, [-6,6])
    deblock_beta: int = 0    # slice_beta_offset_div2
    deblock_device: bool = False  # run the deblocker on the device
                                  # (bit-exact 254-wave twin): 27.4 ms
                                  # vs 17.5 ms for host C++ incl. both
                                  # transfers at 1080p (H100 SXM, 400 W;
                                  # PERF.md), so off by default; the
                                  # pipelined serving driver needs it

    # adaptive quantization (x264 --aq-mode/--aq-strength;
    # x264_adaptive_quant_frame ratecontrol.c:231) + zones
    # (--zones start,end,q=N or b=F; parse_zones ratecontrol.c:602)
    aq_mode: int = 0           # 0 off, 1 variance AQ
    aq_strength: float = 1.0
    zones: str = ""            # "0,99,q=30/100,199,b=0.5"

    # stego
    stego: StegoParams = field(default_factory=StegoParams)

    # metadata / VUI (reference: x264_param_t.vui, x264.h:166-183;
    # assembled into the SPS by x264_sps_init, encoder/set.c:147-211)
    level_idc: int = 0         # 0 = auto-pick smallest fitting level
                               # (reference default -1 = auto too,
                               # common.c:64)
    sps_id: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan: int = 0          # 0 undef / 1 show / 2 crop
    videoformat: int = 5
    fullrange: bool = False
    colorprim: int = 2
    transfer: int = 2
    colmatrix: int = 2
    chromaloc: int = 0         # 0..5 (spec E-2)
    aud: bool = False          # access-unit delimiters (x264 --aud)

    # misc
    threads: int = 1
    log_level: int = 2
    incremental: bool = True   # stego pass-2 re-encodes only the
                               # flip-touched MBs (inter_incr.py);
                               # False forces the full-frame re-encode
                               # (A/B + debugging)
    pipeline: bool = True      # software-pipelined stego serving path:
                               # frame N's entropy is written while the
                               # device runs frame N+1's stage-1 (one
                               # blocking pull per steady-state frame).
                               # Engages only on the fast IPP path with
                               # metrics off + device deblock; output
                               # AUs lag one frame (flush() drains).
    pipeline_deep: bool = False  # speculative deep pipeline: next
                               # frame's ANALYSIS runs against the
                               # pre-flip recon (then a pass-1 patch
                               # vs the true reference) so the packed
                               # pull and the host STC overlap device
                               # work. Conformant + extraction-exact;
                               # mv/partition decisions may differ
                               # from the canonical path near flipped
                               # MBs (x264 --non-deterministic class).
                               # AUs lag 2 frames; IPP/CQP fast path
                               # only.

    def validate(self) -> None:
        """Clamp/check (reference: x264_validate_parameters encoder.c:342)."""
        assert self.width % 2 == 0 and self.height % 2 == 0, \
            "dimensions must be even (4:2:0)"
        self.qp = max(self.qp_min, min(self.qp_max, self.qp))
        self.bframes = max(0, min(16, self.bframes))
        self.b_adapt = max(0, min(2, self.b_adapt))
        # pyramid needs >= 2 Bs per GOP (reference encoder.c:463)
        self.b_pyramid = self.b_pyramid and self.bframes > 1
        self.rc_lookahead = max(0, min(12, self.rc_lookahead))
        self.subpel = max(0, min(2, self.subpel))
        self.ref_frames = max(1, min(8, self.ref_frames))
        # multi-ref combines with partitions ON or OFF (b66 allows
        # --ref N --partitions none: 16x16-only per-ref ME,
        # encoder.c:420-503 never couples them; with partitions off
        # the mref analysis runs with allow_parts=False) and with
        # every direct mode (temporal maps the colocated ref through
        # map_col_to_list0 with per-ref DistScaleFactors; weightb
        # rides per-L0-ref implicit weight tables), with b-pyramid
        # (the BREF enters the sliding window) and with sub-8x8
        # embedding (the RCA probe tables are gathered from each
        # block's own DPB entry; flips alternate MVs, never refs —
        # analyse.c:3518)
        if self.crf > 0 and self.rc_mode == 0:
            self.rc_mode = 1
        if self.bitrate > 0 and self.rc_mode == 0:
            self.rc_mode = 2
        if self.rc_mode == 2:
            assert self.bitrate > 0, "ABR requires bitrate"
        if self.vbv_maxrate > 0:
            assert self.vbv_bufsize > 0, "VBV needs bufsize"
        self.keyint_min = min(self.keyint_min, self.keyint_max)
        self.deblock_alpha = max(-6, min(6, self.deblock_alpha))
        self.deblock_beta = max(-6, min(6, self.deblock_beta))
        # 8x8dct + p4x4 coexist (b66: x264_mb_transform_8x8_allowed,
        # macroblock.h:462 — the per-MB transform_size_8x8_flag is
        # simply absent on MBs carrying sub-8x8 partitions, spec 7.3.5
        # noSubMbPartSizeLessThan8x8Flag; round-5 gate deletion)
        self.deadzone_inter = max(0, min(32, self.deadzone_inter))
        self.deadzone_intra = max(0, min(32, self.deadzone_intra))
        assert self.cqm in ("flat", "jvt"), f"unknown cqm {self.cqm}"
        if not self.cabac:
            # ops/trellis.py rates bits with a CABAC context model; the
            # reference likewise forces trellis off without CABAC
            # (encoder.c:506-508)
            self.trellis = 0
        self.aq_mode = max(0, min(1, self.aq_mode))
        self.aq_strength = max(0.0, min(3.0, self.aq_strength))
        if self.aq_mode:
            # per-MB QP covers I/P/B via the partition paths (docs/
            # PARITY.md); embedding rides the non-fused P path (rho at
            # frame-QP lambda — flip ordering only, extraction is blind)
            if self.stego.enabled:
                assert self.partitions, \
                    "AQ + embedding needs the partition path"

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16


_BOOL = {"1": True, "0": False, "true": True, "false": False,
         "yes": True, "no": False}


def _enum(value: str, names) -> int:
    """Name-or-index enum parse (reference: parse_enum common.c:188)."""
    if value in names:
        return names.index(value)
    return int(value)


def param_parse(p: Params, name: str, value: str) -> None:
    """String-keyed option setter (reference: common/common.c:208)."""
    name = name.replace("-", "_")
    if name in ("qp", "qp_constant"):
        p.qp = int(value)
        p.rc_mode = 0
    elif name == "keyint":
        p.keyint_max = int(value)
    elif name in ("min_keyint", "keyint_min"):
        p.keyint_min = int(value)
    elif name == "scenecut":
        p.scenecut_threshold = int(value)
    elif name == "bitrate":
        p.bitrate = int(value)
        p.rc_mode = 2
    elif name == "crf":
        p.crf = float(value)
        p.rc_mode = 1
    elif name == "qpmin":
        p.qp_min = int(value)
    elif name == "qpmax":
        p.qp_max = int(value)
    elif name == "qpstep":
        p.qp_step = int(value)
    elif name == "ratetol":
        p.rate_tolerance = float(value)
    elif name == "qcomp":
        p.qcomp = float(value)
    elif name == "ipratio":
        p.ip_ratio = float(value)
    elif name == "vbv_maxrate":
        p.vbv_maxrate = int(value)
    elif name == "vbv_bufsize":
        p.vbv_bufsize = int(value)
    elif name == "vbv_init":
        p.vbv_init = float(value)
    elif name == "stats_out":
        p.stat_out = value
    elif name in ("stats", "stats_in"):
        p.stat_in = value
    elif name == "qpfile":
        p.qpfile = value
    elif name == "me":
        p.me_method = _ME_NAMES[value]
    elif name == "merange":
        p.me_range = int(value)
    elif name in ("ref", "ref_frames", "frameref"):
        p.ref_frames = int(value)
    elif name == "subme":
        p.subpel = int(value)
    elif name == "trellis":
        p.trellis = int(value)
    elif name == "ssim":
        p.ssim = _BOOL[value.lower()]
    elif name in ("psnr", "no_psnr"):
        p.psnr = _BOOL[value.lower()] if name == "psnr" \
            else not _BOOL[value.lower()]
    elif name in ("nr", "noise_reduction"):
        p.noise_reduction = int(value)
    elif name == "aq_mode":
        p.aq_mode = int(value)
    elif name == "aq_strength":
        p.aq_strength = float(value)
    elif name == "zones":
        p.zones = value
    elif name == "partitions":
        p.partitions = value not in ("none", "0", "false")
    elif name == "i4x4":
        p.i4x4 = _BOOL[value.lower()]
    elif name == "p4x4":
        p.p4x4 = _BOOL[value.lower()]
    elif name in ("8x8dct", "transform_8x8"):
        p.transform_8x8 = _BOOL[value.lower()]
    elif name in ("rd", "mbrd"):
        p.rd = int(value)
    elif name == "intra_in_p":
        p.intra_in_p = _BOOL[value.lower()]
    elif name == "deblock_device":
        p.deblock_device = _BOOL[value.lower()]
    elif name == "pipeline":
        p.pipeline = _BOOL[value.lower()]
    elif name == "incremental":
        p.incremental = _BOOL[value.lower()]
    elif name == "pipeline_deep":
        p.pipeline_deep = _BOOL[value.lower()]
    elif name in ("deblock", "filter"):
        # x264 common.c OPT2("deblock","filter"): ints set the
        # alpha/beta offsets (and enable the filter); a bool word
        # toggles b_deblocking_filter
        try:
            parts2 = value.replace(":", ",").split(",")
            a = int(parts2[0])
            b = int(parts2[1]) if len(parts2) > 1 else a
        except ValueError:
            p.deblock = _BOOL[value.lower()]
        else:
            p.deblock_alpha, p.deblock_beta = a, b
            p.deblock = True
    elif name == "cabac":
        p.cabac = _BOOL[value.lower()]
    elif name == "dct_decimate":
        p.dct_decimate = _BOOL[value.lower()]
    elif name == "chroma_qp_offset":
        p.chroma_qp_offset = int(value)
    elif name == "bframes":
        p.bframes = int(value)
    elif name in ("b_adapt", "b-adapt"):
        p.b_adapt = int(value)
    elif name in ("weightb", "weighted_bipred"):
        p.weightb = _BOOL[value.lower()]
    elif name in ("deadzone_inter", "deadzone-inter"):
        p.deadzone_inter = int(value)
    elif name in ("deadzone_intra", "deadzone-intra"):
        p.deadzone_intra = int(value)
    elif name in ("fast_pskip", "fast-pskip"):
        p.fast_pskip = _BOOL[value.lower()]
    elif name == "cqm":
        p.cqm = value.lower()
    elif name in ("b_pyramid", "b-pyramid"):
        p.b_pyramid = _BOOL[value.lower()]
    elif name == "direct":
        p.direct = {"none": 0, "spatial": 1, "temporal": 2,
                    "auto": 3}[value.lower()]
    elif name == "rc_lookahead":
        p.rc_lookahead = int(value)
    elif name == "threads":
        p.threads = int(value)
    elif name == "fps":
        if "/" in value:
            n, d = value.split("/")
            p.fps_num, p.fps_den = int(n), int(d)
        else:
            p.fps_num, p.fps_den = int(float(value) * 1000), 1000
    # metadata / VUI (reference: common.c:266-300 OPT blocks)
    elif name in ("level", "level_idc"):
        # "3.1" -> 31; "31" -> 31 (common.c:273-278)
        if "." in value:
            p.level_idc = int(10 * float(value) + 0.5)
        else:
            p.level_idc = int(value)
    elif name == "sps_id":
        p.sps_id = int(value)
    elif name == "sar":
        w, h = value.replace(":", "x").replace("/", "x").split("x")
        p.sar_width, p.sar_height = int(w), int(h)
    elif name == "overscan":
        p.overscan = _enum(value, ("undef", "show", "crop"))
    elif name == "videoformat":
        p.videoformat = _enum(
            value, ("component", "pal", "ntsc", "secam", "mac", "undef"))
    elif name == "fullrange":
        p.fullrange = bool(_enum(value, ("off", "on")))
    elif name == "colorprim":
        p.colorprim = _enum(
            value, ("", "bt709", "undef", "", "bt470m", "bt470bg",
                    "smpte170m", "smpte240m", "film"))
    elif name == "transfer":
        p.transfer = _enum(
            value, ("", "bt709", "undef", "", "bt470m", "bt470bg",
                    "smpte170m", "smpte240m", "linear", "log100",
                    "log316"))
    elif name == "colormatrix":
        p.colmatrix = _enum(
            value, ("GBR", "bt709", "undef", "", "fcc", "bt470bg",
                    "smpte170m", "smpte240m", "YCgCo"))
    elif name == "chromaloc":
        p.chromaloc = max(0, min(5, int(value)))
    elif name == "aud":
        p.aud = _BOOL[value.lower()]
    # stego options (reference CLI: x264.c:394-402)
    elif name == "emrate":
        p.stego.em_rate = float(value)
    elif name == "key":
        p.stego.key = int(value)
    elif name == "emfile":
        p.stego.em_file = value
    elif name == "stc_h":
        p.stego.stc_h = int(value)
    else:
        raise KeyError(f"unknown option: {name}")


def param2string(p: Params) -> str:
    """Option summary string for the SEI version message (reference:
    x264_param2string, common/common.c:818)."""
    s = (f"qp={p.qp} keyint={p.keyint_max} min-keyint={p.keyint_min} "
         f"scenecut={p.scenecut_threshold} bframes={p.bframes} "
         f"ref={p.ref_frames} me=esa merange={p.me_range} "
         f"subme={p.subpel} trellis={p.trellis} "
         f"cabac={int(p.cabac)} deblock={int(p.deblock)} "
         f"decimate={int(p.dct_decimate)} nr={p.noise_reduction} "
         f"8x8dct={int(p.transform_8x8)} rd={p.rd} parts={int(p.partitions)} "
         f"cqm={p.cqm} "
         f"p4x4={int(p.p4x4)} aq={p.aq_mode} weightb={int(p.weightb)} "
         f"direct={('none', 'spatial', 'temporal', 'auto')[p.direct]} "
         f"b-pyramid={int(p.b_pyramid)} b-adapt={p.b_adapt} "
         f"deadzone={p.deadzone_inter},{p.deadzone_intra}")
    if p.aq_mode:
        s += f":{p.aq_strength:.1f}"
    if p.rc_mode == 1:
        s += f" crf={p.crf:.1f}"
    elif p.rc_mode == 2:
        s += f" bitrate={p.bitrate} ratetol={p.rate_tolerance:.1f}"
    if p.stego.enabled:
        s += f" emrate={p.stego.em_rate:g} stc_h={p.stego.stc_h}"
    return s
