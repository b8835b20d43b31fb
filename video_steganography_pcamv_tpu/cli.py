"""x264-style CLI (reference: /root/reference/x264.c:91-934).

    python -m video_steganography_pcamv_tpu.cli in.y4m -o out.264 \
        --qp 26 --emrate 64 --key 7 [--input-res WxH] [--frames N]

Stego options mirror the reference CLI (x264.c:394-402); --key/--emfile
are functional here (inert in the reference). `--extract` runs the blind
extractor instead of encoding.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .params import Params, param_parse, StegoParams
from .utils import yuv
from .encoder.core import Encoder


def build_argparser():
    ap = argparse.ArgumentParser(prog="pcamv-tpu")
    ap.add_argument("input", help="input .y4m/.yuv (or .264 with --extract)")
    ap.add_argument("-o", "--output", default="out.264")
    ap.add_argument("--input-res", default=None, help="WxH for raw yuv")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--seek", type=int, default=0)
    ap.add_argument("--qp", type=int, default=26)
    # rate control (reference: x264.c --bitrate/--crf/--vbv-*/--pass)
    ap.add_argument("--bitrate", type=int, default=0, help="ABR kbps")
    ap.add_argument("--crf", type=float, default=0.0)
    ap.add_argument("--vbv-maxrate", type=int, default=0)
    ap.add_argument("--vbv-bufsize", type=int, default=0)
    ap.add_argument("--ratetol", type=float, default=1.0)
    ap.add_argument("--qpmin", type=int, default=10)
    ap.add_argument("--qpmax", type=int, default=51)
    ap.add_argument("--pass", dest="rc_pass", type=int, default=0,
                    choices=(0, 1, 2))
    ap.add_argument("--stats", default="pcamv_2pass.log")
    ap.add_argument("--qpfile", default="")
    ap.add_argument("--keyint", type=int, default=250)
    ap.add_argument("--min-keyint", type=int, default=25)
    ap.add_argument("--scenecut", type=int, default=40)
    ap.add_argument("--merange", type=int, default=16)
    ap.add_argument("--ref", type=int, default=1,
                    help="number of L0 reference frames (x264 --ref)")
    ap.add_argument("--bframes", "-b", type=int, default=0,
                    help="consecutive B frames between anchors")
    ap.add_argument("--b-adapt", type=int, default=1, choices=(0, 1, 2),
                    help="adaptive B placement (0 off, 1 fast, "
                         "2 lookahead trellis; x264 --b-adapt)")
    ap.add_argument("--rc-lookahead", type=int, default=0,
                    help="slice-type lookahead window in frames "
                         "(x264 --rc-lookahead)")
    ap.add_argument("--weightb", "-w", action="store_true",
                    help="implicit weighted bipred in B frames "
                         "(x264 --weightb)")
    ap.add_argument("--deadzone-inter", type=int, default=21,
                    help="inter luma quantization deadzone "
                         "(x264 --deadzone-inter; chroma follows)")
    ap.add_argument("--deadzone-intra", type=int, default=11,
                    help="intra luma quantization deadzone")
    ap.add_argument("--no-fast-pskip", action="store_true",
                    help="x264 compat: accepted; the exhaustive "
                         "device analysis always evaluates all modes")
    ap.add_argument("--threads", type=int, default=1,
                    help="x264 compat: single-chip encode is one "
                         "device pipeline; scale across chips with "
                         "the mesh runner (parallel/mesh.py)")
    ap.add_argument("--me", default="esa",
                    help="x264 compat: the device path is always "
                         "exhaustive (esa); dia/hex/umh map to esa")
    ap.add_argument("--cqm", default="flat", choices=["flat", "jvt"],
                    help="quantization matrix preset (x264 --cqm)")
    ap.add_argument("--cqm4", default="",
                    help="custom 4x4 list: 16 comma ints, raster "
                         "order, applied to intra+inter (x264 --cqm4)")
    ap.add_argument("--cqm8", default="",
                    help="custom 8x8 list: 64 comma ints (x264 --cqm8)")
    ap.add_argument("--b-pyramid", action="store_true",
                    help="keep the middle B of each GOP as a "
                         "reference (x264 --b-pyramid)")
    ap.add_argument("--direct", default="spatial",
                    choices=["none", "spatial", "temporal", "auto"],
                    help="B direct MV prediction mode (x264 --direct)")
    ap.add_argument("--subme", type=int, default=2)
    ap.add_argument("--trellis", type=int, default=0,
                    help="trellis RD quantization (0 off, 1 final encode)")
    ap.add_argument("--ssim", action="store_true",
                    help="compute in-loop SSIM (x264 --ssim)")
    ap.add_argument("--no-psnr", action="store_true",
                    help="skip in-loop PSNR (keeps recon on-device "
                         "with device deblocking)")
    ap.add_argument("--deblock", default="0:0", dest="deblock_ab",
                    help="alpha:beta deblock offsets in [-6,6] "
                         "(x264 --deblock / -f)")
    ap.add_argument("--deblock-device", action="store_true",
                    help="run the in-loop deblocker on-device "
                         "(serving config; the reference stays on the "
                         "device)")
    ap.add_argument("--nr", type=int, default=0,
                    help="noise reduction strength (x264 --nr)")
    ap.add_argument("--chroma-qp-offset", type=int, default=0,
                    help="chroma QP offset, PPS chroma_qp_index_offset "
                         "(x264 --chroma-qp-offset; the reference's "
                         "psy -2 compensation only fires at subme>=6 — "
                         "pass -2 to match such runs)")
    ap.add_argument("--aq-mode", type=int, default=0,
                    help="adaptive quantization (0 off, 1 variance AQ; "
                         "x264 --aq-mode)")
    ap.add_argument("--aq-strength", type=float, default=1.0,
                    help="AQ strength (x264 --aq-strength)")
    ap.add_argument("--zones", default="",
                    help="start,end,q=QP or b=FACTOR zones separated "
                         "by '/' (x264 --zones)")
    ap.add_argument("--no-dct-decimate", action="store_true")
    ap.add_argument("--cabac", action="store_true")
    ap.add_argument("--no-partitions", action="store_true")
    ap.add_argument("--p4x4", action="store_true",
                    help="sub-8x8 partitions 8x4/4x8/4x4 "
                         "(x264 analyse=p4x4)")
    ap.add_argument("--8x8dct", dest="dct8", action="store_true",
                    help="High profile 8x8 transform + i8x8 intra "
                         "(x264 --8x8dct)")
    ap.add_argument("--rd", type=int, default=0,
                    help="RD mode decision (x264 i_mbrd / subme>=6)")
    # stego (reference: x264.c:394-402)
    ap.add_argument("--emrate", type=float, default=0.0)
    ap.add_argument("--key", type=int, default=0)
    ap.add_argument("--emfile", default="")
    ap.add_argument("--extract", action="store_true",
                    help="blind-extract payload from an Annex-B stream")
    ap.add_argument("--dump-yuv", default="",
                    help="write reconstructed frames (y4m)")
    ap.add_argument("--no-threaded-input", dest="threaded_input",
                    action="store_false", default=True,
                    help="disable the input read-ahead thread "
                         "(x264 threaded reader analog, muxers.c:441)")
    ap.add_argument("--visualize", default="",
                    help="dump per-frame MB/MV overlay PPMs with this "
                         "prefix (reference: --visualize X11 overlay)")
    # stream metadata / VUI (x264.c:301-347)
    ap.add_argument("--fps", default="",
                    help="framerate (num/den or float) for timing VUI "
                         "+ rate control")
    ap.add_argument("--sar", default="", help="sample aspect ratio w:h")
    ap.add_argument("--level", default="",
                    help="level (Annex A): '3.1' or '31'; default auto")
    ap.add_argument("--sps-id", type=int, default=0)
    ap.add_argument("--aud", action="store_true",
                    help="write access-unit delimiters")
    ap.add_argument("--overscan", default="undef",
                    help="undef / show / crop")
    ap.add_argument("--videoformat", default="undef",
                    help="component/pal/ntsc/secam/mac/undef")
    ap.add_argument("--fullrange", default="off", help="off / on")
    ap.add_argument("--colorprim", default="undef")
    ap.add_argument("--transfer", default="undef")
    ap.add_argument("--colormatrix", default="undef")
    ap.add_argument("--chromaloc", type=int, default=0,
                    help="chroma sample location (0-5)")
    ap.add_argument("--device", default="", choices=("", "cpu", "gpu"),
                    help="run on the CPU or on a CUDA GPU (default: "
                         "JAX's own choice); gpu fails when there is "
                         "no GPU")
    ap.add_argument("--log-level", type=int, default=2,
                    help="-1 none, 0 error, 1 warning, 2 info, 3 debug "
                         "(x264 --log-level)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    return ap


import contextlib


@contextlib.contextmanager
def _null_ctx():
    yield None


def _cqmlist(text: str, n: int):
    if not text:
        return None
    vals = [int(x) for x in text.replace(":", ",").split(",") if x]
    assert len(vals) == n, f"--cqm list needs {n} values"
    return tuple(vals)


def main(argv=None):
    from .utils.log import (set_level, error, PcamvError, LOG_ERROR,
                            LOG_DEBUG)
    args = build_argparser().parse_args(argv)
    set_level(LOG_ERROR if args.quiet
              else LOG_DEBUG if args.verbose else args.log_level)
    from .utils.jaxcache import setup_compile_cache
    setup_compile_cache()
    try:
        if args.device:
            _select_device(args.device)
        return _run(args)
    except (PcamvError, AssertionError, OSError) as e:
        # x264-style error contract: log + nonzero exit, no traceback
        # (x264.c:786-790 handles encoder_encode < 0 the same way)
        error(str(e) or type(e).__name__)
        return -1


def _select_device(device: str):
    """Pin JAX to the CPU or to CUDA before the first backend use; a
    missing GPU is an error, never a quiet fall back to the CPU."""
    import jax
    from .utils.log import PcamvError
    jax.config.update("jax_platforms", "cuda" if device == "gpu" else "cpu")
    try:
        platform = jax.devices()[0].platform
    except RuntimeError as e:
        raise PcamvError(f"--device {device}: {e}") from None
    if platform != device:
        raise PcamvError(f"--device {device}: JAX runs on {platform}")


def _run(args):
    from .utils.log import warning
    if args.me not in ("esa", "tesa"):
        # accepted for x264 compat but NOT a silent alias: the batched
        # device analysis is always exhaustive (me.c:248-525 methods
        # collapse into ESA — more search effort, not less)
        warning(f"--me {args.me} maps to esa on the device path "
                "(exhaustive batched search)")
    if args.extract:
        from .stego.extract import extract_from_stream
        data = open(args.input, "rb").read()
        if args.input.endswith(".mp4"):
            from .utils.mp4 import demux_mp4
            data = demux_mp4(data)
        msgs = extract_from_stream(data, em_rate=args.emrate, key=args.key)
        for i, m in enumerate(msgs):
            print(f"frame {i}: {len(m)} bits: "
                  f"{''.join(map(str, m[:64]))}{'...' if len(m) > 64 else ''}")
        if args.output and args.output != "out.264":
            bits = np.concatenate(msgs) if msgs else np.zeros(0, np.uint8)
            np.packbits(bits).tofile(args.output)
        return 0

    if args.input_res:
        w, h = map(int, args.input_res.lower().split("x"))
        reader = yuv.open_input(args.input, w, h)
    else:
        reader = yuv.open_input(args.input)
    if args.threaded_input:
        # overlap file I/O with the encode (muxers.c:441-517 analog)
        reader = yuv.PrefetchReader(reader, start=args.seek)

    p = Params(width=reader.width, height=reader.height, qp=args.qp,
               keyint_max=args.keyint, keyint_min=args.min_keyint,
               scenecut_threshold=args.scenecut,
               me_range=args.merange,
               ref_frames=args.ref,
               bframes=args.bframes,
               b_adapt=args.b_adapt,
               rc_lookahead=args.rc_lookahead,
               weightb=args.weightb,
               b_pyramid=args.b_pyramid,
               deadzone_inter=args.deadzone_inter,
               deadzone_intra=args.deadzone_intra,
               fast_pskip=not args.no_fast_pskip,
               cqm=args.cqm,
               cqm4i=_cqmlist(args.cqm4, 16),
               cqm4p=_cqmlist(args.cqm4, 16),
               cqm8i=_cqmlist(args.cqm8, 64),
               cqm8p=_cqmlist(args.cqm8, 64),
               direct={"none": 0, "spatial": 1, "temporal": 2,
                       "auto": 3}[args.direct],
               subpel=args.subme,
               trellis=args.trellis,
               ssim=args.ssim,
               psnr=not args.no_psnr,
               deblock_device=args.deblock_device,
               deblock_alpha=int(args.deblock_ab.replace(":", ",")
                                 .split(",")[0]),
               deblock_beta=int((args.deblock_ab.replace(":", ",")
                                 .split(",") + ["0"])[1]),
               noise_reduction=args.nr,
               chroma_qp_offset=args.chroma_qp_offset,
               aq_mode=args.aq_mode, aq_strength=args.aq_strength,
               zones=args.zones,
               bitrate=args.bitrate, crf=args.crf,
               vbv_maxrate=args.vbv_maxrate,
               vbv_bufsize=args.vbv_bufsize,
               rate_tolerance=args.ratetol,
               qp_min=args.qpmin, qp_max=args.qpmax,
               stat_out=args.stats if args.rc_pass == 1 else "",
               stat_in=args.stats if args.rc_pass == 2 else "",
               qpfile=args.qpfile,
               dct_decimate=not args.no_dct_decimate,
               cabac=args.cabac,
               partitions=not args.no_partitions,
               p4x4=args.p4x4,
               transform_8x8=args.dct8,
               rd=args.rd,
               stego=StegoParams(em_rate=args.emrate, key=args.key,
                                 em_file=args.emfile))
    p.sps_id = args.sps_id
    p.aud = args.aud
    p.chromaloc = args.chromaloc
    for key, val in (("fps", args.fps), ("sar", args.sar),
                     ("level", args.level), ("overscan", args.overscan),
                     ("videoformat", args.videoformat),
                     ("fullrange", args.fullrange),
                     ("colorprim", args.colorprim),
                     ("transfer", args.transfer),
                     ("colormatrix", args.colormatrix)):
        if val:
            param_parse(p, key, val)
    enc = Encoder(p)
    n = reader.num_frames - args.seek
    if args.frames:
        n = min(n, args.frames)

    t0 = time.time()
    mkv = None
    if args.output.endswith(".mkv"):
        from .utils.mkv import MkvWriter
        mkv = MkvWriter(args.output, p.width, p.height,
                        p.fps_num, p.fps_den)
    elif args.output.endswith(".mp4"):
        from .utils.mp4 import Mp4Writer
        mkv = Mp4Writer(args.output, p.width, p.height,
                        p.fps_num, p.fps_den)
    if args.dump_yuv:
        # recon gathered per display index (with --bframes the encoder
        # emits AUs in decode order; recon_by_disp restores display
        # order, and keep_recon materializes device-resident recon)
        enc.keep_recon = True

    def emit(aus, f):
        from .utils.visualize import overlay_frame, write_ppm
        for disp, chunk, kind in aus:
            if mkv is not None:
                mkv.add_frame(chunk, timecode_ms=int(
                    disp * 1000 * p.fps_den / p.fps_num))
            else:
                f.write(chunk)
            if args.visualize and kind in ("I", "P"):
                # overlays cover anchors (B MB metadata isn't recorded)
                info = enc.last_frame_info
                rgb = overlay_frame(
                    np.asarray(enc.recon_prev[0])[:p.height, :p.width],
                    info["kind"], info["part"], info["mv8"])
                write_ppm(f"{args.visualize}{disp:04d}.ppm", rgb)

    with open(args.output, "wb") if mkv is None else _null_ctx() as f:
        for i in range(n):
            frame = reader.read(args.seek + i)
            emit(enc.encode_frame_aus(frame), f)
            if (i + 1) % 10 == 0 or i + 1 == n:
                el = time.time() - t0
                print(f"\r[{i+1}/{n}] {(i+1)/el:.2f} fps", end="",
                      file=sys.stderr)
        emit(enc.flush_aus(), f)  # drain frames delayed for B reorder
    if mkv is not None:
        mkv.close()
    print(file=sys.stderr)
    if args.dump_yuv:
        recons = []
        for disp in sorted(enc.recon_by_disp):
            ry, ru, rv = enc.recon_by_disp[disp]
            recons.append(yuv.Frame(
                ry[:p.height, :p.width].astype(np.uint8),
                ru[:p.height // 2, :p.width // 2].astype(np.uint8),
                rv[:p.height // 2, :p.width // 2].astype(np.uint8)))
        yuv.write_y4m(args.dump_yuv, recons,
                      fps=(p.fps_num, p.fps_den))
    s = enc.close()
    if s.get("ssim_y"):
        print(f"SSIM Y:{s['ssim_y']:.5f}", file=sys.stderr)
    print(f"encoded {s['frames']} frames, {s['fps']:.2f} fps, "
          f"{s['kbps']:.1f} kb/s, PSNR Y:{s['psnr_y']:.2f} "
          f"U:{s['psnr_u']:.2f} V:{s['psnr_v']:.2f}")
    if p.stego.enabled:
        eff = s["message_bits"] / max(1, s["mv_flips"])
        print(f"stego: {s['mv_covers']} covers, {s['message_bits']} bits, "
              f"{s['mv_flips']} flips, efficiency {eff:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
