"""Matched-flag QP-ladder head-to-head vs the C reference binary.

VERDICT r2 task 3 / BASELINE.md north star: encode the SAME clip with
the SAME flags through the reference x264-b66 fork (built by
tools/build_reference.sh) and this encoder, across the BASELINE QP
ladder {22,27,32,37}, and report bitrate + PSNR side by side with the
PSNR delta judged against the <=0.05 dB target.

Matched configuration (each side's equivalent flags):
  * CAVLC (reference: --no-cabac), no B frames, keyint > clip length
    (one IDR then P), subme 2 on the reference (fullpel+qpel refine --
    the closest ladder rung to the repo's exhaustive fullpel + qpel
    box), deblock on, single reference frame.
  * Stego either off on both sides, or --emrate N on both sides.
PSNR is computed HERE (decode each .264 with the repo's verified
decoder and diff against the source YUV) so both sides are scored by
the same meter; the reference's self-reported PSNR is also captured.

Usage:
  python tools/headtohead.py [--frames 30] [--qps 22,27,32,37]
                             [--size 352x288] [--emrate 0]
                             [--markdown docs/RESULTS.md]
Writes a markdown table to stdout (and optionally appends to a doc).

On a 1-core box a 30-frame CIF run takes tens of minutes on the repo
side (CPU backend); use --frames 10 --size 192x160 for a smoke run.
"""

import argparse
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# quality numbers are device-independent: run on the CPU
import jax
jax.config.update("jax_platforms", "cpu")
from video_steganography_pcamv_tpu.utils.jaxcache import (  # noqa: E402
    setup_compile_cache)
setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

import numpy as np


def synth_clip(n, w, h, seed=11):
    """Moving smoothed-noise clip with global pan + local jitter —
    the same flavour as the conformance fixtures (enough detail for
    nonzero residual at QP 22, enough coherence for real P frames)."""
    rng = np.random.RandomState(seed)
    pad = 4 * n + 32
    a = rng.randint(16, 240, (h + 2 * pad, w + 2 * pad)).astype(np.uint8)
    for _ in range(2):
        a = ((a.astype(np.int32) + np.roll(a, 1, 0) + np.roll(a, 1, 1)
              + np.roll(np.roll(a, 1, 0), 1, 1)) // 4).astype(np.uint8)
    ys, us, vs = [], [], []
    for i in range(n):
        y = a[pad + 2 * i:pad + 2 * i + h, pad + 3 * i:pad + 3 * i + w]
        y = np.clip(y.astype(np.int32)
                    + (rng.randn(h, w) * 2).astype(np.int32),
                    0, 255).astype(np.uint8)
        u = np.clip(110 + (y[::2, ::2].astype(np.int32) - 128) // 4,
                    0, 255).astype(np.uint8)
        v = np.clip(140 - (y[::2, ::2].astype(np.int32) - 128) // 4,
                    0, 255).astype(np.uint8)
        ys.append(y); us.append(u); vs.append(v)
    return ys, us, vs


def write_yuv(path, ys, us, vs):
    with open(path, "wb") as fh:
        for y, u, v in zip(ys, us, vs):
            fh.write(y.tobytes()); fh.write(u.tobytes()); fh.write(v.tobytes())


def psnr(mse):
    if mse == 0:
        return float("inf")
    return 10 * np.log10(255.0 * 255.0 / mse)


def score(decoded, ys, us, vs):
    """Global PSNR per plane over the clip (x264 'Global' convention:
    PSNR of the mean SSD)."""
    sy = su = sv = 0.0
    npx_y = npx_c = 0
    for d, y, u, v in zip(decoded, ys, us, vs):
        sy += float(np.sum((d.y.astype(np.int64)[:y.shape[0], :y.shape[1]]
                            - y) ** 2))
        su += float(np.sum((d.u.astype(np.int64)[:u.shape[0], :u.shape[1]]
                            - u) ** 2))
        sv += float(np.sum((d.v.astype(np.int64)[:v.shape[0], :v.shape[1]]
                            - v) ** 2))
        npx_y += y.size; npx_c += u.size
    return (psnr(sy / npx_y), psnr(su / npx_c), psnr(sv / npx_c))


# matched-flag presets per BASELINE config ladder rung:
#   cavlc: rung 1/2 (IPPP CAVLC single-ref; the round-3 ladder)
#   c3:    rung 3 (720p, 8x8 transform + RD; reference --subme 6 is
#          its first RD rung, ours is --rd 1 + exhaustive fullpel)
#   c4:    rung 4 (1080p CABAC + B-frames + 2-ref ME)
REF_FLAGS = {
    "cavlc": ["--no-cabac", "--subme", "2", "--ref", "1",
              "--bframes", "0"],
    "c3": ["--no-cabac", "--subme", "6", "--ref", "1",
           "--bframes", "0", "--8x8dct"],
    # CABAC is the reference default (only --no-cabac exists);
    # --no-b-adapt pins the fixed B placement our b_adapt=0 matches
    "c4": ["--subme", "2", "--ref", "2", "--bframes", "2",
           "--no-b-adapt"],
}


def run_reference(x264, yuv, wh, qp, frames, emrate, out,
                  config="cavlc"):
    cmd = [x264, "--qp", str(qp), "--frames", str(frames),
           "--keyint", "250", "--min-keyint", "25",
           "--scenecut", "0"] + REF_FLAGS[config]
    if emrate:
        cmd += ["--emrate", str(emrate)]
    cmd += ["-o", out, yuv, wh]
    t0 = time.time()
    # the reference's log strings are GBK-encoded Chinese: decode
    # permissively
    r = subprocess.run(cmd, capture_output=True)
    dt = time.time() - t0
    r = type(r)(r.args, r.returncode,
                r.stdout.decode("utf-8", "replace"),
                r.stderr.decode("utf-8", "replace"))
    if r.returncode != 0:
        raise RuntimeError(f"reference failed: {r.stderr[-400:]}")
    size = os.path.getsize(out)
    return size, dt, r.stderr + r.stdout


REPO_KW = {
    "cavlc": {},
    "c3": dict(transform_8x8=True, rd=1),
    "c4": dict(cabac=True, ref_frames=2, bframes=2, b_adapt=0),
}


def run_repo(w, h, qp, frames_yuv, emrate, config="cavlc"):
    from video_steganography_pcamv_tpu.params import Params, StegoParams
    from video_steganography_pcamv_tpu.encoder.core import Encoder
    from video_steganography_pcamv_tpu.utils.yuv import Frame
    ys, us, vs = frames_yuv
    kw = dict(width=w, height=h, qp=qp, me_range=16,
              scenecut_threshold=0, keyint_max=250, **REPO_KW[config])
    if emrate:
        kw["stego"] = StegoParams(em_rate=float(emrate), key=17)
    p = Params(**kw)
    p.validate()
    enc = Encoder(p)
    t0 = time.time()
    bs = b"".join(enc.encode_frame(Frame(y, u, v))
                  for y, u, v in zip(ys, us, vs))
    bs += enc.flush()
    dt = time.time() - t0
    return bs, dt, enc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--size", default="352x288")
    ap.add_argument("--emrate", type=float, default=0.0)
    ap.add_argument("--x264", default="/tmp/refbuild/x264")
    ap.add_argument("--workdir", default="/tmp/h2h")
    ap.add_argument("--config", default="cavlc",
                    choices=("cavlc", "c3", "c4"),
                    help="matched-flag preset (BASELINE ladder rung)")
    args = ap.parse_args()

    w, h = map(int, args.size.split("x"))
    qps = [int(q) for q in args.qps.split(",")]
    os.makedirs(args.workdir, exist_ok=True)
    if not os.path.exists(args.x264):
        subprocess.run(["bash", os.path.join(os.path.dirname(__file__),
                                             "build_reference.sh")],
                       check=True)

    ys, us, vs = synth_clip(args.frames, w, h)
    yuv = os.path.join(args.workdir, "clip.yuv")
    write_yuv(yuv, ys, us, vs)

    from video_steganography_pcamv_tpu.decoder import decode_annexb
    fps_den = args.frames  # bitrate at 25 fps convention
    rows = []
    for qp in qps:
        ref264 = os.path.join(args.workdir, f"ref_q{qp}.264")
        rsize, rdt, rlog = run_reference(args.x264, yuv, args.size, qp,
                                         args.frames, args.emrate,
                                         ref264, config=args.config)
        rdec = decode_annexb(open(ref264, "rb").read())
        rpy, rpu, rpv = score(rdec, ys, us, vs)
        rkbps = rsize * 8 * 25 / fps_den / 1000.0
        rbits = ""
        # the reference's stego summary prints the embedded payload as
        # "<x> Kbits" (encoder.c:2884 i_message_num / 1000; the label
        # text is GBK-encoded Chinese)
        m = re.findall(r"([0-9.]+)\s*Kbits", rlog)
        if m:
            rbits = int(float(m[-1]) * 1000)

        bs, mdt, enc = run_repo(w, h, qp, (ys, us, vs), args.emrate,
                                config=args.config)
        open(os.path.join(args.workdir, f"repo_q{qp}.264"), "wb").write(bs)
        mdec = decode_annexb(bs)
        mpy, mpu, mpv = score(mdec, ys, us, vs)
        mkbps = len(bs) * 8 * 25 / fps_den / 1000.0
        mbits = ""
        if args.emrate:
            mbits = int(enc.stats.message_bits)
            # capacity claims must survive the blind round trip
            from video_steganography_pcamv_tpu.stego.extract import \
                extract_from_stream
            got = extract_from_stream(bs, em_rate=float(args.emrate),
                                      key=17)
            sent = enc._stego.sent_messages
            assert len(got) == len(sent) and all(
                np.array_equal(g, s) for g, s in zip(got, sent)), \
                f"blind extract mismatch at qp{qp}"

        rows.append((qp, rkbps, rpy, rpu, rpv, rbits,
                     mkbps, mpy, mpu, mpv, mbits))
        print(f"qp{qp}: ref {rkbps:.1f} kbps Y{rpy:.3f} bits={rbits} | "
              f"repo {mkbps:.1f} kbps Y{mpy:.3f} bits={mbits} | "
              f"dY {mpy - rpy:+.3f} "
              f"(ref {rdt:.1f}s, repo {mdt:.1f}s)", flush=True)

    print()
    print("| qp | ref kbps | ref PSNR-Y | ref U | ref V | ref bits | "
          "repo kbps | repo PSNR-Y | repo U | repo V | repo bits | "
          "dY (dB) |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for (qp, rk, ry, ru, rv, rb, mk, my_, mu, mv, mb) in rows:
        print(f"| {qp} | {rk:.1f} | {ry:.3f} | {ru:.3f} | {rv:.3f} | "
              f"{rb} | {mk:.1f} | {my_:.3f} | {mu:.3f} | {mv:.3f} | "
              f"{mb} | {my_ - ry:+.3f} |")


if __name__ == "__main__":
    main()
