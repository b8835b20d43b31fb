"""RD comparison harness: bitrate + PSNR across QPs for two configs.

Evidence tool for the RD features (--rd 1/2, --trellis, --8x8dct,
--cqm, AQ): encodes the same sequence under config A and config B at a
QP ladder and reports per-QP (kbps, PSNR-Y) pairs plus a crude
BD-rate-style average bitrate delta at equal QP. Runs on any backend
(runs on the CPU: quality numbers are device-independent).

Usage:
  python tools/rdcompare.py --w 192 --h 128 --frames 8 \
      --qps 22,27,32,37 --a "rd=0" --b "rd=1,trellis=1,cabac=1"

Config strings are comma-separated param_parse key=value pairs
(params.py string keys, the x264 names).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

# quality numbers are device-independent: run on the CPU
jax.config.update("jax_platforms", "cpu")
from video_steganography_pcamv_tpu.utils.jaxcache import (  # noqa: E402
    setup_compile_cache)
setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)


def _make_params(w, h, qp, spec):
    from video_steganography_pcamv_tpu.params import Params, param_parse
    p = Params(width=w, height=h, qp=qp, me_range=8)
    for kv in filter(None, spec.split(",")):
        k, _, v = kv.partition("=")
        param_parse(p, k.strip(), v.strip() or "1")
    return p

def _psnr(a, b):
    import numpy as np
    d = a.astype(np.int64) - b.astype(np.int64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 * 255.0 / mse)


def run(w, h, n, qps, spec_a, spec_b, seed=7):
    import numpy as np
    from video_steganography_pcamv_tpu.utils.yuv import (
        synthetic_sequence)
    from video_steganography_pcamv_tpu.encoder.core import Encoder
    from video_steganography_pcamv_tpu.ops import cqm as Q

    frames = synthetic_sequence(w, h, n, seed=seed)
    rows = []
    for qp in qps:
        row = {"qp": qp}
        for tag, spec in (("a", spec_a), ("b", spec_b)):
            Q.set_cqm()   # configs may differ in CQM
            enc = Encoder(_make_params(w, h, qp, spec))
            enc.keep_recon = True
            bs = b"".join(enc.encode_frame(f) for f in frames)
            bs += enc.flush()
            ps = [_psnr(enc.recon_by_disp[i][0][:h, :w], f.y)
                  for i, f in enumerate(frames)]
            row[tag + "_kbps"] = 8 * len(bs) * 25.0 / n / 1000.0
            row[tag + "_psnr"] = sum(ps) / len(ps)
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=192)
    ap.add_argument("--h", type=int, default=128)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--a", default="rd=0", help="config A param string")
    ap.add_argument("--b", default="rd=1", help="config B param string")
    args = ap.parse_args()
    qps = [int(q) for q in args.qps.split(",")]
    rows = run(args.w, args.h, args.frames, qps, args.a, args.b)
    print(f"{'qp':>4} {'A kbps':>9} {'A psnrY':>8}"
          f" {'B kbps':>9} {'B psnrY':>8} {'bits%':>7} {'dPSNR':>7}")
    dsum = 0.0
    for r in rows:
        db = 100.0 * (r["b_kbps"] / r["a_kbps"] - 1.0)
        dp = r["b_psnr"] - r["a_psnr"]
        dsum += db
        print(f"{r['qp']:>4} {r['a_kbps']:>9.1f} {r['a_psnr']:>8.3f}"
              f" {r['b_kbps']:>9.1f} {r['b_psnr']:>8.3f}"
              f" {db:>6.1f}% {dp:>+7.3f}")
    print(f"mean bitrate delta at equal QP: {dsum / len(rows):+.1f}%"
          f"  (A: {args.a!r}  B: {args.b!r})")


if __name__ == "__main__":
    main()
