"""1080p encode+embed throughput on one GPU.

    python bench.py [--frames N] [--reps R]

Runs the serving configuration (1920x1088 IPPP, CAVLC, CQP 26, me_range
16, quarter-pel, partitions, 64 bits/frame embedded with a fixed key,
reference deblocked on the device, metrics off) through `Encoder` in
this one process, then blind-extracts the payload from the stream.
Refuses to run without a GPU. Prints the card's name and power limit,
then ONE JSON line:

  {"metric": ..., "value": fps, "unit": "fps", "vs_baseline": fps/30,
   "device": {"platform", "kind", "count"}}

Baseline: BASELINE.json north star = 30 fps per card, 1080p
encode+embed. The metric name gains `_PAYLOAD_LOSS` when extraction
does not return every embedded bit.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

METRIC = "encode_embed_fps_1080p"


def run(width=1920, height=1088, n_measure=8, qp=26, em_rate=64.0,
        n_reps=3, verify=True):
    """Median encode+embed fps over n_reps blocks of n_measure P frames,
    and whether blind extraction recovered every embedded bit (None
    when verify is off: the repo decoder takes seconds per 1080p
    frame)."""
    import numpy as np
    from video_steganography_pcamv_tpu.params import Params, StegoParams
    from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence
    from video_steganography_pcamv_tpu.encoder.core import Encoder
    from video_steganography_pcamv_tpu.stego.extract import (
        extract_from_stream)

    # distinct moving-content frames: every measured encode sees new
    # pixels
    n_content = min(n_measure, 8)
    frames = synthetic_sequence(width, height, 2 + n_content, seed=7)
    p = Params(width=width, height=height, qp=qp, me_range=16,
               deblock_device=True, psnr=False,
               stego=StegoParams(em_rate=em_rate, key=99))
    enc = Encoder(p)

    # warmup / compile: I frame + first P frame
    bs = enc.encode_frame(frames[0])
    bs += enc.encode_frame(frames[1])

    reps = []
    for _ in range(n_reps):
        t0 = time.time()
        for i in range(n_measure):
            bs += enc.encode_frame(frames[2 + (i % n_content)])
        reps.append(n_measure / (time.time() - t0))
    bs += enc.flush()   # pipelined driver: drain the deferred entropy
    fps = float(np.median(reps))
    sys.stderr.write("[bench] per-rep fps: %s -> median %.4f\n"
                     % (["%.4f" % r for r in reps], fps))

    if not verify:
        return fps, None
    got = extract_from_stream(bs, em_rate=em_rate, key=99)
    sent = enc._stego.sent_messages
    recovered = (len(got) == len(sent)
                 and all(np.array_equal(g, s) for g, s in zip(got, sent)))
    return fps, recovered


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8,
                    help="P frames per measured repetition")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from video_steganography_pcamv_tpu.utils.jaxcache import (
        setup_compile_cache)
    from video_steganography_pcamv_tpu.utils.device import (
        card_line, device_record, require_gpu)
    setup_compile_cache()
    require_gpu()
    print(card_line(), flush=True)
    fps, recovered = run(n_measure=args.frames, n_reps=args.reps)
    print(json.dumps({
        "metric": METRIC if recovered else METRIC + "_PAYLOAD_LOSS",
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / 30.0,
        "device": device_record(),
    }))
    return 0 if recovered else 1


if __name__ == "__main__":
    sys.exit(main())
