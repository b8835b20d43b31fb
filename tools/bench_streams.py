"""Single-chip multi-stream throughput: aggregate encode+embed fps at
S = 1, 2, 4 concurrent 1080p streams (BASELINE ladder rung 5 on one
chip; the driver is PipelinedMultiEncoder — per-stream fused stage-1
dispatches keep the device queue fed while the host writes the other
streams' entropy).

Needs a GPU. Prints the card, then one JSON line per S.

    python tools/bench_streams.py [--deep]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from video_steganography_pcamv_tpu.utils.jaxcache import (  # noqa: E402
    setup_compile_cache)
from video_steganography_pcamv_tpu.utils.device import (  # noqa: E402
    card_line, require_gpu)

setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
import numpy as np

from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.encoder.multistream import (
    PipelinedMultiEncoder)
from video_steganography_pcamv_tpu.stego.extract import extract_from_stream
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence


def run(S, width=1920, height=1088, n_measure=6, qp=26, em_rate=64.0,
        deep=False):
    p = Params(width=width, height=height, qp=qp, me_range=16,
               keyint_max=250, scenecut_threshold=0, psnr=False,
               deblock_device=True,
               stego=StegoParams(em_rate=em_rate, key=3))
    # deep pipeline per stream: speculates the next frame's analysis
    # so the device has work while each stream's packed pull waits
    p.pipeline_deep = deep
    p.validate()
    me = PipelinedMultiEncoder(p, S)
    streams = [synthetic_sequence(width, height, 4 + n_measure,
                                  seed=40 + s) for s in range(S)]
    chunks = [b"" for _ in range(S)]
    # warmup: IDR + 3 P frames (compiles + pipeline fill)
    for t in range(4):
        for s, c in enumerate(me.encode_step(
                [st[t] for st in streams])):
            chunks[s] += c
    t0 = time.time()
    for t in range(4, 4 + n_measure):
        for s, c in enumerate(me.encode_step(
                [st[t] for st in streams])):
            chunks[s] += c
    for s, c in enumerate(me.flush()):
        chunks[s] += c
    dt = time.time() - t0
    # payload must survive blind extraction on every stream
    for s in range(S):
        got = extract_from_stream(chunks[s], em_rate=em_rate, key=3)
        sent = me.encs[s]._stego.sent_messages
        assert len(got) == len(sent) and all(
            np.array_equal(g, m) for g, m in zip(got, sent)), \
            f"stream {s}: blind extraction mismatch"
    agg = S * n_measure / dt
    return {"metric": "multistream_agg_fps_1080p", "streams": S,
            "value": agg, "unit": "fps", "per_stream": agg / S,
            "device_kind": jax.devices()[0].device_kind}


def main():
    require_gpu()
    print(card_line(), flush=True)
    for S in (1, 2, 4):
        print(json.dumps(run(S, deep="--deep" in sys.argv)), flush=True)


if __name__ == "__main__":
    main()
