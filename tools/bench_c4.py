"""Config-4 serving measurement (VERDICT r4 item 8): 1080p
CABAC + B-frames + 2-ref + stego, the BASELINE ladder rung 4 shape —
what does the non-IPP pipeline actually serve at on one card?

Prints the card, then one JSON line. Needs a GPU.
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
from video_steganography_pcamv_tpu.encoder.core import Encoder
from video_steganography_pcamv_tpu.stego.extract import extract_from_stream
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence


def main(width=1920, height=1088, n_measure=8, qp=26, em_rate=64.0):
    require_gpu()
    print(card_line(), flush=True)
    p = Params(width=width, height=height, qp=qp, me_range=16,
               cabac=True, bframes=2, b_adapt=0, ref_frames=2,
               psnr=False, deblock_device=True,
               stego=StegoParams(em_rate=em_rate, key=5))
    p.validate()
    enc = Encoder(p)
    frames = synthetic_sequence(width, height, 5 + n_measure, seed=9)
    bs = b""
    for f in frames[:5]:          # warmup/compile incl. B chain
        bs += enc.encode_frame(f)
    t0 = time.time()
    for f in frames[5:5 + n_measure]:
        bs += enc.encode_frame(f)
    bs += enc.flush()
    dt = time.time() - t0
    fps = n_measure / dt
    got = extract_from_stream(bs, em_rate=em_rate, key=5)
    sent = enc._stego.sent_messages
    ok = (len(got) == len(sent)
          and all(np.array_equal(g, m) for g, m in zip(got, sent)))
    print(json.dumps({
        "metric": "encode_embed_fps_1080p_c4_cabac_b2_ref2",
        "value": fps,
        "unit": "fps",
        "payload_recovered": bool(ok),
        "device_kind": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main(*[int(x) for x in sys.argv[1:]])
