"""End-to-end A/B of the full-pel stage on the GPU: the 1080p serving
encode (as bench.py runs it) with the Pallas full-pel kernel and with
the plain `lax.scan` reference in its place, in turns (kernel, plain,
plain, kernel) in one process on one card.

    python tools/fullpel_ab.py [--frames 16]

Prints the card, then one line per run: which full-pel stage and fps
(payload extraction is skipped: bench.py and chip_smoke.py check it). The swap rebinds
`ops.fullpel.fullpel_parts` and drops JAX's in-memory caches, so each
run traces its own programs (the persistent compile cache keeps the
second compile of each variant short).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()

    import jax
    from video_steganography_pcamv_tpu.utils.jaxcache import (
        setup_compile_cache)
    from video_steganography_pcamv_tpu.utils.device import (
        card_line, require_gpu)
    setup_compile_cache()
    require_gpu()
    print(card_line(), flush=True)

    import bench
    from video_steganography_pcamv_tpu.ops import fullpel as FP
    from video_steganography_pcamv_tpu.encoder.partition import (
        fullpel_search_parts)
    kernel = FP.fullpel_parts

    def plain(cur_y, ref_fp, pred_mv_fp, rng, mbh, mbw, lam=1):
        return fullpel_search_parts.__wrapped__(
            cur_y, ref_fp, pred_mv_fp, rng, mbh, mbw, lam)

    for name in ("kernel", "plain", "plain", "kernel"):
        FP.fullpel_parts = kernel if name == "kernel" else plain
        jax.clear_caches()
        fps, _ = bench.run(n_measure=args.frames, n_reps=1, verify=False)
        print(f"full-pel {name}: {fps:.4f} fps", flush=True)
    FP.fullpel_parts = kernel


if __name__ == "__main__":
    main()
