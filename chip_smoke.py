#!/usr/bin/env python3
"""Smoke test of the stego encoder on an NVIDIA GPU.

    python3 chip_smoke.py             # phases 1-4 on one card
    python3 chip_smoke.py --cards 4   # the multi-card path only

Phases (one process; a phase that fails stops the run, exit != 0):

1. Device and host: a GPU is required (no CPU fallback); prints the
   card, JAX version, XLA_FLAGS, and builds the native host library.
2. Kernels against their plain reference at 1080p, exact: the Pallas
   full-pel search against `fullpel_search_parts`, the device deblock
   twin against the host C++ filter. Prints the median time of each.
3. Main path: a seeded synthetic 1920x1088 clip encoded through the
   CLI with a 64 bits/frame payload; prints fps, compile time and
   memory. Blind extraction (the CLI's --extract) and the repo decoder
   run on the CPU in worker processes meanwhile, and are checked after
   phase 4: every embedded bit back, every frame decoded.
4. GPU against CPU: one seeded CIF clip encoded on the card and on the
   CPU in this process; the two streams must be byte-identical.

With `--cards 4` only the multi-card path runs: four 1080p streams
through `parallel.mesh.build_multi_encoder` on a 4-card mesh, each
stream checked against the same stream encoded alone on one card, and
the 4-way MB-row tiled P step checked against the single-card step.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SERVING_FLAGS = ["--qp", "26", "--merange", "16", "--emrate", "64",
                 "--key", "7", "--no-psnr", "--deblock-device"]


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def phase(name):
    log(f"== {name}")
    t0 = time.time()
    yield
    log(f"== {name}: ok ({time.time() - t0:.1f} s)")


def _cpu_only():
    os.environ["JAX_PLATFORMS"] = "cpu"


def _host_pool(n):
    """Worker processes for the pure-Python decoder (seconds per 1080p
    frame). Spawned and pinned to the CPU, so they never touch the
    card."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        n, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_only)


def _extract(data, em_rate, key):
    from video_steganography_pcamv_tpu.stego.extract import (
        extract_from_stream)
    return extract_from_stream(data, em_rate=em_rate, key=key)


def _n_decoded(data):
    from video_steganography_pcamv_tpu.decoder import decode_annexb
    return len(decode_annexb(data))


def median_ms(fn, *args, reps=5):
    """Median wall time of fn(*args) to completion, after one warm-up
    call. Returns (result, ms)."""
    import jax
    import numpy as np
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts)) * 1e3


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def check_device_and_host():
    import jax
    from video_steganography_pcamv_tpu import native
    from video_steganography_pcamv_tpu.utils.device import (
        card_line, require_gpu)
    from video_steganography_pcamv_tpu.utils.jaxcache import cache_dir
    dev = require_gpu()
    log(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
        f"devices {len(jax.devices())}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache: {cache_dir()}")
    log(card_line())     # as nvidia-smi prints name,power.limit
    t0 = time.time()
    if native.load() is None:
        raise RuntimeError(f"native library build failed:\n"
                           f"{native.build_error}")
    log(f"native library loaded ({time.time() - t0:.1f} s incl. build)")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _clip(width, height, n, seed):
    from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence
    return synthetic_sequence(width, height, n, seed=seed)


def check_fullpel_kernel(mbh=68, mbw=120, rng=16, interpret=False):
    """The Pallas full-pel kernel against fullpel_search_parts on real
    content with non-zero predictors: all eight outputs exact."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from video_steganography_pcamv_tpu.encoder import me as ME
    from video_steganography_pcamv_tpu.encoder.partition import (
        fullpel_search_parts)
    from video_steganography_pcamv_tpu.ops import fullpel as FP
    from video_steganography_pcamv_tpu.ops import mc

    fr = _clip(16 * mbw, 16 * mbh, 2, seed=3)
    cur = jnp.asarray(fr[1].y, jnp.int32)
    ref = mc.pad_plane(jnp.asarray(fr[0].y, jnp.int32))
    r = np.random.RandomState(1)
    pred = jnp.asarray(r.randint(-4 * rng, 4 * rng + 1, (mbh, mbw, 2))
                       >> 2, jnp.int32)
    lam = ME.lambda_tab(26)
    kern = jax.jit(lambda c, p, q: FP.fullpel_parts_kernel(
        c, p, q, rng, mbh, mbw, lam, interpret=interpret))
    plain = jax.jit(lambda c, p, q: fullpel_search_parts(
        c, p, q, rng, mbh, mbw, lam))
    got, t_k = median_ms(kern, cur, ref, pred)
    want, t_p = median_ms(plain, cur, ref, pred)
    for k in want:
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            raise AssertionError(f"full-pel kernel differs at {k}")
    log(f"full-pel {16 * mbw}x{16 * mbh} rng {rng}: Pallas kernel "
        f"{t_k:.3f} ms, plain scan {t_p:.3f} ms, exact (8 outputs)")
    return t_k, t_p


def check_deblock(mbh=68, mbw=120):
    """The device deblock twin against the host C++ filter on one frame
    of decision fields; the host time includes pulling the recon and
    pushing the filtered planes back, as the encoder's host path does."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from video_steganography_pcamv_tpu import native
    from video_steganography_pcamv_tpu.ops.deblock_jax import (
        deblock_frame_device)
    from video_steganography_pcamv_tpu.ops.transform import chroma_qp

    r = np.random.RandomState(5)
    fr = _clip(16 * mbw, 16 * mbh, 1, seed=4)[0]
    # low-amplitude copies so the filter's gates open on most edges
    y = ((fr.y.astype(np.int32) // 8) + 110).astype(np.uint8)
    u = ((fr.u.astype(np.int32) // 8) + 110).astype(np.uint8)
    v = ((fr.v.astype(np.int32) // 8) + 110).astype(np.uint8)
    intra = (r.rand(mbh, mbw) < 0.1).astype(np.uint8)
    skip = ((r.rand(mbh, mbw) < 0.3) & (intra == 0)).astype(np.uint8)
    nnz4 = ((r.rand(4 * mbh, 4 * mbw) < 0.4)
            * r.randint(1, 5, (4 * mbh, 4 * mbw))).astype(np.int32)
    mv4 = np.repeat(np.repeat(r.randint(-20, 21, (2 * mbh, 2 * mbw, 2)),
                              2, 0), 2, 1).astype(np.int32)
    qp = 26
    qpc = chroma_qp(qp)
    dev_in = [jnp.asarray(a, jnp.int32)
              for a in (y, u, v, intra, skip, nnz4, mv4)]
    (dy, du, dv), t_dev = median_ms(
        lambda *a: deblock_frame_device(*a, qp, qpc, mbh, mbw), *dev_in)

    def host(yd, ud, vd):
        ry, ru, rv = (np.asarray(p).astype(np.uint8) for p in (yd, ud, vd))
        native.deblock_frame(ry, ru, rv, intra, nnz4, mv4, skip, qp, qpc)
        return tuple(jnp.asarray(p) for p in (ry, ru, rv))

    (hy, hu, hv), t_host = median_ms(host, *dev_in[:3])
    for a, b, name in ((dy, hy, "Y"), (du, hu, "U"), (dv, hv, "V")):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"device deblock differs from C++ ({name})")
    log(f"deblock {16 * mbw}x{16 * mbh}: device twin {t_dev:.3f} ms, "
        f"host C++ incl. transfers {t_host:.3f} ms, exact")
    return t_dev, t_host


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _write_clip(path, width, height, n, seed):
    from video_steganography_pcamv_tpu.utils.yuv import write_y4m
    write_y4m(path, _clip(width, height, n, seed))


def _payload(path, n_bits, seed):
    import numpy as np
    bits = np.random.RandomState(seed).randint(0, 2, n_bits)
    np.packbits(bits.astype(np.uint8)).tofile(path)
    return bits


def _cli(argv):
    from video_steganography_pcamv_tpu import cli
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(argv)
    if rc not in (0, None):
        raise RuntimeError(f"cli {argv[:3]}... exited {rc}")


def main_path(workdir, pool, width=1920, height=1088, n_frames=10,
              fps_frames=16):
    """CLI encode at full width; then the steady-state rate through
    Encoder in this process (programs already compiled) and the fused
    stage-1 program's memory analysis. Blind extraction (the CLI's
    --extract) and the decode run on the CPU in `pool` meanwhile;
    the returned function waits for them and checks every bit."""
    import jax
    import numpy as np

    clip = os.path.join(workdir, "clip.y4m")
    stream = os.path.join(workdir, "clip.264")
    pay = os.path.join(workdir, "payload.bin")
    got_path = os.path.join(workdir, "extracted.bin")
    _write_clip(clip, width, height, n_frames, seed=11)
    sent = _payload(pay, 64 * n_frames, seed=12)

    t0 = time.time()
    _cli([clip, "-o", stream, "--emfile", pay] + SERVING_FLAGS)
    t_cold = time.time() - t0
    data = open(stream, "rb").read()
    n_dec = pool.submit(_n_decoded, data)
    extracted = pool.submit(_cli, [stream, "--extract", "--emrate", "64",
                                   "--key", "7", "-o", got_path,
                                   "--device", "cpu"])
    log(f"CLI {width}x{height}: {n_frames} frames in {t_cold:.1f} s "
        f"(cold, incl. compile), {len(data)} bytes")

    fps, enc = encode_rate(width, height, fps_frames)
    t_compile = t_cold - n_frames / fps
    log(f"steady state: {fps:.3f} fps (Encoder, {fps_frames} P frames); "
        f"cold compile ~{t_compile:.1f} s")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    log(f"p_stage1_stego memory_analysis: {stage1_memory(enc)}")

    def check_payload_and_decode():
        extracted.result()
        got = np.unpackbits(np.fromfile(got_path, np.uint8))
        n_embedded = 64 * (n_frames - 1)  # every P frame carries 64 bits
        if got.size < n_embedded or not np.array_equal(
                got[:n_embedded], sent[:n_embedded]):
            n_ok = int(np.sum(got[:n_embedded] == sent[:got.size]
                              [:n_embedded]))
            raise AssertionError(f"payload: recovered {got.size} bits, "
                                 f"{n_ok} of {n_embedded} correct")
        if n_dec.result() != n_frames:
            raise AssertionError(f"decoded {n_dec.result()} of "
                                 f"{n_frames} frames")
        log(f"CLI {width}x{height}: payload {n_embedded}/{n_embedded} "
            f"bits recovered by blind extraction, {n_frames} frames "
            f"decode")

    return check_payload_and_decode


def _serving_params(width, height):
    from video_steganography_pcamv_tpu.params import Params, StegoParams
    return Params(width=width, height=height, qp=26, me_range=16,
                  deblock_device=True, psnr=False,
                  stego=StegoParams(em_rate=64.0, key=7))


def encode_rate(width, height, n_frames):
    """Steady-state encode+embed rate: I + one P to warm up, then
    n_frames P frames timed (flush included)."""
    from video_steganography_pcamv_tpu.encoder.core import Encoder
    frames = _clip(width, height, 8, seed=13)
    enc = Encoder(_serving_params(width, height))
    enc.encode_frame(frames[0])
    enc.encode_frame(frames[1])
    t0 = time.time()
    for i in range(n_frames):
        enc.encode_frame(frames[2 + i % 6])
    enc.flush()
    return n_frames / (time.time() - t0), enc


def stage1_memory(enc):
    """memory_analysis() of the fused stage-1 program at the encoder's
    shapes (compiled already; this lowers it again to ask)."""
    import jax.numpy as jnp
    import numpy as np
    from video_steganography_pcamv_tpu.encoder import me as ME
    from video_steganography_pcamv_tpu.encoder import partition as PT
    from video_steganography_pcamv_tpu.ops.transform import chroma_qp
    from video_steganography_pcamv_tpu.utils.yuv import Frame
    p = enc.p
    y, u, v = enc._pad(Frame(
        np.zeros((p.height, p.width), np.uint8),
        np.zeros((p.height // 2, p.width // 2), np.uint8),
        np.zeros((p.height // 2, p.width // 2), np.uint8)))
    qp, lam = 26, ME.lambda_tab(26)
    ref = enc.ref
    compiled = PT.p_stage1_stego.lower(
        y, u, v, ref["luma"], ref["u"], ref["v"],
        jnp.asarray(enc.prev_mv), qp, chroma_qp(qp), lam,
        enc._cost_mv_dev(qp, lam), p.me_range, p.mb_height, p.mb_width,
        p.subpel, p.dct_decimate, False, nr_offset=None,
        extra=jnp.zeros(2, jnp.int32), full_pass1=True).compile()
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def gpu_vs_cpu(workdir, width=352, height=288, n_frames=5):
    """Encode one seeded clip with the serving flags on the card and on
    the CPU, in this process; the streams must be byte-identical."""
    import jax
    clip = os.path.join(workdir, "cif.y4m")
    _write_clip(clip, width, height, n_frames, seed=21)
    out = {}
    for name, dev in (("gpu", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        path = os.path.join(workdir, f"cif_{name}.264")
        with jax.default_device(dev):
            _cli([clip, "-o", path] + SERVING_FLAGS)
        out[name] = open(path, "rb").read()
    if out["gpu"] != out["cpu"]:
        stage = first_differing_stage(width, height)
        raise AssertionError(
            f"GPU and CPU streams differ ({len(out['gpu'])} vs "
            f"{len(out['cpu'])} bytes); first differing stage: {stage}")
    log(f"GPU vs CPU {width}x{height} x{n_frames}: streams "
        f"byte-identical ({len(out['gpu'])} bytes)")


def first_differing_stage(width, height):
    """Run the first P frame's device stages on both backends with the
    same inputs and name the first output that differs."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from video_steganography_pcamv_tpu.encoder import me as ME
    from video_steganography_pcamv_tpu.encoder import partition as PT
    from video_steganography_pcamv_tpu.ops import fullpel as FP
    from video_steganography_pcamv_tpu.ops import mc
    from video_steganography_pcamv_tpu.ops.transform import chroma_qp
    from video_steganography_pcamv_tpu.stego.cost import cost_mv_table

    fr = _clip(width, height, 2, seed=21)
    mbh, mbw = height // 16, width // 16
    qp, lam = 26, ME.lambda_tab(26)

    def stages():
        y, u, v = (jnp.asarray(p, jnp.int32)
                   for p in (fr[1].y, fr[1].u, fr[1].v))
        ref = mc.build_ref(*(jnp.asarray(p, jnp.int32)
                             for p in (fr[0].y, fr[0].u, fr[0].v)))
        pm = jnp.zeros((mbh, mbw, 2), jnp.int32)
        st = jax.jit(FP.fullpel_parts, static_argnums=(3, 4, 5))(
            y, ref["luma"][0], pm, 16, mbh, mbw, lam)
        an = PT.analyse_p_frame_parts(y, ref["luma"], pm, 16, mbh, mbw,
                                      lam, 2)
        packed = PT.p_stage1_stego(
            y, u, v, ref["luma"], ref["u"], ref["v"], pm, qp,
            chroma_qp(qp), lam, jnp.asarray(cost_mv_table(lam)), 16, mbh,
            mbw, 2, True, False)[0]
        out = [("fullpel." + k, st[k]) for k in sorted(st)]
        out += [(f"analyse_p_frame_parts[{i}]", a) for i, a in enumerate(an)]
        return out + [("p_stage1_stego.packed", packed)]

    a = stages()
    with jax.default_device(jax.devices("cpu")[0]):
        b = stages()
    for (name, x), (_, z) in zip(a, b):
        if not np.array_equal(np.asarray(x), np.asarray(z)):
            return name
    return "none of the stage-1 outputs (host stages or later)"


# ---------------------------------------------------------------------------
# --cards N
# ---------------------------------------------------------------------------

def multi_card(n_cards, width=1920, height=1088, n_frames=2):
    """Four streams on a 4-card mesh, each against its lone single-card
    encode; then the MB-row tiled P step against the single-card step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from video_steganography_pcamv_tpu.encoder.multistream import (
        MultiEncoder)
    from video_steganography_pcamv_tpu.models import pipeline as PL
    from video_steganography_pcamv_tpu.ops import mc
    from video_steganography_pcamv_tpu.parallel import tile as TL
    from video_steganography_pcamv_tpu.parallel.mesh import (
        build_mesh, build_multi_encoder)

    if len(jax.devices()) < n_cards:
        raise RuntimeError(f"need {n_cards} cards, JAX sees "
                           f"{len(jax.devices())}")
    seqs = [_clip(width, height, n_frames, seed=30 + s)
            for s in range(n_cards)]
    mesh = build_mesh(n_cards)
    menc = build_multi_encoder(_serving_params(width, height), mesh)
    multi = [b""] * n_cards
    t0 = time.time()
    for t in range(n_frames):
        chunks = menc.encode_step([seqs[s][t] for s in range(n_cards)])
        multi = [m + c for m, c in zip(multi, chunks)]
    log(f"{n_cards} streams x {n_frames} frames on the mesh: "
        f"{time.time() - t0:.1f} s (incl. compile)")
    refs = menc._refs
    log("stacked references: " + ", ".join(
        f"{k} on {sorted(d.id for d in refs[k].sharding.device_set)}"
        for k in ("luma", "u", "v")))
    log("per-stream encoder references (I frames, lookahead): " + ", ".join(
        f"stream {s} on {sorted(d.id for d in e.ref['luma'].sharding.device_set)}"
        for s, e in enumerate(menc.encs)))
    for i, d in enumerate(jax.devices()[:n_cards]):
        st = d.memory_stats() or {}
        log(f"card {i}: peak_bytes_in_use {st.get('peak_bytes_in_use')}")
    pool = _host_pool(n_cards)      # extraction overlaps the lone encodes
    got = [pool.submit(_extract, m, 64.0, 7) for m in multi]
    t0 = time.time()
    with jax.default_device(jax.devices()[0]):
        for s in range(n_cards):
            lone = MultiEncoder(_serving_params(width, height), 1)
            single = b"".join(lone.encode_step([f])[0] for f in seqs[s])
            if single != multi[s]:
                raise AssertionError(f"stream {s}: mesh encode differs "
                                     f"from its single-card encode")
    log(f"lone single-card encodes: {time.time() - t0:.1f} s "
        f"(incl. compile)")
    for s in range(n_cards):
        sent = menc.encs[s]._stego.sent_messages
        g = got[s].result()
        if len(g) != len(sent) or not all(
                np.array_equal(a, m) for a, m in zip(g, sent)):
            raise AssertionError(f"stream {s}: payload not recovered")
    pool.shutdown()
    log(f"{n_cards} streams byte-identical to their single-card "
        f"encodes; every payload recovered")

    mbh, mbw = height // 16, width // 16
    fr = _clip(width, height, 2, seed=40)
    planes = [np.asarray(p, np.int32) for p in
              (fr[1].y, fr[1].u, fr[1].v, fr[0].y, fr[0].u, fr[0].v)]
    zero_mv = np.zeros((mbh, mbw, 2), np.int32)
    tmesh = build_mesh(n_cards, axis="tile")
    kw = dict(qp=26, qpc=26, mbh=mbh, mbw=mbw, rng=16, lam=4)
    out_t = TL.p_frame_step_tiled(tmesh, *planes, zero_mv, **kw)
    with jax.default_device(jax.devices()[0]):
        ref = mc.build_ref(*(jnp.asarray(p) for p in planes[3:]))
        out_s = PL.p_frame_step_parts(
            *(jnp.asarray(p) for p in planes[:3]), ref["luma"], ref["u"],
            ref["v"], jnp.asarray(zero_mv), **kw)
    for k in out_s:
        if not np.array_equal(np.asarray(out_s[k]), np.asarray(out_t[k])):
            raise AssertionError(f"tiled step differs at {k}")
    log(f"{n_cards}-way tiled P step at {width}x{height}: bit-exact vs "
        f"the single-card step ({len(out_s)} outputs)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card path")
    args = ap.parse_args(argv)

    from video_steganography_pcamv_tpu.utils.jaxcache import (
        setup_compile_cache)
    from video_steganography_pcamv_tpu.utils.device import device_record
    setup_compile_cache()
    with phase("1 device and host"):
        check_device_and_host()
    if args.cards > 1:
        with phase(f"5 multi-card ({args.cards})"):
            multi_card(args.cards)
    else:
        with phase("2 kernels vs plain reference (1080p)"):
            check_fullpel_kernel()
            check_deblock()
        with tempfile.TemporaryDirectory() as work, _host_pool(2) as pool:
            with phase("3 main path (1080p, CLI)"):
                check_payload = main_path(work, pool)
            with phase("4 GPU vs CPU (CIF)"):
                gpu_vs_cpu(work)
            with phase("3 main path: blind extraction and decode"):
                check_payload()
    rec = device_record()
    rec["count"] = args.cards
    print(json.dumps({"ok": True, "device": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
