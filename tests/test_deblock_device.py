"""Device wavefront deblock vs native C++ (bit-exact required — both
encoder and decoder must agree). Randomized planes + decision fields
across QPs, including the qp<=15 internal-edge shortcut and intra/skip
mixes (checkasm pattern)."""

import numpy as np
import jax.numpy as jnp
import pytest

from video_steganography_pcamv_tpu import native
from video_steganography_pcamv_tpu.ops.deblock_jax import (
    deblock_frame_device)
from video_steganography_pcamv_tpu.ops.transform import chroma_qp


@pytest.mark.skipif(native.load() is None, reason="native lib missing")
@pytest.mark.parametrize("qp", [12, 22, 30, 42])
def test_device_deblock_matches_native(qp):
    rng = np.random.RandomState(qp)
    for trial in range(3):
        mbh, mbw = rng.randint(2, 6), rng.randint(2, 8)
        H, W = 16 * mbh, 16 * mbw
        y = rng.randint(0, 256, (H, W)).astype(np.uint8)
        # piecewise-flat patches so the |p0-q0|<alpha gates open often
        for _ in range(10):
            yy, xx = rng.randint(0, H - 8), rng.randint(0, W - 8)
            y[yy:yy + 8, xx:xx + 8] = rng.randint(0, 256)
        # low-amplitude structure: |p0-q0| < alpha gates open nearly
        # everywhere, so EVERY edge's filter fires and any edge-order
        # mistake (e.g. chroma H before chroma V of a later edge)
        # changes results — random content missed exactly that bug
        gy, gx = np.mgrid[0:H // 2, 0:W // 2]
        u = (128 + (gx % 16) // 3 + (gy % 16) // 4).astype(np.uint8)
        u += (rng.rand(H // 2, W // 2) < 0.2).astype(np.uint8)
        v = np.roll(u, 3, axis=1).copy()
        y = ((y.astype(np.int32) // 8) + 110).astype(np.uint8)
        intra = (rng.rand(mbh, mbw) < 0.3).astype(np.uint8)
        skip = ((rng.rand(mbh, mbw) < 0.3) & (intra == 0)) \
            .astype(np.uint8)
        nnz4 = (rng.rand(4 * mbh, 4 * mbw) < 0.4).astype(np.int32) \
            * rng.randint(1, 5, (4 * mbh, 4 * mbw))
        mv4 = rng.randint(-10, 11, (4 * mbh, 4 * mbw, 2)) \
            .astype(np.int32)
        # unit-uniform enough for realism is not required: bS only
        # compares across 4x4 edges, any field is legal
        qpc = chroma_qp(qp)

        ry, ru, rv = y.copy(), u.copy(), v.copy()
        native.deblock_frame(ry, ru, rv, intra, nnz4, mv4, skip, qp, qpc)

        dy, du, dv = deblock_frame_device(
            jnp.asarray(y, jnp.int32), jnp.asarray(u, jnp.int32),
            jnp.asarray(v, jnp.int32), jnp.asarray(intra),
            jnp.asarray(skip), jnp.asarray(nnz4), jnp.asarray(mv4),
            qp, qpc, mbh, mbw)
        np.testing.assert_array_equal(np.asarray(dy), ry,
                                      err_msg=f"luma qp{qp} t{trial}")
        np.testing.assert_array_equal(np.asarray(du), ru,
                                      err_msg=f"U qp{qp} t{trial}")
        np.testing.assert_array_equal(np.asarray(dv), rv,
                                      err_msg=f"V qp{qp} t{trial}")


@pytest.mark.skipif(native.load() is None, reason="native lib missing")
def test_device_deblock_per_mb_qp_matches_native():
    """Per-MB QP maps (adaptive quantization): the device twin must
    reproduce the C++ qp_map path bit-exactly — qPav on MB edges
    (spec 8.7.2.2), per-MB internal tables, per-MB low-qp/alpha
    gates."""
    rng = np.random.RandomState(77)
    from video_steganography_pcamv_tpu.ops.transform import (
        CHROMA_QP_TABLE)
    for trial in range(4):
        mbh, mbw = rng.randint(2, 6), rng.randint(2, 8)
        H, W = 16 * mbh, 16 * mbw
        y = rng.randint(0, 256, (H, W)).astype(np.uint8)
        y = ((y.astype(np.int32) // 8) + 110).astype(np.uint8)
        gy, gx = np.mgrid[0:H // 2, 0:W // 2]
        u = (128 + (gx % 16) // 3 + (gy % 16) // 4).astype(np.uint8)
        v = np.roll(u, 3, axis=1).copy()
        intra = (rng.rand(mbh, mbw) < 0.3).astype(np.uint8)
        skip = ((rng.rand(mbh, mbw) < 0.3) & (intra == 0)) \
            .astype(np.uint8)
        nnz4 = (rng.rand(4 * mbh, 4 * mbw) < 0.4).astype(np.int32) \
            * rng.randint(1, 5, (4 * mbh, 4 * mbw))
        mv4 = rng.randint(-10, 11, (4 * mbh, 4 * mbw, 2)) \
            .astype(np.int32)
        # qp map spanning the low-qp gate boundary (some MBs <= 15)
        qp_map = rng.randint(10, 45, (mbh, mbw)).astype(np.int32)
        qpc_map = CHROMA_QP_TABLE[qp_map].astype(np.int32)
        qp = int(qp_map[0, 0])

        ry, ru, rv = y.copy(), u.copy(), v.copy()
        native.deblock_frame(ry, ru, rv, intra, nnz4, mv4, skip,
                             qp, chroma_qp(qp),
                             qp_map=qp_map, qpc_map=qpc_map)
        dy, du, dv = deblock_frame_device(
            jnp.asarray(y, jnp.int32), jnp.asarray(u, jnp.int32),
            jnp.asarray(v, jnp.int32), jnp.asarray(intra),
            jnp.asarray(skip), jnp.asarray(nnz4), jnp.asarray(mv4),
            jnp.asarray(qp_map), jnp.asarray(qpc_map), mbh, mbw)
        np.testing.assert_array_equal(np.asarray(dy), ry,
                                      err_msg=f"luma t{trial}")
        np.testing.assert_array_equal(np.asarray(du), ru,
                                      err_msg=f"U t{trial}")
        np.testing.assert_array_equal(np.asarray(dv), rv,
                                      err_msg=f"V t{trial}")

@pytest.mark.skipif(native.load() is None, reason="native lib missing")
def test_device_deblock_chroma_qp_offset_thresh():
    """chroma_qp_offset lowers qp_thresh (reference frame.c:633:
    15 - min(offA, offB) - max(0, cqo)); QPs straddling the boundary
    must gate internal edges identically on both backends, and low-QP
    MBs must still filter their MB-boundary edges when an AQ
    neighbour's qPav clears alpha/beta (no whole-MB early-out)."""
    rng = np.random.RandomState(1515)
    from video_steganography_pcamv_tpu.ops.transform import (
        CHROMA_QP_TABLE)
    for cqo in (0, 2, 6):
        for trial in range(2):
            mbh, mbw = rng.randint(2, 5), rng.randint(2, 6)
            H, W = 16 * mbh, 16 * mbw
            y = rng.randint(0, 256, (H, W)).astype(np.uint8)
            y = ((y.astype(np.int32) // 8) + 110).astype(np.uint8)
            gy, gx = np.mgrid[0:H // 2, 0:W // 2]
            u = (128 + (gx % 16) // 3 + (gy % 16) // 4).astype(np.uint8)
            v = np.roll(u, 3, axis=1).copy()
            intra = (rng.rand(mbh, mbw) < 0.3).astype(np.uint8)
            skip = ((rng.rand(mbh, mbw) < 0.2) & (intra == 0)) \
                .astype(np.uint8)
            nnz4 = (rng.rand(4 * mbh, 4 * mbw) < 0.5).astype(np.int32)
            mv4 = rng.randint(-10, 11, (4 * mbh, 4 * mbw, 2)) \
                .astype(np.int32)
            # half the MBs sit at/below the threshold, adjacent to
            # much higher-QP MBs: qPav on the shared edge exceeds the
            # alpha cut even though the low MB alone would not
            qp_map = np.where(rng.rand(mbh, mbw) < 0.5,
                              rng.randint(6, 16, (mbh, mbw)),
                              rng.randint(30, 46, (mbh, mbw))) \
                .astype(np.int32)
            qpc_map = CHROMA_QP_TABLE[
                np.clip(qp_map + cqo, 0, 51)].astype(np.int32)
            qp = int(qp_map[0, 0])
            qpc = int(qpc_map[0, 0])

            ry, ru, rv = y.copy(), u.copy(), v.copy()
            native.deblock_frame(ry, ru, rv, intra, nnz4, mv4, skip,
                                 qp, qpc, qp_map=qp_map,
                                 qpc_map=qpc_map,
                                 chroma_qp_offset=cqo)
            dy, du, dv = deblock_frame_device(
                jnp.asarray(y, jnp.int32), jnp.asarray(u, jnp.int32),
                jnp.asarray(v, jnp.int32), jnp.asarray(intra),
                jnp.asarray(skip), jnp.asarray(nnz4),
                jnp.asarray(mv4), jnp.asarray(qp_map),
                jnp.asarray(qpc_map), mbh, mbw,
                qp_thresh=15 - max(0, cqo))
            np.testing.assert_array_equal(np.asarray(dy), ry,
                                          err_msg=f"luma cqo{cqo}")
            np.testing.assert_array_equal(np.asarray(du), ru,
                                          err_msg=f"U cqo{cqo}")
            np.testing.assert_array_equal(np.asarray(dv), rv,
                                          err_msg=f"V cqo{cqo}")


@pytest.mark.skipif(native.load() is None, reason="native lib missing")
def test_device_deblock_trans8_and_offsets_matches_native():
    """High-profile inputs (round 5): 8x8-transform MBs skip internal
    4x4-only luma edges (deblock.cpp trans8 rule / reference
    frame.c:627-811), and FilterOffsetA/B shift the alpha/beta/tc0
    table indices (spec 8.7.2.2). Fuzz the XLA twin vs the C++ oracle
    across QPs, offsets (incl. negative and asymmetric) and trans8
    densities."""
    rng = np.random.RandomState(5150)
    cases = [(30, 0, 0), (30, 6, -6), (26, -4, 4), (38, 12, 12),
             (16, -12, -12), (22, 2, 0)]
    for qp, off_a, off_b in cases:
        mbh, mbw = rng.randint(2, 6), rng.randint(2, 8)
        H, W = 16 * mbh, 16 * mbw
        y = rng.randint(0, 256, (H, W)).astype(np.uint8)
        y = ((y.astype(np.int32) // 8) + 110).astype(np.uint8)
        gy, gx = np.mgrid[0:H // 2, 0:W // 2]
        u = (128 + (gx % 16) // 3 + (gy % 16) // 4).astype(np.uint8)
        u += (rng.rand(H // 2, W // 2) < 0.2).astype(np.uint8)
        v = np.roll(u, 3, axis=1).copy()
        intra = (rng.rand(mbh, mbw) < 0.3).astype(np.uint8)
        skip = ((rng.rand(mbh, mbw) < 0.2) & (intra == 0)) \
            .astype(np.uint8)
        trans8 = (rng.rand(mbh, mbw) < 0.5).astype(np.uint8)
        nnz4 = (rng.rand(4 * mbh, 4 * mbw) < 0.4).astype(np.int32) \
            * rng.randint(1, 5, (4 * mbh, 4 * mbw))
        mv4 = rng.randint(-10, 11, (4 * mbh, 4 * mbw, 2)) \
            .astype(np.int32)
        qpc = chroma_qp(qp)

        ry, ru, rv = y.copy(), u.copy(), v.copy()
        native.deblock_frame(ry, ru, rv, intra, nnz4, mv4, skip, qp,
                             qpc, trans8=trans8, alpha_off=off_a,
                             beta_off=off_b)

        dy, du, dv = deblock_frame_device(
            jnp.asarray(y, jnp.int32), jnp.asarray(u, jnp.int32),
            jnp.asarray(v, jnp.int32), jnp.asarray(intra),
            jnp.asarray(skip), jnp.asarray(nnz4), jnp.asarray(mv4),
            qp, qpc, mbh, mbw,
            qp_thresh=15 - min(off_a, off_b),
            trans8=jnp.asarray(trans8.astype(np.int32)),
            off_a=off_a, off_b=off_b)
        for got, want, name in ((dy, ry, "Y"), (du, ru, "U"),
                                (dv, rv, "V")):
            np.testing.assert_array_equal(
                np.asarray(got), want,
                err_msg=f"{name} qp{qp} offA{off_a} offB{off_b}")


def _fuzz_frame(rng, mbh, mbw, amp=24):
    """Structured low-amplitude content (flat MB bases + noise) with
    real-looking decision fields: intra/skip mixes, nnz, MVs that are
    piecewise-constant over 8x8 units."""
    H, W = 16 * mbh, 16 * mbw
    base = rng.integers(60, 180, (mbh, mbw))
    y = np.repeat(np.repeat(base, 16, 0), 16, 1)
    y = np.clip(y + rng.integers(-amp, amp + 1, (H, W)), 0, 255)
    u = np.clip(128 + rng.integers(-amp, amp + 1, (H // 2, W // 2)), 0, 255)
    v = np.clip(128 + rng.integers(-amp, amp + 1, (H // 2, W // 2)), 0, 255)
    intra = (rng.random((mbh, mbw)) < 0.15).astype(np.uint8)
    skip = ((rng.random((mbh, mbw)) < 0.2) & (intra == 0)).astype(np.uint8)
    nnz4 = (rng.random((4 * mbh, 4 * mbw)) < 0.5).astype(np.int32)
    mv4 = rng.integers(-20, 21, (4 * mbh, 4 * mbw, 2)).astype(np.int32)
    mv4 = np.repeat(np.repeat(mv4[::2, ::2], 2, 0), 2, 1)
    return (y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8),
            intra, skip, nnz4, mv4)


@pytest.mark.skipif(native.load() is None, reason="native lib missing")
@pytest.mark.parametrize("case", [
    dict(qp=32, mbh=6, mbw=8), dict(qp=40, mbh=5, mbw=9),
    dict(qp=20, mbh=4, mbw=12),
    dict(qp=None, mbh=5, mbw=10, seed=7),           # AQ maps + multi-ref
    dict(qp=30, mbh=5, mbw=9, seed=58, trans8=True, off=(6, -6)),
], ids=["qp32", "qp40", "qp20", "aq_mref", "trans8_offsets"])
def test_device_deblock_fuzz_matches_native(case):
    """Fuzz matrix over every edge type — strong (intra), normal bS
    1/2, MB-boundary qPav, per-MB AQ maps, multi-ref bS, the
    qp_thresh internal-edge kill, trans8 + FilterOffsetA/B — device
    twin against the C++ filter."""
    from video_steganography_pcamv_tpu.ops.transform import (
        CHROMA_QP_TABLE)
    mbh, mbw = case["mbh"], case["mbw"]
    rng = np.random.default_rng(case.get("seed", case["qp"]))
    y, u, v, intra, skip, nnz4, mv4 = _fuzz_frame(rng, mbh, mbw)
    nat, dev = {}, {}
    off_a, off_b = case.get("off", (0, 0))
    cqo = 0
    if case["qp"] is None:
        cqo = 2
        qp_map = rng.integers(18, 44, (mbh, mbw)).astype(np.int32)
        qpc_map = CHROMA_QP_TABLE[np.clip(qp_map + cqo, 0, 51)] \
            .astype(np.int32)
        ref4 = rng.integers(0, 3, (4 * mbh, 4 * mbw)).astype(np.int32)
        ref4 = np.repeat(np.repeat(ref4[::2, ::2], 2, 0), 2, 1)
        qp, qpc = int(qp_map[0, 0]), int(qpc_map[0, 0])
        nat.update(qp_map=qp_map, qpc_map=qpc_map, ref4=ref4,
                   chroma_qp_offset=cqo)
        dev.update(ref4=jnp.asarray(ref4))
        qp_d, qpc_d = jnp.asarray(qp_map), jnp.asarray(qpc_map)
    else:
        qp, qpc = case["qp"], chroma_qp(case["qp"])
        qp_d, qpc_d = qp, qpc
    if case.get("trans8"):
        trans8 = (rng.random((mbh, mbw)) < 0.5).astype(np.uint8)
        nat.update(trans8=trans8, alpha_off=off_a, beta_off=off_b)
        dev.update(trans8=jnp.asarray(trans8.astype(np.int32)),
                   off_a=off_a, off_b=off_b)

    ry, ru, rv = y.copy(), u.copy(), v.copy()
    native.deblock_frame(ry, ru, rv, intra, nnz4, mv4, skip, qp, qpc,
                         **nat)
    got = deblock_frame_device(
        jnp.asarray(y, jnp.int32), jnp.asarray(u, jnp.int32),
        jnp.asarray(v, jnp.int32), jnp.asarray(intra),
        jnp.asarray(skip), jnp.asarray(nnz4), jnp.asarray(mv4),
        qp_d, qpc_d, mbh, mbw,
        qp_thresh=15 - min(off_a, off_b) - max(0, cqo), **dev)
    for g, want, name in zip(got, (ry, ru, rv), "YUV"):
        np.testing.assert_array_equal(np.asarray(g), want,
                                      err_msg=f"plane {name}")


@pytest.fixture
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; run python3 chip_smoke.py there")


@pytest.mark.gpu
def test_device_deblock_on_gpu_at_1080p(gpu):
    import chip_smoke
    chip_smoke.check_deblock()
