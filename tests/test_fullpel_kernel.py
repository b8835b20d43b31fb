"""The full-pel stage: the Pallas (Triton) kernel in interpret mode
against the plain scan `fullpel_search_parts`, and the wrapper that
picks one of them per lowering platform.

The GPU-marked tests run the compiled kernel on the card; they skip
here (the CPU suite forces JAX onto the CPU) and run through
`python3 chip_smoke.py` on a machine with a GPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder.partition import (
    fullpel_search_parts)
from video_steganography_pcamv_tpu.ops import fullpel as FP
from video_steganography_pcamv_tpu.ops import mc


def _frames(mbh, mbw, seed, kind="shifted"):
    r = np.random.RandomState(seed)
    h, w = 16 * mbh, 16 * mbw
    if kind == "flat":              # every displacement ties on SAD
        ref = np.full((h, w), 77, np.int32)
        cur = np.full((h, w), 80, np.int32)
    elif kind == "periodic":        # ties between periodic shifts
        yy, xx = np.mgrid[0:h, 0:w]
        ref = ((yy % 4) * 40 + (xx % 4) * 20).astype(np.int32)
        cur = np.roll(ref, (1, 2), (0, 1))
    else:                           # a real best displacement + noise
        ref = r.randint(0, 256, (h, w)).astype(np.int32)
        cur = np.roll(ref, (2, -3), (0, 1))
        cur = np.clip(cur + r.randint(-2, 3, cur.shape), 0, 255)
    return jnp.asarray(cur), mc.pad_plane(jnp.asarray(ref))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


CASES = {
    # mbw not a multiple of the column tile: the last tile is masked
    "rng4_partial_tile": dict(rng=4, mbh=2, mbw=5, tw=4, pred=3, lam=4),
    # tile wider than the frame
    "rng8_tile_wider": dict(rng=8, mbh=2, mbw=3, tw=8, pred=8, lam=4),
    # predictors far outside the search range
    "rng8_large_pred": dict(rng=8, mbh=3, mbw=3, tw=2, pred=60, lam=16),
    # predictors past the mv-bit table's own range
    "rng4_huge_pred": dict(rng=4, mbh=2, mbw=4, tw=4, pred=100, lam=4),
    "rng16": dict(rng=16, mbh=2, mbw=3, tw=4, pred=16, lam=4),
    # all costs tie: the first displacement in dy-major order must win
    "ties_flat_lam0": dict(rng=4, mbh=2, mbw=3, tw=4, pred=0, lam=0,
                           kind="flat"),
    "ties_flat_zero_pred": dict(rng=4, mbh=2, mbw=3, tw=2, pred=0, lam=4,
                                kind="flat"),
    "ties_periodic": dict(rng=8, mbh=2, mbw=2, tw=2, pred=2, lam=1,
                          kind="periodic"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_kernel_matches_reference_interpret(case):
    c = CASES[case]
    mbh, mbw, rng = c["mbh"], c["mbw"], c["rng"]
    cur, ref = _frames(mbh, mbw, seed=len(case), kind=c.get("kind", ""))
    r = np.random.RandomState(7)
    pred = jnp.asarray(r.randint(-c["pred"], c["pred"] + 1,
                                 (mbh, mbw, 2)), jnp.int32)
    want = fullpel_search_parts(cur, ref, pred, rng, mbh, mbw, c["lam"])
    got = FP.fullpel_parts_kernel(cur, ref, pred, rng, mbh, mbw,
                                  c["lam"], tw=c["tw"], interpret=True)
    _assert_same(got, want)


def test_wrapper_picks_kernel_per_platform():
    """The wrapper lowers to the Triton kernel for CUDA and to the
    plain scan for the CPU; no interpret mode on either."""
    mbh, mbw, rng = 2, 3, 4
    args = (jax.ShapeDtypeStruct((16 * mbh, 16 * mbw), jnp.int32),
            jax.ShapeDtypeStruct((16 * mbh + 2 * mc.PAD,
                                  16 * mbw + 2 * mc.PAD), jnp.int32),
            jax.ShapeDtypeStruct((mbh, mbw, 2), jnp.int32))
    f = jax.jit(lambda c, r, p: FP.fullpel_parts(c, r, p, rng, mbh, mbw,
                                                 4))
    cuda = f.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    cpu = f.trace(*args).lower(lowering_platforms=("cpu",)).as_text()
    assert "__gpu$xla.gpu.triton" in cuda
    assert "triton" not in cpu
    assert "while" in cpu        # the scan over displacements


def test_wrapper_on_cpu_matches_reference_under_vmap():
    """The multi-stream step vmaps the wrapper over streams."""
    mbh, mbw, rng = 2, 3, 4
    pairs = [_frames(mbh, mbw, seed=s) for s in range(2)]
    curs = jnp.stack([p[0] for p in pairs])
    refs = jnp.stack([p[1] for p in pairs])
    preds = jnp.asarray(np.random.RandomState(3).randint(
        -4, 5, (2, mbh, mbw, 2)), jnp.int32)
    got = jax.jit(jax.vmap(lambda c, r, p: FP.fullpel_parts(
        c, r, p, rng, mbh, mbw, 4)))(curs, refs, preds)
    for s in range(2):
        want = fullpel_search_parts(curs[s], refs[s], preds[s], rng, mbh,
                                    mbw, 4)
        _assert_same({k: v[s] for k, v in got.items()}, want)


def test_kernel_output_shapes_match_reference():
    """Shapes and dtypes at 1080p (abstract evaluation only)."""
    mbh, mbw, rng = 68, 120, 16
    args = (jax.ShapeDtypeStruct((16 * mbh, 16 * mbw), jnp.int32),
            jax.ShapeDtypeStruct((16 * mbh + 2 * mc.PAD,
                                  16 * mbw + 2 * mc.PAD), jnp.int32),
            jax.ShapeDtypeStruct((mbh, mbw, 2), jnp.int32))
    got = jax.eval_shape(lambda c, r, p: FP.fullpel_parts_kernel(
        c, r, p, rng, mbh, mbw, 4, interpret=True), *args)
    want = jax.eval_shape(lambda c, r, p: fullpel_search_parts(
        c, r, p, rng, mbh, mbw, 4), *args)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}


def test_mv_cost_tables_match_reference_cost():
    """The kernel's per-axis mv-cost tables sum to the reference's
    per-displacement mv cost for every MB."""
    from video_steganography_pcamv_tpu.encoder.me import mv_bits_table
    rng, lam = 4, 7
    pred = np.random.RandomState(2).randint(-20, 21, (2, 3, 2))
    mvx, mvy = FP.mv_cost_tables(jnp.asarray(pred, jnp.int32), rng, lam)
    bits = mv_bits_table(4 * (rng + 64))
    off = 4 * (rng + 64)
    for dy in range(-rng, rng + 1):
        for dx in range(-rng, rng + 1):
            want = (bits[4 * dx - 4 * pred[..., 0] + off]
                    + bits[4 * dy - 4 * pred[..., 1] + off]) * lam
            got = np.asarray(mvx[dx + rng] + mvy[dy + rng])
            np.testing.assert_array_equal(got, want)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; run python3 chip_smoke.py there")


@pytest.mark.gpu
def test_kernel_on_gpu_at_1080p(gpu):
    import chip_smoke
    chip_smoke.check_fullpel_kernel()


@pytest.mark.gpu
def test_gpu_and_cpu_streams_identical(gpu, tmp_path):
    import chip_smoke
    chip_smoke.gpu_vs_cpu(str(tmp_path))
