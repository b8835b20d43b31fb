"""The split RCA probe stage: probe_maps_xla (the unit-independent
SATD maps the deep pipeline computes before the MVPs are known) +
probe_combine must equal the one-shot stego_costs_parts."""

import numpy as np
import jax.numpy as jnp
import pytest

from video_steganography_pcamv_tpu.ops import mc
from video_steganography_pcamv_tpu.encoder import partition as PT
from video_steganography_pcamv_tpu.encoder import me as ME


def _setup(seed, mbh, mbw, rng_px=16):
    rng = np.random.RandomState(seed)
    h, w = 16 * mbh, 16 * mbw
    prev = rng.randint(0, 256, (h, w)).astype(np.int32)
    cur = np.clip(prev + rng.randint(-20, 21, (h, w)), 0, 255) \
        .astype(np.int32)
    u = rng.randint(0, 256, (h // 2, w // 2)).astype(np.int32)
    ref = mc.build_ref(jnp.asarray(prev), jnp.asarray(u),
                       jnp.asarray(u))
    part = rng.randint(0, 4, (mbh, mbw)).astype(np.int32)
    mvfp8 = rng.randint(-rng_px, rng_px + 1,
                        (2 * mbh, 2 * mbw, 2)).astype(np.int32)
    # members of a partition unit share their MV (decide_partition's
    # contract; subpel coupling depends on it)
    mvz = PT._sp_to_z(jnp.asarray(mvfp8), mbh, mbw)       # [mbh,mbw,4,2]
    mvz = np.array(mvz)
    for pt, units in PT.UNIT_BLOCKS.items():
        sel = part == pt
        for blocks in units:
            for b in blocks[1:]:
                mvz[sel, b] = mvz[sel, blocks[0]]
    mvfp8 = np.asarray(PT._z_to_sp(jnp.asarray(mvz), mbh, mbw))
    prev_mv = rng.randint(-32, 33, (mbh, mbw, 2)).astype(np.int32)
    return cur, ref, part, mvfp8, prev_mv


@pytest.mark.parametrize("seed,qp,decimate", [
    (3, 30, True), (0, 26, True), (1, 38, True), (0, 26, False)])
def test_probe_combine_from_kernel_maps(seed, qp, decimate):
    """probe_maps_xla + probe_combine == stego_costs_parts."""
    from video_steganography_pcamv_tpu.stego.cost import cost_mv_table
    mbh, mbw = 2, 3
    cur, ref, part, mvfp8, prev_mv = _setup(seed, mbh, mbw)
    lam = ME.lambda_tab(qp)
    cur_j = jnp.asarray(cur)
    planes = ref["luma"].astype(jnp.uint8)
    windows = PT.gather_windows8_jnp(planes, jnp.asarray(mvfp8),
                                     mbh, mbw)
    blocks8 = PT.block_table8(windows)
    wht8 = PT.wht8_flat(blocks8).astype(jnp.int16)
    mv8, ridx, _ = PT.subpel_parts(
        cur_j, wht8, jnp.asarray(part), jnp.asarray(mvfp8),
        jnp.asarray(prev_mv), mbh, mbw, lam, 2)
    rng = np.random.RandomState(9)
    mvp_u = jnp.asarray(rng.randint(-64, 65, (mbh, mbw, 4, 2)),
                        jnp.int32)
    cmv = jnp.asarray(cost_mv_table(lam))

    rho_x, alt_x, val_x = PT.stego_costs_parts(
        cur_j, blocks8, wht8, ridx, jnp.asarray(part), mv8, mvp_u,
        cmv, qp, mbh, mbw, decimate)

    SK, SP, sc8 = PT.probe_maps_xla(cur_j, blocks8, wht8, ridx, qp,
                                    mbh, mbw, decimate)
    rho_p, alt_p, val_p = PT.probe_combine(
        SK, SP, sc8, jnp.asarray(part), mv8, mvp_u, cmv, mbh, mbw,
        decimate)
    assert np.array_equal(np.asarray(rho_p), np.asarray(rho_x))
    assert np.array_equal(np.asarray(alt_p), np.asarray(alt_x))
    assert np.array_equal(np.asarray(val_p), np.asarray(val_x))
