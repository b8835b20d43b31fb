"""Cross-pipeline equivalence: the partition pipeline restricted to
16x16 (allow_parts=False) must reproduce the 16x16 table pipeline's
MVs and RCA stego costs exactly — two independent implementations of
the same math (window geometry differs: 24px/MB vs 16px/8x8-block)."""

import numpy as np
import jax.numpy as jnp

from video_steganography_pcamv_tpu.ops import mc
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence
from video_steganography_pcamv_tpu.encoder import analyse2 as A2
from video_steganography_pcamv_tpu.encoder import partition as PT
from video_steganography_pcamv_tpu.stego.cost import cost_mv_table


def test_partition_pipeline_matches_16x16_when_restricted():
    W, H = 128, 96
    mbh, mbw = H // 16, W // 16
    fr = synthetic_sequence(W, H, 2, seed=13)
    y = jnp.asarray(fr[1].y, jnp.int32)
    ref = mc.build_ref(jnp.asarray(fr[0].y, jnp.int32),
                       jnp.asarray(fr[0].u, jnp.int32),
                       jnp.asarray(fr[0].v, jnp.int32))
    prev = jnp.zeros((mbh, mbw, 2), jnp.int32)
    lam = 4

    mv16, r16, blocks16, wht16t = A2.analyse_p_frame(
        y, ref["luma"], prev, 8, mbh, mbw, lam, 2)
    part, mv8, r8, blocks8, wht8, _cost = PT.analyse_p_frame_parts(
        y, ref["luma"], prev, 8, mbh, mbw, lam, 2, allow_parts=False)

    assert np.all(np.asarray(part) == 0)
    mv8_np = np.asarray(mv8)
    np.testing.assert_array_equal(mv8_np[::2, ::2], np.asarray(mv16))
    np.testing.assert_array_equal(mv8_np[1::2, 1::2], np.asarray(mv16))

    # RCA stego costs: per-unit (slot 0) must equal the 16x16 path
    cmv = jnp.asarray(cost_mv_table(lam))
    mvp = jnp.zeros((mbh, mbw, 2), jnp.int32)
    rho16, alt16, _ = A2.stego_costs_from_table(
        y, blocks16, wht16t, r16, mv16, mvp, cmv, 26, mbh, mbw, True)
    mvp_u = jnp.zeros((mbh, mbw, 4, 2), jnp.int32)
    rho_u, alt_u, valid = PT.stego_costs_parts(
        y, blocks8, wht8, r8, part, mv8, mvp_u, cmv, 26, mbh, mbw, True)

    v = np.asarray(valid)
    assert np.all(v[:, :, 0]) and not np.any(v[:, :, 1:])
    np.testing.assert_array_equal(np.asarray(rho_u)[:, :, 0],
                                  np.asarray(rho16))
    np.testing.assert_array_equal(np.asarray(alt_u)[:, :, 0],
                                  np.asarray(alt16))
