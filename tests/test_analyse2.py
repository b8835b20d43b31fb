"""v2 table-based analysis vs v1 gather-based: identical stego costs."""

import numpy as np
import jax.numpy as jnp

from video_steganography_pcamv_tpu.ops import mc
from video_steganography_pcamv_tpu.encoder import qpel_table as QT
from video_steganography_pcamv_tpu.encoder import analyse2 as A2
from video_steganography_pcamv_tpu.stego.cost import (alt_mv_costs,
                                                      cost_mv_table)
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence


def _frame_pair(w=64, h=48, seed=4):
    frames = synthetic_sequence(w, h, 2, seed=seed)
    cur = jnp.asarray(frames[1].y, jnp.int32)
    ref = jnp.asarray(frames[0].y, jnp.int32)
    fp = mc.pad_plane(ref)
    hh, vv, cc = mc.hpel_planes(fp)
    return cur, jnp.stack([fp, hh, vv, cc])


def test_stego_costs_v2_match_v1():
    mbh, mbw = 3, 4
    cur, planes = _frame_pair()
    rng = np.random.RandomState(0)
    mv_fp = jnp.asarray(rng.randint(-4, 5, (mbh, mbw, 2)).astype(np.int32))
    r = rng.randint(-3, 4, (mbh, mbw, 2)).astype(np.int32)
    mv = np.asarray(mv_fp) * 4 + r
    mvp = jnp.asarray(rng.randint(-10, 11,
                                  (mbh, mbw, 2)).astype(np.int32))
    cmv = jnp.asarray(cost_mv_table(4))

    for decimate in (True, False):
        rho1, alt1, fl1 = alt_mv_costs(cur, planes, jnp.asarray(mv), mvp,
                                       cmv, 26, mbh, mbw, decimate)

        win = QT.gather_windows_jnp(planes, mv_fp, mbh, mbw)
        blocks = QT.block_table(win)
        wht = QT.wht16(blocks)
        r_idx = jnp.asarray(((r[..., 1] + 6) * 13
                             + (r[..., 0] + 6)).reshape(-1))
        rho2, alt2, fl2 = A2.stego_costs_from_table(
            cur, blocks, wht, r_idx, jnp.asarray(mv), mvp, cmv, 26,
            mbh, mbw, decimate)

        np.testing.assert_array_equal(np.asarray(rho1), np.asarray(rho2))
        np.testing.assert_array_equal(np.asarray(alt1), np.asarray(alt2))
        np.testing.assert_array_equal(np.asarray(fl1), np.asarray(fl2))


def test_subpel_from_table_mv_in_box():
    mbh, mbw = 3, 4
    cur, planes = _frame_pair(seed=9)
    mv_fp = jnp.zeros((mbh, mbw, 2), jnp.int32)
    win = QT.gather_windows_jnp(planes, mv_fp, mbh, mbw)
    wht = QT.wht16(QT.block_table(win))
    prev = jnp.zeros((mbh, mbw, 2), jnp.int32)
    mv, r_idx = A2.subpel_from_table(cur, wht, mv_fp, prev, mbh, mbw, 4, 2)
    mv = np.asarray(mv)
    assert np.all(np.abs(mv) <= 3)
    # r_idx consistent with mv
    oy = np.asarray(r_idx) // 13 - 6
    ox = np.asarray(r_idx) % 13 - 6
    np.testing.assert_array_equal(mv[..., 0].reshape(-1), ox)
    np.testing.assert_array_equal(mv[..., 1].reshape(-1), oy)
