"""Qpel block-table machinery vs the direct gather MC path."""

import numpy as np
import jax.numpy as jnp

from video_steganography_pcamv_tpu.ops import mc
from video_steganography_pcamv_tpu.encoder import qpel_table as QT
from video_steganography_pcamv_tpu.ops.pixel import satd


def _setup(mbh=2, mbw=3, seed=0):
    rng = np.random.RandomState(seed)
    h, w = 16 * mbh, 16 * mbw
    ref = jnp.asarray(rng.randint(0, 256, (h, w)).astype(np.int32))
    fp = mc.pad_plane(ref)
    hh, vv, cc = mc.hpel_planes(fp)
    planes = jnp.stack([fp, hh, vv, cc])
    mv_fp = jnp.asarray(rng.randint(-3, 4, (mbh, mbw, 2)).astype(np.int32))
    return planes, mv_fp, mbh, mbw


def test_windows_and_block_table_match_mc_luma():
    planes, mv_fp, mbh, mbw = _setup()
    n = mbh * mbw
    win = QT.gather_windows_jnp(planes, mv_fp, mbh, mbw)
    table = QT.block_table(win)            # [169, N, 16, 16]

    ys = (jnp.arange(n) // mbw) * 16
    xs = (jnp.arange(n) % mbw) * 16
    mvq = mv_fp.reshape(n, 2) * 4
    rng = np.random.RandomState(1)
    for _ in range(12):
        oy, ox = rng.randint(-6, 7), rng.randint(-6, 7)
        direct = mc.mc_luma(planes, ys, xs,
                            mvq + jnp.asarray([ox, oy]))
        got = table[QT.off_index(oy, ox)]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(direct),
                                      err_msg=f"offset ({oy},{ox})")


def test_wht_satd_matches_pixel_satd():
    rng = np.random.RandomState(2)
    a = jnp.asarray(rng.randint(0, 256, (5, 16, 16)).astype(np.int32))
    b = jnp.asarray(rng.randint(0, 256, (5, 16, 16)).astype(np.int32))
    via_wht = QT.satd_tables(QT.wht16(a), QT.wht16(b))
    direct = satd(a, b, 16)[..., 0, 0]
    np.testing.assert_array_equal(np.asarray(via_wht), np.asarray(direct))


def test_select_rows():
    rng = np.random.RandomState(3)
    table = jnp.asarray(rng.randint(0, 99, (7, 10, 4, 4)))
    idx = jnp.asarray(rng.randint(0, 7, 10))
    got = QT.select_rows(table, idx)
    want = np.stack([np.asarray(table)[int(idx[i]), i]
                     for i in range(10)])
    np.testing.assert_array_equal(np.asarray(got), want)
