"""Native C++ host back-end vs Python oracles: bit-identical output."""

import numpy as np
import pytest

from video_steganography_pcamv_tpu import native

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="native lib unavailable")

rng = np.random.RandomState(7)


def _sparse_levels(shape, p=0.15, mag=8):
    x = rng.randint(-mag, mag + 1, shape).astype(np.int32)
    mask = rng.rand(*shape) < p
    return (x * mask).astype(np.int32)


def test_host_scan_matches_python():
    from video_steganography_pcamv_tpu.encoder import inter as I
    mbh, mbw = 6, 9
    mv = rng.randint(-12, 13, (mbh, mbw, 2)).astype(np.int32)
    mv[rng.rand(mbh, mbw) < 0.3] = 0
    cbp_l = (rng.rand(mbh, mbw) < 0.4).astype(np.int32) * 15
    cbp_c = (rng.rand(mbh, mbw) < 0.3).astype(np.int32) * 2
    s1, d1, p1 = I.host_scan_p(mv, cbp_l, cbp_c)
    s2, d2, p2 = native.host_scan_p(mv, cbp_l, cbp_c)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(p1, p2)

    skip = s1
    f1, fd1 = I.host_scan_p_forced(mv, skip)
    f2, fd2 = native.host_scan_p_forced(mv, skip)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(fd1, fd2)


def test_stc_matches_python():
    from video_steganography_pcamv_tpu.stego.stc import (
        stc_embed, stc_extract, StcState)
    st_py, st_na, st_ex = StcState(), StcState(), StcState()
    for _ in range(5):
        n = rng.randint(60, 400)
        k = max(1, n // rng.choice([3, 6, 10]))
        x = rng.randint(0, 2, n).astype(np.uint8)
        m = rng.randint(0, 2, k).astype(np.uint8)
        rho = rng.uniform(0.1, 9, n).astype(np.float32)
        y_py, c_py = stc_embed(x, m, rho, h=10, state=st_py)
        y_na, c_na = native.stc_embed(x, m, rho, h=10, state=st_na)
        np.testing.assert_array_equal(y_py, y_na)
        assert st_py.holdrand == st_na.holdrand  # persistent LCG parity
        assert abs(c_py - c_na) < 1e-9
        np.testing.assert_array_equal(
            stc_extract(y_na, k, h=10, state=st_ex), m)


def _frame_arrays(mbh, mbw):
    n = mbh * mbw
    return dict(
        cbp_chroma=rng.randint(0, 3, (mbh, mbw)).astype(np.int32),
        chroma_dc=_sparse_levels((n, 2, 4), p=0.4, mag=5),
        chroma_ac=_sparse_levels((n, 2, 4, 16), p=0.1, mag=4),
    )


def test_islice_bitstream_matches_python():
    from video_steganography_pcamv_tpu.utils.bitstream import BitWriter
    from video_steganography_pcamv_tpu.encoder.cavlc import FrameCavlc
    mbh, mbw = 4, 5
    n = mbh * mbw
    arr = _frame_arrays(mbh, mbw)
    mode = rng.randint(0, 4, n).astype(np.int32)
    cmode = rng.randint(0, 4, n).astype(np.int32)
    # mode availability constraints at frame borders
    for a in range(n):
        my, mx = a // mbw, a % mbw
        if my == 0 and mode[a] in (0, 3):
            mode[a] = 2
        if mx == 0 and mode[a] in (1, 3):
            mode[a] = 2
        if my == 0 and cmode[a] in (2, 3):
            cmode[a] = 0
        if mx == 0 and cmode[a] in (1, 3):
            cmode[a] = 0
    cbp_luma = (rng.rand(n) < 0.6).astype(np.int32) * 15
    luma_dc = _sparse_levels((n, 16), p=0.5, mag=20)
    luma_ac = _sparse_levels((n, 16, 16), p=0.12, mag=6)
    luma_ac[:, :, 0] = 0  # AC blocks: DC position unused

    header = b"\x12\x34"
    # python reference
    bw = BitWriter()
    bw.write(16, 0x1234)
    fc = FrameCavlc(mbw, mbh)
    for a in range(n):
        my, mx = a // mbw, a % mbw
        fc.write_i16x16_mb(
            bw, mx, my, int(mode[a]), int(cmode[a]), int(cbp_luma[a]),
            int(arr["cbp_chroma"][my, mx]),
            luma_dc[a].reshape(4, 4),
            luma_ac[a].reshape(4, 4, 4, 4),
            arr["chroma_dc"][a].reshape(2, 2, 2),
            arr["chroma_ac"][a].reshape(2, 2, 2, 4, 4), qp_delta=0)
    bw.rbsp_trailing()
    ref = bw.get_bytes()

    got = native.write_slice(
        header, 16, 2, mbw, mbh, mode=mode, cmode=cmode,
        cbp_luma=cbp_luma, cbp_chroma=arr["cbp_chroma"],
        luma_dc=luma_dc, luma_blocks=luma_ac,
        chroma_dc=arr["chroma_dc"], chroma_ac=arr["chroma_ac"])
    assert got == ref


def test_pslice_bitstream_matches_python():
    from video_steganography_pcamv_tpu.utils.bitstream import BitWriter
    from video_steganography_pcamv_tpu.encoder.cavlc import FrameCavlc
    mbh, mbw = 5, 6
    n = mbh * mbw
    arr = _frame_arrays(mbh, mbw)
    skip = (rng.rand(n) < 0.3).astype(np.uint8)
    mvd = rng.randint(-20, 21, (n, 2)).astype(np.int32)
    cbp_luma = rng.randint(0, 16, n).astype(np.int32)
    luma_blocks = _sparse_levels((n, 16, 16), p=0.1, mag=6)
    cbp_chroma = arr["cbp_chroma"].reshape(n)
    # consistency: skip MBs carry no residual info in either writer
    for a in range(n):
        if skip[a]:
            cbp_luma[a] = 0
            cbp_chroma[a] = 0
    header = b"\xAB"

    bw = BitWriter()
    bw.write(8, 0xAB)
    fc = FrameCavlc(mbw, mbh)
    run = 0
    for a in range(n):
        my, mx = a // mbw, a % mbw
        if skip[a]:
            run += 1
            fc.set_mb_nnz_zero(mx, my)
            continue
        bw.write_ue(run)
        run = 0
        fc.write_p16x16_mb(
            bw, mx, my, (int(mvd[a, 0]), int(mvd[a, 1])),
            int(cbp_luma[a]), int(cbp_chroma[a]),
            luma_blocks[a].reshape(4, 4, 4, 4),
            arr["chroma_dc"][a].reshape(2, 2, 2),
            arr["chroma_ac"][a].reshape(2, 2, 2, 4, 4), qp_delta=0)
    if run:
        bw.write_ue(run)
    bw.rbsp_trailing()
    ref = bw.get_bytes()

    got = native.write_slice(
        header, 8, 0, mbw, mbh, skip=skip, mvd=mvd,
        cbp_luma=cbp_luma, cbp_chroma=cbp_chroma,
        luma_blocks=luma_blocks,
        chroma_dc=arr["chroma_dc"], chroma_ac=arr["chroma_ac"])
    assert got == ref


def test_native_builds_into_ignored_dir():
    """The library is built from source at first use into native/build
    (listed in .gitignore), never shipped as a binary."""
    import os
    from video_steganography_pcamv_tpu import native as N
    assert N.load() is not None, N.build_error
    assert N.build_error is None
    assert os.path.dirname(N._LIB) == os.path.join(N._DIR, "build")
    repo = os.path.dirname(os.path.dirname(N._DIR))
    ignored = open(os.path.join(repo, ".gitignore")).read().split()
    assert "video_steganography_pcamv_tpu/native/build/" in ignored
    assert not any(f.endswith(".so") for f in os.listdir(N._DIR))
