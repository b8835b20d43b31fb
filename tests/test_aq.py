"""Adaptive quantization (--aq-mode) + --zones.

Reference model: x264_adaptive_quant_frame (ratecontrol.c:231) computes
per-MB qp offsets from source AC energy; x264_adaptive_quant (:255)
assigns per-MB QP with +-1 hysteresis; mb_qp_delta carries the chain
(spec 7.4.5); the deblocker uses the decoder-visible per-MB QP with
qPav on MB edges (spec 8.7.2.2). Zones: parse_zones (:602)."""

import numpy as np
import pytest

from video_steganography_pcamv_tpu import native
from video_steganography_pcamv_tpu.params import Params
from video_steganography_pcamv_tpu.utils.yuv import Frame
from video_steganography_pcamv_tpu.encoder.core import Encoder
from video_steganography_pcamv_tpu.decoder import decode_annexb

W, H = 96, 64

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="native lib unavailable")


def _mixed_energy_frames(n, seed=5):
    """Half the frame flat, half noisy: AQ must spread QP."""
    rng = np.random.RandomState(seed)
    u = np.full((H // 2, W // 2), 110, np.uint8)
    v = np.full((H // 2, W // 2), 140, np.uint8)
    out = []
    base = rng.randint(0, 256, (H, W)).astype(np.uint8)
    for i in range(n):
        y = np.full((H, W), 80, np.uint8)
        y[:, W // 2:] = np.roll(base, i, axis=1)[:, W // 2:]
        y[:8] += np.arange(W, dtype=np.uint8) % 7  # mild texture band
        out.append(Frame(y, u.copy(), v.copy()))
    return out


def _encode_all(enc, frames):
    bs = b""
    for f in frames:
        bs += enc.encode_frame(f)
    return bs + enc.flush()


def test_aq_roundtrip_and_qp_spread():
    frames = _mixed_energy_frames(4)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 4
    # P frames must carry a real per-MB QP spread
    spread = set()
    for d in dec[1:]:
        spread |= {m.qp for m in d.mbs}
    assert len(spread) >= 3, f"AQ produced no qp spread: {spread}"
    # encoder recon == decoder output (incl. the per-MB-qp deblocker)
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i} luma")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")
        np.testing.assert_array_equal(
            d.v, rv[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} V")


def test_aq_offsets_formula():
    """aq_offsets matches the reference formula
    strength*1.0397*(log2(energy)-14.427) with energy = var16(luma) +
    var8(u) + var8(v) (ratecontrol.c:231-249 with exact log2), and
    flat MBs get lower offsets than noisy ones."""
    import jax.numpy as jnp
    from video_steganography_pcamv_tpu.ops.aq import aq_offsets
    rng = np.random.RandomState(1)
    y = np.full((H, W), 80, np.int32)
    y[:, W // 2:] = rng.randint(0, 256, (H, W // 2))
    u = rng.randint(100, 120, (H // 2, W // 2)).astype(np.int32)
    v = np.full((H // 2, W // 2), 140, np.int32)
    offs = np.asarray(aq_offsets(jnp.asarray(y), jnp.asarray(u),
                                 jnp.asarray(v), H // 16, W // 16,
                                 jnp.float32(1.0)))
    # serial oracle (PIXEL_VAR_C semantics)
    def var(t, shift):
        s, sq = int(t.sum()), int((t.astype(np.int64) ** 2).sum())
        return sq - ((s * s) >> shift)
    for my in range(H // 16):
        for mx in range(W // 16):
            e = (var(y[16*my:16*my+16, 16*mx:16*mx+16], 8)
                 + var(u[8*my:8*my+8, 8*mx:8*mx+8], 6)
                 + var(v[8*my:8*my+8, 8*mx:8*mx+8], 6))
            want = 1.0397 * (np.log2(max(e, 1)) - 14.427)
            assert abs(offs[my, mx] - want) < 1e-3, (my, mx)
    assert offs[:, :W // 32].mean() < offs[:, W // 32:].mean()


def test_zones_force_qp():
    frames = _mixed_energy_frames(6, seed=3)
    p = Params(width=W, height=H, qp=30, me_range=4,
               zones="2,3,q=40/4,5,b=2.0")
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    got = [d.mbs[0].qp for d in dec]
    assert got[2] == 40 and got[3] == 40, got
    # b=2.0 -> qp -= 6*log2(2) = 6
    assert got[4] == 24 and got[5] == 24, got
    assert got[1] == 30, got
    for i, d in enumerate(dec):
        ry = enc.recon_by_disp[i][0][:H, :W].astype(np.uint8)
        np.testing.assert_array_equal(d.y, ry, err_msg=f"frame {i}")


def test_aq_cabac_roundtrip():
    """AQ under CABAC: mb_qp_delta on ctx 60-63 with the prev-MB chain
    (x264_cabac_mb_qp_delta, encoder/cabac.c:265-297) + the decoder's
    running-QP dequant chain."""
    frames = _mixed_energy_frames(4, seed=8)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, cabac=True)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 4
    spread = set()
    for d in dec[1:]:
        spread |= {m.qp for m in d.mbs}
    assert len(spread) >= 3, f"AQ produced no qp spread: {spread}"
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i} luma")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")


@pytest.mark.parametrize("cabac", [False, True])
def test_aq_with_8x8dct(cabac):
    """AQ + --8x8dct: per-MB QP through the 8x8 quant/dequant pair and
    the trans8 deblock rule, both entropy modes."""
    frames = _mixed_energy_frames(4, seed=11)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, transform_8x8=True, cabac=cabac)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 4
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i} luma")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")


@pytest.mark.parametrize("cabac", [False, True])
def test_aq_with_multiref(cabac):
    """AQ + --ref 3: per-MB QP with ref_idx syntax in both entropy
    modes (the mref encode threads the same AQ grids)."""
    frames = _mixed_energy_frames(5, seed=13)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, ref_frames=3, cabac=cabac)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 5
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i} luma")


@pytest.mark.parametrize("cabac", [False, True])
def test_aq_on_i_frames(cabac):
    """AQ applies to I frames too (x264 adaptive_quant on all types):
    per-MB QP through the intra wavefront, mb_qp_delta chain on I16
    (always coded) and I_NxN (with residual), per-MB-QP deblock."""
    frames = _mixed_energy_frames(3, seed=17)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, cabac=cabac, keyint_max=2)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 3
    spread = {m.qp for m in dec[0].mbs}   # the IDR must carry AQ
    assert len(spread) >= 3, f"no I-frame qp spread: {spread}"
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i} luma")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")


@pytest.mark.parametrize("cabac", [False, True])
def test_aq_on_b_frames(cabac):
    """AQ on B frames (+pyramid): per-MB QP through the bipred encode
    and the B mb_qp_delta chain in both entropy modes."""
    frames = _mixed_energy_frames(7, seed=19)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, bframes=2, b_adapt=0, b_pyramid=True,
               cabac=cabac)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 7
    bspread = set()
    for d in dec:
        if d.slice_type in (1, 6):
            bspread |= {m.qp for m in d.mbs}
    assert len(bspread) >= 3, f"no B-frame qp spread: {bspread}"
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i} luma")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")


@pytest.mark.parametrize("cabac", [False, True])
def test_aq_with_stego(cabac):
    """AQ + embedding (--aq-mode 1 --emrate): the flip re-encode
    quantizes at the pass-1 per-MB grid; payload blind-extracts and
    the stream stays conformant. Extends the reference, which embeds
    at CQP only (encoder.c embedding assumes the frame QP)."""
    from video_steganography_pcamv_tpu.params import StegoParams
    from video_steganography_pcamv_tpu.stego.extract import (
        extract_from_stream)
    frames = _mixed_energy_frames(5, seed=23)
    em_rate, key = 0.5, 41
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, cabac=cabac,
               stego=StegoParams(em_rate=em_rate, key=key))
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 5
    spread = set()
    for d in dec[1:]:
        spread |= {m.qp for m in d.mbs}
    assert len(spread) >= 3, f"AQ produced no qp spread: {spread}"
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i}")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")
    got = extract_from_stream(bs, em_rate=em_rate, key=key)
    sent = enc._stego.sent_messages
    assert len(got) == len(sent) == 4
    payload = 0
    for i, (g, s) in enumerate(zip(got, sent)):
        np.testing.assert_array_equal(g, s, err_msg=f"frame {i}")
        payload += len(s)
    assert payload > 0, "no bits embedded"


@pytest.mark.parametrize("with8", [False, True])
def test_aq_with_trellis(with8):
    """AQ + trellis (--aq-mode 1 --trellis 1 [--8x8dct]): the DP
    gathers lambda2/quantizer/context tables per row at the per-MB
    QP; streams stay bit-exact through the decoder."""
    frames = _mixed_energy_frames(4, seed=29)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, trellis=1, cabac=True,
               transform_8x8=with8)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 4
    spread = set()
    for d in dec[1:]:
        spread |= {m.qp for m in d.mbs}
    assert len(spread) >= 3, f"AQ produced no qp spread: {spread}"
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i}")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")


@pytest.mark.parametrize("cabac", [False, True])
def test_aq_with_p4x4(cabac):
    """AQ + sub-8x8 partitions (--aq-mode 1 --p4x4): per-MB QP through
    the 4x4-granularity encode + the mb_qp_delta chain in both entropy
    modes (the native writers don't speak AQ — Python oracle path)."""
    frames = _mixed_energy_frames(4, seed=31)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, p4x4=True, cabac=cabac)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 4
    spread = set()
    for d in dec[1:]:
        spread |= {m.qp for m in d.mbs}
    assert len(spread) >= 3, f"AQ produced no qp spread: {spread}"
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i}")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")


def test_aq_with_device_deblock():
    """AQ + the device wavefront deblocker (the serving config):
    per-MB effective-QP maps through deblock_frame_device; decoder
    (host C++ deblock from the parsed per-MB QPs) must agree
    bit-exactly."""
    frames = _mixed_energy_frames(4, seed=37)
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, deblock_device=True)
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 4
    spread = set()
    for d in dec[1:]:
        spread |= {m.qp for m in d.mbs}
    assert len(spread) >= 3, f"AQ produced no qp spread: {spread}"
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, np.asarray(ry)[:H, :W].astype(np.uint8),
            err_msg=f"frame {i}")
        np.testing.assert_array_equal(
            d.u, np.asarray(ru)[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")


def test_aq_dqp_minus26_boundary():
    """dqp = -26 is the one legal value whose unary binarization is 52
    bins (the writer's 103-fold exempts val=52, cabac.c:288); the
    parser's overrun guard must accept it (regression: it asserted
    val < 52 and rejected conformant AQ streams)."""
    from video_steganography_pcamv_tpu.encoder.cabac import (
        CabacSliceWriter)
    from video_steganography_pcamv_tpu.decoder.cabac_dec import (
        CabacSliceParser)
    from video_steganography_pcamv_tpu.utils.bitstream import (
        BitWriter, BitReader)

    w = CabacSliceWriter(1, 1, 36, slice_is_i=False)
    w.prev_coded, w.last_dqp = 1, 3     # ctx-1 entry like a real chain
    w.qp_delta(-26, True)
    w.qp_delta(25, True)
    w.end_mb(True)
    bw = BitWriter()
    w.end_slice(bw)

    ps = CabacSliceParser(BitReader(bw.get_bytes()), 1, 1, 36,
                          slice_is_i=False)
    ps.prev_coded, ps.last_dqp = 1, 3
    assert ps.qp_delta() == -26
    assert ps.qp_delta() == 25
    assert ps.qp == (36 - 26 + 25 + 52) % 52


def test_aq_p4x4_stego():
    """AQ + sub-8x8 partitions + embedding — the final AQ combination:
    the sub stego re-encode quantizes at the pass-1 per-MB grid;
    payload blind-extracts; stream bit-exact."""
    from video_steganography_pcamv_tpu.params import StegoParams
    from video_steganography_pcamv_tpu.stego.extract import (
        extract_from_stream)
    frames = _mixed_energy_frames(5, seed=43)
    em_rate, key = 0.4, 17
    p = Params(width=W, height=H, qp=30, me_range=4, aq_mode=1,
               aq_strength=1.5, p4x4=True,
               stego=StegoParams(em_rate=em_rate, key=key))
    p.validate()
    enc = Encoder(p)
    enc.keep_recon = True
    bs = _encode_all(enc, frames)
    dec = decode_annexb(bs)
    assert len(dec) == 5
    spread = set()
    for d in dec[1:]:
        spread |= {m.qp for m in d.mbs}
    assert len(spread) >= 3, f"AQ produced no qp spread: {spread}"
    for i, d in enumerate(dec):
        ry, ru, rv = enc.recon_by_disp[i]
        np.testing.assert_array_equal(
            d.y, ry[:H, :W].astype(np.uint8), err_msg=f"frame {i}")
        np.testing.assert_array_equal(
            d.u, ru[:H // 2, :W // 2].astype(np.uint8),
            err_msg=f"frame {i} U")
    got = extract_from_stream(bs, em_rate=em_rate, key=key)
    sent = enc._stego.sent_messages
    assert len(got) == len(sent) == 4
    for i, (g, s) in enumerate(zip(got, sent)):
        np.testing.assert_array_equal(g, s, err_msg=f"frame {i}")
