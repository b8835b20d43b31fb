"""ctypes loader for the native host back-end (libpcamv_native.so).

The library is built from this directory's sources with its Makefile
on first use, into `build/` (ignored by git; `-march=native`, so it
is built on the host that runs it). Plain C ABI + ctypes, no pybind11.
`load()` returns None when the build fails, after printing the
compiler's error; `build_error` keeps it. Callers then use the Python
oracles, and `chip_smoke.py` fails.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "build")
_LIB = os.path.join(_BUILD, "libpcamv_native.so")
_SRCS = ("pcamv_native.cpp", "deblock.cpp", "cabac.cpp")
_lib = None
_tried = False
build_error: str | None = None


def _stale() -> bool:
    return (not os.path.exists(_LIB)
            or any(os.path.getmtime(_LIB)
                   < os.path.getmtime(os.path.join(_DIR, s))
                   for s in _SRCS))


def _build() -> bool:
    """Run the Makefile under a file lock (parallel test workers all
    reach the first load at once)."""
    global build_error
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return True
        try:
            r = subprocess.run(["make", "-C", _DIR, "-s"],
                               capture_output=True, text=True, timeout=300)
            err = r.stderr[-2000:] if r.returncode else None
        except (OSError, subprocess.TimeoutExpired) as e:
            err = repr(e)
    if err is not None:
        build_error = err
        print("pcamv native build failed:\n" + err, file=sys.stderr)
        return False
    return True


def load():
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if _stale() and not _build():
        return None
    lib = ctypes.CDLL(_LIB)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.pcamv_write_slice.restype = ctypes.c_long
    lib.pcamv_write_slice.argtypes = [
        u8p, ctypes.c_long, u8p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        i32p, i32p, ctypes.c_void_p, i32p, i32p, i32p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int]

    lib.pcamv_write_slice_b.restype = ctypes.c_long
    lib.pcamv_write_slice_b.argtypes = [
        u8p, ctypes.c_long, u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p]

    lib.pcamv_write_slice_cabac_b.restype = ctypes.c_long
    lib.pcamv_write_slice_cabac_b.argtypes = [
        u8p, ctypes.c_long, u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p]

    lib.pcamv_host_scan_p.restype = None
    lib.pcamv_host_scan_p.argtypes = [i32p, i32p, i32p, ctypes.c_int,
                                      ctypes.c_int, u8p, i32p, i32p]
    lib.pcamv_host_scan_p_forced.restype = None
    lib.pcamv_host_scan_p_forced.argtypes = [i32p, u8p, ctypes.c_int,
                                             ctypes.c_int, i32p, i32p]
    lib.pcamv_scan_p_parts.restype = None
    lib.pcamv_scan_p_parts.argtypes = [i32p, i32p, i32p, i32p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p,
                                       u8p, i32p, i32p, i32p,
                                       ctypes.c_void_p]
    lib.pcamv_scan_p_parts_forced.restype = None
    lib.pcamv_scan_p_parts_forced.argtypes = [i32p, i32p, u8p,
                                              ctypes.c_int, ctypes.c_int,
                                              i32p, i32p, i32p,
                                              ctypes.c_void_p]
    lib.pcamv_deblock_frame.restype = None
    lib.pcamv_deblock_frame.argtypes = [
        u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, u8p, i32p, i32p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.pcamv_write_slice_cabac.restype = ctypes.c_long
    lib.pcamv_write_slice_cabac.argtypes = [
        u8p, ctypes.c_long, u8p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, i32p, i32p,
        ctypes.c_void_p, i32p, i32p, i32p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int]
    lib.pcamv_stc_embed.restype = ctypes.c_int
    lib.pcamv_stc_embed.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint32),
                                    u8p, ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def _as_i32(x):
    return np.ascontiguousarray(x, np.int32)


def write_slice(header_bytes: bytes, header_nbits: int, slice_type: int,
                mbw: int, mbh: int, *, skip=None, mvd=None, mode=None,
                cmode=None, cbp_luma, cbp_chroma, luma_dc=None,
                luma_blocks, chroma_dc, chroma_ac, mb_i4=None,
                i4_modes=None, part=None, mvd4=None, refs=None,
                num_ref: int = 1, sub_type=None, mb_i8=None,
                i8_modes=None, luma8_lev=None, trans8=None,
                trans8_mode: bool = False) -> bytes:
    """Native whole-slice entropy coding. Shapes:
    luma_blocks [N,16,16], luma_dc [N,16], chroma_dc [N,2,4],
    chroma_ac [N,2,4,16], mvd [N,2], mb_i4 [N] u8, i4_modes [N,16].
    High-profile 8x8: mb_i8 [N] u8, i8_modes [N,4], luma8_lev
    [N,2,2,8,8] raster (zigzag-scanned here), trans8 [N] u8."""
    lib = load()
    n = mbw * mbh
    cap = 1 << 22
    while True:
        out = np.zeros(cap, np.uint8)
        hdr = np.frombuffer(header_bytes + b"\0" * 8, np.uint8).copy()

        def ptr(a):
            if a is None:
                return None
            return a.ctypes.data_as(ctypes.c_void_p)

        skip_a = (np.ascontiguousarray(skip, np.uint8)
                  if skip is not None else None)
        mvd_a = _as_i32(mvd) if mvd is not None else None
        mode_a = _as_i32(mode) if mode is not None else None
        cmode_a = _as_i32(cmode) if cmode is not None else None
        dc_a = _as_i32(luma_dc) if luma_dc is not None else None
        i4_a = (np.ascontiguousarray(mb_i4, np.uint8)
                if mb_i4 is not None else None)
        i4m_a = (_as_i32(i4_modes).reshape(n * 16)
                 if i4_modes is not None else None)
        part_a = _as_i32(part).reshape(n) if part is not None else None
        stride = 16 if sub_type is not None else 4
        mvd4_a = (_as_i32(mvd4).reshape(n * 2 * stride)
                  if mvd4 is not None else None)
        refs_a = (_as_i32(refs).reshape(n * 4)
                  if refs is not None else None)
        sub_a = (_as_i32(sub_type).reshape(n * 4)
                 if sub_type is not None else None)
        i8_a = (np.ascontiguousarray(mb_i8, np.uint8)
                if mb_i8 is not None else None)
        i8m_a = (_as_i32(i8_modes).reshape(n * 4)
                 if i8_modes is not None else None)
        l8_a = None
        if luma8_lev is not None:
            from ..ops.transform8 import ZIGZAG_8x8
            zz = np.asarray(ZIGZAG_8x8)
            blocks8 = _as_i32(luma8_lev).reshape(n, 4, 8, 8)
            l8_a = np.ascontiguousarray(
                blocks8[:, :, zz[:, 0], zz[:, 1]].reshape(n * 256))
        t8_a = (np.ascontiguousarray(trans8, np.uint8)
                if trans8 is not None else None)
        r = lib.pcamv_write_slice(
            out, cap, hdr, header_nbits, slice_type, mbw, mbh,
            ptr(skip_a), ptr(mvd_a), ptr(mode_a), ptr(cmode_a),
            _as_i32(cbp_luma).reshape(n), _as_i32(cbp_chroma).reshape(n),
            ptr(dc_a), _as_i32(luma_blocks).reshape(n * 256),
            _as_i32(chroma_dc).reshape(n * 8),
            _as_i32(chroma_ac).reshape(n * 128),
            ptr(i4_a), ptr(i4m_a), ptr(part_a), ptr(mvd4_a),
            ptr(refs_a), num_ref, ptr(sub_a), stride,
            ptr(i8_a), ptr(i8m_a), ptr(l8_a), ptr(t8_a),
            1 if trans8_mode else 0)
        if r >= 0:
            return bytes(out[:r])
        cap *= 4
        if cap > (1 << 28):
            raise RuntimeError("native slice writer overflow")


def host_scan_p(mv, cbp_luma, cbp_chroma):
    lib = load()
    mbh, mbw = cbp_luma.shape
    skip = np.zeros(mbh * mbw, np.uint8)
    mvd = np.zeros(mbh * mbw * 2, np.int32)
    mvp = np.zeros(mbh * mbw * 2, np.int32)
    lib.pcamv_host_scan_p(_as_i32(mv).reshape(-1),
                          _as_i32(cbp_luma).reshape(-1),
                          _as_i32(cbp_chroma).reshape(-1),
                          mbw, mbh, skip, mvd, mvp)
    return (skip.reshape(mbh, mbw).astype(bool),
            mvd.reshape(mbh, mbw, 2), mvp.reshape(mbh, mbw, 2))


def write_slice_cabac(header_bytes: bytes, header_nbits: int,
                      slice_type: int, mbw: int, mbh: int, qp: int, *,
                      model: int = 0, skip=None, part=None, mvd4=None,
                      mode=None, cmode=None, cbp_luma, cbp_chroma,
                      luma_dc=None, luma_blocks, chroma_dc, chroma_ac,
                      mb_i4=None, i4_modes=None, refs=None,
                      num_ref: int = 1, sub_type=None, mb_i8=None,
                      i8_modes=None, luma8_lev=None, trans8=None,
                      trans8_mode: bool = False) -> bytes:
    """Native CABAC whole-slice entropy coding (twin of
    encoder/cabac.py's CabacSliceWriter; bit-identical)."""
    lib = load()
    n = mbw * mbh
    cap = 1 << 22
    while True:
        out = np.zeros(cap, np.uint8)
        hdr = np.frombuffer(header_bytes + b"\0" * 8, np.uint8).copy()

        def ptr(a):
            return (a.ctypes.data_as(ctypes.c_void_p)
                    if a is not None else None)

        skip_a = (np.ascontiguousarray(skip, np.uint8)
                  if skip is not None else None)
        part_a = _as_i32(part).reshape(n) if part is not None else None
        stride = 16 if sub_type is not None else 4
        mvd4_a = (_as_i32(mvd4).reshape(n * 2 * stride)
                  if mvd4 is not None else None)
        sub_a = (_as_i32(sub_type).reshape(n * 4)
                 if sub_type is not None else None)
        mode_a = _as_i32(mode).reshape(n) if mode is not None else None
        cmode_a = (_as_i32(cmode).reshape(n)
                   if cmode is not None else None)
        dc_a = (_as_i32(luma_dc).reshape(n * 16)
                if luma_dc is not None else None)
        i4_a = (np.ascontiguousarray(mb_i4, np.uint8)
                if mb_i4 is not None else None)
        i4m_a = (_as_i32(i4_modes).reshape(n * 16)
                 if i4_modes is not None else None)
        refs_a = (_as_i32(refs).reshape(n * 4)
                  if refs is not None else None)
        i8_a = (np.ascontiguousarray(mb_i8, np.uint8)
                if mb_i8 is not None else None)
        i8m_a = (_as_i32(i8_modes).reshape(n * 4)
                 if i8_modes is not None else None)
        l8_a = (_as_i32(luma8_lev).reshape(n * 256)
                if luma8_lev is not None else None)
        t8_a = (_as_i32(trans8).reshape(n)
                if trans8 is not None else None)
        r = lib.pcamv_write_slice_cabac(
            out, cap, hdr, header_nbits, slice_type, mbw, mbh, qp,
            model, ptr(skip_a), ptr(part_a), ptr(mvd4_a), ptr(mode_a),
            ptr(cmode_a),
            _as_i32(cbp_luma).reshape(n), _as_i32(cbp_chroma).reshape(n),
            ptr(dc_a), _as_i32(luma_blocks).reshape(n * 256),
            _as_i32(chroma_dc).reshape(n * 8),
            _as_i32(chroma_ac).reshape(n * 128),
            ptr(i4_a), ptr(i4m_a), ptr(refs_a), num_ref,
            ptr(sub_a), stride,
            ptr(i8_a), ptr(i8m_a), ptr(l8_a), ptr(t8_a),
            1 if trans8_mode else 0)
        if r >= 0:
            return bytes(out[:r])
        cap *= 4
        if cap > (1 << 28):
            raise RuntimeError("native cabac writer overflow")


def write_slice_b(header_bytes: bytes, header_nbits: int, mbw: int,
                  mbh: int, *, mode, mvd0, mvd1, cbp_luma, cbp_chroma,
                  luma_blocks, chroma_dc, chroma_ac) -> bytes:
    """Native CAVLC B slice (twin of core.py _write_b_slice_cavlc)."""
    lib = load()
    n = mbw * mbh
    cap = 1 << 22
    while True:
        out = np.zeros(cap, np.uint8)
        hdr = np.frombuffer(header_bytes + b"\0" * 8, np.uint8).copy()
        r = lib.pcamv_write_slice_b(
            out, cap, hdr, header_nbits, mbw, mbh,
            _as_i32(mode).reshape(n), _as_i32(mvd0).reshape(n * 2),
            _as_i32(mvd1).reshape(n * 2),
            _as_i32(cbp_luma).reshape(n), _as_i32(cbp_chroma).reshape(n),
            _as_i32(luma_blocks).reshape(n * 256),
            _as_i32(chroma_dc).reshape(n * 8),
            _as_i32(chroma_ac).reshape(n * 128))
        if r >= 0:
            return bytes(out[:r])
        cap *= 4
        if cap > (1 << 28):
            raise RuntimeError("native B slice writer overflow")


def write_slice_cabac_b(header_bytes: bytes, header_nbits: int,
                        mbw: int, mbh: int, qp: int, *, model: int = 0,
                        mode, mvd0, mvd1, cbp_luma, cbp_chroma,
                        luma_blocks, chroma_dc, chroma_ac) -> bytes:
    """Native CABAC B slice (twin of core.py _write_b_slice_cabac)."""
    lib = load()
    n = mbw * mbh
    cap = 1 << 22
    while True:
        out = np.zeros(cap, np.uint8)
        hdr = np.frombuffer(header_bytes + b"\0" * 8, np.uint8).copy()
        r = lib.pcamv_write_slice_cabac_b(
            out, cap, hdr, header_nbits, mbw, mbh, qp, model,
            _as_i32(mode).reshape(n), _as_i32(mvd0).reshape(n * 2),
            _as_i32(mvd1).reshape(n * 2),
            _as_i32(cbp_luma).reshape(n), _as_i32(cbp_chroma).reshape(n),
            _as_i32(luma_blocks).reshape(n * 256),
            _as_i32(chroma_dc).reshape(n * 8),
            _as_i32(chroma_ac).reshape(n * 128))
        if r >= 0:
            return bytes(out[:r])
        cap *= 4
        if cap > (1 << 28):
            raise RuntimeError("native CABAC B writer overflow")


def scan_p_parts(part, mv8, cbp_luma, cbp_chroma, intra=None, ref8=None):
    """Native partition-aware scan (twin of encoder/scan.py
    scan_p_frame). Returns (skip, mvd [mbh,mbw,4,2], mvp, final8)."""
    lib = load()
    mbh, mbw = part.shape
    skip = np.zeros(mbh * mbw, np.uint8)
    mvd = np.zeros(mbh * mbw * 8, np.int32)
    mvp = np.zeros(mbh * mbw * 8, np.int32)
    final8 = np.zeros(2 * mbh * 2 * mbw * 2, np.int32)
    intra_a = (np.ascontiguousarray(intra, np.uint8).reshape(-1)
               if intra is not None else None)
    intra_p = (intra_a.ctypes.data_as(ctypes.c_void_p)
               if intra_a is not None else None)
    ref8_a = (_as_i32(ref8).reshape(-1) if ref8 is not None else None)
    ref8_p = (ref8_a.ctypes.data_as(ctypes.c_void_p)
              if ref8_a is not None else None)
    lib.pcamv_scan_p_parts(
        _as_i32(part).reshape(-1), _as_i32(mv8).reshape(-1),
        _as_i32(cbp_luma).reshape(-1), _as_i32(cbp_chroma).reshape(-1),
        mbw, mbh, intra_p, skip, mvd, mvp, final8, ref8_p)
    return (skip.reshape(mbh, mbw).astype(bool),
            mvd.reshape(mbh, mbw, 4, 2), mvp.reshape(mbh, mbw, 4, 2),
            final8.reshape(2 * mbh, 2 * mbw, 2))


def scan_p_parts_forced(part, mv8, skip, ref8=None):
    """Native forced scan (twin of scan.py scan_p_frame_forced).
    Returns (final8, mvd, mvp)."""
    lib = load()
    mbh, mbw = part.shape
    final8 = np.zeros(2 * mbh * 2 * mbw * 2, np.int32)
    mvd = np.zeros(mbh * mbw * 8, np.int32)
    mvp = np.zeros(mbh * mbw * 8, np.int32)
    ref8_a = (_as_i32(ref8).reshape(-1) if ref8 is not None else None)
    ref8_p = (ref8_a.ctypes.data_as(ctypes.c_void_p)
              if ref8_a is not None else None)
    lib.pcamv_scan_p_parts_forced(
        _as_i32(part).reshape(-1), _as_i32(mv8).reshape(-1),
        np.ascontiguousarray(skip, np.uint8).reshape(-1), mbw, mbh,
        final8, mvd, mvp, ref8_p)
    return (final8.reshape(2 * mbh, 2 * mbw, 2),
            mvd.reshape(mbh, mbw, 4, 2), mvp.reshape(mbh, mbw, 4, 2))


def host_scan_p_forced(mv, skip):
    lib = load()
    mbh, mbw = skip.shape
    fmv = np.zeros(mbh * mbw * 2, np.int32)
    mvd = np.zeros(mbh * mbw * 2, np.int32)
    lib.pcamv_host_scan_p_forced(
        _as_i32(mv).reshape(-1), np.ascontiguousarray(skip, np.uint8)
        .reshape(-1), mbw, mbh, fmv, mvd)
    return fmv.reshape(mbh, mbw, 2), mvd.reshape(mbh, mbw, 2)


def deblock_frame(y, u, v, intra, nnz4, mv, skip, qp, qpc, ref4=None,
                  trans8=None, alpha_off=0, beta_off=0, qp_map=None,
                  qpc_map=None, chroma_qp_offset=0,
                  mv_l1=None, ref4_l1=None):
    """In-place H.264 deblocking of uint8 planes.

    y/u/v: MB-padded planes (modified in place); intra: [mbh,mbw] uint8;
    nnz4: [4mbh,4mbw] int32 luma 4x4 total_coeff; mv: [4mbh,4mbw,2]
    int32 (4x4 granularity — partition-aware bS) or [mbh,mbw,2] which
    is upsampled; skip: [mbh,mbw] uint8 or None; ref4: optional
    [4mbh,4mbw] int32 L0 refs (different-ref bS rule, spec 8.7.2.1);
    qp_map/qpc_map: optional [mbh,mbw] int32 per-MB QPY/QPC (adaptive
    quantization — MB edges use the spec 8.7.2.2 qPav average)."""
    lib = load()
    mbh, mbw = intra.shape
    mv = np.asarray(mv)
    if mv.shape[:2] == (mbh, mbw):
        mv = np.repeat(np.repeat(mv, 4, 0), 4, 1)
    assert mv.shape == (4 * mbh, 4 * mbw, 2), mv.shape
    assert y.dtype == np.uint8 and y.flags["C_CONTIGUOUS"]
    skip_a = (np.ascontiguousarray(skip, np.uint8)
              if skip is not None else None)
    skip_p = (skip_a.ctypes.data_as(ctypes.c_void_p)
              if skip_a is not None else None)
    ref_a = (_as_i32(ref4).reshape(-1) if ref4 is not None else None)
    ref_p = (ref_a.ctypes.data_as(ctypes.c_void_p)
             if ref_a is not None else None)
    t8_a = (np.ascontiguousarray(trans8, np.uint8)
            if trans8 is not None else None)
    t8_p = (t8_a.ctypes.data_as(ctypes.c_void_p)
            if t8_a is not None else None)
    qpm_a = _as_i32(qp_map).reshape(-1) if qp_map is not None else None
    qpm_p = (qpm_a.ctypes.data_as(ctypes.c_void_p)
             if qpm_a is not None else None)
    qpcm_a = _as_i32(qpc_map).reshape(-1) if qpc_map is not None else None
    qpcm_p = (qpcm_a.ctypes.data_as(ctypes.c_void_p)
              if qpcm_a is not None else None)
    assert (qpm_p is None) == (qpcm_p is None)
    # B slices: second-list motion for the spec 8.7.2.1 two-list bS
    # (reference frame.c:735-741); unused-list cells ref=-1 / mv=0
    mv1_a = None
    if mv_l1 is not None:
        mv1_a = np.asarray(mv_l1)
        if mv1_a.shape[:2] == (mbh, mbw):
            mv1_a = np.repeat(np.repeat(mv1_a, 4, 0), 4, 1)
        mv1_a = _as_i32(mv1_a).reshape(-1)
    mv1_p = (mv1_a.ctypes.data_as(ctypes.c_void_p)
             if mv1_a is not None else None)
    ref1_a = (_as_i32(ref4_l1).reshape(-1)
              if ref4_l1 is not None else None)
    ref1_p = (ref1_a.ctypes.data_as(ctypes.c_void_p)
              if ref1_a is not None else None)
    lib.pcamv_deblock_frame(
        y, u, v, mbw, mbh,
        np.ascontiguousarray(intra, np.uint8),
        _as_i32(nnz4).reshape(-1), _as_i32(mv).reshape(-1), ref_p,
        skip_p, qp, qpc, t8_p, int(alpha_off), int(beta_off),
        qpm_p, qpcm_p, int(chroma_qp_offset), mv1_p, ref1_p)


def stc_embed(cover, message, rho, h=10, state=None):
    """Reference-parity STC (embed.h:309-548). `state` is a
    stego.stc.StcState whose persistent LCG word is advanced in place
    (the reference's static myholdrand, embed.h:134)."""
    from ..stego.stc import StcState
    lib = load()
    if state is None:
        state = StcState()
    cover = np.ascontiguousarray(cover, np.uint8)
    message = np.ascontiguousarray(message, np.uint8)
    rho32 = np.ascontiguousarray(rho, np.float32)
    stego = np.zeros(len(cover), np.uint8)
    cost = ctypes.c_double(0.0)
    hold = ctypes.c_uint32(state.holdrand & 0xFFFFFFFF)
    r = lib.pcamv_stc_embed(
        cover, len(cover), message, len(message),
        rho32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h,
        ctypes.byref(hold), stego, ctypes.byref(cost))
    state.holdrand = int(hold.value)
    if r != 0:
        raise ValueError(f"stc_embed native error {r}")
    return stego, float(cost.value)
