"""Host-side CAVLC entropy coder.

Reference: /root/reference/encoder/cavlc.c (MB writer :288-717, residual
block writer `block_residual_write_cavlc`) and common/vlc.c tables.
Redesigned for the device pipeline: the device delivers per-MB level arrays
(already quantized, block-ordered); this module is the serial bit-exact
back half. It tracks per-4x4 total_coeff maps itself to derive the nC
context (the reference threads this through mb.cache.non_zero_count,
common/macroblock.c:914).

A C++ twin of this module lives in native/ for throughput; this Python
version is the oracle.
"""

from __future__ import annotations

import numpy as np

from ..utils.bitstream import BitWriter
from . import vlc_tables as VT
from ..ops.transform import ZIGZAG_4x4

# luma blkIdx -> (by, bx) inside MB (spec 6.4.3 inverse 4x4 luma scan)
LUMA_SCAN = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3),
             (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]
# chroma blkIdx -> (by, bx)
CHROMA_SCAN = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _b_code_uses():
    """B mb_type ue code -> (n_units, uses_l0 tuple, uses_l1 tuple)
    (spec Table 7-14; x264 mb_type_b_to_golomb + x264_mb_type_list_table,
    encoder/cavlc.c:44-49)."""
    m = {0: (1, (0,), (0,)),      # B_Direct_16x16 (mvd-free)
         1: (1, (1,), (0,)), 2: (1, (0,), (1,)), 3: (1, (1,), (1,))}
    tab16x8 = [[4, 8, 12], [10, 6, 14], [16, 18, 20]]
    tab8x16 = [[5, 9, 13], [11, 7, 15], [17, 19, 21]]
    for tab in (tab16x8, tab8x16):
        for a in range(3):
            for b in range(3):
                m[tab[a][b]] = (2,
                                (1 if a in (0, 2) else 0,
                                 1 if b in (0, 2) else 0),
                                (1 if a in (1, 2) else 0,
                                 1 if b in (1, 2) else 0))
    m[22] = (4, None, None)       # B_8x8: per-sub usage
    return m


B_CODE_USES = _b_code_uses()
# sub_mb_type ue code -> (uses_l0, uses_l1); code 0 = direct (no mvd)
B_SUB_USES = {0: (0, 0), 1: (1, 0), 2: (0, 1), 3: (1, 1)}


def _write_vlc(bw: BitWriter, code: str) -> None:
    assert code, "invalid VLC entry"
    bw.write(len(code), int(code, 2) if set(code) != {"0"} else 0)


def zigzag(block4x4: np.ndarray) -> list[int]:
    return [int(block4x4[r, c]) for r, c in ZIGZAG_4x4]


def write_residual(bw: BitWriter, levels: list[int], max_coeff: int,
                   nc: int) -> int:
    """CAVLC residual block (spec 9.2; reference encoder/cavlc.c
    block_residual_write_cavlc). `levels` in scan order, len == max_coeff.
    Returns total_coeff (for nnz tracking)."""
    nz_pos = [i for i, l in enumerate(levels) if l != 0]
    total_coeff = len(nz_pos)

    if nc == -1:
        tab = 4
    elif nc < 2:
        tab = 0
    elif nc < 4:
        tab = 1
    elif nc < 8:
        tab = 2
    else:
        tab = 3

    if total_coeff == 0:
        _write_vlc(bw, VT.COEFF0[tab])
        return 0

    # trailing ones: up to 3 consecutive |1|s at the high-frequency end
    t1s = 0
    for i in reversed(nz_pos):
        if abs(levels[i]) == 1 and t1s < 3:
            t1s += 1
        else:
            break
    _write_vlc(bw, VT.COEFF_TOKEN[tab][(total_coeff - 1) * 4 + t1s])

    # trailing one signs, high-to-low frequency
    for i in reversed(nz_pos[total_coeff - t1s:]):
        bw.write1(1 if levels[i] < 0 else 0)

    # remaining levels
    suffix_len = 1 if (total_coeff > 10 and t1s < 3) else 0
    first = True
    for k in range(total_coeff - t1s - 1, -1, -1):
        val = levels[nz_pos[k]]
        code = 2 * val - 2 if val > 0 else -2 * val - 1
        if first and t1s < 3:
            code -= 2
        first = False
        _write_level(bw, code, suffix_len)
        if suffix_len == 0:
            suffix_len = 1
        if abs(val) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    if total_coeff < max_coeff:
        tz = nz_pos[-1] + 1 - total_coeff
        if max_coeff == 4:
            _write_vlc(bw, VT.TOTAL_ZEROS_DC[total_coeff - 1][tz])
        else:
            _write_vlc(bw, VT.TOTAL_ZEROS[total_coeff - 1][tz])
        zeros_left = tz
        for k in range(total_coeff - 1, 0, -1):
            if zeros_left <= 0:
                break
            run = nz_pos[k] - nz_pos[k - 1] - 1
            _write_vlc(bw, VT.RUN_BEFORE[min(zeros_left, 7) - 1][run])
            zeros_left -= run
    return total_coeff


def _write_level(bw: BitWriter, code: int, suffix_len: int) -> None:
    """Level prefix/suffix coding (spec 9.2.2.1 inverted)."""
    if suffix_len == 0:
        if code < 14:
            bw.write(code + 1, 1)  # `code` zeros then a 1
            return
        if code < 30:
            bw.write(15, 1)  # prefix 14
            bw.write(4, code - 14)
            return
        code -= 15  # decoder adds 15 when prefix>=15 && suffix_len==0
        suffix_len_eff = 0
    else:
        suffix_len_eff = suffix_len
        if code < (15 << suffix_len):
            prefix = code >> suffix_len
            bw.write(prefix + 1, 1)
            bw.write(suffix_len, code & ((1 << suffix_len) - 1))
            return
    # escape: prefix >= 15 with suffix size prefix-3 (spec 9.2.2.1)
    prefix = 15
    while True:
        sz = prefix - 3
        base = (15 << suffix_len_eff) + (
            ((1 << (prefix - 3)) - 4096) if prefix > 15 else 0)
        if code - base < (1 << sz):
            bw.write(prefix + 1, 1)
            bw.write(sz, code - base)
            return
        prefix += 1
        assert prefix < 32, "level too large for CAVLC"


class FrameCavlc:
    """Per-frame CAVLC state: nnz context maps + bit writer glue."""

    def __init__(self, mbw: int, mbh: int, trans8_mode: bool = False):
        self.mbw, self.mbh = mbw, mbh
        self.nnz_y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.nnz_c = np.zeros((2, 2 * mbh, 2 * mbw), np.int32)
        # i4x4 mode map (2 = not i4x4-coded), mirrors the decoder's
        self.modes4 = np.full((4 * mbh, 4 * mbw), 2, np.int32)
        # PPS transform_8x8_mode_flag: I_NxN MBs then carry a
        # transform_size_8x8_flag right after mb_type (spec 7.3.5)
        self.trans8_mode = trans8_mode

    def _nc(self, arr, by, bx) -> int:
        """Neighbour context (spec 9.2.1): mean of available left/top
        total_coeff."""
        has_l, has_t = bx > 0, by > 0
        if has_l and has_t:
            return int(arr[by, bx - 1] + arr[by - 1, bx] + 1) >> 1
        if has_l:
            return int(arr[by, bx - 1])
        if has_t:
            return int(arr[by - 1, bx])
        return 0

    def write_i16x16_mb(self, bw: BitWriter, mx: int, my: int,
                        mode: int, cmode: int, cbp_luma: int,
                        cbp_chroma: int, luma_dc: np.ndarray,
                        luma_ac: np.ndarray, chroma_dc: np.ndarray,
                        chroma_ac: np.ndarray, qp_delta: int,
                        in_p_slice: bool = False,
                        in_b_slice: bool = False) -> None:
        """One I_16x16 macroblock.

        luma_dc: [4,4]; luma_ac: [4,4,4,4] (by,bx,r,c);
        chroma_dc: [2,2,2] (uv,r,c); chroma_ac: [2,2,2,4,4] (uv,by,bx,r,c).
        """
        cbp01 = 1 if cbp_luma else 0
        mb_type = 1 + mode + 4 * cbp_chroma + 12 * cbp01
        if in_p_slice:
            mb_type += 5   # P-slice intra offset (spec 7.4.5)
        elif in_b_slice:
            mb_type += 23  # B-slice intra offset (spec 7.4.5)
        bw.write_ue(mb_type)
        bw.write_ue(cmode)
        bw.write_se(qp_delta)

        # Intra16x16DCLevel: nC derived as for luma blk 0
        gy, gx = 4 * my, 4 * mx
        nc = self._nc(self.nnz_y, gy, gx)
        write_residual(bw, zigzag(luma_dc), 16, nc)

        # AC blocks (15 coeffs) if cbp_luma
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma:
                nc = self._nc(self.nnz_y, yy, xx)
                lv = zigzag(luma_ac[by, bx])[1:]
                self.nnz_y[yy, xx] = write_residual(bw, lv, 15, nc)
            else:
                self.nnz_y[yy, xx] = 0

        self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc, chroma_ac)

    def write_i4x4_mb(self, bw: BitWriter, mx: int, my: int,
                      modes: np.ndarray, cmode: int, cbp_luma: int,
                      cbp_chroma: int, luma_blocks: np.ndarray,
                      chroma_dc: np.ndarray, chroma_ac: np.ndarray,
                      qp_delta: int, in_p_slice: bool = False,
                      in_b_slice: bool = False) -> None:
        """One I_NxN (Intra_4x4) macroblock (spec 7.3.5.1; reference
        encoder/cavlc.c I_4x4 path).

        modes: [16] z-scan block modes; luma_blocks: [4,4,4,4]
        (by,bx,r,c) full 16-coeff blocks.
        """
        # mb_type I_NxN: ue 0 in I, 5 in P, 23 in B (spec 7.4.5)
        bw.write_ue(23 if in_b_slice else (5 if in_p_slice else 0))
        if self.trans8_mode:
            bw.write1(0)                      # transform_size_8x8_flag
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            gy4, gx4 = 4 * my + by, 4 * mx + bx
            mode = int(modes[blk])
            if gx4 == 0 or gy4 == 0:
                pm = 2
            else:
                pm = int(min(self.modes4[gy4, gx4 - 1],
                             self.modes4[gy4 - 1, gx4]))
            if mode == pm:
                bw.write1(1)
            else:
                bw.write1(0)
                bw.write(3, mode - (1 if mode > pm else 0))
            self.modes4[gy4, gx4] = mode
        bw.write_ue(cmode)
        cbp = (cbp_chroma << 4) | cbp_luma
        bw.write_ue(VT.CBP_INTRA_TO_GOLOMB[cbp])
        if cbp:
            bw.write_se(qp_delta)
        gy, gx = 4 * my, 4 * mx
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma & (1 << (blk >> 2)):
                nc = self._nc(self.nnz_y, yy, xx)
                lv = zigzag(luma_blocks[by, bx])
                self.nnz_y[yy, xx] = write_residual(bw, lv, 16, nc)
            else:
                self.nnz_y[yy, xx] = 0
        self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc, chroma_ac)

    def write_i8x8_mb(self, bw: BitWriter, mx: int, my: int,
                      modes8, cmode: int, cbp_luma: int,
                      cbp_chroma: int, luma8_lev, chroma_dc,
                      chroma_ac, qp_delta: int,
                      in_p_slice: bool = False) -> None:
        """One I_NxN (Intra_8x8) macroblock (spec 7.3.5/7.4.5.3.3 with
        transform_size_8x8_flag = 1; reference encoder/cavlc.c High
        path). modes8: [4] z-order 8x8 modes; luma8_lev: [2,2,8,8].
        CAVLC splits each 8x8 into four interleaved 4x4 blocks: sub
        block j carries zigzag8 positions 4k + j; each sub-block's
        TotalCoeff lands in its 4x4 nnz cell (spec 9.2.1)."""
        from ..ops.transform8 import ZIGZAG_8x8
        assert self.trans8_mode
        bw.write_ue(5 if in_p_slice else 0)   # mb_type I_NxN
        bw.write1(1)                          # transform_size_8x8_flag
        for b, (by8, bx8) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            gy4, gx4 = 4 * my + 2 * by8, 4 * mx + 2 * bx8
            mode = int(modes8[b])
            if gx4 == 0 or gy4 == 0:
                pm = 2
            else:
                pm = int(min(self.modes4[gy4, gx4 - 1],
                             self.modes4[gy4 - 1, gx4]))
            if mode == pm:
                bw.write1(1)
            else:
                bw.write1(0)
                bw.write(3, mode - (1 if mode > pm else 0))
            # replicate into the 2x2 ctx cells (x264 cache layout)
            self.modes4[gy4:gy4 + 2, gx4:gx4 + 2] = mode
        bw.write_ue(cmode)
        cbp = (cbp_chroma << 4) | cbp_luma
        bw.write_ue(VT.CBP_INTRA_TO_GOLOMB[cbp])
        if cbp:
            bw.write_se(qp_delta)
        self._write_luma8(bw, mx, my, cbp_luma, luma8_lev)
        self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc, chroma_ac)

    def _write_luma8(self, bw: BitWriter, mx: int, my: int,
                     cbp_luma: int, luma8_lev) -> None:
        """8x8-transform luma residual: four interleaved 4x4 CAVLC
        blocks per coded 8x8 (spec 7.4.5.3.3 level8x8 split)."""
        from ..ops.transform8 import ZIGZAG_8x8
        zz = ZIGZAG_8x8
        for b, (by8, bx8) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            blk8 = np.asarray(luma8_lev[by8, bx8])
            scan = blk8[zz[:, 0], zz[:, 1]]          # [64] zigzag order
            for j, (sy, sx) in enumerate([(0, 0), (0, 1), (1, 0),
                                          (1, 1)]):
                yy = 4 * my + 2 * by8 + sy
                xx = 4 * mx + 2 * bx8 + sx
                if cbp_luma & (1 << b):
                    lv = [int(x) for x in scan[j::4]]  # interleave 4k+j
                    nc = self._nc(self.nnz_y, yy, xx)
                    self.nnz_y[yy, xx] = write_residual(bw, lv, 16, nc)
                else:
                    self.nnz_y[yy, xx] = 0

    def write_p16x16_mb(self, bw: BitWriter, mx: int, my: int,
                        mvd: tuple, cbp_luma: int, cbp_chroma: int,
                        luma_lev: np.ndarray, chroma_dc: np.ndarray,
                        chroma_ac: np.ndarray, qp_delta: int) -> None:
        """P_L0_16x16 macroblock (reference: encoder/cavlc.c:288-600 P
        path). luma_lev: [4,4,4,4] (by,bx,r,c) 16-coeff blocks."""
        bw.write_ue(0)  # mb_type P_L0_16x16
        # ref_idx_l0 absent with a single active reference
        bw.write_se(int(mvd[0]))
        bw.write_se(int(mvd[1]))
        cbp = (cbp_chroma << 4) | cbp_luma
        bw.write_ue(VT.CBP_INTER_TO_GOLOMB[cbp])
        # mandatory flag under PPS transform mode (this path never
        # chooses the 8x8 transform)
        if self.trans8_mode and cbp_luma:
            bw.write1(0)
        if cbp:
            bw.write_se(qp_delta)
        gy, gx = 4 * my, 4 * mx
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma & (1 << (blk >> 2)):
                nc = self._nc(self.nnz_y, yy, xx)
                lv = zigzag(luma_lev[by, bx])
                self.nnz_y[yy, xx] = write_residual(bw, lv, 16, nc)
            else:
                self.nnz_y[yy, xx] = 0
        if cbp:
            self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc, chroma_ac)
        else:
            self.set_mb_nnz_zero(mx, my, luma_too=False)

    def _write_te_ref(self, bw: BitWriter, ref: int, num_ref: int):
        """ref_idx_l0 te(v) (spec 9.1.1): inverted single bit when the
        range is 0..1, else ue(v)."""
        if num_ref <= 1:
            return
        if num_ref == 2:
            bw.write1(1 - ref)
        else:
            bw.write_ue(ref)

    def write_p_mb(self, bw: BitWriter, mx: int, my: int, part: int,
                   mvds: np.ndarray, cbp_luma: int, cbp_chroma: int,
                   luma_lev: np.ndarray, chroma_dc: np.ndarray,
                   chroma_ac: np.ndarray, qp_delta: int,
                   sub_types=None, refs=None, num_ref: int = 1,
                   trans8: bool = False, luma8_lev=None) -> None:
        """Partitioned P macroblock (spec 7.3.5.2). mvds: [U,2] unit
        mvds in coding order (U up to 16; unused slots ignored).
        sub_types: [4] sub_mb_type per 8x8 block (None = all
        P_L0_8x8); refs: per-ref_idx-slot L0 refs in coding order
        (one per partition for parts 0-2, one per 8x8 block for
        P_8x8), written when num_ref > 1."""
        from .scan import N_SUB
        bw.write_ue(part)
        if part == 3:
            n_units = 0
            n_refs = 4
            for b in range(4):
                st = 0 if sub_types is None else int(sub_types[b])
                bw.write_ue(st)  # sub_mb_type (7.4.5.2 P table)
                n_units += N_SUB[st]
        else:
            n_units = (1, 2, 2)[part]
            n_refs = n_units
        if num_ref > 1:
            for k in range(n_refs):
                self._write_te_ref(bw, 0 if refs is None
                                   else int(refs[k]), num_ref)
        for u in range(n_units):
            bw.write_se(int(mvds[u, 0]))
            bw.write_se(int(mvds[u, 1]))
        cbp = (cbp_chroma << 4) | cbp_luma
        bw.write_ue(VT.CBP_INTER_TO_GOLOMB[cbp])
        # transform_size_8x8_flag between cbp and dqp (spec 7.3.5: only
        # when luma residual exists AND no sub-partition is < 8x8
        # (noSubMbPartSizeLessThan8x8Flag; sub_mb_type 0 is P_L0_8x8)
        t8_present = sub_types is None \
            or all(int(s) == 0 for s in sub_types)
        if self.trans8_mode and cbp_luma and t8_present:
            bw.write1(1 if trans8 else 0)
        if cbp:
            bw.write_se(qp_delta)
        if trans8 and cbp_luma:
            self._write_luma8(bw, mx, my, cbp_luma, luma8_lev)
        else:
            gy, gx = 4 * my, 4 * mx
            for blk in range(16):
                by, bx = LUMA_SCAN[blk]
                yy, xx = gy + by, gx + bx
                if cbp_luma & (1 << (blk >> 2)):
                    nc = self._nc(self.nnz_y, yy, xx)
                    lv = zigzag(luma_lev[by, bx])
                    self.nnz_y[yy, xx] = write_residual(bw, lv, 16, nc)
                else:
                    self.nnz_y[yy, xx] = 0
        if cbp:
            self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc, chroma_ac)
        else:
            self.set_mb_nnz_zero(mx, my, luma_too=False)

    def write_b_mb(self, bw: BitWriter, mx: int, my: int, btype: int,
                   mvd0, mvd1, cbp_luma: int, cbp_chroma: int,
                   luma_lev: np.ndarray, chroma_dc: np.ndarray,
                   chroma_ac: np.ndarray, qp_delta: int,
                   subs=None, ref0: int = 0,
                   num_ref: int = 1) -> None:
        """B macroblock (spec 7.4.5 Table 7-14: the ue code is passed
        directly — 0 direct, 1-3 16x16 L0/L1/BI, 4-21 two-partition
        list combos, 22 B_8x8; reference encoder/cavlc.c:463-560).
        mvd0/mvd1: per-unit (x, y) pairs in coding order — [2] for the
        16x16 subset (back-compat) or [U, 2]; subs: [4] sub_mb_type ue
        codes for B_8x8. Syntax order: ref_idx_l0 (multi-ref B lists,
        16x16 L0/BI only, num_ref > 1), then all L0 mvds, then all L1
        mvds (cavlc.c:515-556); direct units carry no mvd."""
        bw.write_ue(btype)
        mvd0 = np.asarray(mvd0).reshape(-1, 2)
        mvd1 = np.asarray(mvd1).reshape(-1, 2)
        if num_ref > 1 and btype in (1, 3):
            bw.write_te(num_ref - 1, int(ref0))
        if btype == 22:
            for b in range(4):
                bw.write_ue(int(subs[b]))   # sub_mb_type (Table 7-18)
            if num_ref > 1:
                # ref_idx_l0 per non-direct L0-using 8x8 (spec
                # 7.3.5.2 sub_mb_pred order: refs before mvds)
                for b in range(4):
                    sb = int(subs[b])
                    if sb != 0 and B_SUB_USES[sb][0]:
                        bw.write_te(num_ref - 1, int(ref0))
            for mvd, li in ((mvd0, 0), (mvd1, 1)):
                for b in range(4):
                    if B_SUB_USES[int(subs[b])][li]:
                        bw.write_se(int(mvd[b, 0]))
                        bw.write_se(int(mvd[b, 1]))
        else:
            n_units, u0, u1 = B_CODE_USES[btype]
            if num_ref > 1 and btype > 3:
                # ref_idx_l0 per L0-using partition (spec 7.3.5.1
                # mb_pred order: all refs before all mvds)
                for u in range(n_units):
                    if u0[u]:
                        bw.write_te(num_ref - 1, int(ref0))
            for mvd, uses in ((mvd0, u0), (mvd1, u1)):
                for u in range(n_units):
                    if uses[u]:
                        bw.write_se(int(mvd[u, 0]))
                        bw.write_se(int(mvd[u, 1]))
        cbp = (cbp_chroma << 4) | cbp_luma
        bw.write_ue(VT.CBP_INTER_TO_GOLOMB[cbp])
        # transform_size_8x8_flag is mandatory syntax for coded B MBs
        # with luma residual under PPS transform mode (spec 7.3.5;
        # B MBs never choose the 8x8 transform yet -> flag 0)
        if self.trans8_mode and cbp_luma:
            bw.write1(0)
        if cbp:
            bw.write_se(qp_delta)
        gy, gx = 4 * my, 4 * mx
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma & (1 << (blk >> 2)):
                nc = self._nc(self.nnz_y, yy, xx)
                lv = zigzag(luma_lev[by, bx])
                self.nnz_y[yy, xx] = write_residual(bw, lv, 16, nc)
            else:
                self.nnz_y[yy, xx] = 0
        if cbp:
            self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc,
                               chroma_ac)
        else:
            self.set_mb_nnz_zero(mx, my, luma_too=False)

    def set_mb_nnz_zero(self, mx: int, my: int, luma_too: bool = True):
        """Clear nnz context for a skipped (or residual-free) MB."""
        if luma_too:
            self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0

    def _write_chroma(self, bw, mx, my, cbp_chroma, chroma_dc, chroma_ac):
        gy, gx = 2 * my, 2 * mx
        if cbp_chroma:
            for ch in range(2):
                dc = chroma_dc[ch]
                lv = [int(dc[0, 0]), int(dc[0, 1]), int(dc[1, 0]),
                      int(dc[1, 1])]
                write_residual(bw, lv, 4, -1)
        for ch in range(2):
            for blk in range(4):
                by, bx = CHROMA_SCAN[blk]
                yy, xx = gy + by, gx + bx
                if cbp_chroma == 2:
                    nc = self._nc(self.nnz_c[ch], yy, xx)
                    lv = zigzag(chroma_ac[ch, by, bx])[1:]
                    self.nnz_c[ch, yy, xx] = write_residual(bw, lv, 15, nc)
                else:
                    self.nnz_c[ch, yy, xx] = 0
