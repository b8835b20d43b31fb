"""Minimal, spec-literal CABAC decoder for a pure-I16 H.264 I-slice.

Kept as a permanent referee: when the repo encoder+decoder agree with
each other but an external decoder disagrees, this file (written
directly from ITU-T H.264 9.3, sharing NOTHING with the production
code path except the normative constant tables) arbitrates bin by bin.
Used to root-cause the round-3 coded_block_flag ctx bug. Pair with an
instrumented CabacSliceParser to diff (ctx, bit) logs.

Written directly from ITU-T H.264 (2003) sections 9.3.3.2 (arithmetic
decode), 9.3.3.1 (ctx derivation), 9.3.2 (binarization), 7.3.5/7.4.5
(MB layer). Used as an independent referee between the repo's encoder
and FFmpeg. Assumes: CABAC, I slice, all MBs I_16x16 (no PCM), 4:2:0,
one slice per frame, cabac_init_idc n/a (I slice).
"""
import sys
import numpy as np

sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))
from video_steganography_pcamv_tpu.encoder.cabac_tables import (
    CTX_INIT_I, RANGE_TAB_LPS, TRANS_IDX_MPS, TRANS_IDX_LPS)


class Bits:
    def __init__(self, data):
        self.d = data
        self.pos = 0  # bit position

    def bit(self):
        byte = self.d[self.pos >> 3]
        b = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


class Engine:
    def __init__(self, bits, qp):
        pre = np.clip(((CTX_INIT_I[:, 0] * qp) >> 4) + CTX_INIT_I[:, 1],
                      1, 126)
        self.mps = (pre > 63).astype(int)
        self.state = np.where(pre > 63, pre - 64, 63 - pre).astype(int)
        self.bits = bits
        self.range = 510
        self.offset = bits.bits(9)
        self.log = []

    def decision(self, ctx):
        st = self.state[ctx]
        lps = int(RANGE_TAB_LPS[st][(self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - self.mps[ctx]
            self.offset -= self.range
            self.range = lps
            if st == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = TRANS_IDX_LPS[st]
        else:
            b = int(self.mps[ctx])
            self.state[ctx] = TRANS_IDX_MPS[st]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.bits.bit()
        self.log.append(("d", ctx, b))
        return b

    def bypass(self):
        self.offset = (self.offset << 1) | self.bits.bit()
        if self.offset >= self.range:
            b = 1
            self.offset -= self.range
        else:
            b = 0
        self.log.append(("b", b))
        return b

    def terminate(self):
        self.range -= 2
        if self.offset >= self.range:
            self.log.append(("t", 1))
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.bits.bit()
        self.log.append(("t", 0))
        return 0


# sig/last ctx offsets per ctxBlockCat (frame coding), spec Table 9-40
SIG_OFF = {0: 0, 1: 15, 2: 29, 3: 44, 4: 47}
ABS_OFF = {0: 0, 1: 10, 2: 20, 3: 30, 4: 39}
CBF_OFF = {0: 0, 1: 4, 2: 8, 3: 12, 4: 16}
MAXC = {0: 16, 1: 15, 2: 16, 3: 4, 4: 15}


class SpecI16Decoder:
    def __init__(self, data, mbw, mbh, qp):
        # data = RBSP after slice header, byte-aligned at
        # cabac_alignment_one_bit boundary; caller aligns.
        self.e = Engine(Bits(data), qp)
        self.mbw, self.mbh = mbw, mbh
        self.mb_avail = np.zeros((mbh, mbw), bool)
        self.is_i16 = np.zeros((mbh, mbw), bool)
        self.cmode = np.zeros((mbh, mbw), int)
        self.dc_cbf_y = np.zeros((mbh, mbw), int)
        self.dc_cbf_c = np.zeros((2, mbh, mbw), int)
        self.ac_cbf_y = np.zeros((4 * mbh, 4 * mbw), int)
        self.ac_cbf_c = np.zeros((2, 2 * mbh, 2 * mbw), int)
        self.cbp_luma = np.zeros((mbh, mbw), int)
        self.cbp_chroma = np.zeros((mbh, mbw), int)
        self.last_dqp = 0
        self.out = []

    # --- ctx helpers (spec 9.3.3.1) -------------------------------
    def _navail(self, my, mx):
        a = (my, mx - 1) if mx > 0 else None
        b = (my - 1, mx) if my > 0 else None
        return a, b

    def mb_type(self, my, mx):
        a, b = self._navail(my, mx)
        # bin0 ctx 3 + condA + condB; condN = avail && mbN != I_NxN
        inc = 0
        if a and self.mb_avail[a] and self.is_i16[a]:
            inc += 1
        if b and self.mb_avail[b] and self.is_i16[b]:
            inc += 1
        if not self.e.decision(3 + inc):
            raise ValueError(f"I_NxN at {my},{mx} — not pure I16")
        if self.e.terminate():
            raise ValueError("I_PCM")
        cbp_l = self.e.decision(6)                # bin2: cbp luma 0/15
        cbp_c = 0
        if self.e.decision(7):                    # bin3
            cbp_c = 2 if self.e.decision(8) else 1
        m0 = self.e.decision(9)
        m1 = self.e.decision(10)
        mode = 2 * m0 + m1
        self.is_i16[my, mx] = True
        self.cbp_luma[my, mx] = 15 if cbp_l else 0
        self.cbp_chroma[my, mx] = cbp_c
        return mode, cbp_l, cbp_c

    def chroma_mode(self, my, mx):
        a, b = self._navail(my, mx)
        inc = 0
        if a and self.mb_avail[a] and self.cmode[a] != 0:
            inc += 1
        if b and self.mb_avail[b] and self.cmode[b] != 0:
            inc += 1
        if not self.e.decision(64 + inc):
            m = 0
        elif not self.e.decision(67):
            m = 1
        elif not self.e.decision(67):
            m = 2
        else:
            m = 3
        self.cmode[my, mx] = m
        return m

    def qp_delta(self):
        ctx = 1 if self.last_dqp != 0 else 0
        v = 0
        if self.e.decision(60 + ctx):
            v = 1
            if self.e.decision(62):
                v = 2
                while self.e.decision(63):
                    v += 1
                    if v > 80:
                        raise ValueError("dqp runaway")
        # se mapping
        dqp = (v + 1) // 2 if v % 2 else -(v // 2)
        self.last_dqp = dqp
        return dqp

    def cbf(self, cat, my, mx, by=0, bx=0, ch=0):
        # 9.3.3.1.1.9; current MB is always intra (I slice)
        def cond_dc(arr, n):
            if n is None:
                return 1          # mbAddrN unavailable, cur intra -> 1
            if not self.mb_avail[n]:
                return 1
            if cat == 0:
                # neighbor has luma DC iff I16
                return int(arr[n]) if self.is_i16[n] else 0
            # chroma DC present iff cbp_chroma != 0
            return int(arr[n]) if self.cbp_chroma[n] != 0 else 0

        if cat == 0:
            a, b = self._navail(my, mx)
            ca = cond_dc(self.dc_cbf_y, a)
            cb = cond_dc(self.dc_cbf_y, b)
        elif cat == 3:
            a, b = self._navail(my, mx)
            ca = cond_dc(self.dc_cbf_c[ch], a)
            cb = cond_dc(self.dc_cbf_c[ch], b)
        elif cat == 1:
            # luma AC 4x4 block (by,bx global 4x4 coords)
            def cond_ac(y, x):
                if y < 0 or x < 0:
                    return 1
                nmy, nmx = y // 4, x // 4
                if not self.mb_avail[nmy, nmx] and \
                        not (nmy == my and nmx == mx):
                    return 1
                # block coded iff that MB's cbp covers it (I16 AC
                # coded iff cbp_luma nonzero)
                if nmy == my and nmx == mx:
                    return int(self.ac_cbf_y[y, x])
                if self.cbp_luma[nmy, nmx] == 0:
                    return 0
                return int(self.ac_cbf_y[y, x])
            ca = cond_ac(by, bx - 1)
            cb = cond_ac(by - 1, bx)
        else:  # cat 4 chroma AC
            def cond_cac(y, x):
                if y < 0 or x < 0:
                    return 1
                nmy, nmx = y // 2, x // 2
                if not self.mb_avail[nmy, nmx] and \
                        not (nmy == my and nmx == mx):
                    return 1
                if nmy == my and nmx == mx:
                    return int(self.ac_cbf_c[ch, y, x])
                if self.cbp_chroma[nmy, nmx] != 2:
                    return 0
                return int(self.ac_cbf_c[ch, y, x])
            ca = cond_cac(2 * my + by, 2 * mx + bx - 1)
            cb = cond_cac(2 * my + by - 1, 2 * mx + bx)
        return self.e.decision(85 + CBF_OFF[cat] + 2 * cb + ca)

    def residual(self, cat, my, mx, by=0, bx=0, ch=0):
        n = MAXC[cat]
        if not self.cbf(cat, my, mx, by, bx, ch):
            return [0] * n
        sig = [0] * n
        i = 0
        numsig = 0
        while i < n - 1:
            if self.e.decision(105 + SIG_OFF[cat] +
                               (min(i, 2) if False else i)):
                sig[i] = 1
                numsig += 1
                if self.e.decision(166 + SIG_OFF[cat] + i):
                    break
            i += 1
        else:
            sig[n - 1] = 1
            numsig += 1
        if i < n - 1 and sig[i]:
            pass  # last flag was 1 at position i
        # if we broke via last=1, the remaining are zero
        levels = [0] * n
        # decode levels in reverse scan order
        num_gt1 = 0
        num_eq1 = 0
        idxs = [k for k in range(n) if sig[k]]
        for k in reversed(idxs):
            ctx0 = 227 + ABS_OFF[cat] + \
                (0 if num_gt1 else min(4, 1 + num_eq1))
            if not self.e.decision(ctx0):
                mag = 1
                num_eq1 += 1
            else:
                mag = 2
                ctx1 = 227 + ABS_OFF[cat] + 5 + min(4, num_gt1)
                while mag < 15 and self.e.decision(ctx1):
                    mag += 1
                if mag == 15:
                    # UEG0 suffix, bypass
                    k2 = 0
                    while self.e.bypass():
                        mag += 1 << k2
                        k2 += 1
                        if k2 > 30:
                            raise ValueError("ueg runaway")
                    for j in range(k2 - 1, -1, -1):
                        mag += self.e.bypass() << j
                num_gt1 += 1
            sign = self.e.bypass()
            levels[k] = -mag if sign else mag
        return levels

    def decode_frame(self):
        for my in range(self.mbh):
            for mx in range(self.mbw):
                mode, cbp_l, cbp_c = self.mb_type(my, mx)
                cm = self.chroma_mode(my, mx)
                dqp = self.qp_delta()
                dc = self.residual(0, my, mx)
                self.dc_cbf_y[my, mx] = int(any(dc))
                acs = {}
                # z-scan order of 4x4 blocks
                ZS = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3),
                      (1, 2), (1, 3), (2, 0), (2, 1), (3, 0), (3, 1),
                      (2, 2), (2, 3), (3, 2), (3, 3)]
                if cbp_l:
                    for (zy, zx) in ZS:
                        lv = self.residual(1, my, mx, 4 * my + zy,
                                           4 * mx + zx)
                        self.ac_cbf_y[4 * my + zy, 4 * mx + zx] = \
                            int(any(lv))
                        acs[(zy, zx)] = lv
                else:
                    self.ac_cbf_y[4 * my:4 * my + 4,
                                  4 * mx:4 * mx + 4] = 0
                cdc = {}
                if cbp_c:
                    for c2 in range(2):
                        lv = self.residual(3, my, mx, ch=c2)
                        self.dc_cbf_c[c2, my, mx] = int(any(lv))
                        cdc[c2] = lv
                else:
                    self.dc_cbf_c[:, my, mx] = 0
                cac = {}
                if cbp_c == 2:
                    for c2 in range(2):
                        for (zy, zx) in [(0, 0), (0, 1), (1, 0), (1, 1)]:
                            lv = self.residual(4, my, mx, zy, zx, ch=c2)
                            self.ac_cbf_c[c2, 2 * my + zy,
                                          2 * mx + zx] = int(any(lv))
                            cac[(c2, zy, zx)] = lv
                else:
                    self.ac_cbf_c[:, 2 * my:2 * my + 2,
                                  2 * mx:2 * mx + 2] = 0
                self.mb_avail[my, mx] = True
                self.out.append(dict(my=my, mx=mx, mode=mode,
                                     cbp_l=cbp_l, cbp_c=cbp_c, cm=cm,
                                     dqp=dqp, dc=dc, acs=acs, cdc=cdc,
                                     cac=cac))
                last = (my == self.mbh - 1 and mx == self.mbw - 1)
                t = self.e.terminate()
                if t != (1 if last else 0):
                    print(f"TERMINATE mismatch at mb {my},{mx}: got {t}")
                    return self.out
        return self.out
