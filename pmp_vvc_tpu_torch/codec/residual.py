"""VVC residual (transform-coefficient) coding.

Byte-exact contracts:
- CABACWriter::residual_coding / residual_coding_subblock / last_sig_coeff
  (CABACWriter.cpp:2624-3030)
- CoeffCodingContext (ContextModelling.h:110-215, ContextModelling.cpp ctor
  + initSubblock)
- scan orders: Rom.cpp ScanGenerator (diagonal, grouped 4x4 CGs)
- tables: g_uiGroupIdx / g_uiMinInGroup / g_auiGoRiceParsCoeff (Rom.cpp),
  g_log2SbbSize, COEF_REMAIN_BIN_REDUCTION = 5

Scope (round 1): regular residual coding with dependent quantization off,
sign-data hiding off, transform-skip/BDPCM/SBT off — the minimal-conformance
configuration. The state-transition hooks are wired (stateTransTable
parameter) so DepQuant can be enabled later.
"""
from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

from .cabac import BinEncoder

_DATA = pathlib.Path(__file__).resolve().parent / "data"

GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7] +
    [8] * 8 + [9] * 8 + [10] * 16 + [11] * 16, np.int32)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96],
                        np.int32)
GO_RICE_PARS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 2, 2, 2, 2, 3, 3, 3, 3], np.int32)
COEF_REMAIN_BIN_REDUCTION = 5
ZERO_OUT_TH = 32

# per-TU context-coded-bin budget ratios (TU area * ratio >> 4)
CTX_BIN_RATIO_LUMA = 28
CTX_BIN_RATIO_CHROMA = 28


@functools.cache
def ctx_sets() -> dict:
    """Context-set offsets/sizes of the standard layout (data/ctx_sets.json)."""
    return {k: tuple(v) for k, v in
            json.loads((_DATA / "ctx_sets.json").read_text()).items()}


def ctx(name: str, inc: int = 0) -> int:
    off, size = ctx_sets()[name]
    assert 0 <= inc < size, (name, inc, size)
    return off + inc


def log2_sbb_size(log2w: int, log2h: int) -> tuple[int, int]:
    """g_log2SbbSize (Rom.cpp:264)."""
    table = [
        [(0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 4), (0, 4), (0, 4)],
        [(1, 0), (1, 1), (1, 1), (1, 3), (1, 3), (1, 3), (1, 3), (1, 3)],
        [(2, 0), (1, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(3, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
    ]
    return table[log2w][log2h]


@functools.cache
def diag_scan(w: int, h: int):
    """Ungrouped diagonal scan: ScanGenerator SCAN_DIAG semantics.

    Returns array of (idx, x, y) with idx = y*w + x, scanPos 0 = DC.
    """
    out = []
    line = col = 0
    for _ in range(w * h):
        out.append((line * w + col, col, line))
        if col == w - 1 or line == 0:
            line += col + 1
            col = 0
            if line >= h:
                col += line - (h - 1)
                line = h - 1
        else:
            col += 1
            line -= 1
    return np.array(out, np.int32)


@functools.cache
def grouped_scan(w: int, h: int):
    """SCAN_GROUPED_4x4 diagonal scan: (blkIdx, x, y) per scanPos.

    CGs are enumerated by the diagonal scan over the CG grid; positions
    within each CG by the diagonal scan over the CG dims (Rom.cpp initROM).
    """
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    cgl2w, cgl2h = log2_sbb_size(log2w, log2h)
    cgw, cgh = 1 << cgl2w, 1 << cgl2h
    # the grouped scan only covers the zero-out-limited region (Rom.cpp:339)
    cg_scan = diag_scan(min(ZERO_OUT_TH, w) // cgw,
                        min(ZERO_OUT_TH, h) // cgh)
    inner = diag_scan(cgw, cgh)
    out = []
    for _, cgx, cgy in cg_scan:
        bx, by = cgx * cgw, cgy * cgh
        for _, ix, iy in inner:
            x, y = bx + ix, by + iy
            out.append((y * w + x, x, y))
    return np.array(out, np.int32)


@functools.cache
def _scan_tuples(w: int, h: int):
    return [(int(a), int(b), int(c)) for a, b, c in grouped_scan(w, h)]


class ResidualCoder:
    """Codes one TU's coefficient block (regular path)."""

    def __init__(self, enc: BinEncoder, *, max_log2_dyn_range: int = 15,
                 dep_quant: bool = False, sign_hiding: bool = False):
        self.enc = enc
        self.max_log2_dyn = max_log2_dyn_range
        self.state_tab = 32040 if dep_quant else 0
        self.sign_hiding = sign_hiding

    # ---- template sums (ContextModelling.h) ------------------------------

    @staticmethod
    def _sig_ctx_parts(coeff, x, y, w, h):
        """(sumAbs-ish, numPos) over the 5-neighbour template."""
        sum_abs = 0
        num_pos = 0
        def upd(cx, cy):
            nonlocal sum_abs, num_pos
            a = abs(int(coeff[cy, cx]))
            sum_abs += min(4 + (a & 1), a)
            num_pos += 1 if a else 0
        if x < w - 1:
            upd(x + 1, y)
            if x < w - 2:
                upd(x + 2, y)
            if y < h - 1:
                upd(x + 1, y + 1)
        if y < h - 1:
            upd(x, y + 1)
            if y < h - 2:
                upd(x, y + 2)
        return sum_abs, num_pos

    @staticmethod
    def _template_abs_sum(coeff, x, y, w, h, base_level):
        s = 0
        if x < w - 1:
            s += abs(int(coeff[y, x + 1]))
            if x < w - 2:
                s += abs(int(coeff[y, x + 2]))
            if y < h - 1:
                s += abs(int(coeff[y + 1, x + 1]))
        if y < h - 1:
            s += abs(int(coeff[y + 1, x]))
            if y < h - 2:
                s += abs(int(coeff[y + 2, x]))
        return max(min(s - 5 * base_level, 31), 0)

    # ---- last position ---------------------------------------------------

    def _last_sig_coeff(self, pos_x, pos_y, w, h, is_luma):
        gx, gy = int(GROUP_IDX[pos_x]), int(GROUP_IDX[pos_y])
        max_x = int(GROUP_IDX[min(ZERO_OUT_TH, w) - 1])
        max_y = int(GROUP_IDX[min(ZERO_OUT_TH, h) - 1])
        ch = 0 if is_luma else 1
        log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
        if is_luma:
            prefix_ctx = [0, 0, 0, 3, 6, 10, 15, 21]
            off_x, off_y = prefix_ctx[log2w], prefix_ctx[log2h]
            shift_x = (log2w + 1) >> 2
            shift_y = (log2h + 1) >> 2
        else:
            off_x = off_y = 0
            shift_x = min(2, max(0, w >> 3))
            shift_y = min(2, max(0, h >> 3))

        for c in range(gx):
            self.enc.encode_bin(1, ctx(f"LastX{ch}", off_x + (c >> shift_x)))
        if gx < max_x:
            self.enc.encode_bin(0, ctx(f"LastX{ch}", off_x + (gx >> shift_x)))
        for c in range(gy):
            self.enc.encode_bin(1, ctx(f"LastY{ch}", off_y + (c >> shift_y)))
        if gy < max_y:
            self.enc.encode_bin(0, ctx(f"LastY{ch}", off_y + (gy >> shift_y)))
        if gx > 3:
            px = pos_x - int(MIN_IN_GROUP[gx])
            for i in range(((gx - 2) >> 1) - 1, -1, -1):
                self.enc.encode_bin_ep((px >> i) & 1)
        if gy > 3:
            py = pos_y - int(MIN_IN_GROUP[gy])
            for i in range(((gy - 2) >> 1) - 1, -1, -1):
                self.enc.encode_bin_ep((py >> i) & 1)

    # ---- main ------------------------------------------------------------

    def code(self, coeff: np.ndarray, *, is_luma: bool):
        """Encode one TU's (h, w) coefficient array (must be non-empty).

        Returns (scan_pos_last, violates_mts_constraint) for the caller's
        cuCtx bookkeeping (CABACWriter.cpp:2662-2706).
        """
        h, w = coeff.shape
        log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
        cgl2w, cgl2h = log2_sbb_size(log2w, log2h)
        log2_cg = cgl2w + cgl2h
        wig = min(ZERO_OUT_TH, w) >> cgl2w      # widthInGroups
        hig = min(ZERO_OUT_TH, h) >> cgl2h
        scan = grouped_scan(w, h)
        cg_scan = diag_scan(wig, hig)
        ch = 0 if is_luma else 1

        flat = coeff.reshape(-1)
        # whole-TU 5-neighbour template sums (ContextModelling.h windows):
        # S[y, x] = f(a[y, x+1], a[y, x+2], a[y+1, x+1], a[y+1, x],
        #             a[y+2, x]) with zero padding == the bounds guards
        absc = np.abs(coeff.astype(np.int64))
        pad = np.zeros((h + 2, w + 2), np.int64)

        def _win5(a):
            pad[:h, :w] = a
            return (pad[0:h, 1:w + 1] + pad[0:h, 2:w + 2]
                    + pad[1:h + 1, 1:w + 1] + pad[1:h + 1, 0:w]
                    + pad[2:h + 2, 0:w])

        self._ts_sum = _win5(np.minimum(4 + (absc & 1), absc)).tolist()
        self._ts_num = _win5((absc != 0).astype(np.int64)).tolist()
        self._ta_sum = _win5(absc).tolist()
        self._flat = flat.tolist()
        nz_scan = np.nonzero(flat[scan[:, 0]])[0]
        assert nz_scan.size, "residual coding on empty TU"
        scan_pos_last = int(nz_scan[-1])
        sig_groups = set(int(p) >> log2_cg for p in nz_scan)

        last_idx, last_x, last_y = scan[scan_pos_last]
        self._last_sig_coeff(int(last_x), int(last_y), w, h, is_luma)
        violates_mts = False

        ratio = CTX_BIN_RATIO_LUMA if is_luma else CTX_BIN_RATIO_CHROMA
        tb_zoned = min(ZERO_OUT_TH, w) * min(ZERO_OUT_TH, h)
        reg_bin_limit = (tb_zoned * ratio) >> 4

        sig_cg_flags = np.zeros(wig * hig, bool)
        state = 0
        for subset in range(scan_pos_last >> log2_cg, -1, -1):
            cg_pos = int(cg_scan[subset][0])       # idx in CG grid
            cg_x, cg_y = int(cg_scan[subset][1]), int(cg_scan[subset][2])
            is_sig_group = subset in sig_groups
            if is_sig_group:
                sig_cg_flags[cg_pos] = True
            min_sub = subset << log2_cg
            max_sub = min_sub + (1 << log2_cg) - 1
            is_last_cg = subset == (scan_pos_last >> log2_cg)

            # sig group flag
            is_not_first = subset > 0
            if not is_last_cg and is_not_first:
                sig_right = cg_x + 1 < wig and sig_cg_flags[cg_pos + 1]
                sig_lower = cg_y + 1 < hig and sig_cg_flags[cg_pos + wig]
                gctx = ctx(f"SigCoeffGroup{ch}",
                           1 if (sig_right or sig_lower) else 0)
                self.enc.encode_bin(1 if is_sig_group else 0, gctx)
                if not is_sig_group:
                    continue

            state, reg_bin_limit = self._code_subblock(
                coeff, _scan_tuples(w, h), w, h, min_sub, max_sub,
                scan_pos_last, is_last_cg, is_not_first, state,
                reg_bin_limit, is_luma)
            if is_luma and is_sig_group and (cg_x > 3 or cg_y > 3):
                violates_mts = True
        return scan_pos_last, violates_mts

    def _code_subblock(self, coeff, scan, w, h, min_sub, max_sub,
                       scan_pos_last, is_last_cg, is_not_first, state,
                       reg_bin_limit, is_luma):
        enc = self.enc
        ch = 0 if is_luma else 1
        flat = self._flat
        ts_sum, ts_num, ta_sum = self._ts_sum, self._ts_num, self._ta_sum
        first_sig = scan_pos_last if is_last_cg else max_sub
        infer_sig_pos = (first_sig if first_sig == scan_pos_last
                         else (min_sub if is_not_first else -1))
        num_nonzero = 0
        sign_pattern = 0
        rem_reg_bins = reg_bin_limit
        tmpl_diag = {}
        ctx_off = {}
        first_nz = first_sig
        last_nz = -1

        next_pos = first_sig
        while next_pos >= min_sub and rem_reg_bins >= 4:
            idx, x, y = scan[next_pos]
            c = flat[idx]
            sig = 1 if c else 0
            sum_abs = ts_sum[y][x]
            num_pos = ts_num[y][x]
            diag = x + y
            template_set = False
            if num_nonzero or next_pos != infer_sig_pos:
                ctx_ofs = min((sum_abs + 1) >> 1, 3) + (4 if diag < 2 else 0)
                if is_luma:
                    ctx_ofs += 4 if diag < 5 else 0
                sig_set = ch + 2 * max(0, state - 1)
                enc.encode_bin(sig, ctx(f"SigFlag{sig_set}", ctx_ofs))
                rem_reg_bins -= 1
                template_set = True
            elif next_pos != scan_pos_last:
                template_set = True   # side-effect-only sigCtxIdAbs call
            sum1 = sum_abs - num_pos
            if sig:
                # ctxOffsetAbs: 0 for the very first (last-scan) coefficient
                # where sigCtxIdAbs was never invoked (m_tmplCpDiag == -1)
                if not template_set:
                    off = 0
                else:
                    off = min(sum1, 4) + 1
                    if diag == 0:
                        off += 15 if is_luma else 5
                    elif is_luma:
                        off += 10 if diag < 3 else (5 if diag < 10 else 0)
                num_nonzero += 1
                first_nz = next_pos
                last_nz = max(last_nz, next_pos)
                rem = abs(c) - 1
                if next_pos != scan_pos_last:
                    sign_pattern <<= 1
                if c < 0:
                    sign_pattern += 1
                gt1 = 1 if rem else 0
                enc.encode_bin(gt1, ctx(f"GtxFlag{2 + ch}", off))
                rem_reg_bins -= 1
                if gt1:
                    rem -= 1
                    enc.encode_bin(rem & 1, ctx(f"ParFlag{ch}", off))
                    rem >>= 1
                    rem_reg_bins -= 1
                    gt2 = 1 if rem else 0
                    enc.encode_bin(gt2, ctx(f"GtxFlag{ch}", off))
                    rem_reg_bins -= 1
            state = (self.state_tab >> ((state << 2) + ((c & 1) << 1))) & 3
            next_pos -= 1

        first_pos_mode2 = next_pos

        # pass 2: remainders for positions coded in pass 1
        for pos in range(first_sig, first_pos_mode2, -1):
            idx, x, y = scan[pos]
            sum_all = max(min(ta_sum[y][x] - 20, 31), 0)
            rice = int(GO_RICE_PARS[sum_all])
            abs_level = abs(flat[idx])
            if abs_level >= 4:
                enc.encode_rem_abs_ep((abs_level - 4) >> 1, rice,
                                      COEF_REMAIN_BIN_REDUCTION,
                                      self.max_log2_dyn)

        # bypass pass: fully EP-coded positions
        for pos in range(first_pos_mode2, min_sub - 1, -1):
            idx, x, y = scan[pos]
            c = flat[idx]
            abs_level = abs(c)
            sum_all = max(min(ta_sum[y][x], 31), 0)
            rice = int(GO_RICE_PARS[sum_all])
            pos0 = (1 if state < 2 else 2) << rice
            rem = (pos0 if abs_level == 0
                   else abs_level - 1 if abs_level <= pos0 else abs_level)
            enc.encode_rem_abs_ep(rem, rice, COEF_REMAIN_BIN_REDUCTION,
                                  self.max_log2_dyn)
            state = (self.state_tab >> ((state << 2) + ((abs_level & 1) << 1))) & 3
            if abs_level:
                num_nonzero += 1
                first_nz = pos
                last_nz = max(last_nz, pos)
                sign_pattern <<= 1
                if c < 0:
                    sign_pattern += 1

        num_signs = num_nonzero
        if self.sign_hiding and (last_nz - first_nz) >= 4:
            num_signs -= 1
            sign_pattern >>= 1
        if num_signs:
            enc.encode_bins_ep(sign_pattern, num_signs)
        return state, rem_reg_bins


def _ts_mod_coeff(a, pred):
    """deriveModCoeff (ContextModelling.h:357): level -> coded level via
    the left/above max predictor (BDPCM off)."""
    if a == 0:
        return 0
    if a == pred:
        return 1
    return a + 1 if a < pred else a


class TSResidualCoder:
    """Transform-skip residual coding — byte-exact contract of
    CABACWriter::residual_codingTS / residual_coding_subblockTS
    (CABACWriter.cpp:3032-3180) with CoeffCodingContext TS helpers
    (ContextModelling.h:218-432). Forward subblock scan, left/above
    neighbour templates, per-TU context-bin budget (7/4 * numCoeff),
    BDPCM off."""

    def __init__(self, enc: BinEncoder, *, max_log2_dyn_range: int = 15):
        self.enc = enc
        self.max_log2_dyn = max_log2_dyn_range

    def code(self, coeff: np.ndarray, *, is_luma: bool):
        del is_luma    # TS context sets are channel-shared
        enc = self.enc
        h, w = coeff.shape
        log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
        cgl2w, cgl2h = log2_sbb_size(log2w, log2h)
        log2_cg = cgl2w + cgl2h
        wig, hig = w >> cgl2w, h >> cgl2h    # TS TUs <= 32: no zero-out
        scan = _scan_tuples(w, h)
        cg_scan = diag_scan(wig, hig)
        c2 = np.asarray(coeff, np.int64)
        flat = c2.reshape(-1).tolist()
        ctx_bins = (w * h * 7) >> 2
        n_sub = ((w * h - 1) >> log2_cg) + 1

        sig_subsets = {p >> log2_cg for p, (idx, _, _) in enumerate(scan)
                       if flat[idx]}
        sig_flags = [False] * (wig * hig)

        def neigh(x, y):
            l = int(c2[y, x - 1]) if x > 0 else 0
            a = int(c2[y - 1, x]) if y > 0 else 0
            return l, a

        prev_sig = False
        for subset in range(n_sub):
            cg_pos, cg_x, cg_y = (int(v) for v in cg_scan[subset])
            is_sig = subset in sig_subsets
            if is_sig:
                sig_flags[cg_pos] = True
            is_last = subset == n_sub - 1
            if not (is_last and not prev_sig):
                sl = 1 if (cg_x > 0 and sig_flags[cg_pos - 1]) else 0
                sa = 1 if (cg_y > 0 and sig_flags[cg_pos - wig]) else 0
                enc.encode_bin(1 if is_sig else 0,
                               ctx("TsSigCoeffGroup", sl + sa))
                if not is_sig:
                    continue
            else:
                assert is_sig, "inferred TS sig group on empty TU"
            prev_sig = True

            min_sub = subset << log2_cg
            max_sub = min_sub + (1 << log2_cg) - 1
            infer_pos = max_sub
            num_nonzero = 0
            last_p1 = min_sub - 1
            pos = min_sub
            # pass 1: sig + sign + gt1 + parity (context-coded)
            while pos <= max_sub and ctx_bins >= 4:
                idx, x, y = scan[pos]
                c = flat[idx]
                sig = 1 if c else 0
                l, a = neigh(x, y)
                if num_nonzero or pos != infer_pos:
                    npos = (1 if l else 0) + (1 if a else 0)
                    enc.encode_bin(sig, ctx("TsSigFlag", npos))
                    ctx_bins -= 1
                if sig:
                    rs = (l > 0) - (l < 0)
                    bs = (a > 0) - (a < 0)
                    if (rs == 0 and bs == 0) or rs * bs < 0:
                        sc = 0
                    elif rs >= 0 and bs >= 0:
                        sc = 1
                    else:
                        sc = 2
                    enc.encode_bin(1 if c < 0 else 0,
                                   ctx("TsResidualSign", sc))
                    ctx_bins -= 1
                    num_nonzero += 1
                    rem = _ts_mod_coeff(abs(c), max(abs(l), abs(a))) - 1
                    gt1 = 1 if rem else 0
                    npos = (1 if l else 0) + (1 if a else 0)
                    enc.encode_bin(gt1, ctx("TsLrg1Flag", npos))
                    ctx_bins -= 1
                    if gt1:
                        rem -= 1
                        enc.encode_bin(rem & 1, ctx("TsParFlag", 0))
                        ctx_bins -= 1
                last_p1 = pos
                pos += 1

            # pass 2: gt2..gt8 flags
            last_p2 = min_sub - 1
            pos = min_sub
            while pos <= max_sub and ctx_bins >= 4:
                idx, x, y = scan[pos]
                l, a = neigh(x, y)
                mod = _ts_mod_coeff(abs(flat[idx]), max(abs(l), abs(a)))
                cutoff = 2
                for _ in range(4):
                    if mod >= cutoff:
                        enc.encode_bin(1 if mod >= cutoff + 2 else 0,
                                       ctx("TsGtxFlag", cutoff >> 1))
                        ctx_bins -= 1
                    cutoff += 2
                last_p2 = pos
                pos += 1

            # bypass pass: golomb remainders (+ EP signs past pass 1)
            for pos in range(min_sub, max_sub + 1):
                idx, x, y = scan[pos]
                av = abs(flat[idx])
                cutoff = 10 if pos <= last_p2 else \
                    (2 if pos <= last_p1 else 0)
                if cutoff:
                    l, a = neigh(x, y)
                    mod = _ts_mod_coeff(av, max(abs(l), abs(a)))
                else:
                    mod = av
                if mod >= cutoff:
                    rem = (mod - cutoff) >> 1 if pos <= last_p1 else mod
                    enc.encode_rem_abs_ep(rem, 1, COEF_REMAIN_BIN_REDUCTION,
                                          self.max_log2_dyn)
                    if mod and pos > last_p1:
                        enc.encode_bin_ep(1 if flat[idx] < 0 else 0)


class TSResidualParser:
    """Mirror of ``TSResidualCoder`` (CABACReader::residual_codingTS,
    CABACReader.cpp counterpart): the working level array holds
    pass-1 signed partials, abs values through passes 2-3, and the
    decoded signs are applied per subblock."""

    def __init__(self, dec, *, max_log2_dyn_range: int = 15):
        self.dec = dec
        self.max_log2_dyn = max_log2_dyn_range

    def parse(self, w, h, *, is_luma: bool, bdpcm: bool = False):
        del is_luma
        dec = self.dec
        log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
        cgl2w, cgl2h = log2_sbb_size(log2w, log2h)
        log2_cg = cgl2w + cgl2h
        wig, hig = w >> cgl2w, h >> cgl2h
        scan = _scan_tuples(w, h)
        cg_scan = diag_scan(wig, hig)
        ctx_bins = (w * h * 7) >> 2
        n_sub = ((w * h - 1) >> log2_cg) + 1

        val = [[0] * w for _ in range(h)]
        sig_flags = [False] * (wig * hig)
        prev_sig = False
        for subset in range(n_sub):
            cg_pos, cg_x, cg_y = (int(v) for v in cg_scan[subset])
            is_last = subset == n_sub - 1
            if is_last and not prev_sig:
                sig = 1
            else:
                sl = 1 if (cg_x > 0 and sig_flags[cg_pos - 1]) else 0
                sa = 1 if (cg_y > 0 and sig_flags[cg_pos - wig]) else 0
                sig = dec.decode_bin(ctx("TsSigCoeffGroup", sl + sa))
            if not sig:
                continue
            sig_flags[cg_pos] = True
            prev_sig = True

            min_sub = subset << log2_cg
            max_sub = min_sub + (1 << log2_cg) - 1
            infer_pos = max_sub
            signs = []        # (sign, x, y) in parse order
            last_p1 = min_sub - 1
            pos = min_sub
            while pos <= max_sub and ctx_bins >= 4:
                idx, x, y = scan[pos]
                l = val[y][x - 1] if x > 0 else 0
                a = val[y - 1][x] if y > 0 else 0
                if not signs and pos == infer_pos:
                    sig = 1
                else:
                    npos = (1 if l else 0) + (1 if a else 0)
                    sig = dec.decode_bin(ctx("TsSigFlag", npos))
                    ctx_bins -= 1
                if sig:
                    rs = (l > 0) - (l < 0)
                    bs = (a > 0) - (a < 0)
                    if (rs == 0 and bs == 0) or rs * bs < 0:
                        sc = 0
                    elif rs >= 0 and bs >= 0:
                        sc = 1
                    else:
                        sc = 2
                    sign = dec.decode_bin(
                        ctx("TsResidualSign", sc + (3 if bdpcm else 0)))
                    ctx_bins -= 1
                    signs.append((sign, x, y))
                    npos = 3 if bdpcm else \
                        (1 if l else 0) + (1 if a else 0)
                    gt1 = dec.decode_bin(ctx("TsLrg1Flag", npos))
                    ctx_bins -= 1
                    par = 0
                    if gt1:
                        par = dec.decode_bin(ctx("TsParFlag", 0))
                        ctx_bins -= 1
                    val[y][x] = (-1 if sign else 1) * (1 + par + gt1)
                last_p1 = pos
                pos += 1

            last_p2 = min_sub - 1
            pos = min_sub
            while pos <= max_sub and ctx_bins >= 4:
                idx, x, y = scan[pos]
                t = abs(val[y][x])
                cutoff = 2
                for _ in range(4):
                    if t >= cutoff:
                        gt = dec.decode_bin(ctx("TsGtxFlag", cutoff >> 1))
                        ctx_bins -= 1
                        t += gt << 1
                    cutoff += 2
                val[y][x] = t
                last_p2 = pos
                pos += 1

            for pos in range(min_sub, max_sub + 1):
                idx, x, y = scan[pos]
                t = abs(val[y][x])
                cutoff = 10 if pos <= last_p2 else \
                    (2 if pos <= last_p1 else 0)
                if t >= cutoff:
                    rem = dec.decode_rem_abs_ep(
                        1, COEF_REMAIN_BIN_REDUCTION, self.max_log2_dyn)
                    t += (rem << 1) if pos <= last_p1 else rem
                    if t and pos > last_p1:
                        signs.append((dec.decode_bin_ep(), x, y))
                if cutoff and t > 0 and not bdpcm:
                    l = abs(val[y][x - 1]) if x > 0 else 0
                    a = abs(val[y - 1][x]) if y > 0 else 0
                    pred = max(l, a)
                    if t == 1 and pred > 0:
                        t = pred
                    else:
                        t -= 1 if t <= pred else 0
                val[y][x] = t

            for sign, x, y in signs:
                if sign:
                    val[y][x] = -val[y][x]

        return np.array(val, np.int32)


def apply_sign_hiding(lev, coef, w, h, qp, bit_depth=10):
    """Sign-bit-hiding level adjustment (Quant::xSignBitHidingHDQ).

    Per coefficient group with lastNZ-firstNZ >= SBH_THRESHOLD(4), the
    decoder infers sign(first nz) from the parity of the CG's absolute
    level sum; adjust one level by +-1 (minimum dequantisation-error
    choice) when the parity disagrees. Returns the adjusted levels.
    """
    from ..ops.quant import INV_QUANT_SCALES, IQUANT_SHIFT, _geom
    t_shift, sqrt2 = _geom(w, h, bit_depth)
    iscale = int(INV_QUANT_SCALES[sqrt2][qp % 6])
    rshift = IQUANT_SHIFT - ((t_shift - sqrt2) + qp // 6)

    def deq(level):
        if rshift > 0:
            return (level * iscale + (1 << (rshift - 1))) >> rshift
        return (level * iscale) << (-rshift)

    lev = np.asarray(lev).copy()
    flat_l = lev.reshape(-1)
    flat_c = np.asarray(coef).reshape(-1)
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    cgl2w, cgl2h = log2_sbb_size(log2w, log2h)
    log2_cg = cgl2w + cgl2h
    scan = grouped_scan(w, h)[:, 0]
    n_cg = len(scan) >> log2_cg
    for sub in range(n_cg):
        idxs = scan[sub << log2_cg:(sub + 1) << log2_cg]
        levels = flat_l[idxs].astype(np.int64)
        nz = np.nonzero(levels)[0]
        if nz.size == 0:
            continue
        first, last = int(nz[0]), int(nz[-1])
        if last - first < 4:
            continue
        parity = int(np.abs(levels).sum()) & 1
        want = 1 if levels[first] < 0 else 0
        if parity == want:
            continue
        best = None
        for k in range(len(idxs)):
            c = int(flat_c[idxs[k]])
            for d in (1, -1):
                nl = int(levels[k]) + d
                if abs(nl) > 32767:
                    continue
                if levels[k] == 0:
                    # only create a coefficient matching the source sign
                    if c == 0 or (c > 0) != (nl > 0):
                        continue
                trial = levels.copy()
                trial[k] = nl
                tnz = np.nonzero(trial)[0]
                if tnz.size == 0:
                    continue
                tf, tl = int(tnz[0]), int(tnz[-1])
                if tl - tf >= 4:
                    p = int(np.abs(trial).sum()) & 1
                    ws = 1 if trial[tf] < 0 else 0
                    if p != ws:
                        continue
                err_new = (deq(nl) - c) ** 2
                err_old = (deq(int(levels[k])) - c) ** 2
                delta = err_new - err_old
                if best is None or delta < best[0]:
                    best = (delta, k, nl)
        if best is not None:
            levels[best[1]] = best[2]
            flat_l[idxs] = levels
    return lev


def rd_quant_cleanup(lev, coef, w, h, qp, bit_depth=10, lam=0.0):
    """RDOQ-lite: rate-distortion zeroing after scalar quantization.

    Transform-domain distortion via Parseval (the VVC int transforms are
    2^tShift-scaled orthonormal bases, ChromaFormat.h:111), rate modelled
    as ~3 bits/nonzero + ~1.5 bits/coded CG (sig+gt1+sign plus the group
    flag), the same role as QuantRDOQ's per-CG and per-coefficient
    zeroing decisions. Returns possibly-modified levels.
    """
    from ..ops.quant import INV_QUANT_SCALES, IQUANT_SHIFT, _geom
    lev = np.asarray(lev)
    if not lev.any():
        return lev
    t_shift, sqrt2 = _geom(w, h, bit_depth)
    # transform energy gain: 4^t_shift, HALVED for odd-log2-area TUs
    # (measured: sum(coef^2)/sum(resid^2) = 4^t_shift/2 when sqrt2 — the
    # sqrt(2) compensation lives in the quantiser scale tables)
    divisor = float(4.0 ** t_shift) / (2.0 if sqrt2 else 1.0)
    iscale = int(INV_QUANT_SCALES[sqrt2][qp % 6])
    rshift = IQUANT_SHIFT - ((t_shift - sqrt2) + qp // 6)
    flat_l = lev.reshape(-1).copy()
    flat_c = np.asarray(coef).reshape(-1).astype(np.float64)
    if rshift > 0:
        deq = (flat_l.astype(np.int64) * iscale
               + (1 << (rshift - 1))) >> rshift
    else:
        deq = (flat_l.astype(np.int64) * iscale) << (-rshift)
    d_now = (flat_c - deq) ** 2
    d_zero = flat_c ** 2
    gain = (d_zero - d_now) / divisor        # pixel-SSE cost of zeroing

    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    cgl2w, cgl2h = log2_sbb_size(log2w, log2h)
    log2_cg = cgl2w + cgl2h
    scan = grouped_scan(w, h)[:, 0]
    changed = False
    n_cg = len(scan) >> log2_cg
    for sub in range(n_cg):
        idxs = scan[sub << log2_cg:(sub + 1) << log2_cg]
        lv = flat_l[idxs]
        k = int(np.count_nonzero(lv))
        if k == 0:
            continue
        dd = float(gain[idxs].sum())
        if dd < lam * (3.0 * k + 1.5):
            flat_l[idxs] = 0
            changed = True
            continue
        # per-coefficient trim of isolated |level|==1 noise
        ones = idxs[np.abs(lv) == 1]
        if ones.size:
            kill = ones[gain[ones] < lam * 3.0]
            if kill.size:
                flat_l[kill] = 0
                changed = True
    if not changed:
        return lev
    return flat_l.reshape(lev.shape)


class ResidualParser:
    """Parses one TU's coefficients — exact mirror of ``ResidualCoder``
    (CABACReader::residual_coding counterpart).

    Template sums are maintained incrementally: pass-1 contexts read the
    partial levels ``min(|c|, 4 + (|c| & 1))`` (identical to the whole-TU
    precompute in ResidualCoder since every template neighbour lies at a
    strictly higher scan position, hence is already parsed)."""

    def __init__(self, dec, *, max_log2_dyn_range: int = 15,
                 dep_quant: bool = False, sign_hiding: bool = False):
        self.dec = dec
        self.max_log2_dyn = max_log2_dyn_range
        self.state_tab = 32040 if dep_quant else 0
        self.sign_hiding = sign_hiding

    @staticmethod
    def _t5(a, x, y, w, h):
        s = 0
        if x < w - 1:
            s += a[y][x + 1]
            if x < w - 2:
                s += a[y][x + 2]
            if y < h - 1:
                s += a[y + 1][x + 1]
        if y < h - 1:
            s += a[y + 1][x]
            if y < h - 2:
                s += a[y + 2][x]
        return s

    def _parse_last(self, w, h, is_luma):
        dec = self.dec
        max_x = int(GROUP_IDX[min(ZERO_OUT_TH, w) - 1])
        max_y = int(GROUP_IDX[min(ZERO_OUT_TH, h) - 1])
        ch = 0 if is_luma else 1
        log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
        if is_luma:
            prefix_ctx = [0, 0, 0, 3, 6, 10, 15, 21]
            off_x, off_y = prefix_ctx[log2w], prefix_ctx[log2h]
            shift_x = (log2w + 1) >> 2
            shift_y = (log2h + 1) >> 2
        else:
            off_x = off_y = 0
            shift_x = min(2, max(0, w >> 3))
            shift_y = min(2, max(0, h >> 3))
        gx = 0
        while gx < max_x and dec.decode_bin(
                ctx(f"LastX{ch}", off_x + (gx >> shift_x))):
            gx += 1
        gy = 0
        while gy < max_y and dec.decode_bin(
                ctx(f"LastY{ch}", off_y + (gy >> shift_y))):
            gy += 1
        px = py = 0
        if gx > 3:
            for i in range(((gx - 2) >> 1) - 1, -1, -1):
                px |= dec.decode_bin_ep() << i
        if gy > 3:
            for i in range(((gy - 2) >> 1) - 1, -1, -1):
                py |= dec.decode_bin_ep() << i
        return int(MIN_IN_GROUP[gx]) + px, int(MIN_IN_GROUP[gy]) + py

    def parse(self, w, h, *, is_luma: bool):
        """Returns (levels (h, w) int32, scan_pos_last, violates_mts)."""
        log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
        cgl2w, cgl2h = log2_sbb_size(log2w, log2h)
        log2_cg = cgl2w + cgl2h
        wig = min(ZERO_OUT_TH, w) >> cgl2w
        hig = min(ZERO_OUT_TH, h) >> cgl2h
        scan_t = _scan_tuples(w, h)
        cg_scan = diag_scan(wig, hig)
        ch = 0 if is_luma else 1

        pos_x, pos_y = self._parse_last(w, h, is_luma)
        scan_pos_last = next(i for i, (_, x, y) in enumerate(scan_t)
                             if x == pos_x and y == pos_y)

        ratio = CTX_BIN_RATIO_LUMA if is_luma else CTX_BIN_RATIO_CHROMA
        tb_zoned = min(ZERO_OUT_TH, w) * min(ZERO_OUT_TH, h)
        rem_bins = (tb_zoned * ratio) >> 4

        part = [[0] * w for _ in range(h)]   # pass-1 partial abs levels
        full = [[0] * w for _ in range(h)]   # abs levels incl. remainders
        nzf = [[0] * w for _ in range(h)]
        sign = [[0] * w for _ in range(h)]

        sig_cg_flags = np.zeros(wig * hig, bool)
        state = 0
        violates_mts = False
        for subset in range(scan_pos_last >> log2_cg, -1, -1):
            cg_pos = int(cg_scan[subset][0])
            cg_x, cg_y = int(cg_scan[subset][1]), int(cg_scan[subset][2])
            min_sub = subset << log2_cg
            max_sub = min_sub + (1 << log2_cg) - 1
            is_last_cg = subset == (scan_pos_last >> log2_cg)
            is_not_first = subset > 0
            if not is_last_cg and is_not_first:
                sig_right = cg_x + 1 < wig and sig_cg_flags[cg_pos + 1]
                sig_lower = cg_y + 1 < hig and sig_cg_flags[cg_pos + wig]
                gctx = ctx(f"SigCoeffGroup{ch}",
                           1 if (sig_right or sig_lower) else 0)
                if not self.dec.decode_bin(gctx):
                    continue
            sig_cg_flags[cg_pos] = True
            state, rem_bins = self._parse_subblock(
                scan_t, w, h, min_sub, max_sub, scan_pos_last, is_last_cg,
                is_not_first, state, rem_bins, is_luma,
                part, full, nzf, sign)
            if is_luma and (cg_x > 3 or cg_y > 3):
                violates_mts = True

        lev = np.array(full, np.int32)
        lev[np.array(sign, bool)] *= -1
        return lev, scan_pos_last, violates_mts

    def _parse_subblock(self, scan_t, w, h, min_sub, max_sub,
                        scan_pos_last, is_last_cg, is_not_first, state,
                        rem_bins, is_luma, part, full, nzf, sign):
        dec = self.dec
        ch = 0 if is_luma else 1
        first_sig = scan_pos_last if is_last_cg else max_sub
        infer_sig_pos = (first_sig if first_sig == scan_pos_last
                         else (min_sub if is_not_first else -1))
        num_nonzero = 0
        cg_nz = []                       # nonzero scan positions, parse order
        gt2_list = []
        next_pos = first_sig
        while next_pos >= min_sub and rem_bins >= 4:
            idx, x, y = scan_t[next_pos]
            sum_abs = self._t5(part, x, y, w, h)
            num_pos = self._t5(nzf, x, y, w, h)
            diag = x + y
            template_set = False
            if num_nonzero or next_pos != infer_sig_pos:
                ctx_ofs = min((sum_abs + 1) >> 1, 3) + (4 if diag < 2 else 0)
                if is_luma:
                    ctx_ofs += 4 if diag < 5 else 0
                sig_set = ch + 2 * max(0, state - 1)
                sig = dec.decode_bin(ctx(f"SigFlag{sig_set}", ctx_ofs))
                rem_bins -= 1
                template_set = True
            else:
                sig = 1
                if next_pos != scan_pos_last:
                    template_set = True
            val = 0
            if sig:
                sum1 = sum_abs - num_pos
                if not template_set:
                    off = 0
                else:
                    off = min(sum1, 4) + 1
                    if diag == 0:
                        off += 15 if is_luma else 5
                    elif is_luma:
                        off += 10 if diag < 3 else (5 if diag < 10 else 0)
                num_nonzero += 1
                cg_nz.append(next_pos)
                gt1 = dec.decode_bin(ctx(f"GtxFlag{2 + ch}", off))
                rem_bins -= 1
                par = gt2 = 0
                if gt1:
                    par = dec.decode_bin(ctx(f"ParFlag{ch}", off))
                    gt2 = dec.decode_bin(ctx(f"GtxFlag{ch}", off))
                    rem_bins -= 2
                val = 1 + gt1 + par + 2 * gt2
                part[y][x] = val
                full[y][x] = val
                nzf[y][x] = 1
                if gt2:
                    gt2_list.append(next_pos)
            state = (self.state_tab >> ((state << 2)
                                        + ((val & 1) << 1))) & 3
            next_pos -= 1

        first_pos_mode2 = next_pos
        gt2_set = set(gt2_list)
        for pos in range(first_sig, first_pos_mode2, -1):
            if pos not in gt2_set:
                continue
            idx, x, y = scan_t[pos]
            sum_all = max(min(self._t5(full, x, y, w, h) - 20, 31), 0)
            rice = int(GO_RICE_PARS[sum_all])
            rem = dec.decode_rem_abs_ep(rice, COEF_REMAIN_BIN_REDUCTION,
                                        self.max_log2_dyn)
            full[y][x] += rem << 1

        for pos in range(first_pos_mode2, min_sub - 1, -1):
            idx, x, y = scan_t[pos]
            sum_all = max(min(self._t5(full, x, y, w, h), 31), 0)
            rice = int(GO_RICE_PARS[sum_all])
            pos0 = (1 if state < 2 else 2) << rice
            rem = dec.decode_rem_abs_ep(rice, COEF_REMAIN_BIN_REDUCTION,
                                        self.max_log2_dyn)
            if rem == pos0:
                a = 0
            elif rem < pos0:
                a = rem + 1
            else:
                a = rem
            state = (self.state_tab >> ((state << 2)
                                        + ((a & 1) << 1))) & 3
            if a:
                num_nonzero += 1
                cg_nz.append(pos)
                full[y][x] = a
                part[y][x] = min(4 + (a & 1), a)
                nzf[y][x] = 1

        if not cg_nz:
            return state, rem_bins
        first_nz, last_nz = cg_nz[-1], cg_nz[0]
        hide = self.sign_hiding and (last_nz - first_nz) >= 4
        num_signs = num_nonzero - (1 if hide else 0)
        pattern = dec.decode_bins_ep(num_signs) if num_signs else 0
        k = num_signs
        for i, pos in enumerate(cg_nz):
            idx, x, y = scan_t[pos]
            if hide and i == len(cg_nz) - 1:
                parity = sum(full[yy][xx] for (_, xx, yy) in
                             (scan_t[p] for p in cg_nz)) & 1
                sign[y][x] = parity
            else:
                k -= 1
                sign[y][x] = (pattern >> k) & 1
        return state, rem_bins
