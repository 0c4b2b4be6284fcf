"""Sample Adaptive Offset — decoder-exact application + encoder decision.

Contracts (VTM-10.0):
- application: SampleAdaptiveOffset::offsetBlock
  (SampleAdaptiveOffset.cpp:293-547) with its exact per-type boundary
  regions; offsetCTU / SAOProcess (:549-660): SAO reads the deblocked
  picture copy and writes per-CTU, after deblocking.
- offset inversion: invertQuantOffsets (:148-172) — EO classes 0/1 get
  +coded, 3/4 get -coded (CABACReader.cpp sao() tail), class 2 is 0;
  10-bit offsetStepLog2 = 0.
- syntax: CABACWriter::sao / sao_block_pars / sao_offset_pars
  (CABACWriter.cpp:~780-940) with contexts SaoMergeFlag / SaoTypeIdx and
  unary_max_eqprob(maxOffsetQVal = 31 at 10-bit).

The encoder decision here is distortion-optimal per class with a
lambda-scaled rate proxy (VTM's RDO estimator simplified); any choice is
conformant because the decoder replays whatever is signalled.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .residual import ctx

# EO neighbour displacements (dy, dx): offsetBlock cases :308-530
_EO_NBRS = {
    0: ((0, -1), (0, 1)),       # SAO_TYPE_EO_0   horizontal
    1: ((-1, 0), (1, 0)),       # SAO_TYPE_EO_90  vertical
    2: ((-1, -1), (1, 1)),      # SAO_TYPE_EO_135 down-right diagonal
    3: ((-1, 1), (1, -1)),      # SAO_TYPE_EO_45  up-right diagonal
}
MODE_OFF, MODE_NEW = 0, 1
TYPE_BO = 4                      # SAO_TYPE_START_BO


@dataclass
class SaoCompParam:
    mode: int = MODE_OFF         # OFF / NEW (merge never signalled here)
    type_idc: int = 0            # 0..3 EO class, 4 = BO
    offsets: tuple = (0, 0, 0, 0, 0)   # per class (EO: 5, signs applied)
    band_pos: int = 0            # BO start band


@dataclass
class SaoCtuParam:
    comps: list = field(default_factory=lambda: [SaoCompParam(),
                                                 SaoCompParam(),
                                                 SaoCompParam()])


def _avail(x0, y0, w, h, pic_w, pic_h):
    """deriveLoopFilterBoundaryAvailibility, single slice / no tiles."""
    return dict(left=x0 > 0, right=x0 + w < pic_w, above=y0 > 0,
                below=y0 + h < pic_h,
                al=x0 > 0 and y0 > 0, ar=x0 + w < pic_w and y0 > 0,
                bl=x0 > 0 and y0 + h < pic_h,
                br=x0 + w < pic_w and y0 + h < pic_h)


def _eo_class_mask(plane, x0, y0, w, h, eo_type, av):
    """Per-pixel EO class (0..4) + processed mask for one CTU block.

    Mirrors the loop bounds of offsetBlock exactly (the skipped first /
    last rows / columns per availability)."""
    ph, pw = plane.shape
    pad = np.pad(plane, 1, mode="edge")
    win = pad[y0 + 1:y0 + 1 + h, x0 + 1:x0 + 1 + w].astype(np.int64)
    (dy1, dx1), (dy2, dx2) = _EO_NBRS[eo_type]
    n1 = pad[y0 + 1 + dy1:y0 + 1 + dy1 + h,
             x0 + 1 + dx1:x0 + 1 + dx1 + w].astype(np.int64)
    n2 = pad[y0 + 1 + dy2:y0 + 1 + dy2 + h,
             x0 + 1 + dx2:x0 + 1 + dx2 + w].astype(np.int64)
    cls = (np.sign(win - n1) + np.sign(win - n2) + 2).astype(np.int32)

    m = np.zeros((h, w), bool)
    start_x = 0 if av["left"] else 1
    end_x = w if av["right"] else w - 1
    start_y = 0 if av["above"] else 1
    end_y = h if av["below"] else h - 1
    if eo_type == 0:
        m[:, start_x:end_x] = True
    elif eo_type == 1:
        m[start_y:end_y, :] = True
    elif eo_type == 2:
        m[1:h - 1, start_x:end_x] = True
        m[0, (0 if av["al"] else 1):(end_x if av["above"] else 1)] = True
        m[h - 1, (start_x if av["below"] else w - 1):
          (w if av["br"] else w - 1)] = True
    else:
        m[1:h - 1, start_x:end_x] = True
        m[0, (start_x if av["above"] else w - 1):
          (w if av["ar"] else w - 1)] = True
        m[h - 1, (0 if av["bl"] else 1):(end_x if av["below"] else 1)] = True
    return cls, m


def _apply_comp(src, dst, x0, y0, w, h, par: SaoCompParam, bit_depth,
                pic_w, pic_h):
    """offsetBlock for one component block; src is the pre-SAO copy."""
    max_pel = (1 << bit_depth) - 1
    blk = src[y0:y0 + h, x0:x0 + w].astype(np.int64)
    if par.type_idc == TYPE_BO:
        lut = np.zeros(32, np.int64)
        for k in range(4):
            lut[(par.band_pos + k) % 32] = par.offsets[k]
        shift = bit_depth - 5
        out = np.clip(blk + lut[blk >> shift], 0, max_pel)
        dst[y0:y0 + h, x0:x0 + w] = out
    else:
        av = _avail(x0, y0, w, h, pic_w, pic_h)
        cls, m = _eo_class_mask(src, x0, y0, w, h, par.type_idc, av)
        lut = np.asarray(par.offsets, np.int64)
        out = np.clip(blk + lut[cls], 0, max_pel)
        cur = dst[y0:y0 + h, x0:x0 + w]
        dst[y0:y0 + h, x0:x0 + w] = np.where(m, out, cur)


def apply_sao_frame(planes, params, ctu_size, bit_depth=10):
    """SAOProcess: per-CTU offsets over a copy of the (deblocked) recon."""
    srcs = [p.copy() for p in planes]
    pic_h, pic_w = planes[0].shape
    n_ctu_x = (pic_w + ctu_size - 1) // ctu_size
    idx = 0
    for y0 in range(0, pic_h, ctu_size):
        for x0 in range(0, pic_w, ctu_size):
            par = params[idx]
            idx += 1
            for c in range(3):
                cp = par.comps[c]
                if cp.mode == MODE_OFF:
                    continue
                scale = 1 if c == 0 else 2
                _apply_comp(srcs[c], planes[c], x0 // scale, y0 // scale,
                            min(ctu_size, pic_w - x0) // scale,
                            min(ctu_size, pic_h - y0) // scale,
                            cp, bit_depth, pic_w // scale, pic_h // scale)


# ---- encoder decision ----------------------------------------------------

def _best_offset(cnt, s, lo, hi):
    """argmin_off cnt*off^2 - 2*off*s over [lo, hi] (integer)."""
    if cnt == 0:
        return 0, 0
    off = int(np.round(s / cnt))
    off = max(lo, min(hi, off))
    best = (cnt * off * off - 2 * off * s, off)
    for o in (off - 1, off + 1):
        if lo <= o <= hi:
            d = cnt * o * o - 2 * o * s
            if d < best[0]:
                best = (d, o)
    return best[1], best[0]


def _decide_comp(org, rec, x0, y0, w, h, bit_depth, lam, pic_w, pic_h):
    """Best (cost_delta, SaoCompParam) per candidate type for one block."""
    o = org[y0:y0 + h, x0:x0 + w].astype(np.int64)
    r = rec[y0:y0 + h, x0:x0 + w].astype(np.int64)
    diff = o - r
    av = _avail(x0, y0, w, h, pic_w, pic_h)
    results = []
    for t in range(4):
        cls, m = _eo_class_mask(rec, x0, y0, w, h, t, av)
        offs = [0] * 5
        dist = 0.0
        bits = 3 + 2        # type bins + class bins (rough)
        for k in (0, 1, 3, 4):
            sel = m & (cls == k)
            cnt = int(sel.sum())
            s = int(diff[sel].sum())
            lo, hi = (0, 31) if k < 2 else (-31, 0)
            off, d = _best_offset(cnt, s, lo, hi)
            offs[k] = off
            dist += d
            bits += abs(off) + 1
        results.append((dist + lam * bits,
                        SaoCompParam(MODE_NEW, t, tuple(offs))))
    # band offset
    shift = bit_depth - 5
    band = (r >> shift).astype(np.int32)
    cnts = np.bincount(band.ravel(), minlength=32)
    sums = np.bincount(band.ravel(), weights=diff.ravel(), minlength=32)
    b_off = np.zeros(32, np.int64)
    b_d = np.zeros(32)
    for b in range(32):
        b_off[b], b_d[b] = _best_offset(int(cnts[b]), int(sums[b]), -31, 31)
    best_b, best_c = 0, None
    for b in range(29):                 # VTM restricts start band <= 28
        d = float(b_d[b:b + 4].sum())
        bits = 3 + 5 + sum(abs(int(x)) + 2 for x in b_off[b:b + 4])
        c = d + lam * bits
        if best_c is None or c < best_c:
            best_c, best_b = c, b
    results.append((best_c,
                    SaoCompParam(MODE_NEW, TYPE_BO,
                                 tuple(int(x) for x in b_off[best_b:
                                                             best_b + 4]),
                                 best_b)))
    return results


def decide_sao_frame(org_planes, rec_planes, ctu_size, qp, bit_depth=10,
                     lam=None):
    """Per-CTU SAO parameters (merge never used; OFF when not beneficial).

    ``lam``: slice lambda; default reproduces EncSlice::initializeLambda
    at the internal bit depth (bitDepthShift = 6*(bd-8) - 12)."""
    if lam is None:
        lam = 0.57 * 2.0 ** ((qp + 6 * (bit_depth - 8) - 12) / 3.0)
    pic_h, pic_w = org_planes[0].shape
    params = []
    for y0 in range(0, pic_h, ctu_size):
        for x0 in range(0, pic_w, ctu_size):
            par = SaoCtuParam()
            w = min(ctu_size, pic_w - x0)
            h = min(ctu_size, pic_h - y0)
            # luma: independent choice
            cands = _decide_comp(org_planes[0], rec_planes[0], x0, y0, w, h,
                                 bit_depth, lam, pic_w, pic_h)
            best = min(cands, key=lambda t: t[0])
            if best[0] < -lam:          # beats OFF (cost 1 bin)
                par.comps[0] = best[1]
            # chroma: Cr follows Cb's mode/type -> joint choice
            cb = _decide_comp(org_planes[1], rec_planes[1], x0 // 2, y0 // 2,
                              w // 2, h // 2, bit_depth, lam,
                              pic_w // 2, pic_h // 2)
            cr = _decide_comp(org_planes[2], rec_planes[2], x0 // 2, y0 // 2,
                              w // 2, h // 2, bit_depth, lam,
                              pic_w // 2, pic_h // 2)
            joint = [(cb[i][0] + cr[i][0], cb[i][1], cr[i][1])
                     for i in range(len(cb))
                     if cb[i][1].type_idc == cr[i][1].type_idc]
            bj = min(joint, key=lambda t: t[0])
            if bj[0] < -lam:
                par.comps[1] = bj[1]
                par.comps[2] = bj[2]
            params.append(par)
    return params


# ---- syntax --------------------------------------------------------------

def _unary_max_eqprob(enc, val, max_val):
    """CABACWriter::unary_max_eqprob."""
    bins, n = 0, 0
    for _ in range(val):
        bins = (bins << 1) | 1
        n += 1
    if val < max_val:
        bins <<= 1
        n += 1
    if n:
        enc.encode_bins_ep(bins, n)


def write_sao_ctu(enc, par: SaoCtuParam, left_avail, above_avail,
                  bit_depth=10):
    """CABACWriter::sao + sao_block_pars (no merge signalled)."""
    if left_avail:
        enc.encode_bin(0, ctx("SaoMergeFlag", 0))
    if above_avail:
        enc.encode_bin(0, ctx("SaoMergeFlag", 0))
    max_q = (1 << (min(bit_depth, 10) - 5)) - 1
    for comp in range(3):
        cp = par.comps[comp]
        first_of_ch = comp in (0, 1)
        if first_of_ch:
            if cp.mode == MODE_OFF:
                enc.encode_bin(0, ctx("SaoTypeIdx", 0))
                continue
            enc.encode_bin(1, ctx("SaoTypeIdx", 0))
            enc.encode_bin_ep(0 if cp.type_idc == TYPE_BO else 1)
        elif cp.mode == MODE_OFF:       # Cr follows Cb: nothing coded
            continue
        if cp.type_idc == TYPE_BO:
            coded = [cp.offsets[k] for k in range(4)]
        else:
            coded = [cp.offsets[0], cp.offsets[1],
                     cp.offsets[3], cp.offsets[4]]
        for v in coded:
            _unary_max_eqprob(enc, abs(v), max_q)
        if cp.type_idc == TYPE_BO:
            for v in coded:
                if v:
                    enc.encode_bin_ep(1 if v < 0 else 0)
            enc.encode_bins_ep(cp.band_pos, 5)
        elif first_of_ch:
            enc.encode_bins_ep(cp.type_idc, 2)


def _parse_unary_max_eqprob(dec, max_val):
    """CABACReader::unary_max_eqprob."""
    v = 0
    while v < max_val and dec.decode_bin_ep():
        v += 1
    return v


def parse_sao_ctu(dec, left_avail, above_avail, bit_depth=10,
                  left_par=None, above_par=None):
    """CABACReader::sao — parse mirror of ``write_sao_ctu`` (our encoder
    never signals merge, but stock VTM streams do: a set merge flag
    copies the whole neighbour param; Cr inherits Cb's mode/type)."""
    import copy
    par = SaoCtuParam()
    if left_avail:
        if dec.decode_bin(ctx("SaoMergeFlag", 0)):
            return copy.deepcopy(left_par)
    if above_avail:
        if dec.decode_bin(ctx("SaoMergeFlag", 0)):
            return copy.deepcopy(above_par)
    max_q = (1 << (min(bit_depth, 10) - 5)) - 1

    def offsets4():
        return [_parse_unary_max_eqprob(dec, max_q) for _ in range(4)]

    def bo_tail(cp, coded):
        signed = [(-c if c and dec.decode_bin_ep() else c) for c in coded]
        cp.offsets = tuple(signed)
        cp.band_pos = dec.decode_bins_ep(5)

    for comp in (0, 1):
        cp = par.comps[comp]
        if dec.decode_bin(ctx("SaoTypeIdx", 0)) == 0:
            continue
        cp.mode = MODE_NEW
        is_eo = dec.decode_bin_ep()
        coded = offsets4()
        if not is_eo:
            cp.type_idc = TYPE_BO
            bo_tail(cp, coded)
        else:
            cp.offsets = (coded[0], coded[1], 0, -coded[2], -coded[3])
            cp.type_idc = dec.decode_bins_ep(2)
        if comp == 1:                    # Cr follows Cb's mode/type
            cr = par.comps[2]
            cr.mode = MODE_NEW
            cr.type_idc = cp.type_idc
            c2 = offsets4()
            if cp.type_idc == TYPE_BO:
                bo_tail(cr, c2)
            else:
                cr.offsets = (c2[0], c2[1], 0, -c2[2], -c2[3])
    return par
