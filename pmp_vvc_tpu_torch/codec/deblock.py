"""VVC deblocking filter — all-intra reduction, decoder-exact.

Contract: LoopFilter.cpp (VTM-10.0). For intra-only streams with
TU == PU == CU, one slice, no palette/BDPCM/LADF/virtual boundaries,
the general machinery reduces to:

- two picture passes: all vertical CU-boundary edges first
  (LoopFilter.cpp:140-200), then all horizontal edges on the partially
  filtered output (:200-244);
- boundary strength is 2 on every marked edge because both sides are
  intra (xGetBoundaryStrengthSingle :728-740);
- luma filters on the 4-sample grid along each CU left/top edge, chroma
  only where the edge lies on the 8-chroma-sample grid (:1208-1218);
- max filter lengths come from the two adjacent block sizes
  (xSetMaxFilterLengthPQFromTransformSizes :487-583): luma 1 if either
  side <= 4 else 7 where the side is >= 32 else 3; chroma 3 if both
  sides >= 8 (chroma samples) else 1.

Edges of the same direction never read samples written by a parallel
edge (the VVC read/write extents are designed for this), so edge order
within a pass is irrelevant; only the ver-then-hor pass order matters.
"""
from __future__ import annotations

import numpy as np

# sm_tcTable / sm_betaTable, LoopFilter.cpp:61-72 (10-bit domain)
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 4, 4, 4,
    4, 5, 5, 5, 5, 7, 7, 8, 9, 10, 10, 11, 13, 14, 15, 17, 19, 21, 24,
    25, 29, 33, 36, 41, 45, 51, 57, 64, 71, 80, 89, 100, 112, 125, 141,
    157, 177, 198, 222, 250, 280, 314, 352, 395], np.int32)
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88],
    np.int32)

_DB7 = (59, 50, 41, 32, 23, 14, 5)
_DB5 = (58, 45, 32, 19, 6)
_DB3 = (53, 32, 11)
_TC7 = (6, 5, 4, 3, 2, 1, 1)
_TC3 = (6, 4, 2)


def _clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def _dp(b, r, e, shift=0, ctb=False):
    """xCalcDP at ``shift`` samples left of the edge (:1717-1726)."""
    e = e + shift
    if ctb:
        return abs(int(b[r, e - 1]) - int(b[r, e - 2]))
    return abs(int(b[r, e - 3]) - 2 * int(b[r, e - 2]) + int(b[r, e - 1]))


def _dq(b, r, e, shift=0):
    """xCalcDQ at ``shift`` samples right of the edge (:1730-1734)."""
    e = e + shift
    return abs(int(b[r, e]) - 2 * int(b[r, e + 1]) + int(b[r, e + 2]))


def _use_strong(b, r, e, d2, beta, tc, side_p, side_q, len_p, len_q,
                chroma_ctb=False):
    """xUseStrongFiltering (:1660-1715)."""
    m4 = int(b[r, e])
    m3 = int(b[r, e - 1])
    m7 = int(b[r, e + 3])
    m0 = int(b[r, e - 4])
    sp3 = abs(int(b[r, e - 2]) - m3) if chroma_ctb else abs(m0 - m3)
    sq3 = abs(m7 - m4)
    if side_p or side_q:
        if side_p:
            if len_p == 7:
                sp3 += abs(int(b[r, e - 5]) - int(b[r, e - 6])
                           - int(b[r, e - 7]) + int(b[r, e - 8]))
                mp4 = int(b[r, e - 8])
            else:
                mp4 = int(b[r, e - 6])
            sp3 = (sp3 + abs(m0 - mp4) + 1) >> 1
        if side_q:
            if len_q == 7:
                sq3 += abs(int(b[r, e + 4]) - int(b[r, e + 5])
                           - int(b[r, e + 6]) + int(b[r, e + 7]))
                m11 = int(b[r, e + 7])
            else:
                m11 = int(b[r, e + 5])
            sq3 = (sq3 + abs(m11 - m7) + 1) >> 1
        return (sp3 + sq3 < (beta * 3 >> 5)) and d2 < (beta >> 4) \
            and abs(m3 - m4) < ((tc * 5 + 1) >> 1)
    return (sp3 + sq3 < (beta >> 3)) and d2 < (beta >> 2) \
        and abs(m3 - m4) < ((tc * 5 + 1) >> 1)


def _filter_long(b, r, e, n_p, n_q, tc):
    """xFilteringPandQ + xBilinearFilter (:1403-1500)."""
    p = [int(b[r, e - 1 - k]) for k in range(8)]
    q = [int(b[r, e + k]) for k in range(8)]
    ref_p = (p[{7: 6, 5: 4, 3: 2}[n_p]] + p[{7: 7, 5: 5, 3: 3}[n_p]] + 1) >> 1
    ref_q = (q[{7: 6, 5: 4, 3: 2}[n_q]] + q[{7: 7, 5: 5, 3: 3}[n_q]] + 1) >> 1
    if n_p == n_q:
        if n_p == 5:
            ref_m = (2 * (p[0] + q[0] + p[1] + q[1] + p[2] + q[2])
                     + p[3] + q[3] + p[4] + q[4] + 8) >> 4
        else:
            ref_m = (2 * (p[0] + q[0]) + p[1] + q[1] + p[2] + q[2]
                     + p[3] + q[3] + p[4] + q[4] + p[5] + q[5]
                     + p[6] + q[6] + 8) >> 4
    elif {n_p, n_q} == {7, 5}:
        ref_m = (2 * (p[0] + q[0] + p[1] + q[1]) + p[2] + q[2]
                 + p[3] + q[3] + p[4] + q[4] + p[5] + q[5] + 8) >> 4
    elif {n_p, n_q} == {7, 3}:
        s, t = (p, q) if n_p == 7 else (q, p)   # s = long side
        ref_m = (2 * (s[0] + t[0]) + t[0] + 2 * (t[1] + t[2])
                 + s[1] + t[1] + s[2] + s[3] + s[4] + s[5] + s[6] + 8) >> 4
    else:                                       # {5, 3}
        ref_m = (p[0] + q[0] + p[1] + q[1] + p[2] + q[2]
                 + p[3] + q[3] + 4) >> 3
    db_p = {7: _DB7, 5: _DB5, 3: _DB3}[n_p]
    db_q = {7: _DB7, 5: _DB5, 3: _DB3}[n_q]
    tc_p = _TC3 if n_p == 3 else _TC7
    tc_q = _TC3 if n_q == 3 else _TC7
    for k in range(n_p):
        c = (tc * tc_p[k]) >> 1
        b[r, e - 1 - k] = _clip3(p[k] - c, p[k] + c,
                                 (ref_m * db_p[k]
                                  + ref_p * (64 - db_p[k]) + 32) >> 6)
    for k in range(n_q):
        c = (tc * tc_q[k]) >> 1
        b[r, e + k] = _clip3(q[k] - c, q[k] + c,
                             (ref_m * db_q[k]
                              + ref_q * (64 - db_q[k]) + 32) >> 6)


def _pel_filter_luma(b, r, e, tc, sw, thr_cut, filt_p, filt_q, max_pel,
                     side_p, side_q, len_p, len_q):
    """xPelFilterLuma (:1501-1600), no-palette path."""
    m1 = int(b[r, e - 3]); m2 = int(b[r, e - 2]); m3 = int(b[r, e - 1])
    m4 = int(b[r, e]); m5 = int(b[r, e + 1]); m6 = int(b[r, e + 2])
    if sw:
        if side_p or side_q:
            _filter_long(b, r, e, len_p if side_p else 3,
                         len_q if side_q else 3, tc)
            return
        m0 = int(b[r, e - 4]); m7 = int(b[r, e + 3])
        b[r, e - 1] = _clip3(m3 - 3 * tc, m3 + 3 * tc,
                             (m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3)
        b[r, e] = _clip3(m4 - 3 * tc, m4 + 3 * tc,
                         (m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3)
        b[r, e - 2] = _clip3(m2 - 2 * tc, m2 + 2 * tc,
                             (m1 + m2 + m3 + m4 + 2) >> 2)
        b[r, e + 1] = _clip3(m5 - 2 * tc, m5 + 2 * tc,
                             (m3 + m4 + m5 + m6 + 2) >> 2)
        b[r, e - 3] = _clip3(m1 - tc, m1 + tc,
                             (2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3)
        b[r, e + 2] = _clip3(m6 - tc, m6 + tc,
                             (m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3)
        return
    delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4
    if abs(delta) >= thr_cut:
        return
    delta = _clip3(-tc, tc, delta)
    b[r, e - 1] = _clip3(0, max_pel, m3 + delta)
    b[r, e] = _clip3(0, max_pel, m4 - delta)
    tc2 = tc >> 1
    if filt_p:
        d1 = _clip3(-tc2, tc2, (((m1 + m3 + 1) >> 1) - m2 + delta) >> 1)
        b[r, e - 2] = _clip3(0, max_pel, m2 + d1)
    if filt_q:
        d2 = _clip3(-tc2, tc2, (((m6 + m4 + 1) >> 1) - m5 - delta) >> 1)
        b[r, e + 1] = _clip3(0, max_pel, m5 + d2)


def _pel_filter_chroma(b, r, e, tc, sw, max_pel, ctb):
    """xPelFilterChroma (:1601-1659), no-palette path."""
    m0 = int(b[r, e - 4]) if not ctb else 0
    m1 = int(b[r, e - 3]) if not ctb else 0
    m2 = int(b[r, e - 2]); m3 = int(b[r, e - 1])
    m4 = int(b[r, e]); m5 = int(b[r, e + 1])
    m6 = int(b[r, e + 2]); m7 = int(b[r, e + 3])
    if sw:
        if ctb:
            b[r, e - 1] = _clip3(m3 - tc, m3 + tc,
                                 (3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3)
            b[r, e] = _clip3(m4 - tc, m4 + tc,
                             (2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3)
            b[r, e + 1] = _clip3(m5 - tc, m5 + tc,
                                 (m2 + m3 + m4 + 2 * m5 + m6
                                  + 2 * m7 + 4) >> 3)
            b[r, e + 2] = _clip3(m6 - tc, m6 + tc,
                                 (m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3)
        else:
            b[r, e - 3] = _clip3(m1 - tc, m1 + tc,
                                 (3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3)
            b[r, e - 2] = _clip3(m2 - tc, m2 + tc,
                                 (2 * m0 + m1 + 2 * m2 + m3 + m4
                                  + m5 + 4) >> 3)
            b[r, e - 1] = _clip3(m3 - tc, m3 + tc,
                                 (m0 + m1 + m2 + 2 * m3 + m4 + m5
                                  + m6 + 4) >> 3)
            b[r, e] = _clip3(m4 - tc, m4 + tc,
                             (m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3)
            b[r, e + 1] = _clip3(m5 - tc, m5 + tc,
                                 (m2 + m3 + m4 + 2 * m5 + m6
                                  + 2 * m7 + 4) >> 3)
            b[r, e + 2] = _clip3(m6 - tc, m6 + tc,
                                 (m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3)
    else:
        delta = _clip3(-tc, tc, (((m4 - m3) * 4 + m2 - m5 + 4) >> 3))
        b[r, e - 1] = _clip3(0, max_pel, m3 + delta)
        b[r, e] = _clip3(0, max_pel, m4 - delta)


def _luma_len(p_size, q_size):
    if p_size <= 4 or q_size <= 4:
        return 1, 1
    return (7 if p_size >= 32 else 3), (7 if q_size >= 32 else 3)


def _filter_luma_edge(buf, e, r0, n, q_size, p_sizes, qp, bit_depth, ctu,
                      hor):
    """xEdgeFilterLuma (:929-1176) for one CU edge of ``n`` lines.

    ``buf`` is the plane for vertical edges / its transpose for
    horizontal ones; ``e`` the edge coordinate, ``r0`` the first line,
    ``p_sizes[i]`` the P-side block size for 4-line segment i.
    """
    tc_idx = _clip3(0, 65, qp + 2 + 0)          # bS==2 -> +2
    tc_tab = int(TC_TABLE[tc_idx])
    tc = (tc_tab << (bit_depth - 10)) if bit_depth >= 10 else \
        ((tc_tab + (1 << (9 - bit_depth))) >> (10 - bit_depth))
    beta = int(BETA_TABLE[_clip3(0, 63, qp)]) << (bit_depth - 8)
    side_thr = (beta + (beta >> 1)) >> 3
    thr_cut = tc * 10
    max_pel = (1 << bit_depth) - 1
    if tc == 0 and beta == 0:
        return
    for seg in range(n // 4):
        if p_sizes[seg] == 0:
            continue              # bS 0 (both sides BDPCM)
        r = r0 + 4 * seg
        len_p, len_q = _luma_len(p_sizes[seg], q_size)
        side_p = len_p > 3
        side_q = len_q > 3
        if hor and e % ctu == 0:
            side_p = False
        dp0 = _dp(buf, r, e); dq0 = _dq(buf, r, e)
        dp3 = _dp(buf, r + 3, e); dq3 = _dq(buf, r + 3, e)
        use_long = False
        if side_p or side_q:
            dp0l, dp3l, dq0l, dq3l = dp0, dp3, dq0, dq3
            if side_p:
                dp0l = (dp0l + _dp(buf, r, e, -3) + 1) >> 1
                dp3l = (dp3l + _dp(buf, r + 3, e, -3) + 1) >> 1
            if side_q:
                dq0l = (dq0l + _dq(buf, r, e, 3) + 1) >> 1
                dq3l = (dq3l + _dq(buf, r + 3, e, 3) + 1) >> 1
            d0l = dp0l + dq0l
            d3l = dp3l + dq3l
            if d0l + d3l < beta:
                filt_p = (dp0l + dp3l) < side_thr
                filt_q = (dq0l + dq3l) < side_thr
                swl = _use_strong(buf, r, e, 2 * d0l, beta, tc, side_p,
                                  side_q, len_p, len_q) \
                    and _use_strong(buf, r + 3, e, 2 * d3l, beta, tc,
                                    side_p, side_q, len_p, len_q)
                if swl:
                    use_long = True
                    for i in range(4):
                        _pel_filter_luma(buf, r + i, e, tc, True, thr_cut,
                                         filt_p, filt_q, max_pel, side_p,
                                         side_q, len_p, len_q)
        if not use_long:
            d = dp0 + dq0 + dp3 + dq3
            if d < beta:
                filt_p = filt_q = False
                if len_p > 1 and len_q > 1:
                    filt_p = (dp0 + dp3) < side_thr
                    filt_q = (dq0 + dq3) < side_thr
                sw = False
                if len_p > 2 and len_q > 2:
                    sw = _use_strong(buf, r, e, 2 * (dp0 + dq0), beta, tc,
                                     False, False, len_p, len_q) \
                        and _use_strong(buf, r + 3, e, 2 * (dp3 + dq3),
                                        beta, tc, False, False, len_p, len_q)
                for i in range(4):
                    _pel_filter_luma(buf, r + i, e, tc, sw, thr_cut,
                                     filt_p, filt_q, max_pel, False, False,
                                     len_p, len_q)


def _filter_chroma_edge(buf, e, r0, n, q_size, p_sizes, qps, bit_depth,
                        ctb_boundary):
    """xEdgeFilterChroma (:1177-1402) for one chroma CU edge.

    ``n`` lines (chroma samples), 2-line segments; ``q_size``/``p_sizes``
    in chroma samples along the perpendicular direction; ``qps[seg]``
    the per-segment averaged chroma QP ((baseQp_P + baseQp_Q + 1) >> 1,
    :1322-1330 — per-TU because JCCR mode-2 TUs map through the
    JOINT_CbCr offset, QpParam Quant.cpp:105-126).
    """
    max_pel = (1 << bit_depth) - 1
    for seg in range(n // 2):
        if p_sizes[seg] == 0:
            continue              # bS 0 (both sides BDPCM)
        qp = qps[seg]
        tc_idx = _clip3(0, 65, qp + 2 + 0)
        tc_tab = int(TC_TABLE[tc_idx])
        tc = (tc_tab << (bit_depth - 10)) if bit_depth >= 10 else \
            ((tc_tab + (1 << (9 - bit_depth))) >> (10 - bit_depth))
        beta = int(BETA_TABLE[_clip3(0, 63, qp)]) << (bit_depth - 8)
        r = r0 + 2 * seg
        p_size = p_sizes[seg]
        large = p_size >= 8 and q_size >= 8
        if tc == 0 and (not large or beta == 0) and tc == 0:
            pass  # weak filter with tc 0 is a no-op but VTM still runs it
        use_long = False
        if large:
            dp0 = _dp(buf, r, e, ctb=ctb_boundary)
            dq0 = _dq(buf, r, e)
            dp3 = _dp(buf, r + 1, e, ctb=ctb_boundary)
            dq3 = _dq(buf, r + 1, e)
            d0 = dp0 + dq0
            d3 = dp3 + dq3
            if d0 + d3 < beta:
                use_long = True
                sw = _use_strong(buf, r, e, 2 * d0, beta, tc, False, False,
                                 7, 7, ctb_boundary) \
                    and _use_strong(buf, r + 1, e, 2 * d3, beta, tc, False,
                                    False, 7, 7, ctb_boundary)
                for i in range(2):
                    _pel_filter_chroma(buf, r + i, e, tc, sw, max_pel,
                                       ctb_boundary)
        if not use_long:
            for i in range(2):
                _pel_filter_chroma(buf, r + i, e, tc, False, max_pel,
                                   ctb_boundary)


def deblock_frame(recon_y, recon_u, recon_v, luma_cus, chroma_cus,
                  qp, qp_c, bit_depth=10, ctu_size=128,
                  qp_c_joint=None, joint2=None,
                  bdpcm_luma=None, bdpcm_chroma=None):
    """In-place deblocking of one all-intra picture.

    ``luma_cus``: leaf CUs (x, y, w, h) in luma samples; ``chroma_cus``:
    leaf CUs in chroma samples (single tree: luma CUs halved).  ``qp``:
    slice luma QP; ``qp_c``: chroma deblock QP (mapped table value
    without the bit-depth offset, QpParam usage at :1322-1330).
    ``qp_c_joint``/``joint2``: JCCR-mode-2 chroma QP and the per-2x2-
    chroma-unit bool grid of TUs coded in that mode — those TUs deblock
    with the JOINT_CbCr offset (QpParam Quant.cpp:112 useJQP).
    ``bdpcm_luma``/``bdpcm_chroma``: (H/4, W/4) bool grids — edge
    segments with BDPCM on BOTH sides get boundary strength 0
    (LoopFilter.cpp:732/:737) and are skipped (p_size sentinel 0).
    """
    hl, wl = recon_y.shape
    hc, wc = recon_u.shape
    # per-4x4 (luma) / per-2x2 (chroma) block-size grids for P-side lookup
    lw = np.zeros((hl // 4, wl // 4), np.int32)
    lh = np.zeros_like(lw)
    for (x, y, w, h) in luma_cus:
        lw[y // 4:(y + h) // 4, x // 4:(x + w) // 4] = w
        lh[y // 4:(y + h) // 4, x // 4:(x + w) // 4] = h
    cw = np.zeros((hc // 2, wc // 2), np.int32)
    ch = np.zeros_like(cw)
    for (x, y, w, h) in chroma_cus:
        cw[y // 2:(y + h) // 2, x // 2:(x + w) // 2] = w
        ch[y // 2:(y + h) // 2, x // 2:(x + w) // 2] = h
    # per-2x2-chroma-unit base QP (JCCR mode 2 -> joint offset)
    if joint2 is not None and qp_c_joint is not None:
        cqp = np.where(joint2, qp_c_joint, qp_c).astype(np.int32)
    else:
        cqp = np.full((hc // 2, wc // 2), qp_c, np.int32)

    for hor in (False, True):                    # ver pass, then hor pass
        yb = recon_y.T if hor else recon_y
        for (x, y, w, h) in luma_cus:
            if hor:
                e, r0, n, q_size = y, x, w, h
                p_sizes = [int(lh[(y - 1) // 4, (x + 4 * s) // 4])
                           for s in range(n // 4)] if y > 0 else []
                if bdpcm_luma is not None and y > 0:
                    p_sizes = [0 if (bdpcm_luma[(y - 1) // 4,
                                                (x + 4 * s) // 4]
                                     and bdpcm_luma[y // 4,
                                                    (x + 4 * s) // 4])
                               else p_sizes[s] for s in range(n // 4)]
            else:
                e, r0, n, q_size = x, y, h, w
                p_sizes = [int(lw[(y + 4 * s) // 4, (x - 1) // 4])
                           for s in range(n // 4)] if x > 0 else []
                if bdpcm_luma is not None and x > 0:
                    p_sizes = [0 if (bdpcm_luma[(y + 4 * s) // 4,
                                                (x - 1) // 4]
                                     and bdpcm_luma[(y + 4 * s) // 4,
                                                    x // 4])
                               else p_sizes[s] for s in range(n // 4)]
            if e > 0:
                _filter_luma_edge(yb, e, r0, n, q_size, p_sizes, qp,
                                  bit_depth, ctu_size, hor)
        ctu_c = ctu_size // 2
        for (x, y, w, h) in chroma_cus:
            if hor:
                if y == 0 or y % 8 != 0:
                    continue
                e, r0, n, q_size = y, x, w, h
                p_sizes = [int(ch[(y - 1) // 2, (x + 2 * s) // 2])
                           for s in range(n // 2)]
                if bdpcm_chroma is not None:
                    p_sizes = [0 if (bdpcm_chroma[(y - 1) // 2,
                                                  (x + 2 * s) // 2]
                                     and bdpcm_chroma[y // 2,
                                                      (x + 2 * s) // 2])
                               else p_sizes[s] for s in range(n // 2)]
                qps = [(int(cqp[(y - 1) // 2, (x + 2 * s) // 2])
                        + int(cqp[y // 2, (x + 2 * s) // 2]) + 1) >> 1
                       for s in range(n // 2)]
                ctb = (y % ctu_c == 0)
            else:
                if x == 0 or x % 8 != 0:
                    continue
                e, r0, n, q_size = x, y, h, w
                p_sizes = [int(cw[(y + 2 * s) // 2, (x - 1) // 2])
                           for s in range(n // 2)]
                if bdpcm_chroma is not None:
                    p_sizes = [0 if (bdpcm_chroma[(y + 2 * s) // 2,
                                                  (x - 1) // 2]
                                     and bdpcm_chroma[(y + 2 * s) // 2,
                                                      x // 2])
                               else p_sizes[s] for s in range(n // 2)]
                qps = [(int(cqp[(y + 2 * s) // 2, (x - 1) // 2])
                        + int(cqp[(y + 2 * s) // 2, x // 2]) + 1) >> 1
                       for s in range(n // 2)]
                ctb = False
            buf_u = recon_u.T if hor else recon_u
            buf_v = recon_v.T if hor else recon_v
            _filter_chroma_edge(buf_u, e, r0, n, q_size, p_sizes, qps,
                                bit_depth, ctb)
            _filter_chroma_edge(buf_v, e, r0, n, q_size, p_sizes, qps,
                                bit_depth, ctb)
