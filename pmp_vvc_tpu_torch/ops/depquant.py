"""Dependent quantization (trellis-coded quantization) — decoder-exact.

Contract: DepQuant.cpp (VTM-10.0):
- Quantizer::dequantBlock (:713-780): scan-order state machine starting
  at the last significant position, qIdx = 2*level -/+ (state >> 1),
  QP+1 parameter set (shift = IQUANT_SHIFT + 1 - qpPer - tShift), state
  transition table packed in the 16-bit constant 32040, applied at every
  scan position (zeros included);
- Quantizer::initQuantBlock (:668-711): QShift = QUANT_SHIFT - 1 + qpPer
  + tShift for the forward scale.

The encoder here quantizes greedily in decoding order (distortion-
nearest level in the current state's quantizer); VTM's full 8-state
Viterbi trellis (DepQuant::quant :1627) is the round-2 RDOQ upgrade.
The decoder replays whatever states the levels imply, so greedy output
is conformant by construction.
"""
from __future__ import annotations

import numpy as np

from .quant import (COEFF_MAX, COEFF_MIN, INV_QUANT_SCALES, IQUANT_SHIFT,
                    QUANT_SCALES, QUANT_SHIFT, _geom)

STATE_TAB = 32040


def _params(w, h, qp, bit_depth):
    t_shift, sqrt2 = _geom(w, h, bit_depth)
    qp_dq = qp + 1
    per, rem = qp_dq // 6, qp_dq % 6
    tr_shift = t_shift - sqrt2
    q_shift = QUANT_SHIFT - 1 + per + tr_shift
    q_scale = int(QUANT_SCALES[sqrt2][rem])
    inv_shift = IQUANT_SHIFT + 1 - per - tr_shift
    inv_scale = int(INV_QUANT_SCALES[sqrt2][rem])
    return q_shift, q_scale, inv_shift, inv_scale


def dep_dequant(levels, scan, *, w, h, qp, bit_depth=10):
    """Quantizer::dequantBlock over flat scan (scan[k] = blkPos)."""
    lev = np.asarray(levels).reshape(-1)
    _, _, inv_shift, inv_scale = _params(w, h, qp, bit_depth)
    add = 0 if inv_shift < 0 else (1 << inv_shift) >> 1
    out = np.zeros(w * h, np.int64)
    nz = np.nonzero(lev[scan])[0]
    if nz.size == 0:
        return out.reshape(h, w)
    last = int(nz[-1])
    state = 0
    for k in range(last, -1, -1):
        level = int(lev[scan[k]])
        if level:
            if inv_shift < 0 and k == last:
                inv_scale <<= -inv_shift
            q_idx = (level << 1) + (-(state >> 1) if level > 0
                                    else (state >> 1))
            v = (q_idx * inv_scale + add) >> max(inv_shift, 0)
            out[scan[k]] = min(max(v, COEFF_MIN), COEFF_MAX)
        state = (STATE_TAB >> ((state << 2) + ((level & 1) << 1))) & 3
    return out.reshape(h, w)


def _last_pos_bits(px, py, w, h, is_luma, est, _ctx):
    """Fractional bits of last_sig_coeff_{x,y} (CABACWriter
    ::last_sig_coeff contract mirrored from residual._last_sig_coeff)."""
    from ..codec.residual import GROUP_IDX, MIN_IN_GROUP, ZERO_OUT_TH
    gx, gy = int(GROUP_IDX[px]), int(GROUP_IDX[py])
    max_x = int(GROUP_IDX[min(ZERO_OUT_TH, w) - 1])
    max_y = int(GROUP_IDX[min(ZERO_OUT_TH, h) - 1])
    ch = 0 if is_luma else 1
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    if is_luma:
        prefix_ctx = (0, 0, 0, 3, 6, 10, 15, 21)
        off_x, off_y = prefix_ctx[log2w], prefix_ctx[log2h]
        shift_x = (log2w + 1) >> 2
        shift_y = (log2h + 1) >> 2
    else:
        off_x = off_y = 0
        shift_x = min(2, max(0, w >> 3))
        shift_y = min(2, max(0, h >> 3))
    b = 0
    for c in range(gx):
        b += est.bin_bits(1, _ctx(f"LastX{ch}", off_x + (c >> shift_x)))
    if gx < max_x:
        b += est.bin_bits(0, _ctx(f"LastX{ch}", off_x + (gx >> shift_x)))
    for c in range(gy):
        b += est.bin_bits(1, _ctx(f"LastY{ch}", off_y + (c >> shift_y)))
    if gy < max_y:
        b += est.bin_bits(0, _ctx(f"LastY{ch}", off_y + (gy >> shift_y)))
    ep = 0
    if gx > 3:
        ep += (gx - 2) >> 1
    if gy > 3:
        ep += (gy - 2) >> 1
    return b / 32768.0 + ep


def dep_quant_trellis(coef, scan, *, w, h, qp, bit_depth=10, lam=None,
                      is_luma=True, est=None):
    """VTM-shaped TCQ trellis (DepQuant::quant :1627): 4 regular states
    + a virtual START state that optimizes the LAST-significant
    position jointly (State::checkRdCostStart + lastOffset), with
    CABAC rates from the live context estimator — sig/gt1/par/gt2
    fracBits at the contexts the residual writer will use (static
    template approximation: contexts derive from a greedy pre-pass
    instead of per-path level memories; sbb flags and the reg-bin
    budget are not modelled).

    Distortion uses VTM's normalization (initQuantBlock :668): cost of
    quantization index q for scaled target r is F * (q^2 - 2*q*r)
    relative to coding zero, F folding 1/lambda so costs are in bits.
    """
    from ..codec.estimator import RateEstimator, rem_abs_ep_bits
    from ..codec.residual import (COEF_REMAIN_BIN_REDUCTION,
                                  GO_RICE_PARS, ctx as _ctx)
    c = np.asarray(coef).reshape(-1).astype(np.int64)
    q_shift, q_scale, _, _ = _params(w, h, qp, bit_depth)
    t_shift, sqrt2 = _geom(w, h, bit_depth)
    if lam is None:
        # slice lambda at the internal (bit-depth-offset) QP
        # (EncSlice::initializeLambda bitDepthShift) + the dep-quant
        # slope adjustment (calculateLambda)
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0) * 2.0 ** (0.25 / 3.0)
    if est is None:
        est = RateEstimator.standard_init(max(0, min(63, qp - 12)), 2)
    f = 2.0 ** (-2 * t_shift + sqrt2 + 2 * q_shift) \
        / (float(q_scale) ** 2 * lam)
    r_all = np.abs(c[scan]).astype(np.float64) * q_scale / (1 << q_shift)
    n = len(scan)
    lev = np.zeros(w * h, np.int64)
    if not r_all.any():
        return lev.reshape(h, w)

    # ---- static context field from a greedy pre-pass ------------------
    pre = np.abs(dep_quant_greedy(coef, scan, w=w, h=h, qp=qp,
                                  bit_depth=bit_depth)).astype(np.int64)
    pad = np.zeros((h + 2, w + 2), np.int64)

    def win5(a):
        pad[:] = 0
        pad[:h, :w] = a
        return (pad[0:h, 1:w + 1] + pad[0:h, 2:w + 2]
                + pad[1:h + 1, 1:w + 1] + pad[1:h + 1, 0:w]
                + pad[2:h + 2, 0:w])

    ts_sum = win5(np.minimum(4 + (pre & 1), pre))
    ts_num = win5((pre != 0).astype(np.int64))
    ta_sum = win5(pre)
    xs = scan % w
    ys = scan // w
    diag = xs + ys
    sig_ofs = np.minimum((ts_sum[ys, xs] + 1) >> 1, 3) \
        + np.where(diag < 2, 4, 0)
    gt_off = np.minimum(ts_sum[ys, xs] - ts_num[ys, xs], 4) + 1
    if is_luma:
        sig_ofs = sig_ofs + np.where(diag < 5, 4, 0)
        gt_off = gt_off + np.where(diag == 0, 15,
                                   np.where(diag < 3, 10,
                                            np.where(diag < 10, 5, 0)))
    else:
        gt_off = gt_off + np.where(diag == 0, 5, 0)
    rice = GO_RICE_PARS[np.clip(ta_sum[ys, xs] - 20, 0, 31)]
    ch = 0 if is_luma else 1
    # per-position rate tables (bits, float): sig flag per state row
    sig_b = np.empty((3, n, 2))
    for row, sset in enumerate((ch, ch + 2, ch + 4)):
        ids = [_ctx(f"SigFlag{sset}", int(o)) for o in sig_ofs]
        sig_b[row, :, 0] = [est.bin_bits(0, i) / 32768.0 for i in ids]
        sig_b[row, :, 1] = [est.bin_bits(1, i) / 32768.0 for i in ids]
    gt1_ids = [_ctx(f"GtxFlag{2 + ch}", int(o)) for o in gt_off]
    par_ids = [_ctx(f"ParFlag{ch}", int(o)) for o in gt_off]
    gt2_ids = [_ctx(f"GtxFlag{ch}", int(o)) for o in gt_off]
    gtpb = np.empty((n, 6))
    for k in range(n):
        gtpb[k] = (est.bin_bits(0, gt1_ids[k]), est.bin_bits(1, gt1_ids[k]),
                   est.bin_bits(0, par_ids[k]), est.bin_bits(1, par_ids[k]),
                   est.bin_bits(0, gt2_ids[k]), est.bin_bits(1, gt2_ids[k]))
    gtpb /= 32768.0
    # last-coefficient (template never set) variant: offset 0
    lb = [est.bin_bits(b, _ctx(f"GtxFlag{2 + ch}", 0)) / 32768.0
          for b in (0, 1)]
    lpb = [est.bin_bits(b, _ctx(f"ParFlag{ch}", 0)) / 32768.0
           for b in (0, 1)]
    lgb = [est.bin_bits(b, _ctx(f"GtxFlag{ch}", 0)) / 32768.0
           for b in (0, 1)]

    def level_bits(k, L, last):
        rem = L - 1
        g1, pr, g2 = ((lb, lpb, lgb) if last else
                      (gtpb[k][0:2], gtpb[k][2:4], gtpb[k][4:6]))
        b = 1.0 + g1[1 if rem else 0]          # sign EP + gt1
        if rem:
            b += pr[rem & 1]
            rem >>= 1
            b += g2[1 if rem else 0]
        if L >= 4:
            b += rem_abs_ep_bits((L - 4) >> 1, int(rice[k]),
                                 COEF_REMAIN_BIN_REDUCTION)
        return b

    last_bits = {}

    def get_last_bits(k):
        if k not in last_bits:
            last_bits[k] = _last_pos_bits(int(xs[k]), int(ys[k]), w, h,
                                          is_luma, est, _ctx)
        return last_bits[k]

    # ---- trellis ------------------------------------------------------
    big = 1e30
    cost = [big] * 4
    back = np.zeros((n, 4), np.int64)
    prev = np.full((n, 4), 5, np.int8)          # 4 = came from START
    srow = (0, 0, 1, 2)                          # state -> sig ctx row
    for k in range(n - 1, -1, -1):
        r = float(r_all[k])
        ncost = [big] * 4
        nback = [0] * 4
        nprev = [5] * 4
        for s in range(4):
            cs = cost[s]
            if cs >= big:
                continue
            off = s >> 1
            base = int((r + off) // 2.0)
            sb = sig_b[srow[s], k]
            for L in {0, max(0, base), base + 1, max(0, base - 1)}:
                if L:
                    q = 2 * L - off
                    tot = cs + f * (q * q - 2.0 * q * r) + sb[1] \
                        + level_bits(k, L, False)
                else:
                    tot = cs + sb[0]
                s2 = (STATE_TAB >> ((s << 2) + ((L & 1) << 1))) & 3
                if tot < ncost[s2]:
                    ncost[s2] = tot
                    nback[s2] = L
                    nprev[s2] = s
        # START -> this position is the LAST significant coefficient
        if r > 0.25:
            base = int(r // 2.0)
            for L in (max(1, base - 1), max(1, base), base + 1):
                q = 2 * L
                tot = f * (q * q - 2.0 * q * r) \
                    + get_last_bits(k) + level_bits(k, L, True)
                s2 = (STATE_TAB >> ((L & 1) << 1)) & 3
                if tot < ncost[s2]:
                    ncost[s2] = tot
                    nback[s2] = L
                    nprev[s2] = 4
        cost = ncost
        back[k] = nback
        prev[k] = nprev
    s = int(np.argmin(cost))
    if cost[s] >= 0.0:
        return lev.reshape(h, w)                 # all-zero TU is cheaper
    k = 0
    while s != 4 and k < n:
        L = int(back[k][s])
        lev[scan[k]] = L if c[scan[k]] >= 0 else -L
        s = int(prev[k][s])
        k += 1
    return lev.reshape(h, w)


def dep_quant_greedy(coef, scan, *, w, h, qp, bit_depth=10):
    """Greedy state-following quantization in decoding order.

    Returns (h, w) int levels. Positions above the chosen last are zero;
    from the last downwards each coefficient takes the distortion-best
    level reachable in the current state's quantizer (ties go to the
    smaller level)."""
    c = np.asarray(coef).reshape(-1).astype(np.int64)
    q_shift, q_scale, _, _ = _params(w, h, qp, bit_depth)
    lev = np.zeros(w * h, np.int64)
    # real-valued target in qIdx units (2 qIdx steps per level)
    r_all = np.abs(c[scan]).astype(np.float64) * q_scale / (1 << q_shift)
    state = 0
    found_last = False
    # dead-zone rounding bias matching the scalar IRAP dead zone
    # (dz = 171/512, Quant.cpp): frac >= 2/3 rounds up
    dz = 171.0 / 512.0
    for k in range(len(scan) - 1, -1, -1):
        r = r_all[k]
        off = state >> 1
        L = max(0, int(np.floor((r + off) / 2.0 + dz)))
        if not found_last:
            if L == 0:
                continue                 # still above the last position
            found_last = True
        lev[scan[k]] = L if c[scan[k]] >= 0 else -L
        state = (STATE_TAB >> ((state << 2) + ((L & 1) << 1))) & 3
    return lev.reshape(h, w)
