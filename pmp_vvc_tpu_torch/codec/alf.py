"""ALF (adaptive loop filter) — decoder-exact classification + filtering.

Contracts (AdaptiveLoopFilter.cpp):
- block classification: deriveClassificationBlk (:860-1070) — 2x2-grid
  Laplacian gradients (V/H/D0/D1) summed over 8x8 windows per 4x4 block,
  activity -> 5 classes x 5 directionality, transpose index; virtual
  boundary (VB) row substitutions and the 96/64 activity scale.
- filtering: filterBlk (:1072-1310) — 7x7 (luma, 25 classes) / 5x5
  (chroma) diamond with per-tap nonlinear clipping, transpose coefficient
  permutations, VB row clamping, (shift+3) attenuation on VB-adjacent rows.
- fixed filter sets: m_fixedFilterSetCoeff / m_classToFilterMapping
  (:212-298, normative) loaded from codec/data/alf_fixed.npz.
- coefficient reconstruction: reconstructCoeff (:661-719); clipping values
  m_alfClippingValues (create(), :751-760): [1<<bd, 1<<(bd-3), 1<<(bd-5),
  1<<(bd-7)].

The whole-picture source for both classification and filtering is the
pre-ALF recon, border-replicated by 4 (m_tempBuf extendBorderPel).
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parent / "data"

NUM_CLASSES = 25
NUM_FIXED_SETS = 16
NUM_BITS = 8                      # m_NUM_BITS
VB_DIST_LUMA = 4                  # ALF_VB_POS_ABOVE_CTUROW_LUMA
VB_DIST_CHROMA = 2

# tap (dy+, dx+) offsets; the mirror is (-dy, -dx). Last tap = centre.
OFF7 = [(3, 0), (2, 1), (2, 0), (2, -1), (1, 2), (1, 1), (1, 0), (1, -1),
        (1, -2), (0, 3), (0, 2), (0, 1)]
OFF5 = [(2, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1)]

PERM7 = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
    [9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6, 12],
    [0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11, 12],
    [9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6, 12]], np.int32)
PERM5 = np.array([
    [0, 1, 2, 3, 4, 5, 6],
    [4, 1, 5, 3, 0, 2, 6],
    [0, 3, 2, 1, 4, 5, 6],
    [4, 3, 5, 1, 0, 2, 6]], np.int32)


@functools.cache
def fixed_tables():
    with np.load(_DATA / "alf_fixed.npz") as z:
        return z["coeff"].astype(np.int32), z["mapping"].astype(np.int32)


def clipping_values(bit_depth: int) -> np.ndarray:
    shift = bit_depth - 8
    return np.array([1 << bit_depth, 1 << (5 + shift), 1 << (3 + shift),
                     1 << (1 + shift)], np.int32)


def fixed_filter_set(set_idx: int, bit_depth: int):
    """(coeff, clip): (25, 13) decoded fixed set (create(), :783-796)."""
    coeff_tab, mapping = fixed_tables()
    coeff = np.zeros((NUM_CLASSES, 13), np.int32)
    coeff[:, :12] = coeff_tab[mapping[set_idx]]
    coeff[:, 12] = 1 << (NUM_BITS - 1)
    clip = np.full((NUM_CLASSES, 13), clipping_values(bit_depth)[0],
                   np.int32)
    return coeff, clip


def reconstruct_coeff(coeff_raw, clip_idx, bit_depth, num_filters,
                      delta_idx=None, nonlinear=False):
    """reconstructCoeff for an APS filter set -> per-class (25, 13) or
    per-alt (1, 7) decoded coeff + clip arrays (luma when delta_idx given).
    ``coeff_raw``: (num_filters, 12) luma or (7,) chroma-ish input."""
    cv = clipping_values(bit_depth)
    n = coeff_raw.shape[1]
    if delta_idx is not None:           # luma: expand classes
        coeff = np.zeros((NUM_CLASSES, n + 1), np.int32)
        clip = np.zeros((NUM_CLASSES, n + 1), np.int32)
        for cls in range(NUM_CLASSES):
            f = delta_idx[cls]
            coeff[cls, :n] = coeff_raw[f]
            coeff[cls, n] = 1 << (NUM_BITS - 1)
            ci = clip_idx[f] if nonlinear else np.zeros(n, np.int32)
            clip[cls, :n] = cv[ci]
            clip[cls, n] = cv[0]
        return coeff, clip
    coeff = np.zeros((coeff_raw.shape[0], n + 1), np.int32)
    clip = np.zeros((coeff_raw.shape[0], n + 1), np.int32)
    coeff[:, :n] = coeff_raw
    coeff[:, n] = 1 << (NUM_BITS - 1)
    for a in range(coeff_raw.shape[0]):
        ci = clip_idx[a] if nonlinear else np.zeros(n, np.int32)
        clip[a, :n] = cv[ci]
        clip[a, n] = cv[0]
    return coeff, clip


def pad4(plane):
    return np.pad(np.asarray(plane, np.int64), 4, mode="edge")


def classify(rec, bit_depth: int = 10, ctu_size: int = 128):
    """Whole-frame 4x4 classification -> (class_idx, transpose) arrays of
    shape (h//4, w//4). ``rec`` is the pre-ALF recon (unpadded)."""
    h, w = rec.shape
    P = pad4(rec)                     # origin offset 4
    vb_pos = ctu_size - VB_DIST_LUMA
    vb_mask = ctu_size - 1

    # gradient grid: cells at (i, j), i,j even in [0, h+4) x [0, w+4);
    # centre pixel (i-2, j-2)
    gh, gw = (h + 4) // 2, (w + 4) // 2
    ys = np.arange(gh) * 2 - 2        # centre pixel rows
    xs = np.arange(gw) * 2 - 2

    def p(dy_rows, dx):
        # P indexed at (centre + dy, centre + dx); dy_rows: (gh,) per-row
        return P[(ys + dy_rows)[:, None] + 4, (xs + dx)[None, :] + 4]

    r0 = np.full(gh, -1)              # src0 row offset
    r3 = np.full(gh, 2)               # src3 row offset
    sel3 = (ys > 0) & ((ys & vb_mask) == vb_pos - 2)
    sel0 = (ys > 0) & ((ys & vb_mask) == vb_pos)
    r3[sel3] = 1
    r0[sel0] = 0

    c00 = p(np.zeros(gh, int), 0)
    c01 = p(np.zeros(gh, int), 1)
    c0m = p(np.zeros(gh, int), -1)
    c02 = p(np.zeros(gh, int), 2)
    u10 = p(np.ones(gh, int), 0)
    u11 = p(np.ones(gh, int), 1)
    u1m = p(np.ones(gh, int), -1)
    u12 = p(np.ones(gh, int), 2)
    d0 = p(r0, 0)
    d0m = p(r0, -1)
    d01 = p(r0, 1)
    s30 = p(r3, 0)
    s31 = p(r3, 1)
    s32 = p(r3, 2)

    y0 = c00 * 2
    yup1 = u11 * 2
    gv = np.abs(y0 - d0 - u10) + np.abs(yup1 - c01 - s31)
    gh_ = np.abs(y0 - c01 - c0m) + np.abs(yup1 - u12 - u10)
    gd0 = np.abs(y0 - d0m - u11) + np.abs(yup1 - c00 - s32)
    gd1 = np.abs(y0 - u1m - d01) + np.abs(yup1 - s30 - c02)

    bh, bw = h // 4, w // 4
    cls = np.zeros((bh, bw), np.int32)
    trs = np.zeros((bh, bw), np.int32)
    th_tab = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4])
    shift = bit_depth + 4

    # block (bi, bj): laplacian rows {i, i+2, i+4, i+6} where lap row
    # index r maps to ys = 2r - 2 => rows r = bi*2 .. bi*2+3, cols same
    def win(g, rows):
        # sum over given lap-row offsets and 4 lap-cols per block
        s = np.zeros((bh, bw), np.int64)
        for r in rows:
            gr = g[r + np.arange(bh) * 2, :]          # (bh, gw)
            for c in range(4):
                s += gr[:, c + np.arange(bw) * 2]
        return s

    by = np.arange(bh) * 4
    at_vbm4 = (by % ctu_size) == vb_pos - 4
    at_vb = (by % ctu_size) == vb_pos
    full = ~(at_vbm4 | at_vb)

    sums = {}
    for name, g in (("v", gv), ("h", gh_), ("d0", gd0), ("d1", gd1)):
        s_full = win(g, (0, 1, 2, 3))
        s_a = win(g, (0, 1, 2))
        s_b = win(g, (1, 2, 3))
        s = np.where(full[:, None], s_full,
                     np.where(at_vbm4[:, None], s_a, s_b))
        sums[name] = s
    sum_v, sum_h = sums["v"], sums["h"]
    sum_d0, sum_d1 = sums["d0"], sums["d1"]

    temp_act = sum_v + sum_h
    scale = np.where((at_vbm4 | at_vb)[:, None], 96, 64)
    activity = np.clip((temp_act * scale) >> shift, 0, 15)
    cls = th_tab[activity]

    hv1 = np.maximum(sum_v, sum_h)
    hv0 = np.minimum(sum_v, sum_h)
    dir_hv = np.where(sum_v > sum_h, 1, 3)
    d1v = np.maximum(sum_d0, sum_d1)
    d0v = np.minimum(sum_d0, sum_d1)
    dir_d = np.where(sum_d0 > sum_d1, 0, 2)
    d_wins = d1v * hv0 > hv1 * d0v
    hvd1 = np.where(d_wins, d1v, hv1)
    hvd0 = np.where(d_wins, d0v, hv0)
    main_dir = np.where(d_wins, dir_d, dir_hv)
    sec_dir = np.where(d_wins, dir_hv, dir_d)
    strength = np.where(hvd1 * 2 > 9 * hvd0, 2,
                        np.where(hvd1 > 2 * hvd0, 1, 0))
    cls = cls + np.where(strength > 0,
                         (((main_dir & 1) << 1) + strength) * 5, 0)
    transpose_tab = np.array([0, 1, 0, 2, 2, 3, 1, 3])
    trs = transpose_tab[main_dir * 2 + (sec_dir >> 1)]
    return cls.astype(np.int32), trs.astype(np.int32)


def _vb_row_offsets(y_abs, vb_pos, vb_mask, dist):
    """Effective (below e1..e3, above m1..m3) row offsets + near-VB flag
    for output row ``y_abs`` (filterBlk VB pointer clamping)."""
    yvb = y_abs & vb_mask
    e = [1, 2, 3]
    m = [-1, -2, -3]
    if vb_pos - dist <= yvb < vb_pos:
        e[0] = 0 if yvb == vb_pos - 1 else 1
        e[1] = e[0] if yvb >= vb_pos - 2 else 2
        e[2] = e[1] if yvb >= vb_pos - 3 else 3
        m[0] = 0 if yvb == vb_pos - 1 else -1
        m[1] = m[0] if yvb >= vb_pos - 2 else -2
        m[2] = m[1] if yvb >= vb_pos - 3 else -3
    elif vb_pos <= yvb <= vb_pos + dist - 1:
        m[0] = 0 if yvb == vb_pos else -1
        m[1] = m[0] if yvb <= vb_pos + 1 else -2
        m[2] = m[1] if yvb <= vb_pos + 2 else -3
        e[0] = 0 if yvb == vb_pos else 1
        e[1] = e[0] if yvb <= vb_pos + 1 else 2
        e[2] = e[1] if yvb <= vb_pos + 2 else 3
    near = yvb == vb_pos - 1 or yvb == vb_pos
    return e, m, near


def filter_ctu(P, x0, y0, w, h, coeff_px, clip_px, offs, vb_pos, vb_mask,
               vb_dist, bit_depth):
    """Filter one CTU window. ``P``: whole-plane pad4 source; coeff_px /
    clip_px: per-pixel (h, w, ntap) int arrays (transpose-permuted);
    ``offs``: OFF7 or OFF5. Returns the (h, w) filtered block."""
    shift = NUM_BITS - 1
    pel_max = (1 << bit_depth) - 1
    xs = np.arange(w) + x0 + 4
    rows = y0 + np.arange(h) + 4
    # per-row VB pointer clamps (few distinct patterns; the tap loop
    # below is fully vectorised over the block)
    e_all = np.empty((h, 3), np.int64)
    m_all = np.empty((h, 3), np.int64)
    near = np.zeros(h, bool)
    for yy in range(h):
        e, m, nr = _vb_row_offsets(y0 + yy, vb_pos, vb_mask, vb_dist)
        e_all[yy], m_all[yy], near[yy] = e, m, nr
    zero = np.zeros(h, np.int64)
    curr = P[rows[:, None], xs[None, :]].astype(np.int64)
    acc = np.zeros((h, w), np.int64)
    for k, (dy, dx) in enumerate(offs):
        ey = e_all[:, dy - 1] if dy > 0 else zero
        my = m_all[:, dy - 1] if dy > 0 else zero
        a = P[(rows + ey)[:, None], (xs + dx)[None, :]]
        b = P[(rows + my)[:, None], (xs - dx)[None, :]]
        c = clip_px[:, :, k]
        v = np.clip(a - curr, -c, c) + np.clip(b - curr, -c, c)
        acc += coeff_px[:, :, k] * v
    sh = np.where(near, shift + 3, shift)[:, None]
    acc = (acc + (np.int64(1) << (sh - 1))) >> sh
    return np.clip(acc + curr, 0, pel_max)


def apply_luma_ctu(rec_pad, x0, y0, w, h, cls, trs, coeff, clip,
                   bit_depth=10, ctu_size=128):
    """Apply a (25, 13) luma filter set to the CTU at (x0, y0)."""
    # per-pixel coeff/clip maps from the 4x4 classification
    cls_px = np.repeat(np.repeat(cls[y0 // 4:(y0 + h) // 4,
                                     x0 // 4:(x0 + w) // 4], 4, 0), 4, 1)
    trs_px = np.repeat(np.repeat(trs[y0 // 4:(y0 + h) // 4,
                                     x0 // 4:(x0 + w) // 4], 4, 0), 4, 1)
    perm = PERM7[trs_px]                       # (h, w, 13)
    coeff_px = coeff[cls_px[..., None], perm]
    clip_px = clip[cls_px[..., None], perm]
    return filter_ctu(rec_pad, x0, y0, w, h, coeff_px, clip_px, OFF7,
                      ctu_size - VB_DIST_LUMA, ctu_size - 1, VB_DIST_LUMA,
                      bit_depth)


def apply_chroma_ctu(rec_pad, x0, y0, w, h, coeff, clip, bit_depth=10,
                     ctu_size=128):
    """Apply a (7,) chroma filter (single alt) to the chroma CTU window."""
    ctu_c = ctu_size // 2
    coeff_px = np.broadcast_to(coeff[None, None, :], (h, w, 7))
    clip_px = np.broadcast_to(clip[None, None, :], (h, w, 7))
    return filter_ctu(rec_pad, x0, y0, w, h, coeff_px, clip_px, OFF5,
                      ctu_c - VB_DIST_CHROMA, ctu_c - 1, VB_DIST_CHROMA,
                      bit_depth)


# ---------------------------------------------------------------------------
# Encoder-side decision + CTU syntax
# ---------------------------------------------------------------------------

def decide_alf_luma(org_y, rec_y, bit_depth=10, ctu_size=128, lam=0.0,
                    extra_sets=None):
    """Per-CTU luma filter choice over the 16 fixed sets (+ optional APS
    sets) vs off, by SSD + a small signalling cost.

    ``extra_sets``: list of (coeff(25,13), clip(25,13)) APS-decoded sets
    appended after the fixed ones (CTU index NUM_FIXED_SETS + i).
    Returns (flags (cy,cx) bool, set_idx (cy,cx) int, filtered_rec).
    """
    org_y = np.asarray(org_y, np.int64)
    rec_y = np.asarray(rec_y, np.int64)
    h, w = rec_y.shape
    cls, trs = classify(rec_y, bit_depth, ctu_size)
    P = pad4(rec_y)
    n_cx = (w + ctu_size - 1) // ctu_size
    n_cy = (h + ctu_size - 1) // ctu_size
    flags = np.zeros((n_cy, n_cx), bool)
    sets = np.zeros((n_cy, n_cx), np.int32)
    out = rec_y.copy()
    cand = [fixed_filter_set(s, bit_depth) for s in range(NUM_FIXED_SETS)]
    if extra_sets:
        cand += list(extra_sets)
    for cy in range(n_cy):
        for cx in range(n_cx):
            x0, y0 = cx * ctu_size, cy * ctu_size
            cw = min(ctu_size, w - x0)
            ch = min(ctu_size, h - y0)
            o = org_y[y0:y0 + ch, x0:x0 + cw]
            r = rec_y[y0:y0 + ch, x0:x0 + cw]
            best_cost = float(((r - o) ** 2).sum()) + lam * 1.0
            best = (None, None)
            for s, (coeff, clip) in enumerate(cand):
                f = apply_luma_ctu(P, x0, y0, cw, ch, cls, trs, coeff,
                                   clip, bit_depth, ctu_size)
                cost = float(((f - o) ** 2).sum()) + lam * 6.0
                if cost < best_cost:
                    best_cost = cost
                    best = (s, f)
            if best[0] is not None:
                flags[cy, cx] = True
                sets[cy, cx] = best[0]
                out[y0:y0 + ch, x0:x0 + cw] = best[1]
    return flags, sets, out


def decide_alf_chroma(org_c, rec_c, coeff, clip, bit_depth=10,
                      ctu_size=128, lam=0.0):
    """Per-CTU on/off for one chroma plane with a single (7,) filter."""
    org_c = np.asarray(org_c, np.int64)
    rec_c = np.asarray(rec_c, np.int64)
    h, w = rec_c.shape
    csz = ctu_size // 2
    P = pad4(rec_c)
    n_cx = (w + csz - 1) // csz
    n_cy = (h + csz - 1) // csz
    flags = np.zeros((n_cy, n_cx), bool)
    out = rec_c.copy()
    for cy in range(n_cy):
        for cx in range(n_cx):
            x0, y0 = cx * csz, cy * csz
            cw = min(csz, w - x0)
            ch = min(csz, h - y0)
            o = org_c[y0:y0 + ch, x0:x0 + cw]
            r = rec_c[y0:y0 + ch, x0:x0 + cw]
            f = apply_chroma_ctu(P, x0, y0, cw, ch, coeff, clip,
                                 bit_depth, ctu_size)
            if float(((f - o) ** 2).sum()) + lam * 2.0 \
                    < float(((r - o) ** 2).sum()) + lam * 1.0:
                flags[cy, cx] = True
                out[y0:y0 + ch, x0:x0 + cw] = f
    return flags, out


def write_alf_ctu(enc, ctx, cy, cx, flags_y, sets, num_aps=0,
                  flags_cb=None, flags_cr=None):
    """CTU ALF syntax (coding_tree_unit, CABACWriter.cpp:158-189 +
    codeAlfCtuEnableFlag/codeAlfCtuFilterIndex/codeAlfCtuAlternative).

    ``flags_y``/``sets``: (n_cy, n_cx) decision arrays. Chroma flags
    given only when the slice chroma ALF is enabled (1 alternative)."""
    fl = bool(flags_y[cy, cx])
    c = (1 if cx > 0 and flags_y[cy, cx - 1] else 0) \
        + (1 if cy > 0 and flags_y[cy - 1, cx] else 0)
    enc.encode_bin(1 if fl else 0, ctx("ctbAlfFlag", 0 * 3 + c))
    if fl:
        idx = int(sets[cy, cx])
        if num_aps > 0:
            temporal = idx >= NUM_FIXED_SETS
            enc.encode_bin(1 if temporal else 0,
                           ctx("AlfUseTemporalFilt"))
            if temporal:
                assert num_aps == 1   # truncbin absent for a single APS
            else:
                enc.encode_bins_ep(idx, 4)
        else:
            enc.encode_bins_ep(idx, 4)     # xWriteTruncBinCode(idx, 16)
    for comp, fc in ((1, flags_cb), (2, flags_cr)):
        if fc is None:
            continue
        f = bool(fc[cy, cx])
        c = (1 if cx > 0 and fc[cy, cx - 1] else 0) \
            + (1 if cy > 0 and fc[cy - 1, cx] else 0)
        enc.encode_bin(1 if f else 0, ctx("ctbAlfFlag", comp * 3 + c))
        # codeAlfCtuAlternative: truncated unary over numAlts-1 = 0 bins
        # for a single alternative


# ---------------------------------------------------------------------------
# APS filter derivation (encoder) + APS syntax
# ---------------------------------------------------------------------------

def derive_luma_filters(org, rec, bit_depth=10, ctu_size=128):
    """Per-class Wiener filters (25, 12) int, clip idx 0 (linear).

    Least squares on the decoder's exact feature domain: geometric tap
    differences with VB row clamping, scattered to canonical coefficient
    indices via the per-pixel transpose (filterBlk permutations)."""
    org = np.asarray(org, np.int64)
    rec = np.asarray(rec, np.int64)
    h, w = rec.shape
    cls, trs = classify(rec, bit_depth, ctu_size)
    P = pad4(rec)
    vb_pos = ctu_size - VB_DIST_LUMA
    vb_mask = ctu_size - 1
    A = np.zeros((NUM_CLASSES, 12, 12))
    bd = np.zeros((NUM_CLASSES, 12))
    xs = np.arange(w) + 4
    for y in range(h):
        e, m, _ = _vb_row_offsets(y, vb_pos, vb_mask, VB_DIST_LUMA)
        row = y + 4
        curr = P[row, xs]
        feats = []
        for (dy, dx) in OFF7:
            ey = e[dy - 1] if dy > 0 else 0
            my = m[dy - 1] if dy > 0 else 0
            feats.append((P[row + ey, xs + dx] - curr)
                         + (P[row + my, xs - dx] - curr))
        F = np.stack(feats, -1).astype(np.float64)          # (w, 12) geo
        t_row = trs[y // 4].repeat(4)[:w]
        idx = PERM7[t_row][:, :12]                          # canon index
        Fc = np.zeros_like(F)
        np.put_along_axis(Fc, idx, F, axis=1)
        d = (org[y] - curr).astype(np.float64)
        c_row = cls[y // 4].repeat(4)[:w]
        for c in np.unique(c_row):
            sel = c_row == c
            Fs = Fc[sel]
            A[c] += Fs.T @ Fs
            bd[c] += Fs.T @ d[sel]
    out = np.zeros((NUM_CLASSES, 12), np.int32)
    for c in range(NUM_CLASSES):
        try:
            sol = 128.0 * np.linalg.solve(
                A[c] + np.eye(12) * 1e-3, bd[c])
        except np.linalg.LinAlgError:
            continue
        out[c] = np.clip(np.round(sol), -127, 127).astype(np.int32)
    return out


def derive_chroma_filter(org_u, org_v, rec_u, rec_v, bit_depth=10,
                         ctu_size=128):
    """Single (6,) chroma Wiener filter over both planes (alt 0)."""
    csz = ctu_size // 2
    vb_pos = csz - VB_DIST_CHROMA
    vb_mask = csz - 1
    A = np.zeros((6, 6))
    bd = np.zeros(6)
    for org, rec in ((org_u, rec_u), (org_v, rec_v)):
        org = np.asarray(org, np.int64)
        rec = np.asarray(rec, np.int64)
        h, w = rec.shape
        P = pad4(rec)
        xs = np.arange(w) + 4
        for y in range(h):
            e, m, _ = _vb_row_offsets(y, vb_pos, vb_mask, VB_DIST_CHROMA)
            row = y + 4
            curr = P[row, xs]
            feats = []
            for (dy, dx) in OFF5:
                ey = e[dy - 1] if dy > 0 else 0
                my = m[dy - 1] if dy > 0 else 0
                feats.append((P[row + ey, xs + dx] - curr)
                             + (P[row + my, xs - dx] - curr))
            F = np.stack(feats, -1).astype(np.float64)
            d = (org[y] - curr).astype(np.float64)
            A += F.T @ F
            bd += F.T @ d
    try:
        sol = 128.0 * np.linalg.solve(A + np.eye(6) * 1e-3, bd)
    except np.linalg.LinAlgError:
        return np.zeros(6, np.int32)
    return np.clip(np.round(sol), -127, 127).astype(np.int32)


def alf_aps_nal(luma_coeff=None, chroma_coeff=None, aps_id=0,
                ccalf_cb=None, ccalf_cr=None):
    """Prefix-APS NAL, ALF payload (codeAlfAps / alfFilter), linear
    filters (clip flag 0). ``luma_coeff``: (25, 12) per-class (identity
    filterCoeffDeltaIdx); ``chroma_coeff``: (6,) single alternative."""
    from .bitstream import BitWriter, nal_unit
    bw = BitWriter()
    bw.write(0, 3)                      # aps_params_type = ALF_APS
    bw.write(aps_id, 5)
    bw.write_flag(1)                    # aps_chroma_present_flag
    bw.write_flag(1 if luma_coeff is not None else 0)
    bw.write_flag(1 if chroma_coeff is not None else 0)
    bw.write_flag(1 if ccalf_cb is not None else 0)   # alf_cc_cb_signal
    bw.write_flag(1 if ccalf_cr is not None else 0)   # alf_cc_cr_signal
    if luma_coeff is not None:
        bw.write_flag(0)                # alf_luma_clip
        bw.write_uvlc(NUM_CLASSES - 1)  # 25 filters signalled
        for i in range(NUM_CLASSES):
            bw.write(i, 5)              # identity coeff_delta_idx
        for f in range(NUM_CLASSES):
            for i in range(12):
                c = int(luma_coeff[f, i])
                bw.write_uvlc(abs(c))
                if c:
                    bw.write_flag(1 if c < 0 else 0)
    if chroma_coeff is not None:
        bw.write_flag(0)                # alf_nonlinear_enable_flag_chroma
        bw.write_uvlc(0)                # one alternative
        for i in range(6):
            c = int(chroma_coeff[i])
            bw.write_uvlc(abs(c))
            if c:
                bw.write_flag(1 if c < 0 else 0)
    ccalf_aps_payload(bw, ccalf_cb, ccalf_cr)
    bw.write_flag(0)                    # aps_extension_flag
    bw.write(1, 1)
    bw.byte_align_zero()
    return nal_unit(17, bw.bytes())     # NAL_UNIT_PREFIX_APS


# ---------------------------------------------------------------------------
# CC-ALF (cross-component ALF)
# ---------------------------------------------------------------------------

# 3x4 cross taps on the co-located luma, (dy, dx) in luma samples
# (filterBlkCcAlf tap order, AdaptiveLoopFilter.cpp:1380-1390)
CCALF_OFF = [(-1, 0), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1), (2, 0)]
CCALF_SCALE_BITS = 7


def _ccalf_row_offsets(pos, vb_pos):
    """Luma row-offset substitutions per chroma row (420)."""
    o1, o2, o3 = 1, -1, 2
    if pos == vb_pos - 2 or pos == vb_pos + 1:
        o3 = o1
    elif pos == vb_pos - 1 or pos == vb_pos:
        o1 = o2 = o3 = 0
    return o1, o2, o3


def apply_ccalf_ctu(luma_pad, chroma, x0, y0, w, h, coeff, bit_depth=10,
                    ctu_size=128):
    """CC-ALF for one chroma CTU window (420). ``luma_pad``: pad4 of the
    PRE-ALF luma; ``chroma``: post-chroma-ALF plane values for the window
    (h, w). Returns the filtered window."""
    vb_pos = ctu_size - VB_DIST_LUMA
    vb_mask = ctu_size - 1
    pel_max = (1 << bit_depth) - 1
    half = 1 << bit_depth >> 1
    out = np.asarray(chroma, np.int64).copy()
    xs_l = (np.arange(w) + x0) * 2 + 4
    for yy in range(h):
        ly = (y0 + yy) * 2 + 4
        pos = ((y0 + yy) << 1) & vb_mask
        o1, o2, o3 = _ccalf_row_offsets(pos, vb_pos)
        l0 = luma_pad[ly, xs_l]
        acc = np.zeros(w, np.int64)
        for c, (dy, dx) in zip(coeff, CCALF_OFF):
            eff = {-1: o2, 0: 0, 1: o1, 2: o3}[dy]
            acc += int(c) * (luma_pad[ly + eff, xs_l + dx] - l0)
        acc = (acc + ((1 << CCALF_SCALE_BITS) >> 1)) >> CCALF_SCALE_BITS
        acc = np.clip(acc + half, 0, pel_max) - half
        out[yy] = np.clip(out[yy] + acc, 0, pel_max)
    return out


def derive_ccalf_filter(org_c, rec_c, luma_pad, bit_depth=10,
                        ctu_size=128):
    """One power-of-two-constrained CC-ALF filter (7,) for a component."""
    org_c = np.asarray(org_c, np.int64)
    rec_c = np.asarray(rec_c, np.int64)
    h, w = rec_c.shape
    vb_pos = ctu_size - VB_DIST_LUMA
    vb_mask = ctu_size - 1
    A = np.zeros((7, 7))
    bd = np.zeros(7)
    xs_l = np.arange(w) * 2 + 4
    for yy in range(h):
        ly = yy * 2 + 4
        pos = (yy << 1) & vb_mask
        o1, o2, o3 = _ccalf_row_offsets(pos, vb_pos)
        l0 = luma_pad[ly, xs_l]
        feats = []
        for (dy, dx) in CCALF_OFF:
            eff = {-1: o2, 0: 0, 1: o1, 2: o3}[dy]
            feats.append(luma_pad[ly + eff, xs_l + dx] - l0)
        F = np.stack(feats, -1).astype(np.float64)
        d = (org_c[yy] - rec_c[yy]).astype(np.float64)
        A += F.T @ F
        bd += F.T @ d
    try:
        sol = (1 << CCALF_SCALE_BITS) * np.linalg.solve(
            A + np.eye(7) * 1e-3, bd)
    except np.linalg.LinAlgError:
        return np.zeros(7, np.int32)
    out = np.zeros(7, np.int32)
    for i, v in enumerate(sol):
        a = abs(v)
        if a < 0.75:
            continue
        p = int(np.clip(np.round(np.log2(a)), 0, 6))
        out[i] = int(np.sign(v)) * (1 << p)
    return out


def decide_ccalf(org_c, rec_c, luma_pad, coeff, bit_depth=10,
                 ctu_size=128, lam=0.0):
    """Per-CTU CC-ALF on/off for one component; returns (idc, plane)."""
    if not coeff.any():
        h, w = np.asarray(rec_c).shape
        csz = ctu_size // 2
        shape = ((h + csz - 1) // csz, (w + csz - 1) // csz)
        return np.zeros(shape, np.int32), np.asarray(rec_c).copy()
    org_c = np.asarray(org_c, np.int64)
    rec_c = np.asarray(rec_c, np.int64)
    h, w = rec_c.shape
    csz = ctu_size // 2
    n_cx = (w + csz - 1) // csz
    n_cy = (h + csz - 1) // csz
    idc = np.zeros((n_cy, n_cx), np.int32)
    out = rec_c.copy()
    for cy in range(n_cy):
        for cx in range(n_cx):
            x0, y0 = cx * csz, cy * csz
            cw = min(csz, w - x0)
            ch = min(csz, h - y0)
            o = org_c[y0:y0 + ch, x0:x0 + cw]
            r = rec_c[y0:y0 + ch, x0:x0 + cw]
            f = apply_ccalf_ctu(luma_pad, r, x0, y0, cw, ch, coeff,
                                bit_depth, ctu_size)
            if float(((f - o) ** 2).sum()) + lam * 2.0 \
                    < float(((r - o) ** 2).sum()) + lam * 1.0:
                idc[cy, cx] = 1
                out[y0:y0 + ch, x0:x0 + cw] = f
    return idc, out


def write_ccalf_ctu(enc, ctx, cy, cx, idc_cb, idc_cr, filter_count=1):
    """codeCcAlfFilterControlIdc for both components (single filter)."""
    for comp, idc in ((1, idc_cb), (2, idc_cr)):
        if idc is None:
            continue
        v = int(idc[cy, cx])
        c = (1 if cx > 0 and idc[cy, cx - 1] else 0) \
            + (1 if cy > 0 and idc[cy - 1, cx] else 0) \
            + (3 if comp == 2 else 0)
        enc.encode_bin(1 if v else 0, ctx("CcAlfFilterControlFlag", c))
        if v > 0:
            for _ in range(v - 1):
                enc.encode_bin_ep(1)
            if v < filter_count:
                enc.encode_bin_ep(0)


def ccalf_aps_payload(bw, coeff_cb, coeff_cr):
    """CC-ALF filter coefficients inside codeAlfAps (one filter each)."""
    for coeff in (coeff_cb, coeff_cr):
        if coeff is None:
            continue
        # MAX_NUM_CC_ALF_FILTERS=4 > 1 -> filters_signalled_minus1
        bw.write_uvlc(0)
        for i in range(7):
            c = int(coeff[i])
            if c == 0:
                bw.write(0, 3)
            else:
                bw.write(1 + int(abs(c)).bit_length() - 1, 3)
                bw.write_flag(1 if c < 0 else 0)


# ---------------------------------------------------------------------------
# Decoder side: APS/CTU parsing + frame application (ALFProcess mirror)
# ---------------------------------------------------------------------------

def parse_alf_aps(rbsp: bytes):
    """Full alf_data parse (VLCReader.cpp parseAlfAps/alfFilter):
    nonlinear clipping indices, multiple luma filters, multiple chroma
    alternatives, multiple CC-ALF filters per component.

    Returns dict(luma (nf,12)|None, luma_clip (nf,12), luma_nonlinear,
    luma_delta_idx (25,), chroma (nalts,6)|None, chroma_clip (nalts,6),
    chroma_nonlinear, cc_cb (ncb,7)|None, cc_cr (ncr,7)|None)."""
    from .bitstream import BitReader
    br = BitReader(rbsp)
    assert br.read(3) == 0, "not an ALF APS"
    br.read(5)                          # aps id
    chroma_present = br.read_flag()
    has_luma = br.read_flag()
    has_chroma = br.read_flag() if chroma_present else False
    has_cc_cb = br.read_flag() if chroma_present else False
    has_cc_cr = br.read_flag() if chroma_present else False
    out = {"luma": None, "luma_clip": None, "luma_nonlinear": False,
           "luma_delta_idx": None, "chroma": None, "chroma_clip": None,
           "chroma_nonlinear": False, "cc_cb": None, "cc_cr": None}
    if has_luma:
        out["luma_nonlinear"] = bool(br.read_flag())
        nf = br.read_uvlc() + 1
        if nf > 1:
            length = max((nf - 1).bit_length(), 1)
            out["luma_delta_idx"] = np.array(
                [br.read(length) for _ in range(NUM_CLASSES)], np.int32)
        else:
            out["luma_delta_idx"] = np.zeros(NUM_CLASSES, np.int32)
        coeff = np.zeros((nf, 12), np.int32)
        for f in range(nf):
            for i in range(12):
                coeff[f, i] = _read_svlc_coeff(br)
        clip = np.zeros((nf, 12), np.int32)
        if out["luma_nonlinear"]:
            for f in range(nf):
                for i in range(12):
                    clip[f, i] = br.read(2)
        out["luma"], out["luma_clip"] = coeff, clip
    if has_chroma:
        out["chroma_nonlinear"] = bool(br.read_flag())
        nalts = br.read_uvlc() + 1
        coeff = np.zeros((nalts, 6), np.int32)
        clip = np.zeros((nalts, 6), np.int32)
        for a in range(nalts):
            for i in range(6):
                coeff[a, i] = _read_svlc_coeff(br)
            if out["chroma_nonlinear"]:
                for i in range(6):
                    clip[a, i] = br.read(2)
        out["chroma"], out["chroma_clip"] = coeff, clip
    for key, has in (("cc_cb", has_cc_cb), ("cc_cr", has_cc_cr)):
        if not has:
            continue
        nfilt = br.read_uvlc() + 1
        coeff = np.zeros((nfilt, 7), np.int32)
        for f in range(nfilt):
            for i in range(7):
                k = br.read(3)
                if k:
                    sign = br.read_flag()
                    coeff[f, i] = (-1 if sign else 1) * (1 << (k - 1))
        out[key] = coeff
    return out


def _read_svlc_coeff(br):
    c = br.read_uvlc()
    if c and br.read_flag():
        c = -c
    return c


def _trunc_bin_dec(dec, max_symbol):
    """xReadTruncBinCode (CABACReader.cpp readAlfCtuFilterIndex)."""
    thresh = 0
    while (1 << (thresh + 1)) <= max_symbol:
        thresh += 1
    val = 1 << thresh
    b = max_symbol - val
    sym = dec.decode_bins_ep(thresh) if thresh else 0
    if sym >= val - b:
        sym = (sym << 1) | dec.decode_bin_ep()
        sym -= val - b
    return sym


def parse_alf_ctu(dec, ctx, cy, cx, flags_y, sets, num_aps=0,
                  flags_cb=None, flags_cr=None, alt_cb=None, alt_cr=None,
                  num_alts=1):
    """Parse mirror of ``write_alf_ctu`` + CABACReader
    readAlfCtuFilterIndex / ctbAlfAlternative (fills decision arrays).
    ``sets``: fixed-set index 0..15, or NUM_FIXED_SETS + k for the
    k-th slice luma APS; ``alt_cb``/``alt_cr``: per-CTU chroma filter
    alternative when the chroma APS signals several."""
    c = (1 if cx > 0 and flags_y[cy, cx - 1] else 0) \
        + (1 if cy > 0 and flags_y[cy - 1, cx] else 0)
    fl = bool(dec.decode_bin(ctx("ctbAlfFlag", 0 * 3 + c)))
    flags_y[cy, cx] = fl
    if fl:
        if num_aps > 0 and dec.decode_bin(ctx("AlfUseTemporalFilt")):
            idx = _trunc_bin_dec(dec, num_aps) if num_aps > 1 else 0
            sets[cy, cx] = NUM_FIXED_SETS + idx
        else:
            sets[cy, cx] = _trunc_bin_dec(dec, NUM_FIXED_SETS)
    for comp, fc, alt in ((1, flags_cb, alt_cb), (2, flags_cr, alt_cr)):
        if fc is None:
            continue
        c = (1 if cx > 0 and fc[cy, cx - 1] else 0) \
            + (1 if cy > 0 and fc[cy - 1, cx] else 0)
        on = bool(dec.decode_bin(ctx("ctbAlfFlag", comp * 3 + c)))
        fc[cy, cx] = on
        if on and alt is not None and num_alts > 1:
            v = 0
            while v < num_alts - 1 and dec.decode_bin(
                    ctx("ctbAlfAlternative", comp - 1)):
                v += 1
            alt[cy, cx] = v


def parse_ccalf_ctu(dec, ctx, cy, cx, idc_cb, idc_cr,
                    filter_counts=(1, 1)):
    """Parse mirror of ``write_ccalf_ctu`` (per-component filter
    counts; the idc beyond 1 is truncated-unary EP-coded)."""
    for comp, idc, n in ((1, idc_cb, filter_counts[0]),
                         (2, idc_cr, filter_counts[1])):
        if idc is None:
            continue
        c = (1 if cx > 0 and idc[cy, cx - 1] else 0) \
            + (1 if cy > 0 and idc[cy - 1, cx] else 0) \
            + (3 if comp == 2 else 0)
        v = dec.decode_bin(ctx("CcAlfFilterControlFlag", c))
        if v:
            while v < n and dec.decode_bin_ep():
                v += 1
        idc[cy, cx] = v


def apply_alf_frame(recon_y, recon_u, recon_v, flags_y, sets, luma_apss,
                    chroma_aps, flags_cb, flags_cr, idc_cb, idc_cr,
                    alt_cb=None, alt_cr=None, cc_cb_aps=None,
                    cc_cr_aps=None, bit_depth=10, ctu_size=128):
    """Decoder-side ALF + CC-ALF application over post-SAO planes.

    Mirrors AdaptiveLoopFilter::ALFProcess: luma ALF (16 fixed sets +
    one candidate per slice luma APS, selected per CTU by ``sets``) on
    the pre-ALF luma; chroma ALF with the per-CTU alternative
    (``alt_cb``/``alt_cr``) from the slice chroma APS; CC-ALF on the
    post-ALF chroma using the PRE-ALF padded luma, filter ``idc - 1``
    of the per-component CC APS. Returns (y, u, v).
    """
    y = np.asarray(recon_y, np.int64)
    h, w = y.shape
    cls, trs = classify(y, bit_depth, ctu_size)
    P = pad4(y)                          # pre-ALF luma (CC-ALF input too)
    out_y = y.copy()
    cand = [fixed_filter_set(s, bit_depth) for s in range(NUM_FIXED_SETS)]
    for aps in (luma_apss or []):
        cand.append(reconstruct_coeff(
            aps["luma"], aps["luma_clip"], bit_depth, NUM_CLASSES,
            delta_idx=aps["luma_delta_idx"],
            nonlinear=aps["luma_nonlinear"]))
    n_cx = (w + ctu_size - 1) // ctu_size
    n_cy = (h + ctu_size - 1) // ctu_size
    for cy in range(n_cy):
        for cx in range(n_cx):
            if not flags_y[cy, cx]:
                continue
            x0, y0 = cx * ctu_size, cy * ctu_size
            cw = min(ctu_size, w - x0)
            ch = min(ctu_size, h - y0)
            coeff, clip = cand[int(sets[cy, cx])]
            out_y[y0:y0 + ch, x0:x0 + cw] = apply_luma_ctu(
                P, x0, y0, cw, ch, cls, trs, coeff, clip, bit_depth,
                ctu_size)

    outs_c = []
    for plane, fc, alt in ((recon_u, flags_cb, alt_cb),
                           (recon_v, flags_cr, alt_cr)):
        pc = np.asarray(plane, np.int64)
        out_c = pc.copy()
        if fc is not None and chroma_aps is not None and \
                chroma_aps["chroma"] is not None and fc.any():
            ccoeff, cclip = reconstruct_coeff(
                chroma_aps["chroma"], chroma_aps["chroma_clip"],
                bit_depth, chroma_aps["chroma"].shape[0],
                nonlinear=chroma_aps["chroma_nonlinear"])
            Pc = pad4(pc)
            csz = ctu_size // 2
            hc, wc = pc.shape
            for cy in range((hc + csz - 1) // csz):
                for cx in range((wc + csz - 1) // csz):
                    if not fc[cy, cx]:
                        continue
                    a = int(alt[cy, cx]) if alt is not None else 0
                    x0, y0 = cx * csz, cy * csz
                    cw = min(csz, wc - x0)
                    ch = min(csz, hc - y0)
                    out_c[y0:y0 + ch, x0:x0 + cw] = apply_chroma_ctu(
                        Pc, x0, y0, cw, ch, ccoeff[a], cclip[a],
                        bit_depth, ctu_size)
        outs_c.append(out_c)

    for ci, (idc, cc_aps) in enumerate(((idc_cb, cc_cb_aps),
                                        (idc_cr, cc_cr_aps))):
        key = "cc_cb" if ci == 0 else "cc_cr"
        if idc is None or cc_aps is None or cc_aps[key] is None \
                or not idc.any():
            continue
        filt = cc_aps[key]               # (nfilt, 7)
        out_c = outs_c[ci]
        hc, wc = out_c.shape
        csz = ctu_size // 2
        for cy in range((hc + csz - 1) // csz):
            for cx in range((wc + csz - 1) // csz):
                v = int(idc[cy, cx])
                if not v:
                    continue
                x0, y0 = cx * csz, cy * csz
                cw = min(csz, wc - x0)
                ch = min(csz, hc - y0)
                out_c[y0:y0 + ch, x0:x0 + cw] = apply_ccalf_ctu(
                    P, out_c[y0:y0 + ch, x0:x0 + cw], x0, y0, cw, ch,
                    filt[v - 1], bit_depth, ctu_size)
    return (out_y.astype(np.int32), outs_c[0].astype(np.int32),
            outs_c[1].astype(np.int32))
