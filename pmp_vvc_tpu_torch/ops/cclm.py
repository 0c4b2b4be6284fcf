"""CCLM (cross-component linear model) chroma prediction, host numpy.

The 4-bit-significand division table of xGetLMParameters
(IntraPrediction.cpp:1640-1866, VTM-10.0): the linear model's slope divides
the chroma range by the luma range through ``DIV_SIG[norm] | 8``, where
``norm`` is the luma range's four bits below its leading one.

The sequential encoder's predictor (host copies of the JAX package's
``ops/cclm.py``, IntraPrediction.cpp VTM-10.0): ``downsample_luma``
(xGetLumaRecPixels :1384-1464, the 6-tap downsampling of the co-located
luma with its above row and left column), ``lm_parameters`` /
``mdlm_parameters`` (xGetLMParameters :1640-1866, the 4-point template fit
of LM, MDLM_L and MDLM_T), ``downsample_above`` / ``downsample_left`` (the
extended MDLM templates) and ``cclm_pred`` (predIntraChromaLM :272-292).
The size-generic predictor and the wave path's CCLM kernel (K6a) are in
``ops/cclm_generic.py``.
"""
from __future__ import annotations

import numpy as np

DIV_SIG = np.array([0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0], np.int64)


def downsample_luma(recon_y, x_c, y_c, w_c, h_c, left_avail, above_avail,
                    ctu_size=128):
    """(interior (h_c, w_c), above (w_c,) | None, left (h_c,) | None)."""
    L = recon_y.astype(np.int64)
    lx, ly = 2 * x_c, 2 * y_c

    pad = not left_avail
    idx = lx + 2 * np.arange(w_c)
    lidx = idx - 1
    if pad:
        lidx = lidx.copy()
        lidx[0] = idx[0]                # leftPadding: reuse centre sample

    def pairs(r0):
        """One 6-tap downsampled row from luma rows r0, r0+1."""
        a, b = L[r0], L[r0 + 1]
        return (4 + 2 * a[idx] + a[idx + 1] + a[lidx]
                + 2 * b[idx] + b[idx + 1] + b[lidx]) >> 3

    interior = np.empty((h_c, w_c), np.int64)
    for j in range(h_c):
        interior[j] = pairs(ly + 2 * j)

    above = None
    if above_avail:
        if ly % ctu_size == 0:          # CTU top row: 3-tap single line
            r = L[ly - 1]
            above = (2 + 2 * r[idx] + r[idx + 1] + r[lidx]) >> 2
        else:
            above = pairs(ly - 2)

    left = None
    if left_avail:
        j2 = ly + 2 * np.arange(h_c)
        a = L[:, lx - 2][j2]
        a1 = L[:, lx - 1][j2]
        a3 = L[:, lx - 3][j2]
        b = L[:, lx - 2][j2 + 1]
        b1 = L[:, lx - 1][j2 + 1]
        b3 = L[:, lx - 3][j2 + 1]
        left = (4 + 2 * a + a1 + a3 + 2 * b + b1 + b3) >> 3
    return interior, above, left


def lm_parameters(ds_above, ds_left, top_ref, left_ref, w_c, h_c,
                  above_avail, left_avail, bit_depth=10):
    """xGetLMParameters for LM_CHROMA: (a, b, shift).

    top_ref/left_ref: substituted chroma reference lines, index 0 =
    corner (the template chroma values, curChroma0 + 1 ... :1772-1788).
    """
    if not (above_avail or left_avail):
        return 0, 1 << (bit_depth - 1), 0
    above_is4 = 0 if left_avail else 1
    left_is4 = 0 if above_avail else 1
    sel_l = []
    sel_c = []
    if above_avail:
        cnt_t = min(w_c, (1 + above_is4) << 1)
        start = w_c >> (2 + above_is4)
        step = max(1, w_c >> (1 + above_is4))
        for k in range(cnt_t):
            pos = start + k * step
            sel_l.append(int(ds_above[pos]))
            sel_c.append(int(top_ref[1 + pos]))
    if left_avail:
        cnt_l = min(h_c, (1 + left_is4) << 1)
        start = h_c >> (2 + left_is4)
        step = max(1, h_c >> (1 + left_is4))
        for k in range(cnt_l):
            pos = start + k * step
            sel_l.append(int(ds_left[pos]))
            sel_c.append(int(left_ref[1 + pos]))
    if len(sel_l) == 2:
        a0, b0 = sel_l
        c0, d0 = sel_c
        sel_l = [b0, a0, b0, a0]
        sel_c = [d0, c0, d0, c0]

    mn = [0, 2]
    mx = [1, 3]
    if sel_l[mn[0]] > sel_l[mn[1]]:
        mn[0], mn[1] = mn[1], mn[0]
    if sel_l[mx[0]] > sel_l[mx[1]]:
        mx[0], mx[1] = mx[1], mx[0]
    if sel_l[mn[0]] > sel_l[mx[1]]:
        mn, mx = mx, mn
    if sel_l[mn[1]] > sel_l[mx[0]]:
        mn[1], mx[0] = mx[0], mn[1]
    min_l = (sel_l[mn[0]] + sel_l[mn[1]] + 1) >> 1
    min_c = (sel_c[mn[0]] + sel_c[mn[1]] + 1) >> 1
    max_l = (sel_l[mx[0]] + sel_l[mx[1]] + 1) >> 1
    max_c = (sel_c[mx[0]] + sel_c[mx[1]] + 1) >> 1

    diff = max_l - min_l
    if diff <= 0:
        return 0, min_c, 0
    diff_c = max_c - min_c
    x = diff.bit_length() - 1
    norm = ((diff << 4) >> x) & 15
    v = int(DIV_SIG[norm]) | 8
    x += norm != 0
    y = (abs(diff_c).bit_length() - 1 if diff_c else -1) + 1
    add = (1 << y) >> 1
    a = (diff_c * v + add) >> y if y > 0 else diff_c * v
    shift = 3 + x - y
    if shift < 1:
        shift = 1
        a = 0 if a == 0 else (-15 if a < 0 else 15)
    b = min_c - ((a * min_l) >> shift)
    return a, b, shift


def cclm_pred(interior, a, b, shift, bit_depth=10):
    p = ((a * interior) >> shift) + b
    return np.clip(p, 0, (1 << bit_depth) - 1)


# ---------------------------------------------------------------------------
# MDLM_L / MDLM_T (directional CCLM with extended single-side templates)
# ---------------------------------------------------------------------------

def downsample_above(recon_y, x_c, y_c, n, left_avail, ctu_size=128):
    """Downsampled above-template row: ``n`` chroma samples starting at
    chroma x_c (extends into above-right for MDLM_T)."""
    L = np.asarray(recon_y, np.int64)
    lx, ly = 2 * x_c, 2 * y_c
    idx = lx + 2 * np.arange(n)
    lidx = idx - 1
    if not left_avail:
        lidx = lidx.copy()
        lidx[0] = idx[0]
    if ly % ctu_size == 0:              # CTU top row: 3-tap single line
        r = L[ly - 1]
        return (2 + 2 * r[idx] + r[idx + 1] + r[lidx]) >> 2
    a, b = L[ly - 2], L[ly - 1]
    return (4 + 2 * a[idx] + a[idx + 1] + a[lidx]
            + 2 * b[idx] + b[idx + 1] + b[lidx]) >> 3


def downsample_left(recon_y, x_c, y_c, n):
    """Downsampled left-template column: ``n`` chroma samples from y_c
    (extends into left-below for MDLM_L)."""
    L = np.asarray(recon_y, np.int64)
    lx, ly = 2 * x_c, 2 * y_c
    j2 = ly + 2 * np.arange(n)
    a = L[j2, lx - 2]
    a1 = L[j2, lx - 1]
    a3 = L[j2, lx - 3]
    b = L[j2 + 1, lx - 2]
    b1 = L[j2 + 1, lx - 1]
    b3 = L[j2 + 1, lx - 3]
    return (4 + 2 * a + a1 + a3 + 2 * b + b1 + b3) >> 3


def mdlm_parameters(mode_t, ds_line, chroma_ref, actual_n,
                    bit_depth=10):
    """xGetLMParameters for MDLM_T (mode_t=True) / MDLM_L: single-side
    template of ``actual_n`` samples; the other side forced unavailable
    (IntraPrediction.cpp:1731-1744)."""
    if actual_n <= 0:
        return 0, 1 << (bit_depth - 1), 0
    if mode_t:
        return lm_parameters(ds_line, None, chroma_ref, None,
                             actual_n, 0, True, False, bit_depth)
    return lm_parameters(None, ds_line, None, chroma_ref,
                         0, actual_n, False, True, bit_depth)
