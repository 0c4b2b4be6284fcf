"""LFNST (low-frequency non-separable secondary transform): tables,
parameters and the sequential encoder's host transforms (numpy; no device
code).

Contract: TrQuant.cpp (VTM-10.0):
- getLFNSTIntraMode / getTransposeFlag (:328-352): wide-angle-extended
  mode -> kernel set via g_lfnstLut (RomLFNST.cpp:51);
- the secondary coefficients sit along the top-left 4x4 diagonal scan
  (``_DIAG4``).

Tables: ``codec/data/lfnst.npz``, a copy of the JAX package's: lfnstLut
(95,), lfnst4x4 (4, 2, 16, 16) and lfnst8x8 (4, 2, 16, 48), all int32.
``fwd_lfnst`` / ``inv_lfnst`` (TrQuant.cpp fwdLfnstNxN / invLfnstNxN
:248-326 and xFwdLfnst / xInvLfnst :354-562: the int8 kernel product with
(c + 64) >> 7, the inverse clipped to 16 bits, over the top-left 48- or
16-sample region with the mode's transpose) are host copies of the JAX
package's, for the sequential encoder. The size-generic forward and inverse
transforms of the wave path are in ``ops/lfnst_generic.py``.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np

from .intra import wide_angle

_DATA = pathlib.Path(__file__).resolve().parent.parent / "codec" / "data"
NUM_LUMA_MODE = 67
EXT_HALF = 14                        # NUM_EXT_LUMA_MODE >> 1
DIA_IDX = 34


@functools.cache
def _tables():
    with np.load(_DATA / "lfnst.npz") as z:
        return z["lfnstLut"], z["lfnst4x4"], z["lfnst8x8"]


def lfnst_params(intra_mode: int, w: int, h: int):
    """(set_idx, transpose) for a final intra mode and TU geometry."""
    wam = wide_angle(w, h, intra_mode)
    if wam < 0:
        ext = wam + EXT_HALF + NUM_LUMA_MODE
    elif wam >= NUM_LUMA_MODE:
        ext = wam + EXT_HALF
    else:
        ext = wam
    lut, _, _ = _tables()
    transpose = (ext >= NUM_LUMA_MODE + EXT_HALF) or \
        (ext < NUM_LUMA_MODE and ext > DIA_IDX)
    return int(lut[ext]), transpose


def _diag4_positions():
    """Diagonal scan of a 4x4 CG: (y, x) sequence (up-right diagonal)."""
    pos = []
    for d in range(7):
        for y in range(min(d, 3), -1, -1):
            x = d - y
            if x <= 3:
                pos.append((y, x))
    return pos


_DIAG4 = _diag4_positions()


def _region_gather(coeffs, sb, transpose):
    """Top-left region -> 48/16 vector, xFwdLfnst order (:498-543)."""
    c = coeffs
    if sb == 4:
        blk = c[:4, :4]
        return (blk.T if transpose else blk).reshape(-1)
    v = np.zeros(48, c.dtype)
    if transpose:
        # lfnstTemp[0/8/16/24] = row y cols 0..3; +32.. for y<4 cols 4..7
        for y in range(8):
            for i in range(4):
                v[8 * i + y] = c[y, i]
            if y < 4:
                for i in range(4):
                    v[32 + 4 * i + y] = c[y, 4 + i]
    else:
        v[:32] = c[:4, :8].reshape(-1)
        v[32:] = c[4:8, :4].reshape(-1)
    return v


def _region_scatter(vec, sb, transpose, w, h, dtype):
    """48/16 vector -> TU coefficient block (xInvLfnst layout)."""
    c = np.zeros((h, w), dtype)
    if sb == 4:
        blk = vec.reshape(4, 4)
        c[:4, :4] = blk.T if transpose else blk
        return c
    if transpose:
        for y in range(8):
            for i in range(4):
                c[y, i] = vec[8 * i + y]
            if y < 4:
                for i in range(4):
                    c[y, 4 + i] = vec[32 + 4 * i + y]
    else:
        c[:4, :8] = vec[:32].reshape(4, 8)
        c[4:8, :4] = vec[32:].reshape(4, 4)
    return c


def fwd_lfnst(coeffs, intra_mode: int, lfnst_idx: int, w: int, h: int):
    """Forward LFNST over primary-transform coefficients (h, w) int.

    Returns a full (h, w) array: the 16 (or 8) secondary coefficients in
    the top-left 4x4 diagonal-scan positions, everything else zero (the
    encoder may only signal lfnst when nothing survives outside)."""
    _, m4, m8 = _tables()
    sb = 8 if (w >= 8 and h >= 8) else 4
    set_idx, transpose = lfnst_params(intra_mode, w, h)
    kern = (m8 if sb == 8 else m4)[set_idx][lfnst_idx - 1]   # (16, 48/16)
    vec = _region_gather(np.asarray(coeffs, np.int64), sb, transpose)
    n_out = 8 if (w == 4 and h == 4) or (w == 8 and h == 8) else 16
    out_v = (kern[:n_out].astype(np.int64) @ vec + 64) >> 7
    out = np.zeros((h, w), np.int64)
    for k in range(n_out):
        y, x = _DIAG4[k]
        out[y, x] = out_v[k]
    return out


def inv_lfnst(coeffs, intra_mode: int, lfnst_idx: int, w: int, h: int):
    """Inverse LFNST: top-left 4x4 diag coefficients -> primary coeffs."""
    _, m4, m8 = _tables()
    sb = 8 if (w >= 8 and h >= 8) else 4
    set_idx, transpose = lfnst_params(intra_mode, w, h)
    kern = (m8 if sb == 8 else m4)[set_idx][lfnst_idx - 1]
    n_in = 8 if (w == 4 and h == 4) or (w == 8 and h == 8) else 16
    c = np.asarray(coeffs, np.int64)
    vec = np.array([c[_DIAG4[k]] for k in range(n_in)], np.int64)
    res = (kern[:n_in].astype(np.int64).T @ vec + 64) >> 7
    res = np.clip(res, -(1 << 15), (1 << 15) - 1)
    return _region_scatter(res, sb, transpose, w, h, np.int64)
