"""LFNST (low-frequency non-separable secondary transform) tables and
parameters (numpy; no device code).

Contract: TrQuant.cpp (VTM-10.0):
- getLFNSTIntraMode / getTransposeFlag (:328-352): wide-angle-extended
  mode -> kernel set via g_lfnstLut (RomLFNST.cpp:51);
- the secondary coefficients sit along the top-left 4x4 diagonal scan
  (``_DIAG4``).

Tables: ``codec/data/lfnst.npz``, a copy of the JAX package's: lfnstLut
(95,), lfnst4x4 (4, 2, 16, 16) and lfnst8x8 (4, 2, 16, 48), all int32.
The size-generic forward and inverse transforms are in
``ops/lfnst_generic.py``.
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
