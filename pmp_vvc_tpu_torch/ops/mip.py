"""Matrix-based intra prediction (MIP) constants and size classes (numpy).

MatrixIntraPrediction.cpp (VTM-10.0): the weight matmul shifts by
MIP_SHIFT_MATRIX = 6 with offset MIP_OFFSET_MATRIX = 32; the three size
classes and their mode counts are getMipSizeId / getNumModesMip
(UnitTools.cpp:3938-3964). The weight tables are the port's own copy,
``codec/data/mip_matrices.npz``. The size-generic predictor and the wave
path's MIP kernel (K3) are in ``ops/mip_generic.py``.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parent.parent / "codec" / "data"

MIP_SHIFT = 6
MIP_OFFSET = 32


@functools.cache
def _matrices():
    """(16, 16, 4), (8, 16, 8) and (6, 64, 7) int32 weights of sizeId 0-2."""
    z = np.load(_DATA / "mip_matrices.npz")
    return (z["mipMatrix4x4"], z["mipMatrix8x8"], z["mipMatrix16x16"])


def size_id(w: int, h: int) -> int:
    if w == 4 and h == 4:
        return 0
    if w == 4 or h == 4 or (w == 8 and h == 8):
        return 1
    return 2


def num_modes(w: int, h: int) -> int:
    return (16, 8, 6)[size_id(w, h)]
