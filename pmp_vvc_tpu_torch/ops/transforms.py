"""VVC primary-transform constants (numpy; no device code).

The core matrices are normative H.266 constants (6-bit, rows are basis
vectors) loaded from ``codec/data/transform_cores.npz``, a copy of the JAX
package's table. ``g_transformMatrixShift = 6`` and
``maxLog2TrDynamicRange = 15`` (TrQuant.cpp:806-893). The size-generic
DCT-2 transforms of the wave path are in ``ops/tq_generic.py``.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent.parent / "codec" / "data"

# trType codes follow the standard's order (mtsIdx mapping): DCT2=0, DCT8=1, DST7=2
DCT2, DCT8, DST7 = 0, 1, 2
_KIND_NAME = {DCT2: "dct2", DST7: "dst7", DCT8: "dct8"}

MAX_LOG2_DYN_RANGE = 15
COEFF_MIN = -(1 << MAX_LOG2_DYN_RANGE)
COEFF_MAX = (1 << MAX_LOG2_DYN_RANGE) - 1
MATRIX_SHIFT = 6


@functools.cache
def _cores() -> dict:
    with np.load(DATA / "transform_cores.npz") as z:
        return {k: z[k] for k in z.files}


@functools.cache
def core_matrix(kind: int, n: int) -> np.ndarray:
    """(n, n) int32 core matrix; rows are basis vectors."""
    return _cores()[f"{_KIND_NAME[kind]}_{n}"].astype(np.int32)
