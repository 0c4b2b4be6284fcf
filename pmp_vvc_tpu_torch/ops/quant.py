"""VVC scalar quantization constants (numpy; no device code).

Semantics of the standard / VTM path with scaling lists and dependent
quantization off (Quant.cpp:954-1031 ``Quant::quant``, :380-470
``Quant::dequant``; constants CommonDef.h:328-329, scale tables
Rom.cpp:475-486):

  tShift   = 15 - bitDepth - (log2W + log2H)/2          (ChromaFormat.h:111)
  sqrt2    = (log2W + log2H) odd                        (UnitTools.cpp:3900)
  qBits    = 14 + qp/6 + tShift - sqrt2
  level    = sign * ((|c| * qScale[sqrt2][qp%6] + dz << (qBits-9)) >> qBits)
  deq      = clip16((clip16(level) * iqScale[sqrt2][qp%6] + add) >> rShift)
  rShift   = 6 - (tShift - sqrt2 + qp/6)                (may be negative)

Dead-zone ``dz`` = 171 for IRAP slices (all-intra). Transform skip
quantises the residual itself at the clamped QP ``ts_qp`` with
qBits = 14 + qp/6 and rShift = 6 - qp/6 (no transform shift, no sqrt2).
The size-generic device versions are in ``ops/tq_generic.py``.
"""
from __future__ import annotations

import numpy as np

QUANT_SCALES = np.array([[26214, 23302, 20560, 18396, 16384, 14564],
                         [18396, 16384, 14564, 13107, 11651, 10280]],
                        np.int32)
INV_QUANT_SCALES = np.array([[40, 45, 51, 57, 64, 72],
                             [57, 64, 72, 80, 90, 102]], np.int32)

QUANT_SHIFT = 14
IQUANT_SHIFT = 6
MAX_LOG2_DYN_RANGE = 15
COEFF_MIN = -(1 << MAX_LOG2_DYN_RANGE)
COEFF_MAX = (1 << MAX_LOG2_DYN_RANGE) - 1


def _geom(w: int, h: int, bit_depth: int):
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    t_shift = MAX_LOG2_DYN_RANGE - bit_depth - ((lw + lh) >> 1)
    sqrt2 = (lw + lh) & 1
    return t_shift, sqrt2


def ts_qp(qp: int, internal_minus_input: int = 0) -> int:
    """Transform-skip QP clamp (QpParam ctor, Quant.cpp:98):
    baseQpTS = max(baseQp, 4 + 6 * internalMinusInputBitDepth)."""
    return max(qp, 4 + 6 * internal_minus_input)
