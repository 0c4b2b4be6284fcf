"""CCLM (cross-component linear model) constants.

The 4-bit-significand division table of xGetLMParameters
(IntraPrediction.cpp:1640-1866, VTM-10.0): the linear model's slope divides
the chroma range by the luma range through ``DIV_SIG[norm] | 8``, where
``norm`` is the luma range's four bits below its leading one. The
size-generic predictor and the wave path's CCLM kernel (K6a) are in
``ops/cclm_generic.py``.
"""
from __future__ import annotations

import numpy as np

DIV_SIG = np.array([0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0], np.int64)
