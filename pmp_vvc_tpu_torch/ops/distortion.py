"""Hadamard matrix of the SATD (RdCost.cpp xGetHADs, :2828-2951).

Any +-1 Hadamard with an all-ones first row gives the same |coeff|
multiset, so the Sylvester matrix product H_h @ D @ H_w^T reproduces VTM's
butterfly results exactly (DC lands at [0, 0]). The size-generic SATD of
the wave path is ``ops/tq_generic.py:satd_generic``.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.cache
def hadamard(n: int) -> np.ndarray:
    if n == 1:
        return np.array([[1.0]], np.float32)
    h = hadamard(n // 2)
    return np.block([[h, h], [h, -h]]).astype(np.float32)
