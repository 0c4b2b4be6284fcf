"""CABAC fractional-bit rate estimation (the CABACEstimator role).

VTM runs every RD decision against a second CABAC instance whose
"arithmetic coder" only accumulates fractional bits from the per-state
estimation table while adapting contexts exactly like the real encoder
(reference: Lib/CommonLib/Contexts.h:80-127 estFracBits/getFracBitsArray,
Contexts.cpp m_binFracBits[256]; used throughout EncoderLib/CABACWriter.cpp
via getEstFracBits).  This module is that second instance: a sink with the
same ``encode_*`` API as ``cabac.BinEncoder`` / ``encoder.RecordingEncoder``
so every syntax writer (mode syntax, residual coding, split flags) can be
pointed at it unchanged.

Bits accumulate in 2^-15 units (SCALE_BITS).  ``clone()`` gives a cheap
snapshot for candidate trials; the running estimator is advanced by the
recording encoder tee so trial rates always start from the true context
state at the current coding position.
"""
from __future__ import annotations

import pathlib

import numpy as np

from .cabac import ContextStore, MASK_0, MASK_1

_DATA = pathlib.Path(__file__).resolve().parent / "data"

SCALE_BITS = 15

with np.load(_DATA / "cabac_frac_bits.npz") as _z:
    # (256, 2): fractional bits of coding (bin==0, bin==1) at each state
    _FB = _z["frac_bits"].astype(np.int64)
FRAC_BITS = [(int(a), int(b)) for a, b in _FB]

# estFracBitsTrm (Contexts.h:126)
_TRM_BITS = (0x0010C, 0x3BFBB)


class RateEstimator:
    """Fractional-bit CABAC estimator with live context adaptation."""

    __slots__ = ("state0", "state1", "rate", "frac")

    def __init__(self, ctx: ContextStore | None = None):
        if ctx is not None:
            self.state0 = list(ctx.state0)
            self.state1 = list(ctx.state1)
            self.rate = list(ctx.rate)
        self.frac = 0

    @classmethod
    def standard_init(cls, qp: int, init_id: int = 2) -> "RateEstimator":
        return cls(ContextStore.standard_init(qp, init_id))

    def clone(self) -> "RateEstimator":
        c = RateEstimator.__new__(RateEstimator)
        c.state0 = self.state0.copy()
        c.state1 = self.state1.copy()
        c.rate = self.rate.copy()
        c.frac = self.frac
        return c

    @property
    def bits(self) -> float:
        """Accumulated rate in bits."""
        return self.frac / float(1 << SCALE_BITS)

    # ---- BinEncoder-compatible sink API ---------------------------------

    def encode_bin(self, bin_val: int, ctx_id: int):
        s0 = self.state0[ctx_id]
        s1 = self.state1[ctx_id]
        self.frac += FRAC_BITS[(s0 + s1) >> 8][bin_val]
        rate = self.rate[ctx_id]
        r0 = rate >> 4
        r1 = rate & 15
        s0 -= (s0 >> r0) & MASK_0
        s1 -= (s1 >> r1) & MASK_1
        if bin_val:
            s0 += (0x7FFF >> r0) & MASK_0
            s1 += (0x7FFF >> r1) & MASK_1
        self.state0[ctx_id] = s0
        self.state1[ctx_id] = s1

    def bin_bits(self, bin_val: int, ctx_id: int) -> int:
        """Rate of one ctx bin WITHOUT coding it (2^-15 units)."""
        return FRAC_BITS[(self.state0[ctx_id] + self.state1[ctx_id])
                         >> 8][bin_val]

    def encode_bin_ep(self, bin_val: int):
        self.frac += 1 << SCALE_BITS

    def encode_bins_ep(self, bins: int, num_bins: int):
        self.frac += num_bins << SCALE_BITS

    def encode_bin_trm(self, bin_val: int):
        self.frac += _TRM_BITS[bin_val]

    def align(self):
        pass

    def encode_rem_abs_ep(self, value: int, rice_par: int, cutoff: int,
                          max_log2_dyn_range: int = 15):
        self.frac += rem_abs_ep_bits(value, rice_par, cutoff,
                                     max_log2_dyn_range) << SCALE_BITS


def rem_abs_ep_bits(value: int, rice_par: int, cutoff: int,
                    max_log2_dyn_range: int = 15) -> int:
    """EP bit count of encodeRemAbsEP (BinEncoder.cpp:208)."""
    threshold = cutoff << rice_par
    if value < threshold:
        return (value >> rice_par) + 1 + rice_par
    max_prefix = 32 - cutoff - max_log2_dyn_range
    code_value = (value >> rice_par) - cutoff
    if code_value >= (1 << max_prefix) - 1:
        prefix_len = max_prefix
        suffix_len = max_log2_dyn_range
    else:
        prefix_len = 0
        while code_value > (2 << prefix_len) - 2:
            prefix_len += 1
        suffix_len = prefix_len + rice_par + 1
    return prefix_len + cutoff + suffix_len
