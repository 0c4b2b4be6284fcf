"""VVC scalar quantization, and the sequential encoder's transform-
quantisation kernel (K10c).

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
qBits = 14 + qp/6 and rShift = 6 - qp/6 (no transform shift, no sqrt2);
``quantize_ts`` / ``dequantize_ts`` are host numpy, as in the JAX package.

**K10c** ``seq_tq`` (``csrc/seq_tq.cu``) runs the stages of a mask — forward
transform, quantisation, dequantisation, inverse transform — on a batch of
TUs in one launch and returns every stage's output, stacked: the JAX package's
``ops/transforms.py:forward_transform`` / ``inverse_transform``,
``ops/quant.py:quantize`` / ``dequantize`` and their fusion
``codec/encoder.py:_jit_tq``. ``forward_transform``, ``inverse_transform``,
``quantize`` and ``dequantize`` here are ``seq_tq`` with one stage. For a
CPU tensor it runs ``seq_tq_reference``, the plain versions in order; for
a CUDA tensor it launches the kernel or raises; ``seq_tq.launches`` counts
the launches. The size-generic device versions of the wave path are in
``ops/tq_generic.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .transforms import (DCT2, _core, forward_transform_reference,
                         inverse_transform_reference)

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


def quantize_reference(coef: torch.Tensor, *, w: int, h: int, qp: int,
                       bit_depth: int = 10, is_irap: bool = True) -> torch.Tensor:
    """(..., H, W) int32 transform coefficients -> quantized levels."""
    t_shift, sqrt2 = _geom(w, h, bit_depth)
    scale = int(QUANT_SCALES[sqrt2][qp % 6])
    q_bits = QUANT_SHIFT + qp // 6 + (t_shift - sqrt2)
    add = (171 if is_irap else 85) << (q_bits - 9)
    c = coef.long()
    level = (c.abs() * scale + add) >> q_bits
    return torch.where(c < 0, -level, level).clamp(COEFF_MIN, COEFF_MAX).int()


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken to int32 two's complement (their low 32 bits)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def dequantize_reference(level: torch.Tensor, *, w: int, h: int, qp: int,
                         bit_depth: int = 10) -> torch.Tensor:
    """Quantized levels -> reconstructed transform coefficients (clip16).

    In int32 arithmetic as the JAX package's ``dequantize``: where the
    shift is a left shift, the product of a level near the 16-bit limit can
    pass 2^31 (at 10 bits a 1x2 or 2x1 TU at internal QP 74-75) and wraps
    before the clip. The right-shift branch stays below 2^31 (32,768 x 102)."""
    t_shift, sqrt2 = _geom(w, h, bit_depth)
    scale = int(INV_QUANT_SCALES[sqrt2][qp % 6])
    right_shift = IQUANT_SHIFT - ((t_shift - sqrt2) + qp // 6)
    lvl = level.long().clamp(COEFF_MIN, COEFF_MAX)
    if right_shift > 0:
        deq = (lvl * scale + (1 << (right_shift - 1))) >> right_shift
    else:
        deq = _wrap32((lvl * scale) << (-right_shift))
    return deq.clamp(COEFF_MIN, COEFF_MAX).int()


def quantize_ts(resid: np.ndarray, qp: int, *, is_irap: bool = True):
    """Transform-skip forward quantisation (Quant::quant with
    iTransformShift = 0 and no sqrt2 adjustment, Quant.cpp: iQBits =
    QUANT_SHIFT + per; TU::needsSqrt2Scale returns false for TS,
    UnitTools.cpp:3900). ``qp`` must already be TS-clamped."""
    q_bits = QUANT_SHIFT + qp // 6
    scale = int(QUANT_SCALES[0][qp % 6])
    add = (171 if is_irap else 85) << (q_bits - 9)
    r = np.asarray(resid, np.int64)
    mag = (np.abs(r) * scale + add) >> q_bits
    mag = np.minimum(mag, COEFF_MAX)
    return np.where(r < 0, -mag, mag).astype(np.int32)


def dequantize_ts(level: np.ndarray, qp: int):
    """Transform-skip dequantisation (Quant::dequant TS branch:
    rightShift = IQUANT_SHIFT - QP_per, no transform shift); the
    inverse transform is the identity copy (TrQuant::xITransformSkip)."""
    shift = IQUANT_SHIFT - qp // 6
    scale = int(INV_QUANT_SCALES[0][qp % 6])
    lvl = np.clip(np.asarray(level, np.int64), COEFF_MIN, COEFF_MAX)
    if shift > 0:
        deq = (lvl * scale + (1 << (shift - 1))) >> shift
    else:
        deq = (lvl * scale) << (-shift)
    return np.clip(deq, COEFF_MIN, COEFF_MAX).astype(np.int32)


# ---------------------------------------------------------------------------
# K10c: the transform-quantisation stages of a batch of TUs
# ---------------------------------------------------------------------------

FWD, QUANT, DEQUANT, INV = 1, 2, 4, 8     # the stages, in the order they run
ROUND_TRIP = FWD | QUANT | DEQUANT | INV

SIGNATURES = {"seq_tq": {"pmp_seq_tq": (_build.PTR,) * 3 + (_build.INT,) * 8
                                       + (_build.PTR,) * 2}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


@functools.cache
def _device_cores(device: torch.device):
    """The 64-point DCT-2 core and the (2, 4, 32, 32) DCT-8 / DST-7 cores of
    sizes 4..32 on ``device``, uploaded once (``csrc/seq_tq.cu:core_row``
    reads them)."""
    from .tq_generic import _mts_table
    d64 = _core(DCT2, 64, device).int().contiguous()
    mts = torch.from_numpy(np.stack([_mts_table(1), _mts_table(2)])).to(device)
    return d64, mts


def seq_tq_reference(x, stages, *, kind_h=DCT2, kind_v=DCT2, qp=0, bit_depth=10):
    """Plain version of K10c: the stages of ``stages`` in order on
    ``x`` (..., h, w) int32; each stage's output, stacked (S, ..., h, w)."""
    h, w = x.shape[-2], x.shape[-1]
    outs = []
    for st in (FWD, QUANT, DEQUANT, INV):
        if not stages & st:
            continue
        if st == FWD:
            x = forward_transform_reference(x, kind_h, kind_v, bit_depth)
        elif st == QUANT:
            x = quantize_reference(x, w=w, h=h, qp=qp, bit_depth=bit_depth)
        elif st == DEQUANT:
            x = dequantize_reference(x, w=w, h=h, qp=qp, bit_depth=bit_depth)
        else:
            x = inverse_transform_reference(x, kind_h, kind_v, bit_depth)
        outs.append(x)
    return torch.stack(outs)


def seq_tq(x, stages, *, kind_h=DCT2, kind_v=DCT2, qp=0, bit_depth=10):
    """K10c: see ``seq_tq_reference``; a CPU tensor takes it, a CUDA tensor
    launches ``csrc/seq_tq.cu`` (one launch for every stage and TU), and
    must start on a 16-byte boundary."""
    if not 0 < stages < 16:
        raise ValueError(f"seq_tq: stage mask {stages} is not in 1..15")
    if x.device.type == "cpu":
        return seq_tq_reference(x, stages, kind_h=kind_h, kind_v=kind_v, qp=qp,
                                bit_depth=bit_depth)
    _build.check_cuda("seq_tq", x)
    if x.dtype != torch.int32:
        raise TypeError("seq_tq takes int32 tensors")
    h, w = x.shape[-2], x.shape[-1]
    for kind, n in ((kind_h, w), (kind_v, h)):
        if n & (n - 1) or not 1 <= n <= 64 or kind not in (0, 1, 2) or \
                (n > 1 and kind != DCT2 and not 4 <= n <= 32):
            raise ValueError(f"seq_tq: no transform of kind {kind} over a side of {n}")
    if qp < 0:
        raise ValueError(f"seq_tq: QP {qp}")
    if x.data_ptr() % 16:
        raise ValueError("seq_tq reads the TUs as int4: the input must be 16-byte aligned")
    n = x.numel() // (h * w)
    ns = bin(stages).count("1")
    out = torch.empty((ns,) + tuple(x.shape), dtype=torch.int32, device=x.device)
    d64, mts = _device_cores(x.device)
    err = _lib("seq_tq").pmp_seq_tq(x.data_ptr(), d64.data_ptr(), mts.data_ptr(), n, w, h,
                                    kind_h, kind_v, qp, bit_depth, stages, out.data_ptr(),
                                    _build.stream(x))
    _build.count_launch(seq_tq, err)
    return out


seq_tq.launches = 0


def forward_transform(x, kind_h=DCT2, kind_v=DCT2, bit_depth=10):
    """K10c's forward transform alone (``transforms.py``'s reference)."""
    return seq_tq(x, FWD, kind_h=kind_h, kind_v=kind_v, bit_depth=bit_depth)[0]


def inverse_transform(c, kind_h=DCT2, kind_v=DCT2, bit_depth=10):
    """K10c's inverse transform alone."""
    return seq_tq(c, INV, kind_h=kind_h, kind_v=kind_v, bit_depth=bit_depth)[0]


def quantize(coef, *, w, h, qp, bit_depth=10):
    """K10c's quantisation alone; ``w``, ``h`` must be ``coef``'s sides."""
    if coef.shape[-2:] != (h, w):
        raise ValueError(f"quantize: a {tuple(coef.shape)} tile is not {w}x{h}")
    return seq_tq(coef, QUANT, qp=qp, bit_depth=bit_depth)[0]


def dequantize(level, *, w, h, qp, bit_depth=10):
    """K10c's dequantisation alone."""
    if level.shape[-2:] != (h, w):
        raise ValueError(f"dequantize: a {tuple(level.shape)} tile is not {w}x{h}")
    return seq_tq(level, DEQUANT, qp=qp, bit_depth=bit_depth)[0]
