"""VVC primary transforms (DCT-II / DST-VII / DCT-VIII), int32.

Bit-exact integer semantics of the standard / VTM pipeline
(TrQuant.cpp:806-846 forward, :848-893 inverse; 6-bit core matrices,
``g_transformMatrixShift = 6``, ``maxLog2TrDynamicRange = 15``)::

    forward:  C = rs2( Tv  @ rs1( X @ Th^T ) )          rs = round-shift
    inverse:  R = clip16( rs2'( clip16( rs1'( Tv^T @ C ) ) @ Th ) )

with s1 = log2(W) + bitDepth + 6 - 15, s2 = log2(H) + 6, s1' = 7 and
s2' = 20 - bitDepth. High-frequency zero-out: DCT-2 keeps 32 of 64, DST-7 /
DCT-8 16 of 32 coefficients per side (TrQuant.cpp:777-804). The 1xN and Nx1
TUs of ISP take one stage over the coded side with the first stage's shift
(TrQuant.cpp:860-902).

The core matrices are normative H.266 constants (rows are basis vectors)
loaded from ``codec/data/transform_cores.npz``, a copy of the JAX package's
table. ``forward_transform_reference`` and ``inverse_transform_reference``
are the plain versions of the sequential encoder's K10c stages, whose
wrappers are in ``ops/quant.py``; the size-generic DCT-2 transforms of the
wave path are in ``ops/tq_generic.py``.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

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


def nonzero_out_size(kind: int, n: int) -> int:
    """Coefficients kept per dimension (zero-out rule, TrQuant.cpp:777)."""
    if kind == DCT2:
        return min(n, 32)
    return min(n, 16)


def _rshift(x, s: int):
    return (x + (1 << (s - 1))) >> s if s > 0 else x << (-s)


def _core(kind: int, n: int, device) -> torch.Tensor:
    return torch.from_numpy(core_matrix(kind, n)).long().to(device)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product: float64 holds every partial sum (CUDA has no
    int64 matmul)."""
    return (a.double() @ b.double()).round().long()


def transform_shift_fwd(w: int, h: int, bit_depth: int = 10):
    s1 = (w.bit_length() - 1) + bit_depth + MATRIX_SHIFT - MAX_LOG2_DYN_RANGE
    s2 = (h.bit_length() - 1) + MATRIX_SHIFT
    return s1, s2


def forward_transform_reference(x: torch.Tensor, kind_h: int = DCT2,
                                kind_v: int = DCT2, bit_depth: int = 10) -> torch.Tensor:
    """(..., H, W) int32 residual -> (..., H, W) int32 coefficients
    ([vertical frequency, horizontal frequency]; the zeroed-out region
    stays zero)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.long()
    if w == 1 or h == 1:
        n = h if w == 1 else w
        kind = kind_v if w == 1 else kind_h
        k = nonzero_out_size(kind, n)
        s = (n.bit_length() - 1) + bit_depth + MATRIX_SHIFT - MAX_LOG2_DYN_RANGE
        ax = -2 if w == 1 else -1
        v = x.movedim(ax, -1)
        out = torch.zeros(v.shape, dtype=torch.long, device=x.device)
        out[..., :k] = _rshift(_mm(v, _core(kind, n, x.device)[:k].T), s)
        return out.movedim(-1, ax).int()
    kw, kh = nonzero_out_size(kind_h, w), nonzero_out_size(kind_v, h)
    s1, s2 = transform_shift_fwd(w, h, bit_depth)
    t1 = _rshift(_mm(x, _core(kind_h, w, x.device)[:kw].T), s1)    # (..., H, kw)
    t2 = _rshift(_mm(_core(kind_v, h, x.device)[:kh], t1), s2)     # (..., kh, kw)
    out = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    out[..., :kh, :kw] = t2
    return out.int()


def inverse_transform_reference(c: torch.Tensor, kind_h: int = DCT2,
                                kind_v: int = DCT2, bit_depth: int = 10) -> torch.Tensor:
    """(..., H, W) int32 coefficients -> residual, with the full core
    matrices; both stages clipped to 16 bits."""
    h, w = c.shape[-2], c.shape[-1]
    c = c.long()
    if w == 1 or h == 1:
        n = h if w == 1 else w
        kind = kind_v if w == 1 else kind_h
        s = (MATRIX_SHIFT + MAX_LOG2_DYN_RANGE - 1) - bit_depth + 1
        ax = -2 if w == 1 else -1
        r = _rshift(_mm(c.movedim(ax, -1), _core(kind, n, c.device)), s)
        return r.clamp(COEFF_MIN, COEFF_MAX).movedim(-1, ax).int()
    s2 = MATRIX_SHIFT + MAX_LOG2_DYN_RANGE - 1 - bit_depth
    e = _rshift(_mm(_core(kind_v, h, c.device).T, c), MATRIX_SHIFT + 1)
    e = e.clamp(COEFF_MIN, COEFF_MAX)
    r = _rshift(_mm(e, _core(kind_h, w, c.device)), s2)
    return r.clamp(COEFF_MIN, COEFF_MAX).int()
