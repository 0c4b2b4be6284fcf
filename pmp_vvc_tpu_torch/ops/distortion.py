"""Hadamard SATD with VTM's tile rule, and the sequential encoder's SATD
kernel (K10d); SAD and SSE (K10e).

Bit-exact contract (RdCost.cpp xGetHADs, :2828-2951): the block is tiled
per VTM's rules (16x8 / 8x16 / 8x4 / 4x8 / 8x8 / 4x4 / 2x2); each tile's 2-D
Hadamard of the differences with the mean-scaled DC (JVET-R0164: satd -
|DC| + (|DC| >> 2)); per-tile normalisation ((s + 2) >> 2 for 8x8,
(s + 1) >> 1 for 4x4, trunc(s * 2 / sqrt(wh)) for the non-square tiles,
the scale rounded to float32 and applied in one float32 product, as the JAX
package's float32 program does). VTM10 uses full-precision distortion
(DISTORTION_PRECISION_ADJUSTMENT 0): ``bit_depth`` does not rescale.

Any +-1 Hadamard with an all-ones first row gives the same |coeff| multiset,
so the Sylvester matrix product H_h @ D @ H_w^T reproduces VTM's butterfly
results exactly (DC lands at [0, 0]). The Hadamard sums are integers; the
JAX package sums them in float32, exactly while they stay below 2^24, as at
these sizes, and the plain version here in int64.

**K10d** ``satd`` (``csrc/seq_satd.cu``) replaces the JAX package's
``ops/distortion.py:satd`` with ``_satd_tiles``: a CPU tensor takes
``satd_reference``, a CUDA tensor launches the kernel or raises;
``satd.launches`` counts the launches. The size-generic SATD of the wave
path (square tiles only) is ``ops/tq_generic.py:satd_generic``.

**K10e** ``sad`` / ``sse`` (``csrc/seq_dist.cu``) replace the JAX package's
``ops/distortion.py:sad`` and ``sse``: the sum of |org - cur| or
(org - cur)^2 over the last two axes, in int32 as the JAX package sums with
x64 off, where the sum wraps (a 64x64 block of differences of 1023 has
``sse`` -8,384,512); ``sad_reference`` / ``sse_reference`` wrap the same
way. No path of either package calls them. The kernel sums each block as
one flat run of samples, in whatever order loads best (sums modulo 2^32
are exact in any order): a warp per block of up to 256 samples (16x16),
at most two int4s a lane, and above that a thread block per block of
samples at one int4 a lane (8 warps at 32x32, 32 at 64x64), on int4 loads
where the samples' count is a multiple of 4 and both tensors start on a
16-byte boundary (a scalar instantiation of the same kernels otherwise),
each warp's sum one ``__reduce_add_sync``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build


@functools.cache
def hadamard(n: int) -> np.ndarray:
    if n == 1:
        return np.array([[1.0]], np.float32)
    h = hadamard(n // 2)
    return np.block([[h, h], [h, -h]]).astype(np.float32)


def _tile_shape(w: int, h: int) -> tuple[int, int]:
    """VTM xGetHADs tiling rule -> (tile_h, tile_w)."""
    if w > h and h % 8 == 0 and w % 16 == 0:
        return 8, 16
    if w < h and w % 8 == 0 and h % 16 == 0:
        return 16, 8
    if w > h and h % 4 == 0 and w % 8 == 0:
        return 4, 8
    if w < h and w % 4 == 0 and h % 8 == 0:
        return 8, 4
    if h % 8 == 0 and w % 8 == 0:
        return 8, 8
    if h % 4 == 0 and w % 4 == 0:
        return 4, 4
    if h % 2 == 0 and w % 2 == 0:
        return 2, 2
    raise ValueError(f"invalid SATD size {w}x{h}")


def _tile_scale(th: int, tw: int) -> float:
    """The non-square tiles' factor 2 / sqrt(th * tw), rounded to float32."""
    return float(np.float32(2.0 / math.sqrt(th * tw)))


def _wrap_int32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums -> the int32 the JAX package's wrapping int32 sum gives."""
    return ((s + (1 << 31)) % (1 << 32) - (1 << 31)).int()


def sad_reference(org: torch.Tensor, cur: torch.Tensor, *, bit_depth: int = 10) -> torch.Tensor:
    """(..., H, W) x2 (broadcast) -> (...,) int32 sum of |org - cur|, wrapping."""
    d = org.int() - cur.int()
    return _wrap_int32(d.abs().long().sum((-2, -1)))


def sse_reference(org: torch.Tensor, cur: torch.Tensor, *, bit_depth: int = 10) -> torch.Tensor:
    """(..., H, W) x2 (broadcast) -> (...,) int32 sum of (org - cur)^2, wrapping."""
    d = (org.int() - cur.int()).long()
    return _wrap_int32((d * d).sum((-2, -1)))


def satd_reference(org: torch.Tensor, cur: torch.Tensor, *, bit_depth: int = 10) -> torch.Tensor:
    """(..., H, W) x2 (broadcast) -> (...,) int32 SATD (xGetHADs)."""
    h, w = org.shape[-2], org.shape[-1]
    th, tw = _tile_shape(w, h)
    diff = org.long() - cur.long()
    lead = diff.shape[:-2]
    nth, ntw = h // th, w // tw
    d = diff.reshape(*lead, nth, th, ntw, tw).movedim(-2, -3).reshape(
        *lead, nth * ntw, th, tw)
    hh = torch.from_numpy(hadamard(th)).double().to(d.device)
    hw = torch.from_numpy(hadamard(tw)).double().to(d.device)
    absc = (hh @ d.double() @ hw.T).round().long().abs()   # exact in float64
    dc = absc[..., 0, 0]
    tile = absc.sum((-2, -1)) - dc + (dc >> 2)
    if (th, tw) == (8, 8):
        tile = (tile + 2) >> 2
    elif (th, tw) == (4, 4):
        tile = (tile + 1) >> 1
    elif (th, tw) != (2, 2):
        scale = torch.tensor(_tile_scale(th, tw), dtype=torch.float32)
        tile = (tile.float() * scale).trunc().long()
    return tile.sum(-1).int()


SIGNATURES = {"seq_satd": {"pmp_seq_satd": (_build.PTR,) * 2 + (_build.INT,) * 6
                                           + (_build.FLOAT, _build.PTR, _build.PTR)},
              "seq_dist": {"pmp_seq_dist": (_build.PTR,) * 2 + (_build.INT,) * 4
                                           + (_build.PTR,) * 2}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def satd(org: torch.Tensor, cur: torch.Tensor, *, bit_depth: int = 10) -> torch.Tensor:
    """K10d: see ``satd_reference``; CPU tensors take it, CUDA tensors launch
    ``csrc/seq_satd.cu``. ``cur`` is (..., H, W); ``org`` is one (H, W)
    block (any leading ones) or one per candidate, of ``cur``'s shape; both
    start on a 16-byte boundary."""
    if cur.device.type == "cpu":
        return satd_reference(org, cur, bit_depth=bit_depth)
    _build.check_cuda("satd", org, cur)
    if org.dtype != torch.int32 or cur.dtype != torch.int32:
        raise TypeError("satd takes int32 tensors")
    h, w = cur.shape[-2], cur.shape[-1]
    lead = cur.shape[:-2]
    k = cur.numel() // (h * w)
    if org.shape[-2:] != (h, w) or org.numel() not in (h * w, k * h * w):
        raise ValueError(f"satd: original {tuple(org.shape)} against {tuple(cur.shape)}")
    th, tw = _tile_shape(w, h)
    if org.data_ptr() % 16 or cur.data_ptr() % 16:
        raise ValueError("satd reads tile rows as int4: both blocks must be 16-byte aligned")
    out = torch.empty(k, dtype=torch.int32, device=cur.device)
    err = _lib("seq_satd").pmp_seq_satd(
        org.data_ptr(), cur.data_ptr(), k, 0 if org.numel() == h * w else h * w, w, h,
        th, tw, _tile_scale(th, tw), out.data_ptr(), _build.stream(cur))
    _build.count_launch(satd, err)
    return out.reshape(lead)


satd.launches = 0


def _dist(wrapper, org: torch.Tensor, cur: torch.Tensor, square: bool) -> torch.Tensor:
    """K10e's launch: ``cur`` (..., H, W); ``org`` one (H, W) block (any
    leading ones) or one per block, of ``cur``'s shape."""
    _build.check_cuda(wrapper.__name__, org, cur)
    if org.dtype != torch.int32 or cur.dtype != torch.int32:
        raise TypeError(f"{wrapper.__name__} takes int32 tensors")
    h, w = cur.shape[-2], cur.shape[-1]
    k = cur.numel() // (h * w) if h * w else 0
    if org.shape[-2:] != (h, w) or org.numel() not in (h * w, k * h * w):
        raise ValueError(f"{wrapper.__name__}: original {tuple(org.shape)} against "
                         f"{tuple(cur.shape)}")
    out = torch.empty(k, dtype=torch.int32, device=cur.device)
    err = _lib("seq_dist").pmp_seq_dist(
        org.data_ptr(), cur.data_ptr(), k, h * w, 0 if org.numel() == h * w else h * w,
        int(square), out.data_ptr(), _build.stream(cur))
    _build.count_launch(wrapper, err)
    return out.reshape(cur.shape[:-2])


def sad(org: torch.Tensor, cur: torch.Tensor, *, bit_depth: int = 10) -> torch.Tensor:
    """K10e: see ``sad_reference``; CPU tensors take it, CUDA tensors launch
    ``csrc/seq_dist.cu``."""
    if cur.device.type == "cpu":
        return sad_reference(org, cur, bit_depth=bit_depth)
    return _dist(sad, org, cur, False)


def sse(org: torch.Tensor, cur: torch.Tensor, *, bit_depth: int = 10) -> torch.Tensor:
    """K10e: see ``sse_reference``; CPU tensors take it, CUDA tensors launch
    ``csrc/seq_dist.cu``."""
    if cur.device.type == "cpu":
        return sse_reference(org, cur, bit_depth=bit_depth)
    return _dist(sse, org, cur, True)


sad.launches = 0
sse.launches = 0
