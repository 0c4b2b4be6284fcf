"""Matrix-based intra prediction (MIP) constants and size classes (numpy).

MatrixIntraPrediction.cpp (VTM-10.0): the weight matmul shifts by
MIP_SHIFT_MATRIX = 6 with offset MIP_OFFSET_MATRIX = 32; the three size
classes and their mode counts are getMipSizeId / getNumModesMip
(UnitTools.cpp:3938-3964). The weight tables are the port's own copy,
``codec/data/mip_matrices.npz``.

**K10b** ``predict_mip_all`` (``csrc/seq_mip.cu``, sharing ``csrc/mip.cuh``
with K3) gives every MIP candidate of one block, for the sequential
encoder: the JAX package's ``predict_mip_all`` (which its
``codec/encoder.py:_jit_mip`` jits). ``predict_mip_all_reference`` is its
plain version, used for CPU tensors; a CUDA tensor launches the kernel or
raises; ``predict_mip_all.launches`` counts the launches. The size-generic
predictor and the wave path's MIP kernel (K3) are in ``ops/mip_generic.py``.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from .. import _build

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


def _downsample(vec, n_out):
    n_in = vec.shape[-1]
    if n_in == n_out:
        return vec
    f = n_in // n_out
    s = vec.reshape(vec.shape[:-1] + (n_out, f)).sum(-1)
    return (s + (f >> 1)) >> (f.bit_length() - 1)


def _upsample_1d(red, before, factor):
    """predictionUpsampling1D along the last axis: red (..., n) reduced
    samples, before (...,) the boundary sample prepended; (..., n*factor)."""
    if factor == 1:
        return red
    prev = torch.cat([before[..., None], red[..., :-1]], -1)
    p = torch.arange(1, factor + 1, device=red.device)
    out = ((factor - p) * prev[..., None] + p * red[..., None]
           + (factor >> 1)) >> (factor.bit_length() - 1)
    return out.reshape(out.shape[:-2] + (-1,))


def predict_mip_all_reference(top, left, *, w: int, h: int, bit_depth: int = 10):
    """All MIP candidate predictions of one block.

    top/left: (2W+3,) / (2H+3,) substituted unfiltered reference rows,
    index 0 = the corner. Returns (2 * numModes, h, w) int32: index
    t * numModes + m = mode m with transpose flag t."""
    sid = size_id(w, h)
    red_b = 2 if sid == 0 else 4
    red_p = 4 if sid < 2 else 8
    n_modes = num_modes(w, h)
    mat = torch.from_numpy(_matrices()[sid].astype(np.int64)).to(top.device)
    top_full = top[1:1 + w].long()
    left_full = left[1:1 + h].long()
    red_top = _downsample(top_full, red_b)
    red_left = _downsample(left_full, red_b)

    def reduced_pred(bdry):                            # bdry: (2*red_b,)
        off = bdry[0]
        first = (1 << (bit_depth - 1)) - off if sid < 2 else torch.zeros_like(off)
        vec = torch.cat([first[None], bdry[1:] - off])
        vec_m = vec[1:] if sid == 2 else vec            # 7-weight rows
        add = (1 << (MIP_SHIFT - 1)) - MIP_OFFSET * vec.sum()
        res = ((mat.double() @ vec_m.double()).round().long() + add) >> MIP_SHIFT
        res = (res + off).clamp(0, (1 << bit_depth) - 1)
        return res.reshape(n_modes, red_p, red_p)

    red_n = reduced_pred(torch.cat([red_top, red_left]))
    red_t = reduced_pred(torch.cat([red_left, red_top])).transpose(1, 2)
    out = torch.cat([red_n, red_t])                    # (2M, rp, rp)
    f_h, f_v = w // red_p, h // red_p
    if f_h > 1:
        # horizontal pass: boundary = the left sample of each target row
        lsel = left_full[f_v - 1::f_v][:red_p]
        out = _upsample_1d(out, lsel.expand(out.shape[:-1]), f_h)
    if f_v > 1:
        # vertical pass against the full top boundary
        cols = out.transpose(-1, -2)
        cols = _upsample_1d(cols, top_full.expand(cols.shape[:-1]), f_v)
        out = cols.transpose(-1, -2)
    return out.int()


SIGNATURES = {"seq_mip": {"pmp_seq_mip": (_build.PTR,) * 3 + (_build.INT,) * 4
                                         + (_build.PTR,) * 2}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def predict_mip_all(top, left, *, w: int, h: int, bit_depth: int = 10):
    """K10b: see ``predict_mip_all_reference``; CPU tensors take it, CUDA
    tensors launch ``csrc/seq_mip.cu`` (one launch for every candidate).
    The rows may be views at any int32 offset: the kernel reads them with
    scalar loads."""
    if top.device.type == "cpu":
        return predict_mip_all_reference(top, left, w=w, h=h, bit_depth=bit_depth)
    from .mip_generic import _device_table
    _build.check_cuda("predict_mip_all", top, left)
    if top.dtype != torch.int32 or left.dtype != torch.int32 or \
            top.shape != (2 * w + 3,) or left.shape != (2 * h + 3,):
        raise ValueError(f"predict_mip_all: a {w}x{h} block takes int32 (2W+3,) and "
                         f"(2H+3,) rows, got {tuple(top.shape)}, {tuple(left.shape)}")
    out = torch.empty((2 * num_modes(w, h), h, w), dtype=torch.int32, device=top.device)
    err = _lib("seq_mip").pmp_seq_mip(top.data_ptr(), left.data_ptr(),
                                      _device_table(top.device).data_ptr(), 1, w, h,
                                      bit_depth, out.data_ptr(), _build.stream(top))
    _build.count_launch(predict_mip_all, err)
    return out


predict_mip_all.launches = 0
