"""Size-generic batched LFNST for the wave path (plain PyTorch).

The JAX package's ``ops/lfnst_generic.py`` (TrQuant.cpp fwdLfnstNxN /
invLfnstNxN :248-326, xFwdLfnst / xInvLfnst :354-562, getLFNSTIntraMode /
getTransposeFlag :328-352) with CU size and intra mode as tensor data on
padded (B, P, P) tiles: the top-left region gather is a per-CU lookup in one
of four index tables (8x8 or 4x4 region, plain or transposed), the kernel a
per-CU gather from one stacked int32 array, and the 16 x 48 secondary
transform one batched product, run in float64, where every partial sum of
these integers is exact. K5 (``csrc/tq_mts.cu``) computes the same inside
its block.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .lfnst import _DIAG4, _tables, DIA_IDX, EXT_HALF, NUM_LUMA_MODE
from .tq_generic import _log2

_MODE_SHIFT = np.array([0, 6, 10, 12, 14, 15], np.int32)


@functools.cache
def _gather_tables(P):
    """(4, 48) flat source indices + masks for the region gather;
    variants: 0 = 8x8 plain, 1 = 8x8 transposed, 2 = 4x4 plain,
    3 = 4x4 transposed (xFwdLfnst :498-543 orders).  Masked-off slots
    index P*P (dropped on scatter, zeroed on gather)."""
    idx = np.full((4, 48), P * P, np.int32)

    def put(v, k, y, x):
        idx[v, k] = y * P + x

    k = 0
    for y in range(4):
        for x in range(8):
            put(0, k, y, x)
            k += 1
    for y in range(4, 8):
        for x in range(4):
            put(0, k, y, x)
            k += 1
    for y in range(8):
        for i in range(4):
            put(1, 8 * i + y, y, i)
    for y in range(4):
        for i in range(4):
            put(1, 32 + 4 * i + y, y, 4 + i)
    k = 0
    for y in range(4):
        for x in range(4):
            put(2, k, y, x)
            k += 1
    k = 0
    for y in range(4):
        for x in range(4):
            put(3, k, x, y)
            k += 1
    return idx, (idx < P * P).astype(np.int32)


@functools.cache
def _kernels():
    """lfnstLut + stacked kernels K[sb8, set, idx-1] as (16, 48)
    (the 4x4 kernels occupy the first 16 columns)."""
    lut, m4, m8 = _tables()
    S = m8.shape[0]
    K = np.zeros((2, S, 2, 16, 48), np.int32)
    K[1] = m8
    K[0, :, :, :, :16] = m4
    return np.asarray(lut, np.int32), K


@functools.cache
def lfnst_device_tables(device: torch.device):
    """(lut (95,), kernels (2, 4, 2, 16, 48)) int32 on ``device``, for K5."""
    lut, K = _kernels()
    return torch.from_numpy(lut).to(device), torch.from_numpy(K).to(device)


@functools.cache
def lfnst_gather_table(P: int, device: torch.device) -> torch.Tensor:
    """``_gather_tables(P)``'s (4, 48) index table as int32 on ``device``
    (P * P marks a slot that is not used), for K5."""
    return torch.from_numpy(_gather_tables(P)[0]).to(device)


def lfnst_params_generic(modes, ws, hs):
    """(set_idx, transpose) per CU — vectorized ``lfnst_params`` (the
    wide-angle extension of getLFNSTIntraMode)."""
    lut, _ = lfnst_device_tables(modes.device)
    m = modes.long()
    shift = torch.from_numpy(_MODE_SHIFT).to(modes.device)[(_log2(ws) - _log2(hs)).abs().long()]
    ang = (m > 1) & (m <= 66)
    wam = torch.where(ang & (ws > hs) & (m < 2 + shift), m + 65,
                      torch.where(ang & (hs > ws) & (m > 66 - shift), m - 65, m))
    ext = torch.where(wam < 0, wam + EXT_HALF + NUM_LUMA_MODE,
                      torch.where(wam >= NUM_LUMA_MODE, wam + EXT_HALF, wam))
    transpose = (ext >= NUM_LUMA_MODE + EXT_HALF) | ((ext < NUM_LUMA_MODE) & (ext > DIA_IDX))
    return lut[ext], transpose


def _diag_flat(P):
    d = np.asarray(_DIAG4, np.int64)
    return d[:, 0] * P + d[:, 1]


def _geom(coef, modes, ws, hs, lfnst_idx):
    P = coef.shape[-1]
    dev = coef.device
    idx_tab, msk_tab = (torch.from_numpy(t).to(dev) for t in _gather_tables(P))
    _, K = lfnst_device_tables(dev)
    set_idx, transpose = lfnst_params_generic(modes, ws, hs)
    sb8 = ((ws >= 8) & (hs >= 8)).long()
    v = (1 - sb8) * 2 + transpose.long()
    idx, msk = idx_tab[v].long(), msk_tab[v]                       # (B, 48)
    kern = K[sb8, set_idx.long(), lfnst_idx - 1]                    # (B, 16, 48)
    n16 = torch.where(((ws == 4) & (hs == 4)) | ((ws == 8) & (hs == 8)), 8, 16)
    return P, idx, msk, kern, n16


def fwd_lfnst_generic(coef, modes, ws, hs, lfnst_idx: int):
    """(B, P, P) primary coefficients -> secondary coefficients placed
    on the top-left 4x4 diagonal scan; everything else zero."""
    B = coef.shape[0]
    P, idx, msk, kern, n_out = _geom(coef, modes, ws, hs, lfnst_idx)
    flat = torch.nn.functional.pad(coef.reshape(B, -1), (0, 1))
    src = flat.gather(1, idx) * msk
    out16 = (torch.bmm(kern.double(), src.double()[:, :, None])[:, :, 0].round().long()
             + 64) >> 7
    out16 = out16 * (torch.arange(16, device=coef.device)[None] < n_out[:, None])
    out = torch.zeros((B, P * P), dtype=coef.dtype, device=coef.device)
    out[:, torch.from_numpy(_diag_flat(P)).to(coef.device)] = out16.to(coef.dtype)
    return out.reshape(B, P, P)


def inv_lfnst_generic(coef, modes, ws, hs, lfnst_idx: int):
    """Top-left diagonal secondary coefficients -> primary coefficients
    (clipped to the 16-bit range, invLfnstNxN :300-326)."""
    B = coef.shape[0]
    P, idx, msk, kern, n_in = _geom(coef, modes, ws, hs, lfnst_idx)
    diag = torch.from_numpy(_diag_flat(P)).to(coef.device)
    vec16 = coef.reshape(B, -1)[:, diag] * \
        (torch.arange(16, device=coef.device)[None] < n_in[:, None])
    res = (torch.bmm(vec16.double()[:, None, :], kern.double())[:, 0].round().long()
           + 64) >> 7
    res = res.clamp(-(1 << 15), (1 << 15) - 1) * msk
    out = torch.zeros((B, P * P + 1), dtype=coef.dtype, device=coef.device)
    out.scatter_(1, idx, res.to(coef.dtype))
    return out[:, :P * P].reshape(B, P, P)
