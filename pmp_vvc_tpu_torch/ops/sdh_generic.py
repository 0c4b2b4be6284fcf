"""Sign-data-hiding level adjustment — batched, size-generic (plain PyTorch).

The JAX package's ``ops/sdh_generic.py`` (the encoder side of
``Quant::xSignBitHidingHDQ``, Quant.cpp:261) for the wave path: in every
coefficient group whose first and last significant scan positions are at
least SBH_THRESHOLD (4) apart, the decoder infers the sign of the first
significant level from the parity of the group's absolute-level sum
(``codec/residual.py`` reads it back), so where that parity disagrees the
encoder moves one level by one.

The moves considered are the always-legal ones, +1 in magnitude on any
nonzero level and -1 on any level of magnitude >= 2: neither creates nor
removes a level, so the hide condition stays true. The move with the least
added dequantisation error wins, the error in float32 as
``(deq(l') - c)^2 - (deq(l) - c)^2`` with the exact integer dequantiser,
candidates in the order up[0..15] then down[0..15] and the first minimum
taken. K4 (``csrc/tq.cu``) runs the same adjustment inside its block; the
coefficient-group table it reads is ``cg_tables`` on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec.residual import grouped_scan, log2_sbb_size
from .tq_generic import _dequant_unclipped, _log2

SLOT = 16           # max CG size (g_log2SbbSize caps at 2+2)
SBH_THRESHOLD = 4


@functools.cache
def _cg_tables(P: int):
    """(49, NCG, 16) int64: flat P-plane index of scan slot ``k`` of CG
    ``g`` for a (2**lw, 2**lh) TB at row lw*7 + lh, -1 where absent. NCG
    covers the zero-out-limited scanned region (grouped_scan stops at 32),
    and at P = 4 the two 2x2 groups of a 2x4 or 4x2 TB."""
    scans = {}
    for lw in range(1, P.bit_length()):
        for lh in range(1, P.bit_length()):
            cgl2w, cgl2h = log2_sbb_size(lw, lh)
            scans[lw, lh] = grouped_scan(1 << lw, 1 << lh), 1 << (cgl2w + cgl2h)
    ncg = max([(min(32, P) * min(32, P) + SLOT - 1) // SLOT] +
              [-(-len(scan) // cg_size) for scan, cg_size in scans.values()])
    tab = np.full((49, ncg, SLOT), -1, np.int64)
    for (lw, lh), (scan, cg_size) in scans.items():
        for s in range(scan.shape[0]):
            x, y = int(scan[s, 1]), int(scan[s, 2])
            tab[lw * 7 + lh, s // cg_size, s % cg_size] = y * P + x
    return tab


@functools.cache
def cg_tables(P: int, device: torch.device) -> torch.Tensor:
    """``_cg_tables(P)`` as an int32 tensor on ``device``."""
    return torch.from_numpy(_cg_tables(P).astype(np.int32)).to(device)


def sdh_moves(lev, coef, ws, hs, qp: int, *, bit_depth: int = 10):
    """Per coefficient group of (B, P, P) levels: (mismatch (B, NCG) bool,
    errors (B, NCG, 32) float32 with +inf for moves that are out, flat
    target index (B, NCG, 32), new level (B, NCG, 32))."""
    B, P, _ = lev.shape
    tab = torch.from_numpy(_cg_tables(P)).to(lev.device)
    idx = tab[(_log2(ws) * 7 + _log2(hs)).long()]                 # (B, NCG, 16)
    valid = idx >= 0
    safe = idx.clamp(0, P * P - 1).reshape(B, -1)
    levg = torch.where(valid, lev.reshape(B, P * P).gather(1, safe).reshape(idx.shape), 0)
    coefg = torch.where(valid, coef.reshape(B, P * P).gather(1, safe).reshape(idx.shape), 0)

    def sq_err(l):
        d = _dequant_unclipped(l, ws, hs, qp, bit_depth).float() - cf
        return d * d

    slots = torch.arange(SLOT, device=lev.device)
    nz = levg != 0
    first = torch.where(nz, slots, 99).amin(-1)                    # (B, NCG)
    last = torch.where(nz, slots, -1).amax(-1)
    hide = (last - first) >= SBH_THRESHOLD
    parity = levg.abs().sum(-1) & 1
    firstlev = levg.gather(-1, first.clamp(0, SLOT - 1)[..., None])[..., 0]
    mismatch = hide & (parity != (firstlev < 0).long())

    sgn = torch.sign(levg)
    nl_up, nl_dn = levg + sgn, levg - sgn
    cf = coefg.float()
    base = sq_err(levg)
    e_up = torch.where(nz, sq_err(nl_up) - base, torch.inf)
    e_dn = torch.where(levg.abs() >= 2, sq_err(nl_dn) - base, torch.inf)
    return (mismatch, torch.cat([e_up, e_dn], -1), torch.cat([idx, idx], -1),
            torch.cat([nl_up, nl_dn], -1))


def apply_sdh_generic(lev, coef, ws, hs, qp: int, *, bit_depth: int = 10):
    """Adjust (B, P, P) int32 levels so every sign-hiding CG's parity
    encodes the sign of its first significant level. ``coef`` are the
    pre-quant coefficients in the same domain as ``lev``; ``qp`` the
    internal QP; ws/hs (B,) the TB sizes."""
    B, P, _ = lev.shape
    mismatch, err, tgt, new = sdh_moves(lev, coef, ws, hs, qp, bit_depth=bit_depth)
    k = err.argmin(-1, keepdim=True)                               # first minimum
    tgt, new = tgt.gather(-1, k)[..., 0], new.gather(-1, k)[..., 0]
    flat = lev.reshape(B, P * P).clone()
    b, g = torch.nonzero(mismatch, as_tuple=True)
    flat[b, tgt[b, g]] = new[b, g].to(flat.dtype)
    return flat.reshape(B, P, P)
