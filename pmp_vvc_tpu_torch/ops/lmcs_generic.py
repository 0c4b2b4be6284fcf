"""LMCS chroma residual scaling (CRS) of the wave step — the plain version of
the scale that K4 (``csrc/tq.cu``) derives and applies on the card.

The JAX package derives the scale in ``wavefront.py:_chroma_part`` (558-590)
and applies it inside ``_tq_generic`` (146-171):

- ``crs_lut``: sample value -> CRS scale, ``chroma_adj_lut`` over the
  inverse-PWL bin of the value, from the AI reshape model the headers signal
  (``wavefront.py:338-348``);
- ``crs_scale_reference``: per CU, the average of its 64x64 VPDU's left
  column and above row of MAPPED luma recon, 64 samples each, read clamped
  to the frame, each side taken where the chroma tree's coding-order grid
  says its first sample precedes the CU (calculateChromaAdjVpduNei,
  Reshape.cpp:106-190), looked up in the LUT; CUs of 4 or fewer chroma
  samples are not scaled (scale ``1 << 11``);
- ``crs_forward`` / ``crs_inverse``: the residual scaled before the forward
  transform and the reconstructed residual scaled back after the inverse
  (AreaBuf::scaleSignal, CSCALE_FP_PREC = 11), rounding on magnitudes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..codec.lmcs import CSCALE_FP_PREC, Reshaper, derive_ai_model
from .rows import unpack_rows

UNIT_SCALE = 1 << CSCALE_FP_PREC     # the scale that leaves a residual as it is
VPDU = 64


def crs_lut(bit_depth: int, lmcs_offset: int) -> np.ndarray:
    """(1 << bit_depth,) int32: the CRS scale of each neighbour average."""
    rsh = Reshaper(derive_ai_model(bit_depth, lmcs_offset), bit_depth)
    return rsh.chroma_adj_lut[rsh._pwl_idx_inv(np.arange(1 << bit_depth))].astype(np.int32)


def crs_neighbours(og, rows):
    """(left, above) (B,) bool: whether each row's VPDU left column (above
    row) counts, i.e. the leaf covering its first sample precedes the CU in
    the coding order ``og`` (the sequential path's single-unit check)."""
    from .intra_generic import avail_from_order   # it imports tq_generic
    fi, xs, ys, _, _, oi, _ = unpack_rows(rows, 1)
    vx, vy = xs // VPDU * VPDU, ys // VPDU * VPDU
    left = avail_from_order(og, fi, oi, (vx - 4).clamp(min=0) // 4, vy // 4, vx > 0)
    above = avail_from_order(og, fi, oi, vx // 4, (vy - 4).clamp(min=0) // 4, vy > 0)
    return left, above


def crs_scale_reference(ry, og, rows, lut, bit_depth):
    """(B,) int32 CRS scale of each chroma CU of ``rows`` (luma units).

    ``ry``: (F, H, W) int32 mapped luma recon; ``og``: (F, H/4, W/4) int32
    coding-order grid of the chroma CUs (the chroma tree's in dual tree, the
    shared one in single tree); ``lut``: ``crs_lut`` as a tensor. Padding
    rows get ``UNIT_SCALE``."""
    from .intra_generic import gather_plane
    fi, xs, ys, ws, hs, _, ok = unpack_rows(rows, 1)
    vx, vy = xs // VPDU * VPDU, ys // VPDU * VPDU
    left, above = crs_neighbours(og, rows)
    i = torch.arange(VPDU, device=rows.device, dtype=torch.int32)[None]
    s_l = gather_plane(ry, fi[:, None], vy[:, None] + i, (vx - 1).clamp(min=0)[:, None]).sum(-1)
    s_t = gather_plane(ry, fi[:, None], (vy - 1).clamp(min=0)[:, None], vx[:, None] + i).sum(-1)
    s = torch.where(left, s_l, 0) + torch.where(above, s_t, 0)
    n = left.int() + above.int()
    avg = torch.where(n == 0, 1 << (bit_depth - 1),
                      (s + (32 << (n - 1).clamp(min=0))) >> (5 + n))
    scale = lut[avg.clamp(0, lut.shape[0] - 1).long()]
    # chroma TUs of 4 or fewer samples are not scaled (DecCu.cpp)
    gate = ok & ((ws // 2) * (hs // 2) > 4)
    return torch.where(gate, scale, UNIT_SCALE).int()


def crs_forward(resid, crs, bit_depth):
    """The residual scaled for coding: sgn * min(((|r| << 11) + c/2) // c,
    2^bd - 1), ``crs`` (B,) over (B, P, P) tiles."""
    c = crs[:, None, None]
    mag = (((resid.abs() << CSCALE_FP_PREC) + (c >> 1)) // c).clamp(max=(1 << bit_depth) - 1)
    return torch.sign(resid) * mag


def crs_inverse(rr, crs, bit_depth):
    """The reconstructed residual scaled back: clipped to
    [-2^bd, 2^bd - 1], sgn * ((|r| * c + 2^10) >> 11), clipped to 16 bits."""
    c = crs[:, None, None]
    rs = rr.clamp(-(1 << bit_depth), (1 << bit_depth) - 1)
    out = torch.sign(rs) * ((rs.abs() * c + (1 << (CSCALE_FP_PREC - 1))) >> CSCALE_FP_PREC)
    return out.clamp(-32768, 32767)
