"""VVC intra prediction tables and reference substitution.

Contracts (IntraPrediction.cpp):
- reference line layout          :977-1225 (xFillReferenceSamples) — here
  ``top``/``left`` arrays of length 2W+3 / 2H+3 with index 0 = the
  top-left corner sample, then 2W (2H) reference samples, then 2 slots of
  replication for the angular over-read.
- mode parametrisation           :371-443 (initPredIntraParams): wide-angle
  remap (:183-203), MDIS filter decision (m_aucIntraFilter :58),
  angle/inverse-angle tables, PDPC enablement + scale

The tables and ``mode_params`` are host numpy/Python, copied from the JAX
package's ``ops/intra.py``; ``fill_reference_samples`` is its plain PyTorch
version. The size-generic predictor and the K1/K2 kernels' wrappers are in
``ops/intra_generic.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PLANAR_IDX, DC_IDX = 0, 1
HOR_IDX, DIA_IDX, VER_IDX, VDIA_IDX = 18, 34, 50, 66
NUM_LUMA_MODE = 67

ANG_TABLE = np.array([0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26,
                      29, 32, 35, 39, 45, 51, 57, 64, 73, 86, 102, 128, 171,
                      256, 341, 512, 1024], np.int32)
INV_ANG_TABLE = np.array([0, 16384, 8192, 5461, 4096, 2731, 2048, 1638, 1365,
                          1170, 1024, 910, 819, 712, 630, 565, 512, 468, 420,
                          364, 321, 287, 256, 224, 191, 161, 128, 96, 64, 48,
                          32, 16], np.int32)
# MDIS thresholds per log2 size (IntraPrediction.cpp:58)
INTRA_FILTER_THRESH = np.array([24, 24, 24, 14, 2, 0, 0, 0], np.int32)

# 4-tap DCT-IF ("cubic") filter, normative H.266 table
# (InterpolationFilter.cpp:182, spec 8.4.5.2.13)
CHROMA_FILTER = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1]],
    np.int32)


def _flog2(v: int) -> int:
    return int(v).bit_length() - 1


def wide_angle(width: int, height: int, mode: int) -> int:
    """Wide-angle mode remap (IntraPrediction.cpp:183-203)."""
    if mode <= DC_IDX or mode > VDIA_IDX:
        return mode
    mode_shift = [0, 6, 10, 12, 14, 15]
    delta = abs(_flog2(width) - _flog2(height))
    if width > height and mode < 2 + mode_shift[delta]:
        return mode + (VDIA_IDX - 1)
    if height > width and mode > VDIA_IDX - mode_shift[delta]:
        return mode - (VDIA_IDX - 1)
    return mode


@dataclass(frozen=True)
class ModeParams:
    """Static per-mode parameters for one (w, h, is_luma) geometry."""

    mode: int
    pred_mode: int       # after wide-angle remap
    is_ver: bool
    angle: int           # signed intraPredAngle (1/32 px)
    inv_angle: int
    use_filtered: bool   # reference-filtering (MDIS [1 2 1]) selected
    interpolate_gauss: bool  # Gaussian smoothing 4-tap instead of DCT-IF
    apply_pdpc: bool
    pdpc_scale: int


def mode_params(w: int, h: int, mode: int, *, is_luma: bool = True,
                mrl: int = 0, isp: bool = False) -> ModeParams:
    """initPredIntraParams contract (IntraPrediction.cpp:371-443)."""
    pred_mode = wide_angle(w, h, mode)
    is_ver = pred_mode >= DIA_IDX
    ang_mode = (pred_mode - VER_IDX) if is_ver else -(pred_mode - HOR_IDX)
    apply_pdpc = w >= 4 and h >= 4 and mrl == 0

    angle = inv_angle = 0
    scale = 0
    if DC_IDX < mode < NUM_LUMA_MODE:
        abs_mode = abs(ang_mode)
        angle = int(np.sign(ang_mode) or 1) * int(ANG_TABLE[abs_mode]) \
            if ang_mode != 0 else 0
        inv_angle = int(INV_ANG_TABLE[abs_mode])
        if ang_mode < 0:
            apply_pdpc = False
        elif ang_mode > 0:
            side = h if is_ver else w
            scale = min(2, _flog2(side) - (_flog2(3 * inv_angle - 2) - 8))
            apply_pdpc = apply_pdpc and scale >= 0

    use_filtered = False
    interp = False
    if not (not is_luma or isp or mrl or mode == DC_IDX):
        if mode == PLANAR_IDX:
            use_filtered = w * h > 32
        else:
            diff = min(abs(pred_mode - HOR_IDX), abs(pred_mode - VER_IDX))
            log2_size = (_flog2(w) + _flog2(h)) >> 1
            if diff > int(INTRA_FILTER_THRESH[log2_size]):
                is_int_slope = (abs(angle) & 0x1F) == 0
                use_filtered = is_int_slope
                interp = not is_int_slope
    return ModeParams(mode, pred_mode, is_ver, angle, inv_angle,
                      use_filtered, interp, apply_pdpc, scale)


# ---------------------------------------------------------------------------
# Reference sample preparation
# ---------------------------------------------------------------------------

def fill_reference_samples(top_raw, left_raw, avail_top, avail_left,
                           avail_corner, corner_raw, *, bit_depth: int = 10):
    """VVC reference substitution (spec 8.4.5.2.2 / xFillReferenceSamples).

    top_raw:  (N, 2W) int32 candidate top samples; left_raw: (N, 2H);
    corner_raw: (N,); avail_*: boolean masks of the same shapes.
    Returns (top, left): (N, 2W+3) / (N, 2H+3) with index 0 = corner and
    2 trailing replication slots.
    Substitution scans bottom-left -> corner -> top-right, replacing
    unavailable samples with the previous available one (first samples
    backfilled from the first available; all-DC if nothing available).
    """
    h2 = left_raw.shape[1]
    dc = 1 << (bit_depth - 1)
    scan_vals = torch.cat([left_raw.flip(1), corner_raw[:, None], top_raw], 1)
    scan_avail = torch.cat([avail_left.flip(1), avail_corner[:, None],
                            avail_top], 1)
    idx = torch.arange(scan_vals.shape[1], device=scan_vals.device)[None, :]
    # last available index at or before i (-1 if none)
    last = torch.where(scan_avail, idx, -1).cummax(dim=1).values
    # first available index overall (for the leading run)
    first = scan_avail.to(torch.int32).argmax(dim=1)
    any_avail = scan_avail.any(dim=1)
    gather_idx = torch.where(last >= 0, last, first[:, None])
    filled = torch.gather(scan_vals, 1, gather_idx)
    filled = torch.where(any_avail[:, None], filled, torch.full_like(filled, dc))
    left = filled[:, :h2 + 1].flip(1)      # [corner, left_0..left_{2H-1}]
    top = filled[:, h2:]                   # [corner, top_0..top_{2W-1}]
    # 2 replication slots for angular over-read (maxIndex extension)
    top = torch.cat([top, top[:, -1:], top[:, -1:]], 1)
    left = torch.cat([left, left[:, -1:], left[:, -1:]], 1)
    return top, left
