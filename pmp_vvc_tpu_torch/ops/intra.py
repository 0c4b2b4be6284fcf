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
package's ``ops/intra.py``; ``fill_reference_samples`` and
``filter_reference_samples`` are plain PyTorch versions of its functions.

**K10a** ``predict_block`` (``csrc/seq_intra.cu``) predicts N blocks of one
size for a tuple of modes, for the sequential encoder (a chroma CU's U and
V rows as N = 2): the JAX package's ``predict_block`` (which its
``codec/encoder.py:_jit_predict`` jits, one plane a call).
``predict_block_reference`` is its plain version, used for CPU tensors; a
CUDA tensor launches the kernel or raises; ``predict_block.launches``
counts the launches. MRL and ISP predictions (``predict_mrl``,
``predict_isp``, with ``substitute_line`` and the ISP geometry helpers) are
host numpy, as in the JAX package. The size-generic predictor and the K1/K2
kernels' wrappers are in ``ops/intra_generic.py``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build

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


def filter_reference_samples(top, left):
    """[1 2 1]/4 smoothing (xFilterReferenceSamples, :1227-1262).

    top: (N, 2W+3), left: (N, 2H+3), index 0 = corner. The corner becomes
    (corner + top[1] + corner + left[1] + 2) >> 2 with the corner in both
    rows; the last real sample (index 2W / 2H) is copied unfiltered, and
    the replication slots follow."""
    corner = (top[:, 0] + top[:, 1] + left[:, 0] + left[:, 1] + 2) >> 2

    def assemble(row):
        mid = (row[:, :-2] + 2 * row[:, 1:-1] + row[:, 2:] + 2) >> 2
        last_real = row.shape[1] - 3       # index 2W
        return torch.cat([corner[:, None], mid[:, :last_real - 1],
                          row[:, last_real:]], 1)
    return assemble(top), assemble(left)


# ---------------------------------------------------------------------------
# K10a: one block's predictions for a tuple of modes
# ---------------------------------------------------------------------------

def _predict_planar(top, left, w, h):
    """top/left: (N, >=W+2)/(N, >=H+2) incl. corner at 0. Returns (N,h,w)."""
    log2w, log2h = _flog2(w), _flog2(h)
    t = top[:, 1:w + 2].long()
    l = left[:, 1:h + 2].long()
    bottom_left = l[:, h][:, None]
    top_right = t[:, w][:, None]
    xs = torch.arange(w, device=top.device)
    ys = torch.arange(h, device=top.device)
    top_row, left_col = t[:, :w], l[:, :h]
    hor = (left_col[:, :, None] << log2w) + \
        (xs[None, None, :] + 1) * (top_right[:, :, None] - left_col[:, :, None])
    ver = (top_row[:, None, :] << log2h) + \
        (ys[None, :, None] + 1) * (bottom_left[:, :, None] - top_row[:, None, :])
    offset = 1 << (log2w + log2h)
    return ((hor << log2h) + (ver << log2w) + offset) >> (1 + log2w + log2h)


def _predict_dc(top, left, w, h):
    denom = (w << 1) if w == h else max(w, h)
    s = torch.zeros(top.shape[0], dtype=torch.long, device=top.device)
    if w >= h:
        s = s + top[:, 1:w + 1].long().sum(1)
    if w <= h:
        s = s + left[:, 1:h + 1].long().sum(1)
    dc = (s + (denom >> 1)) >> _flog2(denom)
    return dc[:, None, None].expand(top.shape[0], h, w)


def _pdpc_planar_dc(pred, top, left, w, h):
    """PDPC for planar/DC (predIntraAng :248-271). No clipping."""
    scale = (_flog2(w) - 2 + _flog2(h) - 2 + 2) >> 2
    xs = np.arange(w)
    ys = np.arange(h)
    w_t = torch.from_numpy(32 >> np.minimum(31, (ys[:, None] << 1) >> scale)).to(pred.device)
    w_l = torch.from_numpy(32 >> np.minimum(31, (xs[None, :] << 1) >> scale)).to(pred.device)
    t = top[:, 1:w + 1].long()[:, None, :]
    l = left[:, 1:h + 1].long()[:, :, None]
    return pred + ((w_l[None] * (l - pred) + w_t[None] * (t - pred) + 32) >> 6)


def _gather(ref, idx):
    """ref (N, M, L) gathered along L at the (M, K) numpy indices."""
    t = torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(ref.device)
    return torch.gather(ref, 2, t[None].expand(ref.shape[0], -1, -1))


def _predict_angular_batch(main_u, main_f, side_u, side_f, mps, wp: int, hp: int,
                           is_luma: bool, bit_depth: int):
    """All angular modes of one orientation (vertical modes with (main,
    side) = (top, left); horizontal ones with the pair swapped and a final
    transpose by the caller). Returns (N, M, hp, wp).

    The integer-slope copy is the 4-tap DCT-IF at phase 0; the chroma
    2-tap lerp is the 4-tap [0, 64-2f, 2f, 0] exactly."""
    n, m = main_u.shape[0], len(mps)
    dev = main_u.device
    pel_max = (1 << bit_depth) - 1
    angle = np.array([p.angle for p in mps], np.int64)
    inv_angle = np.array([p.inv_angle for p in mps], np.int64)
    use_filt = np.array([p.use_filtered for p in mps], bool)
    gauss = np.array([p.interpolate_gauss for p in mps], bool)
    pdpc = np.array([p.apply_pdpc for p in mps], bool)
    scale = np.array([max(p.pdpc_scale, 0) for p in mps], np.int64)

    filt = torch.from_numpy(use_filt).to(dev)[None, :, None]
    main_sel = torch.where(filt, main_f[:, None, :], main_u[:, None, :]).long()
    side_sel = torch.where(filt, side_f[:, None, :], side_u[:, None, :]).long()
    ls = side_sel.shape[2]

    # negative-angle extension (positive-angle modes never index below off)
    neg_j = np.arange(1, hp + 1)
    proj = np.minimum((neg_j[None, :] * inv_angle[:, None] + 256) >> 9, hp)
    ref = torch.cat([_gather(side_sel, proj[:, ::-1]), main_sel], 2)
    off = hp
    l2 = hp + main_sel.shape[2]

    ys = np.arange(hp)
    delta_pos = angle[:, None] * (1 + ys[None, :])
    delta_int = delta_pos >> 5
    delta_frac = delta_pos & 31
    if is_luma:
        half = delta_frac >> 1
        g = np.stack([16 - half, 32 - half, 16 + half, half], axis=-1)
        c = CHROMA_FILTER[delta_frac]
        fs = np.where(gauss[:, None, None], g, c)
    else:
        zf = np.zeros_like(delta_frac)
        fs = np.stack([zf, 64 - 2 * delta_frac, 2 * delta_frac, zf], axis=-1)
    fs = torch.from_numpy(fs.astype(np.int64)).to(dev)            # (M, hp, 4)

    xs = np.arange(wp)
    base = off + delta_int[:, :, None] + xs[None, None, :]         # (M, hp, wp)
    acc = torch.zeros((n, m, hp, wp), dtype=torch.long, device=dev)
    for k in range(4):
        idx = np.clip(base + k, 0, l2 - 1).reshape(m, hp * wp)
        acc = acc + fs[None, :, :, k:k + 1] * _gather(ref, idx).reshape(n, m, hp, wp)
    pred = ((acc + 32) >> 6).clamp(0, pel_max)

    if pdpc.any():
        zero = angle == 0
        # variant A: angle > 0, the side-projected sample (:624-660)
        inv_sum = 256 + (xs[None, :] + 1) * inv_angle[:, None]
        side_idx = np.clip(ys[None, :, None] + (inv_sum[:, None, :] >> 9) + 1, 0, ls - 1)
        sv = _gather(side_sel, side_idx.reshape(m, hp * wp)).reshape(n, m, hp, wp)
        w_l = torch.from_numpy(32 >> np.minimum(31, (2 * xs[None, :]) >> scale[:, None])).to(dev)
        adj_pos = (w_l[None, :, None, :] * (sv - pred) + 32) >> 6
        lim = np.minimum(3 << scale, wp)
        keep = torch.from_numpy(xs[None, :] < lim[:, None]).to(dev)[None, :, None, :]
        pred_pos = pred + torch.where(keep, adj_pos, 0)
        # variant B: angle == 0 (pure horizontal / vertical), the corner form
        scale0 = (_flog2(wp) + _flog2(hp) - 2) >> 2
        top_left = ref[:, :, off][:, :, None, None]
        lvals = side_sel[:, :, 1:hp + 1][:, :, :, None]
        wl0 = torch.from_numpy(32 >> np.minimum(31, (2 * xs) >> scale0)).to(dev)
        adj0 = (wl0[None, None, None, :] * (lvals - top_left) + 32) >> 6
        adj0 = torch.where(torch.from_numpy(xs < min(3 << scale0, wp)).to(dev), adj0, 0)
        pred_zero = (pred + adj0).clamp(0, pel_max)
        which = torch.from_numpy(np.where(~pdpc, 0, np.where(zero, 2, 1))).to(dev)
        sel = which[None, :, None, None]
        pred = torch.where(sel == 2, pred_zero, torch.where(sel == 1, pred_pos, pred))
    return pred


def predict_block_reference(top_u, left_u, top_f, left_f, *, w: int, h: int,
                            modes: tuple, is_luma: bool = True, bit_depth: int = 10):
    """Predict a batch of N blocks of one size for a tuple of modes.

    top_u/left_u (and the filtered top_f/left_f): (N, 2W+3)/(N, 2H+3)
    reference rows (index 0 = corner). Returns (N, len(modes), h, w) int32.
    """
    params = [mode_params(w, h, mode, is_luma=is_luma) for mode in modes]
    outs = [None] * len(modes)
    ver_idx = [i for i, p in enumerate(params) if p.mode > DC_IDX and p.is_ver]
    hor_idx = [i for i, p in enumerate(params) if p.mode > DC_IDX and not p.is_ver]
    for i, p in enumerate(params):
        if p.mode == PLANAR_IDX:
            top = top_f if p.use_filtered else top_u
            left = left_f if p.use_filtered else left_u
            pred = _predict_planar(top, left, w, h)
            if p.apply_pdpc:
                pred = _pdpc_planar_dc(pred, top, left, w, h)
            outs[i] = pred
        elif p.mode == DC_IDX:
            pred = _predict_dc(top_u, left_u, w, h)
            if p.apply_pdpc:
                pred = _pdpc_planar_dc(pred, top_u, left_u, w, h)
            outs[i] = pred
    if ver_idx:
        preds = _predict_angular_batch(top_u, top_f, left_u, left_f,
                                       [params[i] for i in ver_idx], w, h, is_luma,
                                       bit_depth)
        for k, i in enumerate(ver_idx):
            outs[i] = preds[:, k]
    if hor_idx:
        preds = _predict_angular_batch(left_u, left_f, top_u, top_f,
                                       [params[i] for i in hor_idx], h, w, is_luma,
                                       bit_depth)
        for k, i in enumerate(hor_idx):
            outs[i] = preds[:, k].transpose(-1, -2)
    return torch.stack(outs, 1).int()


SIGNATURES = {"seq_intra": {"pmp_seq_intra": (_build.PTR,) * 6 + (_build.INT,) * 6
                                             + (_build.PTR,) * 2}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


@functools.cache
def _device_modes(modes: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(modes, dtype=torch.int32, device=device)


def predict_block(top_u, left_u, top_f, left_f, *, w: int, h: int, modes: tuple,
                  is_luma: bool = True, bit_depth: int = 10):
    """K10a: see ``predict_block_reference``; CPU tensors take it, CUDA
    tensors launch ``csrc/seq_intra.cu`` (one launch for every block and
    mode). The rows may be views at any int32 offset: the kernel reads
    them with scalar loads."""
    if top_u.device.type == "cpu":
        return predict_block_reference(top_u, left_u, top_f, left_f, w=w, h=h,
                                       modes=modes, is_luma=is_luma, bit_depth=bit_depth)
    from .intra_generic import _device_tables
    refs = (top_u, left_u, top_f, left_f)
    _build.check_cuda("predict_block", *refs)
    n = top_u.shape[0]
    if any(r.dtype != torch.int32 for r in refs) or \
            top_u.shape != (n, 2 * w + 3) or top_f.shape != (n, 2 * w + 3) or \
            left_u.shape != (n, 2 * h + 3) or left_f.shape != (n, 2 * h + 3):
        raise ValueError(f"predict_block: {w}x{h} blocks take int32 (N, 2W+3) and "
                         f"(N, 2H+3) rows, got {[tuple(r.shape) for r in refs]}")
    out = torch.empty((n, len(modes), h, w), dtype=torch.int32, device=top_u.device)
    err = _lib("seq_intra").pmp_seq_intra(
        top_u.data_ptr(), left_u.data_ptr(), top_f.data_ptr(), left_f.data_ptr(),
        _device_modes(tuple(modes), top_u.device).data_ptr(),
        _device_tables(is_luma, top_u.device).data_ptr(), n, len(modes), w, h,
        int(is_luma), bit_depth, out.data_ptr(), _build.stream(top_u))
    _build.count_launch(predict_block, err)
    return out


predict_block.launches = 0


# ---------------------------------------------------------------------------
# Multi-reference-line and ISP prediction (host numpy; the candidates are few)
# ---------------------------------------------------------------------------

def substitute_line(vals, avail, bit_depth=10):
    """xFillReferenceSamples substitution over one scan-ordered line."""
    vals = np.asarray(vals, np.int64)
    avail = np.asarray(avail, bool)
    if not avail.any():
        return np.full_like(vals, 1 << (bit_depth - 1))
    idx = np.where(avail, np.arange(len(vals)), -1)
    idx = np.maximum.accumulate(idx)
    idx[idx < 0] = int(np.argmax(avail))
    return vals[idx]


def isp_split_dim(width: int, height: int, divide_rows: bool) -> int:
    """CU::getISPSplitDim (UnitTools.cpp:522-545): sub-partition height
    (divide_rows=True, HOR split) or width (VER split)."""
    split_size = height if divide_rows else width
    non_split = width if divide_rows else height
    min_samples = 16                       # 1 << (2*log2(MIN_TB_SIZEY))
    factor = (min_samples >> _flog2(non_split)) \
        if non_split < min_samples else 1
    return max(split_size >> 2, factor)


def can_use_isp(w: int, h: int, max_tb: int = 64) -> bool:
    """CU::canUseISP (UnitTools.cpp:489-498)."""
    return (_flog2(w) + _flog2(h) > 4) and w <= max_tb and h <= max_tb


def can_use_lfnst_with_isp(cu_w: int, cu_h: int, isp: int) -> bool:
    """CU::canUseLfnstWithISP (UnitTools.cpp:500-513); isp 1=HOR, 2=VER."""
    if isp == 0:
        return False
    if isp == 1:
        tw, th_ = cu_w, isp_split_dim(cu_w, cu_h, True)
    else:
        tw, th_ = isp_split_dim(cu_w, cu_h, False), cu_h
    return tw >= 4 and th_ >= 4


def predict_isp(top, left, *, cu_w, cu_h, pw, ph, mode, bit_depth=10):
    """ISP prediction-region prediction (numpy, per-region host loop).

    ``top``/``left``: 1-D int arrays, index 0 = corner sample, followed by
    the region's reference samples with >=2 replication slots appended by
    the caller (initIntraPatternChTypeISP layout).  Wide-angle remap uses
    the CU dims (initPredIntraParams blockSize=cuSize, :382); reference
    smoothing and Gaussian interpolation are off for ISP (:427); PDPC per
    the pred-region dims (:390).  Returns (ph, pw) int64.
    """
    pel_max = (1 << bit_depth) - 1
    top = np.asarray(top, np.int64)
    left = np.asarray(left, np.int64)
    pred_mode = wide_angle(cu_w, cu_h, mode)

    if mode == PLANAR_IDX:
        log2w, log2h = _flog2(pw), _flog2(ph)
        t = top[1:pw + 2]
        l = left[1:ph + 2]
        xs, ys = np.arange(pw), np.arange(ph)
        hor = (l[:ph, None] << log2w) + (xs[None, :] + 1) * (t[pw] - l[:ph, None])
        ver = (t[None, :pw] << log2h) + (ys[:, None] + 1) * (l[ph] - t[None, :pw])
        off = 1 << (log2w + log2h)
        pred = ((hor << log2h) + (ver << log2w) + off) >> (1 + log2w + log2h)
    elif mode == DC_IDX:
        denom = (pw << 1) if pw == ph else max(pw, ph)
        s = 0
        if pw >= ph:
            s += int(top[1:pw + 1].sum())
        if pw <= ph:
            s += int(left[1:ph + 1].sum())
        dc = (s + (denom >> 1)) >> _flog2(denom)
        pred = np.full((ph, pw), dc, np.int64)
    else:
        is_ver = pred_mode >= DIA_IDX
        ang_mode = (pred_mode - VER_IDX) if is_ver else -(pred_mode - HOR_IDX)
        abs_mode = abs(ang_mode)
        sign = -1 if ang_mode < 0 else 1
        angle = sign * int(ANG_TABLE[abs_mode])
        inv_angle = int(INV_ANG_TABLE[abs_mode])
        main = top if is_ver else left
        side = left if is_ver else top
        wp, hp = (pw, ph) if is_ver else (ph, pw)
        apply_pdpc = pw >= 4 and ph >= 4
        scale = 0
        if ang_mode < 0:
            apply_pdpc = False
        elif ang_mode > 0:
            side_sz = ph if is_ver else pw
            scale = min(2, _flog2(side_sz) - (_flog2(3 * inv_angle - 2) - 8))
            apply_pdpc = apply_pdpc and scale >= 0

        if angle < 0:
            size_side = hp
            neg_j = np.arange(1, size_side + 1)
            proj = np.minimum((neg_j * inv_angle + 256) >> 9, size_side)
            ref_main = np.concatenate([side[proj[::-1]], main])
            off = size_side
        else:
            ref_main = main
            off = 0
        L = len(ref_main)
        xs = np.arange(wp)
        if angle == 0:
            pred = np.broadcast_to(ref_main[off + 1:off + 1 + wp],
                                   (hp, wp)).astype(np.int64).copy()
            if apply_pdpc:
                sc = (_flog2(wp) + _flog2(hp) - 2) >> 2
                top_left = ref_main[off]
                l = side[1:hp + 1][:, None]
                wl = 32 >> np.minimum(31, (2 * xs) >> sc)
                adj = (wl[None, :] * (l - top_left) + 32) >> 6
                adj[:, min(3 << sc, wp):] = 0
                pred = np.clip(pred + adj, 0, pel_max)
        else:
            ys = np.arange(hp)
            delta_pos = angle * (1 + ys)
            delta_int = delta_pos >> 5
            delta_frac = delta_pos & 31
            if (abs(angle) & 31) == 0:
                idx = np.clip(off + delta_int[:, None] + xs[None, :] + 1,
                              0, L - 1)
                pred = ref_main[idx]
            else:
                fs = np.asarray(CHROMA_FILTER, np.int64)[delta_frac]
                base = off + delta_int[:, None] + xs[None, :]
                acc = np.zeros((hp, wp), np.int64)
                for k in range(4):
                    acc += fs[:, k:k + 1] * ref_main[np.clip(base + k,
                                                             0, L - 1)]
                pred = np.clip((acc + 32) >> 6, 0, pel_max)
            if apply_pdpc:
                inv_sum = 256 + (xs + 1) * inv_angle
                side_idx = np.clip(ys[:, None] + (inv_sum[None, :] >> 9) + 1,
                                   0, len(side) - 1)
                sval = side[side_idx]
                wl = (32 >> np.minimum(31, (2 * xs) >> scale))[None, :]
                adj = (wl * (sval - pred) + 32) >> 6
                adj[:, min(3 << scale, wp):] = 0
                pred = pred + adj
        if not is_ver:
            pred = pred.T

    if mode in (PLANAR_IDX, DC_IDX) and pw >= 4 and ph >= 4:
        sc = (_flog2(pw) - 2 + _flog2(ph) - 2 + 2) >> 2
        xs, ys = np.arange(pw), np.arange(ph)
        wt = 32 >> np.minimum(31, (ys[:, None] << 1) >> sc)
        wl = 32 >> np.minimum(31, (xs[None, :] << 1) >> sc)
        t = top[1:pw + 1][None, :]
        l = left[1:ph + 1][:, None]
        pred = pred + ((wl * (l - pred) + wt * (t - pred) + 32) >> 6)
    return pred


def predict_mrl(top, left, *, w, h, mode, mri, bit_depth=10):
    """Angular prediction from reference line ``mri`` (1 or 2).

    ``top``/``left``: substituted reference lines of line mri, index 0 =
    the corner sample (x0-1-mri, y0-1-mri); lengths >= 2w+1+mri /
    2h+1+mri.  Contract: xPredIntraAng (:476-660) with refMain/refSide
    += multiRefIdx and deltaPos starting at intraPredAngle*(1+mri); PDPC
    and reference smoothing are off for mri != 0 (initPredIntraParams
    :388-431).  Modes: DC or angular (MRL implies an MPM mode, which
    excludes planar but NOT DC — xGetPredValDc :152-181 sums line
    ``mri`` at offset mri+1, i.e. the samples aligned with the block).
    """
    pel_max = (1 << bit_depth) - 1
    if mode == DC_IDX:
        t = np.asarray(top, np.int64)
        l = np.asarray(left, np.int64)
        s = 0
        if w >= h:
            s += int(t[mri + 1: mri + 1 + w].sum())
        if w <= h:
            s += int(l[mri + 1: mri + 1 + h].sum())
        denom = (w << 1) if w == h else max(w, h)
        dc = (s + (denom >> 1)) >> _flog2(denom)
        return np.full((h, w), dc, np.int64)
    p = mode_params(w, h, mode, is_luma=True, mrl=mri)
    main = np.asarray(top if p.is_ver else left, np.int64)
    side = np.asarray(left if p.is_ver else top, np.int64)
    wp, hp = (w, h) if p.is_ver else (h, w)
    angle, inv_angle = p.angle, p.inv_angle

    if angle < 0:
        size_side = hp
        neg_j = np.arange(1, size_side + 1)
        proj = np.minimum((neg_j * inv_angle + 256) >> 9, size_side)
        ref_main = np.concatenate([side[proj[::-1]], main])
        off = size_side + mri
        last = off - mri + 2 * wp + mri      # refLength + mri in concat space
    else:
        ref_main = main
        off = mri
        last = 2 * wp + mri
    # beyond ``last`` VTM replicates ref_main[last] (xPredIntraAng
    # :530-536); clamp indices there, never into provided tail storage
    L = last + 1
    xs = np.arange(wp)

    if angle == 0:
        pred = np.broadcast_to(ref_main[off + 1: off + 1 + wp],
                               (hp, wp)).copy()
    else:
        ys = np.arange(hp)
        delta_pos = angle * (1 + mri + ys)
        delta_int = delta_pos >> 5
        delta_frac = delta_pos & 31
        if (abs(angle) & 31) == 0:
            idx = np.clip(off + delta_int[:, None] + xs[None, :] + 1,
                          0, L - 1)
            pred = ref_main[idx]
        else:
            fs = np.asarray(CHROMA_FILTER, np.int64)[delta_frac]  # (hp, 4)
            base = off + delta_int[:, None] + xs[None, :]
            acc = np.zeros((hp, wp), np.int64)
            for k in range(4):
                acc += fs[:, k:k + 1] * ref_main[np.clip(base + k, 0, L - 1)]
            pred = np.clip((acc + 32) >> 6, 0, pel_max)
    return pred if p.is_ver else pred.T
