"""Size-generic VVC intra prediction — CU size and mode as data — and the
wave path's reference-gather (K1) and intra RMD / DM (K2) kernels.

The JAX package's ``ops/intra_generic.py`` predicts (CU, mode) pairs on a
square padded tile with the CU width/height and mode as per-CU tensors:
per-(size, mode) parameters of initPredIntraParams (IntraPrediction.cpp
:371-443) are gathered from (6, 6, 67) tables, horizontal modes are
computed in transposed space, and reference lines are padded to 2*pad+3
with the last real sample replicated. Here the same functions are plain
PyTorch, and two hand-written CUDA kernels do the wave step's work on the
card:

- **K1** ``ref_gather`` (``csrc/ref_gather.cu``): for a schedule row of B
  CUs, the top/left reference rows with coding-order availability,
  substitution and the MDIS [1 2 1] filter (``wavefront.py:_refs_generic``);
  one warp per (CU, plane), every load issued before any is used, the
  substitution JAX's ``cummax`` form as a ballot a round of 32 entries.
- **K2** ``intra_rmd`` (``csrc/intra_rmd.cu``): luma RMD — SATD over planar,
  DC and the 33 even angulars, then the +-1 refinement — and the chosen
  mode's prediction (``wavefront.py:_make_class_apply`` 373-401); for
  chroma, the DM prediction of the mode read from the luma mode grid.

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises); ``<wrapper>.launches`` counts kernel
launches. Schedule rows are as in ``ops/rows.py``. Outputs are zero
outside each CU's (h, w) region and for padding rows (live == 0); nothing
reads them there.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .intra import CHROMA_FILTER, fill_reference_samples, mode_params
from .rows import check_rows, unpack_rows
from .tq_generic import satd_generic

NUM_LUMA_MODE = 67
_SIZES = (2, 4, 8, 16, 32, 64)
_TABLE_KEYS = ("angle", "inv_angle", "is_ver", "use_filt", "gauss", "pdpc",
               "scale")
# RMD mode subsampling (IntraSearch.cpp:370 does the same): SATD over
# planar/DC + the 33 even angulars, then the best angular's odd neighbours.
RMD_MODES = np.array([0, 1] + list(range(2, 67, 2)), np.int32)


def _li(v):
    """log2(size)-1 index into the (6,6,...) tables for v in 2..64."""
    return ((v > 2).int() + (v > 4).int() + (v > 8).int()
            + (v > 16).int() + (v > 32).int())


def _rshift_const(c: int, s):
    """``c >> s`` for a constant ``c`` and a tensor of shift amounts."""
    return torch.full_like(s, c) >> s


@functools.cache
def param_tables(is_luma: bool):
    """(6*6*67,) numpy tables of ModeParams fields, flat-indexed by
    (log2w-1)*6*67 + (log2h-1)*67 + mode."""
    n = 6 * 6 * 67
    t = {k: np.zeros(n, np.int32) for k in _TABLE_KEYS}
    for iw, w in enumerate(_SIZES):
        for ih, h in enumerate(_SIZES):
            for m in range(NUM_LUMA_MODE):
                p = mode_params(w, h, m, is_luma=is_luma)
                f = (iw * 6 + ih) * 67 + m
                t["angle"][f] = p.angle
                t["inv_angle"][f] = p.inv_angle
                t["is_ver"][f] = int(p.is_ver)
                t["use_filt"][f] = int(p.use_filtered)
                t["gauss"][f] = int(p.interpolate_gauss)
                t["pdpc"][f] = int(p.apply_pdpc)
                t["scale"][f] = max(p.pdpc_scale, 0)
    return t


@functools.cache
def _device_tables(is_luma: bool, device: torch.device) -> torch.Tensor:
    """The parameter tables as one (7, 2412) int32 tensor on ``device``."""
    t = param_tables(is_luma)
    return torch.from_numpy(np.stack([t[k] for k in _TABLE_KEYS])).to(device)


def filter_reference_samples_generic(top, left, w, h):
    """[1 2 1]/4 smoothing with per-CU real lengths (2w / 2h as data).

    top/left: (B, 2*pad+3), index 0 = corner.  Samples at index >= 2w
    (2h) are copied unfiltered (VTM leaves the last real sample
    unfiltered; the padded tail replicates it, so copying preserves the
    replication semantics)."""
    corner = (top[:, 0] + top[:, 1] + left[:, 0] + left[:, 1] + 2) >> 2

    def one(row, n_real):
        mid = (row[:, :-2] + 2 * row[:, 1:-1] + row[:, 2:] + 2) >> 2
        out = torch.cat([corner[:, None], mid], 1)
        idx = torch.arange(row.shape[1] - 1, device=row.device)[None, :]
        out = torch.where(idx >= n_real[:, None], row[:, :-1], out)
        return torch.cat([out, row[:, -1:]], 1)

    return one(top, 2 * w), one(left, 2 * h)


def _planar_dc(top_u, left_u, top_f, left_f, w, h, pad, tabs):
    """Planar and DC prediction, size as data.  Returns two (B, P, P)."""
    P = pad
    dev = top_u.device
    iw, ih = _li(w), _li(h)
    lw, lh = iw + 1, ih + 1
    base = (iw * 6 + ih) * 67
    use_f = tabs["use_filt"][base] > 0
    pdpc_ok = tabs["pdpc"][base] > 0

    tp = torch.where(use_f[:, None], top_f, top_u)
    lp = torch.where(use_f[:, None], left_f, left_u)
    t = tp[:, 1:P + 2]
    l = lp[:, 1:P + 2]
    top_right = torch.gather(t, 1, w[:, None].long())               # (B,1)
    bottom_left = torch.gather(l, 1, h[:, None].long())
    xs = torch.arange(P, device=dev, dtype=torch.int32)
    ys = xs
    lw3, lh3 = lw[:, None, None], lh[:, None, None]
    hor = (l[:, :P, None] << lw3) + \
        (xs[None, None, :] + 1) * (top_right[:, :, None] - l[:, :P, None])
    ver = (t[:, None, :P] << lh3) + \
        (ys[None, :, None] + 1) * (bottom_left[:, :, None] - t[:, None, :P])
    offset = (torch.ones_like(lw) << (lw + lh))[:, None, None]
    planar = ((hor << lh3) + (ver << lw3) + offset) >> (1 + lw3 + lh3)

    # DC on unfiltered refs
    tu = top_u[:, 1:P + 1]
    lu = left_u[:, 1:P + 1]
    sum_t = torch.where(xs[None, :] < w[:, None], tu, 0).sum(1, dtype=torch.int32)
    sum_l = torch.where(ys[None, :] < h[:, None], lu, 0).sum(1, dtype=torch.int32)
    s = torch.where(w >= h, sum_t, 0) + torch.where(w <= h, sum_l, 0)
    denom = torch.where(w == h, w << 1, torch.maximum(w, h))
    ld = _li(denom) + 1 + (denom > 64).int()   # denom can reach 128
    dc_v = (s + (denom >> 1)) >> ld
    dc = dc_v[:, None, None].expand_as(planar)

    # PDPC for planar/DC (predIntraAng :248-271), per-CU scale
    scale = (((lw - 2) + (lh - 2) + 2) >> 2)[:, None, None]
    wT = _rshift_const(32, torch.clamp((ys[None, :, None] * 2) >> scale, max=31))
    wL = _rshift_const(32, torch.clamp((xs[None, None, :] * 2) >> scale, max=31))

    def _pdpc(pred, t_sel, l_sel):
        tt = t_sel[:, 1:P + 1][:, None, :]
        ll = l_sel[:, 1:P + 1][:, :, None]
        adj = (wL * (ll - pred) + wT * (tt - pred) + 32) >> 6
        return torch.where(pdpc_ok[:, None, None], pred + adj, pred)

    return _pdpc(planar, tp, lp), _pdpc(dc, top_u, left_u)


def predict_generic(top_u, left_u, top_f, left_f, modes, w, h, *,
                    pad: int, is_luma: bool = True, bit_depth: int = 10):
    """Predict (B, M) (CU, mode) pairs on a (pad, pad) tile.

    top_u/left_u/top_f/left_f: (B, 2*pad+3) int32 reference rows, index
    0 = the corner, built with availability masks zeroed beyond the
    actual 2w / 2h so the tail replicates the last real sample.
    modes: (B, M) int32 in 0..66; w, h: (B,) int32 powers of two <= pad.
    Returns (B, M, pad, pad) int32; only [:h, :w] is meaningful.

    Each angular sample is read directly from the extended reference
    ``ref`` (the side projection for indices below the corner, then the
    main row) at ``off + delta_int + x + k`` for the 4 taps, clamped to the
    replicated tail; the JAX version's correlate-then-window form gives the
    same numbers.
    """
    P = pad
    B, M = modes.shape
    dev = modes.device
    pel_max = (1 << bit_depth) - 1
    tabs = {k: v for k, v in zip(_TABLE_KEYS, _device_tables(is_luma, dev))}
    modes = modes.clamp(0, 66)
    iw, ih = _li(w), _li(h)
    flat = ((iw * 6 + ih)[:, None]) * 67 + modes                  # (B,M)
    angle, inv_angle, is_ver, use_filt, gauss, pdpc, scale = (
        tabs[k][flat] for k in _TABLE_KEYS)
    is_ver, use_filt, gauss, pdpc = (t > 0 for t in (is_ver, use_filt, gauss, pdpc))

    # orientation-resolved references: main = top for vertical modes
    ver3, filt3 = is_ver[:, :, None], use_filt[:, :, None]
    top = torch.where(filt3, top_f[:, None], top_u[:, None])      # (B,M,L)
    left = torch.where(filt3, left_f[:, None], left_u[:, None])
    main = torch.where(ver3, top, left)
    side = torch.where(ver3, left, top)
    L = main.shape[2]
    wp = torch.where(is_ver, w[:, None], h[:, None])              # (B,M)
    hp = torch.where(is_ver, h[:, None], w[:, None])
    lwp = torch.where(is_ver, iw[:, None], ih[:, None]) + 1
    lhp = torch.where(is_ver, ih[:, None], iw[:, None]) + 1

    # negative-angle extension: ref[off - j] = side[min((j*invAngle+256)>>9, hp)]
    ps = torch.arange(P, device=dev, dtype=torch.int32)
    j = (P - ps)[None, None, :]
    proj = torch.minimum((j * inv_angle[:, :, None] + 256) >> 9, hp[:, :, None])
    neg = torch.gather(side, 2, proj.clamp(0, L - 1).long())
    ref = torch.cat([neg, main], 2)                               # (B,M,P+L)
    ltot = P + L
    off = P

    ys = xs = ps
    delta_pos = angle[:, :, None] * (1 + ys)[None, None, :]       # (B,M,P)
    delta_int = delta_pos >> 5
    delta_frac = delta_pos & 31
    if is_luma:
        half = delta_frac >> 1
        g = torch.stack([16 - half, 32 - half, 16 + half, half], -1)
        c = torch.from_numpy(CHROMA_FILTER).to(dev)[delta_frac.long()]
        fs = torch.where(gauss[:, :, None, None], g, c)           # (B,M,P,4)
    else:
        zf = torch.zeros_like(delta_frac)
        fs = torch.stack([zf, 64 - 2 * delta_frac, 2 * delta_frac, zf], -1)

    acc = torch.zeros((B, M, P, P), dtype=torch.int32, device=dev)
    for k in range(4):
        idx = (off + delta_int[..., None] + xs + k).clamp(max=ltot - 1)
        taps = torch.gather(ref, 2, idx.reshape(B, M, P * P).long())
        acc += fs[..., k, None] * taps.reshape(B, M, P, P)
    pred = ((acc + 32) >> 6).clamp(0, pel_max)

    # ---- PDPC, angular ----
    zero = angle == 0
    # variant A (angle > 0): side-projected samples.  PDPC reaches at
    # most 3 << scale <= 12 columns, so only the first 16 are computed.
    PD = min(16, P)
    xsd = torch.arange(PD, device=dev, dtype=torch.int32)
    inv_sum = 256 + (xsd[None, None, :] + 1) * inv_angle[:, :, None]
    side_idx = (ys[None, None, :, None] + (inv_sum >> 9)[:, :, None, :] + 1
                ).clamp(0, L - 1)
    sv = torch.gather(side, 2, side_idx.reshape(B, M, P * PD).long()
                      ).reshape(B, M, P, PD)
    w_l = _rshift_const(32, torch.clamp((2 * xsd[None, None, :]) >> scale[:, :, None],
                                        max=31))
    adj_pos = (w_l[:, :, None, :] * (sv - pred[..., :PD]) + 32) >> 6
    lim = torch.minimum(3 << scale, wp)
    adj_pos = torch.where(xsd[None, None, None, :] < lim[:, :, None, None],
                          adj_pos, 0)
    if PD < P:
        adj_pos = torch.nn.functional.pad(adj_pos, (0, P - PD))
    pred_pos = pred + adj_pos
    # variant B (angle == 0): pure hor/ver top-left form
    scale0 = (lwp + lhp - 2) >> 2
    top_left = ref[:, :, off][:, :, None, None]
    lvals = side[:, :, 1:P + 1][:, :, :, None]
    wl0 = _rshift_const(32, torch.clamp((2 * xs[None, None, :]) >> scale0[:, :, None],
                                        max=31))
    adj0 = (wl0[:, :, None, :] * (lvals - top_left) + 32) >> 6
    lim0 = torch.minimum(3 << scale0, wp)
    adj0 = torch.where(xs[None, None, None, :] < lim0[:, :, None, None], adj0, 0)
    pred_zero = (pred + adj0).clamp(0, pel_max)
    pred = torch.where((pdpc & zero)[:, :, None, None], pred_zero,
                       torch.where(pdpc[:, :, None, None], pred_pos, pred))

    # horizontal modes were computed in transposed space
    pred = torch.where(is_ver[:, :, None, None], pred, pred.transpose(-1, -2))

    planar, dc = _planar_dc(top_u, left_u, top_f, left_f, w, h, P, tabs)
    msel = modes[:, :, None, None]
    return torch.where(msel == 0, planar[:, None],
                       torch.where(msel == 1, dc[:, None], pred))


# ---------------------------------------------------------------------------
# K1: reference gather (wavefront.py:_refs_generic)
# ---------------------------------------------------------------------------

def gather_plane(plane, fi, rows, cols):
    """plane[fi, rows, cols] with rows/cols clamped into the plane."""
    return plane[fi.long(), rows.clamp(0, plane.shape[1] - 1).long(),
                 cols.clamp(0, plane.shape[2] - 1).long()]


def avail_from_order(og, fi, oi, px, py, ok):
    """Availability of reference samples at map-grid positions: a sample
    is available iff its covering leaf precedes leaf ``oi`` in coding
    order (og: (F, H/4, W/4) coding-order grid, -1 = uncoded)."""
    ids = gather_plane(og, fi, py, px)
    return ok & (ids >= 0) & (ids < oi)


def _refs_one(plane, og4, rows, P, scale, bd):
    fi, xs, ys, ws, hs, oi, ok = unpack_rows(rows, scale)
    H, W = plane.shape[1], plane.shape[2]
    j2 = torch.arange(2 * P, device=plane.device, dtype=torch.int32)[None, :]
    fi2, oi2 = fi[:, None], oi[:, None]
    # top row y-1, x..x+2P-1
    t_ok = ((xs[:, None] + j2) < W) & (ys[:, None] > 0) & (j2 < 2 * ws[:, None])
    at = avail_from_order(og4, fi2, oi2, (xs[:, None] + j2) * scale // 4,
                          torch.clamp(ys[:, None] - 1, min=0) * scale // 4, t_ok)
    top_raw = gather_plane(plane, fi2, ys[:, None] - 1, xs[:, None] + j2)
    # left col x-1, y..y+2P-1
    l_ok = ((ys[:, None] + j2) < H) & (xs[:, None] > 0) & (j2 < 2 * hs[:, None])
    al = avail_from_order(og4, fi2, oi2,
                          torch.clamp(xs[:, None] - 1, min=0) * scale // 4,
                          (ys[:, None] + j2) * scale // 4, l_ok)
    left_raw = gather_plane(plane, fi2, ys[:, None] + j2, xs[:, None] - 1)
    c_ok = (xs > 0) & (ys > 0)
    ac = avail_from_order(og4, fi, oi, torch.clamp(xs - 1, min=0) * scale // 4,
                          torch.clamp(ys - 1, min=0) * scale // 4, c_ok)
    corner = gather_plane(plane, fi, ys - 1, xs - 1)
    tu, lu = fill_reference_samples(top_raw, left_raw, at, al, ac, corner,
                                    bit_depth=bd)
    tf, lf = filter_reference_samples_generic(tu, lu, ws, hs)
    out = torch.stack([tu, lu, tf, lf])
    return torch.where(ok[None, :, None], out, 0)


def ref_gather_reference(planes, og4, rows, pad, scale, bit_depth):
    """Plain version of K1.  ``planes``: one or two (F, H, W) int32 sample
    planes; og4: (F, H_luma/4, W_luma/4) int32 coding-order grid; rows:
    (B, 8) int32.  Returns (len(planes), 4, B, 2*pad+3) int32 holding
    (top, left, top filtered, left filtered); padding rows are zero."""
    return torch.stack([_refs_one(p, og4, rows, pad, scale, bit_depth)
                        for p in planes])


SIGNATURES = {
    "ref_gather": {"pmp_ref_gather": (_build.PTR,) * 4 + (_build.INT,) * 9 + (_build.PTR,) * 2},
    "intra_rmd": {"pmp_intra_rmd": (_build.PTR,) * 5 + (_build.INT,) * 9 + (_build.PTR,) * 3},
}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def ref_gather(planes, og4, rows, pad, scale, bit_depth):
    """K1: reference rows of B CUs for one or two planes.  See
    ``ref_gather_reference``; CPU tensors take it, CUDA tensors launch
    ``csrc/ref_gather.cu``."""
    check_rows(rows)
    if len(planes) not in (1, 2):
        raise ValueError("ref_gather takes one or two planes")
    if rows.device.type == "cpu":
        return ref_gather_reference(planes, og4, rows, pad, scale, bit_depth)
    _build.check_cuda("ref_gather", *planes, og4, rows)
    for t in (*planes, og4):
        if t.dtype != torch.int32:
            raise TypeError(f"ref_gather takes int32 planes and grid, got {t.dtype}")
    B = rows.shape[0]
    _, H, W = planes[0].shape
    out = torch.empty((len(planes), 4, B, 2 * pad + 3), dtype=torch.int32,
                      device=rows.device)
    p1 = planes[1].data_ptr() if len(planes) == 2 else None
    err = _lib("ref_gather").pmp_ref_gather(
        planes[0].data_ptr(), p1, og4.data_ptr(), rows.data_ptr(), B, pad, scale, bit_depth,
        H, W, og4.shape[1], og4.shape[2], len(planes), out.data_ptr(), _build.stream(rows))
    _build.count_launch(ref_gather, err)
    return out


ref_gather.launches = 0


# ---------------------------------------------------------------------------
# K2: luma RMD / chroma DM prediction (wavefront.py:_make_class_apply)
# ---------------------------------------------------------------------------

def _inside(ws, hs, P):
    i = torch.arange(P, device=ws.device)
    return (i[None, :, None] < hs[:, None, None]) & (i[None, None, :] < ws[:, None, None])


def dm_modes(mg, rows):
    """The chroma DM mode of each row: the luma mode grid at the CU centre
    (PU::getCoLocatedIntraLumaMode), luma-unit coordinates."""
    fi, xs, ys, ws, hs = (rows[:, k] for k in range(5))
    return gather_plane(mg, fi, (ys + hs // 2) // 4, (xs + ws // 2) // 4).int()


def intra_rmd_reference(refs, org, mg, rows, pad, is_luma, bit_depth):
    """Plain version of K2.

    Luma (``is_luma``): refs (1, 4, B, 2P+3) from K1 and ``org`` the
    (F, H, W) int32 original luma plane; RMD by SATD over ``RMD_MODES``
    (first index wins a tie), then ``clip(m +- 1, 2, 66)`` refinement with
    candidate order [best, m-1, m+1].  Returns modes (B,) int32 and the
    chosen prediction (1, B, P, P).

    Chroma: refs (n, 4, B, 2P+3) for U (and V); the DM mode is read from
    the uint8 luma mode grid ``mg`` at the CU centre; returns the modes and
    the predictions (n, B, P, P).  ``org`` is unused.
    """
    P = pad
    scale = 1 if is_luma else 2
    fi, xs, ys, ws, hs, _, ok = unpack_rows(rows, scale)
    inside = _inside(ws, hs, P) & ok[:, None, None]
    if not is_luma:
        modes = torch.where(ok, dm_modes(mg, rows), 0)
        preds = torch.stack([predict_generic(*r, modes[:, None], ws, hs, pad=P,
                                             is_luma=False, bit_depth=bit_depth)[:, 0]
                             for r in refs])
        return modes, torch.where(inside[None], preds, 0)
    r = refs[0]
    d = torch.arange(P, device=rows.device, dtype=torch.int32)
    orgs = gather_plane(org, fi[:, None, None], ys[:, None, None] + d[None, :, None],
                        xs[:, None, None] + d[None, None, :])
    rmd = torch.from_numpy(RMD_MODES).to(rows.device)
    modes_rmd = rmd[None].expand(rows.shape[0], -1)
    preds = predict_generic(*r, modes_rmd, ws, hs, pad=P, is_luma=True,
                            bit_depth=bit_depth)
    costs = satd_generic(orgs[:, None], preds, ws, hs)
    bi = costs.argmin(1)
    m_a = rmd[bi]
    ang = m_a >= 2
    modes_ref = torch.stack([torch.where(ang, (m_a - 1).clamp(2, 66), m_a),
                             torch.where(ang, (m_a + 1).clamp(2, 66), m_a)], 1)
    preds_r = predict_generic(*r, modes_ref, ws, hs, pad=P, is_luma=True,
                              bit_depth=bit_depth)
    costs_r = satd_generic(orgs[:, None], preds_r, ws, hs)
    cand_c = torch.cat([costs.gather(1, bi[:, None]), costs_r], 1)
    cand_m = torch.cat([m_a[:, None], modes_ref], 1)
    k = cand_c.argmin(1)
    best = cand_m.gather(1, k[:, None])[:, 0]
    pred = predict_generic(*r, best[:, None], ws, hs, pad=P, is_luma=True,
                           bit_depth=bit_depth)[:, 0]
    best = torch.where(ok, best, 0)
    return best, torch.where(inside, pred, 0)[None]


def intra_rmd(refs, org, mg, rows, pad, is_luma, bit_depth):
    """K2: luma RMD + prediction, or chroma DM prediction.  See
    ``intra_rmd_reference``; CPU tensors take it, CUDA tensors launch
    ``csrc/intra_rmd.cu``."""
    check_rows(rows)
    if rows.device.type == "cpu":
        return intra_rmd_reference(refs, org, mg, rows, pad, is_luma, bit_depth)
    _build.check_cuda("intra_rmd", refs, org if is_luma else None, mg, rows)
    if refs.dtype != torch.int32 or mg.dtype != torch.uint8:
        raise TypeError("intra_rmd takes int32 refs and a uint8 mode grid")
    if is_luma and (org.dtype != torch.int32 or refs.shape[0] != 1):
        raise ValueError("intra_rmd (luma) takes one plane of refs and an int32 original")
    n, _, B, L = refs.shape
    if L != 2 * pad + 3:
        raise ValueError(f"refs of length {L} do not fit pad {pad}")
    _, GH, GW = mg.shape
    H, W = (org.shape[1], org.shape[2]) if is_luma else (0, 0)
    modes = torch.empty(B, dtype=torch.int32, device=rows.device)
    pred = torch.empty((n, B, pad, pad), dtype=torch.int32, device=rows.device)
    tabs = _device_tables(bool(is_luma), rows.device)
    err = _lib("intra_rmd").pmp_intra_rmd(
        refs.data_ptr(), org.data_ptr() if is_luma else None, mg.data_ptr(),
        rows.data_ptr(), tabs.data_ptr(), B, pad, n, int(is_luma), bit_depth, H, W, GH, GW,
        modes.data_ptr(), pred.data_ptr(), _build.stream(rows))
    _build.count_launch(intra_rmd, err)
    return modes, pred


intra_rmd.launches = 0
