"""Size-generic MIP — CU size as data — and the wave path's MIP kernel (K3).

Plain PyTorch version of the JAX package's ``ops/mip_generic.py``: the
three MIP size classes (MatrixIntraPrediction.cpp, getMipSizeId
UnitTools.cpp:3938) on padded tiles, with the per-CU width/height as
tensors:

- the matrices padded into one (3, 16, 64, 8) table; the sizeId-2
  "weight--" quirk (7 weights applied to vec[1:]) is absorbed by placing
  its matrix at input columns 1..7 with column 0 zero;
- Haar boundary downsampling through a group-membership one-hot;
- the reduced prediction as a product with the padded table;
- linear upsampling with per-CU factors as data (factor 1 is the
  identity under the same formula).

The wave step's MIP decision (``wavefront.py:_make_class_apply`` 402-425):
all 2 x 16 (transpose, mode) candidates are scored by SATD against the
original, modes ``m >= n_modes`` are out, the first minimum wins, and the
MIP winner replaces the angular RMD winner only when its SATD is strictly
lower. A MIP CU's mode grid shows PLANAR (0) and its MIP code is
``1 + t * 16 + m`` (0 for an angular CU).

**K3** ``mip_select`` (``csrc/mip_rmd.cu``) makes that decision on the
card after K2; ``mip_select_reference`` is its plain version. Every SATD
here is an integer below 2^24 (a 64x64 CU's Hadamard sum stays under
2^23 for 10-bit samples), so the JAX package's float32 sums and
comparisons are exact and the integer ones here give the same decisions.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .intra_generic import gather_plane
from .mip import MIP_OFFSET, MIP_SHIFT, _matrices
from .rows import check_rows, unpack_rows
from .tq_generic import satd_generic

MAX_MODES = 16
_NO_COST = 1 << 30          # SATD of an invalid mode (above any real one)


@functools.cache
def _mip_table():
    m4, m8, m16 = _matrices()
    t = np.zeros((3, MAX_MODES, 64, 8), np.int32)
    t[0, :16, :16, :4] = m4
    t[1, :8, :16, :8] = m8
    t[2, :6, :64, 1:8] = m16          # 7-weight rows act on vec[1:]
    return t


@functools.cache
def _device_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mip_table()).to(device)


def _log2d(v):
    """log2 for power-of-two data in 1..64."""
    return ((v > 1).int() + (v > 2).int() + (v > 4).int() + (v > 8).int()
            + (v > 16).int() + (v > 32).int())


def sid_generic(w, h):
    return torch.where((w == 4) & (h == 4), 0,
                       torch.where((w == 4) | (h == 4) | ((w == 8) & (h == 8)), 1, 2))


def predict_mip_generic(top_u, left_u, w, h, *, pad: int, bit_depth: int = 10):
    """All MIP candidates for B blocks on a (pad, pad) tile.

    top_u/left_u: (B, 2*pad+3) substituted UNFILTERED reference rows,
    index 0 = corner; w/h: (B,) CU sizes (4..pad). Returns (preds,
    n_modes): preds (B, 2*MAX_MODES, pad, pad) int32 where index
    t*MAX_MODES + m = mode m, transpose t (only m < n_modes[b] and the
    [:h, :w] region are meaningful); n_modes (B,) the valid mode count."""
    P = pad
    B = w.shape[0]
    dev = w.device
    w, h = w.long(), h.long()
    sid = sid_generic(w, h)
    red_b = torch.where(sid == 0, 2, 4)
    red_p = torch.where(sid < 2, 4, 8)
    n_modes = torch.tensor([16, 8, 6], device=dev)[sid]
    maxv = (1 << bit_depth) - 1
    top_full = top_u[:, 1:1 + P].long()
    left_full = left_u[:, 1:1 + P].long()
    i = torch.arange(P, device=dev)
    j4 = torch.arange(4, device=dev)

    def down(vec, n):
        f = n // red_b
        grp = (i[None, :] * red_b[:, None]) // n[:, None]
        sel = (grp[:, :, None] == j4[None, None, :]) & (i[None, :, None] < n[:, None, None])
        s = (vec[:, :, None] * sel).sum(1)
        return (s + (f[:, None] >> 1)) >> _log2d(f)[:, None]

    rt = down(top_full, w)
    rl = down(left_full, h)

    k8 = torch.arange(8, device=dev)
    from_first = k8[None, :] < red_b[:, None]
    idx_a = k8.clamp(0, 3)[None, :].expand(B, 8)
    idx_b = (k8[None, :] - red_b[:, None]).clamp(0, 3)

    def pack(a, b):
        return torch.where(from_first, a.gather(1, idx_a), b.gather(1, idx_b))

    valid_k = k8[None, :] < 2 * red_b[:, None]
    mats = _device_table(dev)[sid].long()                 # (B, 16, 64, 8)

    def reduced(bd):
        off = bd[:, 0]
        first = torch.where(sid < 2, (1 << (bit_depth - 1)) - off, 0)
        vec = torch.where(valid_k, bd - off[:, None], 0)
        vec = torch.cat([first[:, None], vec[:, 1:]], 1)
        add = (1 << (MIP_SHIFT - 1)) - MIP_OFFSET * vec.sum(1)
        res = ((mats * vec[:, None, None, :]).sum(-1) + add[:, None, None]) >> MIP_SHIFT
        return (res + off[:, None, None]).clamp(0, maxv)

    rn = reduced(pack(rt, rl))                  # (B, 16, 64)
    rtr = reduced(pack(rl, rt))

    # 64-vector -> (8, 8) grid with per-CU red_p stride
    r8 = k8
    gidx = (r8[:, None] * red_p[:, None, None] + r8[None, :]).clamp(0, 63).reshape(B, 1, 64)
    grid_n = rn.gather(2, gidx.expand_as(rn)).reshape(B, -1, 8, 8)
    grid_t = rtr.gather(2, gidx.expand_as(rtr)).reshape(B, -1, 8, 8)
    cand = torch.cat([grid_n, grid_t.transpose(-1, -2)], 1)   # (B, 2*MAX, 8, 8)
    M2 = cand.shape[1]

    f_h = w // red_p
    f_v = h // red_p
    lf_h, lf_v = _log2d(f_h), _log2d(f_v)

    # left boundary sample of each reduced row: left_full[(r+1)*f_v - 1]
    lidx = ((r8[None, :] + 1) * f_v[:, None] - 1).clamp(0, P - 1)
    lsel = left_full.gather(1, lidx)                          # (B, 8)

    # horizontal pass: (B, M2, 8, 8) -> (B, M2, 8, P); columns >= w read a
    # clamped index (JAX fills them): they lie outside the CU
    x = torch.arange(P, device=dev)
    jh = (x[None, :] * red_p[:, None]) // w[:, None]           # (B, P)
    ph = x[None, :] - jh * f_h[:, None] + 1
    jh_b = jh[:, None, None, :].expand(B, M2, 8, P)
    redv = cand.gather(3, jh_b.clamp(max=7))
    prevv = cand.gather(3, (jh_b - 1).clamp(0, 7))
    prevv = torch.where(jh_b == 0, lsel[:, None, :, None].expand_as(prevv), prevv)
    num = (f_h[:, None] - ph)[:, None, None, :] * prevv \
        + ph[:, None, None, :] * redv + (f_h >> 1)[:, None, None, None]
    out_h = num >> lf_h[:, None, None, None]

    # vertical pass: rows 8 -> P against the full top boundary
    jv = (x[None, :] * red_p[:, None]) // h[:, None]           # (B, P)
    pv = x[None, :] - jv * f_v[:, None] + 1
    jv_b = jv[:, None, :, None].expand(B, M2, P, P)
    redv2 = out_h.gather(2, jv_b.clamp(max=7))
    prev2 = out_h.gather(2, (jv_b - 1).clamp(0, 7))
    prev2 = torch.where(jv_b == 0, top_full[:, None, None, :].expand_as(prev2), prev2)
    num2 = (f_v[:, None] - pv)[:, None, :, None] * prev2 \
        + pv[:, None, :, None] * redv2 + (f_v >> 1)[:, None, None, None]
    preds = num2 >> lf_v[:, None, None, None]
    return preds.int(), n_modes.int()


# ---------------------------------------------------------------------------
# K3: MIP candidates against the angular RMD winner
# ---------------------------------------------------------------------------

def mip_costs(refs, org, rows, pred, pad, bit_depth):
    """The decision's inputs: (MIP predictions (B, 32, P, P), their SATDs
    (B, 32) with invalid modes at ``_NO_COST``, the angular winner's SATD
    (B,)). Padding rows are scored as 4x4 CUs."""
    fi, xs, ys, ws, hs, _, ok = unpack_rows(rows, 1)
    w, h = torch.where(ok, ws, 4), torch.where(ok, hs, 4)
    preds, n_modes = predict_mip_generic(refs[0, 0], refs[0, 1], w, h, pad=pad,
                                         bit_depth=bit_depth)
    d = torch.arange(pad, device=rows.device, dtype=torch.int32)
    orgs = gather_plane(org, fi[:, None, None], ys[:, None, None] + d[None, :, None],
                        xs[:, None, None] + d[None, None, :])
    costs = satd_generic(orgs[:, None], preds, w, h)
    cost_ang = satd_generic(orgs[:, None], pred[0][:, None], w, h)[:, 0]
    m = torch.arange(2 * MAX_MODES, device=rows.device)
    costs = torch.where((m[None, :] % MAX_MODES) < n_modes[:, None], costs, _NO_COST)
    return preds, costs, cost_ang


def mip_select_reference(refs, org, rows, pred, best, pad, bit_depth):
    """Plain version of K3.

    refs: (1, 4, B, 2P+3) int32 from K1 (unfiltered top/left used); org
    the (F, H, W) int32 original luma; pred (1, B, P, P) and best (B,) the
    angular winner from K2. Returns (best, pred, mip_code): a MIP CU gets
    mode 0, the MIP winner's prediction and ``1 + t*16 + m``; other CUs
    keep K2's mode and prediction with code 0. Zero outside each CU and
    for padding rows."""
    fi, xs, ys, ws, hs, _, ok = unpack_rows(rows, 1)
    preds, costs, cost_ang = mip_costs(refs, org, rows, pred, pad, bit_depth)
    mb = costs.argmin(1)                       # first index on a tie
    use = (costs.gather(1, mb[:, None])[:, 0] < cost_ang) & ok
    mpred = preds.gather(1, mb[:, None, None, None].expand(-1, 1, pad, pad))[:, 0]
    d = torch.arange(pad, device=rows.device)
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None]) \
        & ok[:, None, None]
    out = torch.where(inside, torch.where(use[:, None, None], mpred, pred[0]), 0)
    best = torch.where(use, 0, best).int()
    code = torch.where(use, 1 + mb, 0).int()
    return best, out[None], code


SIGNATURES = {"mip_rmd": {"pmp_mip_rmd": (_build.PTR,) * 6 + (_build.INT,) * 5 + (_build.PTR,) * 4}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def mip_select(refs, org, rows, pred, best, pad, bit_depth):
    """K3: see ``mip_select_reference``; CPU tensors take it, CUDA tensors
    launch ``csrc/mip_rmd.cu``."""
    check_rows(rows)
    if rows.device.type == "cpu":
        return mip_select_reference(refs, org, rows, pred, best, pad, bit_depth)
    _build.check_cuda("mip_select", refs, org, rows, pred, best)
    if any(t.dtype != torch.int32 for t in (refs, org, pred, best)):
        raise TypeError("mip_select takes int32 refs, original, prediction and modes")
    B = rows.shape[0]
    if refs.shape != (1, 4, B, 2 * pad + 3) or pred.shape != (1, B, pad, pad) \
            or best.shape != (B,):
        raise ValueError(f"mip_select: refs {tuple(refs.shape)}, pred "
                         f"{tuple(pred.shape)}, modes {tuple(best.shape)} do not "
                         f"fit {B} rows of pad {pad}")
    _, H, W = org.shape
    best_out = torch.empty_like(best)
    pred_out = torch.empty_like(pred)
    code = torch.empty_like(best)
    err = _lib("mip_rmd").pmp_mip_rmd(
        refs.data_ptr(), org.data_ptr(), rows.data_ptr(),
        _device_table(rows.device).data_ptr(), pred.data_ptr(), best.data_ptr(), B, pad,
        bit_depth, H, W, best_out.data_ptr(), pred_out.data_ptr(), code.data_ptr(),
        _build.stream(rows))
    _build.count_launch(mip_select, err)
    return best_out, pred_out, code


mip_select.launches = 0
