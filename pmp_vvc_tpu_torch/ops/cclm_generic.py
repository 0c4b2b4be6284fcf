"""Size-generic CCLM (LM_CHROMA) — block geometry as data — and the wave
path's CCLM kernel (K6a).

Plain PyTorch version of the JAX package's ``ops/cclm_generic.py``; every
step is branchless over the CU batch:

- 6-tap {1 2 1 / 1 2 1} luma downsampling of the co-located recon, with the
  CTU-top 3-tap row and the no-left padding rule as data selects
  (xGetLumaRecPixels, IntraPrediction.cpp:1384-1464); samples are read
  clamped to the plane's edges;
- the 4-point min/max template fit through VTM's compare-swap network on
  (luma, chroma) pairs, so that ties break as in VTM (xGetLMParameters
  :1640-1866), with the 4-bit-significand division table ``ops/cclm.py``;
- the prediction ``clip(((a * ds) >> shift) + b)``; every right shift is
  arithmetic (it floors negative products).

The wave step's chroma choice (``wavefront.py:_chroma_part`` 514-541): the
LM predictions of U and V compete with the DM predictions by joint U+V SATD;
LM wins only where its cost is strictly lower (ties go to DM) and the row's
CCLM gate (flag bit 0, checkCCLMAllowed) is set. Neighbour availability
comes from the chroma tree's coding-order grid, not from the frame.

**K6a** ``cclm_select`` (``csrc/cclm.cu``) makes that choice on the card
between K2 (the DM prediction) and K4; ``cclm_select_reference`` is its
plain version. The SATDs are integers below 2^24, so the JAX package's
float32 sums and comparisons are exact and the integer ones here decide
alike.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from .cclm import DIV_SIG
from .intra_generic import avail_from_order, gather_plane
from .rows import check_rows, unpack_rows
from .tq_generic import satd_generic


def _bitlen(v, nbits: int = 17):
    """bit_length() of non-negative values below 2**nbits."""
    out = torch.zeros_like(v)
    for k in range(nbits):
        out = out + (v >= (1 << k)).int()
    return out


def _g(plane, fi, rows, cols):
    return gather_plane(plane, fi, rows, cols).int()


def _cswap(al, ac, bl, bc):
    sw = al > bl
    return (torch.where(sw, bl, al), torch.where(sw, bc, ac),
            torch.where(sw, al, bl), torch.where(sw, ac, bc))


def cclm_models(ry, fi, cxs, cys, cws, chs, *, pad_c: int, top_u, left_u, top_v,
                left_v, bit_depth: int = 10, ctu_size: int = 128, left_avail=None,
                above_avail=None):
    """The downsampled luma and the U and V linear models of B chroma blocks
    (arguments as ``cclm_predict_generic``). Returns (interior (B, pad_c,
    pad_c), [(a, b, shift) of U, of V], cases): ``cases`` holds (B,) bool
    masks of the template's special cases, "two" (two samples, duplicated),
    "flat" (no luma range), "none" (no neighbour) and, per plane, "clamped"
    (the slope clamped to +-15 where the shift falls below 1)."""
    Pc = pad_c
    lx, ly = 2 * cxs, 2 * cys
    la = (cxs > 0) if left_avail is None else left_avail
    aa = (cys > 0) if above_avail is None else above_avail
    i = torch.arange(Pc, device=cxs.device, dtype=torch.int32)
    fi2, fi3 = fi[:, None], fi[:, None, None]

    idx = lx[:, None] + 2 * i[None, :]                           # (B, Pc)
    lidx = torch.where((~la[:, None]) & (i[None, :] == 0), idx, idx - 1)

    def six(row0, cols_c, cols_r, cols_l):
        return (4 + 2 * _g(ry, fi2, row0, cols_c) + _g(ry, fi2, row0, cols_r)
                + _g(ry, fi2, row0, cols_l) + 2 * _g(ry, fi2, row0 + 1, cols_c)
                + _g(ry, fi2, row0 + 1, cols_r) + _g(ry, fi2, row0 + 1, cols_l)) >> 3

    # interior (B, Pc, Pc): luma rows ly + 2j, ly + 2j + 1
    r3 = (ly[:, None] + 2 * i[None, :])[:, :, None]
    c3, l3 = idx[:, None, :], lidx[:, None, :]
    g3 = lambda rr, cc: _g(ry, fi3, rr, cc)
    interior = (4 + 2 * g3(r3, c3) + g3(r3, c3 + 1) + g3(r3, l3)
                + 2 * g3(r3 + 1, c3) + g3(r3 + 1, c3 + 1) + g3(r3 + 1, l3)) >> 3

    # the above template row: 6 taps, or 3 on the CTU's top row
    ab6 = six(torch.clamp(ly - 2, min=0)[:, None], idx, idx + 1, lidx)
    r1 = torch.clamp(ly - 1, min=0)[:, None]
    ab3 = (2 + 2 * _g(ry, fi2, r1, idx) + _g(ry, fi2, r1, idx + 1)
           + _g(ry, fi2, r1, lidx)) >> 2
    ds_above = torch.where((ly % ctu_size == 0)[:, None], ab3, ab6)

    # the left template column: 6 taps at luma columns lx-1, lx-2, lx-3
    j2 = ly[:, None] + 2 * i[None, :]
    cl2, cl1, cl3 = (torch.clamp(lx - k, min=0)[:, None] for k in (2, 1, 3))
    ds_left = (4 + 2 * _g(ry, fi2, j2, cl2) + _g(ry, fi2, j2, cl1) + _g(ry, fi2, j2, cl3)
               + 2 * _g(ry, fi2, j2 + 1, cl2) + _g(ry, fi2, j2 + 1, cl1)
               + _g(ry, fi2, j2 + 1, cl3)) >> 3

    above_is4 = torch.where(la, 0, 1).int()
    left_is4 = torch.where(aa, 0, 1).int()
    cnt_t = torch.where(aa, torch.minimum(cws, (1 + above_is4) << 1), 0)
    start_t = cws >> (2 + above_is4)
    step_t = torch.clamp(cws >> (1 + above_is4), min=1)
    cnt_l = torch.where(la, torch.minimum(chs, (1 + left_is4) << 1), 0)
    start_l = chs >> (2 + left_is4)
    step_l = torch.clamp(chs >> (1 + left_is4), min=1)
    k4 = torch.arange(4, device=cxs.device, dtype=torch.int32)
    use_t = k4[None, :] < cnt_t[:, None]
    pos_t = torch.clamp(start_t[:, None] + k4 * step_t[:, None], 0, Pc - 1).long()
    pos_l = torch.clamp(start_l[:, None] + (k4[None, :] - cnt_t[:, None]) * step_l[:, None],
                        0, Pc - 1).long()
    sel_l = torch.where(use_t, ds_above.gather(1, pos_t), ds_left.gather(1, pos_l))
    two = (cnt_t + cnt_l) == 2
    div_sig = torch.from_numpy(DIV_SIG).int().to(cxs.device)

    none = (~la) & (~aa)
    cases = {"two": two & ~none, "none": none, "clamped": []}

    def params(top_ref, left_ref):
        """(a, b, shift) per CU, xGetLMParameters' LM path."""
        sel_c = torch.where(use_t, top_ref.int().gather(1, 1 + pos_t),
                            left_ref.int().gather(1, 1 + pos_l))
        # the two-sample case takes [b0, a0, b0, a0]
        dup = [1, 0, 1, 0]
        sl = torch.where(two[:, None], sel_l[:, dup], sel_l)
        sc = torch.where(two[:, None], sel_c[:, dup], sel_c)
        # VTM's compare-swap network on (luma, chroma) pairs
        n0l, n0c, n1l, n1c = _cswap(sl[:, 0], sc[:, 0], sl[:, 2], sc[:, 2])
        x0l, x0c, x1l, x1c = _cswap(sl[:, 1], sc[:, 1], sl[:, 3], sc[:, 3])
        sw = n0l > x1l
        n0l, n1l, x0l, x1l, n0c, n1c, x0c, x1c = (
            torch.where(sw, x0l, n0l), torch.where(sw, x1l, n1l),
            torch.where(sw, n0l, x0l), torch.where(sw, n1l, x1l),
            torch.where(sw, x0c, n0c), torch.where(sw, x1c, n1c),
            torch.where(sw, n0c, x0c), torch.where(sw, n1c, x1c))
        sw2 = n1l > x0l
        n1l, x0l = torch.where(sw2, x0l, n1l), torch.where(sw2, n1l, x0l)
        n1c, x0c = torch.where(sw2, x0c, n1c), torch.where(sw2, n1c, x0c)

        min_l, min_c = (n0l + n1l + 1) >> 1, (n0c + n1c + 1) >> 1
        max_l, max_c = (x0l + x1l + 1) >> 1, (x0c + x1c + 1) >> 1
        diff, diff_c = max_l - min_l, max_c - min_c
        x = _bitlen(torch.clamp(diff, min=1)) - 1
        norm = ((diff << 4) >> x) & 15
        v = div_sig[norm.long()] | 8
        x = x + (norm != 0).int()
        y = _bitlen(diff_c.abs())
        add = (1 << y) >> 1
        a = (diff_c * v + add) >> y
        shift = 3 + x - y
        flat = diff <= 0
        cases["flat"] = flat & ~none
        cases["clamped"].append((shift < 1) & (a != 0) & ~flat & ~none)
        a = torch.where(shift < 1, torch.where(a == 0, 0, torch.where(a < 0, -15, 15)), a)
        shift = torch.clamp(shift, min=1)
        b = min_c - ((a * min_l) >> shift)
        # degenerate cases: a flat template, no neighbour at all
        a = torch.where(flat | none, 0, a)
        b = torch.where(none, 1 << (bit_depth - 1), torch.where(flat, min_c, b))
        shift = torch.where(flat | none, 0, shift)
        return a, b, shift

    models = [params(top_u, left_u), params(top_v, left_v)]
    return interior, models, cases


def cclm_predict_generic(ry, fi, cxs, cys, cws, chs, *, pad_c: int,
                         top_u, left_u, top_v, left_v, bit_depth: int = 10,
                         ctu_size: int = 128, left_avail=None, above_avail=None):
    """LM_CHROMA predictions for B chroma blocks.

    ry: (F, H, W) int32 luma recon; cxs/cys/cws/chs: (B,) int32 chroma
    coordinates and sizes; top_u/left_u/top_v/left_v: (B, 2*pad_c+3)
    substituted chroma reference rows (index 0 = corner). Returns (pred_u,
    pred_v), each (B, pad_c, pad_c) int32, valid over [:ch, :cw].
    ``left_avail``/``above_avail``: (B,) bool neighbour availability
    (default: not at the frame's left or top edge)."""
    interior, models, _ = cclm_models(
        ry, fi, cxs, cys, cws, chs, pad_c=pad_c, top_u=top_u, left_u=left_u, top_v=top_v,
        left_v=left_v, bit_depth=bit_depth, ctu_size=ctu_size, left_avail=left_avail,
        above_avail=above_avail)
    return tuple(
        (((a[:, None, None] * interior) >> sh[:, None, None]) + b[:, None, None])
        .clamp(0, (1 << bit_depth) - 1).int() for a, b, sh in models)


# ---------------------------------------------------------------------------
# K6a: DM against LM for the wave step's chroma CUs
# ---------------------------------------------------------------------------

def cclm_neighbours(og4c, rows):
    """(left, above) availability (B,) bool of each row's chroma CU: the
    covering leaf of its left (above) neighbour precedes it in the chroma
    tree's coding order (``og4c``, luma-unit 4-sample grid)."""
    fi, cxs, cys, _, _, oi, _ = unpack_rows(rows, 2)
    la = avail_from_order(og4c, fi, oi, torch.clamp(cxs - 1, min=0) * 2 // 4,
                          cys * 2 // 4, cxs > 0)
    aa = avail_from_order(og4c, fi, oi, cxs * 2 // 4,
                          torch.clamp(cys - 1, min=0) * 2 // 4, cys > 0)
    return la, aa


def cclm_costs(refs, ry, orgs, og4c, rows, pred, pad, bit_depth):
    """The choice's inputs: (LM predictions (2, B, P, P), joint U+V SATD of
    DM (B,), of LM (B,))."""
    fi, cxs, cys, cws, chs, _, _ = unpack_rows(rows, 2)
    la, aa = cclm_neighbours(og4c, rows)
    lm = torch.stack(cclm_predict_generic(
        ry, fi, cxs, cys, cws, chs, pad_c=pad, top_u=refs[0, 0], left_u=refs[0, 1],
        top_v=refs[1, 0], left_v=refs[1, 1], bit_depth=bit_depth,
        left_avail=la, above_avail=aa))
    d = torch.arange(pad, device=rows.device, dtype=torch.int32)
    tiles = torch.stack([gather_plane(o, fi[:, None, None], cys[:, None, None] + d[None, :, None],
                                      cxs[:, None, None] + d[None, None, :]) for o in orgs])
    satd = lambda p: sum(satd_generic(tiles[k][:, None], p[k][:, None], cws, chs)[:, 0]
                         for k in range(2))
    return lm, satd(pred), satd(lm)


def cclm_select_reference(refs, ry, orgs, og4c, rows, pred, pad, bit_depth):
    """Plain version of K6a.

    refs: (2, 4, B, 2P+3) int32 chroma references from K1 (U, V; the
    unfiltered top and left rows are used); ry: (F, H, W) int32 luma recon;
    orgs: the U and V (F, H/2, W/2) int32 originals; og4c: the chroma tree's
    (F, H/4, W/4) int32 coding-order grid; rows: (B, 8) int32 (luma units;
    flag bit 0 the CU's CCLM gate); pred: (2, B, P, P) int32 DM predictions
    from K2. Returns (pred, use_lm): the LM predictions where LM's joint SATD
    is strictly below DM's and the gate is set, else DM's, zero outside each
    CU and for padding rows; use_lm (B,) int32."""
    _, _, _, cws, chs, _, ok = unpack_rows(rows, 2)
    lm, cost_dm, cost_lm = cclm_costs(refs, ry, orgs, og4c, rows, pred, pad, bit_depth)
    use = (cost_lm < cost_dm) & ((rows[:, 7] & 1) > 0) & ok
    d = torch.arange(pad, device=rows.device)
    inside = (d[None, :, None] < chs[:, None, None]) & (d[None, None, :] < cws[:, None, None]) \
        & ok[:, None, None]
    out = torch.where(inside[None], torch.where(use[None, :, None, None], lm, pred), 0)
    return out.int(), use.int()


SIGNATURES = {"cclm": {"pmp_cclm": (_build.PTR,) * 7 + (_build.INT,) * 9 + (_build.PTR,) * 3}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def cclm_select(refs, ry, orgs, og4c, rows, pred, pad, bit_depth):
    """K6a: see ``cclm_select_reference``; CPU tensors take it, CUDA tensors
    launch ``csrc/cclm.cu``."""
    check_rows(rows)
    if len(orgs) != 2:
        raise ValueError("cclm_select takes the U and V originals")
    if rows.device.type == "cpu":
        return cclm_select_reference(refs, ry, orgs, og4c, rows, pred, pad, bit_depth)
    _build.check_cuda("cclm_select", refs, ry, *orgs, og4c, rows, pred)
    if any(t.dtype != torch.int32 for t in (refs, ry, *orgs, og4c, pred)):
        raise TypeError("cclm_select takes int32 refs, planes, grid and predictions")
    B = rows.shape[0]
    if refs.shape != (2, 4, B, 2 * pad + 3) or pred.shape != (2, B, pad, pad):
        raise ValueError(f"cclm_select: refs {tuple(refs.shape)}, pred "
                         f"{tuple(pred.shape)} do not fit {B} rows of pad {pad}")
    _, H, W = ry.shape
    _, Hc, Wc = orgs[0].shape
    _, GH, GW = og4c.shape
    out = torch.empty_like(pred)
    use = torch.empty((B,), dtype=torch.int32, device=rows.device)
    err = _lib("cclm").pmp_cclm(
        refs.data_ptr(), ry.data_ptr(), orgs[0].data_ptr(), orgs[1].data_ptr(),
        og4c.data_ptr(), rows.data_ptr(), pred.data_ptr(), B, pad, bit_depth, H, W, Hc, Wc,
        GH, GW, out.data_ptr(), use.data_ptr(), _build.stream(rows))
    _build.count_launch(cclm_select, err)
    return out, use


cclm_select.launches = 0
