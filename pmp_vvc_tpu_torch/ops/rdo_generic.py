"""The device RDO's open-loop leaf costs (K9) and their kernels.

The JAX package's ``codec/rdo_device.py:_leaf_cost_fn`` and
``_chroma_leaf_cost_fn`` price every leaf rect of a frame's QTMT node DAG
in one batched pass, open loop: references come from the ORIGINAL planes
and every in-frame sample counts as available (an all-zero coding-order
grid with order id 1 in every row). Here they are composed of the port's
kernels:

- ``luma_leaf_costs``: K1 (``ref_gather``) on the original luma and U/V;
  K9a (``rdo_luma_select``) — RMD over ``RMD_MODES`` by SATD, the first
  minimum winning with no +-1 refinement, the winner's luma prediction and
  the DM predictions of U and V with its mode; per QP point, K5 (``tq_mts``,
  MTS only, and only where the class allows it: no candidate is legal in the
  64-pad class) and K4 (``tq``, U and V, no joint trial, scale or SDH); then
  K9c (``rdo_leaf_cost``) — ``sse + lam * (bits + 6)`` plus, for U then V,
  ``dw * sse_c + lam * bits_c``.
- ``chroma_leaf_costs`` (the dual tree's chroma channel): K1 on U/V; K9b
  (``rdo_chroma_select``) — the candidates ``CHROMA_CANDIDATES`` by joint
  U+V SATD; with ``cclm``, K6a (``cclm_select``) — LM against that choice
  on the original luma; per QP point K4; then K9c from ``lam * 2``.

The mode search is shared by every QP point; only the round trips and the
costs repeat. Each cost is float32: SSEs exact in int64, rounded once, then
the operations in the JAX package's order. Rows are the wave step's
(``ops/rows.py``): (frame, x, y, w, h, order id 1, live, flags 1) in luma
units; padding rows (live 0) give cost 0 and mode 0, and nothing reads them.

Each kernel wrapper takes its plain version for CPU tensors and launches
``csrc/rdo_leaf.cu`` for CUDA tensors (or raises); ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .cclm_generic import cclm_select
from .intra_generic import (RMD_MODES, _device_tables, gather_plane, predict_generic,
                            ref_gather)
from .rows import check_rows, unpack_rows
from .tq_generic import _orgs_inside, bits_proxy, satd_generic, tq, tq_mts

# the dual-tree chroma candidates: planar, DC, HOR, VER (the DM is unknown
# open loop)
CHROMA_CANDIDATES = np.array([0, 1, 18, 50], np.int32)


def _cu_mask(ws, hs, ok, P):
    d = torch.arange(P, device=ws.device)
    return (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None]) \
        & ok[:, None, None]


def _tiles(plane, fi, xs, ys, P):
    d = torch.arange(P, device=fi.device, dtype=torch.int32)
    return gather_plane(plane, fi[:, None, None], ys[:, None, None] + d[None, :, None],
                        xs[:, None, None] + d[None, None, :])


def _best_of(preds, satds, inside):
    """The first minimum's prediction (B, P, P), zero outside ``inside``,
    and its index."""
    bi = satds.argmin(1)
    pick = preds[torch.arange(len(bi), device=bi.device), bi]
    return torch.where(inside, pick, 0), bi


# ---------------------------------------------------------------------------
# K9a: luma RMD and the DM predictions (rdo_device.py:83-121)
# ---------------------------------------------------------------------------

def rdo_luma_select_reference(refs, crefs, org, rows, pad, bit_depth):
    """Plain version of K9a.

    refs: (1, 4, B, 2P+3) int32 luma references from K1 on the original
    (scale 1); crefs: (2, 4, B, P+3) U and V references from K1 (scale 2,
    pad P/2); org: the (F, H, W) int32 original luma; rows: (B, 8) int32.
    RMD by SATD over ``RMD_MODES``, the first minimum winning. Returns modes
    (B,) int32, pred (1, B, P, P) and cpred (2, B, P/2, P/2) int32: the
    winner's luma prediction and the U and V predictions of its mode with
    the chroma parameters, zero outside each rect and for padding rows."""
    P, Pc = pad, pad // 2
    fi, xs, ys, ws, hs, _, ok = unpack_rows(rows, 1)
    B = rows.shape[0]
    rmd = torch.from_numpy(RMD_MODES).to(rows.device)
    preds = predict_generic(*refs[0], rmd[None].expand(B, -1), ws, hs, pad=P, is_luma=True,
                            bit_depth=bit_depth)
    satds = satd_generic(_tiles(org, fi, xs, ys, P)[:, None], preds, ws, hs)
    pred, bi = _best_of(preds, satds, _cu_mask(ws, hs, ok, P))
    best = torch.where(ok, rmd[bi], 0)
    cws, chs = ws // 2, hs // 2
    cin = _cu_mask(cws, chs, ok, Pc)
    cpred = torch.stack([torch.where(cin, predict_generic(
        *crefs[pl], best[:, None], cws, chs, pad=Pc, is_luma=False,
        bit_depth=bit_depth)[:, 0], 0) for pl in range(2)])
    return best.int(), pred[None].int(), cpred.int()


SIGNATURES = {"rdo_leaf": {
    "pmp_rdo_luma_select": (_build.PTR,) * 6 + (_build.INT,) * 5 + (_build.PTR,) * 4,
    "pmp_rdo_chroma_select": (_build.PTR,) * 5 + (_build.INT,) * 5 + (_build.PTR,) * 3,
    "pmp_rdo_leaf_cost": (_build.PTR,) * 9 + (_build.INT,) * 6 + (_build.PTR,) * 2,
}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def _check_int32(name, *tensors):
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"{name} takes int32 tensors")


def rdo_luma_select(refs, crefs, org, rows, pad, bit_depth):
    """K9a: see ``rdo_luma_select_reference``; CPU tensors take it, CUDA
    tensors launch ``csrc/rdo_leaf.cu``."""
    check_rows(rows)
    if rows.device.type == "cpu":
        return rdo_luma_select_reference(refs, crefs, org, rows, pad, bit_depth)
    _build.check_cuda("rdo_luma_select", refs, crefs, org, rows)
    _check_int32("rdo_luma_select", refs, crefs, org)
    B, P, Pc = rows.shape[0], pad, pad // 2
    if refs.shape != (1, 4, B, 2 * P + 3) or crefs.shape != (2, 4, B, 2 * Pc + 3):
        raise ValueError(f"rdo_luma_select: refs {tuple(refs.shape)}, crefs "
                         f"{tuple(crefs.shape)} do not fit {B} rows of pad {P}")
    dev = rows.device
    modes = torch.empty(B, dtype=torch.int32, device=dev)
    pred = torch.empty((1, B, P, P), dtype=torch.int32, device=dev)
    cpred = torch.empty((2, B, Pc, Pc), dtype=torch.int32, device=dev)
    _, H, W = org.shape
    err = _lib("rdo_leaf").pmp_rdo_luma_select(
        refs.data_ptr(), crefs.data_ptr(), org.data_ptr(), rows.data_ptr(),
        _device_tables(True, dev).data_ptr(), _device_tables(False, dev).data_ptr(),
        B, P, bit_depth, H, W, modes.data_ptr(), pred.data_ptr(), cpred.data_ptr(),
        _build.stream(rows))
    _build.count_launch(rdo_luma_select, err)
    return modes, pred, cpred


rdo_luma_select.launches = 0


# ---------------------------------------------------------------------------
# K9b: the dual-tree chroma candidates (rdo_device.py:588-617)
# ---------------------------------------------------------------------------

def rdo_chroma_select_reference(crefs, orgs, rows, pad_c, bit_depth):
    """Plain version of K9b.

    crefs: (2, 4, B, 2Pc+3) int32 U and V references from K1 (scale 2);
    orgs: the U and V (F, H/2, W/2) int32 originals; rows: (B, 8) int32.
    The candidates ``CHROMA_CANDIDATES`` on U and V by joint U+V SATD, the
    first minimum winning. Returns pred (2, B, Pc, Pc) int32, zero outside
    each rect and for padding rows, and the winner's SATD (B,) int32."""
    fi, cxs, cys, cws, chs, _, ok = unpack_rows(rows, 2)
    B = rows.shape[0]
    cand = torch.from_numpy(CHROMA_CANDIDATES).to(rows.device)[None].expand(B, -1)
    preds = [predict_generic(*crefs[pl], cand, cws, chs, pad=pad_c, is_luma=False,
                             bit_depth=bit_depth) for pl in range(2)]
    satds = sum(satd_generic(_tiles(o, fi, cxs, cys, pad_c)[:, None], p, cws, chs)
                for o, p in zip(orgs, preds))
    inside = _cu_mask(cws, chs, ok, pad_c)
    (pred_u, bi), (pred_v, _) = (_best_of(p, satds, inside) for p in preds)
    best = satds.gather(1, bi[:, None])[:, 0]
    return torch.stack([pred_u, pred_v]).int(), torch.where(ok, best, 0).int()


def rdo_chroma_select(crefs, orgs, rows, pad_c, bit_depth):
    """K9b: see ``rdo_chroma_select_reference``; CPU tensors take it, CUDA
    tensors launch ``csrc/rdo_leaf.cu``."""
    check_rows(rows)
    if len(orgs) != 2:
        raise ValueError("rdo_chroma_select takes the U and V originals")
    if rows.device.type == "cpu":
        return rdo_chroma_select_reference(crefs, orgs, rows, pad_c, bit_depth)
    _build.check_cuda("rdo_chroma_select", crefs, *orgs, rows)
    _check_int32("rdo_chroma_select", crefs, *orgs)
    B, dev = rows.shape[0], rows.device
    if crefs.shape != (2, 4, B, 2 * pad_c + 3):
        raise ValueError(f"rdo_chroma_select: crefs {tuple(crefs.shape)} do not fit "
                         f"{B} rows of pad {pad_c}")
    pred = torch.empty((2, B, pad_c, pad_c), dtype=torch.int32, device=dev)
    satd = torch.empty(B, dtype=torch.int32, device=dev)
    _, Hc, Wc = orgs[0].shape
    err = _lib("rdo_leaf").pmp_rdo_chroma_select(
        crefs.data_ptr(), orgs[0].data_ptr(), orgs[1].data_ptr(), rows.data_ptr(),
        _device_tables(False, dev).data_ptr(), B, pad_c, bit_depth, Hc, Wc,
        pred.data_ptr(), satd.data_ptr(), _build.stream(rows))
    _build.count_launch(rdo_chroma_select, err)
    return pred, satd


rdo_chroma_select.launches = 0


# ---------------------------------------------------------------------------
# K9c: the leaf costs (rdo_device.py:122-136, 636-646)
# ---------------------------------------------------------------------------

def qp_params(qps) -> torch.Tensor:
    """(nQP, 3) float32 (lam, dw_c, lam * 2) of QP points (qp_y, qp_c, lam,
    dw_c), each rounded once to float32 (``lam * 2`` in float64 first)."""
    return torch.tensor([(lam, dw, lam * 2.0) for _qy, _qc, lam, dw in qps],
                        dtype=torch.float32)


def rdo_leaf_cost_reference(rows, pad, orgs, lev, rec, lev_c, rec_c, params):
    """Plain version of K9c.

    rows: (B, 8) int32; orgs: the (F, H, W) luma (None for the chroma
    tree), U and V originals; lev, rec: (nQP, B, P, P) int32 luma levels and
    recon of K5 (None for the chroma tree); lev_c, rec_c: (nQP, 2, B, P/2,
    P/2) of K4; params: ``qp_params``. Each plane's SSE is exact and rounded
    to float32 once; the cost is ``sse + lam * (bits + 6)`` (luma tree) or
    ``lam * 2`` (chroma tree), then for U and V ``+ dw * sse_c + lam *
    bits_c``, in float32 in this order. Returns (nQP, B) float32, 0 for
    padding rows."""
    ok = rows[:, 6] > 0

    def sse(r, tiles):
        org, inside = tiles[:2]
        err = ((r - org) * inside).long()
        return (err * err).sum((-1, -2)).float()

    tiles_c = [_orgs_inside(o, rows, pad // 2, 2) for o in orgs[1:]]
    tiles_l = _orgs_inside(orgs[0], rows, pad, 1) if lev is not None else None
    out = []
    for q, (lam, dw, lam2) in enumerate(params.to(rows.device)):
        if lev is not None:
            cost = sse(rec[q], tiles_l) + lam * (bits_proxy(lev[q]) + 6.0)
        else:
            cost = lam2.expand(rows.shape[0])
        for pl in range(2):
            cost = cost + dw * sse(rec_c[q, pl], tiles_c[pl]) + lam * bits_proxy(lev_c[q, pl])
        out.append(torch.where(ok, cost, 0.0))
    return torch.stack(out)


def rdo_leaf_cost(rows, pad, orgs, lev, rec, lev_c, rec_c, params):
    """K9c: see ``rdo_leaf_cost_reference``; CPU tensors take it, CUDA
    tensors launch ``csrc/rdo_leaf.cu``, whose level and recon tiles must
    start on a 16-byte boundary. The kernel reads the levels inside each
    rect only: beyond it they must be zero, as K4's and K5's are, for the
    plain version's count over the whole tile to be the same."""
    check_rows(rows)
    if rows.device.type == "cpu":
        return rdo_leaf_cost_reference(rows, pad, orgs, lev, rec, lev_c, rec_c, params)
    luma = lev is not None
    params = params.to(rows.device)
    _build.check_cuda("rdo_leaf_cost", rows, *(o for o in orgs if o is not None), lev, rec,
                      lev_c, rec_c, params)
    _check_int32("rdo_leaf_cost", *(t for t in (*orgs, lev, rec, lev_c, rec_c)
                                    if t is not None))
    nqp, B, P, Pc = params.shape[0], rows.shape[0], pad, pad // 2
    if params.dtype != torch.float32 or params.shape != (nqp, 3):
        raise TypeError("rdo_leaf_cost takes (nQP, 3) float32 parameters")
    if rec_c.shape != (nqp, 2, B, Pc, Pc) or lev_c.shape != rec_c.shape or \
            (luma and (rec.shape != (nqp, B, P, P) or lev.shape != rec.shape)):
        raise ValueError(f"rdo_leaf_cost: tiles do not fit {nqp} QP points, {B} rows "
                         f"of pad {P}")
    if any(t.data_ptr() % 16 for t in (lev, rec, lev_c, rec_c) if t is not None):
        raise ValueError("rdo_leaf_cost reads the level and recon tiles as int4: they must "
                         "be 16-byte aligned")
    cost = torch.empty((nqp, B), dtype=torch.float32, device=rows.device)
    _, Hc, Wc = orgs[1].shape
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = _lib("rdo_leaf").pmp_rdo_leaf_cost(
        rows.data_ptr(), ptr(orgs[0]), orgs[1].data_ptr(), orgs[2].data_ptr(), ptr(lev),
        ptr(rec), lev_c.data_ptr(), rec_c.data_ptr(), params.data_ptr(), nqp, B, P,
        2 * Hc, 2 * Wc, int(luma), cost.data_ptr(), _build.stream(rows))
    _build.count_launch(rdo_leaf_cost, err)
    return cost


rdo_leaf_cost.launches = 0


# ---------------------------------------------------------------------------
# the leaf costs of one tile class
# ---------------------------------------------------------------------------

def _zero_grid(oy):
    """The open loop's coding-order grid: every unit coded before order id 1."""
    F, H, W = oy.shape
    return torch.zeros((F, H // 4, W // 4), dtype=torch.int32, device=oy.device)


def luma_leaf_costs(rows, oy, ou, ov, P, qps, bd, rd_quant, mts):
    """Open-loop luma leaf costs of the P-pad class (``_leaf_cost_fn``):
    rows (B, 8) int32 as above; oy, ou, ov the (F, ...) int32 original planes
    (unmapped); ``qps`` a tuple of (qp_y, qp_c, lam, dw_c), the internal QPs.
    Returns (costs (nQP, B) float32, best modes (B,) int32)."""
    og0 = _zero_grid(oy)
    refs = ref_gather([oy], og0, rows, P, 1, bd)
    crefs = ref_gather([ou, ov], og0, rows, P // 2, 2, bd)
    modes, pred, cpred = rdo_luma_select(refs, crefs, oy, rows, P, bd)
    levs, recs, clevs, crecs = [], [], [], []
    for qp_y, qp_c, lam, dw_c in qps:
        lev, rec, _, _ = tq_mts([oy], pred, rows, P, qp_y, bd, rd_quant, lam, modes,
                                mts=mts and P <= 32)
        lev_c, rec_c = tq([ou, ov], cpred, rows, P // 2, 2, qp_c, bd, rd_quant, lam, dw_c)
        levs.append(lev[0])
        recs.append(rec[0])
        clevs.append(lev_c)
        crecs.append(rec_c)
    costs = rdo_leaf_cost(rows, P, [oy, ou, ov], torch.stack(levs), torch.stack(recs),
                          torch.stack(clevs), torch.stack(crecs), qp_params(qps))
    return costs, modes


def chroma_leaf_costs(rows, oy, ou, ov, P, qps, bd, rd_quant, cclm):
    """Open-loop dual-tree chroma leaf costs of the P-pad class (P in luma
    units, ``_chroma_leaf_cost_fn``): as ``luma_leaf_costs``, rows with the
    CCLM gate (flag bit 0) set; with ``cclm``, LM from the original luma.
    Returns costs (nQP, B) float32."""
    Pc = P // 2
    og0 = _zero_grid(oy)
    crefs = ref_gather([ou, ov], og0, rows, Pc, 2, bd)
    pred, _ = rdo_chroma_select(crefs, [ou, ov], rows, Pc, bd)
    if cclm:
        pred, _ = cclm_select(crefs, oy, [ou, ov], og0, rows, pred, Pc, bd)
    clevs, crecs = [], []
    for _qp_y, qp_c, lam, dw_c in qps:
        lev_c, rec_c = tq([ou, ov], pred, rows, Pc, 2, qp_c, bd, rd_quant, lam, dw_c)
        clevs.append(lev_c)
        crecs.append(rec_c)
    return rdo_leaf_cost(rows, P, [None, ou, ov], None, None, torch.stack(clevs),
                         torch.stack(crecs), qp_params(qps))
