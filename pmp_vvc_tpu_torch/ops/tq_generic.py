"""Size-generic transform / quant / distortion — CU size as data — and the
wave path's transform-quantisation kernels (K4, K5).

Plain PyTorch versions of the JAX package's ``ops/tq_generic.py``: one
function covers every CU shape on a square padded tile, with the per-CU
width/height as tensors.

- DCT-II of any size via the nesting property of the VVC cores: the
  N-point DCT-2 matrix rows are the (64/N)-strided rows of the 64-point
  matrix, so per-CU matrices are a gather from one constant.
- forward/inverse shifts, quantiser qBits/scale and dequant shift follow
  TrQuant.cpp:806-893 and Quant.cpp:954-1031 with log2 sizes as tensors.
- SATD uses 8x8 Hadamard tiles when min(w,h) >= 8, else 4x4, masked to the
  (h, w) region.

The plain versions run their small matrix products in float64, which holds
every partial sum of these integers exactly (|x| < 2^31), so they give the
JAX package's int32 results on the CPU and on the card alike.

**K4** ``tq`` (``csrc/tq.cu``) is the fused per-CU round trip of the wave
step: forward DCT-2, dead-zone quantisation, RDOQ-lite zeroing, the
single-tree LFNST region when asked, sign-data hiding when asked
(``ops/sdh_generic.py``), dequant, inverse, the rate proxy and the
coded-vs-zero TU decision (``wavefront.py:_tq_luma_mts`` with DCT-2 only,
and ``_tq_generic``); with ``jccr``, the joint Cb-Cr trial
(``wavefront.py:_chroma_part`` 598-633) after the U and V round trips;
with LMCS, the chroma residual scale (K6b, ``ops/lmcs_generic.py``) in all
three round trips, derived in K4's prologue.
**K5** ``tq_mts`` (``csrc/tq_mts.cu``) is the luma TQ with candidate
transforms (``_tq_luma_mts``): DCT-2, DST-7/DCT-8, DCT-2 +
LFNST (``ops/lfnst_generic.py``) and transform skip, their cost argmin, then
the zero TU.
Cost sums are exact: SSE in int64 and each coefficient group's 16 gains in
float64, each rounded once to float32, then the costs in float32 in the
JAX package's operation order.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .distortion import hadamard
from .lmcs_generic import crs_forward, crs_inverse, crs_scale_reference
from .quant import INV_QUANT_SCALES, IQUANT_SHIFT, QUANT_SCALES, QUANT_SHIFT
from .rows import check_rows, unpack_rows
from .transforms import COEFF_MAX, COEFF_MIN, MATRIX_SHIFT, core_matrix

MAX_LOG2_DYN_RANGE = 15


def _log2(v):
    """log2 for powers of two in 1..128, as data."""
    return ((v > 1).int() + (v > 2).int() + (v > 4).int() + (v > 8).int()
            + (v > 16).int() + (v > 32).int() + (v > 64).int())


def _rshift_v(x, s):
    """Round-shift with per-CU (broadcastable) non-negative shift."""
    return (x + (torch.ones_like(s) << torch.clamp(s - 1, min=0)) * (s > 0)) >> s


@functools.cache
def _dct2_64(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(core_matrix(0, 64).astype(np.int32)).to(device)


def dct2_matrices(n, pad):
    """(B, pad, pad) int32 DCT-2 matrices for per-CU sizes ``n`` (data),
    rows >= zero-out limit and columns >= n zeroed."""
    ln = _log2(n)
    d = _dct2_64(n.device)[:, :pad]                           # (64, pad)
    i = torch.arange(pad, device=n.device, dtype=torch.int32)
    rows = i[None, :] << (6 - ln)[:, None]                    # (B, pad)
    t = d[rows.clamp(0, 63).long()]                           # (B, pad, pad)
    keep = torch.clamp(n, max=32)                              # zero-out rule
    mask = (i[None, :, None] < keep[:, None, None]) & \
        (i[None, None, :] < n[:, None, None])
    return torch.where(mask, t, 0)


@functools.cache
def _mts_table(kind):
    """(4, 32, 32) int32 padded DST-7 / DCT-8 cores for sizes 4..32."""
    out = np.zeros((4, 32, 32), np.int32)
    for i, n in enumerate((4, 8, 16, 32)):
        out[i, :n, :n] = core_matrix(kind, n)
    return out


def tr_matrices(kind, n, pad):
    """(B, pad, pad) transform matrices of static ``kind``
    (transforms.py order: 0 DCT2, 1 DCT8, 2 DST7) for per-CU sizes
    ``n``; MTS zero-out keeps 16 coefficients (TrQuant.cpp:777)."""
    if kind == 0:
        return dct2_matrices(n, pad)
    ln = _log2(n)
    t = torch.from_numpy(_mts_table(kind)).to(n.device)[(ln - 2).clamp(0, 3).long()]
    if pad > 32:
        t = torch.nn.functional.pad(t, (0, pad - 32, 0, pad - 32))
    elif pad < 32:
        t = t[:, :pad, :pad]
    i = torch.arange(pad, device=n.device)
    mask = (i[None, :, None] < torch.clamp(n, max=16)[:, None, None]) & \
        (i[None, None, :] < n[:, None, None])
    return torch.where(mask, t, 0)


def _bmm(a, b):
    """Exact integer batched product (float64 holds every partial sum)."""
    return torch.bmm(a.double(), b.double()).round().long()


def forward_transform_generic(x, w, h, *, bit_depth: int = 10,
                              kind_w: int = 0, kind_h: int = 0):
    """(B, P, P) int32 residual -> coeffs; w/h: (B,) data.  Input columns
    >= w and rows >= h may hold garbage (masked by the matrices)."""
    tw = tr_matrices(kind_w, w, x.shape[-1])
    th_ = tr_matrices(kind_h, h, x.shape[-1])
    lw, lh = _log2(w), _log2(h)
    s1 = (lw + bit_depth + MATRIX_SHIFT - MAX_LOG2_DYN_RANGE)[:, None, None].long()
    s2 = (lh + MATRIX_SHIFT)[:, None, None].long()
    t1 = _rshift_v(_bmm(x, tw.transpose(1, 2)), s1)               # (B, y, i)
    t2 = _rshift_v(_bmm(th_, t1), s2)                             # (B, k, i)
    return t2.int()


def inverse_transform_generic(c, w, h, *, bit_depth: int = 10,
                              kind_w: int = 0, kind_h: int = 0):
    """(B, P, P) coeffs -> residual (clipped to the 16-bit range)."""
    tw = tr_matrices(kind_w, w, c.shape[-1])
    th_ = tr_matrices(kind_h, h, c.shape[-1])
    s1 = torch.tensor(MATRIX_SHIFT + 1, device=c.device)
    s2 = torch.tensor(MATRIX_SHIFT + MAX_LOG2_DYN_RANGE - 1 - bit_depth,
                      device=c.device)
    e = _rshift_v(_bmm(th_.transpose(1, 2), c), s1).clamp(COEFF_MIN, COEFF_MAX)
    r = _rshift_v(_bmm(e, tw), s2)
    return r.clamp(COEFF_MIN, COEFF_MAX).int()


def _geom_v(w, h, bit_depth):
    lw, lh = _log2(w), _log2(h)
    t_shift = MAX_LOG2_DYN_RANGE - bit_depth - ((lw + lh) >> 1)
    sqrt2 = (lw + lh) & 1
    return t_shift, sqrt2


def quantize_generic(coef, w, h, qp: int, *, bit_depth: int = 10):
    """Dead-zone (171, IRAP) scalar quantisation, size as data."""
    t_shift, sqrt2 = _geom_v(w, h, bit_depth)
    scale = torch.from_numpy(QUANT_SCALES[:, qp % 6].copy()).to(coef.device)[sqrt2.long()]
    q_bits = QUANT_SHIFT + qp // 6 + (t_shift - sqrt2)
    add = 171 << (q_bits - 9)
    mag = coef.abs()
    level = (mag * scale[:, None, None] + add[:, None, None]) >> q_bits[:, None, None]
    signed = torch.where(coef < 0, -level, level)
    return signed.clamp(COEFF_MIN, COEFF_MAX)


def _dequant_unclipped(lvl, w, h, qp, bit_depth):
    t_shift, sqrt2 = _geom_v(w, h, bit_depth)
    scale = torch.from_numpy(INV_QUANT_SCALES[:, qp % 6].copy()).to(lvl.device)
    scale = scale[sqrt2.long()][:, None, None]
    rs = (IQUANT_SHIFT - ((t_shift - sqrt2) + qp // 6))[:, None, None]
    pos = (lvl * scale + (torch.ones_like(rs) << torch.clamp(rs - 1, min=0)) * (rs > 0)) \
        >> torch.clamp(rs, min=0)
    # lvl * scale << -rs, written as a product (no shift of a negative value)
    neg = lvl * scale * (torch.ones_like(rs) << torch.clamp(-rs, min=0))
    return torch.where(rs > 0, pos, neg)


def dequantize_generic(level, w, h, qp: int, *, bit_depth: int = 10):
    lvl = level.clamp(COEFF_MIN, COEFF_MAX)
    return _dequant_unclipped(lvl, w, h, qp, bit_depth).clamp(COEFF_MIN, COEFF_MAX)


def satd_generic(org, pred, w, h):
    """(B, M, P, P) SATD with per-CU sizes; diffs outside (h, w) are
    masked to zero so padded tiles contribute nothing.  CU sides are >= 4."""
    P = org.shape[-1]
    i = torch.arange(P, device=org.device)
    inside = (i[None, :, None] < h[:, None, None]) & \
        (i[None, None, :] < w[:, None, None])
    d = (org - pred) * inside[:, None, :, :]

    def tiles(ts):
        nt = P // ts
        hh = torch.from_numpy(hadamard(ts)).double().to(org.device)
        lead = d.shape[:-2]
        v = d.reshape(*lead, nt, ts, nt, ts).transpose(-3, -2).double()
        coef = (hh @ v @ hh.T).round().long().abs()          # (..., nt, nt, ts, ts)
        s = coef.sum((-2, -1))
        dc = coef[..., 0, 0]
        t = s - dc + (dc >> 2)
        t = (t + 2) >> 2 if ts == 8 else (t + 1) >> 1
        return t.sum((-2, -1))

    mn = torch.minimum(w, h)[:, None]
    out = torch.where(mn >= 8, tiles(8), tiles(4)) if P >= 8 else tiles(4)
    return out.int()


def rd_cleanup_generic(lev, coef, w, h, qp: int, lam: float,
                       *, bit_depth: int = 10):
    """RDOQ-lite zeroing on 4x4 coding groups, size as data (mirrors
    residual.rd_quant_cleanup's rate model; skipped for dims < 4 where
    the CG geometry differs).  Each gain is float32 as in the JAX
    package; a group's 16 gains are summed in float64 and rounded once."""
    P = lev.shape[-1]
    t_shift, sqrt2 = _geom_v(w, h, bit_depth)
    divisor = torch.exp2(2.0 * t_shift.float() - sqrt2.float())
    fc = coef.float()
    e = fc - _dequant_unclipped(lev, w, h, qp, bit_depth).float()
    gain = (fc * fc - e * e) / divisor[:, None, None]
    g = gain.double().reshape(-1, P // 4, 4, P // 4, 4).sum((2, 4)).float()
    k = (lev != 0).reshape(-1, P // 4, 4, P // 4, 4).sum((2, 4)).float()
    lam32 = torch.tensor(lam, dtype=torch.float32)
    kill_cg = g < lam32 * (3.0 * k + 1.5)
    kill_cg = kill_cg.repeat_interleave(4, 1).repeat_interleave(4, 2)
    out = torch.where(kill_cg, 0, lev)
    lam3 = torch.tensor(np.float32(lam * 3.0))
    out = torch.where((out.abs() == 1) & (gain < lam3), 0, out)
    ok = (torch.minimum(w, h) >= 4)[:, None, None]
    return torch.where(ok, out, lev)


def bits_proxy(lev):
    """Order-independent residual-rate proxy (bits) for the zero-TU
    decision (``wavefront.py:_bits_proxy``): 8 + nz + sum(2*bitlen|l|+1).
    ``2*ceil(log2(a+1))`` equals ``2*bitlen(a)`` for 0 < a < 65536."""
    a = lev.abs()
    bitlen = torch.frexp(a.double())[1]
    mag = torch.where(a > 0, 2 * bitlen + 1, 0)
    nz = (a > 0).sum((-1, -2))
    return (8 + mag.sum((-1, -2)) + nz).float()


# ---------------------------------------------------------------------------
# K4: fused per-CU transform-quantisation round trip
# ---------------------------------------------------------------------------

def lfnst_region(ws, hs, active, P):
    """(B, P, P) bool: where a TB's levels may be nonzero when its CU's luma
    chose LFNST (single tree, ``wavefront.py:543-557``): diagonal scan
    positions < 8 of 4x4 and 8x8 TBs, < 16 of the others; everywhere when
    the CU's luma did not, or a side is below 4."""
    from .lfnst import _DIAG4
    diag = np.full((P, P), 99, np.int32)
    for k, (y, x) in enumerate(_DIAG4):
        if y < P and x < P:
            diag[y, x] = k
    small = ((ws == 4) & (hs == 4)) | ((ws == 8) & (hs == 8))
    n_allow = torch.where(small, 8, 16)
    no_gate = ~active | (ws < 4) | (hs < 4)
    return (torch.from_numpy(diag).to(ws.device)[None] < n_allow[:, None, None]) | \
        no_gate[:, None, None]


def _orgs_inside(org, rows, P, scale):
    """Each row's original tile (clamped at the plane's edges) and its
    (h, w) mask."""
    fi, xs, ys, ws, hs, _, ok = unpack_rows(rows, scale)
    d = torch.arange(P, device=rows.device, dtype=torch.int32)
    rr_, cc_ = ys[:, None, None] + d[None, :, None], xs[:, None, None] + d[None, None, :]
    orgs = org[fi[:, None, None].long(), rr_.clamp(0, org.shape[1] - 1).long(),
               cc_.clamp(0, org.shape[2] - 1).long()]
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    return orgs, inside, ws, hs, ok


def _tq_tile(orgt, pred, inside, ws, hs, ok, qp, bd, rd_quant, lam, dw, sdh,
             lfnst_active=None, crs=None):
    """One chroma TQ round trip of the original tiles ``orgt`` against
    ``pred``: (lev, rec, rr), rr the reconstructed residual after the
    coded-vs-zero decision, each zero outside the (h, w) mask and for
    padding rows. ``crs``: optional (B,) LMCS chroma residual scale; the
    residual is scaled before the transform and the reconstructed one scaled
    back after the inverse, and both costs measure the unscaled residual."""
    resid_u = (orgt - pred) * inside
    resid = resid_u if crs is None else crs_forward(resid_u, crs, bd)
    coef = forward_transform_generic(resid, ws, hs, bit_depth=bd)
    lev = quantize_generic(coef, ws, hs, qp, bit_depth=bd)
    if rd_quant:
        lev = rd_cleanup_generic(lev, coef, ws, hs, qp, lam, bit_depth=bd)
    if lfnst_active is not None:
        lev = lev * lfnst_region(ws, hs, lfnst_active, pred.shape[-1])
    if sdh:
        from .sdh_generic import apply_sdh_generic
        lev = apply_sdh_generic(lev, coef, ws, hs, qp, bit_depth=bd)
    deq = dequantize_generic(lev, ws, hs, qp, bit_depth=bd)
    rr = inverse_transform_generic(deq, ws, hs, bit_depth=bd)
    if crs is not None:
        rr = crs_inverse(rr, crs, bd)
    err = ((rr - resid_u) * inside).long()
    sse = (err * err).sum((-1, -2)).float()
    rz = resid_u.long()
    sse0 = (rz * rz).sum((-1, -2)).float()
    lam32 = torch.tensor(lam, dtype=torch.float32)
    dw32 = torch.tensor(dw, dtype=torch.float32)
    cost_code = dw32 * sse + lam32 * bits_proxy(lev)
    cost_zero = dw32 * sse0 + torch.tensor(np.float32(lam * 2.0))
    coded = (cost_zero > cost_code)[:, None, None] & inside & ok[:, None, None]
    lev = torch.where(coded, lev, 0)
    rr = torch.where(coded, rr, 0)
    rec = (pred + rr).clamp(0, (1 << bd) - 1)
    return lev, torch.where(inside & ok[:, None, None], rec, 0), rr


def _joint_trial(tiles, pred, outs, qp_j, bd, rd_quant, lam, dw, sdh, act, crs=None):
    """JCCR mask 3 (Cr = -Cb) against the separate U and V TUs ``outs``
    (``wavefront.py:_chroma_part`` 598-633): the joint residual
    round((res_u - res_v) / 2), half to even, takes a third round trip at
    ``qp_j`` as U's residual; Cr is clip(pred_v - rr_j) from its unclipped
    reconstructed residual. The costs are float32, dw * (SSE_U + SSE_V) +
    lam * bits over the reconstructions: separate bits are each coded TU's
    rate proxy (1 for an uncoded one) + 1, joint bits the joint TU's + 3.
    Joint wins where its TU is coded and its cost is strictly lower; then
    both planes take its levels. The joint TU takes the CRS scale ``crs`` as
    the separate ones do, and Cr's residual is the scaled-back one. Returns
    (lev, rec, use_joint (B,) int32)."""
    (ou, inside, ws, hs, ok), (ov, *_) = tiles
    (lev_u, rec_u, _), (lev_v, rec_v, _) = outs
    joint = torch.round(((ou - pred[0]) * inside - (ov - pred[1]) * inside).double() / 2).int()
    lev_j, rec_ju, rr_j = _tq_tile(pred[0] + joint, pred[0], inside, ws, hs, ok, qp_j, bd,
                                   rd_quant, lam, dw, sdh, act, crs)
    rec_jv = torch.where(inside & ok[:, None, None], (pred[1] - rr_j).clamp(0, (1 << bd) - 1), 0)
    sse = lambda rec, org: (((rec - org) * inside).long() ** 2).sum((-1, -2)).float()
    cbf = lambda lev: (lev != 0).flatten(1).any(1)
    lam32 = torch.tensor(lam, dtype=torch.float32)
    dw32 = torch.tensor(dw, dtype=torch.float32)
    bits_s = torch.where(cbf(lev_u), bits_proxy(lev_u), 1.0) + \
        torch.where(cbf(lev_v), bits_proxy(lev_v), 1.0) + 1.0
    bits_j = bits_proxy(lev_j) + 3.0
    cost_s = dw32 * (sse(rec_u, ou) + sse(rec_v, ov)) + lam32 * bits_s
    cost_j = dw32 * (sse(rec_ju, ou) + sse(rec_jv, ov)) + lam32 * bits_j
    use = cbf(lev_j) & (cost_j < cost_s) & ok
    uj = use[:, None, None]
    lev = torch.stack([torch.where(uj, lev_j, lev_u), torch.where(uj, lev_j, lev_v)])
    rec = torch.stack([torch.where(uj, rec_ju, rec_u), torch.where(uj, rec_jv, rec_v)])
    return lev, rec, use.int()


def tq_reference(orgs, pred, rows, pad, scale, qp, bit_depth, rd_quant, lam,
                 dw, sdh=False, lfnst_active=None, jccr=False, qp_j=0, crs=None):
    """Plain version of K4, the chroma TQ (luma runs K5, ``tq_mts``).

    orgs: one or two (F, H, W) int32 original planes (U and V);
    pred: (n, B, P, P) int32 predictions from K2 (or K6a); rows: (B, 8)
    int32 schedule rows (luma units, ``scale`` 2). ``qp`` is the internal
    QP, ``lam`` the slice lambda, ``dw`` the chroma distortion weight: the
    coded TU costs ``dw*SSE + lam*bits``, the zero TU ``dw*SSE0 + lam*2``.
    With ``sdh``, sign-data hiding (``ops/sdh_generic.py``) adjusts the
    levels after the RD zeroing and before dequantisation, so the rate
    proxy, the SSE and the coded-vs-zero decision all see the adjusted
    levels. ``lfnst_active``: optional (B,) int32, nonzero for the
    single-tree CUs whose luma chose LFNST (K5's ``lf``); their levels are
    confined to ``lfnst_region`` after the RD zeroing and before sign-data
    hiding. With ``jccr`` (U and V given), the joint Cb-Cr trial
    (``_joint_trial``) at internal QP ``qp_j`` follows, with the same
    sign-data hiding and LFNST region. ``crs``: optional (B,) int32 LMCS
    chroma residual scales (``ops/lmcs_generic.py``), applied in every round
    trip, the joint one included. Returns lev and rec, (n, B, P, P) int32,
    zero outside each CU, and with ``jccr`` use_joint (B,) int32."""
    act = None if lfnst_active is None else lfnst_active.bool()
    tiles = [_orgs_inside(o, rows, pad, scale) for o in orgs]
    outs = [_tq_tile(t[0], pred[i], *t[1:], qp, bit_depth, rd_quant, lam, dw, sdh, act, crs)
            for i, t in enumerate(tiles)]
    if jccr:
        return _joint_trial(tiles, pred, outs, qp_j, bit_depth, rd_quant, lam, dw, sdh, act,
                            crs)
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


SIGNATURES = {
    "tq": {"pmp_tq": (_build.PTR,) * 10 + (_build.INT,) * 14 + (_build.FLOAT,) * 4 + (_build.PTR,) * 5},
    "tq_mts": {"pmp_tq_mts": (_build.PTR,) * 11 + (_build.INT,) * 13 + (_build.FLOAT,) * 3 + (_build.PTR,) * 5},
}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def tq(orgs, pred, rows, pad, scale, qp, bit_depth, rd_quant, lam, dw,
       sdh=False, lfnst_active=None, jccr=False, qp_j=0, crs_src=None, crs_out=None):
    """K4: see ``tq_reference``; CPU tensors take it, CUDA tensors launch
    ``csrc/tq.cu``. ``crs_src``: optional (mapped luma recon (F, H, W),
    chroma coding-order grid (F, H/4, W/4), ``crs_lut`` (1 << bd,)), all
    int32, from which each CU's LMCS chroma residual scale is derived
    (``crs_scale_reference``; on the card, K4's prologue); ``crs_out``:
    optional (B,) int32 tensor that receives those scales."""
    check_rows(rows)
    if len(orgs) != pred.shape[0] or len(orgs) not in (1, 2):
        raise ValueError("tq takes one or two planes, one prediction each")
    if jccr and len(orgs) != 2:
        raise ValueError("the joint Cb-Cr trial takes the U and V planes")
    if crs_out is not None and crs_src is None:
        raise ValueError("crs_out needs crs_src")
    if rows.device.type == "cpu":
        crs = None
        if crs_src is not None:
            crs = crs_scale_reference(crs_src[0], crs_src[1], rows, crs_src[2], bit_depth)
            if crs_out is not None:
                crs_out.copy_(crs)
        return tq_reference(orgs, pred, rows, pad, scale, qp, bit_depth,
                            rd_quant, lam, dw, sdh, lfnst_active, jccr, qp_j, crs)
    _build.check_cuda("tq", *orgs, pred, rows, lfnst_active, *(crs_src or ()), crs_out)
    if any(t.dtype != torch.int32 for t in (*orgs, pred, *(crs_src or ()))):
        raise TypeError("tq takes int32 planes, predictions and CRS inputs")
    B = pred.shape[1]
    for t, name in ((lfnst_active, "lfnst_active"), (crs_out, "crs_out")):
        if t is not None and (t.dtype != torch.int32 or t.shape != (B,)):
            raise TypeError(f"{name} must be ({B},) int32")
    n = pred.shape[0]
    if pred.shape[2:] != (pad, pad):
        raise ValueError(f"prediction tiles {tuple(pred.shape)} do not fit pad {pad}")
    _, H, W = orgs[0].shape
    if crs_src is not None and (crs_src[0].shape[1:] != (H * scale, W * scale)
                                or crs_src[2].shape != (1 << bit_depth,)):
        raise ValueError("crs_src must be the luma plane of these chroma planes and a "
                         f"{1 << bit_depth}-entry LUT")
    lev = torch.empty_like(pred)
    rec = torch.empty_like(pred)
    joint = torch.empty((B,), dtype=torch.int32, device=rows.device) if jccr else None
    from .sdh_generic import cg_tables
    cgt = cg_tables(pad, rows.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    ry, og, lut = crs_src or (None, None, None)
    err = _lib("tq").pmp_tq(
        orgs[0].data_ptr(), ptr(orgs[1] if n == 2 else None), pred.data_ptr(),
        rows.data_ptr(), _dct2_64(rows.device).data_ptr(), cgt.data_ptr(),
        ptr(lfnst_active), ptr(ry), ptr(og), ptr(lut), n, B, pad, scale, qp, bit_depth,
        int(rd_quant), H, W, int(sdh), cgt.shape[1], int(jccr), qp_j,
        int(crs_src is not None), *(float(np.float32(v)) for v in (lam, lam * 2.0, lam * 3.0, dw)),
        lev.data_ptr(), rec.data_ptr(), ptr(joint), ptr(crs_out), _build.stream(rows))
    _build.count_launch(tq, err)
    tq.crs_launches += crs_src is not None
    return (lev, rec, joint) if jccr else (lev, rec)


tq.launches = 0
tq.crs_launches = 0                # the launches with the chroma residual scale


# ---------------------------------------------------------------------------
# K5: candidate transform-quantisation of a luma CU (MTS, LFNST, TS)
# ---------------------------------------------------------------------------

# (mts_idx, (horizontal, vertical) kinds in core_matrix order: 0 DCT-2,
# 1 DCT-8, 2 DST-7; mts_idx bins) — the JAX package's _MTS_COMBOS
MTS_COMBOS = ((0, (0, 0), 1.0), (2, (2, 2), 2.0), (3, (1, 2), 3.0),
              (4, (2, 1), 4.0), (5, (1, 1), 4.0))


def lfnst_gate(mip_code, ws, hs):
    """(B,) bool: where LFNST may be signalled (residual_lfnst_mode's MIP
    gate, CABACWriter:2776): not on MIP CUs below 16x16."""
    if mip_code is None:
        return torch.ones(ws.shape, dtype=torch.bool, device=ws.device)
    return ~((mip_code > 0) & ~((ws >= 16) & (hs >= 16)))


def _ts_round_trip(resid, qp):
    """Transform skip: the TS quantiser on the residual itself at
    ``ts_qp(qp)`` (dead zone 171, no transform shift, no sqrt2) and its
    dequantiser (a left shift where the shift is not positive)."""
    from .quant import ts_qp
    qpt = ts_qp(qp)
    q_bits = QUANT_SHIFT + qpt // 6
    mag = ((resid.abs() * int(QUANT_SCALES[0][qpt % 6]) + (171 << (q_bits - 9)))
           >> q_bits).clamp(max=COEFF_MAX)
    lev = torch.where(resid < 0, -mag, mag)
    lvl = lev.clamp(COEFF_MIN, COEFF_MAX) * int(INV_QUANT_SCALES[0][qpt % 6])
    shift = IQUANT_SHIFT - qpt // 6
    rr = (lvl + (1 << (shift - 1))) >> shift if shift > 0 else lvl << -shift
    return lev, rr.clamp(COEFF_MIN, COEFF_MAX)


def tq_mts_candidates(orgs, pred, rows, pad, qp, bit_depth, rd_quant, lam,
                      modes, mip_code=None, mts=False, lfnst=False, ts_max=0,
                      sdh=False):
    """Every candidate of K5 on these rows, in the order of the argmin:
    a list of (lev, rr, cost (B,) float32 with +inf where illegal, mts_idx,
    lfnst_idx), then the residual, the (h, w) mask, the live rows and the
    zero TU's cost. See ``tq_mts_reference``."""
    from .lfnst_generic import fwd_lfnst_generic, inv_lfnst_generic
    from .sdh_generic import apply_sdh_generic
    bd = bit_depth
    orgt, inside, ws, hs, ok = _orgs_inside(orgs[0], rows, pad, 1)
    resid = (orgt - pred[0]) * inside
    lam32 = torch.tensor(lam, dtype=torch.float32)

    def code(coef):
        lev = quantize_generic(coef, ws, hs, qp, bit_depth=bd)
        if rd_quant:
            lev = rd_cleanup_generic(lev, coef, ws, hs, qp, lam, bit_depth=bd)
        if sdh:
            lev = apply_sdh_generic(lev, coef, ws, hs, qp, bit_depth=bd)
        return lev

    def cost(lev, rr, bins, legal):
        err = ((rr - resid) * inside).long()
        c = (err * err).sum((-1, -2)).float() + lam32 * (bits_proxy(lev) + bins)
        return torch.where(legal, c, torch.inf)

    def beyond_dc(lev):
        return (lev != 0).sum((-1, -2)) - (lev[:, 0, 0] != 0).long() > 0

    cands = []
    coef_dct2 = None
    for mts_idx, (kw, kh), bins in (MTS_COMBOS if mts else MTS_COMBOS[:1]):
        coef = forward_transform_generic(resid, ws, hs, bit_depth=bd, kind_w=kw, kind_h=kh)
        if mts_idx == 0:
            coef_dct2 = coef
        lev = code(coef)
        rr = inverse_transform_generic(dequantize_generic(lev, ws, hs, qp, bit_depth=bd),
                                       ws, hs, bit_depth=bd, kind_w=kw, kind_h=kh)
        legal = torch.ones_like(ok) if mts_idx == 0 else \
            beyond_dc(lev) & (ws <= 32) & (hs <= 32)
        cands.append((lev, rr, cost(lev, rr, bins, legal), mts_idx, 0))
    if lfnst:
        for li in (1, 2):
            sec = fwd_lfnst_generic(coef_dct2, modes, ws, hs, li)
            lev = code(sec)
            pri = inv_lfnst_generic(dequantize_generic(lev, ws, hs, qp, bit_depth=bd),
                                    modes, ws, hs, li)
            rr = inverse_transform_generic(pri, ws, hs, bit_depth=bd)
            legal = beyond_dc(lev) & lfnst_gate(mip_code, ws, hs)
            cands.append((lev, rr, cost(lev, rr, 2.0, legal), 0, li))
    if ts_max:
        lev, rr = _ts_round_trip(resid, qp)
        legal = (ws <= ts_max) & (hs <= ts_max) & (lev != 0).flatten(1).any(1)
        cands.append((lev, rr, cost(lev, rr, 1.0, legal), 1, 0))
    rz = resid.long()
    cost_zero = (rz * rz).sum((-1, -2)).float() + torch.tensor(np.float32(lam * 2.0))
    return cands, resid, inside, ok, cost_zero


def tq_mts_reference(orgs, pred, rows, pad, qp, bit_depth, rd_quant, lam,
                     modes, mip_code=None, mts=False, lfnst=False, ts_max=0,
                     sdh=False):
    """Plain version of K5, the luma TQ with candidate transforms
    (``wavefront.py:_tq_luma_mts``).

    orgs: [luma (F, H, W) int32]; pred: (1, B, P, P) int32; rows: (B, 8)
    int32; ``modes``: (B,) int32 final luma modes (PLANAR for MIP CUs), the
    LFNST kernel set's input; ``mip_code``: (B,) int32 MIP grid codes or
    None, for LFNST's MIP gate (``lfnst_gate``). Candidates in this order,
    each ``cost = SSE + lam * (bits_proxy + bins)`` in float32:

    - DCT-2 (mts_idx 0, 1 bin), always legal;
    - with ``mts``, DST-7/DCT-8 pairs mts_idx 2..5 (2, 3, 4, 4 bins), legal
      with a level beyond DC and w, h <= 32;
    - with ``lfnst``, DCT-2 + LFNST 1 and 2 (2 bins): quantisation, RD
      zeroing and sign-data hiding on the secondary coefficients; legal with
      a level beyond DC where ``lfnst_gate``;
    - with ``ts_max``, transform skip (mts_idx 1, 1 bin): the TS quantiser,
      no RD zeroing, no sign-data hiding; legal with w, h <= ts_max and a
      nonzero level.

    An illegal candidate costs +inf; the first minimum wins, then the zero
    TU (``SSE0 + 2 lam``) where it costs no more. Each non-TS candidate gets
    sign-data hiding with ``sdh``. Returns lev and rec (1, B, P, P) int32,
    zero outside each CU, and tr (mts_idx) and lf (lfnst_idx), (B,) int32,
    both 0 for a zero TU or a padding row."""
    cands, _, inside, ok, cost_zero = tq_mts_candidates(
        orgs, pred, rows, pad, qp, bit_depth, rd_quant, lam, modes, mip_code,
        mts, lfnst, ts_max, sdh)
    costs = torch.stack([c[2] for c in cands], 1)
    k = costs.argmin(1)                                   # the first minimum
    pick = lambda i: torch.stack([c[i] for c in cands], 1)[
        torch.arange(len(k), device=k.device), k]
    lev, rr = pick(0), pick(1)
    cost_code = costs.gather(1, k[:, None])[:, 0]
    coded = (cost_zero > cost_code) & ok
    idx = lambda i: torch.tensor([c[i] for c in cands], dtype=torch.int32, device=k.device)[k]
    m = coded[:, None, None] & inside
    rec = (pred[0] + torch.where(m, rr, 0)).clamp(0, (1 << bit_depth) - 1)
    return (torch.where(m, lev, 0)[None].int(),
            torch.where(inside & ok[:, None, None], rec, 0)[None].int(),
            torch.where(coded, idx(3), 0), torch.where(coded, idx(4), 0))


@functools.cache
def _mts_cores(device: torch.device) -> torch.Tensor:
    """(2, 4, 32, 32) int32: the DCT-8 and DST-7 cores (``core_matrix``
    kinds 1 and 2) for sizes 4, 8, 16, 32, zero-padded, for K5."""
    return torch.from_numpy(np.stack([_mts_table(1), _mts_table(2)])).to(device)


def tq_mts(orgs, pred, rows, pad, qp, bit_depth, rd_quant, lam, modes,
           mip_code=None, mts=False, lfnst=False, ts_max=0, sdh=False):
    """K5: see ``tq_mts_reference``; CPU tensors take it, CUDA tensors
    launch ``csrc/tq_mts.cu``."""
    check_rows(rows)
    if len(orgs) != 1 or pred.shape[0] != 1:
        raise ValueError("tq_mts takes the luma plane and one prediction")
    if rows.device.type == "cpu":
        return tq_mts_reference(orgs, pred, rows, pad, qp, bit_depth, rd_quant,
                                lam, modes, mip_code, mts, lfnst, ts_max, sdh)
    _build.check_cuda("tq_mts", orgs[0], pred, rows, modes, mip_code)
    B = rows.shape[0]
    if any(t.dtype != torch.int32 for t in (orgs[0], pred, modes)) or \
            (mip_code is not None and mip_code.dtype != torch.int32):
        raise TypeError("tq_mts takes int32 planes, predictions, modes and codes")
    if pred.shape[1:] != (B, pad, pad) or modes.shape != (B,) or \
            (mip_code is not None and mip_code.shape != (B,)):
        raise ValueError(f"prediction {tuple(pred.shape)}, modes and codes do not "
                         f"fit {B} rows at pad {pad}")
    if (mts or ts_max) and pad > 32:
        raise ValueError("MTS and transform skip run only in the 32-pad class")
    from .lfnst_generic import lfnst_device_tables, lfnst_gather_table
    from .quant import ts_qp
    from .sdh_generic import cg_tables
    dev = rows.device
    _, H, W = orgs[0].shape
    lev = torch.empty_like(pred)
    rec = torch.empty_like(pred)
    tr = torch.empty((B,), dtype=torch.int32, device=dev)
    lf = torch.empty((B,), dtype=torch.int32, device=dev)
    cgt = cg_tables(pad, dev)
    lut, kern = lfnst_device_tables(dev)
    gat = lfnst_gather_table(pad, dev)
    code = mip_code.data_ptr() if mip_code is not None else None
    err = _lib("tq_mts").pmp_tq_mts(
        orgs[0].data_ptr(), pred.data_ptr(), rows.data_ptr(), modes.data_ptr(), code,
        _dct2_64(dev).data_ptr(), _mts_cores(dev).data_ptr(), cgt.data_ptr(),
        lut.data_ptr(), kern.data_ptr(), gat.data_ptr(), B, pad, qp, ts_qp(qp), bit_depth,
        int(rd_quant), H, W, int(sdh), cgt.shape[1], int(mts), int(lfnst), int(ts_max),
        *(float(np.float32(v)) for v in (lam, lam * 2.0, lam * 3.0)), lev.data_ptr(),
        rec.data_ptr(), tr.data_ptr(), lf.data_ptr(), _build.stream(rows))
    _build.count_launch(tq_mts, err)
    return lev, rec, tr, lf


tq_mts.launches = 0
