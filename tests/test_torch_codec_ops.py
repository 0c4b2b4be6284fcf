"""The wave path's plain kernels (K1, K2, K4) against the JAX functions.

K1 ``ref_gather_reference`` against ``wavefront.py:_refs_generic``, K2's
predictor ``predict_generic`` and RMD against the JAX predictor and SATD,
and the DCT-2 TQ — luma ``tq_mts_reference`` with its tools off against
``_tq_luma_mts`` (DCT-2 only), chroma K4 ``tq_reference`` against
``_tq_generic`` — exactly, over every CU size 4..64 on pads 32 and 64, all
67 modes, luma and chroma, random availability, QP 22/27/32/37. Before the
TQ is compared, every float decision on the inputs (coefficient-group and
single-coefficient zeroing, coded vs zero TU) is asserted to keep a
relative margin above ``MARGIN``: the JAX package sums those costs in
float32 in an order of its own, and its ``exp2`` divisor is not exactly a
power of two, so a decision closer than that could round either way.

Also: ``_bits_proxy``, the copied tables, and the C CABAC finalizer against
the Python ``BinEncoder``. ``tq_margin`` and ``mip_margin`` also serve the
``margins`` fixture of test_torch_wavefront.py: with sign-data hiding, each
corrected coefficient group's gap between the chosen move and the runner-up
is a float32 decision too; every MIP decision compares integer SATDs, which
the JAX package sums in float32 and so compares exactly only below 2^24. The
CUDA kernels themselves run only on the card; chip_smoke.py holds them
against these plain versions there.
"""
import itertools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.ops import intra_generic as jig
from pmp_vvc_tpu.ops import tq_generic as jtq
from pmp_vvc_tpu_torch.codec.cabac import ContextStore
from pmp_vvc_tpu_torch.native import cabac_finalize, python_finalize
from pmp_vvc_tpu_torch.ops import intra_generic as tig
from pmp_vvc_tpu_torch.ops import mip_generic as tmip
from pmp_vvc_tpu_torch.ops import sdh_generic as tsdh
from pmp_vvc_tpu_torch.ops import tq_generic as ttq
from pmp_vvc_tpu_torch.ops.lmcs_generic import crs_forward, crs_inverse
from pmp_vvc_tpu_torch.ops.quant import INV_QUANT_SCALES, IQUANT_SHIFT

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
BD = 10
QPS = (22, 27, 32, 37)
MARGIN = 1e-6
SIZES = (4, 8, 16, 32, 64)


# jitted once per shape: the JAX functions run op by op otherwise
_jpredict = jax.jit(jig.predict_generic, static_argnames=("pad", "is_luma", "bit_depth"))
_jsatd = jax.jit(jtq.satd_generic)
_jrefs = jax.jit(jwf._refs_generic, static_argnums=(8, 9, 10))
_jtq_luma = jax.jit(jwf._tq_luma_mts, static_argnums=(4, 5, 6, 7, 9))
_jtq_chroma = jax.jit(jwf._tq_generic, static_argnums=(4, 5, 6, 7, 8))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def size_rows(pad, scale=1, seed=0, width=256, height=192, extra_pad_rows=2):
    """(B, 8) int32 schedule rows: every (w, h) of the pad class (luma
    units; chroma rows carry luma sizes 4..2*pad), at random positions that
    include the frame edges, random order ids, and a few padding rows."""
    rng = np.random.RandomState(seed)
    sides = [s for s in (4, 8, 16, 32, 64, 128) if s <= pad * scale]
    big = pad * scale
    sizes = [(w, h) for w, h in itertools.product(sides, sides)
             if max(w, h) <= big and (pad == 32 or max(w, h) > big // 2)]
    rows = []
    for i, (w, h) in enumerate(sizes):
        x = [0, width - w, rng.randint(0, (width - w) // 8 + 1) * 8][i % 3]
        y = [rng.randint(0, (height - h) // 8 + 1) * 8, 0, height - h][i % 3]
        rows.append((rng.randint(2), x, y, w, h, rng.randint(0, 400), 1, 0))
    rows += [(0, 0, 0, 0, 0, 0, 0, 0)] * extra_pad_rows
    return np.array(rows, np.int32)


def planes(seed=0, F=2, width=256, height=192, scale=1):
    """Smooth content plus noise, a random coding-order grid (-1 = not
    coded) and the same frame's originals."""
    rng = np.random.RandomState(seed)
    H, W = height // scale, width // scale
    yy, xx = np.mgrid[0:H, 0:W]
    rec = np.stack([np.clip(512 + 300 * np.sin(xx / (7 + f)) * np.cos(yy / 11)
                            + rng.randn(H, W) * 20, 0, 1023) for f in range(F)])
    org = np.clip(rec + rng.randn(F, H, W) * 40, 0, 1023)
    og = rng.randint(-1, 400, (F, height // 4, width // 4))
    return rec.astype(np.int32), org.astype(np.int32), og.astype(np.int32)


def _unpack(rows, scale):
    r = rows.astype(np.int32)
    return (r[:, 0], r[:, 1] // scale, r[:, 2] // scale, r[:, 3] // scale,
            r[:, 4] // scale, r[:, 5], r[:, 6] > 0)


def jax_refs(plane, og, rows, pad, scale):
    fi, xs, ys, ws, hs, oi, ok = _unpack(rows, scale)
    out = _jrefs(_j(plane), _j(og), _j(fi), _j(oi), _j(xs), _j(ys),
                            _j(ws), _j(hs), pad, scale, BD)
    return np.stack([np.asarray(o) for o in out]), ok


# ---------------------------------------------------------------------------
# tables, rate proxy, CABAC finalizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["transform_cores.npz", "ctx_init.npz",
                                  "ctx_sets.json", "mip_matrices.npz", "lfnst.npz",
                                  "alf_fixed.npz"])
def test_copied_tables_are_byte_equal(name):
    a = (REPO / "pmp_vvc_tpu" / "codec" / "data" / name).read_bytes()
    b = (REPO / "pmp_vvc_tpu_torch" / "codec" / "data" / name).read_bytes()
    assert a == b


def test_bits_proxy_matches_jax():
    rng = np.random.RandomState(0)
    lev = rng.randint(-40, 41, (64, 16, 16)) * (rng.rand(64, 16, 16) < 0.3)
    lev[0, :4, :4] = [[32767, -32768, 65535 // 2, 1], [2, 3, 4, 7],
                      [8, 15, 16, 255], [256, 1023, 1024, 4095]]
    want = np.asarray(jwf._bits_proxy(_j(lev.astype(np.int32))))
    got = ttq.bits_proxy(_t(lev.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_cabac_matches_python_bin_encoder(seed):
    rng = np.random.RandomState(seed)
    n_ctx = len(ContextStore.standard_init(32, 2).state0)
    ops = []
    for _ in range(5000):
        t = rng.randint(4)
        if t == 0:
            ops.append(("b", int(rng.randint(2)), int(rng.randint(n_ctx))))
        elif t == 1:
            ops.append(("ep", int(rng.randint(2))))
        elif t == 2:
            n = int(rng.randint(1, 20))
            ops.append(("eps", int(rng.randint(1 << n)), n))
        else:
            ops.append(("rem", int(rng.randint(5000)), int(rng.randint(4)), 5, 15))
    for qp in (22, 37):
        assert cabac_finalize(ops, ContextStore.standard_init(qp, 2)) == \
            python_finalize(ops, ContextStore.standard_init(qp, 2))


# ---------------------------------------------------------------------------
# K1: reference gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad,scale", [(32, 1), (64, 1), (16, 2), (32, 2)])
def test_ref_gather_matches_jax(pad, scale):
    rows = size_rows(pad, scale, seed=pad + scale)
    rec, _, og = planes(seed=pad, scale=scale)
    # all-uncoded grid rows and fully coded ones besides the random grid
    og[1, :, :] = np.where(np.arange(og.shape[2]) % 3 == 0, -1, og[1])
    want, ok = jax_refs(rec, og, rows, pad, scale)
    got = tig.ref_gather_reference([_t(rec)], _t(og), _t(rows), pad, scale, BD)
    got = got[0].numpy()
    np.testing.assert_array_equal(got[:, ok], want[:, ok])
    assert not got[:, ~ok].any()
    two = tig.ref_gather_reference([_t(rec), _t(rec[::-1].copy())], _t(og),
                                   _t(rows), pad, scale, BD).numpy()
    np.testing.assert_array_equal(two[0], got)


# ---------------------------------------------------------------------------
# K2: predictor and RMD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad,is_luma", [(32, True), (64, True), (16, False),
                                         (32, False)])
def test_predict_generic_matches_jax_on_every_size_and_mode(pad, is_luma):
    scale = 1 if is_luma else 2
    rows = size_rows(pad, scale, seed=7, extra_pad_rows=0)
    rec, _, og = planes(seed=3, scale=scale)
    refs, _ = jax_refs(rec, og, rows, pad, scale)
    _, _, _, ws, hs, _, _ = _unpack(rows, scale)
    modes = np.broadcast_to(np.arange(67, dtype=np.int32), (len(rows), 67))
    want = np.asarray(_jpredict(*(_j(r) for r in refs), _j(modes),
                                          _j(ws), _j(hs), pad=pad,
                                          is_luma=is_luma, bit_depth=BD))
    got = tig.predict_generic(*(_t(r) for r in refs), _t(modes), _t(ws),
                              _t(hs), pad=pad, is_luma=is_luma,
                              bit_depth=BD).numpy()
    for b, (w, h) in enumerate(zip(ws, hs)):
        np.testing.assert_array_equal(got[b, :, :h, :w], want[b, :, :h, :w],
                                      err_msg=f"{w}x{h}")


def jax_rmd(refs, org, rows, pad):
    """The RMD of wavefront.py:_make_class_apply (373-401) with the JAX
    functions."""
    fi, xs, ys, ws, hs, _, _ = _unpack(rows, 1)
    dy = np.arange(pad)
    orgs = jwf._gather_plane(_j(org), _j(fi)[:, None, None],
                             _j(ys)[:, None, None] + dy[None, :, None],
                             _j(xs)[:, None, None] + dy[None, None, :])
    rmd = np.array([0, 1] + list(range(2, 67, 2)), np.int32)
    jr = [_j(r) for r in refs]
    W, H = _j(ws), _j(hs)
    preds = _jpredict(*jr, _j(np.broadcast_to(rmd, (len(rows), 35))),
                                W, H, pad=pad, is_luma=True, bit_depth=BD)
    costs = _jsatd(orgs[:, None], preds, W, H)
    bi = jnp.argmin(costs, axis=1)
    m_a = jnp.take(jnp.asarray(rmd), bi)
    ang = m_a >= 2
    modes_ref = jnp.stack([jnp.where(ang, jnp.clip(m_a - 1, 2, 66), m_a),
                           jnp.where(ang, jnp.clip(m_a + 1, 2, 66), m_a)], axis=1)
    preds_r = _jpredict(*jr, modes_ref, W, H, pad=pad, is_luma=True,
                                  bit_depth=BD)
    costs_r = _jsatd(orgs[:, None], preds_r, W, H)
    cand_c = jnp.concatenate([jnp.take_along_axis(costs, bi[:, None], axis=1),
                              costs_r], axis=1)
    cand_p = jnp.concatenate([jnp.take_along_axis(preds, bi[:, None, None, None],
                                                  axis=1), preds_r], axis=1)
    cand_m = jnp.concatenate([m_a[:, None], modes_ref], axis=1)
    k = jnp.argmin(cand_c, axis=1)
    best = jnp.take_along_axis(cand_m, k[:, None], axis=1)[:, 0]
    pred = jnp.take_along_axis(cand_p, k[:, None, None, None], axis=1)[:, 0]
    return np.asarray(best), np.asarray(pred)


@pytest.mark.parametrize("pad", [32, 64])
def test_rmd_matches_jax(pad):
    rows = size_rows(pad, 1, seed=11)
    rec, org, og = planes(seed=5)
    refs, ok = jax_refs(rec, og, rows, pad, 1)
    want_m, want_p = jax_rmd(refs, org, rows, pad)
    mg = torch.zeros((2, 48, 64), dtype=torch.uint8)
    got_m, got_p = tig.intra_rmd_reference(_t(refs[None]), _t(org), mg, _t(rows),
                                           pad, True, BD)
    np.testing.assert_array_equal(got_m.numpy()[ok], want_m[ok])
    _, _, _, ws, hs, _, _ = _unpack(rows, 1)
    for b in np.flatnonzero(ok):
        np.testing.assert_array_equal(got_p[0, b, :hs[b], :ws[b]].numpy(),
                                      want_p[b, :hs[b], :ws[b]])
    assert not got_p[0, ~torch.from_numpy(ok)].any() and not got_m[~torch.from_numpy(ok)].any()


def test_chroma_dm_reads_the_mode_grid_at_the_cu_centre():
    pad = 32
    rows = size_rows(pad, 2, seed=13)
    rec, _, og = planes(seed=6, scale=2)
    refs, ok = jax_refs(rec, og, rows, pad, 2)
    mg = np.random.RandomState(0).randint(0, 67, (2, 48, 64)).astype(np.uint8)
    modes, pred = tig.intra_rmd_reference(_t(np.stack([refs, refs])), None,
                                          _t(mg), _t(rows), pad, False, BD)
    fi, xs, ys, ws, hs = (rows[:, k] for k in range(5))
    want_m = mg[fi, (ys + hs // 2) // 4, (xs + ws // 2) // 4].astype(np.int32)
    np.testing.assert_array_equal(modes.numpy()[ok], want_m[ok])
    jp = np.asarray(_jpredict(*(_j(r) for r in refs), _j(want_m[:, None]),
                                        _j(ws // 2), _j(hs // 2), pad=pad,
                                        is_luma=False, bit_depth=BD))[:, 0]
    for b in np.flatnonzero(ok):
        h, w = hs[b] // 2, ws[b] // 2
        np.testing.assert_array_equal(pred[0, b, :h, :w].numpy(), jp[b, :h, :w])
        np.testing.assert_array_equal(pred[1, b].numpy(), pred[0, b].numpy())


# ---------------------------------------------------------------------------
# K4: transform-quantisation round trip
# ---------------------------------------------------------------------------

def sdh_gaps(lev, coef, ws, hs, qp):
    """Per coefficient group that sign-data hiding corrects, the relative
    float32 gap between the chosen move's added error and the runner-up's.
    Where both errors are exact in float32 (equal to the int64 value), any
    evaluation order gives the same choice, ties included: the gap counts
    as infinite there."""
    B, P, _ = lev.shape
    mismatch, err, tgt, new = tsdh.sdh_moves(lev, coef, ws, hs, qp, bit_depth=BD)
    old, c = (t.reshape(B, 1, -1).expand(-1, tgt.shape[1], -1).gather(-1, tgt.clamp(min=0))
              .long() for t in (lev, coef))
    deq = lambda l: ttq._dequant_unclipped(l, ws, hs, qp, BD)
    exact = (deq(new.long()) - c) ** 2 - (deq(old) - c) ** 2
    is_exact = err.double() == exact.double()
    e, k = err.sort(dim=-1, stable=True)
    top2_exact = is_exact.gather(-1, k[..., :2]).all(-1)
    e1, e2 = e[..., 0].double(), e[..., 1].double()
    gap = (e2 - e1) / torch.maximum(torch.maximum(e1.abs(), e2.abs()), torch.ones_like(e1))
    gap = torch.where(torch.isinf(e2) | top2_exact, torch.inf, gap)
    return gap[mismatch].tolist()


def mip_margin(refs, org, rows, pred, pad):
    """(largest SATD, smallest gap) of K3's decisions on these inputs: every
    candidate's and K2's winner's SATD (float32 sums are exact below 2^24),
    and over the live CUs the gap |MIP winner - K2 winner|."""
    _, costs, cost_ang = tmip.mip_costs(refs, org, rows, pred, pad, BD)
    ok = rows[:, 6] > 0
    valid = costs < tmip._NO_COST
    top = max(int(costs[valid].max()), int(cost_ang.max()))
    gap = (costs.min(1).values - cost_ang).abs()[ok]
    return top, int(gap.min()) if gap.numel() else None


def quant_margins(coef, ws, hs, qp, lam, live, sdh=False, region=None):
    """The relative margins of the float decisions that quantising ``coef``
    takes: each coefficient group's gain sum against lam*(3k+1.5) and each
    remaining +-1 level's gain against 3*lam (RDOQ-lite zeroing, on the
    ``live`` CUs with both sides >= 4). Returns (margins, the levels after
    the zeroing and the ``region`` mask if given, and with ``sdh`` the
    ``sdh_gaps`` of those levels)."""
    pad = coef.shape[-1]
    lev = ttq.quantize_generic(coef, ws, hs, qp, bit_depth=BD)
    margins = []
    big = (torch.minimum(ws, hs) >= 4) & live
    lw, lh = ttq._log2(ws), ttq._log2(hs)
    t_shift = 15 - BD - ((lw + lh) >> 1)
    sqrt2 = (lw + lh) & 1
    divisor = torch.tensor([2.0 ** int(e) for e in 2 * t_shift - sqrt2],
                           dtype=torch.float32)
    fc = coef.float()
    e = fc - ttq._dequant_unclipped(lev, ws, hs, qp, BD).float()
    gain = (fc * fc - e * e) / divisor[:, None, None]
    g = gain.double().reshape(-1, pad // 4, 4, pad // 4, 4).sum((2, 4))
    k = (lev != 0).reshape(-1, pad // 4, 4, pad // 4, 4).sum((2, 4)).double()
    thr = float(np.float32(lam)) * (3 * k + 1.5)
    act = (k > 0) & big[:, None, None]
    margins.append(((g - thr).abs() / thr)[act])
    lam3 = float(np.float32(lam * 3.0))
    one = (lev.abs() == 1) & big[:, None, None]
    margins.append(((gain.double() - lam3).abs() / lam3)[one])
    lev2 = ttq.rd_cleanup_generic(lev, coef, ws, hs, qp, lam, bit_depth=BD)
    if region is not None:
        lev2 = lev2 * region
    return margins, lev2, sdh_gaps(lev2, coef, ws, hs, qp) if sdh else []


def luma_or_chroma_tq(orgs, pred, rows, pad, scale, qp, lam, dw, sdh=False):
    """The plain DCT-2 TQ round trip of the wave step on these inputs,
    with RD zeroing: ``dw`` None, luma (K5 with its tools off); else chroma
    (K4). Returns (lev, rec)."""
    if dw is None:
        modes = torch.zeros(rows.shape[0], dtype=torch.int32)
        return ttq.tq_mts_reference(orgs, pred, rows, pad, qp, BD, True, lam, modes,
                                    sdh=sdh)[:2]
    return ttq.tq_reference(orgs, pred, rows, pad, scale, qp, BD, True, lam, dw, sdh=sdh)


def _dct2_coef(org, pred, rows, pad, scale, crs=None):
    """(residual, its DCT-2 coefficients, (h, w) mask, ws, hs, live rows)
    of each row's tile; with ``crs`` (B,) the coefficients are those of the
    LMCS-scaled residual."""
    fi, xs, ys, ws, hs, _, ok = (torch.from_numpy(a) for a in _unpack(rows, scale))
    d = torch.arange(pad, dtype=torch.int32)
    orgs = org[fi[:, None, None].long(),
               (ys[:, None, None] + d[None, :, None]).clamp(0, org.shape[1] - 1).long(),
               (xs[:, None, None] + d[None, None, :]).clamp(0, org.shape[2] - 1).long()]
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    resid = (orgs - pred) * inside
    coded = resid if crs is None else crs_forward(resid, crs, BD)
    coef = ttq.forward_transform_generic(coded, ws, hs, bit_depth=BD)
    return resid, coef, inside, ws, hs, ok


def region_cut(org, pred, rows, pad, scale, qp, lam, lfnst_active, crs=None):
    """How many of K4's RD-zeroed levels on these inputs the single-tree
    LFNST region removes (``ttq.lfnst_region``, on the live rows whose
    ``lfnst_active`` is set)."""
    _, coef, _, ws, hs, ok = _dct2_coef(org, pred, rows, pad, scale, crs)
    lev = ttq.rd_cleanup_generic(ttq.quantize_generic(coef, ws, hs, qp, bit_depth=BD),
                                 coef, ws, hs, qp, lam, bit_depth=BD)
    region = ttq.lfnst_region(ws, hs, lfnst_active.bool(), pad)
    return int(((lev != 0) & ~region & ok[:, None, None]).sum())


def tq_margin(org, pred, rows, pad, scale, qp, lam, dw=None, sdh=False,
              lfnst_active=None, crs=None):
    """The smallest relative margin of the DCT-2 TQ's float decisions on
    these inputs (``luma_or_chroma_tq``: K4's, or with ``dw`` None K5's with
    its tools off), recomputed with the port's plain pieces: the zeroing
    decisions of ``quant_margins`` and the coded TU's cost against the zero
    TU's; with ``sdh``, after sign-data hiding (and ``lfnst_active``'s
    region); with ``crs`` (B,), of K4's round trip with LMCS chroma residual
    scaling. Returns (margin, ``sdh_gaps`` of the groups that sign-data
    hiding corrects)."""
    return _round_trip_margin(*_dct2_coef(org, pred, rows, pad, scale, crs), qp, lam, dw, sdh,
                              lfnst_active, crs)


def _round_trip_margin(resid, coef, inside, ws, hs, ok, qp, lam, dw, sdh, lfnst_active,
                       crs=None):
    """``tq_margin`` of the residual tiles ``resid`` with DCT-2 coefficients
    ``coef`` (of the residual scaled by ``crs``, if given)."""
    region = None if lfnst_active is None else \
        ttq.lfnst_region(ws, hs, lfnst_active.bool(), coef.shape[-1])
    margins, lev2, gaps = quant_margins(coef, ws, hs, qp, lam, ok, sdh, region)
    if sdh:
        lev2 = tsdh.apply_sdh_generic(lev2, coef, ws, hs, qp, bit_depth=BD)
    rr = ttq.inverse_transform_generic(
        ttq.dequantize_generic(lev2, ws, hs, qp, bit_depth=BD), ws, hs, bit_depth=BD)
    if crs is not None:
        rr = crs_inverse(rr, crs, BD)
    sse = (((rr - resid) * inside).double() ** 2).sum((-1, -2))
    sse0 = (resid.double() ** 2).sum((-1, -2))
    bits = ttq.bits_proxy(lev2).double()
    lam32 = float(np.float32(lam))
    if dw is None:
        cc, cz = sse + lam32 * (bits + 1), sse0 + 2 * lam32
    else:
        dw32 = float(np.float32(dw))
        cc, cz = dw32 * sse + lam32 * bits, dw32 * sse0 + 2 * lam32
    margins.append(((cc - cz).abs() / torch.maximum(cc, cz))[ok])
    return min(float(m.min()) if m.numel() else np.inf for m in margins), gaps


def jccr_margin(orgs, pred, rows, pad, scale, qp, qp_j, lam, dw, sdh=False,
                lfnst_active=None, crs=None):
    """The smallest relative margin of the joint Cb-Cr trial's float decisions
    on these inputs (K4 with ``jccr``; its U and V round trips are
    ``tq_margin``'s): the joint TU's zeroing and coded-vs-zero decisions, as
    in ``tq_margin``, and where the joint TU is coded its cost against the
    separate TUs' (``ttq._joint_trial``), both recomputed in float64 from the
    exact SSEs; every round trip with the LMCS scales ``crs`` if given.
    Returns (margin, ``sdh_gaps`` of the joint TU)."""
    tiles = [ttq._orgs_inside(o, torch.from_numpy(rows), pad, scale) for o in orgs]
    (ou, inside, ws, hs, ok), (ov, *_) = tiles
    act = None if lfnst_active is None else lfnst_active.bool()
    joint = torch.round(((ou - pred[0]) * inside - (ov - pred[1]) * inside).double() / 2).int()
    coef = ttq.forward_transform_generic(joint if crs is None else crs_forward(joint, crs, BD),
                                         ws, hs, bit_depth=BD)
    margin, gaps = _round_trip_margin(joint, coef, inside, ws, hs, ok, qp_j, lam, dw, sdh,
                                      lfnst_active, crs)
    (lev_u, rec_u, _), (lev_v, rec_v, _) = (
        ttq._tq_tile(t[0], pred[i], *t[1:], qp, BD, True, lam, dw, sdh, act, crs)
        for i, t in enumerate(tiles))
    lev_j, rec_ju, rr_j = ttq._tq_tile(pred[0] + joint, pred[0], inside, ws, hs, ok, qp_j,
                                       BD, True, lam, dw, sdh, act, crs)
    rec_jv = (pred[1] - rr_j).clamp(0, (1 << BD) - 1)
    sse = lambda rec, org: (((rec - org) * inside).double() ** 2).sum((-1, -2))
    cbf = lambda lev: (lev != 0).flatten(1).any(1)
    bits = lambda lev: ttq.bits_proxy(lev).double()
    lam32, dw32 = float(np.float32(lam)), float(np.float32(dw))
    bits_s = torch.where(cbf(lev_u), bits(lev_u), 1.0) + \
        torch.where(cbf(lev_v), bits(lev_v), 1.0) + 1
    cost_s = dw32 * (sse(rec_u, ou) + sse(rec_v, ov)) + lam32 * bits_s
    cost_j = dw32 * (sse(rec_ju, ou) + sse(rec_jv, ov)) + lam32 * (bits(lev_j) + 3)
    gap = ((cost_j - cost_s).abs() / torch.maximum(cost_j, cost_s))[cbf(lev_j) & ok]
    return min(margin, float(gap.min()) if gap.numel() else np.inf), gaps


def k5_margin(orgs, pred, rows, pad, qp, lam, modes, mip_code=None, mts=False,
              lfnst=False, ts_max=0, sdh=False):
    """The smallest relative margins of K5's float decisions on these inputs,
    from the port's plain pieces: (zeroing margin of every candidate's
    coefficients, as ``quant_margins``; the gap between the winning
    candidate's cost and the runner-up's; the gap between the winner's and
    the zero TU's; ``sdh_gaps`` of every candidate). A cost is recomputed in
    float64 from the exact SSE; where both costs of a pair have SSE below
    2^24, the JAX package's float32 sums are exact too and it compares the
    same float32 values as the port, ties included: that gap counts as
    infinite."""
    from pmp_vvc_tpu_torch.ops.lfnst_generic import fwd_lfnst_generic
    cands, resid, inside, ok, _ = ttq.tq_mts_candidates(
        orgs, pred, rows, pad, qp, BD, True, lam, modes, mip_code, mts, lfnst, ts_max, sdh)
    fi, xs, ys, ws, hs, _, _ = (torch.from_numpy(a) for a in _unpack(rows.numpy(), 1))
    margins, gaps = [], []
    coef2 = ttq.forward_transform_generic(resid, ws, hs, bit_depth=BD)
    for lev, rr, cost, tr, lf in cands:
        if tr == 1:
            continue                        # transform skip: no zeroing, no SDH
        kw, kh = next(c[1] for c in ttq.MTS_COMBOS if c[0] == tr)
        coef = ttq.forward_transform_generic(resid, ws, hs, bit_depth=BD, kind_w=kw,
                                             kind_h=kh) if not lf else \
            fwd_lfnst_generic(coef2, modes, ws, hs, lf)
        m, _, g = quant_margins(coef, ws, hs, qp, lam, ok, sdh)
        margins += m
        gaps += g
    lam32 = float(np.float32(lam))
    sse = []
    for lev, rr, cost, tr, lf in cands:
        e = ((rr - resid) * inside).double()
        sse.append((e * e).sum((-1, -2)))
    sse = torch.stack(sse, 1)
    bins = torch.tensor([next((c[2] for c in ttq.MTS_COMBOS if c[0] == tr), 1.0)
                         if not lf else 2.0 for _, _, _, tr, lf in cands], dtype=torch.float64)
    bits = torch.stack([ttq.bits_proxy(c[0]).double() for c in cands], 1)
    legal = torch.stack([torch.isfinite(c[2]) for c in cands], 1)
    cost = torch.where(legal, sse + lam32 * (bits + bins), torch.inf)
    exact = sse < 2 ** 24
    k = torch.stack([c[2] for c in cands], 1).argmin(1)
    rows_b = torch.arange(len(k))
    win, win_exact = cost[rows_b, k], exact[rows_b, k]
    rel = lambda a, b: (a - b).abs() / torch.maximum(a.abs(), b.abs())
    cand_gap = torch.where(legal & (win_exact[:, None] & exact).logical_not(),
                           rel(cost, win[:, None]), torch.inf)
    cand_gap[rows_b, k] = torch.inf
    sse0 = (resid.double() ** 2).sum((-1, -2))
    zero_gap = torch.where(win_exact & (sse0 < 2 ** 24), torch.inf,
                           rel(sse0 + 2 * lam32, win))
    small = lambda t: float(t[ok].min()) if ok.any() else np.inf
    return (min(float(m.min()) if m.numel() else np.inf for m in margins),
            small(cand_gap.min(1).values), small(zero_gap), gaps)


def tq_inputs(pad, scale, seed):
    rows = size_rows(pad, scale, seed=seed)
    _, org, _ = planes(seed=seed, scale=scale)
    rng = np.random.RandomState(seed)
    B = len(rows)
    fi, xs, ys, ws, hs, _, _ = _unpack(rows, scale)
    d = np.arange(pad)
    tile = org[fi[:, None, None], np.clip(ys[:, None, None] + d[None, :, None], 0, org.shape[1] - 1),
               np.clip(xs[:, None, None] + d[None, None, :], 0, org.shape[2] - 1)]
    noise = rng.randn(B, pad, pad) * rng.choice([2, 10, 60, 400], B)[:, None, None]
    pred = np.clip(tile + noise, 0, 1023)
    # extreme residuals: a full-swing checkerboard against a flat prediction
    pred[0] = 0
    org[fi[0], ys[0]:ys[0] + hs[0], xs[0]:xs[0] + ws[0]] = \
        1023 * ((np.add.outer(np.arange(hs[0]), np.arange(ws[0]))) % 2)
    return rows, org.astype(np.int32), pred.astype(np.int32)


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("pad,scale", [(32, 1), (64, 1), (16, 2), (32, 2)])
def test_tq_matches_jax(pad, scale, qp):
    from pmp_vvc_tpu_torch.codec.encoder import FrameEncoder
    from pmp_vvc_tpu_torch.codec.headers import VVCConfig
    enc = FrameEncoder(VVCConfig(width=256, height=192, qp=qp, dual_tree=True,
                                 chroma_qp_start_minus26=-9,
                                 chroma_qp_points=((9, 12), (4, 5), (11, 7))))
    lam, dw = enc.lam, (None if scale == 1 else enc.dw_c)
    qpi = qp + 12 if scale == 1 else \
        int(enc.qp_table[qp + enc.qp_bd_offset]) + enc.qp_bd_offset
    rows, org, pred = tq_inputs(pad, scale, seed=qp + pad + scale)
    margin, _ = tq_margin(_t(org), _t(pred), rows, pad, scale, qpi, lam, dw)
    assert margin > MARGIN, margin
    fi, xs, ys, ws, hs, _, ok = _unpack(rows, scale)
    d = np.arange(pad)
    orgs = jwf._gather_plane(_j(org), _j(fi)[:, None, None],
                             _j(ys)[:, None, None] + d[None, :, None],
                             _j(xs)[:, None, None] + d[None, None, :])
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    if dw is None:
        want_l, want_r, _, _ = _jtq_luma(orgs, _j(pred), _j(ws), _j(hs), qpi,
                                                BD, lam, True, _j(inside), False)
    else:
        want_l, want_r = _jtq_chroma(orgs, _j(pred), _j(ws), _j(hs), qpi, BD,
                                         lam, dw, True, _j(inside))
    got_l, got_r = luma_or_chroma_tq([_t(org)], _t(pred[None]), _t(rows), pad, scale, qpi,
                                     lam, dw)
    want_l, want_r = np.asarray(want_l), np.asarray(want_r)
    m = inside & ok[:, None, None]
    np.testing.assert_array_equal(got_l[0].numpy()[m], want_l[m])
    np.testing.assert_array_equal(got_r[0].numpy()[m], want_r[m])
    assert not got_l[0].numpy()[~m].any() and not got_r[0].numpy()[~m].any()
    assert (want_l[m] != 0).any() and (want_l[m] == 0).any()


def test_jax_exp2_divisor_stays_within_the_margin():
    """rd_cleanup_generic divides the gains by jnp.exp2(2*tShift - sqrt2),
    which XLA need not compute exactly at integers; the port divides by the
    exact power of two. Over the exponents 10-bit CU sizes 2..64 give, the
    JAX divisor stays within MARGIN / 2 of it, so a decision that keeps a
    margin above MARGIN rounds alike in both."""
    exps = np.arange(-3, 9, dtype=np.int32)
    got = np.asarray(jax.jit(lambda e: jnp.exp2(e.astype(jnp.float32)))(_j(exps)))
    rel = np.abs(got.astype(np.float64) / np.ldexp(1.0, exps) - 1)
    assert rel.max() < MARGIN / 2, rel


@pytest.mark.parametrize("qp", [12, 34, 49])
def test_transform_and_quant_stages_match_jax(qp):
    rng = np.random.RandomState(qp)
    sizes = np.array([(w, h) for w in SIZES for h in SIZES], np.int32)
    ws, hs = sizes[:, 0], sizes[:, 1]
    x = rng.randint(-1023, 1024, (len(sizes), 64, 64)).astype(np.int32)
    x *= (np.arange(64)[None, :, None] < hs[:, None, None]) & \
        (np.arange(64)[None, None, :] < ws[:, None, None])
    c_j = jtq.forward_transform_generic(_j(x), _j(ws), _j(hs), bit_depth=BD)
    c_t = ttq.forward_transform_generic(_t(x), _t(ws), _t(hs), bit_depth=BD)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    l_j = jtq.quantize_generic(c_j, _j(ws), _j(hs), qp, bit_depth=BD)
    l_t = ttq.quantize_generic(c_t, _t(ws), _t(hs), qp, bit_depth=BD)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    big = np.clip(rng.randint(-40000, 40000, x.shape), -32768, 32767).astype(np.int32)
    for lev in (np.asarray(l_j), big):
        d_j = jtq.dequantize_generic(_j(lev), _j(ws), _j(hs), qp, bit_depth=BD)
        d_t = ttq.dequantize_generic(_t(lev), _t(ws), _t(hs), qp, bit_depth=BD)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        r_j = jtq.inverse_transform_generic(d_j, _j(ws), _j(hs), bit_depth=BD)
        r_t = ttq.inverse_transform_generic(d_t, _t(ws), _t(hs), bit_depth=BD)
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    s_j = jtq.satd_generic(_j(x[:, None]), _j(np.zeros_like(x)[:, None]), _j(ws), _j(hs))
    s_t = ttq.satd_generic(_t(x[:, None]), _t(np.zeros_like(x)[:, None]), _t(ws), _t(hs))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert INV_QUANT_SCALES.shape == (2, 6) and IQUANT_SHIFT == 6


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_tr_matrices_match_jax(kind):
    n = np.array([4, 8, 16, 32] + ([64] if kind == 0 else []), np.int32)
    for pad in (32, 64):
        want = np.asarray(jtq.tr_matrices(kind, _j(n), pad))
        np.testing.assert_array_equal(ttq.tr_matrices(kind, _t(n), pad).numpy(), want)
