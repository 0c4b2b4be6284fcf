"""The port's candidate transform-quantisation (K5: MTS, LFNST, transform
skip) and K4's single-tree LFNST region against the JAX package, op by op on
the CPU.

1. ``lfnst_params_generic`` equal to the JAX function for all 67 modes on
   every (w, h) of the 32- and 64-pad classes (wide-angle remaps included),
   and the port's per-TU ``lfnst_params`` equal to both.
2. ``fwd_lfnst_generic`` and ``inv_lfnst_generic`` equal to the JAX ones on
   every (w, h) of both classes, all 67 modes (so all four kernel sets, plain
   and transposed), both indices, on coefficients up to full swing (the
   inverse clip and the dropped slots).
3. ``tq_mts_reference`` equal to ``wavefront.py:_tq_luma_mts`` (levels,
   recon, mts_idx, lfnst_idx) with MTS, LFNST, transform skip and sign-data
   hiding on and off, at QP 22/32/37, in both classes (MTS and transform skip
   only in the 32-pad class, as ``_wave_scan`` gates them), with MIP codes
   that close LFNST for some CUs; every float decision keeps its margin
   (``k5_margin``), and with all tools every candidate kind wins for some CU:
   DST-7/DCT-8, LFNST, transform skip, DCT-2 and the zero TU.
4. ``tq_reference`` with ``lfnst_active`` equal to ``_tq_generic`` with the
   LFNST region (``lev_region``) of ``_chroma_part``.

The CUDA kernels run only on the card; chip_smoke.py holds them against these
plain versions there.
"""
import itertools

import numpy as np
import pytest
import torch

import jax

from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.ops import lfnst_generic as jlf
from pmp_vvc_tpu.ops.lfnst import _DIAG4
from pmp_vvc_tpu_torch.ops import lfnst_generic as tlf
from pmp_vvc_tpu_torch.ops import tq_generic as ttq
from pmp_vvc_tpu_torch.ops.lfnst import lfnst_params
from test_torch_codec_ops import BD, MARGIN, _j, _t, _unpack, k5_margin, planes, size_rows

torch.set_num_threads(2)

_jparams = jax.jit(jlf.lfnst_params_generic)
_jfwd = jax.jit(jlf.fwd_lfnst_generic, static_argnums=(4,))
_jinv = jax.jit(jlf.inv_lfnst_generic, static_argnums=(4,))
_jtq_luma = jax.jit(jwf._tq_luma_mts, static_argnums=(4, 5, 6, 7, 9),
                    static_argnames=("lfnst", "sdh", "ts_max"))
_jtq_chroma = jax.jit(jwf._tq_generic, static_argnums=(4, 5, 6, 7, 8),
                      static_argnames=("sdh",))

KINDS = ("DCT-2", "DST-7/DCT-8", "LFNST", "transform skip", "zero TU")


def class_sizes(pad):
    sides = [s for s in (4, 8, 16, 32, 64) if s <= pad]
    return [(w, h) for w, h in itertools.product(sides, sides)
            if pad == 32 or max(w, h) > 32]


def _sweep(pad):
    """Every (w, h) of the class with each of the 67 modes."""
    sizes = class_sizes(pad)
    ws = np.repeat([s[0] for s in sizes], 67).astype(np.int32)
    hs = np.repeat([s[1] for s in sizes], 67).astype(np.int32)
    modes = np.tile(np.arange(67, dtype=np.int32), len(sizes))
    return modes, ws, hs


@pytest.mark.parametrize("pad", [32, 64])
def test_lfnst_params_generic_matches_jax(pad):
    modes, ws, hs = _sweep(pad)
    want_s, want_t = (np.asarray(a) for a in _jparams(_j(modes), _j(ws), _j(hs)))
    got_s, got_t = tlf.lfnst_params_generic(_t(modes), _t(ws), _t(hs))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    # the per-TU version agrees with the batched one
    assert [lfnst_params(int(m), int(w), int(h)) for m, w, h in zip(modes, ws, hs)] == \
        list(zip(want_s.tolist(), want_t.tolist()))
    # all four kernel sets in the sweep, the three angular ones plain and
    # transposed (set 0, planar and DC, is never transposed)
    assert set(zip(want_s.tolist(), want_t.tolist())) == \
        {(s, t) for s in range(4) for t in (False, True)} - {(0, True)}


@pytest.mark.parametrize("idx", [1, 2])
@pytest.mark.parametrize("pad", [32, 64])
def test_lfnst_forward_and_inverse_match_jax(pad, idx):
    modes, ws, hs = _sweep(pad)
    rng = np.random.RandomState(pad + idx)
    coef = rng.randint(-40000, 40001, (len(modes), pad, pad)).astype(np.int32)
    coef[::3] //= 64                          # small coefficients too
    want = np.asarray(_jfwd(_j(coef), _j(modes), _j(ws), _j(hs), idx))
    got = tlf.fwd_lfnst_generic(_t(coef), _t(modes), _t(ws), _t(hs), idx).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(_jinv(_j(coef), _j(modes), _j(ws), _j(hs), idx))
    got = tlf.inv_lfnst_generic(_t(coef), _t(modes), _t(ws), _t(hs), idx).numpy()
    np.testing.assert_array_equal(got, want)
    # the inverse clip is reached, and nothing lands outside the 8x8 region
    assert (np.abs(got) == 1 << 15).any()
    assert not got[:, 8:].any() and not got[:, :, 8:].any()


def k5_inputs(pad, qp, seed):
    """Rows of every CU size of the class (twice), originals, and predictions
    of four kinds, a quarter of the rows each: noisy (DCT-2 and DST-7/DCT-8
    win), sparse +-300 impulses (transform skip wins), one LFNST basis
    function for the row's mode and idx 1 or 2 (LFNST wins), and +-2 noise
    (the zero TU wins); random modes, and MIP codes on a third of the rows,
    which close LFNST on the MIP CUs below 16x16."""
    from pmp_vvc_tpu_torch.ops.tq_generic import _orgs_inside
    rows = np.concatenate([size_rows(pad, 1, seed=seed + k, extra_pad_rows=0)
                           for k in range(2)] + [np.zeros((2, 8), np.int32)])
    _, org, _ = planes(seed=seed)
    rng = np.random.RandomState(seed)
    B = len(rows)
    tile, inside, ws, hs, _ = _orgs_inside(_t(org), _t(rows), pad, 1)
    modes = rng.randint(0, 67, B).astype(np.int32)
    codes = ((rng.rand(B) < 0.3) * rng.randint(1, 33, B)).astype(np.int32)
    sec = np.zeros((B, pad, pad), np.int32)
    sec[:, 0, 0] = rng.choice([-1, 1], B) * rng.randint(2000, 8000, B)
    sec[:, 1, 0] = rng.randint(-3000, 3000, B)
    basis = torch.cat([tlf.inv_lfnst_generic(_t(sec[b:b + 1]), _t(modes[b:b + 1]),
                                             ws[b:b + 1], hs[b:b + 1], 1 + b % 2)
                       for b in range(B)])
    basis = ttq.inverse_transform_generic(basis, ws, hs, bit_depth=BD).numpy()
    kind = (np.arange(B) % 4)[:, None, None]
    resid = np.select([kind == 0, kind == 1, kind == 2],
                      [rng.randint(-300, 301, (B, pad, pad)),
                       (rng.rand(B, pad, pad) < 0.03) * rng.choice([-300, 300], (B, pad, pad)),
                       -basis],
                      rng.randint(-2, 3, (B, pad, pad)))
    pred = np.clip(tile.numpy() + resid, 0, 1023).astype(np.int32)
    return rows, org, pred, modes, codes


def k5_kinds(lev, tr, lf, ok):
    coded = (lev != 0).reshape(len(lev), -1).any(1)
    kind = np.where(~coded, 4, np.where(lf > 0, 2, np.where(tr == 1, 3, np.where(tr >= 2, 1, 0))))
    return np.bincount(kind[ok], minlength=5)


TOOLS = {"all": (True, True, 32, True), "mts": (True, False, 0, False),
         "lfnst+sdh": (False, True, 0, True), "ts": (False, False, 32, False)}


@pytest.mark.parametrize("tools", list(TOOLS))
@pytest.mark.parametrize("qp", [22, 32, 37])
@pytest.mark.parametrize("pad", [32, 64])
def test_tq_mts_reference_matches_jax(pad, qp, tools):
    mts, lfnst, ts_max, sdh = TOOLS[tools]
    if pad == 64:                         # _wave_scan's class gates
        mts, ts_max = False, 0
    lam, qpi = 0.57 * 2 ** ((qp - 12) / 3), qp + 12
    rows, org, pred, modes, codes = k5_inputs(pad, qp, seed=pad + qp)
    zeroing, cand, zero, gaps = k5_margin(
        [_t(org)], _t(pred[None]), _t(rows), pad, qpi, lam, _t(modes), _t(codes),
        mts, lfnst, ts_max, sdh)
    assert min(zeroing, cand, zero) > MARGIN, (zeroing, cand, zero)
    assert not gaps or min(gaps) > MARGIN, min(gaps)
    fi, xs, ys, ws, hs, _, ok = _unpack(rows, 1)
    d = np.arange(pad)
    orgs = jwf._gather_plane(_j(org), _j(fi)[:, None, None],
                             _j(ys)[:, None, None] + d[None, :, None],
                             _j(xs)[:, None, None] + d[None, None, :])
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    lfnst_ok = ~((codes > 0) & ~((ws >= 16) & (hs >= 16)))
    want = [np.asarray(a) for a in _jtq_luma(
        orgs, _j(pred), _j(ws), _j(hs), qpi, BD, lam, True, _j(inside), mts, lfnst=lfnst,
        modes=_j(modes), lfnst_ok=_j(lfnst_ok), sdh=sdh, ts_max=ts_max)]
    got = [a.numpy() for a in ttq.tq_mts_reference(
        [_t(org)], _t(pred[None]), _t(rows), pad, qpi, BD, True, lam, _t(modes), _t(codes),
        mts, lfnst, ts_max, sdh)]
    m = inside & ok[:, None, None]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g[0][m], w[m])
        assert not g[0][~m].any()
    np.testing.assert_array_equal(got[2][ok], want[2][ok])
    np.testing.assert_array_equal(got[3][ok], want[3][ok])
    won = k5_kinds(got[0][0], got[2], got[3], ok)
    if tools == "all":
        need = KINDS if pad == 32 else ("DCT-2", "LFNST", "zero TU")
        assert all(won[KINDS.index(k)] for k in need), dict(zip(KINDS, won))
    # an LFNST winner is never a MIP CU below 16x16
    assert not (got[3][ok] & ~lfnst_ok[ok]).any()


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("pad", [16, 32])
def test_tq_with_lfnst_region_matches_jax(pad, qp):
    """Chroma K4 with the single-tree LFNST region on every other CU."""
    from test_torch_codec_ops import tq_inputs, tq_margin
    lam, dw, qpi = 0.57 * 2 ** ((qp - 12) / 3), 1.2599, qp + 12
    rows, org, pred = tq_inputs(pad, 2, seed=qp + pad)
    active = (np.arange(len(rows)) % 2 * np.arange(len(rows)) % 3).astype(np.int32)
    margin, gaps = tq_margin(_t(org), _t(pred), rows, pad, 2, qpi, lam, dw, True,
                             _t(active))
    assert margin > MARGIN and (not gaps or min(gaps) > MARGIN), (margin, gaps)
    fi, xs, ys, ws, hs, _, ok = _unpack(rows, 2)
    d = np.arange(pad)
    orgs = jwf._gather_plane(_j(org), _j(fi)[:, None, None],
                             _j(ys)[:, None, None] + d[None, :, None],
                             _j(xs)[:, None, None] + d[None, None, :])
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    # _chroma_part's region, built as the JAX package builds it
    diag = np.full((pad, pad), 99, np.int32)
    for k, (y, x) in enumerate(_DIAG4):
        diag[y, x] = k
    small = ((ws == 4) & (hs == 4)) | ((ws == 8) & (hs == 8))
    no_gate = (active == 0) | (ws < 4) | (hs < 4)
    region = (diag[None] < np.where(small, 8, 16)[:, None, None]) | no_gate[:, None, None]
    want_l, want_r = (np.asarray(a) for a in _jtq_chroma(
        orgs, _j(pred), _j(ws), _j(hs), qpi, BD, lam, dw, True, _j(inside),
        lev_region=_j(region), sdh=True))
    got_l, got_r = ttq.tq_reference([_t(org)], _t(pred[None]), _t(rows), pad, 2, qpi, BD,
                                    True, lam, dw, True, _t(active))
    plain_l, _ = ttq.tq_reference([_t(org)], _t(pred[None]), _t(rows), pad, 2, qpi, BD,
                                  True, lam, dw, True)
    m = inside & ok[:, None, None]
    np.testing.assert_array_equal(got_l[0].numpy()[m], want_l[m])
    np.testing.assert_array_equal(got_r[0].numpy()[m], want_r[m])
    assert (got_l != plain_l).any()           # the region removed levels
    assert not got_l[0].numpy()[~region].any()
