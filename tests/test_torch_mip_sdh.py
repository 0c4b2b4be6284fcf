"""The port's MIP (K3) and sign-data hiding (inside K4 and K5) against the JAX
package, op by op on the CPU.

1. ``predict_mip_generic`` equal to the JAX function for every size of
   ``test_mip_generic.SIZES`` (random and full-swing boundaries) and on a
   batched mixed-size input.
2. The luma wave step with MIP and sign-data hiding (K1 -> K2 -> K3 -> K5 ->
   K7) against ``_make_class_apply(kind="luma", mip=True, sdh=True)`` at the
   32- and 64-pad classes, every CU size in a cell of its own: all 11 state
   planes equal, MIP winning for some CUs and losing for others.
3. ``apply_sdh_generic`` and ``_cg_tables`` equal to the JAX ones on seeded
   levels of every (w, h), full-swing coefficients included.
4. The plain DCT-2 TQ with sign-data hiding, luma (``tq_mts_reference``
   with its tools off) against ``_tq_luma_mts(mts=False, sdh=True)`` and
   chroma (``tq_reference``) against ``_tq_generic(sdh=True)``, at QP
   22/32/37.

Every DCT-2 TQ decision, sign-data hiding's included, keeps a relative margin
above MARGIN, and every MIP decision's SATDs stay below 2^24 (the
``margins`` fixture and ``tq_margin``).
"""
import itertools

import numpy as np
import pytest
import torch

import jax

from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.ops import mip_generic as jmip
from pmp_vvc_tpu.ops import sdh_generic as jsdh
from pmp_vvc_tpu.ops.mip import num_modes
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.ops import mip_generic as tmip
from pmp_vvc_tpu_torch.ops import sdh_generic as tsdh
from pmp_vvc_tpu_torch.ops import tq_generic as ttq
from test_mip_generic import SIZES
from test_torch_codec_ops import (BD, MARGIN, _j, _t, _unpack, luma_or_chroma_tq, planes,
                                  tq_inputs, tq_margin)
from test_torch_wavefront import margins  # noqa: F401  (fixture)

torch.set_num_threads(2)

_jmip = jax.jit(jmip.predict_mip_generic, static_argnames=("pad", "bit_depth"))
_jsdh = jax.jit(jsdh.apply_sdh_generic, static_argnums=(4,))
_jtq_luma = jax.jit(jwf._tq_luma_mts, static_argnums=(4, 5, 6, 7, 9),
                    static_argnames=("sdh",))
_jtq_chroma = jax.jit(jwf._tq_generic, static_argnums=(4, 5, 6, 7, 8),
                      static_argnames=("sdh",))


def _i32(*v):
    return np.array(v, np.int32)


# ---------------------------------------------------------------------------
# the plain MIP predictor
# ---------------------------------------------------------------------------

def _check_mip(top, left, ws, hs, pad):
    want, wn = _jmip(_j(top), _j(left), _j(ws), _j(hs), pad=pad)
    got, gn = tmip.predict_mip_generic(_t(top), _t(left), _t(ws), _t(hs), pad=pad)
    want, got = np.asarray(want), got.numpy()
    for b, (w, h) in enumerate(zip(ws, hs)):
        n = num_modes(int(w), int(h))
        assert int(gn[b]) == int(wn[b]) == n
        idx = [t * tmip.MAX_MODES + m for t in range(2) for m in range(n)]
        np.testing.assert_array_equal(got[b, idx, :h, :w], want[b, idx, :h, :w],
                                      err_msg=f"{w}x{h}")


@pytest.mark.parametrize("w,h", SIZES)
def test_predict_mip_generic_matches_jax(w, h):
    pad = 32 if max(w, h) <= 32 else 64
    rng = np.random.RandomState(w * 131 + h)
    top = rng.randint(0, 1024, (2, 2 * pad + 3)).astype(np.int32)
    left = rng.randint(0, 1024, (2, 2 * pad + 3)).astype(np.int32)
    # the second row full swing: 0 and 1023 alternating on both sides
    top[1] = 1023 * (np.arange(2 * pad + 3) % 2)
    left[1] = 1023 - top[1]
    _check_mip(top, left, _i32(w, w), _i32(h, h), pad)


def test_predict_mip_generic_batched_mixed_sizes():
    rng = np.random.RandomState(0)
    for pad in (32, 64):
        sizes = [s for s in SIZES if max(s) <= pad]
        top = rng.randint(0, 1024, (len(sizes), 2 * pad + 3)).astype(np.int32)
        left = rng.randint(0, 1024, (len(sizes), 2 * pad + 3)).astype(np.int32)
        _check_mip(top, left, _i32(*(s[0] for s in sizes)), _i32(*(s[1] for s in sizes)), pad)


# ---------------------------------------------------------------------------
# the luma wave step with MIP and sign-data hiding
# ---------------------------------------------------------------------------

def cell_rows(pad, seed, width=256, height=192):
    """(B, 8) rows: every CU size of the pad class, each in a cell of its own
    (CUs of one step never overlap), flush with the cell's top-left or
    bottom-right corner; random order ids; then two padding rows."""
    rng = np.random.RandomState(seed)
    sides = [s for s in (4, 8, 16, 32, 64) if s <= pad]
    sizes = [(w, h) for w, h in itertools.product(sides, sides)
             if pad == 32 or max(w, h) > 32]
    cells = rng.permutation((width // pad) * (height // pad))
    rows = []
    for i, (w, h) in enumerate(sizes):
        cy, cx = divmod(int(cells[i]), width // pad)
        x, y = cx * pad + (i % 2) * (pad - w), cy * pad + (i % 2) * (pad - h)
        rows.append((rng.randint(2), x, y, w, h, rng.randint(0, 400), 1, 0))
    rows += [(0, 0, 0, 0, 0, 0, 0, 0)] * 2
    return np.array(rows, np.int32)


@pytest.mark.parametrize("pad", [32, 64])
def test_luma_step_with_mip_and_sdh_matches_make_class_apply(pad, margins):
    qp = 22
    lam, dw_c = 0.57 * 2 ** ((qp - 12) / 3), 1.2599
    rows = cell_rows(pad, seed=pad)
    rec, org, og = planes(seed=pad + 1)
    rng = np.random.RandomState(pad)
    F, H, W = rec.shape
    z = lambda shape, dt: np.zeros(shape, dt)
    state = [rec, z((F, H // 2, W // 2), np.int32), z((F, H // 2, W // 2), np.int32),
             z((F, H, W), np.int16), z((F, H // 2, W // 2), np.int16),
             z((F, H // 2, W // 2), np.int16),
             rng.randint(0, 67, (F, H // 4, W // 4)).astype(np.uint8)] + \
        [z((F, H // 4, W // 4), np.uint8) for _ in range(4)]
    orgs = [org, z((F, H // 2, W // 2), np.int32), z((F, H // 2, W // 2), np.int32)]
    f = jax.jit(jwf._make_class_apply(pad, len(rows), qp + 12, qp + 12, BD, lam, dw_c,
                                      True, kind="luma", mip=True, sdh=True))
    want = f(tuple(_j(s) for s in state), _j(rows), *(_j(o) for o in orgs), _j(og), _j(og))
    tstate = [torch.from_numpy(s.copy()) for s in state]
    scan = twf._Scan(tstate, *(_t(o) for o in orgs), _t(og), _t(og), qp + 12, qp + 12, BD,
                     lam, dw_c, True, mip=True, sdh=True)
    scan.step("luma", pad, _t(rows))
    for i, (a, b) in enumerate(zip(tstate, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"plane {i}")
    live = rows[rows[:, 6] > 0]
    codes = tstate[8].numpy()[live[:, 0], live[:, 2] // 4, live[:, 1] // 4]
    assert (codes > 0).any() and (codes == 0).any(), codes
    modes = tstate[6].numpy()[live[:, 0], live[:, 2] // 4, live[:, 1] // 4]
    assert (modes[codes > 0] == 0).all()
    assert margins["mip"] and margins["sdh"]


# ---------------------------------------------------------------------------
# sign-data hiding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [16, 32, 64])
def test_cg_tables_match_jax(P):
    np.testing.assert_array_equal(tsdh._cg_tables(P), jsdh._cg_tables(P))


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("P", [16, 32, 64])
def test_apply_sdh_matches_jax(P, qp):
    """Every (w, h) of the pad; coefficients from sparse to full swing
    (|c| up to 2^15 - 1, levels up to the clip)."""
    rng = np.random.RandomState(P + qp)
    sides = [s for s in (2, 4, 8, 16, 32, 64) if s <= P]
    sizes = list(itertools.product(sides, sides))
    B = len(sizes)
    coef = np.zeros((B, P, P), np.int32)
    ws, hs = _i32(*(s[0] for s in sizes)), _i32(*(s[1] for s in sizes))
    for b, (w, h) in enumerate(sizes):
        amp = [60, 600, 6000, 32767][b % 4]
        c = rng.randint(-amp, amp + 1, (h, w)) * (rng.rand(h, w) < [0.3, 0.6, 1.0][b % 3])
        coef[b, :h, :w] = c
    lev = ttq.quantize_generic(_t(coef), _t(ws), _t(hs), qp + 12, bit_depth=BD)
    want = np.asarray(_jsdh(_j(lev.numpy()), _j(coef), _j(ws), _j(hs), qp + 12))
    got = tsdh.apply_sdh_generic(lev.int(), _t(coef), _t(ws), _t(hs), qp + 12,
                                 bit_depth=BD).numpy()
    np.testing.assert_array_equal(got, want)
    changed = (got != lev.numpy()).sum()
    assert changed > 0 and np.abs(got - lev.numpy()).max() == 1


@pytest.mark.parametrize("qp", [22, 32, 37])
@pytest.mark.parametrize("pad,scale", [(32, 1), (64, 1), (16, 2), (32, 2)])
def test_tq_with_sdh_matches_jax(pad, scale, qp):
    lam = 0.57 * 2 ** ((qp - 12) / 3)
    dw = None if scale == 1 else 1.2599
    qpi = qp + 12
    rows, org, pred = tq_inputs(pad, scale, seed=qp + pad + scale + 1)
    margin, gaps = tq_margin(_t(org), _t(pred), rows, pad, scale, qpi, lam, dw, sdh=True)
    assert margin > MARGIN, margin
    assert gaps and min(gaps) > MARGIN, gaps
    fi, xs, ys, ws, hs, _, ok = _unpack(rows, scale)
    d = np.arange(pad)
    orgs = jwf._gather_plane(_j(org), _j(fi)[:, None, None],
                             _j(ys)[:, None, None] + d[None, :, None],
                             _j(xs)[:, None, None] + d[None, None, :])
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    if dw is None:
        want_l, want_r, _, _ = _jtq_luma(orgs, _j(pred), _j(ws), _j(hs), qpi, BD, lam,
                                         True, _j(inside), False, sdh=True)
    else:
        want_l, want_r = _jtq_chroma(orgs, _j(pred), _j(ws), _j(hs), qpi, BD, lam, dw,
                                     True, _j(inside), sdh=True)
    args = ([_t(org)], _t(pred[None]), _t(rows), pad, scale, qpi, lam, dw)
    got_l, got_r = luma_or_chroma_tq(*args, sdh=True)
    plain_l, _ = luma_or_chroma_tq(*args)
    want_l, want_r = np.asarray(want_l), np.asarray(want_r)
    m = inside & ok[:, None, None]
    np.testing.assert_array_equal(got_l[0].numpy()[m], want_l[m])
    np.testing.assert_array_equal(got_r[0].numpy()[m], want_r[m])
    assert not got_l[0].numpy()[~m].any() and not got_r[0].numpy()[~m].any()
    assert (got_l != plain_l).any()          # sign-data hiding changed levels
