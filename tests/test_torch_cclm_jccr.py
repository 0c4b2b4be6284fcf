"""CCLM (K6a) and the joint Cb-Cr trial (K6c, inside K4): the port's plain
versions against the JAX package's, on the CPU.

1. ``cclm_predict_generic`` against the JAX function on
   test_cclm_generic.py's CASES and on CTU-top, right and bottom frame edge
   and two-sample geometries, with every left/above availability pair, on
   random, flat (a flat template) and steep (the slope clamped to +-15)
   content: exactly.
2. ``cclm_select_reference`` against the DM-vs-LM choice of
   ``_chroma_part`` (514-541) written with the JAX functions: LM winning, DM
   winning, an exact SATD tie (DM keeps it) and the CCLM gate off.
3. ``tq_reference(jccr=True)`` against ``_chroma_part``'s joint trial
   (598-633) written with the JAX functions, with sign-data hiding off and
   on and with the single-tree LFNST region: odd residual differences of both
   signs, the joint TU winning, losing and quantising to zero. Every float
   decision first keeps its margin (``tq_margin``, ``jccr_margin``).
4. One dual-tree chroma step and one single-tree step with CCLM and joint
   Cb-Cr on against ``_make_class_apply``: the 11 state planes equal, both
   code-grid bits set.
5. K7's plain version writing the code grid over a 64x64 chroma CU.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.ops import cclm as jcclm
from pmp_vvc_tpu.ops import tq_generic as jtq
from pmp_vvc_tpu.ops.cclm_generic import cclm_predict_generic as jax_cclm
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.ops import cclm_generic as tcclm
from pmp_vvc_tpu_torch.ops import tq_generic as ttq
from pmp_vvc_tpu_torch.ops.intra_generic import ref_gather_reference
from chip_smoke import chroma_tool_frames
from test_cclm_generic import CASES, _refs_line
from test_torch_codec_ops import MARGIN, jccr_margin, size_rows, tq_margin
from test_torch_wavefront import MTT, _leaves, margins  # noqa: F401  (fixture)
from test_wavefront import _mtt_maps

torch.set_num_threads(2)

BD = 10
W, H = 192, 128
_jcclm = jax.jit(jax_cclm, static_argnames=("pad_c", "bit_depth", "ctu_size"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


# ---------------------------------------------------------------------------
# 1. the LM predictor
# ---------------------------------------------------------------------------

EDGES = [
    (8, 64, 8, 2),         # CTU top row, a chroma side of 2
    (0, 64, 16, 4),        # CTU top row at the left frame edge
    (112, 80, 16, 16),     # right and bottom frame edges
    (126, 94, 2, 2),       # the corner; two samples from one side
]


def _cclm_content(kind, rng, cx, cy, H_=192, W_=256):
    """(luma recon, U, V) planes. "flat": one luma value, so the template is
    flat; "steep": luma 504 above the CU's top row and 500 from it on, chroma
    900 above and 100 from it on, so the slope (800 over 4) is clamped."""
    cu, cv = (rng.randint(0, 1024, (H_ // 2, W_ // 2)).astype(np.int32) for _ in range(2))
    if kind == "flat":
        return np.full((H_, W_), 700, np.int32), cu, cv
    if kind == "steep":
        ry = np.full((H_, W_), 500, np.int32)
        ry[:2 * cy] = 504
        for c in (cu, cv):
            c[:cy], c[cy:] = 900, 100
        return ry, cu, cv
    return rng.randint(0, 1024, (H_, W_)).astype(np.int32), cu, cv


@pytest.mark.parametrize("kind", ["random", "flat", "steep"])
@pytest.mark.parametrize("cx,cy,cw,ch", CASES + EDGES)
def test_cclm_predict_generic_matches_jax(cx, cy, cw, ch, kind):
    rng = np.random.RandomState(cx * 7 + cy * 13 + cw)
    ry, cu, cv = _cclm_content(kind, rng, cx, cy)
    pad_c = 16
    (tu, lu), (tv, lv) = (_refs_line(p, cx, cy, cw, ch, pad_c) for p in (cu, cv))
    for la, aa in [(True, True), (False, True), (True, False), (False, False)]:
        la, aa = la and cx > 0, aa and cy > 0
        want = _jcclm(jnp.asarray(ry)[None], jnp.asarray([0]), jnp.asarray([cx]),
                      jnp.asarray([cy]), jnp.asarray([cw]), jnp.asarray([ch]), pad_c=pad_c,
                      top_u=jnp.asarray(tu)[None], left_u=jnp.asarray(lu)[None],
                      top_v=jnp.asarray(tv)[None], left_v=jnp.asarray(lv)[None],
                      left_avail=jnp.asarray([la]), above_avail=jnp.asarray([aa]))
        got = tcclm.cclm_predict_generic(
            _t(ry)[None], _t([0]), _t([cx]), _t([cy]), _t([cw]), _t([ch]), pad_c=pad_c,
            top_u=_t(tu)[None], left_u=_t(lu)[None], top_v=_t(tv)[None], left_v=_t(lv)[None],
            left_avail=torch.tensor([la]), above_avail=torch.tensor([aa]))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy()[0, :ch, :cw],
                                          np.asarray(w_)[0, :ch, :cw], err_msg=str((la, aa)))
        if la and aa and kind != "random":
            # the content reaches the case it is named after (host oracle)
            interior, dsa, dsl = jcclm.downsample_luma(ry, cx, cy, cw, ch, la, aa, 128)
            a, _, sh = jcclm.lm_parameters(dsa, dsl, tu, lu, cw, ch, aa, la)
            assert (a, sh) == (0, 0) if kind == "flat" else (abs(a) == 15 and sh == 1)


# ---------------------------------------------------------------------------
# 2. DM against LM (K6a)
# ---------------------------------------------------------------------------

def _jax_choice(ry, refs, orgs, og, rows, pred, pad):
    """``_chroma_part``'s DM-vs-LM choice with the JAX functions."""
    r = jnp.asarray(rows)
    fi, xs, ys, ws, hs, oi, flg = (r[:, k] for k in (0, 1, 2, 3, 4, 5, 7))
    cxs, cys, cws, chs = xs // 2, ys // 2, ws // 2, hs // 2
    og4c = jnp.asarray(og)
    la = jwf._avail_from_order(og4c, fi, oi, jnp.maximum(cxs - 1, 0) * 2 // 4,
                               cys * 2 // 4, cxs > 0)
    aa = jwf._avail_from_order(og4c, fi, oi, cxs * 2 // 4,
                               jnp.maximum(cys - 1, 0) * 2 // 4, cys > 0)
    refs = jnp.asarray(refs)
    lm_u, lm_v = _jcclm(jnp.asarray(ry), fi, cxs, cys, cws, chs, pad_c=pad,
                        top_u=refs[0, 0], left_u=refs[0, 1], top_v=refs[1, 0],
                        left_v=refs[1, 1], left_avail=la, above_avail=aa)
    d = np.arange(pad)
    corg = [jwf._gather_plane(jnp.asarray(o), fi[:, None, None],
                              cys[:, None, None] + d[None, :, None],
                              cxs[:, None, None] + d[None, None, :]) for o in orgs]
    satd = lambda o, p: jtq.satd_generic(o[:, None], p[:, None], cws, chs)[:, 0]
    pred = jnp.asarray(pred)
    cost_dm = satd(corg[0], pred[0]) + satd(corg[1], pred[1])
    cost_lm = satd(corg[0], lm_u) + satd(corg[1], lm_v)
    use = (cost_lm < cost_dm) & ((flg & 1) > 0)
    chosen = jnp.where(use[None, :, None, None], jnp.stack([lm_u, lm_v]), pred)
    return np.asarray(chosen), np.asarray(use), np.asarray(cost_dm), np.asarray(cost_lm)


@pytest.mark.parametrize("pad", [16, 32])
def test_cclm_select_matches_the_jax_choice(pad):
    rng = np.random.RandomState(pad)
    y, u, v = chroma_tool_frames(256, 192, 1, seed0=pad)[0]
    ry = (y + rng.randint(-4, 5, y.shape))[None].clip(0, 1023).astype(np.int32)
    recs = [(p + rng.randint(-2, 3, p.shape))[None].clip(0, 1023).astype(np.int32)
            for p in (u, v)]
    orgs = [p[None].astype(np.int32) for p in (u, v)]
    rows = size_rows(pad, 2, seed=pad)
    rows[:, 0] = 0
    rows[:, 7] = rng.randint(0, 2, len(rows))            # the CCLM gate
    og = rng.randint(-1, 400, (1, 192 // 4, 256 // 4)).astype(np.int32)
    refs = ref_gather_reference([_t(r) for r in recs], _t(og), _t(rows), pad, 2, BD)
    # DM predictions: the originals with noise of +-2 or +-200 per CU
    fi, xs, ys = rows[:, 0], rows[:, 1] // 2, rows[:, 2] // 2
    d = np.arange(pad)
    amp = rng.choice([2, 200], len(rows))[:, None, None]
    pred = np.stack([np.clip(o[0][np.clip(ys[:, None, None] + d[None, :, None], 0, 95),
                                  np.clip(xs[:, None, None] + d[None, None, :], 0, 127)]
                             + rng.randint(-1, 2, (len(rows), pad, pad)) * amp, 0, 1023)
                     for o in orgs]).astype(np.int32)
    _, _, cost_dm, cost_lm = _jax_choice(ry, refs.numpy(), orgs, og, rows, pred, pad)
    tie = int(np.argmax(rows[:, 6]))                     # make one CU an exact tie
    lm, _ = tcclm.cclm_costs(refs, _t(ry), [_t(o) for o in orgs], _t(og), _t(rows),
                             _t(pred), pad, BD)[:2]
    pred[:, tie] = lm[:, tie].numpy()
    rows[tie, 7] = 1
    want_p, want_use, cost_dm, cost_lm = _jax_choice(ry, refs.numpy(), orgs, og, rows, pred, pad)
    got_p, got_use = tcclm.cclm_select(refs, _t(ry), [_t(o) for o in orgs], _t(og), _t(rows),
                                       _t(pred), pad, BD)
    ok = rows[:, 6] > 0
    np.testing.assert_array_equal(got_use.numpy()[ok], want_use[ok])
    for b in np.flatnonzero(ok):
        ch, cw = rows[b, 4] // 2, rows[b, 3] // 2
        np.testing.assert_array_equal(got_p.numpy()[:, b, :ch, :cw], want_p[:, b, :ch, :cw])
    assert not got_use.numpy()[~ok].any() and not got_p.numpy()[:, ~ok].any()
    gate = rows[:, 7] > 0
    lm_better = cost_lm < cost_dm
    assert (ok & lm_better & gate).any() and (ok & ~lm_better).any()
    assert (ok & lm_better & ~gate).any(), "no CU where the gate keeps DM"
    assert cost_dm[tie] == cost_lm[tie] and not got_use[tie]
    assert max(cost_dm.max(), cost_lm.max()) < 1 << 24


# ---------------------------------------------------------------------------
# 3. the joint Cb-Cr trial (K6c in K4)
# ---------------------------------------------------------------------------

@jax.jit
def _jax_round(res_u, res_v):
    return jnp.round((res_u - res_v) / 2.0).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8, 9))
def _jax_joint(corg, pred, cws, chs, c_in, qp_c, qp_j, lam, dw, sdh, region, crs=None):
    """``_chroma_part``'s separate U and V TUs and its joint trial (598-633)
    with the JAX functions, each TU with the LMCS chroma residual scales
    ``crs`` if given. Returns (lev, rec, use_joint, cbf_j)."""
    kw = dict(lev_region=region, sdh=sdh, crs=crs)
    lev_u, rec_u = jwf._tq_generic(corg[0], pred[0], cws, chs, qp_c, BD, lam, dw, True, c_in, **kw)
    lev_v, rec_v = jwf._tq_generic(corg[1], pred[1], cws, chs, qp_c, BD, lam, dw, True, c_in, **kw)
    joint_res = _jax_round((corg[0] - pred[0]) * c_in, (corg[1] - pred[1]) * c_in)
    lev_j, rec_ju, rr_j = jwf._tq_generic(pred[0] + joint_res, pred[0], cws, chs, qp_j, BD,
                                          lam, dw, True, c_in, return_rr=True, **kw)
    rec_jv = jnp.clip(pred[1] - rr_j, 0, (1 << BD) - 1)
    cbf_j = (lev_j != 0).any(axis=(-1, -2))

    def _sse(a, b):
        d = ((a - b) * c_in).astype(jnp.float32)
        return (d * d).sum(axis=(-1, -2))
    cbf_u = (lev_u != 0).any(axis=(-1, -2))
    cbf_v = (lev_v != 0).any(axis=(-1, -2))
    bits_s = jnp.where(cbf_u, jwf._bits_proxy(lev_u), 1.0) \
        + jnp.where(cbf_v, jwf._bits_proxy(lev_v), 1.0) + 1.0
    bits_j = jwf._bits_proxy(lev_j) + 3.0
    cost_s = dw * (_sse(rec_u, corg[0]) + _sse(rec_v, corg[1])) + lam * bits_s
    cost_j = dw * (_sse(rec_ju, corg[0]) + _sse(rec_jv, corg[1])) + lam * bits_j
    use = cbf_j & (cost_j < cost_s)
    uj = use[:, None, None]
    lev = jnp.stack([jnp.where(uj, lev_j, lev_u), jnp.where(uj, lev_j, lev_v)])
    rec = jnp.stack([jnp.where(uj, rec_ju, rec_u), jnp.where(uj, rec_jv, rec_v)])
    return lev, rec, use, cbf_j


def _jccr_inputs(pad, seed):
    """Rows of every chroma CU size; U and V originals and predictions whose
    residuals are anti-correlated (res_v = -res_u + small noise) on a third
    of the CUs, independent on another third, and equal up to small noise
    (a joint residual near zero) on the rest."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([size_rows(pad, 2, seed=seed + k) for k in (0, 100)])
    B = len(rows)
    fi, xs, ys = rows[:, 0], rows[:, 1] // 2, rows[:, 2] // 2
    orgs = [rng.randint(350, 674, (2, 96, 128)).astype(np.int32) for _ in range(2)]
    d = np.arange(pad)
    tile = lambda o: o[fi[:, None, None], np.clip(ys[:, None, None] + d[None, :, None], 0, 95),
                       np.clip(xs[:, None, None] + d[None, None, :], 0, 127)]
    kind = np.arange(B) % 3
    amp = rng.choice([20, 80, 300], B)[:, None, None]
    res_u = rng.randint(-1, 2, (B, pad, pad)) * amp
    res_v = np.where(kind[:, None, None] == 0, -res_u + rng.randint(-3, 4, (B, pad, pad)),
                     np.where(kind[:, None, None] == 1, rng.randint(-1, 2, (B, pad, pad)) * amp,
                              res_u + rng.randint(-2, 3, (B, pad, pad))))
    pred = np.stack([tile(orgs[0]) - res_u, tile(orgs[1]) - res_v]).clip(0, 1023)
    return rows, orgs, pred.astype(np.int32)


@pytest.mark.parametrize("region", [False, True])
@pytest.mark.parametrize("sdh", [False, True])
@pytest.mark.parametrize("pad", [16, 32])
def test_joint_cbcr_trial_matches_jax(pad, sdh, region):
    from pmp_vvc_tpu_torch.codec.encoder import FrameEncoder
    enc = FrameEncoder(VVCConfig(width=256, height=192, qp=32, dual_tree=True,
                                 joint_cbcr=True, chroma_qp_start_minus26=-9,
                                 chroma_qp_points=((9, 12), (4, 5), (11, 7))))
    lam, dw = float(enc.lam), float(enc.dw_c)
    qp_c = int(enc.qp_table[32 + enc.qp_bd_offset]) + enc.qp_bd_offset
    qp_j = qp_c - enc.cfg.chroma_qp_offset + enc.cfg.jccr_qp_offset
    rows, orgs, pred = _jccr_inputs(pad, seed=pad + 2 * sdh + region)
    B = len(rows)
    act = _t(np.random.RandomState(pad).randint(0, 2, B)) if region else None
    torgs = [_t(o) for o in orgs]
    for i in range(2):
        m, _ = tq_margin(torgs[i], _t(pred[i]), rows, pad, 2, qp_c, lam, dw, sdh, act)
        assert m > MARGIN, m
    m, _ = jccr_margin(torgs, _t(pred), rows, pad, 2, qp_c, qp_j, lam, dw, sdh, act)
    assert m > MARGIN, m

    fi, xs, ys, ws, hs = (rows[:, k] for k in range(5))
    cxs, cys, cws, chs = xs // 2, ys // 2, ws // 2, hs // 2
    d = np.arange(pad)
    c_in = (d[None, :, None] < chs[:, None, None]) & (d[None, None, :] < cws[:, None, None])
    corg = [jwf._gather_plane(jnp.asarray(o), jnp.asarray(fi)[:, None, None],
                              jnp.asarray(cys)[:, None, None] + d[None, :, None],
                              jnp.asarray(cxs)[:, None, None] + d[None, None, :]) for o in orgs]
    region_m = None if act is None else \
        jnp.asarray(ttq.lfnst_region(_t(cws), _t(chs), act.bool(), pad).numpy())
    want_l, want_r, want_use, cbf_j = (np.asarray(a) for a in _jax_joint(
        corg, jnp.asarray(pred), jnp.asarray(cws), jnp.asarray(chs), jnp.asarray(c_in),
        qp_c, qp_j, lam, dw, sdh, region_m))
    got_l, got_r, got_use = ttq.tq(torgs, _t(pred), _t(rows), pad, 2, qp_c, BD, True, lam, dw,
                                   sdh=sdh, lfnst_active=act, jccr=True, qp_j=qp_j)
    ok = rows[:, 6] > 0
    m = np.broadcast_to(c_in & ok[:, None, None], want_l.shape)
    np.testing.assert_array_equal(got_l.numpy()[m], want_l[m])
    np.testing.assert_array_equal(got_r.numpy()[m], want_r[m])
    np.testing.assert_array_equal(got_use.numpy()[ok], want_use[ok])
    assert not got_l.numpy()[~m].any() and not got_r.numpy()[~m].any()
    assert (want_use & ok).any() and (cbf_j & ~want_use & ok).any() and (~cbf_j & ok).any()
    diff = np.asarray((corg[0] - pred[0]) - (corg[1] - pred[1]))[c_in & ok[:, None, None]]
    assert ((diff % 2 == 1) & (diff > 0)).any() and ((diff % 2 == 1) & (diff < 0)).any()


# ---------------------------------------------------------------------------
# 4. one wave step with both tools
# ---------------------------------------------------------------------------

CONFIGS = {"st": dict(MTT, qp=32), "chroma": dict(MTT, qp=32, dual_tree=True)}


@pytest.mark.parametrize("kind", ["chroma", "st"])
def test_one_wave_step_with_cclm_and_jccr_matches_make_class_apply(kind, margins):
    kw = dict(width=W, height=H, cclm=True, joint_cbcr=True, **CONFIGS[kind])
    jenc = jwf.WavefrontEncoder(JaxConfig(**kw))
    tenc = twf.WavefrontEncoder(VVCConfig(**kw), device="cpu")
    y, u, v = chroma_tool_frames(W, H, 1)[0]
    maps = _mtt_maps(W, H, seed0=6)
    cmaps = _mtt_maps(W, H, chroma_factor=2, seed0=5) if kind == "chroma" else None
    leaves = _leaves(jenc, maps, cmaps, jwf._collect_leaves_chroma)
    assert leaves == _leaves(tenc, maps, cmaps, twf._collect_leaves_chroma)
    active, sched, ogs, ogcs = twf._pack_schedule([leaves], W, H, tenc.batch, cclm=True)
    rng = np.random.RandomState(len(kind))
    noisy = lambda p: (p + rng.randint(-3, 4, p.shape)).clip(0, 1023).astype(np.int32)[None]
    state = [noisy(y), noisy(u), noisy(v)] + \
        [rng.randint(-50, 50, p.shape).astype(np.int16)[None] for p in (y, u, v)] + \
        [rng.randint(0, 67, (1, H // 4, W // 4)).astype(np.uint8)] + \
        [np.zeros((1, H // 4, W // 4), np.uint8) for _ in range(4)]
    orgs = [p[None].astype(np.int32) for p in (y, u, v)]
    qp_y, qp_c = jenc._qps()
    qp_j = qp_c - jenc.cfg.chroma_qp_offset + jenc.cfg.jccr_qp_offset
    assert tenc._qps() == (qp_y, qp_c, qp_j)
    codes = []
    for P in (32, 64):
        if (kind, P) not in active:
            continue
        arr = sched[(kind, P)]
        t = int(np.argmax(arr[:, :, 6].sum(1)))        # the fullest step
        row = arr[t]
        assert (row[row[:, 6] > 0, 7] & 1).any(), "no row with the CCLM gate"
        f = jax.jit(jwf._make_class_apply(P, len(row), qp_y, qp_c, BD, float(jenc.lam),
                                          float(jenc.dw_c), True, kind=kind, cclm=True,
                                          jccr=True, qp_j=qp_j))
        want = f(tuple(jnp.asarray(s) for s in state), jnp.asarray(row),
                 *(jnp.asarray(o) for o in orgs), jnp.asarray(ogs), jnp.asarray(ogcs))
        tstate = [torch.from_numpy(s.copy()) for s in state]
        scan = twf._Scan(tstate, *(_t(o) for o in orgs), _t(ogs), _t(ogcs), qp_y, qp_c, BD,
                         float(tenc.lam), float(tenc.dw_c), True, cclm=True, jccr=True,
                         qp_j=qp_j)
        scan.step(kind, P, torch.from_numpy(row))
        for i, (a, b) in enumerate(zip(tstate, want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"plane {i}")
        codes.append(tstate[9].numpy())
    cg = np.concatenate([c.ravel() for c in codes])
    assert (cg & 1).any(), "no LM chroma CU"
    assert (cg & 2).any(), "no joint Cb-Cr TU"
    assert margins["jccr"] and margins["cclm"]


# ---------------------------------------------------------------------------
# 5. K7's code grid at chroma scale
# ---------------------------------------------------------------------------

def test_wave_scatter_writes_the_code_grid_over_a_64x64_chroma_cu():
    """The chroma steps' code grid lies on the luma-unit 4-sample grid: a CU
    of 64x64 luma units (32x32 chroma samples, the 32-pad chroma class)
    covers 16x16 cells."""
    rows = _t([(0, 64, 0, 64, 64, 0, 1, 0), (0, 0, 64, 32, 64, 1, 1, 0),
               (0, 0, 0, 0, 0, 0, 0, 0)])
    planes = [(torch.zeros((1, 96, 128), dtype=torch.int32),
               torch.zeros((1, 96, 128), dtype=torch.int16)) for _ in range(2)]
    rec = torch.ones((2, 3, 32, 32), dtype=torch.int32)
    grid = torch.zeros((1, 48, 64), dtype=torch.uint8)
    twf.wave_scatter(rows, 32, 2, planes, rec, rec, [(grid, _t([3, 2, 1]))])
    want = torch.zeros_like(grid)
    want[0, 0:16, 16:32] = 3
    want[0, 16:32, 0:8] = 2
    assert torch.equal(grid, want)
    assert int(planes[0][0].sum()) == 32 * 32 + 16 * 32
