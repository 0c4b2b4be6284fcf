"""LMCS with chroma residual scaling (K6b, inside K4) and ALF / CC-ALF: the
port's plain versions against the JAX package's, on the CPU.

1. The port's ``Reshaper`` LUTs, ``crs_lut`` and the LMCS APS bytes against
   the JAX package's for every ``lmcs_offset`` 0-3 at 10 bits.
2. ``crs_scale_reference`` against ``_chroma_part``'s scale (558-590)
   written with the JAX functions, on 208x120 frames (VPDUs cut by the right
   and bottom edges), with every left/above availability pair, the gate for
   CUs of 4 or fewer chroma samples and scales other than 1 << 11.
3. ``tq_reference(crs=...)`` against ``_tq_generic(crs=...)`` for U and V and
   against the joint Cb-Cr trial, with sign-data hiding off and on. Every
   float decision first keeps its margin (``tq_margin``, ``jccr_margin``).
4. The single-tree schedule with chroma scaling waits for each CU's VPDU
   neighbours (``vpdu_dep``), as the JAX package's ``_batched_pass`` does.
5. One single-tree and one dual-tree chroma wave step with LMCS, chroma
   scaling, sign-data hiding and joint Cb-Cr against ``_make_class_apply``:
   the 11 state planes equal.
6. ``decide_alf_luma``, ``decide_alf_chroma``, ``derive_ccalf_filter`` /
   ``decide_ccalf`` and ``alf_aps_nal`` of the port's copy against the JAX
   package's on seeded planes.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmp_vvc_tpu.codec import alf as jalf
from pmp_vvc_tpu.codec import lmcs as jlmcs
from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu_torch.codec import alf as talf
from pmp_vvc_tpu_torch.codec import lmcs as tlmcs
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.ops import tq_generic as ttq
from pmp_vvc_tpu_torch.ops.lmcs_generic import UNIT_SCALE, crs_lut, crs_scale_reference
from chip_smoke import chroma_tool_frames
from test_torch_cclm_jccr import _jax_joint, _jccr_inputs
from test_torch_codec_ops import MARGIN, jccr_margin, tq_margin
from test_torch_wavefront import MTT, _leaves, jax_schedules, margins  # noqa: F401
from test_wavefront import _mtt_maps, _synth

torch.set_num_threads(2)

BD = 10
OFFSETS = (0, 1, 2, 3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _jax_lut(offset):
    """The CRS LUT as ``_make_class_apply`` builds it (338-348)."""
    rsh = jlmcs.Reshaper(jlmcs.derive_ai_model(BD, offset), BD)
    return rsh.chroma_adj_lut[rsh._pwl_idx_inv(np.arange(1 << BD))].astype(np.int32)


# ---------------------------------------------------------------------------
# 1. the reshaper, the CRS LUT and the APS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", OFFSETS)
def test_reshaper_luts_and_crs_lut_match_jax(offset):
    want = jlmcs.Reshaper(jlmcs.derive_ai_model(BD, offset), BD)
    got = tlmcs.Reshaper(tlmcs.derive_ai_model(BD, offset), BD)
    for name in ("fwd_lut", "inv_lut", "chroma_adj_lut", "reshape_pivot"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    lut = crs_lut(BD, offset)
    np.testing.assert_array_equal(lut, _jax_lut(offset))
    assert lut.dtype == np.int32 and lut.shape == (1 << BD,)
    assert (lut != UNIT_SCALE).mean() > 0.9
    samples = np.arange(1 << BD)
    np.testing.assert_array_equal(got.fwd(samples), want.fwd(samples))


@pytest.mark.parametrize("offset", OFFSETS)
def test_lmcs_aps_bytes_match_jax(offset):
    want = jlmcs.lmcs_aps_nal(jlmcs.derive_ai_model(BD, offset))
    got = tlmcs.lmcs_aps_nal(tlmcs.derive_ai_model(BD, offset))
    assert got == want and len(got) > 8


# ---------------------------------------------------------------------------
# 2. the CRS scale
# ---------------------------------------------------------------------------

@jax.jit
def _jax_crs(ry_pl, og4c, rows, crs_lut_):
    """``_chroma_part``'s CRS scale (558-590) with the JAX functions."""
    fi, xs, ys, ws, hs, oi = (rows[:, k] for k in range(6))
    vx, vy = (xs // 64) * 64, (ys // 64) * 64
    l_ok = jwf._avail_from_order(og4c, fi, oi, jnp.maximum(vx - 4, 0) // 4, vy // 4, vx > 0)
    t_ok = jwf._avail_from_order(og4c, fi, oi, vx // 4, jnp.maximum(vy - 4, 0) // 4, vy > 0)
    i64 = np.arange(64)
    Hl, Wl = ry_pl.shape[1], ry_pl.shape[2]
    lrows = jnp.minimum(vy[:, None] + i64, Hl - 1)
    s_l = jwf._gather_plane(ry_pl, fi[:, None], lrows, jnp.maximum(vx - 1, 0)[:, None]).sum(-1)
    tcols = jnp.minimum(vx[:, None] + i64, Wl - 1)
    s_t = jwf._gather_plane(ry_pl, fi[:, None], jnp.maximum(vy - 1, 0)[:, None], tcols).sum(-1)
    s = jnp.where(l_ok, s_l, 0) + jnp.where(t_ok, s_t, 0)
    n = l_ok.astype(jnp.int32) + t_ok.astype(jnp.int32)
    avg = jnp.where(n == 0, 1 << (BD - 1), (s + (32 << jnp.maximum(n - 1, 0))) >> (5 + n))
    crs_all = jnp.take(crs_lut_, jnp.clip(avg, 0, crs_lut_.shape[0] - 1))
    return jnp.where((ws // 2) * (hs // 2) > 4, crs_all, 1 << 11), l_ok, t_ok


CRS_CASES = ("left+above", "left only", "above only", "neither", "cut by the right edge",
             "cut by the bottom edge", "<= 4 samples", "scale != 1 << 11")


def crs_rows(width, height, seed, n=96):
    """(n + 2, 8) int32 rows (luma units) of random chroma CU sizes 4..32 at
    random 4-aligned positions of the frame, random order ids, and two
    padding rows."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        w, h = (int(rng.choice([4, 8, 16, 32])) for _ in range(2))
        x = int(rng.randint(0, (width - w) // 4 + 1)) * 4
        y = int(rng.randint(0, (height - h) // 4 + 1)) * 4
        rows.append((rng.randint(2), x, y, w, h, rng.randint(0, 400), 1, 0))
    rows += [(0, 0, 0, 0, 0, 0, 0, 0)] * 2
    return np.array(rows, np.int32)


def crs_cases(rows, left, above, crs, width, height):
    """Counts of ``CRS_CASES`` over the live rows."""
    ok = rows[:, 6] > 0
    vx, vy = rows[:, 1] // 64 * 64, rows[:, 2] // 64 * 64
    masks = (left & above, left & ~above, ~left & above, ~left & ~above,
             vx + 64 > width, vy + 64 > height,
             (rows[:, 3] // 2) * (rows[:, 4] // 2) <= 4, crs != UNIT_SCALE)
    return np.array([int((m & ok).sum()) for m in masks])


@pytest.mark.parametrize("offset", [0, 2])
def test_crs_scale_matches_jax(offset):
    width, height = 208, 120
    rng = np.random.RandomState(offset)
    ry = rng.randint(0, 1024, (2, height, width)).astype(np.int32)
    ry[1, :, :64] = 1023                       # averages at the top of the LUT
    og = rng.randint(-1, 400, (2, height // 4, width // 4)).astype(np.int32)
    rows = crs_rows(width, height, seed=offset)
    rows[:4, 3:5] = 4                          # chroma 2x2: the gate
    lut = crs_lut(BD, offset)
    want, left, above = (np.asarray(a) for a in _jax_crs(
        jnp.asarray(ry), jnp.asarray(og), jnp.asarray(rows), jnp.asarray(lut)))
    got = crs_scale_reference(_t(ry), _t(og), _t(rows), _t(lut), BD)
    ok = rows[:, 6] > 0
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[ok], want[ok])
    assert (got.numpy()[~ok] == UNIT_SCALE).all()
    seen = crs_cases(rows, left, above, want, width, height)
    assert (seen > 0).all(), dict(zip(CRS_CASES, seen))


# ---------------------------------------------------------------------------
# 3. the scaled round trips: U, V and the joint Cb-Cr TU
# ---------------------------------------------------------------------------

_jtq_chroma = jax.jit(jwf._tq_generic, static_argnums=(4, 5, 6, 7, 8),
                      static_argnames=("sdh",))


@pytest.mark.parametrize("sdh", [False, True])
@pytest.mark.parametrize("pad", [16, 32])
def test_tq_with_crs_matches_jax(pad, sdh):
    from pmp_vvc_tpu_torch.codec.encoder import FrameEncoder
    enc = FrameEncoder(VVCConfig(width=256, height=192, qp=32, dual_tree=True,
                                 joint_cbcr=True, chroma_qp_start_minus26=-9,
                                 chroma_qp_points=((9, 12), (4, 5), (11, 7))))
    lam, dw = float(enc.lam), float(enc.dw_c)
    qp_c = int(enc.qp_table[32 + enc.qp_bd_offset]) + enc.qp_bd_offset
    qp_j = qp_c - enc.cfg.chroma_qp_offset + enc.cfg.jccr_qp_offset
    rows, orgs, pred = _jccr_inputs(pad, seed=pad + 7 * sdh)
    B = len(rows)
    rng = np.random.RandomState(pad + sdh)
    # scales across the LUT's range, the identity on a few CUs
    crs = np.where(np.arange(B) % 5 == 0, UNIT_SCALE,
                   rng.choice(crs_lut(BD, 2), B)).astype(np.int32)
    torgs = [_t(o) for o in orgs]
    for i in range(2):
        m, _ = tq_margin(torgs[i], _t(pred[i]), rows, pad, 2, qp_c, lam, dw, sdh, crs=_t(crs))
        assert m > MARGIN, m
    m, _ = jccr_margin(torgs, _t(pred), rows, pad, 2, qp_c, qp_j, lam, dw, sdh, crs=_t(crs))
    assert m > MARGIN, m

    fi, xs, ys, ws, hs = (rows[:, k] for k in range(5))
    cxs, cys, cws, chs = xs // 2, ys // 2, ws // 2, hs // 2
    d = np.arange(pad)
    c_in = (d[None, :, None] < chs[:, None, None]) & (d[None, None, :] < cws[:, None, None])
    corg = [jwf._gather_plane(jnp.asarray(o), jnp.asarray(fi)[:, None, None],
                              jnp.asarray(cys)[:, None, None] + d[None, :, None],
                              jnp.asarray(cxs)[:, None, None] + d[None, None, :]) for o in orgs]
    ok = rows[:, 6] > 0
    m = c_in & ok[:, None, None]
    # U and V alone
    got_l, got_r = ttq.tq_reference(torgs, _t(pred), _t(rows), pad, 2, qp_c, BD, True, lam, dw,
                                    sdh=sdh, crs=_t(crs))
    for i in range(2):
        want_l, want_r = (np.asarray(a) for a in _jtq_chroma(
            corg[i], jnp.asarray(pred[i]), jnp.asarray(cws), jnp.asarray(chs), qp_c, BD, lam,
            dw, True, jnp.asarray(c_in), sdh=sdh, crs=jnp.asarray(crs)))
        np.testing.assert_array_equal(got_l[i].numpy()[m], want_l[m])
        np.testing.assert_array_equal(got_r[i].numpy()[m], want_r[m])
        assert (want_l[m] != 0).any()
    # with the joint trial
    want_l, want_r, want_use, cbf_j = (np.asarray(a) for a in _jax_joint(
        corg, jnp.asarray(pred), jnp.asarray(cws), jnp.asarray(chs), jnp.asarray(c_in),
        qp_c, qp_j, lam, dw, sdh, None, jnp.asarray(crs)))
    got_l, got_r, got_use = ttq.tq_reference(torgs, _t(pred), _t(rows), pad, 2, qp_c, BD, True,
                                             lam, dw, sdh=sdh, jccr=True, qp_j=qp_j,
                                             crs=_t(crs))
    mm = np.broadcast_to(m, want_l.shape)
    np.testing.assert_array_equal(got_l.numpy()[mm], want_l[mm])
    np.testing.assert_array_equal(got_r.numpy()[mm], want_r[mm])
    np.testing.assert_array_equal(got_use.numpy()[ok], want_use[ok])
    assert not got_l.numpy()[~mm].any() and not got_r.numpy()[~mm].any()
    assert (want_use & ok).any() and (cbf_j & ~want_use & ok).any()
    # the scaling changes the outcome: without it some level differs
    plain_l = ttq.tq_reference(torgs, _t(pred), _t(rows), pad, 2, qp_c, BD, True, lam, dw,
                               sdh=sdh, jccr=True, qp_j=qp_j)[0]
    assert (plain_l.numpy()[mm] != want_l[mm]).any()


# ---------------------------------------------------------------------------
# 4. the single-tree schedule waits for the VPDU neighbours
# ---------------------------------------------------------------------------

LMCS = dict(lmcs=True, lmcs_chroma_scaling=True)


def edge_maps(width, height, seed0):
    """MTT maps over the whole of a frame whose sides are not multiples of
    64: ``_mtt_maps`` of the next 64-multiple frame, cropped."""
    hor, ver, qt, dire = _mtt_maps(-(-width // 64) * 64, -(-height // 64) * 64, seed0=seed0)
    h4, w4 = height // 4, width // 4
    return hor[:h4, :w4], ver[:h4, :w4], qt[:h4 // 2, :w4 // 2], dire[:, :h4, :w4]


def test_single_tree_schedule_with_crs_waits_for_the_vpdu_neighbours():
    W, H = 208, 120
    kw = dict(width=W, height=H, qp=32, **MTT, **LMCS)
    jenc = jwf.WavefrontEncoder(JaxConfig(**kw))
    tenc = twf.WavefrontEncoder(VVCConfig(**kw), device="cpu")
    y, u, v = _synth(W, H)
    maps = edge_maps(W, H, seed0=6)
    leaves = _leaves(tenc, maps, None, twf._collect_leaves_chroma)
    assert leaves == _leaves(jenc, maps, None, jwf._collect_leaves_chroma)
    order = twf._order_grid(leaves[0], W, H)
    plain = twf._schedule_waves(leaves[0], order, W, H)
    waits = twf._schedule_waves(leaves[0], order, W, H, vpdu_dep=True)
    np.testing.assert_array_equal(waits, jwf._schedule_waves(leaves[0], order, W, H,
                                                             vpdu_dep=True))
    assert (waits > plain).any(), "no CU waits for its VPDU neighbours"
    want = jax_schedules(jenc, [(*leaves, y, u, v)])
    active, got, _, _ = twf._pack_schedule([leaves], W, H, tenc.batch, crs=True)
    assert active == tuple(sorted(want))
    for k in active:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    loose = twf._pack_schedule([leaves], W, H, tenc.batch)[1]
    assert any(loose[k].shape != got[k].shape or (loose[k] != got[k]).any() for k in active)


# ---------------------------------------------------------------------------
# 5. one wave step with chroma scaling
# ---------------------------------------------------------------------------

TOOLS = dict(sign_hiding=True, joint_cbcr=True, **LMCS)


@pytest.mark.parametrize("kind", ["chroma", "st"])
def test_one_wave_step_with_crs_matches_make_class_apply(kind, margins):
    W, H = 208, 120
    kw = dict(width=W, height=H, qp=27, dual_tree=kind == "chroma", lmcs_offset=1, **MTT,
              **TOOLS)
    jenc = jwf.WavefrontEncoder(JaxConfig(**kw))
    tenc = twf.WavefrontEncoder(VVCConfig(**kw), device="cpu")
    y, u, v = chroma_tool_frames(W, H, 1)[0]
    maps = edge_maps(W, H, seed0=6)
    cmaps = _mtt_maps(W, H, chroma_factor=2, seed0=5) if kind == "chroma" else None
    leaves = _leaves(tenc, maps, cmaps, twf._collect_leaves_chroma)
    active, sched, ogs, ogcs = twf._pack_schedule([leaves], W, H, tenc.batch, crs=True)
    rng = np.random.RandomState(len(kind))
    noisy = lambda p: (p + rng.randint(-3, 4, p.shape)).clip(0, 1023).astype(np.int32)[None]
    state = [noisy(tenc.reshaper.fwd(y)), noisy(u), noisy(v)] + \
        [rng.randint(-50, 50, p.shape).astype(np.int16)[None] for p in (y, u, v)] + \
        [rng.randint(0, 67, (1, H // 4, W // 4)).astype(np.uint8)] + \
        [np.zeros((1, H // 4, W // 4), np.uint8) for _ in range(4)]
    orgs = [tenc.reshaper.fwd(y)[None].astype(np.int32)] + \
        [p[None].astype(np.int32) for p in (u, v)]
    qp_y, qp_c = jenc._qps()
    qp_j = qp_c - jenc.cfg.chroma_qp_offset + jenc.cfg.jccr_qp_offset
    lut = _t(tenc.crs_lut)
    done = 0
    for P in (32, 64):
        if (kind, P) not in active:
            continue
        arr = sched[(kind, P)]
        t = int(np.argmax(arr[:, :, 6].sum(1)))        # the fullest step
        row = arr[t]
        f = jax.jit(jwf._make_class_apply(P, len(row), qp_y, qp_c, BD, float(jenc.lam),
                                          float(jenc.dw_c), True, kind=kind, sdh=True,
                                          jccr=True, qp_j=qp_j, crs_cfg=(BD, 1)))
        want = f(tuple(jnp.asarray(s) for s in state), jnp.asarray(row),
                 *(jnp.asarray(o) for o in orgs), jnp.asarray(ogs), jnp.asarray(ogcs))
        tstate = [torch.from_numpy(s.copy()) for s in state]
        scan = twf._Scan(tstate, *(_t(o) for o in orgs), _t(ogs), _t(ogcs), qp_y, qp_c, BD,
                         float(tenc.lam), float(tenc.dw_c), True, sdh=True, jccr=True,
                         qp_j=qp_j, crs_lut=lut)
        scan.step(kind, P, torch.from_numpy(row))
        for i, (a, b) in enumerate(zip(tstate, want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"plane {i}")
        done += 1
    assert done
    assert margins["crs"] and any(c != UNIT_SCALE for c in margins["crs"])


# ---------------------------------------------------------------------------
# 6. ALF and CC-ALF (host numpy, the port's copy)
# ---------------------------------------------------------------------------

@functools.cache
def _alf_planes():
    """A 192x128 frame and a recon with noise (what ALF removes) whose chroma
    error follows the luma error (what CC-ALF removes)."""
    rng = np.random.RandomState(11)
    y, u, v = _synth(192, 128)
    ry = np.clip(y + rng.randn(*y.shape) * 20, 0, 1023).astype(np.int32)
    follow = (ry - y)[::2, ::2]
    ru, rv = (np.clip(p + s * follow + rng.randn(*p.shape), 0, 1023).astype(np.int32)
              for p, s in ((u, 1), (v, -1)))
    return (y, u, v), (ry, ru, rv)


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_alf_and_ccalf_decisions_match_jax():
    (y, u, v), (ry, ru, rv) = _alf_planes()
    lam = 0.57 * 2.0 ** ((32 + 12 - 12) / 3.0)
    out = {}
    for name, m in (("jax", jalf), ("port", talf)):
        luma_raw = m.derive_luma_filters(y, ry, BD, 128)
        chroma_raw = m.derive_chroma_filter(u, v, ru, rv, BD, 128)
        extra = [m.reconstruct_coeff(luma_raw, None, BD, 25, delta_idx=np.arange(25))]
        flags, sets, new_y = m.decide_alf_luma(y, ry, BD, 128, lam, extra_sets=extra)
        ccoeff, cclip = m.reconstruct_coeff(chroma_raw[None, :], None, BD, 1)
        cb, new_u = m.decide_alf_chroma(u, ru, ccoeff[0], cclip[0], BD, 128, lam)
        cr, new_v = m.decide_alf_chroma(v, rv, ccoeff[0], cclip[0], BD, 128, lam)
        pad = m.pad4(ry)
        cc_cb_coeff = m.derive_ccalf_filter(u, new_u, pad, BD, 128)
        cc_cr_coeff = m.derive_ccalf_filter(v, new_v, pad, BD, 128)
        cc_cb, cc_u = m.decide_ccalf(u, new_u, pad, cc_cb_coeff, BD, 128, lam)
        cc_cr, cc_v = m.decide_ccalf(v, new_v, pad, cc_cr_coeff, BD, 128, lam)
        aps = m.alf_aps_nal(luma_raw, chroma_raw, ccalf_cb=cc_cb_coeff, ccalf_cr=cc_cr_coeff)
        out[name] = dict(luma=(luma_raw, flags, sets, new_y), chroma=(chroma_raw, cb, cr,
                                                                        new_u, new_v),
                         ccalf=(cc_cb_coeff, cc_cr_coeff, cc_cb, cc_cr, cc_u, cc_v), aps=aps)
    for key in out["jax"]:
        _equal(out["port"][key], out["jax"][key])
    _, flags, _, new_y = out["port"]["luma"]
    _, cb, cr, *_ = out["port"]["chroma"]
    _, _, cc_cb, cc_cr, *_ = out["port"]["ccalf"]
    assert flags.any() and cb.any() and cr.any() and cc_cb.any() and cc_cr.any()
    assert not np.array_equal(new_y, ry)
