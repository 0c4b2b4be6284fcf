"""The port's wave path against the JAX package's, piece by piece, on the CPU.

1. Host geometry: leaves, order grids, wave levels and the packed (S, B, 8)
   schedules, single and dual tree, with MTT maps on two frames.
2. One wave step of each kind ("st", "luma", "chroma") on a real schedule
   row against ``_make_class_apply``: the 11 state planes must be equal.
3. The whole scan against ``_batched_pass`` (``_wave_scan``), and the
   port's scan with other batch sizes: the same planes.

Every coded-vs-zero, zeroing and sign-data-hiding decision of the port's
K4 and K5 calls is first held to a relative margin above ``MARGIN``, and every K3
decision's SATDs to the range where float32 sums are exact (see
test_torch_codec_ops.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.ops.cclm_generic import cclm_costs
from pmp_vvc_tpu_torch.ops.lmcs_generic import crs_scale_reference
from test_torch_codec_ops import (MARGIN, jccr_margin, k5_margin, mip_margin, region_cut,
                                  tq_margin)
from test_wavefront import _mtt_maps, _synth

torch.set_num_threads(2)

W, H = 192, 128
MTT = dict(max_mtt_depth_intra=3, max_bt_intra=32, max_tt_intra=32, log2_min_cb=2)
SLICE = dict(MTT, dual_tree=True, sao=True, deblocking_disabled=False,
             chroma_qp_start_minus26=-9, chroma_qp_points=((9, 12), (4, 5), (11, 7)))
CONFIGS = {"single": dict(MTT, qp=27), "dual": dict(SLICE, qp=22)}


@pytest.fixture
def margins(monkeypatch):
    """Wraps the port's K4, K3, K5 and K6a on the wave path. The float decisions
    of every DCT-2 TQ (K4's, and K5's with its tools off) must keep a
    relative margin above MARGIN (``seen["tq"]``), and so must each
    coefficient group that sign-data hiding corrects (``seen["sdh"]`` holds
    one gap per corrected group); every K3 call's SATDs must stay below
    2^24, where the JAX package's float32 sums and comparisons are exact
    (``seen["mip"]``: (largest SATD, smallest MIP-vs-angular gap)); every
    other K5 call's zeroing decisions, its winning candidate against the
    runner-up and the winner against the zero TU must keep a relative
    margin above MARGIN (``seen["k5"]``: (zeroing, candidate, zero TU)
    margins per call; ``k5_margin``). ``seen["region"]`` counts the chroma
    levels that K4's single-tree LFNST region removes (``region_cut``). With
    the joint Cb-Cr trial, its joint TU's decisions and the joint-vs-separate
    choice of every CU whose joint TU is coded must keep a relative margin
    above MARGIN too (``seen["jccr"]``, ``jccr_margin``); every K6a call's
    DM and LM joint SATDs must stay below 2^24, where the JAX package's
    float32 sums and its strict comparison are exact (``seen["cclm"]``: the
    largest SATD per call). With LMCS chroma scaling, K4's margins are those
    of its scaled round trips, and ``seen["crs"]`` collects the scales."""
    seen = {"tq": [], "sdh": [], "mip": [], "k5": [], "region": [], "jccr": [], "cclm": [],
            "crs": []}
    real_tq, real_mip, real_k5 = twf.tq, twf.mip_select, twf.tq_mts
    real_cclm = twf.cclm_select

    def guarded(orgs, pred, rows, pad, scale, qp, bd, rd_quant, lam, dw, sdh=False,
                lfnst_active=None, jccr=False, qp_j=0, crs_src=None):
        crs = None
        if crs_src is not None:
            crs = crs_scale_reference(crs_src[0], crs_src[1], rows, crs_src[2], bd)
            seen["crs"] += crs[rows[:, 6] > 0].tolist()
        for i, org in enumerate(orgs):
            m, gaps = tq_margin(org, pred[i], rows.numpy(), pad, scale, qp, lam, dw, sdh,
                                lfnst_active, crs)
            seen["tq"].append(m)
            seen["sdh"] += gaps
            if lfnst_active is not None:
                seen["region"].append(region_cut(org, pred[i], rows.numpy(), pad, scale,
                                                 qp, lam, lfnst_active, crs))
        if jccr:
            m, gaps = jccr_margin(orgs, pred, rows.numpy(), pad, scale, qp, qp_j, lam, dw,
                                  sdh, lfnst_active, crs)
            seen["jccr"].append(m)
            seen["sdh"] += gaps
        return real_tq(orgs, pred, rows, pad, scale, qp, bd, rd_quant, lam, dw, sdh,
                       lfnst_active, jccr, qp_j, crs_src)

    def guarded_mip(refs, org, rows, pred, best, pad, bd):
        seen["mip"].append(mip_margin(refs, org, rows, pred, pad))
        return real_mip(refs, org, rows, pred, best, pad, bd)

    def guarded_cclm(refs, ry, orgs, og4c, rows, pred, pad, bd):
        _, cost_dm, cost_lm = cclm_costs(refs, ry, orgs, og4c, rows, pred, pad, bd)
        seen["cclm"].append(int(torch.maximum(cost_dm, cost_lm).max()))
        return real_cclm(refs, ry, orgs, og4c, rows, pred, pad, bd)

    def guarded_k5(orgs, pred, rows, pad, qp, bd, rd_quant, lam, modes, mip_code=None,
                   mts=False, lfnst=False, ts_max=0, sdh=False):
        if mts or lfnst or ts_max:
            *m, gaps = k5_margin(orgs, pred, rows, pad, qp, lam, modes, mip_code, mts,
                                 lfnst, ts_max, sdh)
            seen["k5"].append(m)
        else:
            m, gaps = tq_margin(orgs[0], pred[0], rows.numpy(), pad, 1, qp, lam, None, sdh)
            seen["tq"].append(m)
        seen["sdh"] += gaps
        return real_k5(orgs, pred, rows, pad, qp, bd, rd_quant, lam, modes, mip_code,
                       mts, lfnst, ts_max, sdh)

    monkeypatch.setattr(twf, "tq", guarded)
    monkeypatch.setattr(twf, "mip_select", guarded_mip)
    monkeypatch.setattr(twf, "tq_mts", guarded_k5)
    monkeypatch.setattr(twf, "cclm_select", guarded_cclm)
    yield seen
    assert seen["tq"] and min(seen["tq"]) > MARGIN, min(seen["tq"])
    assert not seen["sdh"] or min(seen["sdh"]) > MARGIN, min(seen["sdh"])
    assert not seen["mip"] or max(top for top, _ in seen["mip"]) < 1 << 24
    assert not seen["k5"] or min(min(m) for m in seen["k5"]) > MARGIN, \
        [min(c) for c in zip(*seen["k5"])]
    assert not seen["jccr"] or min(seen["jccr"]) > MARGIN, min(seen["jccr"])
    assert not seen["cclm"] or max(seen["cclm"]) < 1 << 24


def _encoders(name):
    kw = dict(width=W, height=H, **CONFIGS[name])
    return jwf.WavefrontEncoder(JaxConfig(**kw)), \
        twf.WavefrontEncoder(VVCConfig(**kw), device="cpu")


def _frames(name):
    """Two frames with their own maps: (y, u, v, maps, chroma maps)."""
    out = []
    for f in range(2):
        y, u, v = _synth(W, H, seed=7 + f)
        maps = _mtt_maps(W, H, seed0=3 * f)
        cmaps = _mtt_maps(W, H, chroma_factor=2, seed0=5 + 3 * f) \
            if name == "dual" else None
        out.append((y, u, v, maps, cmaps))
    return out


def _leaves(enc, maps, cmaps, chroma_walk):
    decide = enc._decider(None, maps)
    leaves = enc._collect_leaves(decide)
    cleaves = None
    if enc.cfg.dual_tree:
        cleaves = chroma_walk(enc, enc._decider_chroma(None, maps, cmaps),
                              decide_luma=decide)
    return leaves, cleaves


def jax_schedules(enc, packed):
    """The (S, B, 8) schedules ``_batched_pass`` hands to ``_wave_scan``
    (the scan itself is not run)."""
    got = {}
    real = jwf._wave_scan

    def capture(classes, bszs, *a, **k):
        def run(*args):
            got.update(zip(classes, (np.asarray(s) for s in args[16:])))
            return args[:11]
        return run

    jwf._wave_scan = capture
    try:
        enc._batched_pass(packed)
    finally:
        jwf._wave_scan = real
    return got


@pytest.mark.parametrize("name", ["single", "dual"])
def test_host_geometry_matches_jax(name):
    jenc, tenc = _encoders(name)
    frames = _frames(name)
    packed_j, packed_t = [], []
    for y, u, v, maps, cmaps in frames:
        lj = _leaves(jenc, maps, cmaps, jwf._collect_leaves_chroma)
        lt = _leaves(tenc, maps, cmaps, twf._collect_leaves_chroma)
        assert lj == lt
        for leaves in (lj[0], lj[1]) if lj[1] is not None else (lj[0],):
            order = jwf._order_grid(leaves, W, H)
            np.testing.assert_array_equal(twf._order_grid(leaves, W, H), order)
            np.testing.assert_array_equal(twf._schedule_waves(leaves, order, W, H),
                                          jwf._schedule_waves(leaves, order, W, H))
        packed_j.append((*lj, y, u, v))
        packed_t.append(lt)
    want = jax_schedules(jenc, packed_j)
    active, got, ogs, ogcs = twf._pack_schedule(packed_t, W, H, tenc.batch)
    assert active == tuple(sorted(want))
    for k in active:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert ogs.shape == (2, H // 4, W // 4) and (ogs >= 0).all()


def _state(rng, F):
    """Random recon, level and mode planes; the MTS/MIP/CCLM/LFNST grids
    are zero, as on the port's path (nothing writes them there)."""
    ry = rng.randint(0, 1024, (F, H, W)).astype(np.int32)
    ru = rng.randint(0, 1024, (F, H // 2, W // 2)).astype(np.int32)
    rv = rng.randint(0, 1024, (F, H // 2, W // 2)).astype(np.int32)
    cY = rng.randint(-50, 50, (F, H, W)).astype(np.int16)
    cU = rng.randint(-50, 50, (F, H // 2, W // 2)).astype(np.int16)
    cV = rng.randint(-50, 50, (F, H // 2, W // 2)).astype(np.int16)
    mg = rng.randint(0, 67, (F, H // 4, W // 4)).astype(np.uint8)
    zeros = [np.zeros((F, H // 4, W // 4), np.uint8) for _ in range(4)]
    return [ry, ru, rv, cY, cU, cV, mg] + zeros


@pytest.mark.parametrize("kind", ["st", "luma", "chroma"])
def test_one_wave_step_matches_make_class_apply(kind, margins):
    name = "single" if kind == "st" else "dual"
    jenc, tenc = _encoders(name)
    frames = _frames(name)
    packed = [(*_leaves(jenc, m, c, jwf._collect_leaves_chroma), y, u, v)
              for y, u, v, m, c in frames]
    active, sched, ogs, ogcs = twf._pack_schedule([p[:2] for p in packed], W, H,
                                                  tenc.batch)
    rng = np.random.RandomState(len(kind))
    state = _state(rng, 2)
    orgs = [np.stack([fr[i] for fr in frames]).astype(np.int32) for i in range(3)]
    qp_y, qp_c = jenc._qps()
    done = 0
    for P in (32, 64):
        if (kind, P) not in active:
            continue
        arr = sched[(kind, P)]
        t = int(np.argmax(arr[:, :, 6].sum(1)))        # the fullest step
        row = arr[t]
        f = jax.jit(jwf._make_class_apply(P, len(row), qp_y, qp_c, 10,
                                          float(jenc.lam), float(jenc.dw_c), True,
                                          kind=kind))
        want = f(tuple(jnp.asarray(s) for s in state), jnp.asarray(row),
                 *(jnp.asarray(o) for o in orgs), jnp.asarray(ogs), jnp.asarray(ogcs))
        tstate = [torch.from_numpy(s.copy()) for s in state]
        scan = twf._Scan(tstate, *(torch.from_numpy(o) for o in orgs),
                         torch.from_numpy(ogs), torch.from_numpy(ogcs), qp_y, qp_c,
                         10, float(tenc.lam), float(tenc.dw_c), True)
        scan.step(kind, P, torch.from_numpy(row))
        for i, (a, b) in enumerate(zip(tstate, want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"plane {i}")
        changed = [not np.array_equal(a.numpy(), s) for a, s in zip(tstate, state)]
        assert changed[0 if kind != "chroma" else 1], "the step wrote nothing"
        done += 1
    assert done


@pytest.mark.parametrize("name", ["single", "dual"])
def test_scan_matches_jax_and_is_batch_invariant(name, margins):
    jenc, tenc = _encoders(name)
    frames = _frames(name)
    packed = [(*_leaves(jenc, m, c, jwf._collect_leaves_chroma), y, u, v)
              for y, u, v, m, c in frames]
    want = jenc._batched_pass(packed)
    got = tenc._batched_pass(packed)
    assert len(got) == 11
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.asarray(b).dtype, i
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"plane {i}")
    steps = tenc.steps
    small = twf.WavefrontEncoder(tenc.cfg, device="cpu", batch={32: 2, 64: 1})
    for i, (a, b) in enumerate(zip(small._batched_pass(packed), got)):
        np.testing.assert_array_equal(a, b, err_msg=f"plane {i}")
    assert small.steps > steps
