"""K9b's and K9c's plain versions against the JAX RDO on tie and edge inputs.

``chip_smoke.k9b_tie_inputs`` builds, per pad class of the device RDO (8,
16, 32, 64), rects whose four chroma candidates tie on flat references and
originals (planar must win), rects whose originals are DC's (on non-square
rects too), HOR's or VER's prediction (that candidate must win at cost 0),
symmetric rects where HOR and VER tie at the least joint cost (HOR, index
2, must win over VER, index 3), rects whose U plane alone takes HOR but
whose joint U+V sum takes VER, chroma sides of 2, 32x32 chroma rects of 16
tiles a plane, rects at x = 0, y = 0 and on the frame's right and bottom
edges, and a padding row. The port's ``rdo_chroma_select_reference`` must
give the predictions and the winning SATD of the JAX selection
(``pmp_vvc_tpu/codec/rdo_device.py:_chroma_leaf_cost_fn`` 588-617,
restated here with its jitted functions) exactly, and each case's margin
holds on the JAX package's own SATDs.

``chip_smoke.k9c_edge_calls`` builds, per pad class, K9c's calls in both
trees at 1 and 4 QP points with SSEs above 2^24, levels at +-32,767 and
-32,768 (bit lengths 15 and 16), levels zero beyond the rects (as K4 and K5
leave them) and garbage recon there, rects on the frame's edges, chroma
sides of 2 and padding rows. The port's ``rdo_leaf_cost_reference`` must
give the JAX package's costs (``_leaf_cost_fn`` 122-136,
``_chroma_leaf_cost_fn`` 636-646): to 1e-6 below 2^24 and within the
float32 bound of the JAX package's sums of squares above it
(``tests/test_torch_rdo.py:_assert_costs``; the port sums exactly).
chip_smoke.py holds both CUDA kernels to the same plain versions on the
same inputs on the card.

K9c counts a rect's levels inside the rect, its plain version (as the JAX
package) the whole tile; ``test_tq_levels_zero_beyond_rects`` holds K4's
and K5's plain versions, on the RDO's rows of every class, to the zeros
beyond each rect that make the two agree (chip_smoke.py holds the kernels
to them on the card).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.ops import intra_generic as jig
from pmp_vvc_tpu.ops import tq_generic as jtq
from pmp_vvc_tpu_torch.ops import rdo_generic as rg
from pmp_vvc_tpu_torch.ops.intra_generic import ref_gather_reference
from tests.test_torch_codec_ops import BD, _j, _unpack
from tests.test_torch_rdo import _assert_costs

torch.set_num_threads(2)


def _inside(P, ws, hs):
    d = np.arange(P)
    return (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])


def _org(plane, fi, xs, ys, P):
    d = np.arange(P)
    return jwf._gather_plane(plane, fi[:, None, None], ys[:, None, None] + d[None, :, None],
                             xs[:, None, None] + d[None, None, :])


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_chroma(P, oy, ou, ov, fi, xs, ys, ws, hs):
    og0 = jnp.zeros((oy.shape[0], oy.shape[1] // 4, oy.shape[2] // 4), jnp.int32)
    Pc, B = P // 2, len(fi)
    # U and V in one call: V's frames follow U's
    two = lambda a: jnp.concatenate([a, a])  # noqa: E731
    org, f2 = jnp.concatenate([ou, ov]), jnp.concatenate([fi, fi + oy.shape[0]])
    cxs, cys, cws, chs = (two(a // 2) for a in (xs, ys, ws, hs))
    refs = jwf._refs_generic(org, two(og0), f2, jnp.ones_like(f2), cxs, cys, cws, chs, Pc, 2,
                             BD)
    cand = jnp.broadcast_to(jnp.asarray(rg.CHROMA_CANDIDATES)[None], (2 * B, 4))
    p = jig.predict_generic(*refs, cand, cws, chs, pad=Pc, is_luma=False, bit_depth=BD)
    satds = jtq.satd_generic(_org(org, f2, cxs, cys, Pc)[:, None], p, cws, chs).reshape(2, B, 4)
    joint = satds[0] + satds[1]
    bi = two(jnp.argmin(joint, axis=1))
    pick = jnp.take_along_axis(p, bi[:, None, None, None], axis=1)[:, 0] * _inside(Pc, cws, chs)
    return satds, pick.reshape(2, B, Pc, Pc), joint.min(axis=1)


def jax_chroma(rows, planes, P):
    """The chroma candidates' selection of ``_chroma_leaf_cost_fn`` with the
    JAX functions, in one jit: (satds (2, B, 4) of U and V, pred (2, B,
    P/2, P/2), the winner's joint SATD (B,))."""
    fi, xs, ys, ws, hs, _, _ = _unpack(rows, 1)
    out = _jax_chroma(P, *(_j(a) for a in (*planes, fi, xs, ys, ws, hs)))
    return tuple(np.asarray(o) for o in out)


def k9b_class_cases(P):
    """The tie cases the P-pad class holds: 32x32 chroma rects only at 64,
    the HOR / VER tie below it (planar fits a 32x32 one better)."""
    return [c for c in chip_smoke.K9B_TIE_CASES
            if not (c.startswith("32x32") and P != 64) and not (c.startswith("HOR and VER")
                                                               and P == 64)]


@pytest.mark.parametrize("P", sorted(chip_smoke.K9B_TIES))
def test_rdo_chroma_ties_match_jax(P):
    rows, planes, kinds, places = chip_smoke.k9b_tie_inputs(P, seed=P)
    live = rows[:, 6] > 0
    satds, want_p, want_best = jax_chroma(rows[live], planes, P)
    oy, ou, ov = (torch.from_numpy(p) for p in planes)
    rt = torch.from_numpy(rows)
    crefs = ref_gather_reference([ou, ov], rg._zero_grid(oy), rt, P // 2, 2, BD)
    got_p, got_best = (t.numpy() for t in
                       rg.rdo_chroma_select_reference(crefs, [ou, ov], rt, P // 2, BD))
    np.testing.assert_array_equal(got_p[:, live], want_p)
    np.testing.assert_array_equal(got_best[live], want_best)
    assert not got_p[:, ~live].any() and not got_best[~live].any()

    # the cases are what they claim, on the JAX package's SATDs: a 4-way
    # tie, cost 0 for the candidate an original was made from, HOR and VER
    # tied at the least joint cost on each plane, U's own best overruled
    for b, kind in enumerate(kinds):
        u, v = satds[:, b]
        joint = u + v
        if kind == "flat":
            assert (joint == joint[0]).all() and joint[0] > 0, kind
        elif kind == "tie":
            assert u[2] == u[3] and v[2] == v[3] and joint[2] < joint[:2].min(), (kind, u, v)
        elif kind == "joint":
            assert u[2] == 0 < np.delete(u, 2).min(), (kind, u)
            assert joint[3] < np.delete(joint, 3).min(), (kind, joint)
        elif kind in chip_smoke.K9B_WANT:
            k = chip_smoke.K9B_WANT[kind]
            assert joint[k] == 0 < np.delete(joint, k).min(), (kind, joint)
    preds, port_satds = chip_smoke.k9b_candidates(rows, planes, P)
    np.testing.assert_array_equal(port_satds[:, live], satds)
    seen = dict(zip(chip_smoke.K9B_TIE_CASES,
                    chip_smoke.k9b_tie_seen(rows, kinds, places, port_satds, got_p, preds,
                                            got_best)))
    assert all(seen[c] > 0 for c in k9b_class_cases(P)), seen


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_costs(P, rows5, oy, ou, ov, lev, rec, lev_c, rec_c, params):
    """The leaf costs of ``_leaf_cost_fn`` and of ``_chroma_leaf_cost_fn``
    (its cost loop), restated on given levels and recon, in one jit: (luma
    tree, chroma tree), each (nQP, B)."""
    fi, xs, ys, ws, hs = (rows5[:, k] for k in range(5))
    Pc = P // 2
    c_in = _inside(Pc, ws // 2, hs // 2)
    corgs = [_org(p, fi, xs // 2, ys // 2, Pc) for p in (ou, ov)]
    out = ([], [])
    for q in range(params.shape[0]):
        lam, dw, lam2 = params[q, 0], params[q, 1], params[q, 2]
        err = ((rec[q] - _org(oy, fi, xs, ys, P)) * _inside(P, ws, hs)).astype(jnp.float32)
        for luma, cost in ((True, (err * err).sum(axis=(-1, -2))
                            + lam * (jwf._bits_proxy(lev[q]) + 6.0)),
                           (False, jnp.full((len(fi),), lam2))):   # chroma-mode bins proxy
            for pl in range(2):
                errc = ((rec_c[q, pl] - corgs[pl]) * c_in).astype(jnp.float32)
                cost = cost + dw * (errc * errc).sum(axis=(-1, -2)) \
                    + lam * jwf._bits_proxy(lev_c[q, pl])
            out[1 - luma].append(cost)
    return jnp.stack(out[0]), jnp.stack(out[1])


@pytest.mark.parametrize("P", (8, 16, 32, 64))
def test_rdo_leaf_cost_edges_match_jax(P):
    calls = chip_smoke.k9c_edge_calls(P)
    # both trees at 4 QP points: each QP point's cost is computed alone, so
    # the 1-point calls are the first rows
    rows, _, planes, lev, rec, lev_c, rec_c, qps = calls[1][1]
    params = rg.qp_params(qps).numpy()
    live = rows[:, 6] > 0
    want = dict(zip((True, False), (np.asarray(c) for c in _jax_costs(
        P, _j(rows[live, :5]), *(_j(p) for p in planes), _j(lev[:, live]), _j(rec[:, live]),
        _j(lev_c[:, :, live]), _j(rec_c[:, :, live]), _j(params)))))
    seen = 0
    w, h = rows[live, 3], rows[live, 4]
    for label, args in calls:
        rows, pad, orgs, lev, rec, lev_c, rec_c, qps = args
        t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
        got = rg.rdo_leaf_cost_reference(t(rows), pad, [t(o) for o in orgs], t(lev), t(rec),
                                         t(lev_c), t(rec_c), rg.qp_params(qps)).numpy()
        luma = lev is not None
        _assert_costs(got[:, live], want[luma][:len(qps)], w * h * 3 // 2 if luma else w * h // 2)
        assert not got[:, ~live].any(), label
        seen = seen + chip_smoke.k9c_edge_seen(args, got)
    cases = dict(zip(chip_smoke.K9C_EDGE_CASES, seen))
    # the 8-pad class's SSEs stay below 2^24: the larger classes pass it
    assert all(v > 0 for c, v in cases.items() if P > 8 or c != "SSE above 2^24"), cases


@pytest.mark.parametrize("P", (8, 16, 32, 64))
def test_tq_levels_zero_beyond_rects(P):
    """K5's luma and K4's chroma levels (plain versions) on the P-pad
    class's RDO rows, on K9a's and K9b's predictions at two QP points: zero
    beyond each rect and on padding rows (``chip_smoke.check_levels_inside``)."""
    planes = [torch.from_numpy(p) for p in chip_smoke.rdo_planes(chip_smoke.RDO_W,
                                                                  chip_smoke.RDO_H)]
    oy, ou, ov = planes
    rows = torch.from_numpy(chip_smoke.rdo_rows(P, seed=P, width=chip_smoke.RDO_W,
                                                height=chip_smoke.RDO_H))
    assert (rows[:, 6] <= 0).any() and (rows[:, 3] < P).any() and (rows[:, 4] < P).any()
    og0, Pc = rg._zero_grid(oy), P // 2
    refs = ref_gather_reference([oy], og0, rows, P, 1, BD)
    crefs = ref_gather_reference([ou, ov], og0, rows, Pc, 2, BD)
    modes, pred, cpred = rg.rdo_luma_select_reference(refs, crefs, oy, rows, P, BD)
    dm, _ = rg.rdo_chroma_select_reference(crefs, [ou, ov], rows, Pc, BD)
    qps = chip_smoke.rdo_qp_points(chip_smoke.RDO_W, chip_smoke.RDO_H, (22, 37))
    nz = 0
    for qp_y, qp_c, lam, dw in qps:
        lev = chip_smoke.tq_mts_reference([oy], pred, rows, P, qp_y, BD, True, lam, modes, None,
                                          P <= 32)[0]
        chip_smoke.check_levels_inside(lev[0], rows, P, 1, "K5")
        for cp in (cpred, dm):
            lev_c = chip_smoke.tq_reference([ou, ov], cp, rows, Pc, 2, qp_c, BD, True, lam,
                                            dw)[0]
            chip_smoke.check_levels_inside(lev_c, rows, Pc, 2, "K4")
            nz += int((lev_c != 0).sum())
        nz += int((lev != 0).sum())
    assert nz > 0
