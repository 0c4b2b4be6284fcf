"""K9a's plain version against the JAX RDO's mode selection on tie inputs.

``chip_smoke.k9a_tie_inputs`` builds, per pad class of the device RDO (8,
16, 32, 64), a flat rect on flat references (all 35 RMD costs equal: planar
must win), rects whose original is mode 2's, mode 66's or another even
angular's prediction (cost 0: that mode must win, with no +-1 refinement),
square rects on symmetric references with a symmetric original (modes 2 and
66 tie at the least cost: 2 must win), 4x4, 4x8, 8x4 and 8x8 rects, rects
at x = 0, y = 0 and on the frame's right and bottom edges, and a padding
row. The port's ``rdo_luma_select_reference`` must give the modes, the luma
prediction and the U and V DM predictions of the JAX selection
(``pmp_vvc_tpu/codec/rdo_device.py:_leaf_cost_fn`` 83-121, restated here
with its jitted functions) exactly; chip_smoke.py holds the CUDA kernel to
the same plain version on the same inputs on the card.
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
from pmp_vvc_tpu_torch.ops.intra_generic import RMD_MODES, ref_gather_reference
from tests.test_torch_codec_ops import BD, _j, _unpack

# the cases every class holds; the 8-pad class adds the four small sizes
CLASS_CASES = [c for c in chip_smoke.K9A_TIE_CASES if c not in ("4x4", "4x8", "8x4", "8x8")]


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_select(P, oy, ou, ov, fi, xs, ys, ws, hs):
    og0 = jnp.zeros((oy.shape[0], oy.shape[1] // 4, oy.shape[2] // 4), jnp.int32)
    oi = jnp.ones_like(fi)                        # open loop: all coded
    refs = jwf._refs_generic(oy, og0, fi, oi, xs, ys, ws, hs, P, 1, BD)
    rmd = jnp.asarray(RMD_MODES)
    preds = jig.predict_generic(*refs, jnp.broadcast_to(rmd, (len(fi), 35)), ws, hs, pad=P,
                                is_luma=True, bit_depth=BD)
    dy = np.arange(P)
    orgs = jwf._gather_plane(oy, fi[:, None, None], ys[:, None, None] + dy[None, :, None],
                             xs[:, None, None] + dy[None, None, :])
    costs = jtq.satd_generic(orgs[:, None], preds, ws, hs)
    bi = jnp.argmin(costs, axis=1)
    best = jnp.take(rmd, bi)
    inside = (dy[None, :, None] < hs[:, None, None]) & (dy[None, None, :] < ws[:, None, None])
    pred = jnp.take_along_axis(preds, bi[:, None, None, None], axis=1)[:, 0] * inside
    Pc, dc = P // 2, np.arange(P // 2)
    cws, chs = ws // 2, hs // 2
    c_in = (dc[None, :, None] < chs[:, None, None]) & (dc[None, None, :] < cws[:, None, None])
    # U and V in one call: V's frames follow U's
    two = lambda a: jnp.concatenate([a, a])  # noqa: E731
    crefs = jwf._refs_generic(jnp.concatenate([ou, ov]), two(og0), jnp.concatenate(
        [fi, fi + oy.shape[0]]), two(oi), two(xs // 2), two(ys // 2), two(cws), two(chs), Pc,
        2, BD)
    cpred = jig.predict_generic(*crefs, two(best)[:, None], two(cws), two(chs), pad=Pc,
                                is_luma=False, bit_depth=BD)[:, 0] * two(c_in)
    return costs, best, pred, cpred.reshape(2, len(fi), Pc, Pc)


def jax_select(rows, planes, P):
    """The RMD and DM predictions of ``_leaf_cost_fn`` with the JAX
    functions, in one jit: (costs (B, 35), modes, pred (B, P, P), cpred (2,
    B, P/2, P/2))."""
    fi, xs, ys, ws, hs, _, _ = _unpack(rows, 1)
    out = _jax_select(P, *(_j(a) for a in (*planes, fi, xs, ys, ws, hs)))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("P", sorted(chip_smoke.K9A_TIES))
def test_rdo_select_ties_match_jax(P):
    rows, planes, kinds, places = chip_smoke.k9a_tie_inputs(P, seed=P)
    live = rows[:, 6] > 0
    costs, want_m, want_p, want_c = jax_select(rows[live], planes, P)
    oy, ou, ov = (torch.from_numpy(p) for p in planes)
    rt = torch.from_numpy(rows)
    og0 = rg._zero_grid(oy)
    refs = ref_gather_reference([oy], og0, rt, P, 1, BD)
    crefs = ref_gather_reference([ou, ov], og0, rt, P // 2, 2, BD)
    got_m, got_p, got_c = (t.numpy() for t in
                           rg.rdo_luma_select_reference(refs, crefs, oy, rt, P, BD))
    np.testing.assert_array_equal(got_m[live], want_m)
    np.testing.assert_array_equal(got_p[0, live], want_p)
    np.testing.assert_array_equal(got_c[:, live], want_c)
    assert not got_m[~live].any() and not got_p[:, ~live].any() and not got_c[:, ~live].any()

    # the cases are what they claim: a 35-way tie, cost 0 for the mode a
    # rect was made from, 2 and 66 tied at the least cost with planar and
    # DC above it; then every case of the class occurs
    k = {int(m): i for i, m in enumerate(RMD_MODES)}
    for b, kind in enumerate(kinds):
        c = costs[b]
        if kind == "flat":
            assert (c == c[0]).all() and c[0] > 0, kind
        elif kind.startswith("mode"):
            assert c[k[int(kind.split()[1])]] == 0, kind
        elif kind == "tie 2/66":
            assert c[k[2]] == c[k[66]] == c.min() < c[:2].min(), (kind, c)
    seen = dict(zip(chip_smoke.K9A_TIE_CASES,
                    chip_smoke.k9a_tie_seen(rows, kinds, places, got_m)))
    want = CLASS_CASES if P > 8 else chip_smoke.K9A_TIE_CASES
    assert all(seen[c] > 0 for c in want), seen
