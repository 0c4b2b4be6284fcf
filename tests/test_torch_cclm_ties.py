"""K6a's plain version against the JAX DM-vs-LM choice on inputs built to
reach its tie and edge cases.

``chip_smoke.cclm_tie_inputs`` builds, per chroma class (pad 16 and 32 of
the wave path, 4 of the device RDO's chroma tree), a CU of every size the
class admits (sides of 2, non-square CUs whose short side is 4), CUs whose
DM prediction is exactly LM's (a SATD tie, which DM must keep), CUs whose
original is LM's prediction with the CCLM gate off (DM must keep them) and
on (LM must win), CUs whose template makes LM clip at 0 and at pel_max,
flat, two-sample and neighbourless templates, a CU on the CTU top row, one
on the frame's right and bottom edges, and a padding row. The port's
``cclm_select_reference`` must give the choice of ``wavefront.py:
_chroma_part`` (514-541) written with the jitted JAX
``cclm_predict_generic``, ``_avail_from_order`` and ``satd_generic``
exactly, on references that the JAX ``_refs_generic`` and the port's
``ref_gather_reference`` build alike. chip_smoke.py holds the CUDA kernel
to the same plain version on the same inputs on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.ops import tq_generic as jtq
from pmp_vvc_tpu.ops.cclm_generic import cclm_predict_generic as jax_cclm
from pmp_vvc_tpu_torch.ops import cclm_generic as tcclm
from pmp_vvc_tpu_torch.ops.intra_generic import ref_gather_reference
from tests.test_torch_codec_ops import BD, _t, jax_refs

torch.set_num_threads(2)


@functools.partial(jax.jit, static_argnames=("pad",))
def jax_choice(ry, refs, orgs, og, rows, pred, pad):
    """(chosen (2, B, pad, pad), use_lm, DM's SATD, LM's SATD): the choice
    of ``_chroma_part`` (514-541) with the JAX functions."""
    fi, xs, ys, ws, hs, oi, flg = (rows[:, k] for k in (0, 1, 2, 3, 4, 5, 7))
    cxs, cys, cws, chs = xs // 2, ys // 2, ws // 2, hs // 2
    la = jwf._avail_from_order(og, fi, oi, jnp.maximum(cxs - 1, 0) * 2 // 4, cys * 2 // 4,
                               cxs > 0)
    aa = jwf._avail_from_order(og, fi, oi, cxs * 2 // 4, jnp.maximum(cys - 1, 0) * 2 // 4,
                               cys > 0)
    lm = jnp.stack(jax_cclm(ry, fi, cxs, cys, cws, chs, pad_c=pad, top_u=refs[0, 0],
                            left_u=refs[0, 1], top_v=refs[1, 0], left_v=refs[1, 1],
                            bit_depth=BD, left_avail=la, above_avail=aa))
    d = jnp.arange(pad)
    corg = [jwf._gather_plane(o, fi[:, None, None], cys[:, None, None] + d[None, :, None],
                              cxs[:, None, None] + d[None, None, :]) for o in orgs]
    cost = lambda p: sum(jtq.satd_generic(corg[k][:, None], p[k][:, None], cws, chs)[:, 0]
                         for k in range(2))
    cost_dm, cost_lm = cost(pred), cost(lm)
    use = (cost_lm < cost_dm) & ((flg & 1) > 0)
    return jnp.where(use[None, :, None, None], lm, pred), use, cost_dm, cost_lm


@pytest.mark.parametrize("pad", [16, 32, 4])
def test_cclm_ties_match_jax(pad):
    rows, ry, recs, orgs, og, dm, kinds, facts = chip_smoke.cclm_tie_inputs(pad, seed=pad)
    refs = ref_gather_reference([_t(recs[0]), _t(recs[1])], _t(og), _t(rows), pad, 2, BD)
    jrefs = np.stack([jax_refs(r, og, rows, pad, 2)[0] for r in recs])
    ok = rows[:, 6] > 0
    np.testing.assert_array_equal(refs.numpy()[:, :, ok], jrefs[:, :, ok])
    want_p, want_use, cost_dm, cost_lm = (np.asarray(a) for a in jax_choice(
        jnp.asarray(ry), jnp.asarray(jrefs), [jnp.asarray(o) for o in orgs], jnp.asarray(og),
        jnp.asarray(rows), jnp.asarray(dm), pad))
    got_p, got_use = (a.numpy() for a in tcclm.cclm_select_reference(
        refs, _t(ry), [_t(orgs[0]), _t(orgs[1])], _t(og), _t(rows), _t(dm), pad, BD))
    np.testing.assert_array_equal(got_use[ok], want_use[ok])
    d = np.arange(pad)
    inside = (d[None, :, None] < rows[:, 4, None, None] // 2) & \
        (d[None, None, :] < rows[:, 3, None, None] // 2) & ok[:, None, None]
    np.testing.assert_array_equal(got_p * inside, want_p * inside)
    assert not (got_p * ~inside).any() and not got_use[~ok].any()
    # the JAX costs make each case what the inputs claim
    np.testing.assert_array_equal((cost_dm == cost_lm)[ok], facts["tie"][ok])
    np.testing.assert_array_equal((cost_lm < cost_dm)[ok], facts["lm better"][ok])
    assert max(cost_dm.max(), cost_lm.max()) < 1 << 24
    seen = chip_smoke.cclm_tie_seen(rows, kinds, facts, got_p, got_use)
    # no chroma CU of the 4-pad class is non-square with a short side of 4
    absent = {"non-square, short side 4"} if pad == 4 else set()
    assert all(n > 0 for case, n in zip(chip_smoke.CCLM_TIE_CASES, seen) if case not in absent), \
        dict(zip(chip_smoke.CCLM_TIE_CASES, seen))
