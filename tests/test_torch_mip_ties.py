"""K3's plain version against the JAX MIP decision on inputs built to make ties.

``chip_smoke.mip_tie_inputs`` builds, per luma class (pad 32 and 64), flat
CUs on references at 512 (every MIP candidate predicts 512 and ties K2's
planar winner, so MIP must lose), CUs whose original is one MIP
candidate's prediction with t = 0 and t = 1 (cost 0, so it must win with
that code), CUs on references whose every MIP input is zero, so that all
candidates give one prediction, the original (all tie at cost 0 below K2's
and the first, code 1, must win), every MIP size class (4x4, 8x8, 4xN /
Nx4, sizeId 2 up to 64x64) and a padding row. The port's ``mip_select_reference`` must give the
JAX decision (``wavefront.py:_make_class_apply`` 402-425 over the jitted
``predict_mip_generic`` and ``satd_generic``) exactly, both after the same
K2 winner: the port's plain RMD on the JAX references (test_torch_rmd_ties.py
and test_torch_codec_ops.py hold it to the JAX RMD; its JAX compiles would
double this file's time). chip_smoke.py holds the CUDA kernel to the same
plain version on the same inputs on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu.ops import mip_generic as jmip
from pmp_vvc_tpu_torch.ops import intra_generic as tig
from pmp_vvc_tpu_torch.ops import mip_generic as tmip
from tests.test_torch_codec_ops import BD, _j, _jsatd, _t, _unpack, jax_refs

_jmip = jax.jit(jmip.predict_mip_generic, static_argnames=("pad", "bit_depth"))


def jax_mip(refs, org, rows, pad, best, pred):
    """(best, pred, code, MIP costs (B, 32) with invalid modes at inf,
    K2's winner's cost): the MIP decision of wavefront.py:402-425 with the
    JAX functions, after K2's winner (``best``, ``pred``)."""
    fi, xs, ys, ws, hs, _, _ = _unpack(rows, 1)
    dy = np.arange(pad)
    orgs = jwf._gather_plane(_j(org), _j(fi)[:, None, None],
                             _j(ys)[:, None, None] + dy[None, :, None],
                             _j(xs)[:, None, None] + dy[None, None, :])
    W, H = _j(ws), _j(hs)
    cost_ang = _jsatd(orgs[:, None], _j(pred)[:, None], W, H)[:, 0]
    mip_preds, n_m = _jmip(_j(refs[0]), _j(refs[1]), W, H, pad=pad, bit_depth=BD)
    mip_costs = _jsatd(orgs[:, None], mip_preds, W, H)
    mi = np.arange(2 * jmip.MAX_MODES)
    valid = (mi[None, :] % jmip.MAX_MODES) < n_m[:, None]
    mip_costs = jnp.where(valid, mip_costs, jnp.inf)
    mb = jnp.argmin(mip_costs, axis=1)
    mip_c = jnp.take_along_axis(mip_costs, mb[:, None], axis=1)[:, 0]
    use_mip = mip_c < cost_ang
    mpred = jnp.take_along_axis(mip_preds, mb[:, None, None, None], axis=1)[:, 0]
    out = jnp.where(use_mip[:, None, None], mpred, _j(pred))
    inside = (dy[None, :, None] < H[:, None, None]) & (dy[None, None, :] < W[:, None, None])
    return (np.asarray(jnp.where(use_mip, 0, _j(best))), np.asarray(jnp.where(inside, out, 0)),
            np.asarray(jnp.where(use_mip, 1 + mb, 0)), np.asarray(mip_costs),
            np.asarray(cost_ang))


@pytest.mark.parametrize("pad", [32, 64])
def test_mip_ties_match_jax(pad):
    rows, rec, org, og, kinds = chip_smoke.mip_tie_inputs(pad, seed=pad)
    refs, ok = jax_refs(rec, og, rows, pad, 1)
    mg = torch.zeros((2, og.shape[1], og.shape[2]), dtype=torch.uint8)
    best, pred = (a.numpy() for a in tig.intra_rmd_reference(_t(refs[None]), _t(org), mg,
                                                             _t(rows), pad, True, BD))
    pred = pred[0]
    want_b, want_p, want_c, costs, cost_ang = jax_mip(refs, org, rows, pad, best, pred)
    got_b, got_p, got_c = tmip.mip_select_reference(
        _t(refs[None]), _t(org), _t(rows), _t(pred[None]).contiguous(),
        _t(best), pad, BD)
    np.testing.assert_array_equal(got_b.numpy()[ok], want_b[ok])
    np.testing.assert_array_equal(got_c.numpy()[ok], want_c[ok])
    np.testing.assert_array_equal(got_p[0].numpy()[ok], want_p[ok])
    # the padding row: a zero tile, K2's mode, code 0
    pad_rows = torch.from_numpy(~ok)
    assert not got_p[0, pad_rows].any() and not got_c[pad_rows].any()
    np.testing.assert_array_equal(got_b.numpy()[~ok], best[~ok])
    # the cases are what they claim: a flat CU's MIP costs all equal K2's
    # winner's; a "tie" CU's are all 0, below K2's; a "mip K" CU's candidate
    # K costs 0, strictly below K2's
    for b, kind in enumerate(kinds):
        valid = np.isfinite(costs[b])
        if kind == "flat":
            assert valid.sum() >= 12 and (costs[b, valid] == cost_ang[b]).all() \
                and cost_ang[b] > 0, (b, costs[b], cost_ang[b])
        elif kind == "tie":
            assert valid.sum() >= 12 and (costs[b, valid] == 0).all() and cost_ang[b] > 0, \
                (b, costs[b], cost_ang[b])
        elif kind.startswith("mip"):
            k = int(kind.split()[1])
            assert costs[b, k] == 0 < cost_ang[b], (b, kind, costs[b], cost_ang[b])
    seen = chip_smoke.mip_tie_seen(rows, kinds, want_c)
    absent = {"sizeId 0"} if pad == 64 else set()      # no 4x4 CU in the 64-pad class
    assert all(n > 0 for case, n in zip(chip_smoke.MIP_TIE_CASES, seen) if case not in absent), \
        seen
