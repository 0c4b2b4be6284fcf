"""K2's plain version against the JAX RMD on inputs built to make ties.

``chip_smoke.rmd_tie_inputs`` builds, per luma class (pad 32 and 64), a flat
CU on flat references (all 35 RMD costs equal: planar must win), CUs whose
original is mode 2's or mode 66's prediction (the refinement's clamp
repeats the winner), and 4xN and Nx4 CUs (4x4 SATD tiles). The port's
``intra_rmd_reference`` must give the JAX RMD's modes and predictions
(``wavefront.py:_make_class_apply`` 373-401, restated in
test_torch_codec_ops.py:jax_rmd) exactly; chip_smoke.py holds the CUDA
kernel to the same plain version on the same inputs on the card.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from pmp_vvc_tpu_torch.ops import intra_generic as tig
from tests.test_torch_codec_ops import BD, _j, _jpredict, _jsatd, _t, _unpack, jax_refs, jax_rmd


def jax_costs(refs, org, rows, pad):
    """(B, 35) SATDs of the RMD candidates, with the JAX functions."""
    fi, xs, ys, ws, hs, _, _ = _unpack(rows, 1)
    d = np.arange(pad)
    orgs = org[fi[:, None, None], np.clip(ys[:, None, None] + d[None, :, None], 0, org.shape[1] - 1),
               np.clip(xs[:, None, None] + d[None, None, :], 0, org.shape[2] - 1)]
    rmd = np.broadcast_to(tig.RMD_MODES, (len(rows), 35))
    preds = _jpredict(*(_j(r) for r in refs), _j(rmd), _j(ws), _j(hs), pad=pad, is_luma=True,
                      bit_depth=BD)
    return np.asarray(_jsatd(_j(orgs)[:, None], preds, _j(ws), _j(hs)))


@pytest.mark.parametrize("pad", [32, 64])
def test_rmd_ties_match_jax(pad):
    rows, rec, org, og, kinds = chip_smoke.rmd_tie_inputs(pad, seed=pad)
    refs, ok = jax_refs(rec, og, rows, pad, 1)
    want_m, want_p = jax_rmd(refs, org, rows, pad)
    mg = torch.zeros((2, og.shape[1], og.shape[2]), dtype=torch.uint8)
    got_m, got_p = tig.intra_rmd_reference(_t(refs[None]), _t(org), mg, _t(rows), pad, True, BD)
    np.testing.assert_array_equal(got_m.numpy()[ok], want_m[ok])
    for b in np.flatnonzero(ok):
        h, w = rows[b, 4], rows[b, 3]
        np.testing.assert_array_equal(got_p[0, b, :h, :w].numpy(), want_p[b, :h, :w],
                                      err_msg=f"{kinds[b]} {w}x{h}")
    assert not got_p[0, ~torch.from_numpy(ok)].any() and not got_m[~torch.from_numpy(ok)].any()
    # the cases are what they claim: a 35-way tie that planar wins, modes 2
    # and 66 winning, 4xN and Nx4 CUs
    costs = jax_costs(refs, org, rows, pad)
    flat = [b for b, k in enumerate(kinds) if k == "flat"]
    assert flat and all((costs[b] == costs[b, 0]).all() and costs[b, 0] > 0 for b in flat)
    seen = chip_smoke.rmd_tie_seen(rows, kinds, want_m)
    assert (seen > 0).all(), seen
