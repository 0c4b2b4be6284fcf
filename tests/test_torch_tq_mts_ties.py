"""K5's plain version against the JAX luma TQ on inputs built to make ties.

``chip_smoke.k5_tie_inputs`` builds, per luma class (pad 32 and 64), a
call at internal QP 4 with lam 0 and the main path's tools: CUs whose
residual DCT-2 rebuilds exactly (cost 0; transform skip ties at 0 in the
32-pad class, and DCT-2, the first candidate, must win), zero residuals
(DCT-2's cost 0 equals the zero TU's, which must win), LFNST basis
residuals on MIP CUs below 16x16 (the gate keeps LFNST out), single
impulses that transform skip alone rebuilds and a CU of every size of the
class; in the 32-pad class a second call with lam 2, where transform
skip's nonzero levels cost exactly what the zero TU costs and the zero TU
must win; each call ends with a padding row, and each case is asserted
with the plain version. The
port's ``tq_mts_reference`` must give ``wavefront.py:_tq_luma_mts``'s
levels, recon, mts_idx and lfnst_idx exactly. chip_smoke.py holds the CUDA
kernel to the same plain version on the same inputs on the card.
"""
import jax
import numpy as np
import pytest

import chip_smoke
from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu_torch.ops import tq_generic as ttq
from tests.test_torch_codec_ops import BD, _j, _t, _unpack

# lam traced, so that a class's calls (lam 0 and 2, rows padded to JAX_ROWS
# by repeating the first) share one compile; for these lam, float32(lam)
# and its products with 2 and 3 are exact, as the static float's are
_jtq_luma = jax.jit(jwf._tq_luma_mts, static_argnums=(4, 5, 7, 9),
                    static_argnames=("lfnst", "sdh", "ts_max"))
JAX_ROWS = 32


def _rows(a, n):
    """``a``'s first ``n`` rows, padded to JAX_ROWS with copies of its first."""
    a = np.asarray(a)[:n]
    return np.concatenate([a, np.repeat(a[:1], JAX_ROWS - n, 0)])


@pytest.mark.parametrize("pad", [32, 64])
def test_k5_ties_match_jax(pad):
    mts, lfnst, ts_max, sdh = chip_smoke.k5_tie_tools(pad)
    qp = chip_smoke.K5_TIE_QP
    seen = 0
    for lam, rows, org, pred, modes, codes, kinds in chip_smoke.k5_tie_inputs(pad, seed=pad):
        fi, xs, ys, ws, hs, _, ok = _unpack(rows, 1)
        live = np.nonzero(ok)[0]
        d = np.arange(pad)
        orgs = jwf._gather_plane(_j(org), _j(fi)[:, None, None],
                                 _j(ys)[:, None, None] + d[None, :, None],
                                 _j(xs)[:, None, None] + d[None, None, :])
        inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
        lfnst_ok = ~((codes > 0) & ~((ws >= 16) & (hs >= 16)))
        n = len(live)
        assert n <= JAX_ROWS and (live == np.arange(n)).all()
        want = [np.asarray(a)[:n] for a in _jtq_luma(
            _j(_rows(orgs, n)), _j(_rows(pred, n)), _j(_rows(ws, n)), _j(_rows(hs, n)), qp,
            BD, np.float32(lam), True, _j(_rows(inside, n)), mts, lfnst=lfnst,
            modes=_j(_rows(modes, n)), lfnst_ok=_j(_rows(lfnst_ok, n)), sdh=sdh,
            ts_max=ts_max)]
        got = [a.numpy() for a in ttq.tq_mts_reference(
            [_t(org)], _t(pred[None]), _t(rows), pad, qp, BD, True, lam, _t(modes), _t(codes),
            mts, lfnst, ts_max, sdh)]
        m = inside[live]
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g[0][live][m], w[m])
            assert not g[0][live][~m].any() and not g[0][~ok].any()
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g[live], w)
            assert not g[~ok].any()
        seen = seen + chip_smoke.k5_tie_seen(rows, kinds, got[0][0], got[2], got[3])
    absent = ({"64-pad CU"} if pad == 32 else
              {"32-pad CU", "transform skip wins an impulse", "zero TU wins a tie with coded levels"})
    assert all((n > 0) == (case not in absent)
               for case, n in zip(chip_smoke.K5_TIE_CASES, seen)), seen
