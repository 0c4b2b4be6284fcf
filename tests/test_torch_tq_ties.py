"""K4's plain version against the JAX chroma TQ and joint Cb-Cr trial on
inputs built to make ties.

``chip_smoke.k4_tie_inputs`` builds, per chroma class (pad 16 and 32 of the
wave path, with sign-data hiding; 4 of the device RDO's, without, as the RDO
calls it), calls at internal QP 34 with dw 1: CUs whose separate and joint
TUs all rebuild exactly, so that with lam 0 the joint cost equals the
separate cost and the separate TUs must stay; zero residuals, whose coded
TUs tie the zero TUs at cost 0; equal U and V residuals, whose joint TU
quantises to zero; a CU whose coded TU costs exactly what its zero TU costs
(at an integer lam) although it has levels; coefficient groups whose wrong
parity two sign-data-hiding moves of equal error can fix (pad 16 and 32);
lams at which a group's RD gain sum equals its threshold and a level's gain
equals 3 lam; a CU of every size of the class (chroma sides of 2 among them)
with odd residual differences of both signs; and a padding row. The port's
``tq_reference`` with the trial must give the levels, recon and joint flags
of ``wavefront.py:_tq_generic`` (134-186) and the trial of ``_chroma_part``
(598-633) written with the jitted JAX functions, exactly. chip_smoke.py
holds the CUDA kernel to the same plain version on the same inputs on the
card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu_torch.ops import tq_generic as ttq
from tests.test_torch_codec_ops import BD, _t

QP = chip_smoke.K4_TIE_QP
JAX_ROWS = 24                  # rows a call, padded with copies of the first


@functools.partial(jax.jit, static_argnames=("pad", "sdh"))
def jax_chroma(org, pred, rows, lam, pad, sdh):
    """(lev (2, B, pad, pad), rec, use_joint, separate cost, joint cost):
    ``_chroma_part``'s U, V and joint round trips (``_tq_generic`` at QP,
    dw 1, the three stacked in one call) and its trial."""
    fi, xs, ys = rows[:, 0], rows[:, 1] // 2, rows[:, 2] // 2
    ws, hs = rows[:, 3] // 2, rows[:, 4] // 2
    d = jnp.arange(pad)
    c_in = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    corg = [jwf._gather_plane(org[k], fi[:, None, None], ys[:, None, None] + d[None, :, None],
                              xs[:, None, None] + d[None, None, :]) for k in range(2)]
    res_u, res_v = ((corg[k] - pred[k]) * c_in for k in range(2))
    joint_res = jnp.round((res_u - res_v) / 2.0).astype(jnp.int32)
    cat = lambda *a: jnp.concatenate(a)  # noqa: E731
    n = fi.shape[0]
    lev, rec, rr = jwf._tq_generic(
        cat(corg[0], corg[1], pred[0] + joint_res), cat(pred[0], pred[1], pred[0]),
        cat(ws, ws, ws), cat(hs, hs, hs), QP, BD, lam, 1.0, True, cat(c_in, c_in, c_in),
        sdh=sdh, return_rr=True)
    (lev_u, lev_v, lev_j), (rec_u, rec_v, rec_ju) = (
        [a[k * n:(k + 1) * n] for k in range(3)] for a in (lev, rec))
    rr_j = rr[2 * n:]
    rec_jv = jnp.clip(pred[1] - rr_j, 0, (1 << BD) - 1)
    cbf = lambda lv: (lv != 0).any(axis=(-1, -2))  # noqa: E731

    def _sse(a, b):
        e = ((a - b) * c_in).astype(jnp.float32)
        return (e * e).sum(axis=(-1, -2))
    bits_s = jnp.where(cbf(lev_u), jwf._bits_proxy(lev_u), 1.0) \
        + jnp.where(cbf(lev_v), jwf._bits_proxy(lev_v), 1.0) + 1.0
    bits_j = jwf._bits_proxy(lev_j) + 3.0
    cost_s = 1.0 * (_sse(rec_u, corg[0]) + _sse(rec_v, corg[1])) + lam * bits_s
    cost_j = 1.0 * (_sse(rec_ju, corg[0]) + _sse(rec_jv, corg[1])) + lam * bits_j
    use = cbf(lev_j) & (cost_j < cost_s)
    uj = use[:, None, None]
    lev_out = jnp.stack([jnp.where(uj, lev_j, lev_u), jnp.where(uj, lev_j, lev_v)])
    rec_out = jnp.stack([jnp.where(uj, rec_ju, rec_u), jnp.where(uj, rec_jv, rec_v)])
    return lev_out, rec_out * c_in, use, cost_s, cost_j


def _pad(a, n, axis=0):
    """``a``'s first ``n`` entries along ``axis``, padded to JAX_ROWS with
    copies of its first."""
    a = np.take(np.asarray(a), np.arange(n), axis=axis)
    first = np.take(a, [0] * (JAX_ROWS - n), axis=axis)
    return np.concatenate([a, first], axis=axis)


@pytest.mark.parametrize("pad", [16, 32, 4])
def test_k4_ties_match_jax(pad):
    seen = 0
    for lam, rows, org, pred, kinds in chip_smoke.k4_tie_inputs(pad, seed=pad):
        ok = rows[:, 6] > 0
        n = int(ok.sum())
        assert n <= JAX_ROWS and ok[:n].all() and not ok[n:].any()
        want = [np.asarray(a)[..., :n, :, :] if k < 2 else np.asarray(a)[:n]
                for k, a in enumerate(jax_chroma(
                    jnp.asarray(org), jnp.asarray(_pad(pred, n, 1)), jnp.asarray(_pad(rows, n)),
                    np.float32(lam), pad, chip_smoke.K4_TIE_SDH[pad]))]
        lev, rec, use = (a.numpy() for a in ttq.tq_reference(
            [_t(org[0]), _t(org[1])], _t(pred), _t(rows), pad, 2, QP, BD, True, lam, 1.0,
            chip_smoke.K4_TIE_SDH[pad], None, True, QP))
        np.testing.assert_array_equal(lev[:, :n], want[0])
        np.testing.assert_array_equal(rec[:, :n], want[1])
        np.testing.assert_array_equal(use[:n], want[2])
        assert not lev[:, n:].any() and not rec[:, n:].any() and not use[n:].any()
        # the joint ties are ties in JAX's costs too
        tie = np.array([k == "joint tie" for k in kinds])
        np.testing.assert_array_equal(want[3][tie], want[4][tie])
        assert max(want[3].max(), want[4].max()) < 1 << 24
        seen = seen + chip_smoke.k4_tie_seen(rows, kinds, org, pred, lev, use)
    counted = set(chip_smoke.K4_TIE_CASES) - {"CRS gate (<= 4 samples)",
                                              "LFNST region cut a joint level"} - \
        (set() if chip_smoke.K4_TIE_SDH[pad] else {"SDH moves tied"})
    assert all(c > 0 for case, c in zip(chip_smoke.K4_TIE_CASES, seen) if case in counted), \
        dict(zip(chip_smoke.K4_TIE_CASES, seen))
