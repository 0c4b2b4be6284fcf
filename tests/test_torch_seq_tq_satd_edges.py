"""K10c's and K10d's plain versions against the JAX package on their edge cases.

``chip_smoke.k10c_edge_inputs`` builds calls of the sequential encoder's
transform-quantisation (K10c) with full-scale +-(2^bd - 1) residual patterns
(flat, checkerboards, stripes, the signs of a high-frequency basis, random
signs) at every shape of ``chip_smoke.SEQ_TQ_SHAPES`` and every kind at 8
and 10 bits; levels at the 16-bit limits into the dequantiser and the
inverse, in the signs that drive both inverse clips; QPs where the
dequantiser's shift is 0 or negative, down to -11, the least at 10 bits (a
1x1 TU, through the dequantiser alone), where the product of a level at the
16-bit limit passes 2^31 on the 1x1, 1x2 and 2x1 TUs and wraps in int32 as
the JAX package's does (the plain dequantiser wraps too:
``test_dequantize_wraps_as_jax``); coefficients on the dead zone's
boundaries; negative sums at
a rounding half in the forward and inverse transforms and the
dequantiser; and the zero-out at 64 (DCT-2) and 32 (DST-7 / DCT-8).
``seq_tq_reference`` must give what the jitted JAX ``forward_transform``,
``quantize``, ``dequantize`` and ``inverse_transform`` give, in K10c's
order, and every case must occur (``chip_smoke.k10c_edge_seen``).

``chip_smoke.k10d_edge_inputs`` builds, at a block shape of every VTM tile
shape and at sides that are not powers of two, candidates whose
differences are +-1023 everywhere, DC-only tiles, and non-square tiles whose
sum lands on or next to an integer when float32 scales it, against one
original for all candidates and one per candidate; ``satd_reference`` must
give what the jitted JAX ``satd`` gives.

chip_smoke.py holds the CUDA kernels to the same plain versions on the same
inputs on the card.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pmp_vvc_tpu.ops import distortion as jdist
from pmp_vvc_tpu.ops import quant as jquant
from pmp_vvc_tpu.ops import transforms as jtr
from pmp_vvc_tpu_torch.ops import distortion as tdist
from pmp_vvc_tpu_torch.ops import quant as tquant

torch.set_num_threads(2)


def _jax_stages(stages, kh, kv, qp, bd, h, w):
    """The JAX package's functions in K10c's order on one call's TUs."""
    def run(v):
        outs = []
        if stages & tquant.FWD:
            v = jtr.forward_transform(v, kh, kv, bit_depth=bd)
            outs.append(v)
        if stages & tquant.QUANT:
            v = jquant.quantize(v, w=w, h=h, qp=qp, bit_depth=bd)
            outs.append(v)
        if stages & tquant.DEQUANT:
            v = jquant.dequantize(v, w=w, h=h, qp=qp, bit_depth=bd)
            outs.append(v)
        if stages & tquant.INV:
            v = jtr.inverse_transform(v, kh, kv, bit_depth=bd)
            outs.append(v)
        return jnp.stack(outs)
    return run


@functools.cache
def _k10c_calls():
    return chip_smoke.k10c_edge_inputs()


@functools.cache
def _k10c_case(case):
    """(calls, JAX outputs) of one case: every call of the case in one
    jitted program, which compiles in about half the time that a program
    per call signature takes."""
    calls = [c for c in _k10c_calls() if c[0] == case]
    fns = [_jax_stages(stages, kh, kv, qp, bd, *x.shape[-2:])
           for _, x, stages, kh, kv, qp, bd in calls]
    outs = jax.jit(lambda xs: [f(x) for f, x in zip(fns, xs)])([jnp.asarray(c[1]) for c in calls])
    return calls, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("case", chip_smoke.K10C_EDGE_CASES)
def test_k10c_edges_match_jax(case):
    seen = 0
    calls, wants = _k10c_case(case)
    for (c, x, stages, kh, kv, qp, bd), want in zip(calls, wants):
        got = tquant.seq_tq_reference(torch.from_numpy(x), stages, kind_h=kh, kind_v=kv, qp=qp,
                                      bit_depth=bd).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{x.shape} {stages} {kh} {kv} {qp} {bd}")
        seen += chip_smoke.k10c_edge_seen(case, x, stages, kh, kv, qp, bd, got)
    assert seen > 0, case


def test_k10d_edges_match_jax():
    seen = collections.Counter()
    calls = chip_smoke.k10d_edge_inputs()
    wants = jax.jit(lambda ps: [jdist.satd(o, c) for o, c in ps])(
        [(jnp.asarray(o), jnp.asarray(c)) for o, c in calls])
    for (org, cur), want in zip(calls, wants):
        got = tdist.satd_reference(torch.from_numpy(org), torch.from_numpy(cur)).numpy()
        want = np.asarray(want)
        np.testing.assert_array_equal(got, want, err_msg=f"{org.shape} {cur.shape}")
        seen.update(dict(zip(chip_smoke.K10D_EDGE_CASES, chip_smoke.k10d_edge_seen(org, cur))))
    missing = [c for c in chip_smoke.K10D_EDGE_CASES if not seen[c]]
    assert not missing, missing


@pytest.mark.parametrize("w, h", ((1, 2), (2, 1), (1, 1)))
def test_dequantize_wraps_as_jax(w, h):
    """Levels at the 16-bit limits on a 1x2 and a 2x1 TU at internal QP
    74-75 (dequantiser shift -10) and on a 1x1 TU at QP 72-75 (-11, the
    least): the exact product passes 2^31, and the plain dequantiser gives
    what the jitted JAX ``dequantize`` gives in int32."""
    lev = np.array([[32767, -32768], [-32768, 32767], [-32767, 32767], [1, -32768]],
                   np.int32)[:, :w * h].reshape(4, h, w)
    for qp in chip_smoke.K10C_WRAP_QPS[w, h]:
        t_shift, sqrt2 = tquant._geom(w, h, 10)
        shift = tquant.IQUANT_SHIFT - (t_shift - sqrt2 + qp // 6)
        assert shift == chip_smoke.K10C_MIN_DEQ_SHIFT + (w * h > 1)
        exact = lev.astype(np.int64) * int(tquant.INV_QUANT_SCALES[sqrt2][qp % 6]) << -shift
        assert (np.abs(exact) >= 2 ** 31).any(), qp
        want = np.asarray(jquant.dequantize(jnp.asarray(lev), w=w, h=h, qp=qp, bit_depth=10))
        got = tquant.dequantize_reference(torch.from_numpy(lev), w=w, h=h, qp=qp).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} at QP {qp}")
        assert (got != np.clip(exact, -32768, 32767)).any(), qp   # it did wrap
