"""K10a's and K10b's plain versions against the JAX package on their edge cases.

``chip_smoke.k10a_edge_inputs`` builds calls of the sequential encoder's
intra predictor (K10a) on reference rows of 0 and the peak in turns and in
runs of two, which drive the 4-tap filters' sums past the range and into
the clip, on flat rows and random ones; at the wide-angle sizes from 2:1 to
16:1 (4x64 and 64x4 luma, 2x32 and 32x2 chroma), negative angles whose side
projection reaches its clamp, the angular PDPC and planar's and DC's, DC of
non-square CUs, chroma sides of 2 and 64x64; a single mode, repeated modes,
modes out of order, two CUs of different rows in one call (U and V) and 8
bits. ``predict_block_reference`` must give what the jitted JAX
``predict_block`` gives, and every case must occur in the calls that name
it (``chip_smoke.k10a_edge_seen``).

``chip_smoke.k10b_edge_inputs`` builds MIP calls (K10b) at every size class
and both 16-fold upsamplings, on random rows, rows at 0 and at the peak
and steps, which make the first boundary term negative and clip reduced
samples at 0 and at the peak, at 8 and 10 bits; ``predict_mip_all_reference`` must give
what the jitted JAX ``predict_mip_all`` gives.

The sequential encoder predicts a chroma CU's U and V in one stacked call
(N = 2) where the JAX package makes one call a plane:
``test_stacked_chroma_call`` holds the stacked call to the two single ones.

chip_smoke.py holds the CUDA kernels to the same plain versions on the same
inputs on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pmp_vvc_tpu.ops import intra as jintra
from pmp_vvc_tpu.ops import mip as jmip
from pmp_vvc_tpu_torch.ops import intra as tintra
from pmp_vvc_tpu_torch.ops import mip as tmip

torch.set_num_threads(2)


@functools.cache
def _k10a_calls():
    return chip_smoke.k10a_edge_inputs()


@functools.cache
def _k10a_case(case):
    """(calls, JAX outputs) of one case: every call of the case in one
    jitted program."""
    calls = [c for c in _k10a_calls() if c[0] == case]

    def run(all_refs):
        return [jintra.predict_block(*refs, w=w, h=h, modes=modes, is_luma=luma, bit_depth=bd)
                for refs, (_, _, w, h, modes, luma, bd) in zip(all_refs, calls)]
    outs = jax.jit(run)([tuple(jnp.asarray(r) for r in c[1]) for c in calls])
    return calls, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("case", chip_smoke.K10A_EDGE_CASES)
def test_k10a_edges_match_jax(case):
    calls, wants = _k10a_case(case)
    assert calls, case
    for (_, refs, w, h, modes, luma, bd), want in zip(calls, wants):
        got = tintra.predict_block_reference(*(torch.from_numpy(r) for r in refs), w=w, h=h,
                                             modes=modes, is_luma=luma, bit_depth=bd).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} {modes} {luma} {bd}")
        shown = chip_smoke.k10a_edge_seen(refs, w, h, modes, luma, bd)
        assert shown[chip_smoke.K10A_EDGE_CASES.index(case)], (case, w, h, modes)


def test_k10b_edges_match_jax():
    calls = chip_smoke.k10b_edge_inputs()
    wants = jax.jit(lambda rows: [jmip.predict_mip_all(t, lft, w=w, h=h, bit_depth=bd)
                                  for (t, lft), (_, _, w, h, bd) in zip(rows, calls)])(
        [(jnp.asarray(t), jnp.asarray(lft)) for t, lft, *_ in calls])
    seen = np.zeros(len(chip_smoke.K10B_EDGE_CASES), np.int64)
    for (top, left, w, h, bd), want in zip(calls, wants):
        got = tmip.predict_mip_all_reference(torch.from_numpy(top), torch.from_numpy(left), w=w,
                                             h=h, bit_depth=bd).numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{w}x{h} {bd}")
        seen += chip_smoke.k10b_edge_seen(top, left, w, h, bd)
    missing = [c for c, n in zip(chip_smoke.K10B_EDGE_CASES, seen) if not n]
    assert not missing, missing


def test_stacked_chroma_call():
    """U's and V's rows stacked (N = 2) give what one JAX call a plane
    gives (the JAX calls jitted as one program), at chroma sides of 2 and
    4x4 to 8x8."""
    rng = np.random.RandomState(24)
    kw = dict(modes=chip_smoke.CHROMA_MODES, is_luma=False, bit_depth=10)
    sizes = ((2, 2), (4, 4), (8, 4), (2, 8), (8, 8))
    rows = [chip_smoke.k10a_rows("random", 2, w, h, 10, False, rng) for w, h in sizes]
    wants = jax.jit(lambda all_refs: [
        [jintra.predict_block(*(r[plane:plane + 1] for r in refs), w=w, h=h, **kw)
         for plane in range(2)] for refs, (w, h) in zip(all_refs, sizes)])(
        [tuple(jnp.asarray(r) for r in refs) for refs in rows])
    for refs, (w, h), want in zip(rows, sizes, wants):
        got = tintra.predict_block_reference(*(torch.from_numpy(r) for r in refs), w=w, h=h,
                                             **kw).numpy()
        for plane in range(2):
            np.testing.assert_array_equal(got[plane:plane + 1], np.asarray(want[plane]),
                                          err_msg=f"{w}x{h} plane {plane}")
            one = tintra.predict_block_reference(
                *(torch.from_numpy(r[plane:plane + 1]) for r in refs), w=w, h=h, **kw).numpy()
            np.testing.assert_array_equal(got[plane:plane + 1], one)
