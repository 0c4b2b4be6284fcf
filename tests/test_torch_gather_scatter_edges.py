"""K1's and K7's plain versions against the JAX package on their edge cases.

``chip_smoke.k1_edge_inputs`` builds, in every class K1 runs (the wave
path's 32- and 64-pad luma and 16- and 32-pad chroma classes, the device
RDO's 8-pad luma and 4-pad chroma ones), CUs with no left, top or corner
neighbour, with none available, with only the last top or the first
bottom-left cell available (the substitution backfills over the rest),
with runs of order ids equal to the CU's (unavailable: the test is a
strict ``<``) and of -1, with a reach past the right or bottom picture
edge, w != h, sides of 2 at the chroma pads, frame index 1, samples 0 and
1023, and a padding row. ``ref_gather_reference`` must give what the
jitted JAX ``wavefront.py:_refs_generic`` gives on every live row.

``chip_smoke.k7_edge_inputs`` builds, in the four wave classes, CUs past
the plane's right and bottom edges, 2-wide chroma CUs at odd 2-sample
offsets and 4-wide ones at 2-sample offsets, 4x4 and 64x64 luma CUs, grid
cells past the grid, levels at the int16 limits, frame index 1 and a
padding row, over planes and grids that hold a sentinel. With 0 to 4 code
grids, ``wave_scatter_reference`` must write what the ``.at[...].set(...,
mode="drop")`` scatters of ``wavefront.py:438-462`` write, written here
with the JAX package's ``_OOB``, and leave the sentinel everywhere else.
chip_smoke.py holds the CUDA kernels to the same plain versions on the
same inputs on the card. It also binds the empty kernel that it times
beside them, ``csrc/probes/launch_floor.cu``, itself: that source lies
outside ``csrc/*.cu``, which ``test_torch_kernel_signatures.py`` covers,
so its binding is held to its C prototype here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pmp_vvc_tpu.codec import wavefront as jwf
from pmp_vvc_tpu_torch.codec.wavefront import wave_scatter_reference
from pmp_vvc_tpu_torch.ops.intra_generic import ref_gather_reference
from tests.test_torch_codec_ops import BD, _t, jax_refs
from tests.test_torch_kernel_signatures import _PROTO, _kind

torch.set_num_threads(2)


@pytest.mark.parametrize("pad,scale", chip_smoke.K1_EDGE_CLASSES)
def test_k1_edges_match_jax(pad, scale):
    rows, planes, og = chip_smoke.k1_edge_inputs(pad, scale, seed=pad + scale)
    got = ref_gather_reference([_t(p) for p in planes], _t(og), _t(rows), pad, scale,
                               BD).numpy()
    ok = rows[:, 6] > 0
    for i, plane in enumerate(planes):
        want, _ = jax_refs(plane, og, rows, pad, scale)
        np.testing.assert_array_equal(got[i][:, ok], want[:, ok])
    assert not got[:, :, ~ok].any()
    seen = chip_smoke.k1_edge_seen(rows, og, pad, scale, got)
    missing = [c for c, n in zip(chip_smoke.K1_EDGE_CASES, seen)
               if n == 0 and chip_smoke.edge_case_applies(c, pad, scale)]
    assert not missing, missing


@functools.partial(jax.jit, static_argnames=("pad", "scale"))
def jax_scatter(rows, planes, rec, lev, grids, codes, pad, scale):
    """The scatters of ``wavefront.py:438-462`` (and 634-651 for chroma):
    each plane pair at the CU's (h, w) region, each grid over its 4-sample
    cells, everything else dropped through ``_OOB``."""
    fi, x, y, w, h, live = (rows[:, k] for k in (0, 1, 2, 3, 4, 6))
    ok = live > 0
    xs, ys, ws, hs = x // scale, y // scale, w // scale, h // scale
    d = np.arange(pad)
    o_rows = ys[:, None, None] + d[None, :, None]
    o_cols = xs[:, None, None] + d[None, None, :]
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    srows = jnp.where(ok[:, None, None] & inside, o_rows, jwf._OOB)
    fi3 = fi[:, None, None]
    planes = [(rp.at[fi3, srows, o_cols].set(rec[i], mode="drop"),
               lp.at[fi3, srows, o_cols].set(lev[i].astype(jnp.int16), mode="drop"))
              for i, (rp, lp) in enumerate(planes)]
    d4 = np.arange(pad * scale // 4)
    m_rows = y[:, None, None] // 4 + d4[None, :, None]
    m_cols = x[:, None, None] // 4 + d4[None, None, :]
    m_ok = ok[:, None, None] & (d4[None, :, None] < h[:, None, None] // 4) \
        & (d4[None, None, :] < w[:, None, None] // 4)
    msafe = jnp.where(m_ok, m_rows, jwf._OOB)
    grids = [g.at[fi3, msafe, m_cols].set(
        jnp.broadcast_to(c[:, None, None].astype(jnp.uint8), m_rows.shape), mode="drop")
        for g, c in zip(grids, codes)]
    return planes, grids


@pytest.mark.parametrize("pad,scale", chip_smoke.K7_EDGE_CLASSES)
def test_k7_edges_match_jax(pad, scale):
    rows, rec, lev, codes = chip_smoke.k7_edge_inputs(pad, scale, seed=pad + scale)
    F = len(rows) - 1
    planes0, grids0 = chip_smoke.k7_edge_planes(len(rec), scale, F, "cpu")
    # the JAX scatter with all four grids once; grid k does not depend on the others
    want_p, want_g = jax_scatter(
        jnp.asarray(rows), [(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())) for a, b in planes0],
        jnp.asarray(rec), jnp.asarray(lev), [jnp.asarray(g.numpy()) for g in grids0],
        [jnp.asarray(c) for c in codes], pad, scale)
    seen = np.zeros(len(chip_smoke.K7_EDGE_CASES), np.int64)
    for ngrids in range(5):
        planes, grids = chip_smoke.k7_edge_planes(len(rec), scale, F, "cpu")
        wave_scatter_reference(_t(rows), pad, scale, planes, _t(rec), _t(lev),
                               [(g, _t(c)) for g, c in zip(grids[:ngrids], codes)])
        for (a, b), (ja, jb) in zip(planes, want_p):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        for k, g in enumerate(grids):
            want = np.asarray(want_g[k]) if k < ngrids else grids0[k].numpy()
            np.testing.assert_array_equal(g.numpy(), want)
        kept = sum(int((t == s).sum()) for p in planes
                   for t, s in zip(p, chip_smoke.K7_SENTINEL)) + \
            sum(int((g == chip_smoke.K7_SENTINEL[2]).sum()) for g in grids[:ngrids])
        seen += chip_smoke.k7_edge_seen(rows, pad, scale, lev, ngrids, kept)
    missing = [c for c, n in zip(chip_smoke.K7_EDGE_CASES, seen)
               if n == 0 and chip_smoke.edge_case_applies(c, pad, scale)]
    assert not missing, missing


def test_launch_floor_binding_matches_prototype():
    (name, args), = _PROTO.findall(chip_smoke.LAUNCH_FLOOR_SRC.read_text())
    assert name == "pmp_launch_floor"
    assert [_kind(a) for a in args.split(",") if a.strip()] == list(chip_smoke.LAUNCH_FLOOR_ARGS)
