"""The port's device RDO (K9) against the JAX package's, at the op level.

``ops/rdo_generic.py``'s ``luma_leaf_costs`` and ``chroma_leaf_costs`` (the
kernels' plain versions composed as on the card: K1, K9a / K9b, K5 / K4,
K6a, K9c) against the jitted ``codec/rdo_device.py:_leaf_cost_fn`` and
``_chroma_leaf_cost_fn`` on seeded rows of every tile class, rects at the
frame's top-left and bottom-right corners and with chroma sides of 2, two QP
points in one call, and a frame whose SSEs reach above 2^24. The modes
agree exactly. The JAX package sums each plane's float32 squares in XLA's
order, the port exactly in int64 and rounds once: below 2^24 every partial
sum is exact, and the costs agree to RTOL; above it, XLA's partial sums
round, by up to 82 ulps of the cost (6.2e-6) on this input's 64x64 rects
(its own sum of 4096 squares is ~1,400 off the exact one), and the costs
agree within the float32 bound of a sum of that many terms, one ulp of the
cost per term (``_assert_costs``). The chroma tree with CCLM on is in
test_torch_rdo_search.py, with the search itself.

Then the host part of ``codec/rdo_device.py``: the node DAG arrays of
both packages in dual and single tree at 128x128, 208x120 and 264x136
(CTUs inside the frame and cut by both edges), ``solve``
and ``qt_ban_mask`` on the same costs (hand-made ties included), the QP
points, leaf costs that do not depend on the chunk size, and the traps the
port must not fall into: no +-1 refinement, and no tool but MTS, RD
zeroing and CCLM reaching the costs (the original planes unmapped with
LMCS).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pmp_vvc_tpu.codec import rdo_device as jrd
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu.data.synthcontent import natural_frame
from pmp_vvc_tpu_torch.codec import rdo_device as trd
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.ops import rdo_generic as rg
from pmp_vvc_tpu_torch.ops.intra_generic import RMD_MODES, intra_rmd_reference, ref_gather

torch.set_num_threads(2)

RTOL = 1e-6
BD = 10
W, H, F = 128, 96, 2
# the bench's chroma QP table and partitioning (bench.py:186-197)
TABLE = dict(chroma_qp_start_minus26=-9, chroma_qp_points=((9, 12), (4, 5), (11, 7)),
             log2_min_cb=2, max_mtt_depth_intra=3, max_bt_intra=32, max_tt_intra=32)


def _frames():
    """A natural frame, and one with strong noise (SSEs above 2^24 in the
    64-pad class)."""
    a = natural_frame(W, H, seed=3)
    rng = np.random.RandomState(4)
    b = tuple(np.clip(p + rng.randint(-400, 401, p.shape), 0, 1023).astype(np.int32)
              for p in natural_frame(W, H, seed=5))
    return [a, b]


FRAMES = _frames()
PLANES = [np.stack([f[i] for f in FRAMES]).astype(np.int32) for i in range(3)]


def _qps():
    """Two QP points (22 and 37) of the bench's chroma QP table, from the
    port's encoders, held to the JAX package's."""
    encs = [twf.WavefrontEncoder(VVCConfig(width=W, height=H, qp=qp, **TABLE), device="cpu")
            for qp in (22, 37)]
    jencs = [JaxEncoder(JaxConfig(width=W, height=H, qp=qp, **TABLE)) for qp in (22, 37)]
    return trd.DeviceRDO._qp_points(encs), jrd.DeviceRDO(jencs[0])._qp_points(jencs)


QPS, JAX_QPS = _qps()


def test_qp_points_match_jax():
    # the port's _qps also returns the joint QP; the RDO takes the first two
    assert QPS == JAX_QPS
    assert len(QPS[0]) == 4


def _rows(P, seed):
    """(B, 5) int32 rows (frame, x, y, w, h) of the P-pad class: every
    size with its longer side in the class, at the frame's top-left and
    bottom-right corners and at random 4-aligned positions."""
    rng = np.random.RandomState(seed)
    sides = [s for s in (4, 8, 16, 32, 64) if s <= P]
    sizes = [(w, h) for w in sides for h in sides if max(w, h) == P or P == 8]
    rows = []
    for i, (w, h) in enumerate(sizes * 3):
        x = rng.randint(0, (W - w) // 4 + 1) * 4
        y = rng.randint(0, (H - h) // 4 + 1) * 4
        if i < len(sizes):
            x, y = (0, 0) if i % 2 else (W - w, H - h)
        rows.append((i % F, x, y, w, h))
    return np.array(rows, np.int32)


def _port_rows(rows):
    """The wave-step rows of the port: order id 1, live, CCLM gate; two
    padding rows after them."""
    out = np.zeros((len(rows) + 2, 8), np.int32)
    out[:len(rows), :5] = rows
    out[:len(rows), 5:] = 1
    return torch.from_numpy(out)


def _assert_costs(got, want, n_terms):
    """``got`` against ``want`` (nQP, B) float32: to RTOL below 2^24, and
    above it within ``n_terms`` (B,) ulps of the cost, the float32 error
    bound of a sum of that many squares."""
    small = want < 2 ** 24
    np.testing.assert_allclose(got[small], want[small], rtol=RTOL)
    bound = np.broadcast_to(n_terms, want.shape)[~small] * np.spacing(want[~small])
    assert (np.abs(got[~small] - want[~small]) <= bound).all()


def _jax_args(rows):
    og0 = jnp.zeros((F, H // 4, W // 4), jnp.int32)
    return (jnp.asarray(rows), *(jnp.asarray(p) for p in PLANES), og0)


@pytest.mark.parametrize("P", (8, 16, 32, 64))
def test_luma_leaf_costs_match_jax(P):
    """MTS on in every class: no MTS candidate is legal in the 64-pad class,
    where the port runs K5 without it."""
    rows = _rows(P, seed=P)
    want_c, want_m = (np.asarray(a) for a in
                      jrd._leaf_cost_fn(P, JAX_QPS, BD, True, True)(*_jax_args(rows)))
    got_c, got_m = rg.luma_leaf_costs(_port_rows(rows), *map(torch.from_numpy, PLANES), P,
                                      QPS, BD, True, True)
    n = len(rows)
    np.testing.assert_array_equal(got_m[:n].numpy(), want_m)
    _assert_costs(got_c[:, :n].numpy(), want_c, rows[:, 3] * rows[:, 4] * 3 // 2)
    assert (got_c[:, n:] == 0).all() and (got_m[n:] == 0).all()   # padding rows
    if P == 8:      # 4-sample luma sides: chroma sides of 2
        assert (rows[:, 3] == 4).any() and (rows[:, 4] == 4).any()
    if P == 64:     # the noisy frame's SSEs pass 2^24
        assert got_c[:, :n].max() > 2 ** 24


@pytest.mark.parametrize("P", (8, 16, 32, 64))
def test_chroma_leaf_costs_match_jax(P):
    rows = _rows(P, seed=P + 1)
    want = np.asarray(jrd._chroma_leaf_cost_fn(P, JAX_QPS, BD, True, False)(*_jax_args(rows)))
    got = rg.chroma_leaf_costs(_port_rows(rows), *map(torch.from_numpy, PLANES), P, QPS, BD,
                               True, False)
    _assert_costs(got[:, :len(rows)].numpy(), want, rows[:, 3] * rows[:, 4] // 2)


def test_rdo_does_not_refine():
    """K2 refines its RMD winner by +-1; the RDO's RMD keeps the 35 modes.
    On these rows K2 ends on an odd angular somewhere, the RDO never."""
    rows = _port_rows(_rows(16, seed=9))
    oy = torch.from_numpy(PLANES[0])
    og0 = torch.zeros((F, H // 4, W // 4), dtype=torch.int32)
    refs = ref_gather([oy], og0, rows, 16, 1, BD)
    crefs = ref_gather([torch.from_numpy(p) for p in PLANES[1:]], og0, rows, 8, 2, BD)
    modes = rg.rdo_luma_select(refs, crefs, oy, rows, 16, BD)[0]
    k2 = intra_rmd_reference(refs, oy, None, rows, 16, True, BD)[0]
    assert set(modes.tolist()) <= set(RMD_MODES.tolist())
    assert not set(k2.tolist()) <= set(RMD_MODES.tolist())


def _geom_arrays(g):
    return dict(keys=g.keys, rects=g.rects, roots=g.roots, groups=g.groups, e0=g.e0,
                e_node=g.e_node, e_split=g.e_split, e_leaf=g.e_leaf, c0=g.c0,
                children=g.children)


def _both_rdo(width, height, dual_tree, **kw):
    cfg = dict(width=width, height=height, dual_tree=dual_tree, **TABLE, **kw)
    return (trd.DeviceRDO(twf.WavefrontEncoder(VVCConfig(**cfg), device="cpu")),
            jrd.DeviceRDO(JaxEncoder(JaxConfig(**cfg))))


@pytest.mark.parametrize("size", ((128, 128), (208, 120), (264, 136)),
                         ids=("128x128", "208x120", "264x136"))
@pytest.mark.parametrize("dual_tree", (True, False), ids=("dual", "single"))
def test_geometry_matches_jax(size, dual_tree):
    port, jax_rdo = _both_rdo(*size, dual_tree)
    pairs = [(port.geom(), jax_rdo.geom())]
    if dual_tree:
        pairs.append((port.geom_chroma(), jax_rdo.geom_chroma()))
    for got, want in pairs:
        for name, a in _geom_arrays(got).items():
            b = _geom_arrays(want)[name]
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name


def test_solve_and_qt_ban_match_jax():
    """``solve`` with and without the L0 QT ban on random costs, then on
    costs full of exact ties (flat leaves: every split ties its children's
    sum): the earliest entry wins in both packages."""
    port, jax_rdo = _both_rdo(128, 128, True)
    rng = np.random.RandomState(0)
    qt_map = rng.randint(0, 4, (16, 16))
    for g_t, g_j in ((port.geom(), jax_rdo.geom()), (port.geom_chroma(), jax_rdo.geom_chroma())):
        mask_t, mask_j = g_t.qt_ban_mask(qt_map), g_j.qt_ban_mask(qt_map)
        np.testing.assert_array_equal(mask_t, mask_j)
        assert not mask_t.all()
        R = len(g_t.rects)
        areas = np.array([w * h for _, _, w, h in g_t.rects], np.float64)
        for costs, lam in ((rng.rand(R) * 1e4, 3.7), (areas * 2.0, 0.0), (np.full(R, 5.0), 0.0)):
            for mask in (None, mask_t):
                bt, ct = g_t.solve(costs, lam, mask)
                bj, cj = g_j.solve(costs, lam, mask)
                np.testing.assert_array_equal(bt, bj)
                np.testing.assert_array_equal(ct, cj)


def test_leaf_costs_do_not_depend_on_chunk_size(monkeypatch):
    port, _ = _both_rdo(64, 64, True, mts_intra=True, cclm=True)
    frames = [tuple(p[:64, :64].copy() for p in FRAMES[0])]
    base = port.leaf_cost_arrays(frames), port.chroma_leaf_cost_arrays(frames)
    monkeypatch.setattr(trd, "_BATCH_CPU", {8: 100, 16: 37, 32: 9, 64: 3})
    small = port.leaf_cost_arrays(frames), port.chroma_leaf_cost_arrays(frames)
    np.testing.assert_array_equal(base[0][0], small[0][0])
    np.testing.assert_array_equal(base[0][1], small[0][1])
    np.testing.assert_array_equal(base[1], small[1])
    # the single-frame dict form of the same costs and modes
    costs, modes = port._leaf_costs(None, *frames[0])
    rects = port.geom().rects
    assert [costs[r] for r in rects] == list(base[0][0][0, 0])
    assert [modes[r] for r in rects] == list(base[0][1][0])


def test_only_mts_rd_quant_and_cclm_reach_the_costs():
    """The RDO prices the unmapped original whatever the configuration:
    MIP, LFNST, transform skip, SDH, joint Cb-Cr and LMCS with chroma
    scaling leave its costs as they are."""
    frames = [tuple(p[:64, :64].copy() for p in FRAMES[0])]
    plain, _ = _both_rdo(64, 64, True, mts_intra=True, cclm=True)
    tools, _ = _both_rdo(64, 64, True, mts_intra=True, cclm=True, mip=True, lfnst=True,
                         transform_skip=True, sign_hiding=True, joint_cbcr=True, lmcs=True,
                         lmcs_chroma_scaling=True)
    a, b = plain.leaf_cost_arrays(frames), tools.leaf_cost_arrays(frames)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(plain.chroma_leaf_cost_arrays(frames),
                                  tools.chroma_leaf_cost_arrays(frames))


@pytest.mark.parametrize("P", (4, 8))
def test_sdh_group_table_covers_the_small_pads(P):
    """K4's coefficient-group table at the RDO's chroma pads: every scan
    position of every TB shape once, a 2x4 TB's two 2x2 groups at pad 4."""
    from pmp_vvc_tpu_torch.codec.residual import grouped_scan
    from pmp_vvc_tpu_torch.ops.sdh_generic import _cg_tables
    tab = _cg_tables(P)
    for lw in range(1, P.bit_length()):
        for lh in range(1, P.bit_length()):
            got = sorted(int(i) for i in tab[lw * 7 + lh].ravel() if i >= 0)
            scan = grouped_scan(1 << lw, 1 << lh)
            assert got == sorted(int(y) * P + int(x) for _, x, y in scan[:, :3])
    assert (tab[1 * 7 + 2, 1] >= 0).sum() == 4
