"""The port's device RDO search against the JAX package's, and the margin
that keeps its decisions exact.

A 128x128 frame of natural content in dual tree with the bench's coding
tools (MTS and CCLM reach the RDO) and two QP points (22 and 37) in one
batched search, as the label search runs it: the luma and chroma leaf
costs of every rect against ``DeviceRDO.leaf_cost_arrays`` /
``chroma_leaf_cost_arrays`` of the JAX package (every tile class, the
64-pad class with MTS, the chroma tree with LM), the RMD modes exactly,
and the DP's decisions at every node, with and without the L0 QT ban,
equal to the JAX package's. The port's costs keep every decision of the
chosen trees apart from its runner-up by a relative gap above MARGIN,
far above the costs' disagreement with JAX's (test_torch_rdo.py); a
4-QP search decides as four single-QP searches do.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.codec import rdo_device as jrd
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu.data.synthcontent import natural_frame
from pmp_vvc_tpu_torch.codec import rdo_device as trd
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_accel_levels import _maps
from test_torch_rdo import TABLE, _assert_costs

torch.set_num_threads(2)

MARGIN = 1e-6
W = H = 128
QPS = (22, 37)
TOOLS = dict(mts_intra=True, cclm=True, mip=True, lfnst=True, transform_skip=True,
             sign_hiding=True, joint_cbcr=True, lmcs=True, lmcs_chroma_scaling=True)
FRAME = natural_frame(W, H, seed=11)


@pytest.fixture(scope="module")
def searched():
    """Both packages' leaf costs and the port's geometry, at QP 22 and 37."""
    kw = dict(width=W, height=H, dual_tree=True, **TABLE, **TOOLS)
    encs = [twf.WavefrontEncoder(VVCConfig(qp=qp, **kw), device="cpu") for qp in QPS]
    jencs = [JaxEncoder(JaxConfig(qp=qp, **kw)) for qp in QPS]
    port, jax_rdo = trd.DeviceRDO(encs[0]), jrd.DeviceRDO(jencs[0])
    out = {"encs": encs, "port": port}
    for name, rdo, es in (("port", port, encs), ("jax", jax_rdo, jencs)):
        out[name, "luma"] = rdo.leaf_cost_arrays([FRAME], es)
        out[name, "chroma"] = rdo.chroma_leaf_cost_arrays([FRAME], es)
    return out


def _geom(port, tree):
    return port.geom() if tree == "luma" else port.geom_chroma()


@pytest.mark.parametrize("tree", ("luma", "chroma"))
def test_leaf_costs_match_jax(searched, tree):
    got, want = searched["port", tree], searched["jax", tree]
    if tree == "luma":
        (got, got_m), (want, want_m) = got, want
        np.testing.assert_array_equal(got_m, want_m)
        n_terms = 3
    else:
        n_terms = 1
    rects = _geom(searched["port"], tree).rect_arr
    _assert_costs(got, want, rects[:, 2] * rects[:, 3] * n_terms // 2)


def _entry_costs(geom, leaf_cost, lam, best, mask):
    """Each entry's cost given the nodes' best costs ``best``, as ``solve``
    forms it."""
    e_cost = np.zeros(len(geom.e_split))
    leaf = geom.e_leaf >= 0
    e_cost[leaf] = leaf_cost[geom.e_leaf[leaf]]
    e_cost += lam * trd._SPLIT_BITS_ARR[geom.e_split]
    seg = np.repeat(np.arange(len(e_cost)), geom.e_nchild)
    e_cost += np.bincount(seg, weights=best[geom.children], minlength=len(e_cost))
    if mask is not None:
        e_cost[~mask] = np.inf
    return e_cost


def chosen_tree_gaps(geom, leaf_cost, lam, mask=None):
    """(chosen split per node, relative gaps between the best and the
    second-best entry of every node of the chosen trees that has two finite
    entries)."""
    best, chosen = geom.solve(leaf_cost, lam, mask)
    e_cost = _entry_costs(geom, leaf_cost, lam, best, mask)
    gaps, stack = [], list(geom.roots)
    while stack:
        i = stack.pop()
        ents = np.arange(geom.e0[i], geom.e0[i + 1])
        c = np.sort(e_cost[ents])
        if len(c) > 1 and np.isfinite(c[1]):
            gaps.append((c[1] - c[0]) / abs(c[0]))
        e = ents[geom.e_split[ents] == chosen[i]][0]
        assert e_cost[e] == best[i]
        stack += geom.children[geom.c0[e]:geom.c0[e + 1]].tolist()
    return chosen, np.array(gaps)


@pytest.mark.parametrize("tree", ("luma", "chroma"))
@pytest.mark.parametrize("level0", (False, True), ids=("no ban", "L0 QT ban"))
def test_decisions_match_jax_with_margin(searched, tree, level0):
    geom = _geom(searched["port"], tree)
    mask = geom.qt_ban_mask(_maps(W, H)[2]) if level0 else None
    got, want = searched["port", tree], searched["jax", tree]
    if tree == "luma":
        got, want = got[0], want[0]
    for q, enc in enumerate(searched["encs"]):
        lam = float(enc.lam)
        chosen, gaps = chosen_tree_gaps(geom, got[q, 0], lam, mask)
        np.testing.assert_array_equal(chosen, geom.solve(want[q, 0], lam, mask)[1])
        assert len(gaps) and gaps.min() > MARGIN, gaps.min()


def test_multi_qp_search_decides_as_single_qp_searches(searched):
    """The label search: one batched search over both QP points gives each
    QP the trees of a search at that QP alone."""
    port, encs = searched["port"], searched["encs"]
    multi = (port.search_frames([FRAME], encs), port.search_frames_chroma([FRAME], encs))
    for q, enc in enumerate(encs):
        single = trd.DeviceRDO(enc)
        alone = (single.search_frames([FRAME]), single.search_frames_chroma([FRAME]))
        for t in range(2):
            np.testing.assert_array_equal(multi[t][q][0].chosen, alone[t][0][0].chosen)
            state = twf.SplitState(last_split=twf.Split.QT, qt_depth=1)
            assert multi[t][q][0](0, 0, 64, 64, state) == alone[t][0][0](0, 0, 64, 64, state)
