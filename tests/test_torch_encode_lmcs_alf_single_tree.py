"""The port's single-tree encode with the bench configuration's coding tools
against the JAX package's, end to end on the CPU: the tools and checks of
test_torch_encode_lmcs_alf.py on a 208x120 frame. Its sides are not
multiples of 64, so VPDUs are cut by the right and bottom edges (the chroma
scale's neighbour reads clamp there), and with the maps ``edge_maps`` makes,
CUs wait for their VPDU's luma neighbours before their chroma is scaled
(``vpdu_dep``).
"""
import test_torch_encode_lmcs_alf as e2e
from test_torch_lmcs_alf import edge_maps
from test_torch_wavefront import margins  # noqa: F401  (fixture)


def test_single_tree_with_the_bench_tools(margins):
    e2e.encode_both(208, 120, False, edge_maps(208, 120, seed0=6), None, margins)
