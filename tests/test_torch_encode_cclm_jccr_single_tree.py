"""The port's single-tree encode with CCLM (K6a) and joint Cb-Cr coding (K6c)
against the JAX package's, end to end on the CPU: the frame, maps, tools and
checks of test_torch_encode_cclm_jccr.py, in single tree (the chroma of each
CU follows its luma in the same wave step, with the CU's own CCLM gate).
"""
import test_torch_encode_cclm_jccr as e2e
from test_torch_wavefront import margins  # noqa: F401  (fixture)


def test_single_tree_with_cclm_and_jccr(margins):
    e2e.assert_both_tools(e2e.encode_both(dual_tree=False), margins)
