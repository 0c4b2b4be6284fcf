"""The port's encode with CCLM (K6a) and joint Cb-Cr coding (K6c) against the
JAX package's, end to end on the CPU.

One seeded 192x128 frame (``chip_smoke.chroma_tool_frames``: anti-correlated
chroma on the left half, where the joint trial wins, and chroma linear in the
downsampled luma on the right half, where LM wins), encoded by both packages'
``WavefrontEncoder`` with MTT maps (seed 6) in the dual-tree configuration of
test_torch_encode_k5.py (MIP, sign-data hiding, MTS, LFNST, transform skip,
deblocking, SAO, the CTC chroma QP table, accel level 3) plus CCLM and joint
Cb-Cr at QP 32. The single-tree encode is in
test_torch_encode_cclm_jccr_single_tree.py (one file each, so that each stays
short on one test worker).

The bitstreams and recon must be byte-identical, the port's stream must
decode hash-verified with the JAX package's decoder, every decision keeps its
margin (the ``margins`` fixture, with the joint Cb-Cr and DM-vs-LM checks),
and the encode must code some chroma CU with LM (code-grid bit 0) and some
chroma TU as a joint residual (bit 1).
"""
import numpy as np
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from chip_smoke import chroma_tool_frames
from test_torch_encode_k5 import MTT, TOOLS
from test_torch_wavefront import margins  # noqa: F401  (fixture)
from test_wavefront import _mtt_maps

torch.set_num_threads(2)

W, H = 192, 128
CHROMA = dict(cclm=True, joint_cbcr=True)
FILTERS = dict(sao=True, deblocking_disabled=False, chroma_qp_start_minus26=-9,
               chroma_qp_points=((9, 12), (4, 5), (11, 7)))


def encode_both(dual_tree: bool):
    """Both encoders on the frame; returns the port's code grid (cg)."""
    kw = dict(width=W, height=H, qp=32, dual_tree=dual_tree, **MTT, **TOOLS, **CHROMA,
              **FILTERS)
    y, u, v = chroma_tool_frames(W, H, 1)[0]
    maps = _mtt_maps(W, H, seed0=6)
    cmaps = _mtt_maps(W, H, chroma_factor=2, seed0=5) if dual_tree else None
    bs_j, rec_j = JaxEncoder(JaxConfig(**kw), accel_level=3).encode_frame(
        y, u, v, maps=maps, chroma_maps=cmaps)
    enc = twf.WavefrontEncoder(VVCConfig(**kw), accel_level=3, device="cpu")
    bs_t, rec_t = enc.encode_frame(y, u, v, maps=maps, chroma_maps=cmaps)
    assert bs_t == bs_j
    for a, b in zip(rec_t, rec_j):
        assert np.array_equal(a, b)
    _, got = decode_stream(bs_t, verify_hash=True)
    assert len(got) == 1
    err = (rec_t[0].astype(np.int64) - y) ** 2
    assert 10 * np.log10(1023 * 1023 / err.mean()) > 30
    return enc._dev_result[9][0]


def assert_both_tools(cg, margins):
    assert (cg & 1).any(), "no chroma CU coded with LM"
    assert (cg & 2).any(), "no chroma TU coded as a joint Cb-Cr residual"
    assert margins["jccr"] and margins["cclm"]


def test_dual_tree_with_cclm_and_jccr(margins):
    assert_both_tools(encode_both(dual_tree=True), margins)
