"""The port's encode with the bench configuration's coding tools against the
JAX package's, end to end on the CPU: LMCS with chroma residual scaling
(K6b, inside K4), ALF with its chroma filter and CC-ALF, on top of MIP,
sign-data hiding, MTS, LFNST, transform skip, CCLM and joint Cb-Cr
(``bench.py:186-197`` without ``rdo_fallback``, at QP 32).

One seeded 192x128 frame (``chip_smoke.chroma_tool_frames``), encoded by both
packages' ``WavefrontEncoder`` in dual tree with luma and chroma MTT maps.
The single-tree encode at 208x120 is in
test_torch_encode_lmcs_alf_single_tree.py (one file each, so that each stays
short on one test worker).

The bitstreams and recon must be byte-identical, the port's stream must
decode hash-verified with the JAX package's decoder, every decision keeps its
margin (the ``margins`` fixture, with K4's round trips scaled), some chroma
CU is scaled by other than 1 << 11, and some CTU has ALF on and some CC-ALF.
"""
import numpy as np
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.ops.lmcs_generic import UNIT_SCALE
from chip_smoke import chroma_tool_frames
from test_torch_wavefront import margins  # noqa: F401  (fixture)
from test_wavefront import _mtt_maps

torch.set_num_threads(2)

# bench.py:186-197 without rdo_fallback
BENCH = dict(qp=32, sao=True, deblocking_disabled=False, mts_intra=True, mip=True, cclm=True,
             lfnst=True, alf=True, ccalf=True, alf_chroma=True, sign_hiding=True,
             joint_cbcr=True, lmcs=True, lmcs_chroma_scaling=True, transform_skip=True,
             chroma_qp_start_minus26=-9, chroma_qp_points=((9, 12), (4, 5), (11, 7)),
             log2_min_cb=2, max_mtt_depth_intra=3, max_bt_intra=32, max_tt_intra=32)


def encode_both(width, height, dual_tree, maps, cmaps, margins):
    """Both encoders on one ``chroma_tool_frames`` frame; checks the streams,
    the decode, the scales and the ALF / CC-ALF CTUs."""
    kw = dict(width=width, height=height, dual_tree=dual_tree, **BENCH)
    y, u, v = chroma_tool_frames(width, height, 1)[0]
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
    assert any(c != UNIT_SCALE for c in margins["crs"]), "no chroma CU scaled"
    assert enc.alf_ctus["luma"] > 0, enc.alf_ctus
    assert enc.alf_ctus["ccalf_cb"] + enc.alf_ctus["ccalf_cr"] > 0, enc.alf_ctus
    assert {"alf", "replay", "deblock", "sao", "finalize"} <= set(enc.timings)
    return enc


def test_dual_tree_with_the_bench_tools(margins):
    W, H = 192, 128
    encode_both(W, H, True, _mtt_maps(W, H, seed0=6),
                _mtt_maps(W, H, chroma_factor=2, seed0=5), margins)
