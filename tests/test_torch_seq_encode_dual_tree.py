"""The port's sequential ``FrameEncoder`` against the JAX package's, end to
end, dual tree.

A 128x128 frame with MTT maps for the luma and the chroma tree, QP 32 with
the bench's chroma QP table, and LMCS with chroma residual scaling, ISP,
CCLM, MRL, dependent quantization, MIP, MTS, LFNST and joint Cb-Cr on,
encoded by both packages on the CPU at ``mode_select="rd"`` (the true-RD
trial of the SATD shortlist, every RMD mode; QP 27, where MRL and ISP both
win a CU of this content) and ``"planar"`` (no mode search: MRL, which
needs an MPM other than planar, cannot occur). The tools that can occur
must fire; the bitstream and recon must be byte-identical, and the port's
stream must decode hash-verified with the JAX package's decoder.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.encoder import FrameEncoder as JaxEncoder
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu_torch.codec.encoder import FrameEncoder
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_encoder_conformance import _synth
from test_wavefront import _mtt_maps

torch.set_num_threads(2)

W = H = 128
TOOLS = dict(width=W, height=H, dual_tree=True, log2_min_cb=2, max_mtt_depth_intra=3,
             max_bt_intra=32, max_tt_intra=32, chroma_max_mtt_depth=3, chroma_max_bt=32,
             chroma_max_tt=32, sao=True, deblocking_disabled=False, lmcs=True,
             lmcs_chroma_scaling=True, isp=True, cclm=True, mrl=True, dep_quant=True,
             mts_intra=True, lfnst=True, joint_cbcr=True, mip=True,
             chroma_qp_start_minus26=-9, chroma_qp_points=((9, 12), (4, 5), (11, 7)))


@pytest.mark.parametrize("mode_select,qp,fired", [
    ("rd", 27, ("n_mrl", "n_isp", "n_depquant", "n_jccr")),
    ("planar", 32, ("n_isp", "n_depquant", "n_cclm", "n_jccr")),
])
def test_dual_tree_map_driven_bit_exact(mode_select, qp, fired):
    y, u, v = _synth(W, H, seed=5)
    maps = _mtt_maps(W, H)
    cmaps = _mtt_maps(W, H, chroma_factor=2, seed0=3)
    enc = FrameEncoder(VVCConfig(qp=qp, **TOOLS), mode_select=mode_select, device="cpu")
    bs, recon = enc.encode_frame(y, u, v, maps=maps, chroma_maps=cmaps)
    assert all(getattr(enc, n) > 0 for n in fired), {n: getattr(enc, n) for n in fired}
    jbs, jrecon = JaxEncoder(JaxConfig(qp=qp, **TOOLS), mode_select=mode_select).encode_frame(
        y, u, v, maps=maps, chroma_maps=cmaps)
    assert bs == jbs
    for a, b in zip(recon, jrecon):
        assert np.array_equal(a, b)
    _, frames = decode_stream(bs, verify_hash=True)
    for a, b in zip(frames[0], recon):
        assert np.array_equal(np.asarray(a), b)
