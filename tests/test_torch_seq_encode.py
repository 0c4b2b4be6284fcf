"""The port's sequential ``FrameEncoder`` against the JAX package's, end to
end, single tree.

A 160x96 frame (32-sample boundary strips: implicit boundary splits) with
the tools of ``test_encoder_conformance.py:test_boundary_frame_bit_exact``'s
third case — deblocking, SAO, MTS, LFNST, MIP, CCLM, MRL, joint Cb-Cr and
dependent quantization — plus ISP, in single tree, ``mode_select="satd"``
over every fourth RMD mode, encoded by both packages on the CPU (the port
with ``device="cpu"``: the K10 kernels' plain versions). MRL, ISP and the
dependent-quantization trellis must fire; the bitstream and recon must be
byte-identical, and the port's stream must decode hash-verified with the
JAX package's decoder.
"""
import numpy as np
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.encoder import FrameEncoder as JaxEncoder
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu_torch.codec.encoder import FrameEncoder
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_encoder_conformance import _synth

torch.set_num_threads(2)

W, H = 160, 96
TOOLS = dict(width=W, height=H, qp=32, max_mtt_depth_intra=2, max_bt_intra=32,
             max_tt_intra=32, sao=True, deblocking_disabled=False, mts_intra=True,
             lfnst=True, mip=True, cclm=True, mrl=True, joint_cbcr=True, dep_quant=True,
             isp=True)
RMD = tuple(range(0, 67, 4))


def test_single_tree_every_tool_bit_exact():
    y, u, v = _synth(W, H, seed=11)
    enc = FrameEncoder(VVCConfig(**TOOLS), mode_select="satd", rmd_modes=RMD, device="cpu")
    bs, recon = enc.encode_frame(y, u, v, poc=0)
    assert enc.n_mrl > 0 and enc.n_isp > 0 and enc.n_depquant > 0
    assert enc.n_lfnst > 0 and enc.n_cclm > 0
    assert set(enc.timings) >= {"code", "deblock", "sao", "finalize"}
    jbs, jrecon = JaxEncoder(JaxConfig(**TOOLS), mode_select="satd",
                             rmd_modes=RMD).encode_frame(y, u, v, poc=0)
    assert bs == jbs
    for a, b in zip(recon, jrecon):
        assert np.array_equal(a, b)
    _, frames = decode_stream(bs, verify_hash=True)
    for a, b in zip(frames[0], recon):
        assert np.array_equal(np.asarray(a), b)
