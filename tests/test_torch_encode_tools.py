"""The port's encode with MIP and sign-data hiding against the JAX
package's, end to end on the CPU.

Two configurations on 192x128 frames, each encoded by both packages'
``WavefrontEncoder``: (a) the slice's dual-tree configuration (MTT maps for
luma and chroma, deblocking, SAO, the CTC chroma QP table, accel level 3)
with ``mip=True, sign_hiding=True`` at QP 22; (b) single tree with both
flags, MTT maps, deblocking and SAO at QP 32. The bitstreams and recon must
be byte-identical, the port's stream must decode hash-verified with the JAX
package's decoder, and each encode must use both tools: some CU coded with
MIP (a nonzero code in the MIP grid) and some coefficient group whose parity
sign-data hiding corrected (counted by the ``margins`` fixture in the plain
pieces). Every decision keeps its margin (test_torch_wavefront.py).
"""
import numpy as np
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_torch_wavefront import margins  # noqa: F401  (fixture)
from test_wavefront import _mtt_maps, _synth

torch.set_num_threads(2)

W, H = 192, 128
MTT = dict(max_mtt_depth_intra=3, max_bt_intra=32, max_tt_intra=32, log2_min_cb=2)
TOOLS = dict(mip=True, sign_hiding=True)
SLICE = dict(MTT, **TOOLS, dual_tree=True, sao=True, deblocking_disabled=False,
             chroma_qp_start_minus26=-9, chroma_qp_points=((9, 12), (4, 5), (11, 7)))


def _encode_both(kw, chroma_maps):
    y, u, v = _synth(W, H)
    maps = _mtt_maps(W, H)
    cmaps = _mtt_maps(W, H, chroma_factor=2, seed0=5) if chroma_maps else None
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
    # the MIP code of each luma leaf
    pg = enc._dev_result[8][0]
    return np.array([pg[y // 4, x // 4] for x, y, *_ in
                     enc._collect_leaves(enc._decider(None, maps))])


def test_dual_tree_with_mip_and_sdh(margins):
    codes = _encode_both(dict(width=W, height=H, qp=22, **SLICE), chroma_maps=True)
    assert (codes > 0).any() and (codes == 0).any()
    assert margins["sdh"], "sign-data hiding corrected no coefficient group"
    assert margins["mip"]


def test_single_tree_with_mip_sdh_and_filters(margins):
    kw = dict(width=W, height=H, qp=32, sao=True, deblocking_disabled=False, **MTT, **TOOLS)
    codes = _encode_both(kw, chroma_maps=False)
    assert (codes > 0).any() and (codes == 0).any()
    assert margins["sdh"], "sign-data hiding corrected no coefficient group"
