"""The port's encode with MTS, LFNST and transform skip (K5) against the JAX
package's, end to end on the CPU.

One 192x128 frame whose left half is the smooth ``_synth`` content and whose
right half is ``test_transform_skip._content`` (flat regions, hard edges and
noise stripes, where transform skip wins), encoded by both packages'
``WavefrontEncoder`` with MTT maps (seed 6, which splits into CUs from 8x32
to 64x64) in the slice's dual-tree configuration (luma and chroma MTT maps,
deblocking, SAO, the CTC chroma QP table, accel level 3) with MIP,
sign-data hiding, MTS, LFNST and transform skip at QP 22. The single-tree
encode with the same tools is in test_torch_encode_k5_single_tree.py (one
file each, so that each stays short on one test worker).

The bitstreams and recon must be byte-identical, the port's stream must
decode hash-verified with the JAX package's decoder, every decision keeps
its margin (the ``margins`` fixture, K5's included), and each encode must
use every tool: some luma CU coded with DST-7/DCT-8 (mts_idx 2..5), some with
LFNST, some with transform skip (mts_idx 1), and some with none of them.
"""
import numpy as np
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_torch_wavefront import margins  # noqa: F401  (fixture)
from test_transform_skip import _content
from test_wavefront import _mtt_maps, _synth

torch.set_num_threads(2)

W, H = 192, 128
MTT = dict(max_mtt_depth_intra=3, max_bt_intra=32, max_tt_intra=32, log2_min_cb=2)
TOOLS = dict(mip=True, sign_hiding=True, mts_intra=True, lfnst=True, transform_skip=True)
SLICE = dict(MTT, **TOOLS, dual_tree=True, sao=True, deblocking_disabled=False,
             chroma_qp_start_minus26=-9, chroma_qp_points=((9, 12), (4, 5), (11, 7)))


def _frame():
    y, u, v = _synth(W, H)
    cy, cu, cv = _content(W, H)
    y[:, W // 2:], u[:, W // 4:], v[:, W // 4:] = cy[:, W // 2:], cu[:, W // 4:], cv[:, W // 4:]
    return y, u, v


def _encode_both(kw, chroma_maps):
    """Both encoders on the frame; returns the port's (mts_idx, lfnst_idx) of
    each luma leaf."""
    y, u, v = _frame()
    maps = _mtt_maps(W, H, seed0=6)
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
    tg, lg = enc._dev_result[7][0], enc._dev_result[10][0]
    leaves = enc._collect_leaves(enc._decider(None, maps))
    return (np.array([tg[y // 4, x // 4] for x, y, *_ in leaves]),
            np.array([lg[y // 4, x // 4] for x, y, *_ in leaves]))


def _assert_every_tool(tr, lf, margins):
    assert ((tr >= 2) & (tr <= 5)).any(), "no CU coded with DST-7/DCT-8"
    assert (lf > 0).any(), "no CU coded with LFNST"
    assert (tr == 1).any(), "no CU coded with transform skip"
    assert ((tr == 0) & (lf == 0)).any()
    assert margins["k5"] and margins["sdh"]


def test_dual_tree_with_mts_lfnst_and_ts(margins):
    tr, lf = _encode_both(dict(width=W, height=H, qp=22, **SLICE), chroma_maps=True)
    _assert_every_tool(tr, lf, margins)
