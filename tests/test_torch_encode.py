"""The port's map-driven encode against the JAX package's, end to end.

Three configurations on 192x128 frames, each encoded by both packages'
``WavefrontEncoder`` on the CPU: single tree with QT-only maps (two frames,
and the same with ``pipeline_chunk``), single tree with MTT maps and
deblocking + SAO, and the slice's dual-tree configuration with luma and
chroma MTT maps. The bitstreams and recon must be byte-identical, and the
port's stream must decode hash-verified with the JAX package's decoder.
Every K4 and K5 decision keeps a relative margin above MARGIN
(test_torch_codec_ops.py). Every flag the port does not support (the
sequential-only tools) raises; every coding tool of the bench
configuration and the device RDO fallback are accepted (the
test_torch_encode_*.py files encode with them), and the sequential
encoder's own RDO split search gives the JAX package's stream.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.encoder import RDO as JAX_RDO
from pmp_vvc_tpu.codec.encoder import FrameEncoder as JaxFrameEncoder
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.encoder import RDO, FrameEncoder
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_torch_wavefront import margins  # noqa: F401  (fixture)
from test_wavefront import _mtt_maps, _synth

torch.set_num_threads(2)

W, H = 192, 128
MTT = dict(max_mtt_depth_intra=3, max_bt_intra=32, max_tt_intra=32, log2_min_cb=2)
SLICE = dict(MTT, dual_tree=True, sao=True, deblocking_disabled=False,
             chroma_qp_start_minus26=-9, chroma_qp_points=((9, 12), (4, 5), (11, 7)))


def _check(bs_t, rec_t, bs_j, rec_j, frames=1):
    assert bs_t == bs_j
    for a, b in zip(rec_t, rec_j):
        assert np.array_equal(a, b)
    _, got = decode_stream(bs_t, verify_hash=True)
    assert len(got) == frames


def test_single_tree_qt_only_two_frames(margins):
    kw = dict(width=W, height=H, qp=32)
    frames = [_synth(W, H, seed=7 + f) for f in range(2)]
    want = JaxEncoder(JaxConfig(**kw)).encode_frames(frames)
    enc = twf.WavefrontEncoder(VVCConfig(**kw), device="cpu")
    got = enc.encode_frames(frames)
    chunked = enc.encode_frames(frames, pipeline_chunk=1)
    for f in range(2):
        assert got[f][0] == want[f][0] == chunked[f][0]
        for a, b, c in zip(got[f][1], want[f][1], chunked[f][1]):
            assert np.array_equal(a, b) and np.array_equal(a, c)
    _check(got[0][0] + got[1][0], [], want[0][0] + want[1][0], [], frames=2)


def test_single_tree_mtt_maps_with_filters(margins):
    kw = dict(width=W, height=H, qp=27, sao=True, deblocking_disabled=False, **MTT)
    y, u, v = _synth(W, H)
    maps = _mtt_maps(W, H)
    bs_j, rec_j = JaxEncoder(JaxConfig(**kw)).encode_frame(y, u, v, maps=maps)
    bs_t, rec_t = twf.WavefrontEncoder(VVCConfig(**kw), device="cpu").encode_frame(
        y, u, v, maps=maps)
    _check(bs_t, rec_t, bs_j, rec_j)


def test_dual_tree_slice_configuration(margins):
    kw = dict(width=W, height=H, qp=22, **SLICE)
    y, u, v = _synth(W, H)
    maps = _mtt_maps(W, H)
    cmaps = _mtt_maps(W, H, chroma_factor=2, seed0=5)
    bs_j, rec_j = JaxEncoder(JaxConfig(**kw), accel_level=3).encode_frame(
        y, u, v, maps=maps, chroma_maps=cmaps)
    enc = twf.WavefrontEncoder(VVCConfig(**kw), accel_level=3, device="cpu")
    bs_t, rec_t = enc.encode_frame(y, u, v, maps=maps, chroma_maps=cmaps)
    _check(bs_t, rec_t, bs_j, rec_j)
    err = (rec_t[0].astype(np.int64) - y) ** 2
    assert 10 * np.log10(1023 * 1023 / err.mean()) > 30
    assert set(enc.timings) >= {"collect", "schedule", "upload", "scan", "fetch",
                                "replay", "deblock", "sao", "finalize"}


@pytest.mark.parametrize("flag", twf.UNSUPPORTED_TOOLS)
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError):
        twf.WavefrontEncoder(VVCConfig(width=64, height=64, **{flag: True}),
                             device="cpu")


def test_mip_and_sign_hiding_are_accepted():
    tools = ("mip", "sign_hiding", "mts_intra", "lfnst", "transform_skip", "cclm",
             "joint_cbcr", "lmcs", "lmcs_chroma_scaling", "alf", "alf_chroma", "ccalf")
    enc = twf.WavefrontEncoder(VVCConfig(width=64, height=64, **dict.fromkeys(tools, True)),
                               device="cpu")
    assert all(getattr(enc.cfg, t) for t in tools)
    assert not set(tools) & set(twf.UNSUPPORTED_TOOLS)


def test_rdo_paths_raise():
    """Kept under its old name. The wavefront encoder takes the device RDO
    (``rdo_fallback``; the test_torch_encode_rdo*.py files encode with it);
    the sequential ``FrameEncoder``'s own split search, which a deciding
    node defers to, runs and gives the JAX package's stream and recon
    (``test_torch_seq_rdo.py`` holds it with the coding tools)."""
    enc = twf.WavefrontEncoder(VVCConfig(width=64, height=64), rdo_fallback=True,
                               device="cpu")
    assert enc.rdo_fallback
    y, u, v = _synth(64, 64)
    bs, recon = FrameEncoder(VVCConfig(width=64, height=64), mode_select="planar",
                             device="cpu").encode_frame(y, u, v, decide_fn=lambda *a: RDO)
    jbs, jrecon = JaxFrameEncoder(JaxConfig(width=64, height=64),
                                  mode_select="planar").encode_frame(
        y, u, v, decide_fn=lambda *a: JAX_RDO)
    _check(bs, recon, jbs, jrecon)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twf.WavefrontEncoder(VVCConfig(width=64, height=64))
