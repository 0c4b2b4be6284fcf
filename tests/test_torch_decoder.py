"""The port's decoder on the port's own streams, against the JAX package's.

``tests/test_native_decoder.py``'s tool matrix (its lines 68-139: QT-only
over two frames, MTT maps, dual tree with MTS and LFNST, MIP + MRL + ISP,
CCLM + joint Cb-Cr + sign hiding + deblocking, dependent quantization +
LFNST, SAO + deblocking + the CTC chroma QP table, LMCS with chroma scaling
and most tools, a frame with implicit boundary splits), each frame encoded
by the port's ``FrameEncoder`` on the CPU and decoded by the port's
``decode_stream(verify_hash=True, device="cpu")`` (the K10 kernels' plain
versions): the recon must be the encoder's. On three streams, the last a
dual-tree one with LMCS, ALF, CC-ALF and dependent quantization, the JAX
package's ``decode_stream`` must give the same recon; with one byte of
slice data flipped, both decoders must give the same recon and both refuse
its hash. The decode-side state the port's encoder now carries
(``unit_bdpcm``, ``VDIA``, ``DM_CHROMA``) is the JAX package's and leaves
the streams alone. ``cli.decode`` writes the JAX CLI's output file.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.cli import decode as jax_cli
from pmp_vvc_tpu.codec import encoder as jax_encoder
from pmp_vvc_tpu.codec.decoder import decode_stream as jax_decode_stream
from pmp_vvc_tpu_torch.cli import decode as cli
from pmp_vvc_tpu_torch.codec import encoder as tenc
from pmp_vvc_tpu_torch.codec.decoder import decode_stream
from pmp_vvc_tpu_torch.codec.encoder import FrameEncoder
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.codec.hlsparse import parse_bitstream
from test_native_decoder import _mtt_maps, _synth

torch.set_num_threads(2)

RMD = (0, 1, 18, 34, 50, 63)
MTT = dict(log2_min_cb=3, max_mtt_depth_intra=3, max_bt_intra=32, max_tt_intra=32)
QT2 = np.full((16, 16), 2, np.int32)


def _qt_two_frames():
    qt = np.ones((16, 24), np.int32)
    qt[:8, :8] = 2
    return qt


def _qt_sao():
    qt = np.full((16, 24), 1, np.int32)
    qt[4:, 4:] = 2
    return qt


# name: (VVCConfig keywords, encode_frame keywords, seed, frames, RMD modes)
CASES = {
    "qt_only_two_frames": (dict(width=192, height=128, qp=32),
                           lambda: dict(qt_map=_qt_two_frames()), 7, 2, RMD),
    "mtt_map_driven": (dict(width=128, height=128, qp=32, **MTT),
                       lambda: dict(maps=_mtt_maps(128, 128, 1, 0)), 7, 1, (0, 1, 18, 50)),
    "dual_tree_mts_lfnst": (dict(width=128, height=128, qp=32, dual_tree=True, mts_intra=True,
                                 lfnst=True, chroma_max_mtt_depth=3, chroma_max_bt=32,
                                 chroma_max_tt=32, **MTT),
                            lambda: dict(maps=_mtt_maps(128, 128, 1, 0),
                                         chroma_maps=_mtt_maps(128, 128, 2, 100)), 9, 1, RMD),
    "mip_mrl_isp": (dict(width=128, height=128, qp=32, mip=True, mrl=True, isp=True,
                         mts_intra=True), lambda: dict(qt_map=QT2), 11, 1, RMD),
    "cclm_jccr_sign_hiding_deblock": (dict(width=128, height=128, qp=27, cclm=True,
                                           joint_cbcr=True, sign_hiding=True,
                                           deblocking_disabled=False),
                                      lambda: dict(qt_map=QT2), 5, 1, RMD),
    "dep_quant_lfnst": (dict(width=128, height=128, qp=32, dep_quant=True, lfnst=True),
                        lambda: dict(qt_map=QT2), 13, 1, RMD),
    "sao_deblock_ctc_chroma_qp": (dict(width=192, height=128, qp=37, sao=True,
                                       deblocking_disabled=False, chroma_qp_start_minus26=-9,
                                       chroma_qp_points=((9, 12), (4, 5), (11, 7))),
                                  lambda: dict(qt_map=_qt_sao()), 3, 1, RMD),
    "lmcs_crs_kitchen_sink": (dict(width=128, height=128, qp=30, lmcs=True,
                                   lmcs_chroma_scaling=True, sao=True,
                                   deblocking_disabled=False, mts_intra=True, lfnst=True,
                                   mip=True, isp=True, joint_cbcr=True),
                              lambda: dict(qt_map=QT2), 5, 1, RMD),
    "boundary_frame_implicit_splits": (dict(width=160, height=96, qp=32), dict, 21, 1, RMD),
    # a dual-tree stream with LMCS, ALF, CC-ALF and dependent quantization
    "dual_lmcs_alf_dep_quant": (dict(width=128, height=64, qp=32, dual_tree=True, lmcs=True,
                                     lmcs_chroma_scaling=True, alf=True, alf_chroma=True,
                                     ccalf=True, dep_quant=True, mip=True, cclm=True,
                                     deblocking_disabled=False, sao=True),
                                lambda: dict(qt_map=np.full((8, 16), 2, np.int32)), 17, 1,
                                RMD),
}
# the streams the JAX package's decoder also decodes
WITH_JAX = ("mip_mrl_isp", "boundary_frame_implicit_splits", "dual_lmcs_alf_dep_quant")


def _encode(name):
    cfg_kw, frame_kw, seed, frames, rmd = CASES[name]
    cfg = VVCConfig(**cfg_kw)
    enc = FrameEncoder(cfg, mode_select="satd", rmd_modes=rmd, device="cpu")
    bs, recons = b"", []
    for poc in range(frames):
        b, recon = enc.encode_frame(*_synth(cfg.width, cfg.height, seed + poc), poc=poc,
                                    **frame_kw())
        bs += b
        recons.append(recon)
    return bs, recons


@pytest.fixture(scope="module")
def streams():
    return {}


def _stream(streams, name):
    if name not in streams:
        streams[name] = _encode(name)
    return streams[name]


@pytest.mark.parametrize("name", list(CASES))
def test_decoder_reproduces_the_encoders_recon(streams, name):
    bs, recons = _stream(streams, name)
    _, got = decode_stream(bs, verify_hash=True, device="cpu")
    assert len(got) == len(recons)
    for f, recon in enumerate(recons):
        for plane, (a, b) in enumerate(zip(got[f], recon)):
            assert np.array_equal(a, b), (f, plane, np.argwhere(a != b)[:4])
    if name in WITH_JAX:
        _, want = jax_decode_stream(bs, verify_hash=True)
        for f in range(len(recons)):
            for a, b in zip(got[f], want[f]):
                assert np.array_equal(a, np.asarray(b))


def _flip(bs):
    """``bs`` with the low bit of its slice data's 146th byte from the end
    flipped: a flip after which the parse still reaches the end-of-slice
    bit (most flips desynchronise the arithmetic decoder, and both decoders
    then stop at that bit), with a recon that differs from the encoder's."""
    data = bytearray(bs)
    si = parse_bitstream(bs).slices[0]
    data[bytes(data).index(si.slice_data) + len(si.slice_data) - 146] ^= 0x01
    return bytes(data)


def _verdicts(frames, hashes):
    import hashlib
    return [[hashlib.md5(np.asarray(p).astype("<u2").tobytes()).digest() == want
             for p, want in zip(frame, hs)] for frame, hs in zip(frames, hashes)]


def test_flipped_byte_fails_the_hash_in_both_decoders(streams):
    bad = _flip(_stream(streams, "mip_mrl_isp")[0])
    hashes = parse_bitstream(bad).hashes
    _, got = decode_stream(bad, verify_hash=False, device="cpu")
    _, want = jax_decode_stream(bad, verify_hash=False)
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, np.asarray(b))
    assert _verdicts(got, hashes) == _verdicts(want, hashes)
    assert not all(_verdicts(got, hashes)[0])
    for decode, kw in ((decode_stream, {"device": "cpu"}), (jax_decode_stream, {})):
        with pytest.raises(AssertionError, match="picture hash mismatch"):
            decode(bad, verify_hash=True, **kw)


def test_decode_side_state_is_the_jax_packages(streams):
    """The constants and grids the decoder reads are the JAX package's, and
    the encoder leaves the BDPCM grids clear: the port's streams are as
    before (``test_torch_seq_encode*.py`` hold them to the JAX package's)."""
    assert (tenc.VDIA, tenc.DM_CHROMA) == (jax_encoder.VDIA, jax_encoder.DM_CHROMA) == (66, 67)
    cfg_kw, frame_kw, seed, _, rmd = CASES["mip_mrl_isp"]
    enc = FrameEncoder(VVCConfig(**cfg_kw), mode_select="satd", rmd_modes=rmd, device="cpu")
    bs, _ = enc.encode_frame(*_synth(128, 128, seed), **frame_kw())
    assert bs == _stream(streams, "mip_mrl_isp")[0]
    assert enc.unit_bdpcm.shape == enc.unit_bdpcm_c.shape == enc.coded.shape
    assert not enc.unit_bdpcm.any() and not enc.unit_bdpcm_c.any()


@pytest.mark.parametrize("hash_check", [True, False], ids=["hash", "no-hash-check"])
def test_cli_decode_writes_the_jax_clis_file(streams, tmp_path, capsys, hash_check):
    src = tmp_path / "in.bin"
    src.write_bytes(_stream(streams, "qt_only_two_frames")[0])
    outs, logs = [], []
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        out = tmp_path / f"{tag}.yuv"
        argv = ["-b", str(src), "-o", str(out)] + extra + ([] if hash_check
                                                           else ["--no-hash-check"])
        assert main(argv) == 0
        outs.append(out.read_bytes())
        logs.append([l for l in capsys.readouterr().out.splitlines() if l.startswith("POC")])
    assert outs[0] == outs[1] and len(outs[0]) == 2 * 192 * 128 * 3
    assert logs[0] == logs[1] and len(logs[0]) == 2
    assert all(("(OK)" in l) == hash_check for l in logs[0])
