"""The port's sequential RDO split search against the JAX package's.

``FrameEncoder.encode_frame(rdo=True)`` (every node of 64x64 or less goes
to ``_rd_search``) and ``rdo_fallback=True`` (the nodes the maps defer) on
``natural_frame(64, 64, seed=21)`` at QP 32 with ``mode_select="satd"``
over every fourth RMD mode, both packages on the CPU (the port with
``device="cpu"``: the K10 kernels' plain versions). The bitstream and
recon must be byte-identical, the choice counters equal, and the port's
stream must decode hash-verified with both packages' ``decode_stream``.

What a rolled-back trial leaves behind: ``n_depquant`` counts the trellis
runs of every trial that gave a level (pinned, and equal to a count of the
trellis's own calls); the choice counters are restored with the snapshot.
The search keeps the JAX package's rate bookkeeping, in which a split
trial's cost and the estimator it carries forward miss its children's
bins (ROADMAP.md queue 3): so at this QP every leaf is 8x8, in both
packages.

Tier-1 runs the single-tree, MTT-depth-0 case with MIP, MRL, ISP, CCLM,
joint Cb-Cr, LFNST, MTS and dependent quantization, and the fallback at
accel level 0 on the same frame (the JAX package's functions compiled by
the first case); the every-tool dual-tree configuration of
``tools/rdcheck.py:ctc_cfg`` and an MTT-depth-1 dual-tree case are
``slow``.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream as jax_decode_stream
from pmp_vvc_tpu.codec.encoder import FrameEncoder as JaxEncoder
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu_torch.codec import encoder as tenc
from pmp_vvc_tpu_torch.codec.decoder import decode_stream
from pmp_vvc_tpu_torch.codec.encoder import FrameEncoder
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.data.synthcontent import natural_frame

torch.set_num_threads(2)

W = H = 64
RMD = tuple(range(0, 67, 4))
TOOLS = dict(mip=True, mrl=True, isp=True, cclm=True, joint_cbcr=True, lfnst=True,
             mts_intra=True, dep_quant=True)
# tools/rdcheck.py:ctc_cfg
CTC = dict(dual_tree=True, mts_intra=True, lfnst=True, mip=True, mrl=True, isp=True, cclm=True,
           joint_cbcr=True, dep_quant=True, sign_hiding=False, lmcs=True,
           lmcs_chroma_scaling=True, sao=True, alf=True, alf_chroma=True, ccalf=True,
           deblocking_disabled=False, chroma_qp_start_minus26=-9,
           chroma_qp_points=((9, 12), (4, 5), (11, 7)))
COUNTERS = ("n_cclm", "n_lfnst", "n_mrl", "n_jccr", "n_isp", "n_nondm")
# trellis runs that gave a level in the tier-1 search: every trial's, the
# rolled-back ones included
SEARCH_DEPQUANT = 1007


@pytest.fixture(scope="module")
def frame():
    return natural_frame(W, H, seed=21)


def _both(frame, cfg_kw, enc_kw=(), **frame_kw):
    """(port encoder, bitstream, recon) after holding the port's encode to
    the JAX package's: equal bytes, recon and counters, and a stream that
    both packages' decoders decode hash-verified to that recon."""
    enc_kw = dict(enc_kw)
    enc = FrameEncoder(VVCConfig(width=W, height=H, qp=32, **cfg_kw), mode_select="satd",
                       rmd_modes=RMD, device="cpu", **enc_kw)
    bs, recon = enc.encode_frame(*frame, **frame_kw)
    jenc = JaxEncoder(JaxConfig(width=W, height=H, qp=32, **cfg_kw), mode_select="satd",
                      rmd_modes=RMD, **enc_kw)
    jbs, jrecon = jenc.encode_frame(*frame, **frame_kw)
    assert bs == jbs
    for a, b in zip(recon, jrecon):
        assert np.array_equal(a, b)
    assert [getattr(enc, n) for n in COUNTERS] == [getattr(jenc, n) for n in COUNTERS]
    for decode, kw in ((jax_decode_stream, {}), (decode_stream, {"device": "cpu"})):
        _, got = decode(bs, verify_hash=True, **kw)
        for a, b in zip(got[0], recon):
            assert np.array_equal(np.asarray(a), b)
    return enc, bs, recon


def test_rdo_true_single_tree_tools(frame, monkeypatch):
    runs = []
    trellis = tenc.dq_ops.dep_quant_trellis

    def counted(*args, **kw):
        lev = trellis(*args, **kw)
        runs.append(bool(lev.any()))
        return lev
    monkeypatch.setattr(tenc.dq_ops, "dep_quant_trellis", counted)
    enc, _, _ = _both(frame, TOOLS, rdo=True)
    assert enc.n_mrl and enc.n_isp and enc.n_cclm and enc.n_jccr
    assert len(enc.leaf_c) > 4
    # n_depquant: every trellis run that gave a level, the rolled-back
    # trials' included; a rollback restores the choice counters alone
    assert enc.n_depquant == sum(runs) == SEARCH_DEPQUANT
    assert len(runs) > SEARCH_DEPQUANT
    counts = [getattr(enc, n) for n in COUNTERS]
    snap = enc._state_snapshot(0, 0, W, H)
    for n in COUNTERS + ("n_depquant",):
        setattr(enc, n, getattr(enc, n) + 1)
    enc._state_restore(snap)
    assert [getattr(enc, n) for n in COUNTERS] == counts
    assert enc.n_depquant == SEARCH_DEPQUANT + 1


def test_rdo_fallback_accel_level_0(frame, monkeypatch):
    calls = []
    search = tenc.FrameEncoder._rd_search

    def counted(self, *args, **kw):
        calls.append(args[3:7])
        return search(self, *args, **kw)
    monkeypatch.setattr(tenc.FrameEncoder, "_rd_search", counted)
    # QT edges on the 16-sample grid, QT depth 1 in the right half and 2 in
    # the left: at L0 the right half's 32x32 nodes and the left half's 16x16
    # nodes leave the map gate and defer to the search
    hor = np.zeros((H // 4, W // 4), np.uint8)
    ver = np.zeros_like(hor)
    hor[::4], ver[:, ::4] = 1, 1
    qt = np.full((H // 8, W // 8), 2, np.int32)
    qt[:, W // 16:] = 1
    maps = (hor, ver, qt, np.zeros((3, H // 4, W // 4), np.int8))
    _both(frame, TOOLS, dict(accel_level=0, rdo_fallback=True), maps=maps)
    # the right half's 16x16 nodes come again inside the 32x32 nodes' QT
    # trials
    assert set(calls) == ({(32, y, 32, 32) for y in (0, 32)}
                          | {(x, y, 16, 16) for x in range(0, W, 16) for y in range(0, H, 16)})


@pytest.mark.slow
@pytest.mark.parametrize("mtt", [0, 1], ids=["ctc-every-tool", "dual-mtt1"])
def test_rdo_true_dual_tree(frame, mtt):
    cfg = CTC if mtt == 0 else dict(dual_tree=True, max_mtt_depth_intra=1,
                                    chroma_max_mtt_depth=1, max_bt_intra=32,
                                    max_tt_intra=32)
    enc, _, _ = _both(frame, cfg, rdo=True)
    assert len(enc.leaf_l) > 4 and len(enc.leaf_c) > 4
