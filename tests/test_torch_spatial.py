"""The port's spatial-stripe scan (K12b) on the CPU over gloo.

Two rank processes (see ``torch_ranks.Ranks``) run, on
256x128 frames, ``spatial_wave_planes`` with tools off and with the JAX
package's spatial tool set (tests/test_spatial_sharding.py:22-26) and
``dryrun_multichip_encode`` at D = 2; every rank must return the same. With
tools off the 11 planes must equal the JAX package's ``spatial_wave_planes``
on ``make_mesh(2, axis="sp")`` and the replayed stream its single-device
stream; with tools on, and for the dry run, the streams must equal the
port's single-process ones (the tool tests hold those to the JAX package's;
the JAX package's tools-on spatial reference costs a minute of compiles).

The halo pack and unpack's plain versions are held to a numpy restatement
of the JAX package's ``exchange`` (spatial.py:153-167) for every rank of
meshes of 1-4 stripes, edge ranks included. The JAX package's four-stripe
512-wide encode is not run here; on the card, chip_smoke.py holds the K12b
kernel to its plain version at an interior rank of four.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.codec.encoder import FrameEncoder as JaxFrameEncoder
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu.parallel import distributed as jax_distributed
from pmp_vvc_tpu.parallel import make_mesh as jax_mesh
from pmp_vvc_tpu.parallel.spatial import spatial_wave_planes as jax_spatial
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.codec.wavefront import WavefrontEncoder
from pmp_vvc_tpu_torch.parallel import process_frame_range
from pmp_vvc_tpu_torch.parallel import spatial as sp
from pmp_vvc_tpu_torch.parallel.dryrun import dryrun_config, dryrun_frames
from test_spatial_sharding import _TOOLSET, _synth
from torch_ranks import Ranks, same_on_every_rank

torch.set_num_threads(2)

W, H = 256, 128
CFG_OFF = dict(width=W, height=H, qp=32)
CFG_ON = dict(CFG_OFF, **_TOOLSET)

_JOB = '''
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.codec.wavefront import WavefrontEncoder
from pmp_vvc_tpu_torch.parallel.dryrun import dryrun_multichip_encode, spatial_encode
from pmp_vvc_tpu_torch.parallel.spatial import spatial_wave_planes

def run(mesh, frame, cfg_off, cfg_on):
    enc = WavefrontEncoder(VVCConfig(**cfg_off), device="cpu")
    leaves = enc._collect_leaves(enc._decider(None, None))
    planes = spatial_wave_planes(enc, leaves, *frame, mesh)
    return {"planes": planes, "on": spatial_encode(VVCConfig(**cfg_on), *frame, mesh),
            "dryrun": dryrun_multichip_encode(mesh)}
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    job = Ranks(tmp_path_factory.mktemp("spatial"), 2, _JOB, frame=_synth(W, H),
                cfg_off=CFG_OFF, cfg_on=CFG_ON)
    yield job
    for p in job.procs:
        p.kill()


def test_tools_off_planes_and_stream_match_jax(ranks):
    y, u, v = _synth(W, H)
    cfg = JaxConfig(**CFG_OFF)
    bs1, _ = JaxEncoder(cfg).encode_frame(y, u, v)
    enc = JaxEncoder(cfg)
    leaves = enc._collect_leaves(enc._decider(None, None))
    want = jax_spatial(enc, leaves, y, u, v, jax_mesh(2, axis="sp"))
    planes = same_on_every_rank(ranks.results(), "planes")
    assert len(planes) == len(want) == 11
    for a, b in zip(planes, want):
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    # the port's planes replayed by the JAX package's FrameEncoder
    enc._dev_result, enc._cur_frame = planes, 0
    assert JaxFrameEncoder.encode_frame(enc, y, u, v)[0] == bs1


def test_tools_on_stream_matches_single_process(ranks):
    y, u, v = _synth(W, H)
    want, _ = WavefrontEncoder(VVCConfig(**CFG_ON), device="cpu").encode_frame(y, u, v)
    assert same_on_every_rank(ranks.results(), "on") == want


def test_dryrun_two_ranks(ranks):
    (y, u, v), (y2, u2, v2) = dryrun_frames()
    got = same_on_every_rank(ranks.results(), "dryrun")
    wave, _ = WavefrontEncoder(dryrun_config(), device="cpu").encode_frame(y, u, v)
    spatial, _ = WavefrontEncoder(dryrun_config(2 * 128, tools=False),
                                  device="cpu").encode_frame(y2, u2, v2)
    assert got == {"wave": wave, "spatial": spatial}


def _jax_exchange(planes, hl, hr, strd):
    """numpy restatement of the JAX package's ``exchange`` (spatial.py:
    153-167) over every rank's (1, H', W') plane at once."""
    D = len(planes)
    out = [p.copy() for p in planes]
    for d in range(D):
        if d > 0:                      # left halo <- left neighbour's last hl owned
            out[d][:, :, :hl] = planes[d - 1][:, :, hl + strd - hl:hl + strd]
        if d < D - 1:                  # right halo <- right neighbour's first hr owned
            out[d][:, :, hl + strd:] = planes[d + 1][:, :, hl:hl + hr]
    return out


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_halo_pack_unpack_match_jax_exchange(D):
    rng = np.random.RandomState(D)
    Hh, strd = 24, 128
    shapes = [(1, Hh, sp.HL + strd + sp.HR)] + 2 * [(1, Hh // 2, (sp.HL + strd + sp.HR) // 2)]
    ranks_planes = [[rng.randint(-1 << 20, 1 << 20, s).astype(np.int32) for s in shapes]
                    for _ in range(D)]
    want = [_jax_exchange([rp[i] for rp in ranks_planes], sp.HL >> (i > 0), sp.HR >> (i > 0),
                          strd >> (i > 0)) for i in range(3)]
    planes = [[torch.from_numpy(p.copy()) for p in rp] for rp in ranks_planes]
    bufs = [sp.halo_pack(p, sp.HL, sp.HR, strd) for p in planes]
    n_a = sp.band_size(Hh, sp.HL)
    assert bufs[0].shape == (n_a + sp.band_size(Hh, sp.HR),)
    for d in range(D):
        got = torch.zeros_like(bufs[d])
        if d > 0:
            got[:n_a] = bufs[d - 1][:n_a]
        if d < D - 1:
            got[n_a:] = bufs[d + 1][n_a:]
        sp.halo_unpack(got, planes[d], sp.HL, sp.HR, strd, d > 0, d < D - 1)
        for i in range(3):
            assert np.array_equal(planes[d][i].numpy(), want[i][d]), (d, i)


def test_halo_rejects_bad_shapes():
    planes = [torch.zeros((1, 8, 8 + 128 + 128), dtype=torch.int32)] + \
        2 * [torch.zeros((1, 4, 132), dtype=torch.int32)]
    with pytest.raises(ValueError, match="widths"):
        sp.halo_pack(planes, sp.HL, sp.HR, 130)
    with pytest.raises(ValueError, match="int32"):
        sp.halo_pack([p.to(torch.int16) for p in planes], sp.HL, sp.HR, 128)


@pytest.mark.parametrize("n_frames", [1, 2, 5, 8, 13])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_process_frame_range_matches_jax(monkeypatch, n_frames, world):
    import jax
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda w=world: w)
        assert process_frame_range(n_frames, rank, world) == \
            jax_distributed.process_frame_range(n_frames)
