"""The port's CU-batch-sharded wave scan (K12a) on the CPU over gloo.

Each case runs ``WavefrontEncoder(cfg, mesh=make_mesh(...))`` in two or
three rank processes (``torch.distributed`` with the gloo backend, a
``file://`` store under the test's tmp_path, ``device="cpu"``: the kernels'
plain versions) and requires every rank's stream to be the same:

- 192x128, single tree, tools off: byte-identical to the JAX package's
  ``WavefrontEncoder(cfg, mesh=make_mesh(2))`` and single-device streams,
  recon equal, decoding hash-verified with the JAX package's decoder;
- 320x192, dual tree, QP 37, three ranks: the JAX package's uneven-tail case
  (tests/test_multichip_encode.py), against its single-device and
  ``make_mesh(3)`` streams;
- the dry run's tool set (dual tree, every device tool, LMCS with chroma
  scaling) with MTT maps over two frames through ``encode_frames``: against
  the port's single-process stream, which the tool tests hold to the JAX
  package's.

The rank processes start together when the first test asks for them, and
run while the JAX references are computed here.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu.parallel import make_mesh as jax_mesh
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.codec.wavefront import DEFAULT_BATCH, WavefrontEncoder
from pmp_vvc_tpu_torch.parallel import Mesh, initialize, shard_rows
from pmp_vvc_tpu_torch.parallel.dryrun import TOOLS
from test_multichip_encode import _synth
from test_wavefront import _mtt_maps
from torch_ranks import Ranks, same_on_every_rank

torch.set_num_threads(2)

W, H = 192, 128
WIDE_W, WIDE_H = 320, 192
MTT = dict(max_mtt_depth_intra=3, max_bt_intra=32, max_tt_intra=32, log2_min_cb=2)

# the jobs: each result a dict of (stream, recon) or stream lists
_JOB2 = '''
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.codec.wavefront import WavefrontEncoder

def run(mesh, frame, cfg, frames, maps, cmaps, tools_cfg):
    enc = WavefrontEncoder(VVCConfig(**cfg), mesh=mesh)
    out = {"off": enc.encode_frame(*frame), "batch": enc.batch}
    enc = WavefrontEncoder(VVCConfig(**tools_cfg), mesh=mesh)
    out["tools"] = [o[0] for o in enc.encode_frames(frames, maps=maps, chroma_maps=cmaps)]
    return out
'''
_JOB3 = '''
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.codec.wavefront import WavefrontEncoder

def run(mesh, frame, cfg):
    enc = WavefrontEncoder(VVCConfig(**cfg), mesh=mesh)
    return {"wide": enc.encode_frame(*frame), "batch": enc.batch}
'''

CFG_OFF = dict(width=W, height=H, qp=32)
CFG_WIDE = dict(width=WIDE_W, height=WIDE_H, qp=37, dual_tree=True)
CFG_TOOLS = dict(width=W, height=H, qp=32, **TOOLS, **MTT)


def _tool_frames():
    frames = [_synth(W, H, seed=7 + f) for f in range(2)]
    return frames, [_mtt_maps(W, H)] * 2, [_mtt_maps(W, H, chroma_factor=2, seed0=5)] * 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both jobs, started together: two ranks and three ranks."""
    frames, maps, cmaps = _tool_frames()
    two = Ranks(tmp_path_factory.mktemp("two"), 2, _JOB2, frame=_synth(W, H), cfg=CFG_OFF,
                frames=frames, maps=maps, cmaps=cmaps, tools_cfg=CFG_TOOLS)
    three = Ranks(tmp_path_factory.mktemp("three"), 3, _JOB3,
                  frame=_synth(WIDE_W, WIDE_H, seed=11), cfg=CFG_WIDE)
    yield {2: two, 3: three}
    for job in (two, three):
        for p in job.procs:
            p.kill()


def test_two_ranks_match_jax_sharded_and_single(ranks):
    y, u, v = _synth(W, H)
    cfg = JaxConfig(**CFG_OFF)
    bs1, rec1 = JaxEncoder(cfg).encode_frame(y, u, v)
    bs2, _ = JaxEncoder(cfg, mesh=jax_mesh(2)).encode_frame(y, u, v)
    outs = ranks[2].results()
    bs, rec = same_on_every_rank(outs, "off")
    assert bs == bs1 == bs2
    for a, b in zip(rec, rec1):
        assert np.array_equal(a, b)
    _, got = decode_stream(bs, verify_hash=True)
    for a, b in zip(got[0], rec):
        assert np.array_equal(a, b)
    assert outs[0]["batch"] == DEFAULT_BATCH     # 16 and 8 split over 2 as they are


def test_three_ranks_uneven_tail_dual_tree(ranks):
    y, u, v = _synth(WIDE_W, WIDE_H, seed=11)
    cfg = JaxConfig(**CFG_WIDE)
    bs1, _ = JaxEncoder(cfg).encode_frame(y, u, v)
    bs3, _ = JaxEncoder(cfg, mesh=jax_mesh(3)).encode_frame(y, u, v)
    outs = ranks[3].results()
    bs, _ = same_on_every_rank(outs, "wide")
    assert bs == bs1 == bs3
    decode_stream(bs, verify_hash=True)
    assert outs[0]["batch"] == {32: 18, 64: 9}


def test_dryrun_tools_mtt_encode_frames_match_single_process(ranks):
    frames, maps, cmaps = _tool_frames()
    want = WavefrontEncoder(VVCConfig(**CFG_TOOLS), device="cpu").encode_frames(
        frames, maps=maps, chroma_maps=cmaps)
    got = same_on_every_rank(ranks[2].results(), "tools")
    assert got == [o[0] for o in want]
    _, dec = decode_stream(b"".join(got), verify_hash=True)
    assert len(dec) == 2


def test_shard_rows_and_batch_rounding():
    mesh3 = Mesh(None, 2, 3, "gloo", torch.device("cpu"))
    rows = torch.arange(18 * 8, dtype=torch.int32).reshape(18, 8)
    assert torch.equal(shard_rows(mesh3, rows), rows[12:18])
    with pytest.raises(ValueError):
        shard_rows(mesh3, rows[:16])
    enc = WavefrontEncoder(VVCConfig(width=64, height=64), mesh=mesh3)
    assert enc.batch == {32: 18, 64: 9} and enc.device.type == "cpu"
    with pytest.raises(ValueError):
        WavefrontEncoder(VVCConfig(width=64, height=64), mesh=mesh3, device="cuda")


def test_single_process_initialize_starts_nothing(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        initialize(device="cpu")
