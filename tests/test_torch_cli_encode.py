"""The port's encode CLI against the JAX package's, on the CPU.

``pmp_vvc_tpu_torch.cli.encode.main`` with ``--device cpu`` and
``pmp_vvc_tpu.cli.encode.main`` on the same small YUV: the sequential engine
from a ``-c`` cfg stack (every tool the stack turns on, MRL, ISP and
dependent quantization among them) and from a PartitionMat file with MTT,
and the wavefront engine with a uniform QT depth; the bitstream and
recon files must be byte-identical, and the streams decode hash-verified.
The port's ``vtmcfg`` maps a cfg stack as the JAX package's does;
``--model-dir`` reads the committed msgpack checkpoints and names a missing
one; ``--jobs 2`` (spawned workers) writes the same stream as ``--jobs 1``;
the sequential engine's RDO split search (``--rdo``, ``--rdo-fallback``) is
not ported and raises.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.cli import encode as jax_cli
from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.utils import vtmcfg as jax_vtmcfg
from pmp_vvc_tpu_torch.cli import encode as cli
from pmp_vvc_tpu_torch.data.synthcontent import natural_sequence
from pmp_vvc_tpu_torch.data.yuv import write_yuv420
from pmp_vvc_tpu_torch.pmp.map2partition import write_partition_txt
from pmp_vvc_tpu_torch.utils import vtmcfg
from test_wavefront import _mtt_maps

torch.set_num_threads(2)

W, H = 128, 64
CKPT = "trained_models/bd"
TOOLS_CFG = """QP : 32
MTS : 1
LFNST : 1
ISP : 1
MRL : 1
MIP : 1
DepQuant : 1
LMChroma : 1
JointCbCr : 1
SAO : 1
"""


@pytest.fixture
def clip(tmp_path):
    """A 2-frame 8-bit YUV, a sequence cfg naming it, a tools cfg and a
    PartitionMat file with MTT maps for both frames."""
    frames = natural_sequence(W, H, 2, seed0=4, bit_depth=8)
    yuv = tmp_path / "in.yuv"
    write_yuv420(yuv, *(np.stack([f[i] for f in frames]).astype(np.uint8) for i in range(3)))
    seq = tmp_path / "seq.cfg"
    seq.write_text(f"InputFile : {yuv}\nInputBitDepth : 8\nSourceWidth : {W}\n"
                   f"SourceHeight : {H}\nFramesToBeEncoded : 1\n")
    tools = tmp_path / "tools.cfg"
    tools.write_text(TOOLS_CFG)
    pmat = tmp_path / "maps.txt"
    write_partition_txt(pmat, [_mtt_maps(W, H, seed0=s) for s in (0, 7)])
    return tmp_path, yuv, seq, tools, pmat


def _run_both(tmp, argv):
    out = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        bs, rec = tmp / f"{name}.bin", tmp / f"{name}.yuv"
        main(argv + extra + ["--output", str(bs), "--recon", str(rec)])
        out[name] = (bs.read_bytes(), rec.read_bytes())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    decode_stream(out["port"][0], verify_hash=True)
    return out["port"][0]


def test_sequential_cfg_stack_matches_jax(clip):
    tmp, _, seq, tools, _ = clip
    _run_both(tmp, ["-c", str(seq), "-c", str(tools), "--mode-select", "satd"])


def test_sequential_partition_mat_matches_jax(clip):
    tmp, yuv, _, _, pmat = clip
    _run_both(tmp, ["--input", str(yuv), "--width", str(W), "--height", str(H), "--qp", "27",
                    "--frames", "1", "--partition-mat", str(pmat), "--mtt", "--sao", "--mip",
                    "--mrl", "--isp", "--dep-quant", "--cclm", "--lfnst"])


def test_wavefront_matches_jax(clip):
    tmp, yuv, _, _, _ = clip
    _run_both(tmp, ["--input", str(yuv), "--width", str(W), "--height", str(H), "--qp", "27",
                    "--frames", "2", "--engine", "wavefront", "--sao", "--mip",
                    "--sign-hiding", "--lfnst", "--bit-stats"])


def test_vtmcfg_matches_jax(clip):
    tmp, _, seq, tools, _ = clip
    extra = tmp / "extra.cfg"
    extra.write_text("DualITree : 1\nMaxMTTHierarchyDepthISliceL : 3\nMinQTLumaISlice : 8\n"
                     "ALF : 1\nLMCSEnable : 1\nCbQpOffset : 1\nQP : 37  # later wins\n")
    stack = [seq, tools, extra]
    assert vtmcfg.merge_cfgs(stack) == jax_vtmcfg.merge_cfgs(stack)
    assert vtmcfg.to_encoder_args(vtmcfg.merge_cfgs(stack, {"QP": "22"})) == \
        jax_vtmcfg.to_encoder_args(jax_vtmcfg.merge_cfgs(stack, {"QP": "22"}))


def test_model_dir_reads_msgpack_checkpoints(clip):
    tmp, yuv, _, _, _ = clip
    base = ["--input", str(yuv), "--width", str(W), "--height", str(H), "--frames", "1",
            "--model-dir", CKPT, "--mtt", "--engine", "wavefront", "--device", "cpu"]
    out = tmp / "model.bin"
    cli.main(base + ["--qp", "22", "--output", str(out)])
    decode_stream(out.read_bytes(), verify_hash=True)
    with pytest.raises(FileNotFoundError, match="Chroma_Q_QP27.msgpack"):
        cli.main(base + ["--qp", "27", "--output", str(out)])


def test_jobs_spawn_matches_one_job(clip):
    tmp, yuv, _, _, _ = clip
    outs = []
    for jobs in ("1", "2"):
        out = tmp / f"jobs{jobs}.bin"
        cli.main(["--input", str(yuv), "--width", str(W), "--height", str(H), "--frames", "2",
                  "--engine", "wavefront", "--device", "cpu", "--jobs", jobs,
                  "--output", str(out)])
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("flag", ["--rdo", "--rdo-fallback"])
def test_sequential_rdo_search_raises(clip, flag):
    tmp, yuv, _, _, _ = clip
    with pytest.raises(NotImplementedError, match="RDO split search"):
        cli.main(["--input", str(yuv), "--width", str(W), "--height", str(H), "--device", "cpu",
                  "--output", str(tmp / "x.bin"), flag])
