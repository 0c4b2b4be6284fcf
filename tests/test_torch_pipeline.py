"""The port's prediction pipeline against the JAX package's, end to end.

A 2-frame 192x128 ``natural_sequence`` YUV goes through ``predict_sequence``
of both packages (the port on the CPU) with the trained Luma QP32 and Chroma
QP22 predictors. Voted QT maps, frame partitions and PartitionMat files must
be equal; bt/dire within atol 1e-4.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization

from pmp_vvc_tpu.data.synthcontent import natural_sequence as jax_natural_sequence
from pmp_vvc_tpu.data.yuv import blocks_for_sequence as jax_blocks_for_sequence
from pmp_vvc_tpu.models import ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet
from pmp_vvc_tpu.pmp.map2partition import (
    blocks_to_frame_partition as jax_blocks_to_frame_partition)
from pmp_vvc_tpu.pmp.pipeline import predict_sequence as jax_predict_sequence
from pmp_vvc_tpu.pmp.predict import CompPredictor as JaxPredictor
from pmp_vvc_tpu_torch.data.synthcontent import natural_sequence
from pmp_vvc_tpu_torch.data.yuv import blocks_for_sequence, read_yuv420, write_yuv420
from pmp_vvc_tpu_torch.pmp.map2partition import blocks_to_frame_partition
from pmp_vvc_tpu_torch.pmp.pipeline import StageTimes, predict_sequence
from pmp_vvc_tpu_torch.pmp.predict import CompPredictor

torch.set_num_threads(2)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "trained_models" / "bd"
W, H, FRAMES = 192, 128, 2
# Seed 17 keeps the JAX raw maps at least MARGIN from every rounding
# threshold (test_jax_raw_maps_keep_a_margin). No seed in 0..39 keeps luma bt
# 1e-3 away: 12 CTUs give 9,216 bt values, and their nearest approach to a
# half is ~1e-4 for a smooth distribution (seed 7 comes within 1.1e-4).
# Seed 17 keeps bt 4.5e-4 away, more than four times ATOL, the bound within
# which the port's raw maps match.
SEED = 17
MARGIN = {"qt": 1e-3, "bt": 4e-4, "dire": 1e-3}
KEYS = [("Luma", 32), ("Chroma", 22)]
ATOL = 1e-4


def _jax_predictor(comp, qp):
    """A JAX CompPredictor on the checkpoint as ``from_trained`` restores it
    (``from_bytes`` into the template is ``msgpack_restore``), without its
    eager template init."""
    q_net, bd_net = ((LumaQNet(), LumaMSBDNet()) if comp == "Luma"
                     else (ChromaQNet(), ChromaMSBDNet()))
    return JaxPredictor(
        q_net, bd_net,
        serialization.msgpack_restore((CKPT / f"{comp}_Q_QP{qp}.msgpack").read_bytes()),
        serialization.msgpack_restore((CKPT / f"{comp}_BD_QP{qp}.msgpack").read_bytes()))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    frames = natural_sequence(W, H, FRAMES, seed0=SEED, bit_depth=8)
    y, u, v = (np.stack([f[i] for f in frames]).astype(np.uint8) for i in range(3))
    yuv = tmp / "natural.yuv"
    write_yuv420(yuv, y, u, v)
    jax_preds = {k: _jax_predictor(*k) for k in KEYS}
    port_preds = {k: CompPredictor.from_trained(
        k[0] == "Luma", CKPT / f"{k[0]}_Q_QP{k[1]}.msgpack",
        CKPT / f"{k[0]}_BD_QP{k[1]}.msgpack", device="cpu") for k in KEYS}
    common = dict(seq_name="natural", subsample=1, qps=(22, 32))
    jax_predict_sequence(yuv, W, H, predictors=jax_preds, out_dir=tmp / "jax",
                         **common)
    times = predict_sequence(yuv, W, H, predictors=port_preds,
                             out_dir=tmp / "port", **common)
    blocks = dict(zip(("Luma", "Chroma"), blocks_for_sequence(y, u, v)))
    outs = {k: (jax_preds[k].predict(blocks[k[0]]),
                port_preds[k].predict(blocks[k[0]])) for k in KEYS}
    return dict(tmp=tmp, frames=frames, yuv=yuv, jax_preds=jax_preds,
                blocks=blocks, outs=outs, times=times)


def test_synthetic_content_and_blocking_match_jax(run):
    theirs = jax_natural_sequence(W, H, FRAMES, seed0=SEED, bit_depth=8)
    for ours, ref in zip(run["frames"], theirs):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    y, u, v = read_yuv420(run["yuv"], W, H)
    for ours, ref in zip((run["blocks"]["Luma"], run["blocks"]["Chroma"]),
                         jax_blocks_for_sequence(y, u, v)):
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("key", KEYS, ids=[f"{c}-{q}" for c, q in KEYS])
def test_jax_raw_maps_keep_a_margin(run, key):
    """A raw value within ATOL of a rounding threshold may round either way
    in two float32 programs: that is numerics, not a port fault. The seed is
    chosen so that no raw map of this input comes within MARGIN."""
    jp = run["jax_preds"][key]
    x = jnp.asarray(run["blocks"][key[0]])
    qt_raw = jp.q_net.apply({"params": jp.q_params}, x)
    bd = jp.bd_net.apply({"params": jp.bd_params}, x, qt_raw)
    pooled = np.asarray(qt_raw)[..., 0].reshape(-1, 4, 2, 4, 2).max(axis=(2, 4))
    bt = np.stack([np.asarray(o)[..., 0] for o in bd])
    dire = np.stack([np.asarray(o)[..., 1] for o in bd])
    for name, vals in (("qt", pooled), ("bt", bt)):
        frac = vals - np.floor(vals)
        assert np.abs(frac - 0.5).min() >= MARGIN[name], name  # round()
    assert np.abs(np.abs(dire) - 0.5).min() >= MARGIN["dire"]  # th_round(., 0.5)


@pytest.mark.parametrize("key", KEYS, ids=[f"{c}-{q}" for c, q in KEYS])
def test_predict_matches_jax(run, key):
    (jqt, jbt, jdire), (qt, bt, dire) = run["outs"][key]
    assert qt.dtype == bt.dtype == dire.dtype == np.float32
    assert qt.shape == (FRAMES * 6, 8, 8) and bt.shape == (FRAMES * 6, 3, 16, 16)
    np.testing.assert_array_equal(qt, jqt)
    np.testing.assert_allclose(bt, jbt, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dire, jdire, atol=ATOL, rtol=0)


@pytest.mark.parametrize("key", KEYS, ids=[f"{c}-{q}" for c, q in KEYS])
def test_frame_partitions_match_jax(run, key):
    (jqt, jbt, jdire), (qt, bt, dire) = run["outs"][key]
    per = (W // 64) * (H // 64)
    for f in range(FRAMES):
        s = slice(f * per, (f + 1) * per)
        ours = blocks_to_frame_partition(qt[s], bt[s], dire[s], W, H, key[0] == "Luma")
        theirs = jax_blocks_to_frame_partition(jqt[s], jbt[s], jdire[s], W, H,
                                               key[0] == "Luma")
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", KEYS, ids=[f"{c}-{q}" for c, q in KEYS])
def test_partition_files_identical(run, key):
    name = f"natural_{key[0]}_QP{key[1]}_PartitionMat.txt"
    ours = (run["tmp"] / "port" / name).read_bytes()
    assert ours == (run["tmp"] / "jax" / name).read_bytes()
    per_frame = 2 * (H // 4 * W // 4) + (H // 8 * W // 8) + 3 * (H // 4 * W // 4)
    assert ours.count(b"\n") == FRAMES * per_frame


def test_stage_times_cover_every_predictor(run):
    times = run["times"]
    assert isinstance(times, StageTimes) and times.blocking > 0
    assert sorted(times.net) == sorted(times.post) == sorted(KEYS)
