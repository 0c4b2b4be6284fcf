"""The device RDO fallback is lazy: at accel level L3 with full maps no node
defers, so the search never runs and the stream is the one without the
fallback (test_torch_encode_rdo.py describes the frame and the maps, and
holds the other levels to the JAX package). ``bench.py:186-197``'s encoder
constructs with ``rdo_fallback`` at every level."""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.data.synthcontent import natural_frame
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_accel_levels import _maps
from test_torch_encode_lmcs_alf import BENCH
from test_torch_encode_rdo import H, RDO_STAGES, W

torch.set_num_threads(2)


def test_level3_fallback_is_lazy():
    y, u, v = natural_frame(W, H, seed=11)
    kw = dict(width=W, height=H, dual_tree=True, **BENCH)
    out = {}
    for fallback in (True, False):
        enc = twf.WavefrontEncoder(VVCConfig(**kw), accel_level=3, rdo_fallback=fallback,
                                   device="cpu")
        out[fallback] = enc.encode_frame(y, u, v, maps=_maps(W, H))
        assert enc.rdo_deferred == ([set()] if fallback else [])
        assert not RDO_STAGES & set(enc.timings)
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("level", (0, 1, 2, 3))
def test_bench_encoder_constructs_with_the_fallback(level):
    enc = twf.WavefrontEncoder(VVCConfig(width=416, height=240, dual_tree=True, **BENCH),
                               accel_level=level, rdo_fallback=True, device="cpu")
    assert enc.rdo_fallback and enc.accel_level == level


def test_dual_tree_rdo_true_replays_the_searched_tree():
    """``encode_frame(rdo=True)`` in dual tree: the search decides the
    64x64 luma quadrants too, keyed by their QT child index; the replay
    codes the tree the wave scan coded, and the stream decodes
    hash-verified. (The JAX package's replay keys all four quadrants as the
    first, so on this frame its stream does not decode and the two differ.)"""
    from pmp_vvc_tpu.codec.decoder import decode_stream
    from pmp_vvc_tpu_torch.codec.mtt import Split, SplitState
    from pmp_vvc_tpu_torch.codec.rdo_device import DeviceRDO
    y, u, v = natural_frame(W, H, seed=21)
    kw = dict(width=W, height=H, dual_tree=True, **BENCH)
    enc = twf.WavefrontEncoder(VVCConfig(**kw), device="cpu")
    decide = DeviceRDO(enc).search(y, u, v)
    quads = [decide(x, yy, 64, 64, SplitState(last_split=Split.QT, qt_depth=1, part_idx=i))
             for i, (x, yy) in enumerate(((0, 0), (64, 0), (0, 64), (64, 64)))]
    assert any(s != Split.NONE for s in quads[1:])
    bs, rec = enc.encode_frame(y, u, v, rdo=True)
    assert enc.leaf_l == [leaf[:4] for leaf in enc.leaves[0][0]]
    _, got = decode_stream(bs, verify_hash=True)
    for a, b in zip(got[0], rec):
        assert np.array_equal(a, b)
