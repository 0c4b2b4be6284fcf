"""The port's encode with the device RDO fallback against the JAX package's,
end to end on the CPU, at accel level L1.

One 128x128 frame of natural content with the maps of
test_accel_levels.py (BT_H at MTT depth 0, BT_V at depth 1, nothing below:
L1 defers every node from MTT depth 1 on, L2 from depth 2, L3 none) and the
bench's coding tools at QP 32 in dual tree (``bench.py:186-197``), encoded by
both packages' ``WavefrontEncoder(rdo_fallback=True)``. The bitstreams and
recon must be byte-identical, the port's stream must decode hash-verified
with the JAX package's decoder, the wave path's decisions keep their margins
(the ``margins`` fixture), and the device RDO must have run: nodes
deferred, its stages in ``timings``. L2, L0 (with its QT ban), L3 (where
nothing defers) and ``encode_frame(rdo=True)`` are in
test_torch_encode_rdo_l2.py, _l0.py, _l3.py and _single_tree.py, one file
each, so that each stays short on one test worker; test_torch_rdo_search.py
holds the search's decisions to a margin.
"""
import numpy as np
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu.data.synthcontent import natural_frame
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_accel_levels import _maps
from test_torch_encode_lmcs_alf import BENCH
from test_torch_wavefront import margins  # noqa: F401  (fixture)

torch.set_num_threads(2)

W = H = 128
RDO_STAGES = {"rdo_geometry", "rdo_leaf_costs", "rdo_dp"}


def encode_level(level, rdo_fallback=True):
    """The 128x128 frame at ``level`` by both packages; checks the streams,
    the recon and the decode; returns the port's encoder."""
    kw = dict(width=W, height=H, dual_tree=True, **BENCH)
    y, u, v = natural_frame(W, H, seed=11)
    maps = _maps(W, H)
    bs_j, rec_j = JaxEncoder(JaxConfig(**kw), accel_level=level,
                             rdo_fallback=rdo_fallback).encode_frame(y, u, v, maps=maps)
    enc = twf.WavefrontEncoder(VVCConfig(**kw), accel_level=level, rdo_fallback=rdo_fallback,
                               device="cpu")
    bs_t, rec_t = enc.encode_frame(y, u, v, maps=maps)
    assert bs_t == bs_j
    for a, b in zip(rec_t, rec_j):
        assert np.array_equal(a, b)
    _, got = decode_stream(bs_t, verify_hash=True)
    assert len(got) == 1
    return enc


def check_rdo_ran(enc):
    """Some node deferred, the search's stages timed apart from collect."""
    assert sum(len(s) for s in enc.rdo_deferred) > 0
    assert RDO_STAGES - {"rdo_geometry"} <= set(enc.timings)
    assert enc.timings["collect"] >= 0


def test_level1_matches_jax(margins):
    check_rdo_ran(encode_level(1))
