"""The device RDO fallback at accel level L3 where the maps do not cover
the frame, against the JAX package's, end to end on the CPU.

Predicted maps cover whole 64x64 blocks only (``blocks_to_frame_partition``
makes them (H // 64 * 16, W // 64 * 16)), so at a frame size that is not a
multiple of 64, as ``bench.py``'s 416x240, the map partitioner defers every
node outside them at every level, L3 included. One 160x120 frame with the
MTT maps of test_accel_levels.py over its 128x64 covered part, the bench's
coding tools at QP 32 in dual tree: the fallback decides the uncovered
nodes (and only those), and the bitstream and recon are byte-identical to
the JAX package's and decode hash-verified."""
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


def test_level3_defers_outside_the_maps(margins):
    W, H = 160, 120
    CW, CH = W // 64 * 64, H // 64 * 64           # the maps' coverage
    kw = dict(width=W, height=H, dual_tree=True, **BENCH)
    y, u, v = natural_frame(W, H, seed=13)
    maps = _maps(CW, CH)
    bs_j, rec_j = JaxEncoder(JaxConfig(**kw), accel_level=3,
                             rdo_fallback=True).encode_frame(y, u, v, maps=maps)
    enc = twf.WavefrontEncoder(VVCConfig(**kw), accel_level=3, rdo_fallback=True,
                               device="cpu")
    bs_t, rec_t = enc.encode_frame(y, u, v, maps=maps)
    assert bs_t == bs_j
    for a, b in zip(rec_t, rec_j):
        assert np.array_equal(a, b)
    _, got = decode_stream(bs_t, verify_hash=True)
    assert len(got) == 1
    deferred = enc.rdo_deferred[0]
    assert deferred and {"rdo_leaf_costs", "rdo_dp"} <= set(enc.timings)
    assert all(x + w > CW or y + h > CH for _, x, y, w, h, _ in deferred)
