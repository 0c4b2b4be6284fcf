"""``encode_frame(rdo=True)`` against the JAX package's, end to end on the
CPU: the device RDO's open-loop search chooses the whole tree (single tree,
so its geometry leaves out the SCIPU-triggering splits), which the wave path
then codes. One 208x120 frame of natural content (its bottom CTU row cut by
the frame edge) with the bench's coding tools at QP 32; the bitstreams and
recon must be byte-identical and the port's stream must decode
hash-verified with the JAX package's decoder."""
import numpy as np
import torch

from pmp_vvc_tpu.codec.decoder import decode_stream
from pmp_vvc_tpu.codec.headers import VVCConfig as JaxConfig
from pmp_vvc_tpu.codec.wavefront import WavefrontEncoder as JaxEncoder
from pmp_vvc_tpu.data.synthcontent import natural_frame
from pmp_vvc_tpu_torch.codec import wavefront as twf
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from test_torch_encode_lmcs_alf import BENCH
from test_torch_wavefront import margins  # noqa: F401  (fixture)

torch.set_num_threads(2)


def test_rdo_true_single_tree_matches_jax(margins):
    W, H = 208, 120
    kw = dict(width=W, height=H, dual_tree=False, **BENCH)
    y, u, v = natural_frame(W, H, seed=5)
    bs_j, rec_j = JaxEncoder(JaxConfig(**kw)).encode_frame(y, u, v, rdo=True)
    enc = twf.WavefrontEncoder(VVCConfig(**kw), device="cpu")
    bs_t, rec_t = enc.encode_frame(y, u, v, rdo=True)
    assert bs_t == bs_j
    for a, b in zip(rec_t, rec_j):
        assert np.array_equal(a, b)
    _, got = decode_stream(bs_t, verify_hash=True)
    assert len(got) == 1
    # the search chose an MTT tree, and its stages were timed
    assert any(w != h for _, _, w, h, _ in enc.leaves[0][0])
    assert {"rdo_leaf_costs", "rdo_dp"} <= set(enc.timings)
