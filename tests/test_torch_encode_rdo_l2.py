"""The port's encode with the device RDO fallback at accel level L2 against
the JAX package's (test_torch_encode_rdo.py describes the frame, the maps and
the checks): L2 defers the nodes from MTT depth 2 on."""
import torch

from test_torch_encode_rdo import check_rdo_ran, encode_level
from test_torch_wavefront import margins  # noqa: F401  (fixture)

torch.set_num_threads(2)


def test_level2_matches_jax(margins):
    check_rdo_ran(encode_level(2))
