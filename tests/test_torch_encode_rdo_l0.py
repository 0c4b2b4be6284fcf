"""The port's encode with the device RDO fallback at accel level L0 against
the JAX package's (test_torch_encode_rdo.py describes the frame, the maps and
the checks): L0 defers every MTT node and bans QT splits below the map's QT
depth in the search (``_Geom.qt_ban_mask``)."""
import torch

from test_torch_encode_rdo import check_rdo_ran, encode_level
from test_torch_wavefront import margins  # noqa: F401  (fixture)

torch.set_num_threads(2)


def test_level0_matches_jax(margins):
    enc = encode_level(0)
    check_rdo_ran(enc)
    # the QT map is 2 everywhere: no leaf of the QT-banned search is a QT
    # split below 16x16, and the maps' deferred nodes decide every MTT split
    assert all(w * h <= 256 for x, y, w, h, _ in enc.leaves[0][0])
