"""The port's single-tree encode with MTS, LFNST and transform skip (K5)
against the JAX package's, end to end on the CPU.

The frame, maps and checks of test_torch_encode_k5.py, in single tree with
MIP, sign-data hiding, MTS, LFNST and transform skip, deblocking and SAO at
QP 32, with seeded uniform noise of +-100 added to both chroma planes. There
K4 confines the chroma levels of the CUs whose luma chose LFNST to LFNST's
signallable region; the noise leaves those CUs' chroma with levels outside
the region, so the region removes some (``margins["region"]``; on the
frame's own smooth chroma it removes none), and the streams must stay
byte-identical all the same.
"""
import numpy as np

import test_torch_encode_k5 as k5
from test_torch_wavefront import margins  # noqa: F401  (fixture)


_smooth_chroma_frame = k5._frame


def _noisy_chroma_frame():
    y, u, v = _smooth_chroma_frame()
    rng = np.random.RandomState(1)
    u, v = (np.clip(p + rng.randint(-100, 101, p.shape), 0, 1023).astype(p.dtype)
            for p in (u, v))
    return y, u, v


def test_single_tree_with_mts_lfnst_ts_and_filters(margins, monkeypatch):
    monkeypatch.setattr(k5, "_frame", _noisy_chroma_frame)
    kw = dict(width=k5.W, height=k5.H, qp=32, sao=True, deblocking_disabled=False,
              **k5.MTT, **k5.TOOLS)
    tr, lf = k5._encode_both(kw, chroma_maps=False)
    k5._assert_every_tool(tr, lf, margins)
    assert sum(margins["region"]) > 0, "the LFNST region removed no chroma level"
