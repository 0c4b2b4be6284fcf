"""The encode half of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py:72-108``) on the port.

Every rank of the mesh calls ``dryrun_multichip_encode(mesh)``:

- a 128x128 frame encoded by ``WavefrontEncoder(mesh=...)`` in the dual-tree
  configuration with every device tool and LMCS with chroma scaling, its CU
  batches sharded over the mesh (K12a);
- with two ranks or more, a ``128 * min(D, 2)``-wide frame encoded by the
  spatial-stripe scan (K12b) over the mesh's first two ranks (tools off),
  then replayed by ``FrameEncoder.encode_frame``.

The frames are the JAX function's: ``np.random.RandomState(3)`` draws y, u,
v of the first, then of the second.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..codec.encoder import FrameEncoder
from ..codec.headers import VVCConfig
from ..codec.wavefront import WavefrontEncoder
from .spatial import spatial_wave_planes
from .wavefront_dp import make_mesh

W = H = 128
TOOLS = dict(dual_tree=True, mts_intra=True, mip=True, cclm=True, lfnst=True,
             sign_hiding=True, joint_cbcr=True, lmcs=True, lmcs_chroma_scaling=True)


def dryrun_frames():
    """((y, u, v) of the sharded wave encode, (y, u, v) of the spatial
    one, or None at a width below two stripes), 10-bit."""
    rng = np.random.RandomState(3)
    draw = lambda w: tuple(rng.randint(0, 1 << 10, shape).astype(np.int32)
                           for shape in ((H, w), (H // 2, w // 2), (H // 2, w // 2)))
    return draw(W), draw(2 * W)


def dryrun_config(width: int = W, tools: bool = True) -> VVCConfig:
    return VVCConfig(width=width, height=H, qp=32, **(TOOLS if tools else {}))


def spatial_encode(cfg: VVCConfig, y, u, v, mesh) -> bytes:
    """One frame through the spatial-stripe scan over ``mesh`` and the
    replay (QT-only partitioning, as in the JAX package's tests)."""
    enc = WavefrontEncoder(cfg, device=mesh.device)
    leaves = enc._collect_leaves(enc._decider(None, None))
    enc._dev_result = spatial_wave_planes(enc, leaves, y, u, v, mesh)
    enc._cur_frame = 0
    return FrameEncoder.encode_frame(enc, y, u, v)[0]


def dryrun_multichip_encode(mesh) -> dict:
    """Run both encodes on every rank of ``mesh`` (a mesh over the default
    group's ranks); returns {"wave": bytes, "spatial": bytes or None}
    (None with one rank, and on ranks past the first two)."""
    (y, u, v), (y2, u2, v2) = dryrun_frames()
    bs, _ = WavefrontEncoder(dryrun_config(), mesh=mesh).encode_frame(y, u, v)
    assert len(bs) > 0
    out = {"wave": bs, "spatial": None}
    D = mesh.size
    if D < 2:
        return out
    sub = mesh
    if D > 2:
        # new_group is entered by every rank of the default group
        group = dist.new_group([mesh.global_rank(r) for r in range(2)])
        sub = make_mesh(group, mesh.device) if mesh.rank < 2 else None
    if sub is not None:
        out["spatial"] = spatial_encode(dryrun_config(2 * W, tools=False), y2, u2, v2, sub)
        assert len(out["spatial"]) > 0
    return out
