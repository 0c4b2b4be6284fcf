"""The JAX package's ``dryrun_multichip`` (``__graft_entry__.py:38-108``)
on the port: ``dryrun_multichip(mesh)`` runs its training half, then its
encode half. Every rank of the mesh calls each.

``dryrun_multichip_train(mesh)``, the training half (38-71): one joint qbd
step of the luma nets at QP 32, data-parallel over the mesh (K12c), on
``n = 2 * D`` CTUs drawn by ``np.random.RandomState(0)`` as the JAX
function draws them (x, qt, bt, dire), lr 1e-4; the nets' initial
parameters come from flax's initialisation with seeds 0 (Q) and 1 (BD),
or from ``params``.

``dryrun_multichip_encode(mesh)``, the encode half (72-108):

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
import torch
import torch.distributed as dist

from ..codec.encoder import FrameEncoder
from ..codec.headers import VVCConfig
from ..codec.wavefront import WavefrontEncoder
from ..models import LumaMSBDNet, LumaQNet, init_params
from ..pmp.predict import strict_fp32
from ..train.trainer import Adam, make_qbd_train_step, shard_batch
from .spatial import spatial_wave_planes
from .wavefront_dp import make_mesh

W = H = 128
TOOLS = dict(dual_tree=True, mts_intra=True, mip=True, cclm=True, lfnst=True,
             sign_hiding=True, joint_cbcr=True, lmcs=True, lmcs_chroma_scaling=True)


TRAIN_QP, TRAIN_LR = 32, 1e-4


def luma_nets(params=None, device=None):
    """The luma Q and BD nets on ``device``: ``params`` ({"q": state dict,
    "bd": state dict}) or flax's initialisation with seeds 0 (Q) and 1 (BD),
    as the JAX entry points draw them with ``PRNGKey(0)`` and ``PRNGKey(1)``
    (other numbers: torch's generator is not JAX's)."""
    q_net, bd_net = LumaQNet(), LumaMSBDNet()
    for k, net in enumerate((q_net, bd_net)):
        if params is None:
            init_params(net, torch.Generator().manual_seed(k))
        else:
            net.load_state_dict(params[("q", "bd")[k]], strict=True)
    return q_net.to(device), bd_net.to(device)


def dryrun_train_batch(n: int):
    """The training half's (x, qt, bt, dire), NHWC float32, as
    ``__graft_entry__.py:52-56`` draws them."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 255, (n, 68, 68, 1)).astype(np.float32)
    qt = rng.randint(0, 4, (n, 8, 8, 1)).astype(np.float32)
    bt = rng.randint(0, 3, (n, 16, 16, 3)).astype(np.float32)
    dire = rng.randint(-1, 2, (n, 16, 16, 3)).astype(np.float32)
    return x, qt, bt, dire


def dryrun_multichip_train(mesh, params=None) -> float:
    """One data-parallel joint step on every rank of ``mesh``; asserts a
    finite loss and returns it (the loss of the global batch, the same on
    every rank)."""
    strict_fp32()
    q_net, bd_net = luma_nets(params, mesh.device)
    opt = Adam(list(q_net.parameters()) + list(bd_net.parameters()))
    run = make_qbd_train_step(q_net, bd_net, opt, qp=TRAIN_QP, is_luma=True, mesh=mesh)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
                  for a in dryrun_train_batch(2 * mesh.size))
    x, qt, bt, dire = (a.to(mesh.device) for a in shard_batch(mesh, batch))
    loss = float(run(x, qt, bt, dire, TRAIN_LR))
    if not np.isfinite(loss):
        raise RuntimeError(f"the dry run's training step gave a loss of {loss}")
    return loss


def dryrun_multichip(mesh) -> dict:
    """Both halves on every rank of ``mesh``: {"train": the step's loss,
    "wave": bytes, "spatial": bytes or None}."""
    return {"train": dryrun_multichip_train(mesh), **dryrun_multichip_encode(mesh)}


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
