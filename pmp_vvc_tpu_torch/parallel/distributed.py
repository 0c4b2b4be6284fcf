"""Multi-process bootstrap: ``torch.distributed`` in place of
``jax.distributed``.

``initialize`` brings up the default process group from its arguments or,
failing those, from the ``torchrun`` environment (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``). The backend follows the
device: NCCL for the card, gloo for the CPU. A caller may name the backend
itself, e.g. gloo for ranks that share one card (NCCL does not run two
ranks on one GPU); nothing switches the backend on an error.

All-intra frames are independent, so the encoder's multi-process mode
across frames is frame sharding: each rank encodes its own POC range
(``process_frame_range``) and the bitstreams concatenate after the
parameter sets.

``host_shard`` is the data-parallel counterpart of a batch that each
process loads for itself: every rank passes its own slice of the global
batch, and the slices become the ranks' blocks once their lengths agree.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from . import comm


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device=None) -> bool:
    """Start the default process group; True if one was started.

    Without ``init_method`` and at a world size of 1 (no ``torchrun``
    environment) this is the single-process case: nothing starts and the
    result is False, as in the JAX package. An explicit ``init_method``
    (``tcp://host:port``, ``file:///path``) starts a group at any size, a
    one-rank group included. ``device=None`` means the card (the port's
    rule); on the card the rank's GPU becomes the current device (its index,
    else ``LOCAL_RANK``)."""
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", "1")) if world_size is None else world_size
    rank = int(env.get("RANK", "0")) if rank is None else rank
    if init_method is None:
        if world_size <= 1:
            return False
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError("a multi-process run needs init_method or the torchrun "
                               "environment (MASTER_ADDR, MASTER_PORT)")
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(env.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def shutdown() -> None:
    """Tear the default process group down (if one is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_frame_range(n_frames: int, rank: int | None = None,
                        world_size: int | None = None) -> range:
    """The POC range this rank encodes under frame sharding: contiguous
    blocks of ceil(n_frames / world_size) frames. ``rank`` and
    ``world_size`` default to the default group's (0 and 1 without one)."""
    up = dist.is_initialized()
    rank = (dist.get_rank() if up else 0) if rank is None else rank
    world_size = (dist.get_world_size() if up else 1) if world_size is None else world_size
    per = (n_frames + world_size - 1) // world_size
    return range(rank * per, min((rank + 1) * per, n_frames))


def host_shard(mesh, tree):
    """This rank's slice of a global batch as its block on ``mesh``: each
    array of ``tree`` (an array or a tuple / list of arrays, numpy or torch)
    becomes a tensor on ``mesh.device``. The counterpart of the JAX
    package's ``host_shard`` (``jax.make_array_from_process_local_data``):
    every rank passes its own slice, and every slice of one array must have
    the same length on every rank, which one all-gather of the lengths
    checks (every rank raises together otherwise). Every rank must call
    it."""
    leaves = list(tree) if isinstance(tree, (tuple, list)) else [tree]
    blocks = [(a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a)))
              .to(mesh.device) for a in leaves]
    mine = torch.tensor([[len(b) for b in blocks]], dtype=torch.int64, device=mesh.device)
    lengths = comm.all_gather(mesh, mine)
    if not bool((lengths == lengths[:1]).all()):
        raise ValueError(f"the ranks' slices differ in length: {lengths.tolist()}")
    return type(tree)(blocks) if isinstance(tree, (tuple, list)) else blocks[0]
