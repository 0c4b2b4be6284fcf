"""CU-batch data parallelism for the wavefront encoder (K12a).

The JAX package shards each packed (S, B, 7) wave schedule on its per-CU
batch axis (``P(None, "dp")``) and keeps every frame plane replicated
(``wave_scan_shardings``); XLA partitions the wave step over the CU axis
and all-gathers the recon and level scatters. The port does the same by
hand: each rank runs the step's kernels (K1, K2, K3, K5 for luma; K1, K2,
K6a, K4 for chroma) on its contiguous block of the step's rows
(``shard_rows``), one all-gather per pass (``comm.all_gather``) brings the
block's per-CU outputs into the full batch, and every rank scatters all of
them (K7) into its own replicated planes. Everything is integer
arithmetic, so every rank holds the single-device planes and replays the
same bitstream.

A ``Mesh`` is the port's counterpart of a 1-D JAX mesh: a process group
with this rank, the world size (``size``, as ``Mesh.size`` in JAX), the
backend and the device the ranks' tensors live on.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: object          # the process group (None: the default group)
    rank: int              # this process's rank in the group
    size: int              # the group's world size
    backend: str           # "nccl" or "gloo"
    device: torch.device   # where the ranks' tensors live

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of the group's ``group_rank``."""
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh over ``group`` (default: every rank of the default group);
    ``device=None`` means the card. NCCL takes only tensors on the card."""
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    backend = str(dist.get_backend(group))
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL mesh takes tensors on the card")
    return Mesh(group, rank, dist.get_world_size(group), backend, dev)


def check_device(mesh, device: torch.device) -> None:
    """Raise unless ``device`` is of the kind the mesh's tensors live on
    (no mesh: nothing to check)."""
    if mesh is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")


def round_batch(batch: dict, size: int) -> dict:
    """Each class's CUs per step rounded up to a multiple of the mesh size,
    so that every rank's block of a step has the same number of rows (the
    JAX package's ``WavefrontEncoder(mesh=...)`` does the same)."""
    return {p: (b + size - 1) // size * size for p, b in batch.items()}


def shard_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of a step's (B, 8) schedule rows (or of
    any batch, tensor or array): the ``P(None, "dp")`` cut of the batch
    axis. B must be a multiple of the mesh size (``round_batch``); a block
    may hold only padding rows."""
    B = rows.shape[0]
    if B % mesh.size:
        raise ValueError(f"{B} rows do not split over {mesh.size} ranks")
    b = B // mesh.size
    return rows[mesh.rank * b:(mesh.rank + 1) * b]
