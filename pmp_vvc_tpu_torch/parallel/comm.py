"""Every collective of the port's multi-device work, in one place.

- ``all_gather``: the wave step's gather of each rank's block of per-CU
  outputs into the full batch (K12a), the spatial scan's final gather of
  the stripes, and the data-parallel predictor's gather of each rank's
  maps (K12c);
- ``all_reduce_sum``: the data-parallel training step's sum of the
  gradient bucket (K12c), the counterpart of the gradient ``psum`` XLA
  inserts;
- ``neighbour_exchange``: the spatial scan's halo send / receive with
  ranks d - 1 and d + 1 (K12b), the counterpart of the JAX package's two
  ``ppermute`` calls.

This is the one place where the backend matters. Under NCCL the tensors
stay on the card; NCCL's stream waits for the current stream, on which
every kernel of the port launches, and the current stream waits for NCCL's
before it goes on. Under gloo a tensor on the card crosses through host
memory: an explicit ``.cpu()`` before the collective and a copy back to
the card after it (the port does not rely on gloo taking CUDA tensors);
tensors on the CPU go as they are. ``transport`` names which of the three
ran.

``stats`` counts each collective's calls and the bytes this rank sent.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# name: [calls, bytes sent]
stats = {"all_gather": [0, 0], "all_reduce": [0, 0], "exchange": [0, 0]}


def reset_stats() -> None:
    for v in stats.values():
        v[:] = [0, 0]


def transport(mesh) -> str:
    """"nccl" (on the card), "gloo via host" (card tensors staged through
    host memory) or "gloo" (CPU tensors)."""
    if mesh.backend == "nccl":
        return "nccl"
    return "gloo via host" if mesh.device.type == "cuda" else "gloo"


def _count(name: str, *sent: torch.Tensor) -> None:
    stats[name][0] += 1
    stats[name][1] += sum(t.numel() * t.element_size() for t in sent)


def all_gather(mesh, block: torch.Tensor) -> torch.Tensor:
    """Every rank's ``block`` (the same shape on each), concatenated along
    dim 0 in rank order, on ``mesh.device``. Every rank must call it."""
    block = block.contiguous()
    _count("all_gather", block)
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size * block.shape[0], *block.shape[1:]),
                          dtype=block.dtype, device=block.device)
        dist.all_gather_into_tensor(out, block, group=mesh.group)
        return out
    src = block.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(mesh.device)


def all_reduce_sum(mesh, buf: torch.Tensor) -> torch.Tensor:
    """Sum the flat float32 ``buf`` over the mesh, in place; returns it.
    Every rank gets the same sum, bit for bit. Every rank must call it."""
    if buf.dtype != torch.float32 or buf.ndim != 1 or not buf.is_contiguous():
        raise ValueError("all_reduce_sum takes a flat contiguous float32 buffer")
    _count("all_reduce", buf)
    if mesh.backend == "nccl" or buf.device.type == "cpu":
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        return buf
    host = buf.cpu()
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.copy_(host)


def neighbour_exchange(mesh, buf: torch.Tensor, split: int) -> torch.Tensor:
    """Send ``buf[:split]`` to rank + 1 and ``buf[split:]`` to rank - 1
    (``buf`` 1-D); returns a buffer of the same layout holding what rank - 1
    sent right in ``[:split]`` and what rank + 1 sent left in
    ``[split:]``, zeros at the mesh's edges (rank 0 has no left neighbour,
    rank size - 1 no right one). Every rank must call it."""
    host = mesh.backend != "nccl" and mesh.device.type == "cuda"
    send = buf.contiguous().cpu() if host else buf.contiguous()
    recv = torch.zeros_like(send)
    ops, sent = [], []
    if mesh.rank > 0:
        left = mesh.global_rank(mesh.rank - 1)
        ops += [dist.P2POp(dist.isend, send[split:], left, mesh.group),
                dist.P2POp(dist.irecv, recv[:split], left, mesh.group)]
        sent.append(send[split:])
    if mesh.rank < mesh.size - 1:
        right = mesh.global_rank(mesh.rank + 1)
        ops += [dist.P2POp(dist.isend, send[:split], right, mesh.group),
                dist.P2POp(dist.irecv, recv[split:], right, mesh.group)]
        sent.append(send[:split])
    _count("exchange", *sent)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(mesh.device) if host else recv
