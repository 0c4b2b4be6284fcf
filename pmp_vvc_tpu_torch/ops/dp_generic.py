"""The data-parallel training step's gradient bucket (K12c).

The JAX package's sharded training steps (``train/trainer.py``, the batch
cut by ``_shard_batch`` 63-70) leave the gradient sum over the mesh to XLA,
which combines the gradients into buffers and sums them with ``psum``. The port
does it by hand: ``bucket_pack`` copies every gradient tensor and the
step's loss into one flat float32 buffer, each value times ``scale``, so
that one ``parallel.comm.all_reduce_sum`` sums them all; the Adam update
(K11b) then takes the gradients as views of the summed bucket
(``ops/train_generic.py:_flat_views``), and the loss is its last element.
No unpack is needed.

``bucket_pack`` takes its plain version, ``bucket_pack_reference``, for CPU
tensors and launches ``csrc/grad_bucket.cu`` for CUDA tensors, or raises;
``bucket_pack.launches`` counts the kernel's launches (one per 128
sources).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build

MAX_TENSORS = 128           # sources a launch takes (csrc/grad_bucket.cu)

SIGNATURES = {"grad_bucket": {"pmp_bucket_pack": (
    _build.INT, _build.PTR, _build.PTR, _build.PTR, _build.FLOAT, _build.PTR)}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def _sources(grads, loss) -> list:
    if loss.numel() != 1:
        raise ValueError(f"the loss must hold one value, got {tuple(loss.shape)}")
    srcs = [*grads, loss]
    if any(t.dtype != torch.float32 for t in srcs):
        raise TypeError("bucket_pack takes float32 tensors")
    if any(t.device != loss.device for t in srcs):
        raise ValueError("bucket_pack takes tensors on one device")
    return srcs


@torch.no_grad()
def bucket_pack_reference(grads, loss, scale: float) -> torch.Tensor:
    """Plain version of K12c: every gradient flattened in order, then the
    loss, in one float32 buffer, each value times ``scale`` (in float32)."""
    srcs = _sources(list(grads), loss)
    s = float(np.float32(scale))
    return torch.cat([t.reshape(-1) * s for t in srcs])


def bucket_pack(grads, loss, scale: float) -> torch.Tensor:
    """K12c: ``bucket_pack_reference``'s buffer in one launch (a table of
    pointers passed by value; above 128 sources, one launch per 128). CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/grad_bucket.cu``; ``grads`` must then be contiguous."""
    srcs = _sources(list(grads), loss)
    if loss.device.type == "cpu":
        return bucket_pack_reference(grads, loss, scale)
    _build.check_cuda("bucket_pack", *srcs)
    numel = [t.numel() for t in srcs]
    if sum(numel) >= 2 ** 31:
        raise ValueError("bucket_pack: the bucket exceeds 2^31 values")
    out = torch.empty(sum(numel), dtype=torch.float32, device=loss.device)
    k = len(srcs)
    ptrs = (ctypes.c_void_p * k)(*(t.data_ptr() for t in srcs))
    sizes = (ctypes.c_int64 * k)(*numel)
    err = _lib("grad_bucket").pmp_bucket_pack(k, ptrs, sizes, out.data_ptr(),
                                              float(np.float32(scale)), _build.stream(out))
    _build.count_launch(bucket_pack, err)
    bucket_pack.launches += -(-k // MAX_TENSORS) - 1
    return out


bucket_pack.launches = 0
