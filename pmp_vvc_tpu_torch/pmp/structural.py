"""QT-depth map structural-consistency vote (post-processing), kernel K8.

The raw 8x8 QT-depth output is 2x2 max-pooled, rounded half to even,
clamped to [0,3], then each 4x4 map is repaired by majority vote so the
implied quadtree is structurally consistent, and nearest-upsampled back to
8x8 (``pmp_vvc_tpu/pmp/structural.py``).

``structural_vote`` dispatches on the tensor's device: a CPU tensor goes
through the plain PyTorch version ``structural_vote_reference``; a CUDA
tensor goes through the hand-written kernel ``csrc/structural_vote.cu`` or
raises. ``structural_vote.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import functools

import torch

from .. import _build


def _check_square_unity(mat: torch.Tensor) -> torch.Tensor:
    """Repair of (N, 4, 4) depth maps."""
    n = mat.shape[0]
    num0 = (mat == 0).sum(dim=(-2, -1), keepdim=True)

    # Case A (num0 <= 12): promote zeros to 1, then harmonize each 2x2 quadrant.
    a = torch.where(mat == 0, torch.ones_like(mat), mat)
    quads = a.reshape(n, 2, 2, 2, 2).permute(0, 1, 3, 2, 4)  # quadrant-major
    qsum = quads.sum(dim=(-2, -1), keepdim=True)
    n1 = (quads == 1).sum(dim=(-2, -1), keepdim=True)
    mixed = (qsum >= 5) & (qsum <= 10)
    promoted = torch.where(quads == 1, torch.full_like(quads, 2.0), quads)
    flattened = torch.ones_like(quads)
    quads = torch.where(mixed, torch.where(n1 < 3, promoted, flattened), quads)
    a = quads.permute(0, 1, 3, 2, 4).reshape(mat.shape)

    out = torch.where(num0 <= 12, a, mat)
    # Case B (12 < num0 < 16): all zeros. num0 == 16 is untouched (already 0).
    return torch.where((num0 > 12) & (num0 < 16), torch.zeros_like(mat), out)


def structural_vote_reference(qt_raw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch vote: (N, 8, 8[, 1]) raw -> repaired (same shape)."""
    squeeze = qt_raw.ndim == 4
    x = qt_raw[..., 0] if squeeze else qt_raw
    n = x.shape[0]
    pooled = x.reshape(n, 4, 2, 4, 2).amax(dim=(2, 4))
    pooled = pooled.round().clamp(0, 3)
    repaired = _check_square_unity(pooled)
    up = repaired[:, :, None, :, None].expand(n, 4, 2, 4, 2).reshape(n, 8, 8)
    return up.unsqueeze(-1) if squeeze else up


SIGNATURES = {"structural_vote": {"pmp_structural_vote": (
    _build.PTR, _build.PTR, _build.INT64, _build.PTR)}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def _launch(qt_raw: torch.Tensor) -> torch.Tensor:
    if qt_raw.dtype != torch.float32:
        raise TypeError(f"structural_vote kernel takes float32, got {qt_raw.dtype}")
    if not qt_raw.is_contiguous():
        raise ValueError("structural_vote kernel takes a contiguous tensor")
    if qt_raw.data_ptr() % 16:
        raise ValueError("structural_vote kernel takes a 16-byte aligned tensor")
    out = torch.empty_like(qt_raw)
    n = qt_raw.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(qt_raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("structural_vote").pmp_structural_vote(
            qt_raw.data_ptr(), out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"structural_vote kernel launch failed: CUDA error {err}")
    structural_vote.launches += 1
    return out


def structural_vote(qt_raw: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8[, 1]) raw QT-depth output -> structurally repaired (same shape).

    CPU tensors use the plain version; CUDA tensors launch the kernel.
    """
    if qt_raw.shape[1:] not in ((8, 8), (8, 8, 1)):
        raise ValueError(f"expected (N, 8, 8) or (N, 8, 8, 1), got {tuple(qt_raw.shape)}")
    if qt_raw.device.type == "cpu":
        return structural_vote_reference(qt_raw)
    if qt_raw.device.type != "cuda":
        raise ValueError(f"structural_vote runs on cpu or cuda, not {qt_raw.device}")
    return _launch(qt_raw)


structural_vote.launches = 0
