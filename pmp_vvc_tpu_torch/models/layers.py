"""Building blocks for the Down-Up-CNN partition predictors (NCHW).

Counterpart of ``pmp_vvc_tpu/models/layers.py``. Submodule names equal the
flax names (``conv1``, ``conv2``, ``conv_sc``, ``block{i}``), so loading flax
weights is a pure renaming plus the HWIO -> OIHW kernel transpose
(``checkpoint.params_from_jax``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def zero_pad2d(x: torch.Tensor, left: int, right: int, top: int,
               bottom: int) -> torch.Tensor:
    """Zero-pad an NCHW tensor on the spatial dims."""
    return F.pad(x, (left, right, top, bottom))


def max_pool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping max pool (window == stride, VALID)."""
    return F.max_pool2d(x, window, window)


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest-neighbour upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class ResBlock(nn.Module):
    """conv-relu-conv residual block with optional 1x1 projection shortcut.

    Both convs are bias-free and "same"-padded; the shortcut is projected iff
    the channel count changes; ReLU after the residual add
    (``pmp_vvc_tpu/models/layers.py:ResBlock``; every block there has
    stride 1).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, kernel, padding="same",
                               bias=False)
        self.conv2 = nn.Conv2d(out_ch, out_ch, kernel, padding="same",
                               bias=False)
        self.conv_sc = (nn.Conv2d(in_ch, out_ch, 1, bias=False)
                        if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(x)))
        if self.conv_sc is not None:
            x = self.conv_sc(x)
        return F.relu(y + x)


class ResTrunk(nn.Sequential):
    """A sequence of ResBlocks named ``block{i}``; ``specs`` is a list of
    (out_ch, kernel)."""

    def __init__(self, in_ch: int, specs: Sequence[tuple[int, int]]):
        blocks = OrderedDict()
        for i, (out_ch, kernel) in enumerate(specs):
            blocks[f"block{i}"] = ResBlock(in_ch, out_ch, kernel)
            in_ch = out_ch
        super().__init__(blocks)
