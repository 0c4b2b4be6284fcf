"""Down-Up-CNN partition predictors (PyTorch, NCHW).

Counterpart of ``pmp_vvc_tpu/models/qbd.py``, with the same four nets:

- LumaQNet      : (N,1,68,68) luma CTU+halo -> (N,1,8,8)  QT-depth map
- LumaMSBDNet   : ((N,1,68,68), (N,1,8,8))  -> 3 x (N,2,16,16) (mtt-depth, direction)
- ChromaQNet    : (N,3,34,34) (pooled-Y,U,V) -> (N,1,8,8)
- ChromaMSBDNet : ((N,3,34,34), (N,1,8,8))  -> 3 x (N,2,16,16)

The stems use VALID convolutions on the same asymmetric zero-pads as the JAX
nets (right/bottom for the stems, left/top for the upsampled QT map), so the
4-px top-left halo geometry is the same. Module names equal the flax names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ResBlock, ResTrunk, max_pool2d, nearest_upsample, zero_pad2d


def _pyramid(x: torch.Tensor) -> torch.Tensor:
    """Concat x with its 2/4/8 max-pooled, re-upsampled copies (channels)."""
    return torch.cat([x] + [nearest_upsample(max_pool2d(x, f), f)
                            for f in (2, 4, 8)], dim=1)


class _QNet(nn.Module):
    """Q-net: VALID stem on a right/bottom zero-pad, two ResBlocks down to
    16x16, a pooling pyramid trunk, 8x8x1 output (``qbd.py:LumaQNet`` /
    ``ChromaQNet``; they differ only in the stem and the first blocks)."""

    def __init__(self, in_ch: int, halo: int, stem_k: int, res_k: int,
                 pool_q1: bool):
        super().__init__()
        self.halo, self.pool_q1 = halo, pool_q1
        self.conv_q1 = nn.Conv2d(in_ch, 32, stem_k)
        self.resblock_q1 = ResBlock(32, 64, res_k)
        self.resblock_q2 = ResBlock(64, 64, res_k)
        self.resblock_q3 = ResBlock(64, 32, 3)
        self.resblock_q4 = ResBlock(128, 32, 3)
        self.resblock_q5 = ResBlock(32, 32, 3)
        self.resblock_q6 = ResBlock(32, 8, 3)
        self.conv_q2 = nn.Conv2d(8, 1, 3, padding="same")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.halo
        x = F.relu(self.conv_q1(zero_pad2d(x, 0, h, 0, h)))     # 64(32)^2 x32
        x = self.resblock_q1(x)
        x = max_pool2d(x, 2) if self.pool_q1 else x             # 32x32x64
        x = max_pool2d(self.resblock_q2(x), 2)                  # 16x16x64
        x = self.resblock_q3(x)                                 # 16x16x32
        x = self.resblock_q4(_pyramid(x))                       # 16x16x32
        x = max_pool2d(self.resblock_q5(x), 2)                  # 8x8x32
        return self.conv_q2(self.resblock_q6(x))                # 8x8x1


class LumaQNet(_QNet):
    """Luma QT-depth predictor: (N,1,68,68) -> (N,1,8,8)."""

    def __init__(self):
        super().__init__(1, halo=4, stem_k=9, res_k=5, pool_q1=True)


class ChromaQNet(_QNet):
    """Chroma QT-depth predictor: (N,3,34,34) -> (N,1,8,8)."""

    def __init__(self):
        super().__init__(3, halo=2, stem_k=5, res_k=3, pool_q1=False)


_TRUNK_M1 = ((64, 5), (64, 3), (64, 3), (64, 3), (64, 3), (64, 3))
_TRUNK_M2 = ((64, 3), (64, 3), (64, 3), (64, 3))
_TRUNK_B = ((32, 3), (16, 3), (8, 3))
_TRUNK_ATT = ((32, 3), (64, 3))


def _couple(out: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Residual coupling of the depth channel: out[:,0] += prev[:,0]."""
    return torch.cat([out[:, 0:1] + prev[:, 0:1], out[:, 1:2]], dim=1)


class _MSBDCore(nn.Module):
    """Shared multi-scale depth+direction head ("Up" part of Down-Up-CNN).

    Three output branches with attention trunks gating the main-trunk
    features (elementwise), and residual coupling of the depth channel
    between branches (``qbd.py:_MSBDCore``).
    """

    def __init__(self, in_ch: int, halo: int, qt_up: int, stem_k: tuple,
                 pool_m1: bool):
        super().__init__()
        self.halo, self.qt_up, self.pool_m1 = halo, qt_up, pool_m1
        k = stem_k
        c = in_ch + 1
        # non-square stems: kernel (kh, kw) is (k[1], k[0]) and (k[0], k[1]),
        # the same order in flax and torch
        self.conv_b1_1 = nn.Conv2d(c, 16, (k[0], k[0]))
        self.conv_b1_2 = nn.Conv2d(c, 8, (k[1], k[0]))
        self.conv_b1_3 = nn.Conv2d(c, 8, (k[0], k[1]))
        self.trunk_M1 = ResTrunk(32, _TRUNK_M1)
        self.trunk_M2 = ResTrunk(64, _TRUNK_M2)
        self.trunk_B1 = ResTrunk(64, _TRUNK_B)
        self.trunk_B2 = ResTrunk(64, _TRUNK_B)
        self.trunk_B3 = ResTrunk(64, _TRUNK_B)
        self.trunk_Att1 = ResTrunk(3, _TRUNK_ATT)
        self.trunk_Att2 = ResTrunk(3, _TRUNK_ATT)
        self.conv_B1 = nn.Conv2d(8, 2, 3, padding="same")
        self.conv_B2 = nn.Conv2d(8, 2, 3, padding="same")
        self.conv_B3 = nn.Conv2d(8, 2, 3, padding="same")

    def forward(self, x: torch.Tensor, qt: torch.Tensor):
        h = self.halo
        qt_full = zero_pad2d(nearest_upsample(qt, self.qt_up), h, 0, h, 0)
        x2 = torch.cat([x, qt_full], dim=1)
        s1 = F.relu(self.conv_b1_1(zero_pad2d(x2, 0, h, 0, h)))
        s2 = F.relu(self.conv_b1_2(zero_pad2d(x2, 0, h, 0, 0)))
        s3 = F.relu(self.conv_b1_3(zero_pad2d(x2, 0, 0, 0, h)))
        x3 = torch.cat([s1, s2, s3], dim=1)                 # 32ch @ 64(32)^2

        m1 = self.trunk_M1(x3)
        x4 = max_pool2d(m1, 2) if self.pool_m1 else m1      # 64ch @ 32x32
        x5 = max_pool2d(self.trunk_M2(x4), 2)               # 64ch @ 16x16

        # Branch 1
        out0 = self.conv_B1(self.trunk_B1(x5))              # (N,2,16,16)

        # Branch 2: attention over (qt, out0)
        att0 = self.trunk_Att1(torch.cat([nearest_upsample(qt, 2), out0], 1))
        out1 = _couple(self.conv_B2(self.trunk_B2(x5 * att0)), out0)

        # Branch 3: attention at 32x32 over (qt, out1)
        att1 = self.trunk_Att2(torch.cat(
            [nearest_upsample(qt, 4), nearest_upsample(out1, 2)], 1))
        b3 = max_pool2d(self.trunk_B3(x4 * att1), 2)
        out2 = _couple(self.conv_B3(b3), out1)
        return out0, out1, out2


class LumaMSBDNet(nn.Module):
    """Luma MTT depth+direction predictor (``qbd.py:LumaMSBDNet``)."""

    def __init__(self):
        super().__init__()
        self.core = _MSBDCore(1, halo=4, qt_up=8, stem_k=(9, 5), pool_m1=True)

    def forward(self, x: torch.Tensor, qt: torch.Tensor):
        return self.core(x, qt)


class ChromaMSBDNet(nn.Module):
    """Chroma MTT depth+direction predictor (``qbd.py:ChromaMSBDNet``)."""

    def __init__(self):
        super().__init__()
        self.core = _MSBDCore(3, halo=2, qt_up=4, stem_k=(5, 3), pool_m1=False)

    def forward(self, x: torch.Tensor, qt: torch.Tensor):
        return self.core(x, qt)
