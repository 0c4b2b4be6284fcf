"""Batched partition-map prediction (Q-net + MSBD-net + structural vote).

Counterpart of ``pmp_vvc_tpu/pmp/predict.py:CompPredictor``. Inputs and
outputs keep the JAX package's layouts: x is (B, H, W, C) float32 numpy;
``predict`` returns qt [B,8,8], bt [B,3,16,16] and dire [B,3,16,16] float32
numpy. Inside, the nets run NCHW on ``device`` under ``inference_mode``, and
the vote on a CUDA device is the hand-written kernel (``structural.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..models import ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet, load_into
from .structural import structural_vote


def strict_fp32() -> None:
    """Run float32 convolutions and products in full float32.

    cuDNN runs float32 convolutions in TF32 (about three decimal digits) by
    default, which breaks parity with the JAX nets.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclass
class CompPredictor:
    """Predictor for one component (luma or chroma) at one QP."""

    q_net: nn.Module
    bd_net: nn.Module
    device: torch.device

    @classmethod
    def from_trained(cls, is_luma: bool, q_msgpack, bd_msgpack, device=None):
        """Q-net and BD-net from flax msgpack checkpoints
        (``trained_models/bd/{Luma,Chroma}_{Q,BD}_QP<qp>.msgpack``)."""
        device = resolve_device(device)
        strict_fp32()
        q_net = LumaQNet() if is_luma else ChromaQNet()
        bd_net = LumaMSBDNet() if is_luma else ChromaMSBDNet()
        load_into(q_net, q_msgpack)
        load_into(bd_net, bd_msgpack)
        return cls(q_net.to(device).eval(), bd_net.to(device).eval(), device)

    @torch.inference_mode()
    def forward(self, x: torch.Tensor):
        """NCHW batch on ``device`` -> raw (qt [B,8,8], bt, dire [B,3,16,16])."""
        qt_raw = self.q_net(x)
        bd = self.bd_net(x, qt_raw)
        bt = torch.cat([o[:, 0:1] for o in bd], dim=1)
        dire = torch.cat([o[:, 1:2] for o in bd], dim=1)
        return qt_raw[:, 0], bt, dire

    @torch.inference_mode()
    def predict(self, x: np.ndarray, batch_size: int = 512):
        """x: (B, H, W, C) float32 -> (qt [B,8,8], bt [B,3,16,16], dire)."""
        qts, bts, dires = [], [], []
        for i in range(0, x.shape[0], batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(x[i:i + batch_size]))
            chunk = chunk.to(self.device).permute(0, 3, 1, 2).contiguous()
            qt_raw, bt, dire = self.forward(chunk)
            qts.append(structural_vote(qt_raw.contiguous()).cpu().numpy())
            bts.append(bt.cpu().numpy())
            dires.append(dire.cpu().numpy())
        return (np.concatenate(qts), np.concatenate(bts),
                np.concatenate(dires))
