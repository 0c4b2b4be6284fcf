"""Batched partition-map prediction (Q-net + MSBD-net + structural vote).

Counterpart of ``pmp_vvc_tpu/pmp/predict.py:CompPredictor``. Inputs and
outputs keep the JAX package's layouts: x is (B, H, W, C) float32 numpy;
``predict`` returns qt [B,8,8], bt [B,3,16,16] and dire [B,3,16,16] float32
numpy. Inside, the nets run NCHW on ``device`` under ``inference_mode``, and
the vote on a CUDA device is the hand-written kernel (``structural.py``).

With ``mesh=`` (K12c) the batch is sharded as the JAX predictor shards it
(``P("dp")``): each chunk is padded to a multiple of the mesh size by
repeating its last CTU, each rank runs the nets and the vote on its
contiguous block, one ``parallel.comm.all_gather`` per chunk brings every
rank's (voted qt, bt, dire) rows together, and the padding is dropped, so
every rank returns the whole batch's maps. Every rank must call
``predict`` with the same input.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..models import ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet, load_into
from ..parallel import comm
from ..parallel.wavefront_dp import check_device, shard_rows
from .structural import structural_vote

QT_VALUES, BD_VALUES = 64, 3 * 16 * 16      # a CTU's qt and bt (or dire) values


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
    mesh: object = None     # parallel.Mesh: the batch sharded over its ranks

    def __post_init__(self):
        check_device(self.mesh, self.device)

    @classmethod
    def from_trained(cls, is_luma: bool, q_msgpack, bd_msgpack, device=None, mesh=None):
        """Q-net and BD-net from flax msgpack checkpoints
        (``trained_models/bd/{Luma,Chroma}_{Q,BD}_QP<qp>.msgpack``); under
        ``mesh`` on the mesh's device unless ``device`` is given."""
        if mesh is not None and device is None:
            device = mesh.device
        device = resolve_device(device)
        check_device(mesh, device)
        strict_fp32()
        q_net = LumaQNet() if is_luma else ChromaQNet()
        bd_net = LumaMSBDNet() if is_luma else ChromaMSBDNet()
        load_into(q_net, q_msgpack)
        load_into(bd_net, bd_msgpack)
        return cls(q_net.to(device).eval(), bd_net.to(device).eval(), device, mesh)

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
            chunk = np.ascontiguousarray(x[i:i + batch_size])
            m = chunk.shape[0]
            if self.mesh is not None:
                chunk = self._block(chunk)
            chunk = torch.from_numpy(chunk).to(self.device).permute(0, 3, 1, 2).contiguous()
            qt_raw, bt, dire = self.forward(chunk)
            qt = structural_vote(qt_raw.contiguous())
            if self.mesh is not None:
                qt, bt, dire = self._gather(qt, bt, dire, m)
            qts.append(qt.cpu().numpy())
            bts.append(bt.cpu().numpy())
            dires.append(dire.cpu().numpy())
        return (np.concatenate(qts), np.concatenate(bts),
                np.concatenate(dires))

    def _block(self, chunk: np.ndarray) -> np.ndarray:
        """This rank's block of ``chunk`` padded to a multiple of the mesh
        size with copies of its last CTU (a block may be padding only)."""
        pad = -len(chunk) % self.mesh.size
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        return shard_rows(self.mesh, chunk)

    def _gather(self, qt, bt, dire, m: int):
        """Every rank's (qt, bt, dire) rows in rank order, padding dropped:
        the chunk's first ``m`` CTUs."""
        b = qt.shape[0]
        rows = torch.cat([qt.reshape(b, QT_VALUES), bt.reshape(b, BD_VALUES),
                          dire.reshape(b, BD_VALUES)], 1)
        rows = comm.all_gather(self.mesh, rows)[:m]
        qt, bt, dire = rows.split([QT_VALUES, BD_VALUES, BD_VALUES], 1)
        return (qt.reshape(m, 8, 8), bt.reshape(m, 3, 16, 16), dire.reshape(m, 3, 16, 16))
