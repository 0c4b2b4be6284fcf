"""Training losses for the Down-Up-CNN (plain PyTorch, NCHW).

Counterpart of ``pmp_vvc_tpu/train/losses.py``: QP-dependent direction
weighting, per-branch L1 terms and residual-depth coupling terms, with the
same float32 operation order. Branch outputs ``bd_i`` are (N,2,16,16) with
channels (mtt-depth, direction); ``bt_label`` and ``dire_label`` are
(N,3,16,16), the MTT layer on the channel axis, which is the dataset's
``.npy`` layout itself; ``qt_out`` and ``qt_label`` are (N,1,8,8).

The gradient of |x| is JAX's: +1 at 0 (``_abs``). These are the plain
versions; ``ops/train_generic.py:qbd_loss`` computes
the same loss and its gradient with the K11a kernel on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Weight of the non-zero direction class per (QP index, MTT layer); rows are
# QP 22/27/32/37.
LUMA_WEIGHT_MAT = 0.5 * np.array([[1.0, 0.73, 0.15],
                                  [2.43, 0.35, 0.10],
                                  [0.96, 0.23, 0.07],
                                  [0.59, 0.16, 0.05]])
CHROMA_WEIGHT_MAT = 0.5 * np.array([[17.83, 0.49, 0.11],
                                    [1.20, 0.25, 0.07],
                                    [0.58, 0.17, 0.05],
                                    [0.38, 0.12, 0.04]])

QPS = (22, 27, 32, 37)


@dataclass(frozen=True)
class LossWeights:
    """Per-term lambdas of the loss."""

    q: float = 1.0
    b: tuple = (0.8, 1.0, 1.2)
    d: tuple = (1.0, 1.0, 1.0)
    resb: tuple = (0.5, 0.5, 0.5)


def _abs(x):
    """|x| with JAX's derivative: ``lax.abs``'s JVP is ``select(x >= 0, g,
    -g)``, so the gradient is +1 at 0 (torch's ``abs`` gives 0 there).
    Predictions meet quantised labels exactly, so the two differ in
    training."""
    return torch.where(x >= 0, x, -x)


def _l1(a, b):
    return torch.mean(_abs(a - b))


def weight_row(qp: int, is_luma: bool) -> np.ndarray:
    """The three per-layer weights of ``qp`` as float32 (the JAX package
    adds the float64 table entry to a float32 array, which rounds it)."""
    mat = LUMA_WEIGHT_MAT if is_luma else CHROMA_WEIGHT_MAT
    return mat[QPS.index(qp)].astype(np.float32)


def direction_weights(dire_label, qp: int, is_luma: bool):
    """Per-layer weights w_i = dire_i^2 + weight_mat[qp][i] (w_0 = 1 at QP 22)."""
    row = weight_row(qp, is_luma)
    ws = [dire_label[:, i:i + 1] ** 2 + float(row[i]) for i in range(3)]
    if qp == 22:
        ws[0] = torch.ones_like(ws[0])
    return ws


def msbd_loss(bd_outs, bt_label, dire_label, *, qp: int, is_luma: bool,
              w: LossWeights = LossWeights()):
    """The MTT loss; ``bd_outs`` = (bd0, bd1, bd2)."""
    wd = direction_weights(dire_label, qp, is_luma)
    loss = 0.0
    prev_depth = None
    prev_label = None
    for i, bd in enumerate(bd_outs):
        depth, dire = bd[:, 0:1], bd[:, 1:2]
        bt_i = bt_label[:, i:i + 1]
        d_i = dire_label[:, i:i + 1]
        loss = loss + w.b[i] * _l1(depth, bt_i)
        loss = loss + w.d[i] * _l1(wd[i] * dire, wd[i] * d_i)
        if i == 0:
            loss = loss + w.resb[0] * _l1(wd[0] * depth, wd[0] * bt_i)
        else:
            loss = loss + w.resb[i] * _l1(wd[i] * (depth - prev_depth),
                                          wd[i] * (bt_i - prev_label))
        prev_depth, prev_label = depth, bt_i
    return loss


def qbd_loss(qt_out, bd_outs, qt_label, bt_label, dire_label, *, qp: int,
             is_luma: bool, w: LossWeights = LossWeights()):
    """The joint loss: QT L1 plus the MTT terms."""
    return w.q * _l1(qt_out, qt_label) + msbd_loss(
        bd_outs, bt_label, dire_label, qp=qp, is_luma=is_luma, w=w)


def q_loss(qt_out, qt_label):
    """The QT net's pretraining loss, plain L1."""
    return _l1(qt_out, qt_label)
