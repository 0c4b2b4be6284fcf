"""The training step's device work: the QBD loss with its gradient (K11a)
and the Adam update (K11b).

The JAX package's training steps (``train/trainer.py``, jitted at 85, 110
and 136) compute ``jax.value_and_grad`` of ``train/losses.py`` over the
nets and then optax's Adam. The convolutions and their gradients go to
cuDNN through ``torch.nn`` here; the loss and the update are kernels:

- ``qbd_loss`` (K11a, ``csrc/qbd_loss.cu``): the loss of one of three modes
  and its gradient with respect to ``qt_out`` and each branch output, in one
  launch that the autograd function ``_QBDLoss`` wraps (the blocks' partial
  sums meet in the last block through a ticket counter the wrapper keeps
  per device and stream); ``backward`` scales
  the saved gradients by the incoming one. Modes: ``"q"``, the QT net's
  plain L1 (``trainer.py:77-79``); ``"bd"``, ``msbd_loss``; ``"qbd"``,
  ``qbd_loss``. The plain version is ``qbd_loss_reference``, the autograd of
  ``train/losses.py``.
- ``adam_update`` (K11b, ``csrc/adam.cu``): optax's ``adam`` (b1 0.9, b2
  0.999, eps 1e-8, eps_root 0) over every parameter tensor in one launch, in
  place, in optax's operation order, the bias corrections computed on the
  host by ``bias_corrections``. The plain version is
  ``adam_update_reference``.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises; ``<wrapper>.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..train.losses import LossWeights, q_loss, msbd_loss, qbd_loss as qbd_loss_plain, \
    weight_row

MODES = ("q", "bd", "qbd")

# optax.adam's defaults. ``inject_hyperparams`` holds b1, b2 and eps as
# float32 arrays, so 1 - b1 and 1 - b2 are float32 differences
B1, B2, EPS = np.float32(0.9), np.float32(0.999), np.float32(1e-8)
ADAM_CONSTS = np.array([B1, np.float32(1) - B1, B2, np.float32(1) - B2, EPS], np.float32)


# ---------------------------------------------------------------------------
# K11a: the loss and its gradient
# ---------------------------------------------------------------------------

def _check_shapes(mode, qt_out, bd_outs, qt_label, bt_label, dire_label):
    if mode not in MODES:
        raise ValueError(f"qbd_loss mode must be one of {MODES}, got {mode!r}")
    if mode != "bd":
        n = qt_out.shape[0]
        if qt_out.shape != (n, 1, 8, 8) or qt_label.shape != (n, 1, 8, 8):
            raise ValueError(f"qt_out and qt_label must be (N,1,8,8), got "
                             f"{tuple(qt_out.shape)} and {tuple(qt_label.shape)}")
    if mode != "q":
        n = bt_label.shape[0]
        if len(bd_outs) != 3 or any(b.shape != (n, 2, 16, 16) for b in bd_outs):
            raise ValueError("bd_outs must be three (N,2,16,16) tensors")
        if bt_label.shape != (n, 3, 16, 16) or dire_label.shape != (n, 3, 16, 16):
            raise ValueError("bt_label and dire_label must be (N,3,16,16)")
        if mode == "qbd" and qt_out.shape[0] != n:
            raise ValueError("qt_out and the branch outputs differ in batch")


def qbd_loss_reference(mode, qt_out, bd_outs, qt_label, bt_label, dire_label, *,
                       qp, is_luma, w=LossWeights()):
    """Plain version of K11a: the differentiable loss of ``mode`` from
    ``train/losses.py`` (its gradient is autograd's)."""
    _check_shapes(mode, qt_out, bd_outs, qt_label, bt_label, dire_label)
    if mode == "q":
        return q_loss(qt_out, qt_label)
    if mode == "bd":
        return msbd_loss(bd_outs, bt_label, dire_label, qp=qp, is_luma=is_luma, w=w)
    return qbd_loss_plain(qt_out, bd_outs, qt_label, bt_label, dire_label, qp=qp,
                          is_luma=is_luma, w=w)


def loss_params(mode, n, qp, is_luma, w=LossWeights()) -> np.ndarray:
    """(24,) float32 scalars of K11a: the direction weights of ``qp`` (3),
    1 at QP 22 (1), the term weights q, b0-2, d0-2, resb0-2 (10) and the
    gradient scale of each term, weight / count (10), the last as autograd
    forms it (the mean's backward divides the product's gradient by the
    element count). The loss of mode "q" is unweighted."""
    wq = 1.0 if mode == "q" else w.q
    c = np.array([wq, *w.b, *w.d, *w.resb], np.float32)
    count = np.array([n * 64] + [n * 256] * 9, np.float32)
    return np.concatenate([weight_row(qp, is_luma), [float(qp == 22)], c, c / count]) \
        .astype(np.float32)


SIGNATURES = {
    "qbd_loss": {"pmp_qbd_loss": (_build.INT, _build.INT) + (_build.PTR,) * 16,
                 "pmp_qbd_loss_blocks": (_build.INT, _build.INT)},
    "adam": {"pmp_adam_update": (_build.INT,) + (_build.PTR,) * 7},
}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


# K11a's ticket counters, one a (device, stream): zeroed once, and 0 again
# after every launch (the last block's atomicInc wraps it)
_TICKETS: dict = {}


def _ticket(dev, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((), dtype=torch.int32, device=dev)
    return _TICKETS[key]


def _launch_loss(mode, qt_out, bd_outs, qt_label, bt_label, dire_label, params):
    has_q, has_bd = mode != "bd", mode != "q"
    q_in = (qt_out, qt_label) if has_q else (None, None)
    bd_in = (*bd_outs, bt_label, dire_label) if has_bd else (None,) * 5
    tensors = [t for t in q_in + bd_in if t is not None]
    _build.check_cuda("qbd_loss", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("qbd_loss takes float32 tensors")
    n, dev, stream = tensors[0].shape[0], tensors[0].device, _build.stream(tensors[0])
    lib, m = _lib("qbd_loss"), MODES.index(mode)
    partials = torch.empty(lib.pmp_qbd_loss_blocks(m, n) * 10, dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    g_qt = torch.empty_like(qt_out) if has_q else None
    g_bd = [torch.empty_like(b) for b in bd_outs] if has_bd else [None] * 3
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.pmp_qbd_loss(
        m, n, *map(ptr, q_in + bd_in), params.ctypes.data,
        *map(ptr, [g_qt, *g_bd]), partials.data_ptr(), _ticket(dev, stream).data_ptr(),
        loss.data_ptr(), stream)
    _build.count_launch(qbd_loss, err)
    return loss, g_qt, g_bd


class _QBDLoss(torch.autograd.Function):
    """K11a under autograd: the forward computes the loss and every
    gradient at once; the backward scales them by the incoming gradient."""

    @staticmethod
    def forward(ctx, mode, params, qt_out, qt_label, bt_label, dire_label, bd0, bd1, bd2):
        loss, g_qt, g_bd = _launch_loss(mode, qt_out, (bd0, bd1, bd2), qt_label,
                                        bt_label, dire_label, params)
        ctx.save_for_backward(g_qt, *g_bd)
        return loss

    @staticmethod
    def backward(ctx, grad):
        g_qt, *g_bd = ctx.saved_tensors
        scale = lambda g: None if g is None else g * grad
        return (None, None, scale(g_qt), None, None, None, *(scale(g) for g in g_bd))


def qbd_loss(mode, qt_out, bd_outs, qt_label, bt_label, dire_label, *, qp, is_luma,
             w=LossWeights()):
    """K11a: the training loss of ``mode`` ("q", "bd" or "qbd"), a scalar
    with a gradient with respect to ``qt_out`` ("q", "qbd") and the three
    branch outputs ("bd", "qbd"); the labels get none. Tensors the mode does
    not use may be None. CPU tensors take ``qbd_loss_reference``; CUDA
    tensors launch ``csrc/qbd_loss.cu``."""
    _check_shapes(mode, qt_out, bd_outs, qt_label, bt_label, dire_label)
    ref = qt_out if mode != "bd" else bt_label
    if ref.device.type == "cpu":
        return qbd_loss_reference(mode, qt_out, bd_outs, qt_label, bt_label, dire_label,
                                  qp=qp, is_luma=is_luma, w=w)
    params = loss_params(mode, ref.shape[0], qp, is_luma, w)
    q = (lambda t: t.contiguous()) if mode != "bd" else (lambda t: None)
    b = (lambda t: t.contiguous()) if mode != "q" else (lambda t: None)
    return _QBDLoss.apply(mode, params, q(qt_out), q(qt_label), b(bt_label), b(dire_label),
                          *(b(x) for x in (bd_outs if mode != "q" else (None,) * 3)))


qbd_loss.launches = 0


# ---------------------------------------------------------------------------
# K11b: the Adam update
# ---------------------------------------------------------------------------

def bias_corrections(count: int) -> tuple[float, float]:
    """optax's ``1 - b ** count`` for b1 and b2 in float32, as XLA forms it:
    the float32 power of the float32 constant with the count converted to
    float32, then the difference (equal to XLA's for every count from 1 to
    3,000 on the CPU)."""
    return tuple(float(np.float32(1) - b ** np.float32(count)) for b in (B1, B2))


def _flat_views(flat, params):
    views, off = [], 0
    for p in params:
        views.append(flat[off:off + p.numel()].view_as(p))
        off += p.numel()
    if off != flat.numel():
        raise ValueError(f"the moment buffers hold {flat.numel()} values, the "
                         f"parameters {off}")
    return views


@torch.no_grad()
def adam_update_reference(params, grads, mu, nu, lr, bc1, bc2):
    """Plain version of K11b: optax's Adam step, in place, with torch ops in
    optax's order: mu = (1-b1) g + b1 mu; nu = (1-b2) g g + b2 nu; then
    p + (-lr) (mu / bc1) / (sqrt(nu / bc2) + eps). ``mu`` and ``nu`` are flat
    float32 buffers holding the moments of ``params`` in order; ``bc1`` and
    ``bc2`` come from ``bias_corrections``. The corrections divide as
    one-element tensors: a division by a Python scalar may multiply by its
    reciprocal on the card."""
    b1, omb1, b2, omb2, eps = (float(c) for c in ADAM_CONSTS)
    dev = mu.device
    bc = torch.tensor([bc1, bc2], dtype=torch.float32, device=dev)
    neg_lr = -float(np.float32(lr))
    for p, g, m, v in zip(params, grads, _flat_views(mu, params), _flat_views(nu, params)):
        m.copy_(g * omb1 + m * b1)
        v.copy_((g * g) * omb2 + v * b2)
        u = (m / bc[0]) / (torch.sqrt(v / bc[1]) + eps)
        p.copy_(p + u * neg_lr)


def adam_update(params, grads, mu, nu, lr, bc1, bc2):
    """K11b: ``adam_update_reference``'s step over every tensor of ``params``
    in one launch (a table of pointers passed by value; above 128 tensors,
    one launch per 128). CPU tensors take the plain version; CUDA tensors
    launch ``csrc/adam.cu``. Updates ``params``, ``mu`` and ``nu`` in place."""
    params, grads = list(params), list(grads)
    if len(params) != len(grads) or any(p.shape != g.shape for p, g in zip(params, grads)):
        raise ValueError("adam_update: parameters and gradients differ in shape")
    if mu.device.type == "cpu":
        return adam_update_reference(params, grads, mu, nu, lr, bc1, bc2)
    _build.check_cuda("adam_update", mu, nu, *params, *grads)
    if any(t.dtype != torch.float32 for t in (mu, nu, *params, *grads)):
        raise TypeError("adam_update takes float32 tensors")
    numel = [p.numel() for p in params]
    if sum(numel) != mu.numel() or mu.shape != nu.shape or sum(numel) >= 2 ** 31:
        raise ValueError("adam_update: the moment buffers do not fit the parameters")
    k = len(params)
    ptrs = (ctypes.c_void_p * k)(*(p.data_ptr() for p in params))
    gptrs = (ctypes.c_void_p * k)(*(g.data_ptr() for g in grads))
    sizes = (ctypes.c_int64 * k)(*numel)
    scalars = np.concatenate([ADAM_CONSTS, np.array([bc1, bc2, -np.float32(lr)],
                                                    np.float32)]).astype(np.float32)
    err = _lib("adam").pmp_adam_update(
        k, ptrs, gptrs, sizes, mu.data_ptr(), nu.data_ptr(), scalars.ctypes.data,
        _build.stream(mu))
    _build.count_launch(adam_update, err)
    adam_update.launches += -(-k // ADAM_MAX_TENSORS) - 1


ADAM_MAX_TENSORS = 128
adam_update.launches = 0
