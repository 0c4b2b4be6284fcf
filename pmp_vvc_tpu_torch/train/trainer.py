"""The three training stages' steps, on one card or data-parallel over a
mesh.

Counterpart of ``pmp_vvc_tpu/train/trainer.py``:
- stage "q"   : pretrain the QT net, plain L1;
- stage "bd"  : pretrain the MTT net on QT *labels*;
- stage "qbd" : joint fine-tune, the QT net's output feeding the MTT net,
  one optimizer over both nets.

A step runs the nets forward (cuDNN convolutions through ``torch.nn``, TF32
off as in ``pmp/predict.py:strict_fp32``), the loss with its gradient (K11a,
``ops/train_generic.py:qbd_loss``), autograd's backward through the nets,
and the Adam update (K11b, ``adam_update``), which changes the nets'
parameters in place where the JAX step returns new ones.

Data parallelism (K12c), the counterpart of the JAX package's 1-D ``dp``
mesh (``data_mesh``, ``_shard_batch`` and the gradient ``psum`` XLA
inserts): with ``mesh=`` a step takes this rank's block of the global batch
(``shard_batch``, or ``parallel.host_shard`` of a slice the rank loaded
itself), and after autograd packs the gradients and the loss into one
bucket scaled by 1/D (``ops/dp_generic.py:bucket_pack``), sums it over the
mesh (``parallel.comm.all_reduce_sum``) and hands the bucket's views to
K11b. K11a normalises by the rank's block, so the mean of the D equal
blocks' means is the global batch's mean that JAX's loss takes; every rank
applies the same summed bucket and keeps the same parameters, bit for bit.
The step returns the summed loss.
"""
from __future__ import annotations

import torch

from ..ops.dp_generic import bucket_pack
from ..ops.train_generic import _flat_views, adam_update, bias_corrections, qbd_loss
from ..parallel import comm
from ..parallel.wavefront_dp import check_device, make_mesh, shard_rows
from .losses import LossWeights


def step_decay_schedule(lr: float, decay_every: int):
    """lr * 0.5**(epoch // decay_every), frozen once below 1e-6.

    Returns f(epoch) -> lr.
    """
    def sched(epoch: int) -> float:
        e = int(epoch)
        while e > 0 and lr * (0.5 ** (e // decay_every)) <= 1e-6:
            e -= 1
        return lr * (0.5 ** (e // decay_every))
    return sched


def data_mesh(group=None, device=None):
    """The data-parallel mesh over ``group`` (default: every rank of the
    default group); ``parallel.make_mesh``."""
    return make_mesh(group, device)


def shard_batch(mesh, tree):
    """This rank's contiguous block (``rank*b:(rank+1)*b``,
    ``parallel.shard_rows``) of every array of a global batch ``tree`` (an
    array or a tuple / list of arrays): the single-process ``_shard_batch``
    of the JAX package. Raises when the mesh size does not divide a batch,
    as a ``NamedSharding`` of the batch axis does."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_rows(mesh, a) for a in tree)
    return shard_rows(mesh, tree)


class Adam:
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8) over ``params``, with
    the learning rate given every step. The moments live on the parameters'
    device as two flat buffers in parameter order; the step count stays on
    the host, which forms the bias corrections from it."""

    def __init__(self, params):
        self.params = list(params)
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.count = 0

    def step(self, grads, lr: float) -> None:
        self.count += 1
        bc1, bc2 = bias_corrections(self.count)
        adam_update(self.params, [g.contiguous() for g in grads], self.mu, self.nu, lr,
                    bc1, bc2)


def _step(loss, opt: Adam, lr: float, mesh=None):
    grads = torch.autograd.grad(loss, opt.params)
    if mesh is None:
        opt.step(grads, lr)
        return loss.detach()
    bucket = bucket_pack([g.contiguous() for g in grads], loss.detach(), 1.0 / mesh.size)
    comm.all_reduce_sum(mesh, bucket)
    opt.step(_flat_views(bucket[:-1], opt.params), lr)
    return bucket[-1].clone()       # not a view that keeps the bucket alive


def make_q_train_step(net, opt: Adam, mesh=None):
    """Stage "q": (x, qt_label, lr) -> loss (a device scalar); under
    ``mesh`` the batch is this rank's block and the loss the global one."""
    check_device(mesh, opt.params[0].device)

    def run(x, qt_label, lr):
        # mode "q" reads no QP or component
        loss = qbd_loss("q", net(x), None, qt_label, None, None, qp=22, is_luma=True)
        return _step(loss, opt, lr, mesh)

    return run


def make_bd_train_step(net, opt: Adam, *, qp: int, is_luma: bool,
                       w: LossWeights = LossWeights(), mesh=None):
    """Stage "bd": the MTT net on the QT labels as its QT input;
    (x, qt_label, bt_label, dire_label, lr) -> loss."""
    check_device(mesh, opt.params[0].device)

    def run(x, qt_label, bt_label, dire_label, lr):
        outs = net(x, qt_label)
        loss = qbd_loss("bd", None, outs, None, bt_label, dire_label, qp=qp,
                        is_luma=is_luma, w=w)
        return _step(loss, opt, lr, mesh)

    return run


def make_qbd_train_step(q_net, bd_net, opt: Adam, *, qp: int, is_luma: bool,
                        w: LossWeights = LossWeights(), mesh=None):
    """Joint stage: one optimizer over both nets' parameters; the QT net's
    output feeds the MTT net, so the MTT terms' gradient reaches the QT net
    through it. (x, qt_label, bt_label, dire_label, lr) -> loss."""
    check_device(mesh, opt.params[0].device)

    def run(x, qt_label, bt_label, dire_label, lr):
        qt_out = q_net(x)
        outs = bd_net(x, qt_out)
        loss = qbd_loss("qbd", qt_out, outs, qt_label, bt_label, dire_label, qp=qp,
                        is_luma=is_luma, w=w)
        return _step(loss, opt, lr, mesh)

    return run
