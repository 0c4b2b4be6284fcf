"""Training driver: epoch loop, lr schedule, validation metrics, loss CSV,
checkpoint cadence.

Counterpart of ``pmp_vvc_tpu/train/driver.py``, in NCHW. The dataset layout
is the reference ``.npy`` convention, per split (Train/Validate):
  <split>_Y_Block68.npy                        (N, 68, 68)   luma inputs
  <split>_Chroma_Block34.npy                   (N, 34, 34, 3) chroma inputs
  <split>_<comp>_QP<q>_QTdepth_Block8.npy      (N, 8, 8)
  <split>_<comp>_QP<q>_MSBTdepth_Block16.npy   (N, 3, 16, 16)
  <split>_<comp>_QP<q>_MSdirection_Block16.npy (N, 3, 16, 16)
The QT label is shifted by -1 (QT depth starts at 1 under CTU-128).
``synth_dataset`` fabricates a small learnable set for smoke training.

The whole split goes to the device once; each step gathers its batch there.
With ``mesh=`` (K12c) every rank draws the same permutation and the same
initialisation, steps on its ``shard_batch`` block of every batch,
validates unsharded and returns the same rows (but for their wall time
``time_s``); only rank 0 prints and writes the checkpoints and the loss
CSV.
"""
from __future__ import annotations

import csv
import pathlib
import time

import numpy as np
import torch

from .._device import resolve_device
from ..models import ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet, init_params as init_net
from ..models.checkpoint import params_to_jax, save_params
from ..pmp.predict import strict_fp32
from .trainer import (Adam, make_bd_train_step, make_q_train_step, make_qbd_train_step,
                      shard_batch, step_decay_schedule)


def load_npy_split(data_dir, split, comp="Luma", qp=32):
    """One split as float32 NCHW arrays: x (N,1,68,68) for luma or
    (N,3,34,34) for chroma (2x2-pooled Y, U, V), qt (N,1,8,8) minus 1,
    bt and dire (N,3,16,16)."""
    d = pathlib.Path(data_dir)
    if comp == "Chroma":
        x = np.load(d / f"{split}_Chroma_Block34.npy").astype(np.float32) \
            .transpose(0, 3, 1, 2)
    else:
        x = np.load(d / f"{split}_Y_Block68.npy").astype(np.float32)[:, None]
    qt = np.load(d / f"{split}_{comp}_QP{qp}_QTdepth_Block8.npy") \
        .astype(np.float32) - 1.0
    bt = np.load(d / f"{split}_{comp}_QP{qp}_MSBTdepth_Block16.npy") \
        .astype(np.float32)
    dire = np.load(d / f"{split}_{comp}_QP{qp}_MSdirection_Block16.npy") \
        .astype(np.float32)
    return np.ascontiguousarray(x), qt[:, None], bt, dire


def synth_dataset(n, seed=0):
    """Learnable toy set (NCHW): QT depth follows local 8x8 variance
    quantiles, MTT depth follows 4x4 variance, direction follows the sign of
    the horizontal-vs-vertical gradient-energy difference. The same numbers
    as the JAX package's for the same seed."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 255, (n, 9, 9)).astype(np.float32)
    x = np.stack([np.kron(b, np.ones((8, 8)))[:68, :68] for b in base])
    x += rng.randn(n, 68, 68).astype(np.float32) * \
        rng.uniform(0, 24, (n, 1, 1)).astype(np.float32)
    core = x[:, 4:68, 4:68]
    v8 = core.reshape(n, 8, 8, 8, 8).std(axis=(3, 4))
    qt = np.digitize(v8, [8, 16]).astype(np.float32)        # 0..2
    v4 = core.reshape(n, 16, 4, 16, 4).std(axis=(2, 4))
    bt1 = (v4 > 12).astype(np.float32)
    gy = np.abs(np.diff(core, axis=1)).reshape(n, -1, 16, 4).mean((1, 3))
    gx = np.abs(np.diff(core, axis=2)).reshape(n, 16, 4, -1).mean((2, 3))
    dire1 = np.sign(gy[:, :, None] - gx[:, None, :]).astype(np.float32)
    bt = np.stack([bt1, bt1, bt1], axis=1)
    dire = np.stack([dire1 * bt1, dire1 * bt1, dire1 * bt1], axis=1)
    return x[:, None], qt[:, None], bt, dire


def rounded_accuracy(pred, label):
    """Share of positions whose ROUNDED prediction equals the label."""
    return float(np.mean(np.round(np.asarray(pred)) == np.asarray(label)))


@torch.inference_mode()
def validate(q_net, bd_net, data, batch=256, label_qt_input=False):
    """Per-head rounded accuracy over an (x, qt, bt, dire) split on the nets'
    device. ``label_qt_input=True`` feeds the ground-truth QT labels to the
    MTT net (as the stage-"bd" step trains it) instead of the QT net's
    output; the qt row is then left out."""
    x, qt, bt, dire = data
    dev = next(bd_net.parameters()).device
    accs = {"qt": [], "bt0": [], "bt1": [], "bt2": [],
            "dir0": [], "dir1": [], "dir2": []}
    if label_qt_input:
        del accs["qt"]
    for i in range(0, len(x), batch):
        xb = torch.from_numpy(np.ascontiguousarray(x[i:i + batch], np.float32)).to(dev)
        n = xb.shape[0]
        if label_qt_input:
            outs = bd_net(xb, torch.from_numpy(np.ascontiguousarray(qt[i:i + n],
                                                                    np.float32)).to(dev))
        else:
            qt_out = q_net(xb)
            outs = bd_net(xb, qt_out)
            accs["qt"].append(rounded_accuracy(qt_out.cpu().numpy(), qt[i:i + n]))
        for k, bd in enumerate(outs):
            bd = bd.cpu().numpy()
            accs[f"bt{k}"].append(rounded_accuracy(bd[:, 0], bt[i:i + n, k]))
            accs[f"dir{k}"].append(rounded_accuracy(bd[:, 1], dire[i:i + n, k]))
    return {k: float(np.mean(v)) for k, v in accs.items()}


def _tree(stage, q_net, bd_net):
    if stage == "q":
        return params_to_jax(q_net.state_dict())
    if stage == "bd":
        return params_to_jax(bd_net.state_dict())
    return {"q": params_to_jax(q_net.state_dict()), "bd": params_to_jax(bd_net.state_dict())}


def train(stage, train_data, val_data, *, qp=32, is_luma=True, epochs=20,
          lr=1e-3, decay_every=10, batch=64, ckpt_dir=None, ckpt_every=10,
          log_path=None, init_params=None, seed=0, device=None, mesh=None,
          print_fn=print):
    """Run one training stage ("q" | "bd" | "qbd") on ``device`` (the card
    unless "cpu" is given; under ``mesh`` the mesh's device); returns
    (params, log rows).

    Adam with the step-halving lr, per-epoch train loss and validation
    accuracies, loss CSV, a checkpoint every ``ckpt_every`` epochs and at
    the end. ``init_params`` is {"q": state dict, "bd": state dict}; without
    it both nets are drawn from flax's initialisation (``init_params`` of
    ``models/checkpoint.py``) with a generator seeded by ``seed``. The
    returned params are the trained net's state dict (stage "q" or "bd") or
    {"q": ..., "bd": ...} (stage "qbd"), on the device.

    ``mesh`` (``trainer.data_mesh``): data-parallel over its ranks, each
    stepping on its block of every batch (``batch`` must split evenly);
    every rank must call ``train`` with the same arguments.
    """
    if mesh is not None and device is None:
        device = mesh.device
    dev = resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    strict_fp32()
    q_net = LumaQNet() if is_luma else ChromaQNet()
    bd_net = LumaMSBDNet() if is_luma else ChromaMSBDNet()
    if init_params is None:
        gen = torch.Generator().manual_seed(seed)
        init_net(q_net, gen)
        init_net(bd_net, gen)
    else:
        q_net.load_state_dict(init_params["q"], strict=True)
        bd_net.load_state_dict(init_params["bd"], strict=True)
    q_net.to(dev)
    bd_net.to(dev)
    if stage == "q":
        opt = Adam(q_net.parameters())
        run = make_q_train_step(q_net, opt, mesh=mesh)
    elif stage == "bd":
        opt = Adam(bd_net.parameters())
        run = make_bd_train_step(bd_net, opt, qp=qp, is_luma=is_luma, mesh=mesh)
    elif stage == "qbd":
        opt = Adam(list(q_net.parameters()) + list(bd_net.parameters()))
        run = make_qbd_train_step(q_net, bd_net, opt, qp=qp, is_luma=is_luma, mesh=mesh)
    else:
        raise ValueError(f"unknown stage {stage!r}")
    x, qt, bt, dire = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                       for a in train_data)
    sched = step_decay_schedule(lr, decay_every)
    n = len(x)
    rng = np.random.RandomState(seed)
    log_rows = []
    for epoch in range(epochs):
        cur_lr = sched(epoch)
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        t0 = time.time()
        for i in range(0, n - batch + 1, batch):
            sl = perm[i:i + batch]
            if mesh is not None:
                sl = shard_batch(mesh, sl)
            if stage == "q":
                losses.append(run(x[sl], qt[sl], cur_lr))
            else:
                losses.append(run(x[sl], qt[sl], bt[sl], dire[sl], cur_lr))
        step_losses = torch.stack(losses).cpu().numpy().astype(np.float64) if losses \
            else np.array([np.nan])
        row = {"epoch": epoch, "lr": cur_lr,
               "train_loss": float(np.mean(step_losses)),
               "time_s": round(time.time() - t0, 2)}
        if val_data is not None and stage == "bd":
            row.update(validate(q_net, bd_net, val_data, label_qt_input=True))
        elif val_data is not None and stage == "qbd":
            row.update(validate(q_net, bd_net, val_data))
        elif val_data is not None:
            row["qt"] = validate(q_net, bd_net, val_data)["qt"]
        log_rows.append(row)
        if writer:
            print_fn(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                              f"{k}={v}" for k, v in row.items()))
        if writer and ckpt_dir and (epoch + 1) % ckpt_every == 0:
            save_params(pathlib.Path(ckpt_dir) / f"{stage}_epoch{epoch + 1}.msgpack",
                        _tree(stage, q_net, bd_net))
    if writer and log_path:
        keys = sorted({k for r in log_rows for k in r})
        with open(log_path, "w", newline="") as f:
            wcsv = csv.DictWriter(f, fieldnames=keys)
            wcsv.writeheader()
            wcsv.writerows(log_rows)
    if writer and ckpt_dir:
        save_params(pathlib.Path(ckpt_dir) / f"{stage}_final.msgpack",
                    _tree(stage, q_net, bd_net))
    params = {"q": q_net.state_dict(), "bd": bd_net.state_dict()}
    return (params[stage] if stage != "qbd" else params), log_rows
