"""CLI: train the Down-Up-CNN partition predictors on the card.

Counterpart of ``pmp_vvc_tpu/cli/train.py``: three stages (--stage q | bd |
qbd), the reference .npy dataset layout (--data-dir) or a built-in learnable
synthetic set (--synth N), step-halving lr, per-epoch validation rounded
accuracy per output head, loss CSV, checkpoints (flax msgpack, which both
packages read).

  python -m pmp_vvc_tpu_torch.cli.train --stage q --synth 2048 --epochs 20 \\
      --ckpt-dir ckpts --log loss.csv

``--init`` takes a checkpoint holding {"q": ..., "bd": ...} (a stage-"qbd"
checkpoint) to start from; ``--device cpu`` runs on the CPU.

Under ``torchrun`` (``WORLD_SIZE`` > 1) every process trains data-parallel
on its block of each batch over the mesh of all ranks, one card each (the
JAX driver shards over every device it sees); rank 0 writes:

  torchrun --nproc-per-node 4 -m pmp_vvc_tpu_torch.cli.train --stage qbd ...
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default="q", choices=["q", "bd", "qbd"])
    ap.add_argument("--data-dir", default=None,
                    help="reference .npy dataset directory")
    ap.add_argument("--synth", type=int, default=0,
                    help="use N synthetic training samples instead")
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--chroma", action="store_true")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--decay-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log", default=None, help="loss CSV path")
    ap.add_argument("--init", default=None,
                    help="msgpack params {q, bd} to fine-tune from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..models.checkpoint import load_trained, params_from_jax
    from ..parallel import initialize, make_mesh, shutdown
    from ..train.driver import load_npy_split, synth_dataset, train

    if args.synth:
        train_data = synth_dataset(args.synth, seed=args.seed)
        val_data = synth_dataset(max(args.synth // 8, 64), seed=args.seed + 1)
    elif args.data_dir:
        comp = "Chroma" if args.chroma else "Luma"
        train_data = load_npy_split(args.data_dir, "Train", comp, args.qp)
        val_data = load_npy_split(args.data_dir, "Validate", comp, args.qp)
    else:
        ap.error("need --data-dir or --synth")
    init = None
    if args.init:
        tree = load_trained(args.init)
        if set(tree) != {"q", "bd"}:
            ap.error(f"--init {args.init} does not hold q and bd params")
        init = {k: params_from_jax(v) for k, v in tree.items()}

    mesh = make_mesh(device=args.device) if initialize(device=args.device) else None
    try:
        train(args.stage, train_data, val_data, qp=args.qp,
              is_luma=not args.chroma, epochs=args.epochs, lr=args.lr,
              decay_every=args.decay_every, batch=args.batch,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              log_path=args.log, init_params=init, seed=args.seed,
              device=args.device, mesh=mesh)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
