"""Train the Q+BD (QT + MTT depth/direction) nets of each component and QP
on the card.

Counterpart of the JAX package's ``tools/train_bd.py``: pretrain the BD net
with the ground-truth QT input (stage "bd"), then fine-tune Q and BD jointly
(stage "qbd") from a trained Q net, and save per-QP msgpack checkpoints that
``pmp/predict.CompPredictor.from_trained`` loads:

  python -m pmp_vvc_tpu_torch.tools.train_bd --data corpus --out ckpts \\
      --qps 22,27,32,37 --comps Luma,Chroma

The joint stage's Q init is the committed ``trained_models/bd/
{comp}_Q_QP{qp}.msgpack`` (the JAX tool reads the reference's
``{comp}_Q_{qp}.pkl``, which this repository does not hold), so chroma
trains at the QPs whose chroma checkpoints exist (QP 22). ``--device cpu``
runs on the CPU. Under ``torchrun`` (``WORLD_SIZE`` > 1) both stages train
data-parallel over the mesh of all ranks and rank 0 writes.
"""
from __future__ import annotations

import argparse
import pathlib

from ..models.checkpoint import load_trained, params_from_jax, params_to_jax, save_params
from ..parallel import initialize, make_mesh, shutdown
from ..train.driver import load_npy_split, train

Q_INIT_DIR = pathlib.Path(__file__).resolve().parents[2] / "trained_models" / "bd"


def train_component(data, out, comp, qp, *, bd_epochs=60, joint_epochs=30, batch=32,
                    device=None, mesh=None, print_fn=print):
    """The bd stage, then the qbd stage, for one component and QP; writes
    ``{comp}_{Q,BD}_QP{qp}.msgpack`` and both loss CSVs into ``out`` and
    returns (params, bd rows, qbd rows). Under ``mesh`` data-parallel, and
    only rank 0 prints and writes."""
    writer = mesh is None or mesh.rank == 0
    if not writer:
        print_fn = lambda *a: None
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    is_luma = comp == "Luma"
    tag = "" if is_luma else "c"
    tr = load_npy_split(data, "Train", comp, qp)
    va = load_npy_split(data, "Validate", comp, qp)
    print_fn(f"== {comp} QP{qp}: {len(tr[0])} train / {len(va[0])} val CTUs")
    # stage "bd": the BD net from flax's initialisation, with the
    # ground-truth QT input
    bd_params, bd_rows = train(
        "bd", tr, va, qp=qp, is_luma=is_luma, epochs=bd_epochs, lr=1e-3,
        decay_every=20, batch=batch, log_path=str(out / f"bd{tag}_qp{qp}_loss.csv"),
        device=device, mesh=mesh, print_fn=print_fn)
    # stage "qbd": joint, from the trained Q net
    q_init = params_from_jax(load_trained(Q_INIT_DIR / f"{comp}_Q_QP{qp}.msgpack"))
    params, rows = train(
        "qbd", tr, va, qp=qp, is_luma=is_luma, epochs=joint_epochs, lr=2e-4,
        decay_every=10, batch=batch, init_params={"q": q_init, "bd": bd_params},
        log_path=str(out / f"qbd{tag}_qp{qp}_loss.csv"), device=device, mesh=mesh,
        print_fn=print_fn)
    if writer:
        save_params(out / f"{comp}_BD_QP{qp}.msgpack", params_to_jax(params["bd"]))
        save_params(out / f"{comp}_Q_QP{qp}.msgpack", params_to_jax(params["q"]))
    print_fn(f"{comp} QP{qp} final: {rows[-1] if rows else {}}")
    return params, bd_rows, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--comps", default="Luma")
    ap.add_argument("--bd-epochs", type=int, default=60)
    ap.add_argument("--joint-epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    mesh = make_mesh(device=args.device) if initialize(device=args.device) else None
    try:
        for comp in args.comps.split(","):
            for qp in (int(q) for q in args.qps.split(",")):
                train_component(args.data, args.out, comp, qp, bd_epochs=args.bd_epochs,
                                joint_epochs=args.joint_epochs, batch=args.batch,
                                device=args.device, mesh=mesh)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
