"""Dataset generation from the port's device RDO decisions.

Counterpart of the JAX package's ``tools/gen_dataset.py``: frames go through
the batched open-loop QTMT search on the card (``codec/rdo_device.py``),
each 64x64 block's tree is rebuilt from the chosen leaves, its (QT-depth,
3-layer MTT-depth, 3-layer direction) labels derived, and the reference
``.npy`` layout written, which ``train/driver.load_npy_split`` reads.

All QPs are labelled in one pass (the mode search is shared across the QP
points on the device). The default content is the natural-statistics
generator (``data/synthcontent.py``).

  python -m pmp_vvc_tpu_torch.tools.gen_dataset --out corpus --frames 160 \\
      --width 512 --height 512 --qps 22,27,32,37 --split Train

Use --input seq.yuv for real content; --device cpu to run the search's
plain versions on the CPU; --chroma to label the dual-tree chroma channel
(the same seeds give the same frames as the luma pass).
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

from ..codec.headers import VVCConfig
from ..codec.rdo_device import DeviceRDO
from ..codec.wavefront import WavefrontEncoder, _collect_leaves_chroma
from ..data.labels import labels_from_tree, tree_from_leaves
from ..data.synthcontent import natural_frame
from ..data.yuv import blocks_for_sequence, read_yuv420


def synth_frame(w, h, seed):
    """Sinusoid field (kept for comparison experiments)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    fx, fy = rng.uniform(8, 40, 2)
    amp = rng.uniform(20, 80)
    y8 = np.clip(128 + amp * np.sin(xx / fx) * np.cos(yy / fy)
                 + rng.randn(h, w) * rng.uniform(2, 12), 0, 255)
    u8 = 128 + 40 * np.sin(xx[::2, ::2] / (fx * 2))
    v8 = 128 + 40 * np.cos(yy[::2, ::2] / (fy * 2))
    return (y8.astype(np.int32) << 2, u8.astype(np.int32) << 2,
            v8.astype(np.int32) << 2)


def label_config(w, h, qp, chroma):
    """The label search's encoder configuration at ``qp``: the bench's
    chroma QP table, 8x8 minimum CUs, MTT depth 3, BT/TT 32, no deblocking;
    with ``chroma`` the dual tree with CCLM."""
    return VVCConfig(
        width=w, height=h, qp=qp, deblocking_disabled=True,
        chroma_qp_start_minus26=-9,
        chroma_qp_points=((9, 12), (4, 5), (11, 7)),
        log2_min_cb=3, max_mtt_depth_intra=3,
        max_bt_intra=32, max_tt_intra=32,
        dual_tree=chroma, cclm=chroma)


def frame_labels(enc, decide, chroma, w, h):
    """(qt8, msbt, msdire) of every 64x64 block of one frame, in raster
    order, from the tree ``decide`` chose."""
    raw = _collect_leaves_chroma(enc, decide) if chroma else enc._collect_leaves(decide)
    leaves = [lf[:4] for lf in raw]
    return [labels_from_tree(tree_from_leaves(leaves, bx, by))
            for by in range(0, h, 64) for bx in range(0, w, 64)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--content", default="natural",
                    choices=["natural", "sinusoid"])
    ap.add_argument("--input", default=None,
                    help="YUV420 8-bit input instead of synthetic")
    ap.add_argument("--split", default="Train",
                    help="output split prefix (Train/Validate/TestSub)")
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--group", type=int, default=4,
                    help="frames per device batch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--save-every", type=int, default=8,
                    help="checkpoint the .npy files every N groups")
    ap.add_argument("--chroma", action="store_true",
                    help="label the dual-tree CHROMA channel instead "
                         "(DeviceRDO.search_frames_chroma; same seeds "
                         "=> same frames as the luma pass)")
    args = ap.parse_args(argv)

    w, h = args.width, args.height
    qps = [int(q) for q in args.qps.split(",")]
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def frame(i):
        if args.input:
            y, u, v = (p[i].astype(np.int32) << 2 for p in
                       read_yuv420(args.input, w, h, i + 1))
            return y, u, v
        if args.content == "natural":
            return natural_frame(w, h, seed=args.seed0 + i)
        return synth_frame(w, h, seed=args.seed0 + i)

    encs = [WavefrontEncoder(label_config(w, h, qp, args.chroma), device=args.device)
            for qp in qps]
    rdo = DeviceRDO(encs[0])
    xs, cxs = [], []
    labels = {qp: ([], [], []) for qp in qps}   # qt, bt, dire

    comp = "Chroma" if args.chroma else "Luma"

    def save_all():
        pre = args.split
        np.save(out / f"{pre}_Y_Block68.npy",
                np.asarray(xs, np.float32).reshape(len(xs), 68, 68))
        np.save(out / f"{pre}_Chroma_Block34.npy",
                np.asarray(cxs, np.float32))
        for qp in qps:
            qt, bt, dire = labels[qp]
            np.save(out / f"{pre}_{comp}_QP{qp}_QTdepth_Block8.npy",
                    np.asarray(qt, np.uint8))
            np.save(out / f"{pre}_{comp}_QP{qp}_MSBTdepth_Block16.npy",
                    np.asarray(bt, np.uint8))
            np.save(out / f"{pre}_{comp}_QP{qp}_MSdirection_Block16.npy",
                    np.asarray(dire, np.int8))

    t_start = time.time()
    for g0 in range(0, args.frames, args.group):
        gn = min(args.group, args.frames - g0)
        frames = [frame(g0 + i) for i in range(gn)]
        t0 = time.time()
        if args.chroma:
            decides = rdo.search_frames_chroma(frames, encoders=encs)
        else:
            decides = rdo.search_frames(frames, encoders=encs)
        t_rdo = time.time() - t0
        for i, (y, u, v) in enumerate(frames):
            lin, cin = blocks_for_sequence(
                (y >> 2).astype(np.uint8)[None],
                (u >> 2).astype(np.uint8)[None],
                (v >> 2).astype(np.uint8)[None])
            xs.extend(lin[..., 0])
            cxs.extend(cin)
            for qi, qp in enumerate(qps):
                for qt8, msbt, msdire in frame_labels(encs[qi], decides[qi][i],
                                                      args.chroma, w, h):
                    labels[qp][0].append(qt8)
                    labels[qp][1].append(msbt)
                    labels[qp][2].append(msdire)
        done = g0 + gn
        rate = len(xs) * len(qps) / (time.time() - t_start)
        print(f"frames {done}/{args.frames}: rdo {t_rdo:.1f}s, "
              f"{len(xs)} blocks, {rate:.1f} labels/s", file=sys.stderr,
              flush=True)
        if (g0 // args.group + 1) % args.save_every == 0:
            save_all()
    save_all()
    print(f"wrote {len(xs)} samples x {len(qps)} QPs to {out} "
          f"in {time.time()-t_start:.0f}s")


if __name__ == "__main__":
    main()
