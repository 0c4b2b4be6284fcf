"""CLI: encode a YUV sequence to a VVC bitstream, on the card.

The port of the JAX package's ``cli/encode.py`` (the counterpart of the
reference demo flow, codec/demo/README.md): partition maps come either
from the Down-Up-CNN predictors (``--model-dir``: the flax msgpack
checkpoints ``{Luma,Chroma}_{Q,BD}_QP<qp>.msgpack`` of
``trained_models/bd``, read by ``CompPredictor.from_trained``), from a
PartitionMat txt (``--partition-mat``), or a uniform QT depth
(``--qt-depth``). Both engines run on ``--device`` (default: the card):
``sequential`` is ``FrameEncoder`` (the K10 kernels per block; ``--rdo``
runs its RDO split search on every node with no maps, ``--rdo-fallback``
on the nodes the maps defer); ``wavefront`` is ``WavefrontEncoder``. ``--jobs`` > 1 encodes frames in
``spawn``-started worker processes (CUDA does not survive ``fork``).

Usage:
  python -m pmp_vvc_tpu_torch.cli.encode --input seq.yuv --width 192 \
      --height 128 --frames 2 --qp 32 --output out.bin \
      [--model-dir trained_models/bd] [--mtt] [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np


def _encode_frame_job(payload):
    """Worker: encode one frame (AI frames are independent, so the frame
    axis is the natural host-parallel dimension; chips-parallel batching
    happens inside each frame's kernels)."""
    (cfg_dict, mode_select, (y, u, v), poc, map_entry, mtt, stats,
     engine, accel, rdo_fb, rdo, skip_mtt, disturb, device) = payload
    from ..codec.encoder import FrameEncoder
    from ..codec.headers import VVCConfig
    from ..codec.wavefront import WavefrontEncoder
    cfg = VVCConfig(**cfg_dict)
    abl = dict(ablation_skip_mtt=skip_mtt, ablation_disturb=disturb,
               device=device)
    if engine == "wavefront":
        enc = WavefrontEncoder(cfg, accel_level=accel, **abl)
    else:
        enc = FrameEncoder(cfg, mode_select=mode_select,
                           accel_level=accel, rdo_fallback=rdo_fb, **abl)
    kw = dict(poc=poc, collect_bin_stats=stats)
    kind, m = map_entry
    if kind == "maps":
        m, cm = m if isinstance(m, tuple) and len(m) == 2 else (m, None)
        bs, recon = enc.encode_frame(y, u, v, maps=m, chroma_maps=cm,
                                     **kw)
    elif rdo and engine != "wavefront":
        bs, recon = enc.encode_frame(y, u, v, rdo=True, **kw)
    else:
        bs, recon = enc.encode_frame(y, u, v, qt_map=m, **kw)
    return poc, bs, recon, list(enc.leaf_l), enc.bin_stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--cfg", action="append", default=[],
                    help="VTM-style cfg file (repeatable, layered; the "
                         "reference demo stack '-c seq.cfg -c "
                         "encoder_intra_vtm.cfg -q QP' works unchanged)")
    ap.add_argument("-q", dest="qp_short", type=int, default=None,
                    help="QP (VTM-compatible shorthand)")
    ap.add_argument("-b", dest="out_short", default=None,
                    help="bitstream file (VTM-compatible shorthand)")
    ap.add_argument("--input", default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--qp", type=int, default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--is10bit", action="store_true")
    ap.add_argument("--model-dir", default=None,
                    help="{Luma,Chroma}_{Q,BD}_QP<qp>.msgpack checkpoints "
                         "for map prediction (trained_models/bd)")
    ap.add_argument("--partition-mat", default=None,
                    help="PartitionMat txt (reference exchange format)")
    ap.add_argument("--qt-depth", type=int, default=1,
                    help="uniform QT depth if no maps given")
    ap.add_argument("--mtt", action="store_true",
                    help="MTT partitioning (needs maps)")
    ap.add_argument("--mode-select", default="satd",
                    choices=["satd", "rd", "planar"])
    ap.add_argument("--no-deblock", action="store_true",
                    help="disable the deblocking filter")
    ap.add_argument("--sao", action="store_true",
                    help="enable SAO (with per-CTU RD decision)")
    ap.add_argument("--mip", action="store_true",
                    help="matrix intra prediction (SATD-selected per CU)")
    ap.add_argument("--cclm", action="store_true",
                    help="CCLM chroma (single tree only)")
    ap.add_argument("--lfnst", action="store_true",
                    help="low-frequency non-separable transform")
    ap.add_argument("--dep-quant", action="store_true",
                    help="dependent quantization (Viterbi TCQ)")
    ap.add_argument("--sign-hiding", action="store_true",
                    help="sign-data hiding (mutually excl. with dep-quant)")
    ap.add_argument("--mrl", action="store_true",
                    help="multi-reference-line intra (lines 1/2)")
    ap.add_argument("--jccr", action="store_true",
                    help="joint Cb-Cr residual coding")
    ap.add_argument("--isp", action="store_true",
                    help="intra sub-partitions (HOR/VER RD trial per CU)")
    ap.add_argument("--lmcs", action="store_true",
                    help="luma mapping with chroma scaling (AI dQP model)")
    ap.add_argument("--no-crs", action="store_true",
                    help="disable LMCS chroma residual scaling")
    ap.add_argument("--alf", action="store_true",
                    help="adaptive loop filter (fixed + per-frame APS)")
    ap.add_argument("--ccalf", action="store_true",
                    help="cross-component ALF (implies --alf)")
    ap.add_argument("--recon", default=None, help="write recon YUV here")
    ap.add_argument("--paint-partition", default=None,
                    help="write recon YUV with CU edges painted (debug)")
    ap.add_argument("--bit-stats", action="store_true",
                    help="print per-syntax-class bin statistics")
    ap.add_argument("--ctc-chroma-qp", action="store_true",
                    help="CTC AI chroma QP mapping table (QP32 -> 34)")
    ap.add_argument("--accel-level", type=int, default=3,
                    choices=[0, 1, 2, 3],
                    help="map-acceleration level L0-L3 (reference "
                         "Acceleration_Config_fal; L0 = map drives QT "
                         "force/ban + all MTT, L1-L3 = map gates MTT "
                         "levels < L only)")
    ap.add_argument("--rdo-fallback", action="store_true",
                    help="bounded RDO split search outside the map gate "
                         "(EncModeCtrl.cpp:1455 stock fallback role)")
    ap.add_argument("--rdo", action="store_true",
                    help="stock full RDO partitioning (no maps)")
    ap.add_argument("--skip-mtt", action="store_true",
                    help="ablation: reject every BT/TT split "
                         "(Skip_Partition_Mode_fal, EncModeCtrl"
                         ".cpp:1973)")
    ap.add_argument("--disturb", default=None,
                    help="ablation: force ONE decision off, "
                         "'x,y,w,h,SPLIT' (Context_Disturb_fal, "
                         "EncModeCtrl.cpp:1962)")
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "wavefront"],
                    help="sequential = FrameEncoder (every tool); "
                         "wavefront = batched device CU coding (no MRL, "
                         "ISP or dependent quantization)")
    ap.add_argument("--device", default=None,
                    help="where the kernels run (default: the card; 'cpu' "
                         "runs their plain versions)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="frame-parallel worker processes (AI frames are "
                         "independent)")
    args = ap.parse_args(argv)

    vtm_cfg_kwargs = None
    if args.cfg:
        from ..utils.vtmcfg import merge_cfgs, to_encoder_args
        io, vtm_cfg_kwargs, warns = to_encoder_args(merge_cfgs(args.cfg))
        for wmsg in warns:
            print(f"warning: {wmsg}", file=sys.stderr)
        args.input = args.input or io["input"]
        args.width = args.width or io["width"]
        args.height = args.height or io["height"]
        if args.frames is None:
            args.frames = io["frames"]
        args.output = args.output or io["output"]
        args.is10bit = args.is10bit or io["is10bit"]
        if args.qp_short is not None:
            vtm_cfg_kwargs["qp"] = args.qp_short
        if args.qp is not None:
            vtm_cfg_kwargs["qp"] = args.qp
        args.qp = vtm_cfg_kwargs["qp"]
    if args.out_short:
        args.output = args.out_short
    if args.qp_short is not None and args.qp is None:
        args.qp = args.qp_short
    args.qp = 32 if args.qp is None else args.qp
    args.frames = 1 if args.frames is None else args.frames
    for req in ("input", "width", "height", "output"):
        if getattr(args, req) in (None,):
            ap.error(f"--{req} required (directly or via -c cfg files)")

    from ..codec.headers import VVCConfig
    from ..codec.partition import read_partition_txt
    from ..data.yuv import read_yuv420

    w, h = args.width, args.height
    y, u, v = read_yuv420(args.input, w, h, args.frames,
                          is10bit=args.is10bit)
    if not args.is10bit:
        y, u, v = (p.astype(np.int32) << 2 for p in (y, u, v))

    maps_per_frame = None
    if args.partition_mat:
        maps_per_frame = read_partition_txt(args.partition_mat, h, w)
    elif args.model_dir:
        from ..pmp.predict import CompPredictor
        from ..pmp.map2partition import blocks_to_frame_partition
        from ..data.yuv import blocks_for_sequence

        def _mk_pred(comp):
            """Q-net and BD-net of one component at this QP from the
            flax msgpack checkpoints of ``--model-dir``."""
            d = pathlib.Path(args.model_dir)
            q, bd = (d / f"{comp}_{net}_QP{args.qp}.msgpack" for net in ("Q", "BD"))
            for f in (q, bd):
                if not f.exists():
                    raise FileNotFoundError(f"--model-dir: no checkpoint {f}")
            return CompPredictor.from_trained(comp == "Luma", q, bd,
                                              device=args.device)

        ins = blocks_for_sequence(
            (np.asarray(y) >> 2).astype(np.uint8),
            (np.asarray(u) >> 2).astype(np.uint8),
            (np.asarray(v) >> 2).astype(np.uint8))
        per = (w // 64) * (h // 64)
        comp_maps = {}
        for comp, blocks in (("Luma", ins[0]), ("Chroma", ins[1])):
            qt, bt, dire = _mk_pred(comp).predict(blocks)
            comp_maps[comp] = [
                blocks_to_frame_partition(
                    qt[f * per:(f + 1) * per], bt[f * per:(f + 1) * per],
                    dire[f * per:(f + 1) * per], w, h, comp == "Luma")
                for f in range(y.shape[0])]
        maps_per_frame = comp_maps["Luma"]
        chroma_maps_per_frame = comp_maps["Chroma"]

    filt = dict(deblocking_disabled=args.no_deblock, sao=args.sao,
                mip=args.mip, cclm=args.cclm, lfnst=args.lfnst,
                dep_quant=args.dep_quant, sign_hiding=args.sign_hiding,
                mrl=args.mrl,
                joint_cbcr=args.jccr, isp=args.isp, lmcs=args.lmcs,
                lmcs_chroma_scaling=args.lmcs and not args.no_crs,
                alf=args.alf or args.ccalf,
                alf_chroma=args.alf or args.ccalf, ccalf=args.ccalf)
    if args.ctc_chroma_qp:
        filt.update(chroma_qp_start_minus26=-9,
                    chroma_qp_points=((9, 12), (4, 5), (11, 7)))
    if vtm_cfg_kwargs is not None:
        cfg = VVCConfig(width=w, height=h, **vtm_cfg_kwargs)
    elif args.mtt:
        cfg = VVCConfig(width=w, height=h, qp=args.qp, log2_min_cb=3,
                        max_mtt_depth_intra=3, max_bt_intra=32,
                        max_tt_intra=32, **filt)
    else:
        cfg = VVCConfig(width=w, height=h, qp=args.qp, **filt)

    out = bytearray()
    recons = []
    leafs = []
    stats = []
    t0 = time.time()
    import dataclasses
    cfg_dict = dataclasses.asdict(cfg)
    disturb = None
    if args.disturb:
        from ..codec.mtt import Split
        dx, dy, dw, dh, ds = args.disturb.split(",")
        disturb = (int(dx), int(dy), int(dw), int(dh), Split[ds])
    payloads = []
    cmaps = locals().get("chroma_maps_per_frame")
    for f in range(y.shape[0]):
        if maps_per_frame is not None:
            m = maps_per_frame[min(f, len(maps_per_frame) - 1)]
            if args.mtt and cmaps is not None and cfg.dual_tree:
                entry = ("maps", (m, cmaps[min(f, len(cmaps) - 1)]))
            elif args.mtt:
                entry = ("maps", m)
            else:
                entry = ("qt", m[2])
        else:
            entry = ("qt", np.full((h // 8, w // 8), args.qt_depth,
                                   np.int32))
        payloads.append((cfg_dict, args.mode_select,
                         (y[f], u[f], v[f]), f, entry, args.mtt,
                         args.bit_stats, args.engine, args.accel_level,
                         args.rdo_fallback, args.rdo, args.skip_mtt,
                         disturb, args.device))

    if args.jobs > 1 and len(payloads) > 1:
        # AI frames are independent: fan out across processes, started with
        # spawn (a forked child cannot use the parent's CUDA context)
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                max_workers=args.jobs,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(_encode_frame_job, payloads))
    else:
        results = [_encode_frame_job(p) for p in payloads]

    from ..utils.visualize import frame_summary
    for f, bs, recon, leaf_l, bstats in results:
        if args.bit_stats and bstats:
            from ..utils.stats import print_bin_stats
            print(f"-- POC {f} bin statistics:", file=sys.stderr)
            print_bin_stats(bstats)
        out += bs
        recons.append(recon)
        leafs.append(leaf_l)
        stats.append(frame_summary((y[f], u[f], v[f]), recon, len(bs) * 8))
        print(f"POC {f}: {len(bs)} bytes  "
              f"({time.time() - t0:.1f}s elapsed)", file=sys.stderr)

    pathlib.Path(args.output).write_bytes(bytes(out))
    if args.recon:
        with open(args.recon, "wb") as fp:
            for ry, ru, rv in recons:
                fp.write(ry.astype(np.uint16).tobytes())
                fp.write(ru.astype(np.uint16).tobytes())
                fp.write(rv.astype(np.uint16).tobytes())
    if args.paint_partition:
        from ..utils.visualize import paint_partition
        with open(args.paint_partition, "wb") as fp:
            for (ry, ru, rv), cus in zip(recons, leafs):
                fp.write(paint_partition(ry, cus).astype(np.uint16)
                         .tobytes())
                fp.write(ru.astype(np.uint16).tobytes())
                fp.write(rv.astype(np.uint16).tobytes())
    from ..utils.visualize import frame_summary, print_summary
    print_summary(stats)
    print(f"wrote {len(out)} bytes to {args.output}")


if __name__ == "__main__":
    main()
