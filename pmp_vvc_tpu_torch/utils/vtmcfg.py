"""VTM-compatible config-file front end (program_options_lite
counterpart, Lib/Utilities/program_options_lite.cpp): parse layered
``Key : value  # comment`` cfg files so the reference demo command line
(`-c seq.cfg -c encoder_intra_vtm.cfg -q 32`, codec/demo/README.md:10)
drives our encoder unchanged.

``to_encoder_args(opts)`` maps the merged option dict onto our
``VVCConfig`` + CLI semantics.  Unknown keys are collected, not fatal
(the CTC cfg is full of inter/rate-control keys dead in AI); keys whose
non-default value we cannot honour yet are reported as warnings.
"""
from __future__ import annotations

import pathlib


def parse_cfg_file(path) -> dict:
    opts = {}
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        key, val = line.split(":", 1)
        opts[key.strip()] = val.strip()
    return opts


def merge_cfgs(paths, overrides=None) -> dict:
    """Later files / overrides win (program_options_lite layering)."""
    opts = {}
    for p in paths:
        opts.update(parse_cfg_file(p))
    opts.update(overrides or {})
    return opts


def _b(opts, key, default="0"):
    # a key with an empty value ("Key :") is legal program_options_lite
    # input; treat it as unset/false
    toks = opts.get(key, default).split()
    return bool(toks) and toks[0] not in ("0", "false", "")


def _i(opts, key, default=None):
    v = opts.get(key)
    return int(v.split()[0]) if v is not None else default


def to_encoder_args(opts: dict):
    """(io_dict, cfg_kwargs, warnings) from merged VTM options.

    io_dict: input/output/frames/bit-depth driving the CLI;
    cfg_kwargs: VVCConfig constructor arguments.
    """
    warn = []
    io = {
        "input": opts.get("InputFile"),
        "output": opts.get("BitstreamFile", "str.bin"),
        "width": _i(opts, "SourceWidth"),
        "height": _i(opts, "SourceHeight"),
        "frames": _i(opts, "FramesToBeEncoded", 1),
        "is10bit": _i(opts, "InputBitDepth", 8) == 10,
        "subsample": _i(opts, "TemporalSubsampleRatio", 1),
    }
    cfg = {
        "qp": _i(opts, "QP", 32),
        "bit_depth": _i(opts, "InternalBitDepth", 10),
        "ctu_size": _i(opts, "CTUSize", 128),
        "dual_tree": _b(opts, "DualITree"),
        "min_qt_intra": _i(opts, "MinQTLumaISlice",
                           _i(opts, "MinQTISlice", 8)),
        "max_mtt_depth_intra": _i(opts, "MaxMTTHierarchyDepthISliceL",
                                  _i(opts, "MaxMTTHierarchyDepth", 0)),
        "mts_intra": _b(opts, "MTS"),
        "lfnst": _b(opts, "LFNST"),
        "isp": _b(opts, "ISP"),
        "mip": _b(opts, "MIP", "1"),
        "mrl": _b(opts, "MRL", "1"),
        "cclm": _b(opts, "LMChroma"),
        "joint_cbcr": _b(opts, "JointCbCr", "1"),
        "dep_quant": _b(opts, "DepQuant"),
        "sign_hiding": _b(opts, "SignHideFlag"),
        "sao": _b(opts, "SAO"),
        "alf": _b(opts, "ALF"),
        "alf_chroma": _b(opts, "ALF"),
        "ccalf": _b(opts, "CCALF", opts.get("ALF", "0")),
        "lmcs": _b(opts, "LMCSEnable"),
        "lmcs_chroma_scaling": _b(opts, "LMCSEnable"),
        "deblocking_disabled": _b(opts, "LoopFilterDisable"),
        "chroma_qp_offset": _i(opts, "CbQpOffset", 0),
    }
    if cfg["max_mtt_depth_intra"]:
        cfg["max_bt_intra"] = _i(opts, "MaxBTLumaISlice", 32)
        cfg["max_tt_intra"] = _i(opts, "MaxTTLumaISlice", 32)
        cfg["log2_min_cb"] = 3 if cfg["min_qt_intra"] >= 8 else 2
    if cfg["dual_tree"]:
        cfg["chroma_min_qt"] = _i(
            opts, "MinQTChromaISliceInChromaSamples", 4) * 2
        cfg["chroma_max_mtt_depth"] = _i(
            opts, "MaxMTTHierarchyDepthISliceC",
            cfg["max_mtt_depth_intra"])
        if cfg["chroma_max_mtt_depth"]:
            cfg["chroma_max_bt"] = 32
            cfg["chroma_max_tt"] = 32
    # chroma QP mapping table: QpInValCb/QpOutValCb pivot lists
    if "QpInValCb" in opts and "QpOutValCb" in opts:
        inv = [int(t) for t in opts["QpInValCb"].split()]
        outv = [int(t) for t in opts["QpOutValCb"].split()]
        if len(inv) == len(outv) and len(inv) >= 2:
            # per-point (in_delta_minus1, out_delta): CTC 17/27/32/44 ->
            # 17/29/34/41 = start -9, points (9,12),(4,5),(11,7)
            cfg["chroma_qp_start_minus26"] = inv[0] - 26
            cfg["chroma_qp_points"] = tuple(
                (inv[k] - inv[k - 1] - 1, outv[k] - outv[k - 1])
                for k in range(1, len(inv)))
    if _b(opts, "TransformSkip"):
        cfg["transform_skip"] = True
        cfg["ts_max_log2"] = _i(opts, "TransformSkipLog2MaxSize", 5)
    for key, why in (("IBC", "intra block copy"),
                     ("BDPCM", "BDPCM")):
        if _b(opts, key):
            warn.append(f"{key} requested but not implemented ({why}); "
                        "encoding without it")
    if _b(opts, "SBT") or _b(opts, "Affine"):
        pass    # inter-only keys: dead in all-intra, ignore silently
    return io, cfg, warn
