"""VVC high-level syntax parsing (SPS/PPS/PH/SH/SEI) — HLSyntaxReader
counterpart for the constrained all-intra configuration this framework's
encoder emits (mirror of codec/headers.py; reference VTM-10.0
VLCReader.cpp parseSPS/parsePPS/parsePictureHeader/parseSliceHeader).

Fields whose values the writer cannot produce raise instead of being
silently accepted — the native decoder targets this encoder's
conformance envelope, with the stock VTM decoder as the oracle for the
rest.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader
from .headers import VVCConfig
from .nalparse import split_nals

NAL_IDR_N_LP = 8
NAL_SPS = 15
NAL_PPS = 16
NAL_PREFIX_APS = 17
NAL_SUFFIX_SEI = 24


def _expect(cond, what):
    if not cond:
        raise NotImplementedError(f"unsupported stream feature: {what}")


def parse_profile_tier_level(br: BitReader, cfg: VVCConfig):
    cfg.profile_idc = br.read(7)
    _expect(br.read(1) == 0, "tier")
    cfg.level_idc = br.read(8)
    br.read_flag()                      # ptl_frame_only_constraint_flag
    br.read_flag()                      # ptl_multilayer_enabled_flag
    _expect(not br.read_flag(), "gci")  # gci_present_flag
    br.byte_align()
    _expect(br.read(8) == 0, "sub profiles")


def parse_sps(rbsp: bytes) -> VVCConfig:
    br = BitReader(rbsp)
    cfg = VVCConfig(width=0, height=0)
    _expect(br.read(4) == 0, "sps id")
    _expect(br.read(4) == 0, "vps id")
    _expect(br.read(3) == 0, "sub layers")
    _expect(br.read(2) == 1, "chroma format != 4:2:0")
    cfg.ctu_size = 1 << (br.read(2) + 5)
    # the CTU loop / SAO / ALF grids in FrameDecoder assume CTU 128
    _expect(cfg.ctu_size == 128, "CTU size != 128")
    _expect(br.read_flag(), "no ptl")
    parse_profile_tier_level(br, cfg)
    br.read_flag()   # sps_gdr_enabled: harmless for an all-IDR stream
                     # (VTM-10 xInitSPS writes 1 regardless of GDR use)
    if br.read_flag():      # sps_ref_pic_resampling (CTC default 1):
        br.read_flag()      # single-resolution AI stream -> harmless;
                            # sps_res_change_in_clvs_allowed_flag
    cfg.width = br.read_uvlc()
    cfg.height = br.read_uvlc()
    _expect(not br.read_flag(), "conformance window")
    _expect(not br.read_flag(), "subpics")
    cfg.bit_depth = br.read_uvlc() + 8
    _expect(not br.read_flag(), "wpp")
    self_entry = br.read_flag()   # sps_entry_point_offsets_present: with
    del self_entry                # one slice/pic no offsets are coded
    cfg.poc_bits = br.read(4) + 4
    _expect(not br.read_flag(), "poc msb")
    _expect(br.read(2) == 0, "extra ph bits")
    _expect(br.read(2) == 0, "extra sh bits")
    cfg.max_dec_pic_buffering = br.read_uvlc() + 1
    cfg.num_reorder_pics = br.read_uvlc()
    br.read_uvlc()                      # max_latency_increase_plus1
    cfg.log2_min_cb = br.read_uvlc() + 2
    # sps_partition_constraints_override_enabled (CTC default 1): adds a
    # single always-zero override flag to each picture header
    cfg.partition_override = br.read_flag()
    min_qt_log2 = br.read_uvlc() + cfg.log2_min_cb
    cfg.min_qt_intra = 1 << min_qt_log2
    cfg.max_mtt_depth_intra = br.read_uvlc()
    if cfg.max_mtt_depth_intra != 0:
        cfg.max_bt_intra = 1 << (br.read_uvlc() + min_qt_log2)
        cfg.max_tt_intra = 1 << (br.read_uvlc() + min_qt_log2)
    cfg.dual_tree = br.read_flag()
    if cfg.dual_tree:
        cmin_qt_log2 = br.read_uvlc() + cfg.log2_min_cb
        cfg.chroma_min_qt = 1 << cmin_qt_log2
        cfg.chroma_max_mtt_depth = br.read_uvlc()
        if cfg.chroma_max_mtt_depth != 0:
            cfg.chroma_max_bt = 1 << (br.read_uvlc() + cmin_qt_log2)
            cfg.chroma_max_tt = 1 << (br.read_uvlc() + cmin_qt_log2)
    br.read_uvlc()                      # inter minQT
    if br.read_uvlc():                  # inter (B/P) MTT depth: unused in
        br.read_uvlc()                  # an all-intra stream; skip the
        br.read_uvlc()                  # max BT / max TT size deltas
    if cfg.ctu_size > 32:
        cfg.log2_max_tb = 6 if br.read_flag() else 5
    cfg.transform_skip = br.read_flag()
    if cfg.transform_skip:
        cfg.ts_max_log2 = br.read_uvlc() + 2
        cfg.bdpcm = bool(br.read_flag())
    cfg.mts_intra = br.read_flag()
    if cfg.mts_intra:
        _expect(br.read_flag(), "implicit MTS")
        _expect(not br.read_flag(), "inter MTS")
    cfg.lfnst = br.read_flag()
    cfg.joint_cbcr = br.read_flag()
    _expect(br.read_flag(), "per-component chroma QP tables")
    cfg.chroma_qp_start_minus26 = br.read_svlc()
    n_pts = br.read_uvlc() + 1
    pts = []
    for _ in range(n_pts):
        di = br.read_uvlc()
        do = br.read_uvlc() ^ di
        pts.append((di, do))
    cfg.chroma_qp_points = tuple(pts)
    cfg.sao = br.read_flag()
    cfg.alf = br.read_flag()
    if cfg.alf:
        cfg.ccalf = br.read_flag()
    cfg.lmcs = br.read_flag()
    _expect(not br.read_flag(), "weighted pred")
    _expect(not br.read_flag(), "weighted bipred")
    _expect(not br.read_flag(), "long term ref pics")
    _expect(not br.read_flag(), "idr rpl")
    rpl1_same = br.read_flag()          # rpl1_same_as_rpl0_flag

    def _skip_rpl():
        # ref_pic_list_struct with long-term and inter-layer ref pics
        # off: per entry abs_delta_poc_st + sign — unused by an all-intra
        # decode, skipped for stock-VTM streams.  VLCReader.cpp:378-391
        # increments the raw value when weighted pred is off (always in
        # this envelope) or i == 0, so the sign flag is always present.
        for _ in range(br.read_uvlc()):
            br.read_uvlc()
            br.read_flag()

    for _ in range(br.read_uvlc()):     # sps_num_ref_pic_lists[0]
        _skip_rpl()
    if not rpl1_same:
        for _ in range(br.read_uvlc()):  # sps_num_ref_pic_lists[1]
            _skip_rpl()
    # inter-only tool flags: dead in an all-intra stream (the PH keeps
    # ph_inter_slice_allowed 0), so accept them and skip their
    # subfields (VLCReader.cpp sps_temporal_mvp.. block)
    _expect(not br.read_flag(), "wraparound")
    if br.read_flag():                  # sps_temporal_mvp_enabled_flag
        br.read_flag()                  # sps_sbtmvp_enabled_flag
    amvr = br.read_flag()               # sps_amvr_enabled_flag
    if br.read_flag():                  # sps_bdof_enabled_flag
        br.read_flag()                  # sps_bdof_pic_present_flag
    br.read_flag()                      # sps_smvd_enabled_flag
    if br.read_flag():                  # sps_dmvr_enabled_flag
        br.read_flag()                  # sps_dmvr_pic_present_flag
    if br.read_flag():                  # sps_mmvd_enabled_flag
        br.read_flag()                  # sps_mmvd_fullpel_only_flag
    max_merge = 6 - br.read_uvlc()      # six_minus_max_num_merge_cand
    br.read_flag()                      # sps_sbt_enabled_flag
    if br.read_flag():                  # sps_affine_enabled_flag
        br.read_uvlc()                  # five_minus_max_num_subblock_mc
        br.read_flag()                  # sps_affine_type_flag
        if amvr:
            br.read_flag()              # sps_affine_amvr_enabled_flag
        if br.read_flag():              # sps_affine_prof_enabled_flag
            br.read_flag()              # sps_prof_pic_present_flag
    br.read_flag()                      # sps_bcw_enabled_flag
    br.read_flag()                      # sps_ciip_enabled_flag
    if max_merge >= 2:
        if br.read_flag():              # sps_gpm_enabled_flag
            if max_merge >= 3:
                br.read_uvlc()          # max_num_merge_cand_minus_gpm
    br.read_uvlc()                      # log2_parallel_merge_level_minus2
    cfg.isp = br.read_flag()
    cfg.mrl = br.read_flag()
    cfg.mip = br.read_flag()
    cfg.cclm = br.read_flag()
    br.read_flag()                      # chroma horizontal collocated
    br.read_flag()                      # chroma vertical collocated
    _expect(not br.read_flag(), "palette")
    if cfg.transform_skip:              # TS||PLT (VLCReader.cpp:2142)
        cfg.internal_minus_input = br.read_uvlc()
    for what in ("ibc", "ladf", "explicit scaling lists"):
        _expect(not br.read_flag(), what)
    cfg.dep_quant = br.read_flag()
    cfg.sign_hiding = br.read_flag()
    _expect(not br.read_flag(), "virtual boundaries")
    _expect(not br.read_flag(), "hrd")
    br.read_flag()                      # field_seq
    _expect(not br.read_flag(), "vui")
    _expect(not br.read_flag(), "sps extension")
    return cfg


def parse_pps(rbsp: bytes, cfg: VVCConfig):
    br = BitReader(rbsp)
    _expect(br.read(6) == 0, "pps id")
    _expect(br.read(4) == 0, "pps sps id")
    br.read_flag()                      # mixed nalu types
    assert br.read_uvlc() == cfg.width and br.read_uvlc() == cfg.height
    _expect(not br.read_flag(), "pps conformance window")
    br.read_flag()                      # scaling window
    br.read_flag()                      # output flag present
    _expect(br.read_flag(), "pic partitioning")   # no_pic_partition = 1
    br.read_flag()                      # subpic id mapping
    br.read_flag()    # pps_cabac_init_present: sh_cabac_init_flag is
                      # only coded for P/B slices — harmless in AI
    br.read_uvlc()
    br.read_uvlc()                      # num_ref_idx defaults
    br.read_flag()                      # rpl1_idx_present
    br.read_flag()
    br.read_flag()                      # weighted pred/bipred
    br.read_flag()                      # wraparound
    cfg.qp = br.read_svlc() + 26
    _expect(not br.read_flag(), "cu qp delta")
    if br.read_flag():                  # chroma tool offsets present
        cfg.chroma_qp_offset = br.read_svlc()
        assert br.read_svlc() == cfg.chroma_qp_offset, "cb/cr offset differ"
        if br.read_flag():              # pps_joint_cbcr_qp_offset_present
            cfg.jccr_qp_offset = br.read_svlc()
        _expect(not br.read_flag(), "slice chroma qp offsets")
        _expect(not br.read_flag(), "cu chroma qp offset list")
    if br.read_flag():                  # deblocking control present
        _expect(not br.read_flag(), "deblock override")
        cfg.deblocking_disabled = br.read_flag()
        if not cfg.deblocking_disabled:
            for _ in range(6):
                assert br.read_svlc() == 0, "deblock beta/tc offsets"
    else:
        # control-present absent => deblocking ENABLED with zero
        # offsets (VVC 7.4.3.4 inference; stock VTM omits the block
        # when no override and all offsets are 0)
        cfg.deblocking_disabled = False
    br.read_flag()                      # ph extension
    br.read_flag()                      # sh extension
    _expect(not br.read_flag(), "pps extension")
    return cfg


@dataclass
class SliceInfo:
    poc: int = 0
    lmcs_enabled: bool = False
    chroma_residual_scale: bool = False
    jccr_sign: bool = False
    alf_enabled: bool = False
    alf_aps_ids: tuple = ()             # slice luma ALF APS ids, in order
    alf_aps_id_chroma: int = -1
    alf_cb: bool = False
    alf_cr: bool = False
    ccalf_cb: bool = False
    ccalf_cr: bool = False
    ccalf_cb_aps_id: int = -1
    ccalf_cr_aps_id: int = -1
    sao_luma: bool = False
    sao_chroma: bool = False
    dep_quant: bool = False
    sign_hiding: bool = False
    slice_data: bytes = b""


def parse_slice_header(rbsp: bytes, cfg: VVCConfig) -> SliceInfo:
    """Mirror of headers.write_slice_header + write_picture_header."""
    br = BitReader(rbsp)
    si = SliceInfo()
    _expect(br.read_flag(), "ph not in slice header")
    # picture header
    _expect(br.read_flag(), "non-irap picture")  # gdr_or_irap
    br.read_flag()                      # non_ref_pic
    _expect(not br.read_flag(), "gdr pic")
    _expect(not br.read_flag(), "inter slices")
    _expect(br.read_uvlc() == 0, "ph pps id")
    si.poc = br.read(cfg.poc_bits)
    # picture_header_structure order (VLCReader.cpp:2776-3445): POC ->
    # [ALF if alf_info_in_ph, absent here] -> LMCS (:2901) -> [scaling
    # lists / virtual boundaries / pic output / RPL, all absent in this
    # envelope] -> partition-constraints override (:3172) -> [cu qp
    # delta/chroma offset subdivs, absent] -> JCCR sign (:3445).
    if cfg.lmcs:
        si.lmcs_enabled = br.read_flag()
        if si.lmcs_enabled:
            _expect(br.read(2) == 0, "lmcs aps id")
            si.chroma_residual_scale = br.read_flag()
    if cfg.partition_override:
        _expect(not br.read_flag(), "ph partition constraints override")
    if cfg.joint_cbcr:
        si.jccr_sign = br.read_flag()
    # slice header tail
    br.read_flag()                      # no_output_of_prior_pics
    if cfg.alf:
        si.alf_enabled = br.read_flag()
        if si.alf_enabled:
            n_aps = br.read(3)          # slice_num_alf_aps_ids_luma
            si.alf_aps_ids = tuple(br.read(3) for _ in range(n_aps))
            si.alf_cb = bool(br.read(1))
            si.alf_cr = bool(br.read(1))
            if si.alf_cb or si.alf_cr:
                si.alf_aps_id_chroma = br.read(3)
        if cfg.ccalf and si.alf_enabled:
            si.ccalf_cb = br.read_flag()
            if si.ccalf_cb:
                si.ccalf_cb_aps_id = br.read(3)
            si.ccalf_cr = br.read_flag()
            if si.ccalf_cr:
                si.ccalf_cr_aps_id = br.read(3)
    assert br.read_svlc() == 0, "sh_qp_delta"
    if cfg.sao:
        si.sao_luma = br.read_flag()
        si.sao_chroma = br.read_flag()
    if cfg.dep_quant:
        si.dep_quant = br.read_flag()
    if cfg.sign_hiding and not si.dep_quant:
        si.sign_hiding = br.read_flag()
    if cfg.transform_skip and not si.dep_quant and not si.sign_hiding:
        _expect(not br.read_flag(), "ts residual coding disabled")
    # byte_alignment: one 1-bit then zeros
    assert br.read(1) == 1
    si.slice_data = br.tail_bytes()
    return si


def parse_picture_hash_sei(rbsp: bytes):
    """Decoded-picture-hash suffix SEI -> list of 3 MD5 digests."""
    br = BitReader(rbsp)
    ptype = br.read(8)
    psize = br.read(8)
    if ptype != 132:
        return None
    payload = bytes(br.read(8) for _ in range(psize))
    assert payload[0] == 0, "only MD5 hash_type supported"
    return [payload[1 + 16 * i: 17 + 16 * i] for i in range(3)]


@dataclass
class Bitstream:
    """Parsed access units of an Annex-B stream (this encoder's layout)."""
    cfg: VVCConfig = None
    slices: list = field(default_factory=list)      # SliceInfo per frame
    hashes: list = field(default_factory=list)      # per frame, or None
    aps: list = field(default_factory=list)         # raw APS rbsp payloads


def parse_bitstream(data: bytes) -> Bitstream:
    """APS NALs persist by (aps_params_type, aps_id) across pictures
    (VTM ParameterSetManager semantics): every slice sees the full table
    of APS received so far, with later same-id APS replacing earlier
    ones.  aps_params_type u(3) + aps_id u(5) are the first RBSP byte
    (VLCReader.cpp parseAPS)."""
    out = Bitstream()
    aps_table: dict[int, bytes] = {}     # (type<<5)|id -> rbsp
    for nal_type, _hdr, rbsp in split_nals(data):
        if nal_type == NAL_SPS:
            out.cfg = parse_sps(rbsp)
        elif nal_type == NAL_PPS:
            parse_pps(rbsp, out.cfg)
        elif nal_type == NAL_PREFIX_APS:
            aps_table[rbsp[0]] = rbsp
        elif nal_type == NAL_IDR_N_LP:
            si = parse_slice_header(rbsp, out.cfg)
            si.aps = list(aps_table.values())
            si.aps_by_id = dict(aps_table)
            out.slices.append(si)
            out.hashes.append(None)
        elif nal_type == NAL_SUFFIX_SEI:
            if out.hashes:
                out.hashes[-1] = parse_picture_hash_sei(rbsp)
    return out
