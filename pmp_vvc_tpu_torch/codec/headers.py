"""VVC high-level syntax writers (SPS/PPS/PH/SH) for the all-intra config.

Field sequences follow the bitstream syntax emitted by the conformance
target (VTM-10.0 HLSWriter: VLCWriter.cpp codeSPS :836, codePPS :257,
codePictureHeader :1651, codeSliceHeader :2245, codeProfileTierLevel
:2897) for the constrained configuration this encoder produces. Paths not
reachable from ``VVCConfig`` raise instead of guessing.

Headers are validated byte-for-byte against a reference-encoder golden
stream in tests/test_headers.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitWriter, nal_unit

NAL_IDR_N_LP = 8
NAL_CRA = 9
NAL_SPS = 15
NAL_PPS = 16
NAL_PH = 19
NAL_SUFFIX_SEI = 24


def _flog2(v: int) -> int:
    return int(v).bit_length() - 1


@dataclass
class VVCConfig:
    width: int
    height: int
    qp: int = 32
    # sps_partition_constraints_override_enabled_flag (decode side: set
    # from the parsed SPS; our writer always writes 0)
    partition_override: bool = False
    bit_depth: int = 10
    # CTU 128 only: the encoder/decoder hard-code the 128 CTU raster
    # and the dual-tree 64-quadrant structure (the CTC configuration,
    # encoder_intra_vtm.cfg CTUSize 128); __post_init__ rejects other
    # values rather than letting the field silently lie
    ctu_size: int = 128
    log2_min_cb: int = 2
    # partition
    min_qt_intra: int = 8
    max_mtt_depth_intra: int = 0
    max_bt_intra: int = 8
    max_tt_intra: int = 8
    dual_tree: bool = False
    chroma_min_qt: int = 8        # luma units (= 4 chroma samples)
    chroma_max_mtt_depth: int = 3
    chroma_max_bt: int = 32       # luma units
    chroma_max_tt: int = 32
    log2_max_tb: int = 6
    # profile/level
    profile_idc: int = 1          # Main 10
    level_idc: int = 35           # level 2.1 (16 * 2 + 1*... VTM Level::L2_1=35)
    # tools (all default-off for the minimal config)
    sao: bool = False
    alf: bool = False
    ccalf: bool = False
    alf_chroma: bool = False       # slice_alf_cb/cr (needs a chroma APS)
    lmcs: bool = False
    lmcs_chroma_scaling: bool = False   # ph_chroma_residual_scale_flag
    lmcs_offset: int = 2                # lmcs_delta_abs_crs (CTC LMCSOffset)
    mts_intra: bool = False
    lfnst: bool = False
    isp: bool = False
    mrl: bool = False
    mip: bool = False
    cclm: bool = False
    joint_cbcr: bool = False
    transform_skip: bool = False
    ts_max_log2: int = 5           # TransformSkipLog2MaxSize (CTC 5 -> 32)
    bdpcm: bool = False            # sps_bdpcm_enabled_flag (decode side)
    internal_minus_input: int = 0  # sps_internal_bit_depth_minus_input_bit_depth
    dep_quant: bool = False
    sign_hiding: bool = False
    rd_quant: bool = True          # encoder-side RDOQ-lite zeroing
    deblocking_disabled: bool = True
    poc_bits: int = 8
    num_reorder_pics: int = 0
    max_dec_pic_buffering: int = 2
    chroma_qp_offset: int = 0
    jccr_qp_offset: int = 0        # pps_joint_cbcr_qp_offset_value
    # chroma QP mapping table (SPS): start + (delta_in_minus1, delta_out)
    # points; default identity. CTC AI uses ((-9), (9,12),(4,5),(11,7))
    chroma_qp_start_minus26: int = 0
    chroma_qp_points: tuple = ((0, 0),)

    def __post_init__(self):
        if self.ctu_size != 128:
            raise NotImplementedError(
                "CTU-128 only: the CTU raster, dual-tree 64-quadrant "
                "structure and SAO/ALF grids hard-code 128 "
                "(encoder_intra_vtm.cfg CTUSize)")

    @property
    def min_qt_log2(self):
        return _flog2(self.min_qt_intra)


def write_profile_tier_level(bw: BitWriter, cfg: VVCConfig,
                             max_sub_layers_minus1: int = 0):
    """codeProfileTierLevel (profileTierPresentFlag=True)."""
    bw.write(cfg.profile_idc, 7)       # general_profile_idc
    bw.write_flag(0)                   # general_tier_flag (MAIN)
    bw.write(cfg.level_idc, 8)         # general_level_idc
    bw.write_flag(1)                   # ptl_frame_only_constraint_flag
    bw.write_flag(0)                   # ptl_multilayer_enabled_flag
    # constraint info: gci_present_flag = 0 then byte align
    bw.write_flag(0)
    bw.byte_align_zero()
    # no sub layers -> no flags; byte aligned already
    bw.write(0, 8)                     # ptl_num_sub_profiles


def write_ref_pic_list(bw: BitWriter, num_pics: int = 0):
    """xCodeRefPicList for an empty/trivial list (AI)."""
    bw.write_uvlc(num_pics)            # num_ref_entries
    assert num_pics == 0, "only empty RPLs supported"


def write_sps(cfg: VVCConfig) -> bytes:
    bw = BitWriter()
    bw.write(0, 4)                     # sps_seq_parameter_set_id
    bw.write(0, 4)                     # sps_video_parameter_set_id
    bw.write(0, 3)                     # sps_max_sub_layers_minus1
    bw.write(1, 2)                     # chroma_format_idc 4:2:0
    bw.write(_flog2(cfg.ctu_size) - 5, 2)  # sps_log2_ctu_size_minus5
    bw.write_flag(1)                   # sps_ptl_dpb_hrd_params_present_flag
    write_profile_tier_level(bw, cfg)
    bw.write_flag(0)                   # gdr_enabled_flag
    bw.write_flag(0)                   # ref_pic_resampling_enabled_flag
    bw.write_uvlc(cfg.width)           # pic_width_max_in_luma_samples
    bw.write_uvlc(cfg.height)
    conf_needed = cfg.width % 8 or cfg.height % 8
    assert not conf_needed, "conformance window not supported yet"
    bw.write_flag(0)                   # sps_conformance_window_flag
    bw.write_flag(0)                   # subpic_info_present_flag
    bw.write_uvlc(cfg.bit_depth - 8)   # sps_bitdepth_minus8
    bw.write_flag(0)                   # sps_entropy_coding_sync_enabled_flag
    bw.write_flag(0)                   # sps_entry_point_offsets_present_flag
    bw.write(cfg.poc_bits - 4, 4)      # log2_max_pic_order_cnt_lsb_minus4
    bw.write_flag(0)                   # sps_poc_msb_flag
    bw.write(0, 2)                     # num_extra_ph_bits_bytes
    bw.write(0, 2)                     # num_extra_sh_bits_bytes
    # dpb_parameters (single layer)
    bw.write_uvlc(cfg.max_dec_pic_buffering - 1)
    bw.write_uvlc(cfg.num_reorder_pics)
    bw.write_uvlc(0)                   # max_latency_increase_plus1
    bw.write_uvlc(cfg.log2_min_cb - 2)  # log2_min_luma_coding_block_size_minus2
    bw.write_flag(0)                   # partition_constraints_override
    bw.write_uvlc(cfg.min_qt_log2 - cfg.log2_min_cb)
    bw.write_uvlc(cfg.max_mtt_depth_intra)
    if cfg.max_mtt_depth_intra != 0:
        bw.write_uvlc(_flog2(cfg.max_bt_intra) - cfg.min_qt_log2)
        bw.write_uvlc(_flog2(cfg.max_tt_intra) - cfg.min_qt_log2)
    bw.write_flag(cfg.dual_tree)       # qtbtt_dual_tree_intra_flag
    if cfg.dual_tree:
        bw.write_uvlc(_flog2(cfg.chroma_min_qt) - cfg.log2_min_cb)
        bw.write_uvlc(cfg.chroma_max_mtt_depth)
        if cfg.chroma_max_mtt_depth != 0:
            bw.write_uvlc(_flog2(cfg.chroma_max_bt)
                          - _flog2(cfg.chroma_min_qt))
            bw.write_uvlc(_flog2(cfg.chroma_max_tt)
                          - _flog2(cfg.chroma_min_qt))
    # inter (B/P) partition constraints — mirrored minimal values
    bw.write_uvlc(cfg.min_qt_log2 - cfg.log2_min_cb)   # B-slice minQT
    bw.write_uvlc(0)                   # sps_max_mtt_hierarchy_depth_inter_slice
    if cfg.ctu_size > 32:
        bw.write_flag(cfg.log2_max_tb - 5)  # sps_max_luma_transform_size_64_flag
    bw.write_flag(cfg.transform_skip)
    if cfg.transform_skip:
        # log2_transform_skip_max_size_minus2 + sps_bdpcm_enabled_flag
        # (VLCReader.cpp:1851-1857)
        bw.write_uvlc(cfg.ts_max_log2 - 2)
        bw.write_flag(cfg.bdpcm)
    bw.write_flag(cfg.mts_intra)       # sps_mts_enabled_flag
    if cfg.mts_intra:
        bw.write_flag(1)               # sps_explicit_mts_intra_enabled_flag
        bw.write_flag(0)               # sps_explicit_mts_inter_enabled_flag
    bw.write_flag(cfg.lfnst)
    # chroma tool block (chroma_format != 400)
    bw.write_flag(cfg.joint_cbcr)
    bw.write_flag(1)                   # same_qp_table_for_chroma
    bw.write_svlc(cfg.chroma_qp_start_minus26)  # qp_table_start_minus26
    bw.write_uvlc(len(cfg.chroma_qp_points) - 1)
    for di, do in cfg.chroma_qp_points:
        bw.write_uvlc(di)              # sps_delta_qp_in_val_minus1
        bw.write_uvlc(do ^ di)         # sps_delta_qp_diff_val
    bw.write_flag(cfg.sao)
    bw.write_flag(cfg.alf)
    if cfg.alf:
        bw.write_flag(cfg.ccalf)   # sps_ccalf_enabled_flag (chroma != 400)
    bw.write_flag(cfg.lmcs)
    bw.write_flag(0)                   # sps_weighted_pred_flag
    bw.write_flag(0)                   # sps_weighted_bipred_flag
    bw.write_flag(0)                   # long_term_ref_pics_flag
    bw.write_flag(0)                   # sps_idr_rpl_present_flag
    bw.write_flag(0)                   # rpl1_same_as_rpl0_flag ... careful
    # sps_num_ref_pic_lists[0] and RPLs
    bw.write_uvlc(0)                   # num_ref_pic_lists_in_sps[0]
    bw.write_uvlc(0)                   # num_ref_pic_lists_in_sps[1]
    bw.write_flag(0)                   # sps_ref_wraparound_enabled_flag
    bw.write_flag(0)                   # sps_temporal_mvp_enabled_flag
    bw.write_flag(0)                   # sps_amvr_enabled_flag
    bw.write_flag(0)                   # sps_bdof_enabled_flag
    bw.write_flag(0)                   # sps_smvd_enabled_flag
    bw.write_flag(0)                   # sps_dmvr_enabled_flag
    bw.write_flag(0)                   # sps_mmvd_enabled_flag
    bw.write_uvlc(6 - 5)               # six_minus_max_num_merge_cand (5 cands)
    bw.write_flag(0)                   # sps_sbt_enabled_flag
    bw.write_flag(0)                   # sps_affine_enabled_flag
    bw.write_flag(0)                   # sps_bcw_enabled_flag
    bw.write_flag(0)                   # sps_ciip_enabled_flag
    # maxNumMergeCand >= 2 -> geo flag
    bw.write_flag(0)                   # sps_gpm_enabled_flag
    bw.write_uvlc(0)                   # log2_parallel_merge_level_minus2
    bw.write_flag(cfg.isp)
    bw.write_flag(cfg.mrl)
    bw.write_flag(cfg.mip)
    bw.write_flag(cfg.cclm)            # sps_cclm_enabled_flag
    # 4:2:0 collocated chroma flags
    bw.write_flag(0)                   # sps_chroma_horizontal_collocated_flag
    bw.write_flag(0)                   # sps_chroma_vertical_collocated_flag
    bw.write_flag(0)                   # sps_palette_enabled_flag
    if cfg.transform_skip:             # TS||PLT (VLCReader.cpp:2142)
        bw.write_uvlc(cfg.internal_minus_input)
    bw.write_flag(0)                   # sps_ibc_enabled_flag
    bw.write_flag(0)                   # sps_ladf_enabled_flag
    bw.write_flag(0)                   # sps_explicit_scaling_list_enabled_flag
    bw.write_flag(cfg.dep_quant)
    bw.write_flag(cfg.sign_hiding)
    bw.write_flag(0)                   # sps_virtual_boundaries_enabled_flag
    # ptl_dpb_hrd present -> general hrd params flag
    bw.write_flag(0)                   # sps_general_hrd_params_present_flag
    bw.write_flag(0)                   # sps_field_seq_flag
    bw.write_flag(0)                   # sps_vui_parameters_present_flag
    bw.write_flag(0)                   # sps_extension_present_flag
    bw.write(1, 1)                     # rbsp_stop_one_bit
    bw.byte_align_zero()
    return bw.bytes()


def write_pps(cfg: VVCConfig) -> bytes:
    bw = BitWriter()
    bw.write(0, 6)                     # pps_pic_parameter_set_id
    bw.write(0, 4)                     # pps_seq_parameter_set_id
    bw.write_flag(0)                   # pps_mixed_nalu_types_in_pic_flag
    bw.write_uvlc(cfg.width)
    bw.write_uvlc(cfg.height)
    bw.write_flag(0)                   # pps_conformance_window_flag
    bw.write_flag(0)                   # pps_scaling_window_explicit_signalling
    bw.write_flag(0)                   # pps_output_flag_present_flag
    bw.write_flag(1)                   # pps_no_pic_partition_flag
    bw.write_flag(0)                   # pps_subpic_id_mapping_present_flag
    bw.write_flag(0)                   # pps_cabac_init_present_flag
    bw.write_uvlc(0)                   # num_ref_idx_l0_default_active_minus1
    bw.write_uvlc(0)                   # num_ref_idx_l1_default_active_minus1
    bw.write_flag(0)                   # pps_rpl1_idx_present_flag
    bw.write_flag(0)                   # pps_weighted_pred_flag
    bw.write_flag(0)                   # pps_weighted_bipred_flag
    bw.write_flag(0)                   # pps_ref_wraparound_enabled_flag
    bw.write_svlc(cfg.qp - 26)         # pps_init_qp_minus26
    bw.write_flag(0)                   # pps_cu_qp_delta_enabled_flag
    bw.write_flag(1)                   # pps_chroma_tool_offsets_present_flag
    bw.write_svlc(cfg.chroma_qp_offset)  # pps_cb_qp_offset
    bw.write_svlc(cfg.chroma_qp_offset)  # pps_cr_qp_offset
    bw.write_flag(0)                   # pps_joint_cbcr_qp_offset_present_flag
    bw.write_flag(0)                   # pps_slice_chroma_qp_offsets_present
    bw.write_flag(0)                   # pps_cu_chroma_qp_offset_list_enabled
    bw.write_flag(1)                   # pps_deblocking_filter_control_present
    bw.write_flag(0)                   # pps_deblocking_filter_override_enabled
    bw.write_flag(cfg.deblocking_disabled)  # pps_deblocking_filter_disabled
    if not cfg.deblocking_disabled:
        bw.write_svlc(0)               # pps_luma_beta_offset_div2
        bw.write_svlc(0)               # pps_luma_tc_offset_div2
        bw.write_svlc(0)               # cb beta
        bw.write_svlc(0)               # cb tc
        bw.write_svlc(0)               # cr beta
        bw.write_svlc(0)               # cr tc
    bw.write_flag(0)                   # pps_picture_header_extension_present
    bw.write_flag(0)                   # pps_slice_header_extension_present
    bw.write_flag(0)                   # pps_extension_present_flag
    bw.write(1, 1)
    bw.byte_align_zero()
    return bw.bytes()


def write_picture_header(bw: BitWriter, cfg: VVCConfig, poc: int):
    """codePictureHeader for the constrained config (in-slice-header form)."""
    bw.write_flag(1)                   # ph_gdr_or_irap_pic_flag
    bw.write_flag(0)                   # ph_non_ref_pic_flag
    bw.write_flag(0)                   # ph_gdr_pic_flag
    bw.write_flag(0)                   # ph_inter_slice_allowed_flag
    bw.write_uvlc(0)                   # ph_pic_parameter_set_id
    bw.write(poc & ((1 << cfg.poc_bits) - 1), cfg.poc_bits)  # ph_pic_order_cnt_lsb
    # alf-in-ph absent (sps alf off); scaling-list/virtual-boundary/
    # output/rpl/split-override/dqp/sao/deblock-in-ph blocks absent
    if cfg.lmcs:
        bw.write_flag(1)               # ph_lmcs_enabled_flag
        bw.write(0, 2)                 # ph_lmcs_aps_id
        bw.write_flag(cfg.lmcs_chroma_scaling)  # ph_chroma_residual_scale
    if cfg.joint_cbcr:
        bw.write_flag(1)               # ph_joint_cbcr_sign_flag (Cr = -Cb)


def write_slice_header(cfg: VVCConfig, poc: int) -> BitWriter:
    """codeSliceHeader with the picture header in the slice header.

    Returns the BitWriter (unaligned) so slice data can follow after
    byte alignment by the caller.
    """
    bw = BitWriter()
    bw.write_flag(1)                   # sh_picture_header_in_slice_header_flag
    write_picture_header(bw, cfg, poc)
    # slice_type not coded (intra-only picture); IDR -> no_output_of_prior
    bw.write_flag(0)                   # sh_no_output_of_prior_pics_flag
    if cfg.alf:
        bw.write_flag(1)               # slice_alf_enabled_flag
        if cfg.alf_chroma:
            bw.write(1, 3)             # slice_num_alf_aps_ids_luma
            bw.write(0, 3)             # slice_alf_aps_id_luma[0]
            bw.write(1, 1)             # slice_alf_cb_enabled_flag
            bw.write(1, 1)             # slice_alf_cr_enabled_flag
            bw.write(0, 3)             # slice_alf_aps_id_chroma
        else:
            bw.write(0, 3)             # fixed luma filter sets only
            bw.write(0, 1)             # slice_alf_cb_enabled_flag
            bw.write(0, 1)             # slice_alf_cr_enabled_flag
        if cfg.ccalf:
            bw.write_flag(1)           # slice_cc_alf_cb_enabled_flag
            bw.write(0, 3)             # slice_cc_alf_cb_aps_id
            bw.write_flag(1)           # slice_cc_alf_cr_enabled_flag
            bw.write(0, 3)             # slice_cc_alf_cr_aps_id
    # no alf/lmcs/scaling/rpl/cabac-init/tmvp/wp blocks
    bw.write_svlc(0)                   # sh_qp_delta (sliceQp == pps init)
    # no chroma qp offsets / cu chroma qp adj (pps flags 0)
    if cfg.sao:                        # sps_sao_enabled && !sao_info_in_ph
        bw.write_flag(1)               # slice_sao_luma_flag
        bw.write_flag(1)               # slice_sao_chroma_flag
    # no deblock override (pps override disabled)
    if cfg.dep_quant:
        bw.write_flag(1)               # sh_dep_quant_used_flag
    if cfg.sign_hiding and not cfg.dep_quant:
        bw.write_flag(1)               # sh_sign_data_hiding_used_flag
    if cfg.transform_skip and not cfg.dep_quant and not cfg.sign_hiding:
        bw.write_flag(0)               # slice_ts_residual_coding_disabled
    return bw


def slice_nal(cfg: VVCConfig, poc: int, slice_data: bytes) -> bytes:
    bw = write_slice_header(cfg, poc)
    bw.write(1, 1)                     # byte_alignment: alignment bit 1
    bw.byte_align_zero()
    bw.append_bytes(slice_data)
    return nal_unit(NAL_IDR_N_LP, bw.bytes())


def sps_nal(cfg: VVCConfig) -> bytes:
    return nal_unit(NAL_SPS, write_sps(cfg))


def pps_nal(cfg: VVCConfig) -> bytes:
    return nal_unit(NAL_PPS, write_pps(cfg))


def decoded_picture_hash_sei(recon_planes, bit_depth: int = 10) -> bytes:
    """Suffix-SEI NAL with the MD5 decoded-picture hash.

    Contract: SEIwrite.cpp xWriteSEIDecodedPictureHash (payload type 132,
    hash_type 0, 16 bytes per plane) and PicYuvMD5.cpp md5_plane (samples
    raster order, little-endian, (bitDepth+7)/8 bytes each).
    """
    import hashlib

    nbytes = (bit_depth + 7) // 8
    digests = b""
    for plane in recon_planes:
        import numpy as _np
        arr = _np.asarray(plane)
        data = (arr.astype("<u2").tobytes() if nbytes == 2
                else arr.astype(_np.uint8).tobytes())
        digests += hashlib.md5(data).digest()
    payload = bytes([0]) + digests          # hash_type MD5 + 3 x 16 bytes
    bw = BitWriter()
    bw.write(132, 8)                        # payload_type
    bw.write(len(payload), 8)               # payload_size
    bw.append_bytes(payload)
    bw.write(1, 1)                          # rbsp trailing
    bw.byte_align_zero()
    return nal_unit(NAL_SUFFIX_SEI, bw.bytes())
