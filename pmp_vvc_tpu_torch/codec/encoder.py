"""All-intra VVC frame encoder: the syntax, coding tree and frame tail that
the wave path (``codec/wavefront.py``) replays its device decisions through.

A port of the part of the JAX package's ``codec/encoder.py`` that its
``WavefrontEncoder`` reaches: chroma QP table, slice lambda and chroma
distortion weight; the neighbour state; split, intra-mode, residual
(transform-skip residual included), LFNST and MTS syntax; the coding-tree walks and split deciders; the bin-op
recorder and the native CABAC finalizer; and ``encode_frame``'s tail
(LMCS inverse mapping, deblocking, SAO, ALF and CC-ALF, NAL units with the
LMCS and ALF APS, decoded-picture-hash SEI).

Syntax contracts: CABACWriter.cpp coding_tree_unit :158 / coding_tree :394 /
split_cu_mode :567 / coding_unit :660 / intra_luma_pred_modes :1057 /
intra_chroma_pred_mode :1259 / transform_unit :2406 / cbf_comp :2305;
MPM list UnitTools.cpp:591; QP derivation Quant.cpp QpParam :54.

Not ported: the sequential CU coding (mode choice, per-TU RD, ISP, MRL,
dependent quantization), whose ``_encode_cu`` raises here; the CABAC rate
estimator that only the sequential path reads.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from . import alf
from .cabac import ContextStore
from .deblock import deblock_frame
from .headers import (VVCConfig, decoded_picture_hash_sei, pps_nal, slice_nal,
                      sps_nal)
from .lmcs import Reshaper, derive_ai_model, lmcs_aps_nal
from .mtt import (SplitState, can_split_set, get_implicit_split,
                  write_split_cu_mode)
from .partition import MapPartitioner, PartitionConstraints, Split
from .residual import ResidualCoder, TSResidualCoder, ctx, grouped_scan
from .sao import apply_sao_frame, decide_sao_frame, write_sao_ctu
from ..ops import mip as mip_ops


class RecordingEncoder:
    """Records the bin sequence of a slice-data pass for later replay.

    VTM writes the final bitstream in a second entropy pass after the
    in-loop filters are decided (EncSlice::encodeSlice); this captures
    pass 1 so pass 2 can interleave the SAO CTU syntax
    (CABACWriter::coding_tree_unit order: sao() first, :158).
    """

    def __init__(self):
        self.ops = []
        self.ctu_marks = []

    def mark_ctu(self):
        self.ctu_marks.append(len(self.ops))

    def encode_bin(self, v, ctx_id):
        self.ops.append(("b", v, ctx_id))

    def encode_bin_ep(self, v):
        self.ops.append(("ep", v))

    def encode_bins_ep(self, bins, n):
        self.ops.append(("eps", bins, n))

    def encode_rem_abs_ep(self, value, rice_par, cutoff, max_log2_tr_range):
        self.ops.append(("rem", value, rice_par, cutoff, max_log2_tr_range))


PLANAR, DC, HOR, VER = 0, 1, 18, 50
NUM_MPM = 6

# decide() sentinel: defer this node to the RDO split search
# (EncModeCtrl.cpp:1455-1645 stock fallback outside the map gate)
RDO = "rdo"


def derive_chroma_qp_table(start_minus26=0, delta_in_minus1=(0,),
                           delta_out=(0,), bit_depth=10):
    """ChromaQpMappingTable::derivedChromaQPMappingTables (Slice.cpp)."""
    qp_bd_offset = 6 * (bit_depth - 8)
    n = len(delta_in_minus1)
    qp_in = [start_minus26 + 26]
    qp_out = [qp_in[0]]
    for j in range(n):
        qp_in.append(qp_in[j] + delta_in_minus1[j] + 1)
        qp_out.append(qp_out[j] + delta_out[j])
    table = np.zeros(64 + qp_bd_offset, np.int32)  # index qpi + qp_bd_offset
    def set_t(qpi, v):
        table[qpi + qp_bd_offset] = v
    def get_t(qpi):
        return int(table[qpi + qp_bd_offset])
    set_t(qp_in[0], qp_out[0])
    for k in range(qp_in[0] - 1, -qp_bd_offset - 1, -1):
        set_t(k, max(-qp_bd_offset, min(63, get_t(k + 1) - 1)))
    for j in range(n):
        sh = (delta_in_minus1[j] + 1) >> 1
        for m, k in enumerate(range(qp_in[j] + 1, qp_in[j + 1] + 1), 1):
            set_t(k, get_t(qp_in[j])
                  + ((qp_out[j + 1] - qp_out[j]) * m + sh)
                  // (delta_in_minus1[j] + 1))
    for k in range(qp_in[n] + 1, 64):
        set_t(k, max(-qp_bd_offset, min(63, get_t(k - 1) + 1)))
    return table, qp_bd_offset


@dataclass
class CuInfo:
    x: int
    y: int
    w: int
    h: int
    qt_depth: int
    mode: int = PLANAR
    mip: bool = False
    mip_mode: int = 0
    mip_transpose: bool = False
    cclm: bool = False
    lm_symbol: int = 0        # getLMSymbolList: 0=LM, 1=MDLM_L, 2=MDLM_T
    mrl: int = 0
    isp: int = 0              # 0 off, 1 HOR, 2 VER
    chroma_mode: int | None = None   # non-DM chroma mode (decode side)
    bdpcm: int = 0            # 0 off, 1 horizontal, 2 vertical (decode)
    bdpcm_c: int = 0


class FrameEncoder:
    """Encodes one intra frame to a slice-data CABAC payload + recon.

    ``timings`` accumulates host seconds per stage of ``encode_frame``:
    ``replay`` (coding-tree walk and CABAC bin recording), ``deblock`` (with
    LMCS, the inverse luma mapping first), ``sao`` (decision and filtering),
    ``alf`` (with ALF: the filters' derivation, decision and filtering, and
    CC-ALF's) and ``finalize`` (SAO and ALF syntax splice, native CABAC
    finalizer, NAL units, hash SEI). ``alf_ctus`` accumulates alike the CTUs
    with each ALF filter on: luma, Cb, Cr, CC-ALF Cb, CC-ALF Cr."""

    def __init__(self, cfg: VVCConfig, *, accel_level: int = 3,
                 rdo_fallback: bool = False, ablation_skip_mtt: bool = False,
                 ablation_disturb=None):
        self.cfg = cfg
        self.accel_level = accel_level
        self.rdo_fallback = rdo_fallback
        # debug/ablation toggles (reference compile-time *_fal macros):
        # skip_mtt = Skip_Partition_Mode_fal (EncModeCtrl.cpp:1973-1977,
        # every BT/TT test mode rejected); disturb = Context_Disturb_fal
        # (:1962-1971, one (x, y, w, h, Split) decision forced off)
        self.ablation_skip_mtt = ablation_skip_mtt
        self.ablation_disturb = ablation_disturb
        self.qp_table, self.qp_bd_offset = derive_chroma_qp_table(
            cfg.chroma_qp_start_minus26,
            tuple(p[0] for p in cfg.chroma_qp_points),
            tuple(p[1] for p in cfg.chroma_qp_points),
            bit_depth=cfg.bit_depth)
        # slice lambda (EncSlice::initializeLambda, AI: QPfactor 0.57):
        # lambda = 0.57 * 2^((QP + bitDepthShift)/3) with bitDepthShift =
        # 6*(bd-8) - SHIFT_QP(12), i.e. the *internal* QP drives lambda
        self.lam = 0.57 * 2.0 ** ((cfg.qp + 6 * (cfg.bit_depth - 8) - 12)
                                  / 3.0)
        # chroma distortion weight 2^((qpY-qpC)/3) in user-QP scale
        # (EncSlice::setUpLambda)
        qpi = max(-self.qp_bd_offset, min(63, cfg.qp))
        qp_c = int(self.qp_table[qpi + self.qp_bd_offset]) \
            + cfg.chroma_qp_offset
        qp_c = max(-self.qp_bd_offset, min(63, qp_c))
        self.dw_c = 2.0 ** ((cfg.qp - qp_c) / 3.0)
        self.reshaper = Reshaper(derive_ai_model(cfg.bit_depth, cfg.lmcs_offset),
                                 cfg.bit_depth) if cfg.lmcs else None
        self.timings = {}
        self.alf_ctus = {}

    def _time(self, stage, t0):
        self.timings[stage] = self.timings.get(stage, 0.0) + time.perf_counter() - t0

    # ---- neighbour state -------------------------------------------------

    def _init_state(self):
        cfg = self.cfg
        r4, c4 = cfg.height // 4, cfg.width // 4
        self.coded = np.zeros((r4, c4), bool)          # luma 4x4 units decoded
        self.unit_mode = np.full((r4, c4), PLANAR, np.int32)
        self.unit_w = np.zeros((r4, c4), np.int32)
        self.unit_h = np.zeros((r4, c4), np.int32)
        self.unit_qt = np.zeros((r4, c4), np.int32)
        self.recon_y = np.zeros((cfg.height, cfg.width), np.int32)
        self.recon_u = np.zeros((cfg.height // 2, cfg.width // 2), np.int32)
        self.recon_v = np.zeros((cfg.height // 2, cfg.width // 2), np.int32)
        # chroma-tree unit grids, filled by the dual-tree chroma pass
        self.coded_c = np.zeros((r4, c4), bool)
        self.unit_w_c = np.zeros((r4, c4), np.int32)   # luma units
        self.unit_h_c = np.zeros((r4, c4), np.int32)
        self.unit_qt_c = np.zeros((r4, c4), np.int32)
        self.leaf_l = []                  # leaf CUs, luma coords
        self.leaf_c = []                  # leaf CUs, chroma coords
        # chroma TUs coded in JCCR mode 2 (cbf_cb & cbf_cr joint), per
        # 2x2-chroma-sample unit — deblock maps their QP through the
        # JOINT_CbCr offset (QpParam Quant.cpp:112)
        self.unit_joint2 = np.zeros((cfg.height // 4, cfg.width // 4),
                                    bool)
        self.unit_mip = np.zeros((r4, c4), bool)

    def _cu_at(self, x, y):
        """(w, h, qt_depth, mode) of the CU covering luma pel (x, y)."""
        if x < 0 or y < 0 or y >= self.cfg.height or x >= self.cfg.width:
            return None
        r, c = y // 4, x // 4
        if not self.coded[r, c]:
            return None
        return (int(self.unit_w[r, c]), int(self.unit_h[r, c]),
                int(self.unit_qt[r, c]), int(self.unit_mode[r, c]))

    # ---- split syntax ----------------------------------------------------

    def _neighbor(self, x, y, chroma=False):
        if chroma:
            if x < 0 or y < 0 or y >= self.cfg.height or x >= self.cfg.width:
                return None
            r, c = y // 4, x // 4
            if not self.coded_c[r, c]:
                return None
            return (int(self.unit_w_c[r, c]), int(self.unit_h_c[r, c]),
                    int(self.unit_qt_c[r, c]))
        info = self._cu_at(x, y)
        if info is None:
            return None
        return (info[0], info[1], info[2])   # (w, h, qt_depth)

    def _write_split(self, enc, x, y, w, h, state, split, chroma=False):
        """split_cu_mode with boundary implicit-split inference.

        At picture boundaries only the bins the decoder cannot infer are
        coded (canNo=false etc., UnitPartitioner.cpp:409-418); the
        dual-tree >64 implicit QT codes no bins at all."""
        cfg = self.cfg
        implicit = get_implicit_split(x, y, w, h, state, cfg, chroma)
        left = self._neighbor(x - 1, y, chroma)
        above = self._neighbor(x, y - 1, chroma)
        write_split_cu_mode(enc, split, w, h, state, cfg, left, above,
                            chroma, implicit=implicit)

    # ---- intra mode syntax -----------------------------------------------

    def _mpm_list(self, cu: CuInfo):
        """PU::getIntraMPMs (UnitTools.cpp:591)."""
        left = self._cu_at(cu.x - 1, cu.y + cu.h - 1)
        above = None
        if cu.y % 128 != 0:   # above must be in same CTU
            above = self._cu_at(cu.x + cu.w - 1, cu.y - 1)
        left_dir = left[3] if left else PLANAR
        above_dir = above[3] if above else PLANAR
        offset = 67 - 6
        mod = offset + 3
        mpm = [PLANAR, DC, VER, HOR, VER - 4, VER + 4]
        if left_dir == above_dir:
            if left_dir > DC:
                mpm = [PLANAR, left_dir,
                       ((left_dir + offset) % mod) + 2,
                       ((left_dir - 1) % mod) + 2,
                       ((left_dir + offset - 1) % mod) + 2,
                       (left_dir % mod) + 2]
        else:
            if left_dir > DC and above_dir > DC:
                mpm = [PLANAR, left_dir, above_dir, 0, 0, 0]
                mx = max(left_dir, above_dir)
                mn = min(left_dir, above_dir)
                if mx - mn == 1:
                    mpm[3] = ((mn + offset) % mod) + 2
                    mpm[4] = ((mx - 1) % mod) + 2
                    mpm[5] = ((mn + offset - 1) % mod) + 2
                elif mx - mn >= 62:
                    mpm[3] = ((mn - 1) % mod) + 2
                    mpm[4] = ((mx + offset) % mod) + 2
                    mpm[5] = (mn % mod) + 2
                elif mx - mn == 2:
                    mpm[3] = ((mn - 1) % mod) + 2
                    mpm[4] = ((mn + offset) % mod) + 2
                    mpm[5] = ((mx - 1) % mod) + 2
                else:
                    mpm[3] = ((mn + offset) % mod) + 2
                    mpm[4] = ((mn - 1) % mod) + 2
                    mpm[5] = ((mx + offset) % mod) + 2
            elif left_dir + above_dir >= 2:
                mx = max(left_dir, above_dir)
                mpm = [PLANAR, mx,
                       ((mx + offset) % mod) + 2,
                       ((mx - 1) % mod) + 2,
                       ((mx + offset - 1) % mod) + 2,
                       (mx % mod) + 2]
        return mpm

    def _write_trunc_bin(self, enc, symbol, max_symbol):
        """xWriteTruncBinCode (CABACWriter.cpp:913); 61 symbols -> thresh 5."""
        thresh = 0
        while (1 << (thresh + 1)) <= max_symbol:
            thresh += 1
        val = 1 << thresh
        b = max_symbol - val
        if symbol < val - b:
            enc.encode_bins_ep(symbol, thresh)
        else:
            sym = symbol + val - b
            enc.encode_bins_ep(sym, thresh + 1)

    def _write_intra_luma_mode(self, enc, cu: CuInfo):
        """intra_luma_pred_modes (CABACWriter.cpp:1057) with the MIP flag
        and mode first when MIP is on; MRL and ISP off (the port refuses
        those flags)."""
        if self.cfg.mip:
            # DeriveCtx::CtxMipFlag (ContextModelling.cpp:557)
            left = self._cu_at(cu.x - 1, cu.y)
            above = self._cu_at(cu.x, cu.y - 1)
            ctx_id = 0
            if left is not None and self.unit_mip[cu.y // 4, (cu.x - 1) // 4]:
                ctx_id += 1
            if above is not None and self.unit_mip[(cu.y - 1) // 4, cu.x // 4]:
                ctx_id += 1
            if cu.w > 2 * cu.h or cu.h > 2 * cu.w:
                ctx_id = 3
            enc.encode_bin(1 if cu.mip else 0, ctx("MipFlag", ctx_id))
            if cu.mip:
                enc.encode_bin_ep(1 if cu.mip_transpose else 0)
                self._write_trunc_bin(enc, cu.mip_mode, mip_ops.num_modes(cu.w, cu.h))
                return
        mpm = self._mpm_list(cu)
        mpm_idx = mpm.index(cu.mode) if cu.mode in mpm else NUM_MPM
        enc.encode_bin(1 if mpm_idx < NUM_MPM else 0,
                       ctx("IntraLumaMpmFlag"))
        if mpm_idx < NUM_MPM:
            # not-planar flag: ctx 1 without ISP
            enc.encode_bin(1 if mpm_idx > 0 else 0,
                           ctx("IntraLumaPlanarFlag", 1))
            if mpm_idx:
                enc.encode_bin_ep(1 if mpm_idx > 1 else 0)
            if mpm_idx > 1:
                enc.encode_bin_ep(1 if mpm_idx > 2 else 0)
            if mpm_idx > 2:
                enc.encode_bin_ep(1 if mpm_idx > 3 else 0)
            if mpm_idx > 3:
                enc.encode_bin_ep(1 if mpm_idx > 4 else 0)
        else:
            spred = sorted(mpm)
            mode = cu.mode
            for m in reversed(spred):
                if mode > m:
                    mode -= 1
            self._write_trunc_bin(enc, mode, 67 - NUM_MPM)

    @staticmethod
    def _chroma_cand_list(luma_mode):
        """Non-DM chroma candidates: {PLANAR, VER, HOR, DC} with the
        entry equal to the co-located luma (DM) mode replaced by VDIA
        (PU::getIntraChromaCandModes, UnitTools.cpp)."""
        cands = [0, 50, 18, 1]
        for i, m in enumerate(cands):
            if m == luma_mode:
                cands[i] = 66
        return cands

    def _write_intra_chroma_mode(self, enc, cclm=False, cclm_allowed=None,
                                 lm_symbol=0, chroma_mode=None,
                                 luma_mode=0):
        """intra_chroma_pred_mode (CABACWriter.cpp:1258-1276) +
        intra_chroma_lmc_mode; getLMSymbolList order LM/MDLM_L/MDLM_T.
        ``chroma_mode``: non-DM mode from the 4-candidate list (None =
        DM); ``luma_mode`` the DM mode for the VDIA replacement."""
        if cclm_allowed is None:
            cclm_allowed = self.cfg.cclm and not self.cfg.dual_tree
        if cclm_allowed:
            enc.encode_bin(1 if cclm else 0, ctx("CclmModeFlag"))
            if cclm:
                enc.encode_bin(0 if lm_symbol == 0 else 1,
                               ctx("CclmModeIdx"))
                if lm_symbol > 0:
                    enc.encode_bin_ep(lm_symbol - 1)
                return
        if chroma_mode is None:
            # DM (derived mode): single ctx bin 0
            enc.encode_bin(0, ctx("IntraChromaPredMode"))
            return
        idx = self._chroma_cand_list(luma_mode).index(chroma_mode)
        enc.encode_bin(1, ctx("IntraChromaPredMode"))
        enc.encode_bin_ep(idx >> 1)
        enc.encode_bin_ep(idx & 1)

    def _cclm_allowed_dual(self, split_path):
        """checkCCLMAllowed, dual tree, CTU 128 (Unit.cpp:378-443).

        ``split_path`` = (split at the 64x64 chroma node, split of its
        child) along this CU's path; self._luma_root_split = the split
        of the co-located 64x64 luma node (quadrant root)."""
        d1, d2 = split_path
        ok = (d1 == Split.QT
              or (d1 == Split.BT_H and d2 == Split.BT_V)
              or d1 is None                        # 64x64 chroma leaf
              or (d1 == Split.BT_H and d2 is None))
        if not ok:
            return False
        lr = self._luma_root_split
        # luma side: ban if the 64x64 luma node used BT/TT, or is an
        # unsplit 64x64 CU coded with ISP (Unit.cpp:426-443)
        if lr == Split.NONE:
            return not self._luma_root_isp
        return lr == Split.QT

    # ---- residual, LFNST and MTS syntax -----------------------------------

    def _ts_allowed(self, w, h, is_luma, isp=0):
        """TU::isTSAllowed (UnitTools.cpp) — BDPCM/SBT off."""
        cfg = self.cfg
        mx = 1 << cfg.ts_max_log2
        return (cfg.transform_skip and w <= mx and h <= mx
                and (not isp or not is_luma))

    def _write_resid(self, rc, lev, w, h, is_luma, ts=False, isp=0):
        """ts_flag + residual for one cbf TU component (the
        CABACWriter::residual_coding entry, :2630). Returns
        (last_pos, violates_mts); (-1, False) for transform skip."""
        if self._ts_allowed(w, h, is_luma, isp):
            rc.enc.encode_bin(1 if ts else 0,
                              ctx("TransformSkipFlag", 0 if is_luma else 1))
        if ts:
            TSResidualCoder(rc.enc).code(lev, is_luma=is_luma)
            return -1, False
        return rc.code(lev, is_luma=is_luma)

    @staticmethod
    def _scan_pos_last(lev, w, h):
        """Last significant scan position (-1 if none)."""
        nz = np.nonzero(lev.reshape(-1)[grouped_scan(w, h)[:, 0]])[0]
        return int(nz[-1]) if nz.size else -1

    def _write_lfnst_idx(self, enc, cu, lfnst_idx, comps, sep_tree,
                         ts_used=False):
        """CABACWriter::residual_lfnst_mode (:2770-2820), without ISP.

        ``comps``: list of (w, h, lev) for every coded (cbf=1) non-TS TU
        component of this CU in its channel scope; ``ts_used``: any cbf
        component coded with transform skip (isTrSkip, :2789) — the
        index is then never coded."""
        cfg = self.cfg
        if not cfg.lfnst or ts_used:
            return
        if cu is not None and cu.mip and not (cu.w >= 16 and cu.h >= 16):
            return
        last_ok = False
        viol = False
        for (w, h, lev) in comps:
            if w < 4 or h < 4:
                continue
            last = self._scan_pos_last(lev, w, h)
            if last < 0:
                continue
            max_pos = 7 if ((w == 4 and h == 4) or (w == 8 and h == 8)) \
                else 15
            viol |= last > max_pos
            last_ok |= last >= 1
        if not last_ok or viol:
            return
        enc.encode_bin(1 if lfnst_idx else 0,
                       ctx("LFNSTIdx", 1 if sep_tree else 0))
        if lfnst_idx:
            enc.encode_bin(1 if lfnst_idx == 2 else 0, ctx("LFNSTIdx", 2))

    def _write_mts_idx(self, enc, mts_idx, cu_w, cu_h, cbf_y, last_pos,
                       violates):
        """CABACWriter::mts_idx (:2721) for single-TU intra CUs."""
        cfg = self.cfg
        allowed = (cfg.mts_intra and cu_w <= 32 and cu_h <= 32)
        if not allowed or violates or not cbf_y or last_pos < 1:
            return
        symbol = 1 if mts_idx != 0 else 0
        enc.encode_bin(symbol, ctx("MTSIdx", 0))
        if symbol:
            for i in range(3):
                s = 1 if mts_idx > i + 2 else 0
                enc.encode_bin(s, ctx("MTSIdx", 1 + i))
                if not s:
                    break

    # ---- CU coding: supplied by the wave path ------------------------------

    def _encode_cu(self, enc, rc, org_y, org_u, org_v, cu: CuInfo):
        raise NotImplementedError(
            "sequential CU coding is not ported; use WavefrontEncoder")

    def _encode_luma_cu(self, enc, rc, org_y, cu: CuInfo):
        raise NotImplementedError(
            "sequential CU coding is not ported; use WavefrontEncoder")

    def _encode_chroma_cu(self, enc, rc, org_u, org_v, cu: CuInfo,
                          split_path=(None, None)):
        raise NotImplementedError(
            "sequential CU coding is not ported; use WavefrontEncoder")

    # ---- coding tree -----------------------------------------------------

    def _encode_tree_ch(self, enc, rc, org, x, y, w, h, state, decide,
                        chroma, depth64=0, path=(None, None)):
        """``depth64``/``path`` track the splits at the 64x64 node and
        its child along this CU's path (CU::getSplitAtDepth for
        checkCCLMAllowed, Unit.cpp:378)."""
        cfg = self.cfg
        if x >= cfg.width or y >= cfg.height:
            return
        implicit = get_implicit_split(x, y, w, h, state, cfg, chroma)
        if implicit != Split.NONE:
            split = implicit
            if split == Split.BT_V and chroma and w // 2 == 4:
                split = Split.QT     # implicit-BV chroma-width-4 ban
        else:
            split = decide(x, y, w, h, state)
        if split == RDO:
            raise NotImplementedError("RDO split search is not ported")
        if not chroma and depth64 == 0:
            self._luma_root_split = split
        self._write_split(enc, x, y, w, h, state, split, chroma)
        if split != Split.NONE:
            npath = (split if depth64 == 0 else path[0],
                     split if depth64 == 1 else path[1])
            imp_bt = state.implicit_bt_depth + (
                1 if split == implicit
                and split in (Split.BT_H, Split.BT_V) else 0)
            for i, (cx, cy, cw, chh) in enumerate(
                    self._children(x, y, w, h, split)):
                cstate = SplitState(
                    last_split=split, part_idx=i,
                    qt_depth=state.qt_depth + (1 if split == Split.QT else 0),
                    mtt_depth=state.mtt_depth
                    + (0 if split == Split.QT else 1),
                    implicit_bt_depth=imp_bt)
                self._encode_tree_ch(enc, rc, org, cx, cy, cw, chh, cstate,
                                     decide, chroma, depth64 + 1, npath)
            return
        cu = CuInfo(x, y, w, h, state.qt_depth)
        if chroma:
            npath = (path[0] if depth64 > 0 else None,
                     path[1] if depth64 > 1 else None)
            self._encode_chroma_cu(enc, rc, org[1], org[2], cu,
                                   split_path=npath)
        else:
            self._encode_luma_cu(enc, rc, org[0], cu)

    @staticmethod
    def _children(x, y, w, h, split):
        """Child geometry in (x=col, y=row) convention, coding order."""
        if split == Split.QT:
            return [(x, y, w // 2, h // 2), (x + w // 2, y, w // 2, h // 2),
                    (x, y + h // 2, w // 2, h // 2),
                    (x + w // 2, y + h // 2, w // 2, h // 2)]
        if split == Split.BT_H:
            return [(x, y, w, h // 2), (x, y + h // 2, w, h // 2)]
        if split == Split.BT_V:
            return [(x, y, w // 2, h), (x + w // 2, y, w // 2, h)]
        if split == Split.TT_H:
            return [(x, y, w, h // 4), (x, y + h // 4, w, h // 2),
                    (x, y + 3 * h // 4, w, h // 4)]
        if split == Split.TT_V:
            return [(x, y, w // 4, h), (x + w // 4, y, w // 2, h),
                    (x + 3 * w // 4, y, w // 4, h)]
        return []

    @staticmethod
    def _scipu_cond(w, h, split):
        """modeTypeCondition != 0 for an I-slice 4:2:0 single-tree
        node: the split would create chroma blocks below 16 samples or
        of width 2 (UnitTools.cpp CU::checkModeTypeCondition; spec
        7.4.11.4)."""
        area = w * h
        return ((area == 64 and split != Split.NONE)
                or (area == 32 and split in (Split.BT_H, Split.BT_V))
                or (area == 128 and split in (Split.TT_H, Split.TT_V))
                or (w == 8 and split == Split.BT_V)
                or (w == 16 and split == Split.TT_V))

    def _encode_tree(self, enc, rc, org, x, y, w, h, state, decide):
        cfg = self.cfg
        if x >= cfg.width or y >= cfg.height:
            return
        implicit = get_implicit_split(x, y, w, h, state, cfg)
        split = implicit if implicit != Split.NONE \
            else decide(x, y, w, h, state)
        if split == RDO:
            raise NotImplementedError("RDO split search is not ported")
        if split != Split.NONE and self._scipu_cond(w, h, split):
            # SCIPU (modeTypeCondition != 0): the decoder would switch
            # to a local dual tree here, which this encoder does not
            # emit — refusing the split is always conformant; an
            # IMPLICIT such split cannot be refused, so fail loudly
            # (UnitTools.cpp CU::checkModeTypeCondition)
            if split == implicit:
                raise NotImplementedError(
                    "implicit boundary split triggers SCIPU "
                    f"({w}x{h} {split}); single-tree local dual tree "
                    "encoding is not implemented")
            split = Split.NONE
        self._write_split(enc, x, y, w, h, state, split)
        if split != Split.NONE:
            imp_bt = state.implicit_bt_depth + (
                1 if split == implicit
                and split in (Split.BT_H, Split.BT_V) else 0)
            for i, (cx, cy, cw, chh) in enumerate(
                    self._children(x, y, w, h, split)):
                cstate = SplitState(
                    last_split=split, part_idx=i,
                    qt_depth=state.qt_depth + (1 if split == Split.QT else 0),
                    mtt_depth=state.mtt_depth
                    + (0 if split == Split.QT else 1),
                    implicit_bt_depth=imp_bt)
                self._encode_tree(enc, rc, org, cx, cy, cw, chh, cstate,
                                  decide)
            return
        cu = CuInfo(x, y, w, h, state.qt_depth)
        self._encode_cu(enc, rc, org[0], org[1], org[2], cu)

    # ---- split deciders ----------------------------------------------------

    def _qt_map_decider(self, qt_map):
        """QT-only decisions from the predicted QT-depth map."""
        cfg = self.cfg
        def decide(x, y, w, h, state):
            implicit = (x + w > cfg.width) or (y + h > cfg.height)
            if w > 64 or implicit:
                return Split.QT
            if state.mtt_depth == 0 and w == h and w > cfg.min_qt_intra:
                pred = int(qt_map[min(y, cfg.height - 1) // 8,
                                  min(x, cfg.width - 1) // 8]) + 1
                if state.qt_depth < pred:
                    return Split.QT
            return Split.NONE
        return decide

    def _map_decider(self, hor, ver, qt, dire, chroma=False):
        """Full PMP map-driven decisions via the partition scheduler."""
        cfg = self.cfg
        if chroma:
            cons = PartitionConstraints(
                ctu_size=cfg.ctu_size, min_qt=cfg.chroma_min_qt,
                max_bt=cfg.chroma_max_bt, max_tt=cfg.chroma_max_tt,
                max_mtt_depth=cfg.chroma_max_mtt_depth,
                min_cb=1 << cfg.log2_min_cb, chroma=True)
        else:
            cons = PartitionConstraints(
                ctu_size=cfg.ctu_size, min_qt=cfg.min_qt_intra,
                max_bt=cfg.max_bt_intra, max_tt=cfg.max_tt_intra,
                max_mtt_depth=cfg.max_mtt_depth_intra,
                min_cb=1 << cfg.log2_min_cb)
        part = MapPartitioner(hor, ver, qt, dire,
                              accel_level=self.accel_level,
                              constraints=cons)

        def decide(x, y, w, h, state):
            implicit = (x + w > cfg.width) or (y + h > cfg.height)
            if w > 64 or h > 64 or implicit:
                return Split.QT
            # scheduler coords: x=row, y=col -> encoder (col, row)
            split, needs_rdo = part.decide(
                y, x, h, w, state.qt_depth, state.mtt_depth,
                state.last_split, state.part_idx)
            if needs_rdo and self.rdo_fallback:
                return RDO
            if split != Split.NONE:
                # defensive: the scheduled split must be signallable
                if not can_split_set(w, h, state, cfg, chroma)[split]:
                    return Split.NONE
            return split
        return decide

    def _apply_ablations(self, decide):
        """Debug/ablation wrappers (reference *_fal macros): skip-all-
        MTT (Skip_Partition_Mode_fal, EncModeCtrl.cpp:1973) and the
        single-decision disturb (Context_Disturb_fal, :1962).
        Idempotent; explicit decisions only (implicit splits are
        resolved before the decider is consulted)."""
        if not self.ablation_skip_mtt and self.ablation_disturb is None:
            return decide
        mtt = (Split.BT_H, Split.BT_V, Split.TT_H, Split.TT_V)
        dist = tuple(self.ablation_disturb) \
            if self.ablation_disturb is not None else None

        def wrapped(x, y, w, h, state):
            s = decide(x, y, w, h, state)
            if s is RDO:
                return s
            if self.ablation_skip_mtt and s in mtt:
                return Split.NONE
            if dist is not None and (x, y, w, h, s) == dist:
                return Split.NONE
            return s
        return wrapped

    # ---- entropy finalize --------------------------------------------------

    def _finalize_ops(self, ops) -> bytes:
        """Serialize a recorded bin-op stream to the terminated slice
        payload with the native C arithmetic coder (native/cabac.c)."""
        from ..native import cabac_finalize
        return cabac_finalize(ops, ContextStore.standard_init(self.cfg.qp, 2))

    # ---- ALF and CC-ALF ------------------------------------------------------

    def _alf_frame(self, y_orig, org_u, org_v):
        """Decide and apply ALF (and with ``alf_chroma`` its chroma filter,
        with ``ccalf`` CC-ALF) on the frame's recon, in place. Returns (the
        CTU syntax's inputs: luma flags, filter sets, Cb and Cr flags, CC-ALF
        Cb and Cr filter indices; the ALF APS bytes or None). With
        ``alf_chroma`` the frame's Wiener filters are derived and signalled in
        the APS; CC-ALF reads the pre-ALF luma (tmpYuv in ALFProcess)."""
        cfg, bd, lam = self.cfg, self.cfg.bit_depth, self.lam
        extra = luma_raw = chroma_raw = None
        luma_pre_pad = alf.pad4(self.recon_y) if cfg.ccalf else None
        if cfg.alf_chroma:
            luma_raw = alf.derive_luma_filters(y_orig, self.recon_y, bd, 128)
            chroma_raw = alf.derive_chroma_filter(org_u, org_v, self.recon_u,
                                                  self.recon_v, bd, 128)
            extra = [alf.reconstruct_coeff(luma_raw, None, bd, 25,
                                           delta_idx=np.arange(25))]
        flags, sets, new_y = alf.decide_alf_luma(y_orig, self.recon_y, bd, 128, lam,
                                                 extra_sets=extra)
        self.recon_y = new_y.astype(np.int32)
        cb = cr = cc_cb = cc_cr = cc_cb_coeff = cc_cr_coeff = None
        if cfg.alf_chroma:
            ccoeff, cclip = alf.reconstruct_coeff(chroma_raw[None, :], None, bd, 1)
            cb, new_u = alf.decide_alf_chroma(org_u, self.recon_u, ccoeff[0],
                                              cclip[0], bd, 128, lam)
            cr, new_v = alf.decide_alf_chroma(org_v, self.recon_v, ccoeff[0],
                                              cclip[0], bd, 128, lam)
            self.recon_u = new_u.astype(np.int32)
            self.recon_v = new_v.astype(np.int32)
        if cfg.ccalf:
            cc_cb_coeff = alf.derive_ccalf_filter(org_u, self.recon_u, luma_pre_pad,
                                                  bd, 128)
            cc_cr_coeff = alf.derive_ccalf_filter(org_v, self.recon_v, luma_pre_pad,
                                                  bd, 128)
            cc_cb, new_u = alf.decide_ccalf(org_u, self.recon_u, luma_pre_pad,
                                            cc_cb_coeff, bd, 128, lam)
            cc_cr, new_v = alf.decide_ccalf(org_v, self.recon_v, luma_pre_pad,
                                            cc_cr_coeff, bd, 128, lam)
            self.recon_u = new_u.astype(np.int32)
            self.recon_v = new_v.astype(np.int32)
        aps = None
        if cfg.alf_chroma or cfg.ccalf:
            aps = alf.alf_aps_nal(luma_raw, chroma_raw, ccalf_cb=cc_cb_coeff,
                                  ccalf_cr=cc_cr_coeff)
        for key, on in (("luma", flags), ("cb", cb), ("cr", cr), ("ccalf_cb", cc_cb),
                        ("ccalf_cr", cc_cr)):
            n = 0 if on is None else int(np.count_nonzero(on))
            self.alf_ctus[key] = self.alf_ctus.get(key, 0) + n
        return (flags, sets, cb, cr, cc_cb, cc_cr), aps

    # ---- frame -----------------------------------------------------------

    def encode_frame(self, y, u, v, qt_map=None, maps=None,
                     chroma_maps=None, poc: int = 0,
                     decide_fn=None, decide_c_fn=None):
        """Encode one frame. Returns (bitstream_bytes, recon (y,u,v)).

        ``maps``: optional (hor, ver, qt, dire) frame partition maps for
        full MTT map-driven coding; else ``qt_map`` drives QT-only coding.
        ``chroma_maps``: chroma-component maps for the dual chroma tree
        (defaults to ``maps``).  ``decide_fn``/``decide_c_fn``: explicit
        split deciders (override maps).
        """
        cfg = self.cfg
        if y.shape != (cfg.height, cfg.width):
            raise ValueError(f"luma plane {y.shape} is not {cfg.height}x{cfg.width}")
        # min-CB-multiple frames; boundary CTUs use implicit splits
        if cfg.width % 8 or cfg.height % 8:
            raise ValueError("frame sides must be multiples of 8")
        t0 = time.perf_counter()
        self._init_state()
        if decide_fn is not None:
            decide = decide_fn
        elif maps is not None:
            decide = self._map_decider(*maps)
        else:
            if qt_map is None:
                qt_map = np.ones((cfg.height // 8, cfg.width // 8), np.int32)
            decide = self._qt_map_decider(qt_map)
        decide = self._apply_ablations(decide)
        if cfg.dual_tree:
            cmaps = chroma_maps or maps
            if decide_c_fn is not None:
                decide_c = decide_c_fn
            elif cmaps is not None:
                decide_c = self._map_decider(*cmaps, chroma=True)
            else:
                cqt = (qt_map if qt_map is not None else
                       np.ones((cfg.height // 8, cfg.width // 8), np.int32))
                def decide_c(x, yy, w, h, state, _q=cqt):
                    if w > 64:
                        return Split.QT
                    if state.mtt_depth == 0 and w == h \
                            and w > cfg.chroma_min_qt:
                        pred = int(_q[min(yy, cfg.height - 1) // 8,
                                      min(x, cfg.width - 1) // 8]) + 1
                        if state.qt_depth < pred:
                            return Split.QT
                    return Split.NONE
            decide_c = self._apply_ablations(decide_c)
        # the coding pass records the bin-op stream: the SAO CTU syntax is
        # interleaved afterwards (EncSlice 2-pass), and the stream is
        # serialized by the native C finalizer in one call
        enc = RecordingEncoder()
        rc = ResidualCoder(enc, dep_quant=cfg.dep_quant,
                           sign_hiding=cfg.sign_hiding)
        y_orig = y.astype(np.int32)
        org = (y_orig, u.astype(np.int32), v.astype(np.int32))
        n_ctu_x = (cfg.width + 127) // 128
        n_ctu_y = (cfg.height + 127) // 128
        for cty in range(n_ctu_y):
            for ctx_i in range(n_ctu_x):
                bx, by = ctx_i * 128, cty * 128
                enc.mark_ctu()
                if not cfg.dual_tree:
                    self._encode_tree(enc, rc, org, bx, by,
                                      128, 128, SplitState(), decide)
                    continue
                # dual tree: implicit QT to 64, then per 64 quadrant the
                # luma tree followed by the chroma tree
                # (CABACWriter::coding_tree dual path, :431-470)
                for i, (qx, qy, qw, qh) in enumerate(
                        self._children(bx, by, 128, 128, Split.QT)):
                    if qx >= cfg.width or qy >= cfg.height:
                        continue
                    st = SplitState(last_split=Split.QT, qt_depth=1)
                    # the luma quadrant keeps its QT child index, as the
                    # wavefront's leaf walk from the CTU gives it: the
                    # device RDO keys its decisions by the full state (the
                    # JAX package's replay passes 0 for all four, and its
                    # dual-tree streams with RDO-decided quadrants 1-3 do
                    # not decode). The luma pass records the co-located
                    # 64x64 luma node's split into _luma_root_split
                    # (checkCCLMAllowed).
                    self._encode_tree_ch(enc, rc, org, qx, qy, qw, qh,
                                         SplitState(last_split=Split.QT,
                                                    qt_depth=1, part_idx=i),
                                         decide, False)
                    self._luma_root_isp = False     # no ISP on this path
                    self._encode_tree_ch(enc, rc, org, qx, qy, qw, qh,
                                         st, decide_c, True)
        self._time("replay", t0)
        t0 = time.perf_counter()
        if self.reshaper is not None:
            # picture-level inverse mapping before the in-loop filters
            # (DecLib::executeLoopFilters order: inverse LUT, deblock, SAO)
            self.recon_y = self.reshaper.inv(self.recon_y).astype(np.int32)
        if not cfg.deblocking_disabled:
            qpi = max(-self.qp_bd_offset, min(63, cfg.qp))
            qp_c_db = max(-self.qp_bd_offset,
                          min(63, int(self.qp_table[qpi + self.qp_bd_offset])
                              + cfg.chroma_qp_offset))
            qp_j_db = max(-self.qp_bd_offset,
                          min(63, int(self.qp_table[qpi + self.qp_bd_offset])
                              + cfg.jccr_qp_offset))
            deblock_frame(self.recon_y, self.recon_u, self.recon_v,
                          self.leaf_l, self.leaf_c, cfg.qp, qp_c_db,
                          bit_depth=cfg.bit_depth, ctu_size=cfg.ctu_size,
                          qp_c_joint=qp_j_db, joint2=self.unit_joint2)
        self._time("deblock", t0)
        t0 = time.perf_counter()
        final_ops = enc.ops
        if cfg.sao:
            # SAO compares against the ORIGINAL (unmapped) planes
            recs = [self.recon_y, self.recon_u, self.recon_v]
            sao_params = decide_sao_frame((y_orig, org[1], org[2]),
                                          recs, 128, cfg.qp,
                                          bit_depth=cfg.bit_depth,
                                          lam=self.lam)
            apply_sao_frame(recs, sao_params, 128, bit_depth=cfg.bit_depth)
        self._time("sao", t0)
        alf_aps = None
        if cfg.alf:
            t0 = time.perf_counter()
            (flags, sets, cb, cr, cc_cb, cc_cr), alf_aps = self._alf_frame(
                y_orig, org[1], org[2])
            self._time("alf", t0)
        t0 = time.perf_counter()
        if cfg.sao or cfg.alf:
            # pass 2: splice the SAO and ALF CTU syntax into the op stream
            # (CABACWriter::coding_tree_unit: sao(), then the ALF flags)
            pass2 = RecordingEncoder()
            marks = enc.ctu_marks + [len(enc.ops)]
            i = 0
            for cty in range(n_ctu_y):
                for cx_i in range(n_ctu_x):
                    if cfg.sao:
                        write_sao_ctu(pass2, sao_params[i], cx_i > 0,
                                      cty > 0, cfg.bit_depth)
                    if cfg.alf:
                        alf.write_alf_ctu(pass2, ctx, cty, cx_i, flags, sets,
                                          num_aps=1 if cfg.alf_chroma else 0,
                                          flags_cb=cb, flags_cr=cr)
                        if cfg.ccalf:
                            alf.write_ccalf_ctu(pass2, ctx, cty, cx_i, cc_cb, cc_cr)
                    pass2.ops.extend(enc.ops[marks[i]:marks[i + 1]])
                    i += 1
            final_ops = pass2.ops
        slice_data = self._finalize_ops(final_ops)

        out = bytearray()
        if poc == 0:
            out += sps_nal(cfg)
            out += pps_nal(cfg)
            if self.reshaper is not None:
                out += lmcs_aps_nal(self.reshaper.model)
        if alf_aps:
            out += alf_aps              # the frame's derived ALF filters
        out += slice_nal(cfg, poc, slice_data)
        out += decoded_picture_hash_sei(
            (self.recon_y, self.recon_u, self.recon_v), cfg.bit_depth)
        self._time("finalize", t0)
        return bytes(out), (self.recon_y.copy(), self.recon_u.copy(),
                            self.recon_v.copy())
