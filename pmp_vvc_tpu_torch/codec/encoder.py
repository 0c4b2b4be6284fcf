"""All-intra VVC frame encoder: the sequential ``FrameEncoder``, whose
syntax, coding tree and frame tail the wave path (``codec/wavefront.py``)
also replays its device decisions through.

A port of the JAX package's ``codec/encoder.py``: chroma QP table, slice
lambda and chroma distortion weight; the neighbour state; the CU coding —
luma mode choice (``mode_select`` "planar", "satd" or "rd": RMD over
``rmd_modes`` with MIP and MRL candidates, then with "rd" a true-RD trial
of the shortlist), ISP trials, the per-TU RD over DCT-2, MTS, LFNST and
transform skip with scalar or dependent quantization, the chroma mode
search with CCLM, the joint Cb-Cr trial and the LMCS chroma residual
scale, all costed against the running CABAC rate estimator; split,
intra-mode, residual, LFNST and MTS syntax; the coding-tree walks and split
deciders; the bin-op recorder and the native CABAC finalizer; and
``encode_frame``'s tail (LMCS inverse mapping, deblocking, SAO, ALF and
CC-ALF, NAL units with the LMCS and ALF APS, decoded-picture-hash SEI).

Each block's device work goes through the K10 kernels on ``device`` (the
card unless the caller passes ``device="cpu"``, which runs their plain
versions): K10a ``ops/intra.py:predict_block`` (a chroma CU's U and V
rows stacked into one call), K10b
``ops/mip.py:predict_mip_all``, K10c ``ops/quant.py:seq_tq`` (with its
one-stage forms) and K10d ``ops/distortion.py:satd``. The host reads every
result back: the RD decisions are host Python, as in the JAX package.

Syntax contracts: CABACWriter.cpp coding_tree_unit :158 / coding_tree :394 /
split_cu_mode :567 / coding_unit :660 / intra_luma_pred_modes :1057 /
intra_chroma_pred_mode :1259 / transform_unit :2406 / cbf_comp :2305;
MPM list UnitTools.cpp:591; QP derivation Quant.cpp QpParam :54.

Not ported: the RDO split search (``RDO`` nodes raise
``NotImplementedError``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import alf
from .._device import resolve_device
from .cabac import ContextStore
from .deblock import deblock_frame
from .estimator import RateEstimator
from .headers import (VVCConfig, decoded_picture_hash_sei, pps_nal, slice_nal,
                      sps_nal)
from .lmcs import (Reshaper, derive_ai_model, lmcs_aps_nal,
                   scale_chroma_residual_fwd, scale_chroma_residual_inv)
from .mtt import (SplitState, can_split_set, get_implicit_split,
                  write_split_cu_mode)
from .partition import MapPartitioner, PartitionConstraints, Split
from .residual import (ResidualCoder, TSResidualCoder, apply_sign_hiding, ctx,
                       grouped_scan, rd_quant_cleanup)
from .sao import apply_sao_frame, decide_sao_frame, write_sao_ctu
from ..ops import cclm as cclm_ops
from ..ops import depquant as dq_ops
from ..ops import intra as intra_ops
from ..ops import lfnst as lfnst_ops
from ..ops import mip as mip_ops
from ..ops.distortion import satd
from ..ops.quant import (DEQUANT, INV, ROUND_TRIP, dequantize, dequantize_ts,
                         forward_transform, inverse_transform, quantize,
                         quantize_ts, seq_tq, ts_qp)
from ..ops.transforms import DCT2, DCT8, DST7
from ..utils.stats import bin_stats


class RecordingEncoder:
    """Records the bin sequence of a slice-data pass for later replay.

    VTM writes the final bitstream in a second entropy pass after the
    in-loop filters are decided (EncSlice::encodeSlice); this captures
    pass 1 so pass 2 can interleave the SAO CTU syntax
    (CABACWriter::coding_tree_unit order: sao() first, :158).

    ``owner``: optional FrameEncoder — every recorded ctx bin also
    adapts ``owner.est`` (the live RateEstimator), so RD trials branched
    off the estimator always start from the true coding-position state
    (the CABACEstimator discipline of EncCu/IntraSearch). ``None`` (the
    wave path's replay, which needs no rates) records only.
    """

    def __init__(self, owner=None):
        self.ops = []
        self.ctu_marks = []
        self.owner = owner

    def mark_ctu(self):
        self.ctu_marks.append(len(self.ops))

    def encode_bin(self, v, ctx_id):
        self.ops.append(("b", v, ctx_id))
        o = self.owner
        if o is not None and o.est is not None:
            o.est.encode_bin(v, ctx_id)

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

    ``device``: where the K10 kernels run (``None``: the card, raising
    without CUDA when the first block is coded; ``"cpu"``: their plain
    versions). ``mode_select``,
    ``rmd_modes`` and ``rd_effort`` are the JAX package's. The counters
    ``n_mrl``, ``n_isp``, ``n_cclm``, ``n_nondm``, ``n_lfnst``, ``n_jccr``
    count each frame's choices, ``n_depquant`` the TUs (RD trials included)
    to which the dependent-quantization trellis gave a level; ``bin_stats``
    holds the bin statistics of ``encode_frame(collect_bin_stats=True)``.

    ``timings`` accumulates host seconds per stage of ``encode_frame``:
    ``code`` (the sequential CU coding with its coding-tree walk and CABAC
    bin recording; the wave path's replay of its device decisions is
    ``replay``), ``deblock`` (with
    LMCS, the inverse luma mapping first), ``sao`` (decision and filtering),
    ``alf`` (with ALF: the filters' derivation, decision and filtering, and
    CC-ALF's) and ``finalize`` (SAO and ALF syntax splice, native CABAC
    finalizer, NAL units, hash SEI). ``alf_ctus`` accumulates alike the CTUs
    with each ALF filter on: luma, Cb, Cr, CC-ALF Cb, CC-ALF Cr."""

    #: the CU coding reads the running CABAC rate estimator
    _rate_estimated = True

    def __init__(self, cfg: VVCConfig, *, mode_select: str = "satd",
                 rmd_modes: tuple | None = None, accel_level: int = 3,
                 rdo_fallback: bool = False, rd_effort: int = 1,
                 ablation_skip_mtt: bool = False, ablation_disturb=None,
                 device=None):
        self.cfg = cfg
        self._device_req, self._device = device, None
        self.mode_select = mode_select
        self.rmd_modes = tuple(rmd_modes or range(67))
        self.rd_effort = rd_effort
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
        # (distortion is measured at full internal bit depth, FULL_NBIT);
        # dep-quant adds 2^(0.25/3)
        # (EncSlice::calculateLambda)
        self.lam = 0.57 * 2.0 ** ((cfg.qp + 6 * (cfg.bit_depth - 8) - 12)
                                  / 3.0)
        if cfg.dep_quant:
            self.lam *= 2.0 ** (0.25 / 3.0)
        # chroma distortion weight 2^((qpY-qpC)/3) in user-QP scale
        # (EncSlice::setUpLambda), +2^(0.2/3) under dep-quant (GOP < 8)
        qpi = max(-self.qp_bd_offset, min(63, cfg.qp))
        qp_c = int(self.qp_table[qpi + self.qp_bd_offset]) \
            + cfg.chroma_qp_offset
        qp_c = max(-self.qp_bd_offset, min(63, qp_c))
        self.dw_c = 2.0 ** ((cfg.qp - qp_c) / 3.0)
        if cfg.dep_quant:
            self.dw_c *= 2.0 ** (0.2 / 3.0)
        self.est = None                 # running CABAC rate estimator
        self.bin_stats = None
        self.reshaper = Reshaper(derive_ai_model(cfg.bit_depth, cfg.lmcs_offset),
                                 cfg.bit_depth) if cfg.lmcs else None
        self.timings = {}
        self.alf_ctus = {}

    def _time(self, stage, t0):
        self.timings[stage] = self.timings.get(stage, 0.0) + time.perf_counter() - t0

    # ---- the K10 kernels on self.device ----------------------------------

    @property
    def device(self) -> torch.device:
        """The kernels' device, resolved at first use."""
        if self._device is None:
            self._device = resolve_device(self._device_req)
        return self._device

    def _dev(self, a) -> torch.Tensor:
        """A host array as an int32 tensor on ``self.device``."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    @staticmethod
    def _host(t) -> np.ndarray:
        """A result back on the host (a CUDA tensor's copy waits for it)."""
        return t.cpu().numpy()

    def _refs_dev(self, refs):
        """(top_u, left_u, top_f, left_f) (N, 2W+3) / (N, 2H+3) host rows
        as views of one upload; device tensors pass through."""
        if isinstance(refs[0], torch.Tensor):
            return refs
        flat = self._dev(np.concatenate([np.ravel(r) for r in refs]))
        out, off = [], 0
        for r in refs:
            out.append(flat[off:off + r.size].view(r.shape))
            off += r.size
        return tuple(out)

    def _predict(self, refs, w, h, modes, is_luma):
        """K10a: (N, M, h, w) predictions of ``modes`` on the device."""
        return intra_ops.predict_block(*self._refs_dev(refs), w=w, h=h,
                                       modes=tuple(modes), is_luma=is_luma,
                                       bit_depth=self.cfg.bit_depth)

    def _satd(self, org, preds) -> np.ndarray:
        """K10d: (K,) SATDs of (K, h, w) predictions against one block."""
        if not isinstance(org, torch.Tensor):
            org = self._dev(org)
        if not isinstance(preds, torch.Tensor):
            preds = self._dev(preds)
        return self._host(satd(org, preds, bit_depth=self.cfg.bit_depth))

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
        self.unit_isp = np.zeros((r4, c4), bool)
        self.n_cclm = 0                   # CUs that chose CCLM
        self.n_nondm = 0                  # CUs that chose a non-DM chroma mode
        self.n_lfnst = 0                  # CUs that chose LFNST
        self.n_mrl = 0                    # CUs that chose MRL
        self.n_jccr = 0                   # TUs that chose joint Cb-Cr
        self.n_isp = 0                    # CUs that chose ISP
        self.n_depquant = 0               # trellis runs that gave a level

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
        and mode first when MIP is on, then MRL and ISP."""
        if self.cfg.mip:
            # DeriveCtx::CtxMipFlag (ContextModelling.cpp:557)
            left = self._cu_at(cu.x - 1, cu.y)
            above = self._cu_at(cu.x, cu.y - 1)
            ctx_id = 0
            if left is not None and self.unit_mip[cu.y // 4,
                                                  (cu.x - 1) // 4]:
                ctx_id += 1
            if above is not None and self.unit_mip[(cu.y - 1) // 4,
                                                   cu.x // 4]:
                ctx_id += 1
            if cu.w > 2 * cu.h or cu.h > 2 * cu.w:
                ctx_id = 3
            enc.encode_bin(1 if cu.mip else 0, ctx("MipFlag", ctx_id))
            if cu.mip:
                enc.encode_bin_ep(1 if cu.mip_transpose else 0)
                self._write_trunc_bin(enc, cu.mip_mode,
                                      mip_ops.num_modes(cu.w, cu.h))
                return
        if self.cfg.mrl and cu.y % 128 != 0:
            # extend_ref_line (CABACWriter.cpp:979): not on the CTU top row
            enc.encode_bin(1 if cu.mrl != 0 else 0,
                           ctx("MultiRefLineIdx", 0))
            if cu.mrl != 0:
                enc.encode_bin(1 if cu.mrl != 1 else 0,
                               ctx("MultiRefLineIdx", 1))
        # isp_mode (CABACWriter.cpp:2752): after MRL, gated on mrl==0
        if self.cfg.isp and cu.mrl == 0 \
                and intra_ops.can_use_isp(cu.w, cu.h):
            enc.encode_bin(1 if cu.isp else 0, ctx("ISPMode", 0))
            if cu.isp:
                enc.encode_bin(cu.isp - 1, ctx("ISPMode", 1))
        mpm = self._mpm_list(cu)
        mpm_idx = mpm.index(cu.mode) if cu.mode in mpm else NUM_MPM
        if cu.mrl:
            assert 0 < mpm_idx < NUM_MPM, "MRL requires a non-planar MPM"
        else:
            enc.encode_bin(1 if mpm_idx < NUM_MPM else 0,
                           ctx("IntraLumaMpmFlag"))
        if mpm_idx < NUM_MPM:
            # not-planar flag: ctx 0 when ISP else 1; skipped for MRL
            if cu.mrl == 0:
                enc.encode_bin(1 if mpm_idx > 0 else 0,
                               ctx("IntraLumaPlanarFlag",
                                   0 if cu.isp else 1))
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

    def _mdlm_ext(self, x, y, w, h, coded):
        """(ext_top, ext_left) extra template lengths in chroma samples
        for MDLM_T / MDLM_L (above-right / left-below availability runs,
        capped at min(cW, cH); xGetLumaRecPixels :1731-1744)."""
        cfg = self.cfg
        ext_t = ext_l = 0
        max_units = min(w, h) // 4
        if y > 0:
            k = 0
            while k < max_units:
                lx = x + w + 4 * k
                if lx >= cfg.width or not coded[(y - 1) // 4, lx // 4]:
                    break
                k += 1
            ext_t = 2 * k
        if x > 0:
            k = 0
            while k < max_units:
                ly = y + h + 4 * k
                if ly >= cfg.height or not coded[ly // 4, (x - 1) // 4]:
                    break
                k += 1
            ext_l = 2 * k
        return ext_t, ext_l

    def _cclm_candidates(self, x, y, w, h, refs_u, refs_v, coded):
        """LM/MDLM_L/MDLM_T predictions: list of (symbol, pred_u, pred_v).

        (x, y, w, h) luma coords of the chroma CU; refs_u/refs_v the
        substituted chroma reference tuples from _refs_for_block."""
        cfg = self.cfg
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        la, aa = cx > 0, cy > 0
        interior, dsa, dsl = cclm_ops.downsample_luma(
            self.recon_y, cx, cy, cw, chh, la, aa, 128)
        out = []

        def pred_pair(param_fn):
            preds = []
            for refs_c in (refs_u, refs_v):
                a, b, sh = param_fn(np.asarray(refs_c[0][0]),
                                    np.asarray(refs_c[1][0]))
                preds.append(cclm_ops.cclm_pred(interior, a, b, sh,
                                                cfg.bit_depth))
            return preds

        out.append((0, *pred_pair(
            lambda t, l: cclm_ops.lm_parameters(
                dsa, dsl, t, l, cw, chh, aa, la, cfg.bit_depth))))
        ext_t, ext_l = self._mdlm_ext(x, y, w, h, coded)
        al = chh + min(ext_l, cw) if la else 0       # MDLM_L template
        at = cw + min(ext_t, chh) if aa else 0       # MDLM_T template
        ds_left_ext = cclm_ops.downsample_left(self.recon_y, cx, cy, al) \
            if al else None
        ds_above_ext = cclm_ops.downsample_above(
            self.recon_y, cx, cy, at, la, 128) if at else None
        out.append((1, *pred_pair(
            lambda t, l: cclm_ops.mdlm_parameters(
                False, ds_left_ext, l, al, cfg.bit_depth))))
        out.append((2, *pred_pair(
            lambda t, l: cclm_ops.mdlm_parameters(
                True, ds_above_ext, t, at, cfg.bit_depth))))
        return out

    #: RD-trialled shortlist size of the chroma mode search
    CHROMA_RD_CANDS = 3

    def _choose_chroma(self, cu: CuInfo, x, y, w, h, refs_u, refs_v,
                       coded, cclm_ok, dm_mode, qp_c, crs,
                       org_cu, org_cv):
        """Chroma mode search over the full candidate list — DM, the
        non-DM {planar, ver, hor, DC} list (VDIA replacement), and the
        three CCLM/MDLM modes: SATD preselect, then a true-RD trial of
        the shortlist (IntraSearch::estIntraPredChromaQT,
        IntraSearch.cpp:1224-1400; shortlist simplification of its
        full-list RD loop).

        Sets ``cu.cclm`` / ``cu.lm_symbol`` / ``cu.chroma_mode`` and
        returns the winning ``(pred_u, pred_v)``."""
        cfg = self.cfg
        bd = cfg.bit_depth
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        full = self.mode_select != "planar"
        modes = [dm_mode] + (self._chroma_cand_list(dm_mode)
                             if full else [])
        # U's and V's rows stacked: one K10a launch and one read-back
        refs_uv = tuple(np.concatenate(pair) for pair in zip(refs_u, refs_v))
        pu_all, pv_all = self._host(self._predict(refs_uv, cw, chh, modes, False))
        if not full and not cclm_ok:
            cu.cclm, cu.lm_symbol, cu.chroma_mode = False, 0, None
            return pu_all[0].astype(np.int32), pv_all[0].astype(np.int32)
        # (satd, kind, payload, pred_u, pred_v); kind 'dm'|'mode'|'cclm';
        # one K10d launch scores every candidate of a plane
        entries = [("dm" if i == 0 else "mode", None if i == 0 else m,
                    pu_all[i].astype(np.int32), pv_all[i].astype(np.int32))
                   for i, m in enumerate(modes)]
        if cclm_ok:
            entries += [("cclm", sym, pu_.astype(np.int32),
                         pv_.astype(np.int32))
                        for sym, pu_, pv_ in self._cclm_candidates(
                            x, y, w, h, refs_u, refs_v, coded)]
        su = self._satd(org_cu, np.stack([e[2] for e in entries]))
        sv = self._satd(org_cv, np.stack([e[3] for e in entries]))
        cands = [(int(a) + int(b), *e) for a, b, e in zip(su, sv, entries)]
        cands.sort(key=lambda t: t[0])
        # fast path (test configs): SATD argmin only, no RD trials
        short = cands[:self.CHROMA_RD_CANDS] if full else cands[:1]
        best = None
        if len(short) > 1:
            for _c, kind, payload, pu, pv in short:
                cbf_u, lev_u, rec_u, _, _ = self._code_tu_component(
                    None, org_cu, pu, cx, cy, cw, chh, qp_c, False,
                    chroma_scale=crs)
                cbf_v, lev_v, rec_v, _, _ = self._code_tu_component(
                    None, org_cv, pv, cx, cy, cw, chh, qp_c, False,
                    chroma_scale=crs,
                    cbf_ctx=("QtCbf2", 1 if cbf_u else 0))
                est = self.est.clone()
                f0 = est.frac
                self._write_intra_chroma_mode(
                    est, cclm=kind == "cclm", cclm_allowed=cclm_ok,
                    lm_symbol=payload if kind == "cclm" else 0,
                    chroma_mode=payload if kind == "mode" else None,
                    luma_mode=dm_mode)
                bits = (est.frac - f0) / 32768.0 \
                    + self._est_tu_bits(lev_u if cbf_u else None,
                                        ("QtCbf1", 0), False) \
                    + self._est_tu_bits(lev_v if cbf_v else None,
                                        ("QtCbf2", 1 if cbf_u else 0),
                                        False)
                eu = rec_u.astype(np.int64) - org_cu
                ev = rec_v.astype(np.int64) - org_cv
                cost = self.dw_c * float((eu * eu).sum()
                                         + (ev * ev).sum()) \
                    + self.lam * bits
                if best is None or cost < best[0]:
                    best = (cost, kind, payload, pu, pv)
        else:
            best = (0.0, *short[0][1:])
        _, kind, payload, pu, pv = best
        cu.cclm = kind == "cclm"
        cu.lm_symbol = payload if kind == "cclm" else 0
        cu.chroma_mode = payload if kind == "mode" else None
        if cu.cclm:
            self.n_cclm += 1
        if cu.chroma_mode is not None:
            self.n_nondm += 1
        return pu, pv

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

    # ---- prediction + residual ------------------------------------------

    def _refs_for_block(self, plane, x, y, w, h, scale, bit_depth,
                        coded=None):
        """Build (top_u, left_u, top_f, left_f) (1, 2W+3)/(1, 2H+3) arrays."""
        fw = self.cfg.width // scale
        fh = self.cfg.height // scale
        coded = self.coded if coded is None else coded

        def avail_row(px0, py, n):  # horizontal run at row py
            out = np.zeros(n, bool)
            if 0 <= py < fh:
                xs = np.arange(px0, px0 + n)
                ok = (xs >= 0) & (xs < fw)
                cs = np.clip(xs * scale // 4, 0, coded.shape[1] - 1)
                out[ok] = coded[py * scale // 4, cs[ok]]
            return out

        def avail_col(px, py0, n):
            out = np.zeros(n, bool)
            if 0 <= px < fw:
                ys = np.arange(py0, py0 + n)
                ok = (ys >= 0) & (ys < fh)
                rs = np.clip(ys * scale // 4, 0, coded.shape[0] - 1)
                out[ok] = coded[rs[ok], px * scale // 4]
            return out

        top_raw = np.zeros((1, 2 * w), np.int32)
        avail_top = avail_row(x, y - 1, 2 * w)[None]
        if y > 0:
            span = min(2 * w, fw - x)
            top_raw[0, :span] = plane[y - 1, x:x + span]
        left_raw = np.zeros((1, 2 * h), np.int32)
        avail_left = avail_col(x - 1, y, 2 * h)[None]
        if x > 0:
            span = min(2 * h, fh - y)
            left_raw[0, :span] = plane[y:y + span, x - 1]
        corner = np.zeros((1,), np.int32)
        avail_c = avail_row(x - 1, y - 1, 1)
        if avail_c[0]:
            corner[0] = plane[y - 1, x - 1]
        # numpy substitution + smoothing (host-side prep; the jitted
        # variant cost ~1 ms/TU in dispatch for these tiny arrays)
        scan_vals = np.concatenate([left_raw[0][::-1], corner,
                                    top_raw[0]]).astype(np.int64)
        scan_avail = np.concatenate([avail_left[0][::-1], avail_c,
                                     avail_top[0]])
        h2, w2 = 2 * h, 2 * w
        if not scan_avail.any():
            filled = np.full(scan_vals.shape, 1 << (bit_depth - 1),
                             np.int64)
        else:
            idx = np.where(scan_avail, np.arange(len(scan_vals)), -1)
            idx = np.maximum.accumulate(idx)
            idx[idx < 0] = int(np.argmax(scan_avail))
            filled = scan_vals[idx]
        left = filled[:h2 + 1][::-1]
        top = filled[h2:]
        top = np.concatenate([top, top[-1:], top[-1:]])[None]
        left = np.concatenate([left, left[-1:], left[-1:]])[None]

        def smooth(row):
            mid = (row[:, :-2] + 2 * row[:, 1:-1] + row[:, 2:] + 2) >> 2
            last_real = row.shape[1] - 3
            return np.concatenate(
                [cref[:, None], mid[:, :last_real - 1], row[:, last_real:]],
                axis=1)
        cref = (top[:, 0] + top[:, 1] + left[:, 0] + left[:, 1] + 2) >> 2
        return top, left, smooth(top), smooth(left)

    def _mrl_refs(self, x, y, w, h, mri):
        """Substituted reference line ``mri`` (xFillReferenceSamples with
        the +mri extents): (top, left), index 0 = corner of line mri."""
        plane = self.recon_y
        cfg = self.cfg
        fw, fh = cfg.width, cfg.height
        n_top = 2 * w + mri
        n_left = 2 * h + mri
        top_raw = np.zeros(n_top, np.int64)
        left_raw = np.zeros(n_left, np.int64)
        ty, tx0 = y - 1 - mri, x - mri
        avail_t = np.zeros(n_top, bool)
        if 0 <= ty < fh:
            cols = np.arange(tx0, tx0 + n_top)
            ok = (cols >= 0) & (cols < fw)
            avail_t[ok] = self.coded[ty // 4, cols[ok] // 4]
            top_raw[ok] = plane[ty, cols[ok]]
        lx, ly0 = x - 1 - mri, y - mri
        avail_l = np.zeros(n_left, bool)
        if 0 <= lx < fw:
            rows = np.arange(ly0, ly0 + n_left)
            ok = (rows >= 0) & (rows < fh)
            avail_l[ok] = self.coded[rows[ok] // 4, lx // 4]
            left_raw[ok] = plane[rows[ok], lx]
        corner = 0
        avail_c = False
        if ty >= 0 and lx >= 0:
            avail_c = bool(self.coded[ty // 4, lx // 4])
            corner = int(plane[ty, lx])
        scan_v = np.concatenate([left_raw[::-1], [corner], top_raw])
        scan_a = np.concatenate([avail_l[::-1], [avail_c], avail_t])
        sub = intra_ops.substitute_line(scan_v, scan_a, cfg.bit_depth)
        left_s = np.concatenate([sub[n_left:n_left + 1],
                                 sub[:n_left][::-1]])
        top_s = sub[n_left:]
        return top_s, left_s

    def _choose_luma_mode(self, org, refs, w, h):
        if self.mode_select == "planar":
            return PLANAR
        preds = self._predict(refs, w, h, self.rmd_modes, True)  # (1, M, h, w)
        costs = self._satd(org, preds[0])
        return int(self.rmd_modes[int(np.argmin(costs))])

    def _choose_luma(self, cu: CuInfo, org, refs, w, h):
        """Pick the luma mode; fills cu and returns the pred.

        mode_select "satd": RMD argmin (+ MIP by SATD).  "rd": VTM-style
        two-stage — SATD shortlist (top 3 + MPMs + best MIP), then true
        transform-quant RD (IntraSearch::estIntraPredLumaQT's structure,
        single-pass simplification)."""
        cfg = self.cfg
        if self.mode_select == "planar":
            cu.mode = PLANAR
            return self._host(self._predict(refs, w, h, (PLANAR,), True)[0, 0])
        refs_d = self._refs_dev(refs)
        preds = self._predict(refs_d, w, h, self.rmd_modes, True)  # (1, M, h, w)
        org_d = self._dev(org)
        costs = self._satd(org_d, preds[0])
        order = np.argsort(costs)
        best_ang = int(self.rmd_modes[int(order[0])])

        mip_best = None
        if cfg.mip:
            mip_preds = mip_ops.predict_mip_all(
                refs_d[0][0], refs_d[1][0], w=w, h=h,
                bit_depth=cfg.bit_depth)              # (2M, h, w)
            mc = self._satd(org_d, mip_preds)
            mip_best = (int(np.argmin(mc)), int(mc.min()))

        mrl_best = None
        if cfg.mrl and cu.y % 128 != 0:
            # every (line, MPM) candidate scored in one K10d launch; the
            # first minimum in this order wins, as in a loop with a strict <
            mpm = self._mpm_list(cu)
            mrl_cands = []
            for mri in (1, 2):
                mtop, mleft = self._mrl_refs(cu.x, cu.y, w, h, mri)
                for m in mpm[1:]:
                    if m == PLANAR:
                        continue
                    mrl_cands.append((m, mri, intra_ops.predict_mrl(
                        mtop, mleft, w=w, h=h, mode=m, mri=mri,
                        bit_depth=cfg.bit_depth)))
            mc = self._satd(org_d, np.stack([c[2] for c in mrl_cands]))
            k = int(np.argmin(mc))
            mrl_best = (int(mc[k]), *mrl_cands[k])

        if self.mode_select != "rd":
            best_c = int(costs[order[0]])
            if mip_best is not None and mip_best[1] < best_c \
                    and (mrl_best is None or mip_best[1] <= mrl_best[0]):
                n = mip_ops.num_modes(w, h)
                cu.mip = True
                cu.mip_transpose = mip_best[0] >= n
                cu.mip_mode = mip_best[0] % n
                cu.mode = PLANAR      # neighbour MPM / chroma DM view
                return self._host(mip_preds[mip_best[0]])
            if mrl_best is not None and mrl_best[0] < best_c:
                cu.mode = mrl_best[1]
                cu.mrl = mrl_best[2]
                self.n_mrl += 1
                return mrl_best[3].astype(np.int32)
            cu.mode = best_ang
            return self._host(preds[0, int(order[0])])

        # ---- stage 2: true RD over the shortlist ----
        # estIntraPredLumaQT's structure: SATD shortlist -> per-candidate
        # transform-quant trial costed as SSE + lambda * estimated CABAC
        # bits of (intra mode syntax + cbf + residual), from the live
        # context state
        mpm = self._mpm_list(cu)
        cands = []
        n_satd = 3 if w * h >= 256 else 4
        for i in order[:n_satd]:
            m = int(self.rmd_modes[int(i)])
            if m not in cands:
                cands.append(m)
        for m in mpm[:4]:
            if m not in cands:
                cands.append(m)
        lam = self.lam
        qp_y = cfg.qp + self.qp_bd_offset
        cand_preds = self._host(self._predict(refs_d, w, h, cands,
                                              True)[0])    # (K, h, w)

        def _rd(pr, mode, mip=False, mip_mode=0, mip_t=False, mrl=0):
            resid = org.astype(np.int32) - pr
            lev, rec = self._tq_roundtrip(resid, w, h, qp_y, 0)
            err = rec.astype(np.int64) - resid
            tmp = CuInfo(cu.x, cu.y, w, h, cu.qt_depth, mode=mode,
                         mip=mip, mip_mode=mip_mode, mip_transpose=mip_t,
                         mrl=mrl)
            est = self.est.clone()
            self._write_intra_luma_mode(est, tmp)
            base = est.frac
            bits_mode = (base - self.est.frac) / 32768.0
            bits_tu = self._est_tu_bits(
                lev if lev.any() else None, ("QtCbf0", 0), True)
            return float((err * err).sum()) + lam * (bits_mode + bits_tu)

        best = None
        for k, m in enumerate(cands):
            pr = cand_preds[k]
            cost = _rd(pr, m)
            if best is None or cost < best[0]:
                best = (cost, m, False, 0, False, 0, pr)
        if mip_best is not None:
            n = mip_ops.num_modes(w, h)
            pr = self._host(mip_preds[mip_best[0]]).astype(np.int32)
            cost = _rd(pr, PLANAR, mip=True, mip_mode=mip_best[0] % n,
                       mip_t=mip_best[0] >= n)
            if cost < best[0]:
                best = (cost, PLANAR, True, mip_best[0] % n,
                        mip_best[0] >= n, 0, pr)
        if mrl_best is not None:
            pr = mrl_best[3].astype(np.int32)
            cost = _rd(pr, mrl_best[1], mrl=mrl_best[2])
            if cost < best[0]:
                best = (cost, mrl_best[1], False, 0, False, mrl_best[2], pr)
        (_, cu.mode, cu.mip, cu.mip_mode, cu.mip_transpose, cu.mrl,
         pr) = best
        if cu.mrl:
            self.n_mrl += 1
        return pr

    # mtsIdx -> (trTypeHor, trTypeVer); TypeDef MtsType order
    _MTS_TR = {0: (DCT2, DCT2), 2: (DST7, DST7), 3: (DCT8, DST7),
               4: (DST7, DCT8), 5: (DCT8, DCT8)}

    def _tq_roundtrip(self, resid, w, h, qp, mts_idx, lfnst_idx=0,
                      intra_mode=0, tr_kinds=None, is_luma=True):
        bd = self.cfg.bit_depth
        if mts_idx == 1:       # MTS_SKIP: identity transform + TS quant
            qpt = ts_qp(qp, self.cfg.internal_minus_input)
            lev = quantize_ts(resid, qpt)
            if lev.any():
                rec_resid = dequantize_ts(lev, qpt)
            else:
                rec_resid = np.zeros_like(resid)
            return lev, rec_resid
        th, tv = tr_kinds if tr_kinds is not None else self._MTS_TR[mts_idx]
        if lfnst_idx == 0 and not self.cfg.dep_quant:
            # fused path (the common case): one K10c launch returns the
            # coefficients, levels, dequantised coefficients and residual
            coef_j, lev, _, rec_resid = self._host(seq_tq(
                self._dev(resid), ROUND_TRIP, kind_h=th, kind_v=tv, qp=qp,
                bit_depth=bd))
            dirty = False
            if self.cfg.rd_quant and lev.any():
                lev2 = rd_quant_cleanup(lev, coef_j, w, h, qp, bd, self.lam)
                dirty = lev2 is not lev
                lev = lev2
            if self.cfg.sign_hiding and lev.any():
                lev2 = apply_sign_hiding(lev, coef_j, w, h, qp, bd)
                if not np.array_equal(lev2, lev):
                    lev = lev2
                    dirty = True
            if dirty:
                if lev.any():
                    rec_resid = self._host(seq_tq(
                        self._dev(lev), DEQUANT | INV, kind_h=th, kind_v=tv,
                        qp=qp, bit_depth=bd)[1])
                else:
                    rec_resid = np.zeros_like(resid)
            return lev, rec_resid
        coef = self._host(forward_transform(self._dev(resid), th, tv,
                                            bit_depth=bd))
        if lfnst_idx:
            # secondary transform (DCT2 primary only, TrQuant.cpp:1066)
            coef = lfnst_ops.fwd_lfnst(coef, intra_mode, lfnst_idx,
                                       w, h).astype(np.int32)
        if self.cfg.dep_quant:
            scan = grouped_scan(w, h)[:, 0]
            lev = dq_ops.dep_quant_trellis(
                coef, scan, w=w, h=h, qp=qp, bit_depth=bd,
                lam=self.lam if is_luma else self.lam / self.dw_c,
                est=self.est, is_luma=is_luma).astype(np.int32)
            self.n_depquant += bool(lev.any())
        else:
            lev = self._host(quantize(self._dev(coef), w=w, h=h, qp=qp,
                                      bit_depth=bd))
            if self.cfg.sign_hiding:
                lev = apply_sign_hiding(lev, coef, w, h, qp, bd)
        if lev.any():
            if self.cfg.dep_quant:
                deq = dq_ops.dep_dequant(lev, scan, w=w, h=h, qp=qp,
                                         bit_depth=bd).astype(np.int32)
            else:
                deq = self._host(dequantize(self._dev(lev), w=w, h=h, qp=qp,
                                            bit_depth=bd))
            if lfnst_idx:
                deq = lfnst_ops.inv_lfnst(deq, intra_mode, lfnst_idx,
                                          w, h).astype(np.int32)
            rec_resid = self._host(inverse_transform(self._dev(deq), th, tv,
                                                     bit_depth=bd))
        else:
            rec_resid = np.zeros_like(resid)
        return lev, rec_resid

    # ---- ISP (intra sub-partitions) ---------------------------------------

    @staticmethod
    def _isp_deblock_units(x, y, w, h, isp):
        """Deblocking units of an ISP CU: sub-TU edges are transform
        edges (LoopFilter xSetEdgefilterMultiple TU pass), restricted to
        the 4-sample deblocking grid (1/2-wide sub-TUs merge into 4-wide
        units)."""
        if isp == 2:
            tw = intra_ops.isp_split_dim(w, h, False)
            step = max(tw, 4)
            return [(x + i * step, y, step, h) for i in range(w // step)]
        th_ = intra_ops.isp_split_dim(w, h, True)
        step = max(th_, 4)
        return [(x, y + i * step, w, step) for i in range(h // step)]

    @staticmethod
    def _isp_subs(w, h, isp):
        """Sub-TU geometry (dx, dy, tw, th) list; isp 1=HOR, 2=VER."""
        if isp == 2:
            tw = intra_ops.isp_split_dim(w, h, False)
            return [(i * tw, 0, tw, h) for i in range(w // tw)]
        th_ = intra_ops.isp_split_dim(w, h, True)
        return [(0, i * th_, w, th_) for i in range(h // th_)]

    def _isp_tr_kinds(self, tw, th_):
        """getTrTypes ISP branch (TrQuant.cpp): DST7 per dim in [4,16],
        only when SPS MTS is enabled; no LFNST with ISP in this encoder."""
        if not self.cfg.mts_intra:
            return (DCT2, DCT2)
        kh = DST7 if 4 <= tw <= 16 else DCT2
        kv = DST7 if 4 <= th_ <= 16 else DCT2
        return (kh, kv)

    def _isp_region_refs(self, cu, ver, r, pw, ph, fill_top, fill_left):
        """References for ISP prediction region ``r``
        (initIntraPatternChTypeISP, IntraPrediction.cpp:857-974).

        Region 0 uses the CU-level fill with per-region length adjustment;
        later regions shift the CU-level buffer and splice the previous
        region's reconstructed boundary row/column.  Returns (top, left)
        1-D int64 arrays, index 0 = corner, 2 replication slots appended.
        """
        W, H = cu.w, cu.h
        rec = self.recon_y
        if ver:
            x0 = cu.x + r * pw
            top_len = W + pw                    # m_topRefLength
            if r == 0:
                top = np.concatenate([fill_top[:top_len + 1],
                                      np.repeat(fill_top[top_len], 2)])
                return top, fill_left.copy()
            above_ok = cu.y > 0 and bool(self.coded[(cu.y - 1) // 4,
                                                    x0 // 4])
            src = rec[cu.y:cu.y + H, x0 - 1].astype(np.int64)
            if above_ok:
                shifted = fill_top[r * pw: r * pw + top_len + 1]
            else:
                shifted = np.full(top_len + 1, src[0], np.int64)
            top = np.concatenate([shifted, np.repeat(shifted[-1], 2)])
            left = np.empty(2 * H + 3, np.int64)
            left[0] = shifted[0]
            left[1:H + 1] = src
            left[H + 1:] = src[-1]
            return top, left
        y0 = cu.y + r * ph
        left_len = H + ph                       # m_leftRefLength
        if r == 0:
            left = np.concatenate([fill_left[:left_len + 1],
                                   np.repeat(fill_left[left_len], 2)])
            return fill_top.copy(), left
        left_ok = cu.x > 0 and bool(self.coded[y0 // 4, (cu.x - 1) // 4])
        src = rec[y0 - 1, cu.x:cu.x + W].astype(np.int64)
        if left_ok:
            lshift = fill_left[r * ph: r * ph + left_len + 1]
        else:
            lshift = np.full(left_len + 1, src[0], np.int64)
        left = np.concatenate([lshift, np.repeat(lshift[-1], 2)])
        top = np.empty(2 * W + 3, np.int64)
        top[0] = lshift[0]
        top[1:W + 1] = src
        top[W + 1:] = src[-1]
        return top, left

    def _code_isp_trial(self, cu, org_y, qp_y, isp):
        """Code ISP split ``isp`` with mode cu.mode, writing recon into
        self.recon_y (caller restores on reject).  Returns
        {cost, subs=[(cbf, lev, (x, y, tw, th))], nnz} or None if every
        sub-TU is all-zero (the inferred last cbf forbids that)."""
        cfg = self.cfg
        x, y, W, H = cu.x, cu.y, cu.w, cu.h
        ver = isp == 2
        subs = self._isp_subs(W, H, isp)
        tw, th_ = subs[0][2], subs[0][3]
        kinds = self._isp_tr_kinds(tw, th_)
        pw = max(tw, 4) if ver else W           # pred-region dims
        ph = H if ver else th_
        refs = self._refs_for_block(self.recon_y, x, y, W, H, 1,
                                    cfg.bit_depth)
        fill_top = np.asarray(refs[0][0], np.int64)
        fill_left = np.asarray(refs[1][0], np.int64)

        lam = self.lam
        out = []
        cost = 0.0
        region_pred = None
        # sub-TU cbf + residual bits on a local estimator advanced across
        # sub-TUs (ISP cbf ctx 2+prev; last inferred when all prior zero)
        est = self.est.clone()
        rc_e = ResidualCoder(est, dep_quant=cfg.dep_quant,
                             sign_hiding=cfg.sign_hiding)
        n_subs = len(subs)
        prev_cbf = False
        any_cbf = False
        for si, (dx, dy, sw, sh) in enumerate(subs):
            off = dx if ver else dy
            if off % (pw if ver else ph) == 0:
                r = off // (pw if ver else ph)
                top, left = self._isp_region_refs(cu, ver, r, pw, ph,
                                                  fill_top, fill_left)
                region_pred = intra_ops.predict_isp(
                    top, left, cu_w=W, cu_h=H, pw=pw, ph=ph,
                    mode=cu.mode, bit_depth=cfg.bit_depth)
            if ver:
                pred = region_pred[:, off % pw: off % pw + sw]
            else:
                pred = region_pred
            sx, sy = x + dx, y + dy
            org = org_y[sy:sy + sh, sx:sx + sw].astype(np.int32)
            resid = org - pred.astype(np.int32)
            lev, rec_resid = self._tq_roundtrip(resid, sw, sh, qp_y, 0,
                                                tr_kinds=kinds)
            recon = np.clip(pred.astype(np.int32) + rec_resid, 0,
                            (1 << cfg.bit_depth) - 1)
            self.recon_y[sy:sy + sh, sx:sx + sw] = recon
            err = recon.astype(np.int64) - org
            cbf = bool(lev.any())
            f0 = est.frac
            inferred = si == n_subs - 1 and not any_cbf
            if not inferred:
                est.encode_bin(1 if cbf else 0,
                               ctx("QtCbf0", 2 + (1 if prev_cbf else 0)))
            if cbf:
                rc_e.code(lev, is_luma=True)
            cost += float((err * err).sum()) \
                + lam * (est.frac - f0) / 32768.0
            prev_cbf = cbf
            any_cbf = any_cbf or cbf
            out.append((cbf, lev, (sx, sy, sw, sh)))
        if not any_cbf:
            return None
        return {"cost": cost, "subs": out}

    def _maybe_isp(self, cu, org_y, qp_y, cost_base):
        """Trial HOR/VER ISP vs the committed non-ISP coding.

        Returns None (keep non-ISP; recon restored) or the winning trial
        dict with cu.isp set and recon left in place."""
        cfg = self.cfg
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        saved = self.recon_y[y:y + h, x:x + w].copy()
        best = None
        for isp in (1, 2):
            trial = self._code_isp_trial(cu, org_y, qp_y, isp)
            if trial is not None and trial["cost"] < cost_base and \
                    (best is None or trial["cost"] < best[1]["cost"]):
                best = (isp, trial,
                        self.recon_y[y:y + h, x:x + w].copy())
            self.recon_y[y:y + h, x:x + w] = saved
        if best is None:
            return None
        cu.isp = best[0]
        self.recon_y[y:y + h, x:x + w] = best[2]
        self.n_isp += 1
        return best[1]

    def _write_isp_tus(self, enc, rc, trial, before_last_cbf=None,
                       after_last_cbf=None):
        """ISP luma sub-TU syntax: per sub-TU cbf (ISP contexts 2+prev,
        CtxQtCbf; last inferred =1 if all previous zero) + residual.

        Single-tree hooks (transform_unit order for the last sub-TU which
        carries the chroma blocks): ``before_last_cbf`` emits cbf_cb /
        cbf_cr; ``after_last_cbf`` emits the joint_cb_cr flag (between
        cbf_luma and the luma residual)."""
        subs = trial["subs"]
        n = len(subs)
        prev = False
        any_prev = False
        comps = []
        for k, (cbf, lev, (sx, sy, sw, sh)) in enumerate(subs):
            is_last = k == n - 1
            if is_last and before_last_cbf is not None:
                before_last_cbf()
            inferred = is_last and not any_prev
            if not inferred:
                enc.encode_bin(1 if cbf else 0,
                               ctx("QtCbf0", 2 + (1 if prev else 0)))
            if is_last and after_last_cbf is not None:
                after_last_cbf()
            if cbf:
                rc.code(lev, is_luma=True)
                comps.append((sw, sh, lev))
            prev = cbf
            any_prev = any_prev or cbf
        return comps

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

    def _est_tu_bits(self, lev, cbf_ctx, is_luma, extra=None,
                     ts=False, ts_allowed=False) -> float:
        """Estimated rate (bits) of coding ``cbf + residual`` for one TU
        component starting from the current CABAC context state
        (CABACEstimator discipline: IntraSearch xGetIntraFracBitsQT).

        ``cbf_ctx``: (set name, inc) of the cbf bin; None skips the cbf
        bin (inferred cbf).  ``extra(est)``: optional callback writing
        trailing syntax (mts_idx / lfnst_idx bins) into the estimator.
        ``ts_allowed``/``ts``: include the ts_flag bin / use the TS
        residual coder."""
        est = self.est.clone()
        cbf = lev is not None and bool(lev.any())
        if cbf_ctx is not None:
            est.encode_bin(1 if cbf else 0, ctx(*cbf_ctx))
        if cbf:
            if ts_allowed:
                est.encode_bin(1 if ts else 0,
                               ctx("TransformSkipFlag",
                                   0 if is_luma else 1))
            if ts:
                TSResidualCoder(est).code(lev, is_luma=is_luma)
            else:
                ResidualCoder(est, dep_quant=self.cfg.dep_quant,
                              sign_hiding=self.cfg.sign_hiding).code(
                                  lev, is_luma=is_luma)
        if extra is not None:
            extra(est)
        return (est.frac - self.est.frac) / 32768.0

    def _code_tu_component(self, enc_rc, org, pred, x, y, w, h, qp, is_luma,
                           try_mts=False, try_lfnst=False, intra_mode=0,
                           chroma_scale=None, cbf_ctx=None,
                           allow_zero=True, try_ts=False):
        """Returns (cbf, levels, recon, mts_idx, lfnst_idx); mts_idx 1
        means transform skip (MTS_SKIP) was chosen.

        Candidate transforms are compared by true RD cost: SSE (in the
        residual domain) + lambda * estimated CABAC bits of cbf +
        residual + transform-index syntax, from the live context state
        (IntraSearch::xIntraCodingTUBlock + xGetIntraFracBitsQT roles).
        A null-cbf candidate competes too unless ``allow_zero=False``.

        ``chroma_scale``: LMCS chroma-residual scale (CSCALE_FP_PREC fixed
        point) — residual forward-scaled before the transform, recon via
        the decoder's inverse scaling (DecCu.cpp scaleSignal call)."""
        if cbf_ctx is None:
            cbf_ctx = ("QtCbf0", 0) if is_luma else ("QtCbf1", 0)
        resid = org.astype(np.int32) - np.asarray(pred, np.int32)
        if chroma_scale is not None:
            resid = scale_chroma_residual_fwd(resid, chroma_scale,
                                              self.cfg.bit_depth)
        candidates = [(0, 0)]
        ts_allowed = self._ts_allowed(w, h, is_luma)
        if try_ts and ts_allowed:
            candidates.append((1, 0))          # MTS_SKIP trial
        if try_mts:
            candidates += [(m, 0) for m in (2, 3, 4, 5)]
        if try_lfnst and w >= 4 and h >= 4:
            candidates += [(0, 1), (0, 2)]
        lam = self.lam
        dw = 1.0 if is_luma else self.dw_c
        best = None
        zero_err = resid.astype(np.int64)
        if allow_zero:
            cost0 = dw * float((zero_err * zero_err).sum()) \
                + lam * self._est_tu_bits(None, cbf_ctx, is_luma)
            best = (cost0, 0, 0, np.zeros_like(resid), np.zeros_like(resid))
        for mts_idx, lfnst_idx in candidates:
            lev, rec_resid = self._tq_roundtrip(resid, w, h, qp, mts_idx,
                                                lfnst_idx, intra_mode,
                                                is_luma=is_luma)
            if mts_idx > 1 or lfnst_idx != 0:
                # decoder infers DCT2/no-LFNST unless last scan pos >= 1
                # (mtsLastScanPos / lfnstLastScanPos); skip unusable cands
                scan = grouped_scan(w, h)
                nz_scan = np.nonzero(lev.reshape(-1)[scan[:, 0]])[0]
                if nz_scan.size == 0 or nz_scan[-1] < 1:
                    continue
                if mts_idx != 0 and (lev[:, 16:].any() or lev[16:, :].any()):
                    continue
            if not lev.any():
                if best is None:        # allow_zero=False, all-zero quant
                    best = (float("inf"), 0, 0, lev, rec_resid)
                continue

            def _extra(est, m=mts_idx, lf=lfnst_idx):
                # transform-index signalling bits (residual_lfnst_mode /
                # mts_idx), included so DCT2 vs MTS/LFNST compare fairly;
                # neither is coded when TS is chosen (isTrSkip /
                # mtsLastScanPos stays false)
                if m == 1:
                    return
                if try_lfnst and w >= 4 and h >= 4:
                    est.encode_bin(1 if lf else 0, ctx("LFNSTIdx", 0))
                    if lf:
                        est.encode_bin(1 if lf == 2 else 0,
                                       ctx("LFNSTIdx", 2))
                if try_mts and lf == 0:
                    est.encode_bin(1 if m else 0, ctx("MTSIdx", 0))
                    if m:
                        for i in range(3):
                            s = 1 if m > i + 2 else 0
                            est.encode_bin(s, ctx("MTSIdx", 1 + i))
                            if not s:
                                break
            bits = self._est_tu_bits(lev, cbf_ctx, is_luma, extra=_extra,
                                     ts=mts_idx == 1,
                                     ts_allowed=ts_allowed)
            err = rec_resid.astype(np.int64) - resid
            cost = dw * float((err * err).sum()) + lam * bits
            if best is None or cost < best[0]:
                best = (cost, mts_idx, lfnst_idx, lev, rec_resid)
        _, mts_idx, lfnst_idx, lev, rec_resid = best
        cbf = bool(lev.any())
        if chroma_scale is not None and cbf:
            rec_resid = scale_chroma_residual_inv(rec_resid, chroma_scale,
                                                  self.cfg.bit_depth)
        recon = np.clip(np.asarray(pred, np.int32) + rec_resid, 0,
                        (1 << self.cfg.bit_depth) - 1)
        return cbf, lev, recon, mts_idx, lfnst_idx

    @staticmethod
    def _scan_pos_last(lev, w, h):
        """Last significant scan position (-1 if none)."""
        nz = np.nonzero(lev.reshape(-1)[grouped_scan(w, h)[:, 0]])[0]
        return int(nz[-1]) if nz.size else -1

    def _chroma_adj(self, x_l, y_l):
        """LMCS chroma-residual scale for the 64x64 VPDU containing luma
        (x_l, y_l): average of the VPDU's above/left MAPPED luma recon
        neighbours -> chromaAdjHelpLUT (calculateChromaAdjVpduNei,
        Reshape.cpp:106-190). Cached per VPDU (deterministic: neighbours
        are outside the VPDU and complete before any of its TUs)."""
        vx, vy = (x_l // 64) * 64, (y_l // 64) * 64
        a = self._vpdu_adj.get((vx, vy))
        if a is not None:
            return a
        cfg = self.cfg
        rec = self.recon_y
        num = min(64, cfg.ctu_size)
        nlog = num.bit_length() - 1
        s = 0
        peln = 0
        if vx > 0 and bool(self.coded[vy // 4, (vx - 1) // 4]):
            idx = np.arange(num)
            k = np.where(vy + idx >= cfg.height, cfg.height - vy - 1, idx)
            s += int(rec[vy + k, vx - 1].sum())
            peln += num
        if vy > 0 and bool(self.coded[(vy - 1) // 4, vx // 4]):
            idx = np.arange(num)
            k = np.where(vx + idx >= cfg.width, cfg.width - vx - 1, idx)
            s += int(rec[vy - 1, vx + k].sum())
            peln += num
        if peln == num:
            avg = (s + (1 << (nlog - 1))) >> nlog
        elif peln == 2 * num:
            avg = (s + (1 << nlog)) >> (nlog + 1)
        else:
            avg = 1 << (cfg.bit_depth - 1)
        a = self.reshaper.chroma_adj(avg)
        self._vpdu_adj[(vx, vy)] = a
        return a

    def _crs_scale(self, x_l, y_l, cw, chh):
        """Chroma-scale for a TU, or None (gate: w*h > 4 chroma samples,
        DecCu.cpp)."""
        if self.reshaper is None or not self.cfg.lmcs_chroma_scaling \
                or cw * chh <= 4:
            return None
        return self._chroma_adj(x_l, y_l)

    def _try_joint_cbcr(self, rc, org_cu, org_cv, pred_u, pred_v,
                        cx, cy, cw, chh, qp_c,
                        cbf_u, lev_u, rec_u, cbf_v, lev_v, rec_v,
                        chroma_scale=None):
        """Evaluate JCCR mask 3 (Cr = -Cb, ph sign flag 1): returns
        (joint, cbf_u, lev_u, rec_u, cbf_v, lev_v, rec_v).

        Contracts: invTransformCbCr<-2> (TrQuant.cpp:139), joint_cb_cr
        (CABACWriter.cpp:2610), QpParam JOINT (same table, offset 0)."""
        cfg = self.cfg
        ru = org_cu.astype(np.int64) - pred_u
        rv = org_cv.astype(np.int64) - pred_v
        joint_res = ((ru - rv) / 2.0).round().astype(np.int32)
        synth_org = (pred_u.astype(np.int32) + joint_res)
        # JOINT_CbCr QP: same mapping table, pps_joint_cbcr_qp_offset
        # instead of the cb offset (QpParam ctor, Quant.cpp:115)
        qp_j = qp_c - cfg.chroma_qp_offset + cfg.jccr_qp_offset
        cbf_j, lev_j, rec_ju, _, _ = self._code_tu_component(
            rc, synth_org, pred_u, cx, cy, cw, chh, qp_j, False,
            chroma_scale=chroma_scale)
        if not cbf_j:
            return (False, cbf_u, lev_u, rec_u, cbf_v, lev_v, rec_v)
        dec_res = rec_ju.astype(np.int64) - pred_u
        rec_jv = np.clip(pred_v - dec_res, 0,
                         (1 << cfg.bit_depth) - 1).astype(rec_ju.dtype)
        lam = self.lam

        def sse(a, b):
            d = a.astype(np.int64) - b.astype(np.int64)
            return self.dw_c * float((d * d).sum())
        # joint: cbf_u=1, cbf_v=1 (inferred from joint), joint flag, one
        # residual; separate: cbf_u + cbf_v + joint=0 flag (when a cbf is
        # set) + both residuals (CABACWriter transform_unit order)
        bits_j = self._est_tu_bits(lev_j, ("QtCbf1", 0), False) \
            + self.est.bin_bits(1, ctx("QtCbf2", 1)) / 32768.0 \
            + self.est.bin_bits(1, ctx("JointCbCrFlag", 2)) / 32768.0
        bits_s = self._est_tu_bits(lev_u if cbf_u else None,
                                   ("QtCbf1", 0), False) \
            + self._est_tu_bits(lev_v if cbf_v else None,
                                ("QtCbf2", 1 if cbf_u else 0), False)
        cbf_mask = (2 if cbf_u else 0) + (1 if cbf_v else 0)
        if cfg.joint_cbcr and cbf_mask:
            bits_s += self.est.bin_bits(
                0, ctx("JointCbCrFlag", cbf_mask - 1)) / 32768.0
        cost_j = sse(rec_ju, org_cu) + sse(rec_jv, org_cv) + lam * bits_j
        cost_s = sse(rec_u, org_cu) + sse(rec_v, org_cv) + lam * bits_s
        if cost_j < cost_s:
            self.n_jccr += 1
            return (True, True, lev_j, rec_ju, True, lev_j, rec_jv)
        return (False, cbf_u, lev_u, rec_u, cbf_v, lev_v, rec_v)

    def _write_lfnst_idx(self, enc, cu, lfnst_idx, comps, sep_tree,
                         ts_used=False):
        """CABACWriter::residual_lfnst_mode (:2770-2820).

        ``comps``: list of (w, h, lev) for every coded (cbf=1) non-TS TU
        component of this CU in its channel scope; ``ts_used``: any cbf
        component coded with transform skip (isTrSkip, :2789) — the
        index is then never coded."""
        cfg = self.cfg
        if not cfg.lfnst or ts_used:
            return
        isp = cu.isp if cu is not None else 0
        if isp and not intra_ops.can_use_lfnst_with_isp(cu.w, cu.h, isp):
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
        # the lastScanPos condition is waived for ISP (CABACWriter:2801)
        if (not last_ok and not isp) or viol:
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

    # ---- dual-tree CU coding --------------------------------------------

    def _encode_luma_cu(self, enc, rc, org_y, cu: CuInfo):
        """Dual-tree luma CU: intra luma mode + luma TU only."""
        cfg = self.cfg
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        refs = self._refs_for_block(self.recon_y, x, y, w, h, 1,
                                    cfg.bit_depth)
        org = org_y[y:y + h, x:x + w]
        pred_y = self._choose_luma(cu, org, refs, w, h)
        qp_y = cfg.qp + self.qp_bd_offset
        try_mts = cfg.mts_intra and w <= 32 and h <= 32
        try_lfnst = cfg.lfnst and (not cu.mip or (w >= 16 and h >= 16))
        cbf_y, lev_y, rec_y, mts_idx, lfnst_idx = self._code_tu_component(
            rc, org, pred_y, x, y, w, h, qp_y, True, try_mts=try_mts,
            try_lfnst=try_lfnst, intra_mode=cu.mode,
            try_ts=cfg.transform_skip)
        ts_y = mts_idx == 1

        trial = None
        if cfg.isp and not cu.mip and cu.mrl == 0 \
                and intra_ops.can_use_isp(w, h):
            err = rec_y.astype(np.int64) - org
            cost_base = float((err * err).sum()) + self.lam * \
                self._est_tu_bits(lev_y if cbf_y else None,
                                  ("QtCbf0", 0), True, ts=ts_y,
                                  ts_allowed=self._ts_allowed(w, h, True))
            trial = self._maybe_isp(cu, org_y, qp_y, cost_base)

        self._write_intra_luma_mode(enc, cu)
        # sep-tree luma: no chroma cbfs / modes
        if trial is not None:
            comps = self._write_isp_tus(enc, rc, trial)
            self._write_lfnst_idx(enc, cu, 0, comps, True)
            # mts_idx never coded for ISP (mtsAllowed &= !ispMode)
        else:
            enc.encode_bin(1 if cbf_y else 0, ctx("QtCbf0", 0))
            last_pos_y, violates_mts = -1, False
            if cbf_y:
                last_pos_y, violates_mts = self._write_resid(
                    rc, lev_y, w, h, True, ts=ts_y)
            if lfnst_idx:
                self.n_lfnst += 1
            self._write_lfnst_idx(
                enc, cu, lfnst_idx,
                [(w, h, lev_y)] if cbf_y and not ts_y else [], True,
                ts_used=cbf_y and ts_y)
            if lfnst_idx == 0 and not ts_y:
                self._write_mts_idx(enc, mts_idx, w, h, cbf_y, last_pos_y,
                                    violates_mts)
            self.recon_y[y:y + h, x:x + w] = rec_y
        r, c = y // 4, x // 4
        self.coded[r:r + h // 4, c:c + w // 4] = True
        self.unit_mode[r:r + h // 4, c:c + w // 4] = cu.mode
        self.unit_w[r:r + h // 4, c:c + w // 4] = w
        self.unit_h[r:r + h // 4, c:c + w // 4] = h
        self.unit_qt[r:r + h // 4, c:c + w // 4] = cu.qt_depth
        self.unit_mip[r:r + h // 4, c:c + w // 4] = cu.mip
        self.unit_isp[r:r + h // 4, c:c + w // 4] = cu.isp != 0
        if cu.isp:
            self.leaf_l.extend(self._isp_deblock_units(x, y, w, h, cu.isp))
        else:
            self.leaf_l.append((x, y, w, h))

    def _encode_chroma_cu(self, enc, rc, org_u, org_v, cu: CuInfo,
                          split_path=(None, None)):
        """Dual-tree chroma CU (luma-unit coords): DM/CCLM + Cb/Cr TUs."""
        cfg = self.cfg
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        # DM = co-located luma mode at the chroma block centre
        # (PU::getCoLocatedIntraLumaMode; centre pos in luma units)
        cx_l = x + w // 2
        cy_l = y + h // 2
        mode = int(self.unit_mode[cy_l // 4, cx_l // 4])
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        refs_u = self._refs_for_block(self.recon_u, cx, cy, cw, chh, 2,
                                      cfg.bit_depth, coded=self.coded_c)
        refs_v = self._refs_for_block(self.recon_v, cx, cy, cw, chh, 2,
                                      cfg.bit_depth, coded=self.coded_c)
        cclm_ok = cfg.cclm and self._cclm_allowed_dual(split_path)
        qpi = max(-self.qp_bd_offset, min(63, cfg.qp))
        qp_c = int(self.qp_table[qpi + self.qp_bd_offset]) \
            + cfg.chroma_qp_offset
        qp_c = max(-self.qp_bd_offset, min(63, qp_c)) + self.qp_bd_offset
        crs = self._crs_scale(x, y, cw, chh)
        pred_u, pred_v = self._choose_chroma(
            cu, x, y, w, h, refs_u, refs_v, self.coded_c,
            cclm_ok, mode, qp_c, crs,
            self._org_u[cy:cy + chh, cx:cx + cw],
            self._org_v[cy:cy + chh, cx:cx + cw])
        cbf_u, lev_u, rec_u, mts_u, _ = self._code_tu_component(
            rc, self._org_u[cy:cy + chh, cx:cx + cw], pred_u,
            cx, cy, cw, chh, qp_c, False, chroma_scale=crs,
            try_ts=cfg.transform_skip)
        cbf_v, lev_v, rec_v, mts_v, _ = self._code_tu_component(
            rc, self._org_v[cy:cy + chh, cx:cx + cw], pred_v,
            cx, cy, cw, chh, qp_c, False, chroma_scale=crs,
            cbf_ctx=("QtCbf2", 1 if cbf_u else 0),
            try_ts=cfg.transform_skip)
        ts_u, ts_v = mts_u == 1, mts_v == 1

        joint = False
        if cfg.joint_cbcr:
            (joint, cbf_u, lev_u, rec_u, cbf_v, lev_v, rec_v) = \
                self._try_joint_cbcr(rc, self._org_u[cy:cy + chh,
                                                     cx:cx + cw],
                                     self._org_v[cy:cy + chh, cx:cx + cw],
                                     pred_u, pred_v, cx, cy, cw, chh, qp_c,
                                     cbf_u, lev_u, rec_u,
                                     cbf_v, lev_v, rec_v,
                                     chroma_scale=crs)

        # chroma-tree CU syntax: intra_chroma_pred_mode, then TU
        self._write_intra_chroma_mode(enc, cclm=cu.cclm,
                                      cclm_allowed=cclm_ok,
                                      lm_symbol=cu.lm_symbol,
                                      chroma_mode=cu.chroma_mode,
                                      luma_mode=mode)
        enc.encode_bin(1 if cbf_u else 0, ctx("QtCbf1", 0))
        enc.encode_bin(1 if cbf_v else 0, ctx("QtCbf2", 1 if cbf_u else 0))
        cbf_mask = (2 if cbf_u else 0) + (1 if cbf_v else 0)
        if cfg.joint_cbcr and cbf_mask:
            enc.encode_bin(1 if joint else 0,
                           ctx("JointCbCrFlag", cbf_mask - 1))
        if joint:
            ts_u = ts_v = False
        if cbf_u:
            self._write_resid(rc, lev_u, cw, chh, False, ts=ts_u)
        if cbf_v and not joint:
            self._write_resid(rc, lev_v, cw, chh, False, ts=ts_v)
        if min(cw, chh) >= 4:       # residual_lfnst_mode chroma-tree gate
            comps = []
            if cbf_u and not ts_u:
                comps.append((cw, chh, lev_u))
            if cbf_v and not joint and not ts_v:
                comps.append((cw, chh, lev_v))
            ts_used = (cbf_u and ts_u) or (cbf_v and ts_v)
            self._write_lfnst_idx(enc, cu, 0, comps, True,
                                  ts_used=ts_used)

        self.recon_u[cy:cy + chh, cx:cx + cw] = rec_u
        self.recon_v[cy:cy + chh, cx:cx + cw] = rec_v
        self.unit_joint2[cy // 2:(cy + chh) // 2,
                         cx // 2:(cx + cw) // 2] = \
            bool(joint and cbf_u and cbf_v)
        r, c = y // 4, x // 4
        self.coded_c[r:r + h // 4, c:c + w // 4] = True
        self.unit_w_c[r:r + h // 4, c:c + w // 4] = w
        self.unit_h_c[r:r + h // 4, c:c + w // 4] = h
        self.unit_qt_c[r:r + h // 4, c:c + w // 4] = cu.qt_depth
        self.leaf_c.append((x // 2, y // 2, w // 2, h // 2))

    # ---- CU coding -------------------------------------------------------

    def _encode_cu(self, enc, rc, org_y, org_u, org_v, cu: CuInfo):
        cfg = self.cfg
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        # luma prediction + mode choice
        refs = self._refs_for_block(self.recon_y, x, y, w, h, 1,
                                    cfg.bit_depth)
        org = org_y[y:y + h, x:x + w]
        pred_y = self._choose_luma(cu, org, refs, w, h)

        qp_y = cfg.qp + self.qp_bd_offset
        qpi = max(-self.qp_bd_offset, min(63, cfg.qp))
        qp_c = int(self.qp_table[qpi + self.qp_bd_offset]) \
            + cfg.chroma_qp_offset
        qp_c = max(-self.qp_bd_offset, min(63, qp_c)) + self.qp_bd_offset

        try_mts = self.cfg.mts_intra and w <= 32 and h <= 32
        try_lfnst = cfg.lfnst and (not cu.mip or (w >= 16 and h >= 16))
        cbf_y, lev_y, rec_y, mts_idx, lfnst_idx = self._code_tu_component(
            rc, org, pred_y, x, y, w, h, qp_y, True, try_mts=try_mts,
            try_lfnst=try_lfnst, intra_mode=cu.mode,
            try_ts=cfg.transform_skip)
        ts_y = mts_idx == 1
        isp_trial = None
        if cfg.isp and not cu.mip and cu.mrl == 0 \
                and intra_ops.can_use_isp(w, h):
            err = rec_y.astype(np.int64) - org
            cost_base = float((err * err).sum()) + self.lam * \
                self._est_tu_bits(lev_y if cbf_y else None,
                                  ("QtCbf0", 0), True, ts=ts_y,
                                  ts_allowed=self._ts_allowed(w, h, True))
            isp_trial = self._maybe_isp(cu, org_y, qp_y, cost_base)
            if isp_trial is not None:
                lfnst_idx = mts_idx = 0    # no LFNST/MTS with ISP here
        # luma recon written early: CCLM downsamples the co-located luma
        if isp_trial is None:
            self.recon_y[y:y + h, x:x + w] = rec_y

        # chroma: DM mode on co-located; chroma block at half res
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        refs_u = self._refs_for_block(self.recon_u, cx, cy, cw, chh, 2,
                                      cfg.bit_depth)
        refs_v = self._refs_for_block(self.recon_v, cx, cy, cw, chh, 2,
                                      cfg.bit_depth)
        org_cu = org_u[cy:cy + chh, cx:cx + cw]
        org_cv = org_v[cy:cy + chh, cx:cx + cw]
        crs = self._crs_scale(x, y, cw, chh)
        pred_u, pred_v = self._choose_chroma(
            cu, x, y, w, h, refs_u, refs_v, self.coded,
            cfg.cclm and not cfg.dual_tree, cu.mode, qp_c, crs,
            org_cu, org_cv)
        cbf_u, lev_u, rec_u, mts_u, _ = self._code_tu_component(
            rc, org_cu, pred_u, cx, cy, cw, chh,
            qp_c, False, chroma_scale=crs, try_ts=cfg.transform_skip)
        cbf_v, lev_v, rec_v, mts_v, _ = self._code_tu_component(
            rc, org_cv, pred_v, cx, cy, cw, chh,
            qp_c, False, chroma_scale=crs,
            cbf_ctx=("QtCbf2", 1 if cbf_u else 0),
            try_ts=cfg.transform_skip)
        ts_u, ts_v = mts_u == 1, mts_v == 1

        if lfnst_idx:
            # single tree: chroma coefficients share the LFNST signalling
            # constraint (violatesLfnstConstrained[CHROMA], :2787); if a
            # chroma TU breaks it the index can't be coded -> redo luma
            # with LFNST off (chroma preds depend on luma recon via CCLM,
            # but LFNST off only changes the luma residual, so the chroma
            # TUs stay valid)
            viol_c = (cbf_u and ts_u) or (cbf_v and ts_v)  # isTrSkip
            for lv, ts_c in ((lev_u if cbf_u else None, ts_u),
                             (lev_v if cbf_v else None, ts_v)):
                if lv is None or ts_c or cw < 4 or chh < 4:
                    continue
                last = self._scan_pos_last(lv, cw, chh)
                max_pos = 7 if ((cw == 4 and chh == 4)
                                or (cw == 8 and chh == 8)) else 15
                viol_c |= last > max_pos
            if viol_c:
                cbf_y, lev_y, rec_y, mts_idx, lfnst_idx = \
                    self._code_tu_component(
                        rc, org, pred_y, x, y, w, h, qp_y, True,
                        try_mts=try_mts, intra_mode=cu.mode,
                        try_ts=cfg.transform_skip)
                ts_y = mts_idx == 1
                self.recon_y[y:y + h, x:x + w] = rec_y
                if cu.cclm:
                    # CCLM prediction read the old luma recon: recompute
                    for sym, pu_, pv_ in self._cclm_candidates(
                            x, y, w, h, refs_u, refs_v, self.coded):
                        if sym == cu.lm_symbol:
                            pred_u = pu_.astype(np.int32)
                            pred_v = pv_.astype(np.int32)
                            break
                    cbf_u, lev_u, rec_u, mts_u, _ = \
                        self._code_tu_component(
                            rc, org_cu, pred_u, cx, cy, cw, chh, qp_c,
                            False, chroma_scale=crs,
                            try_ts=cfg.transform_skip)
                    cbf_v, lev_v, rec_v, mts_v, _ = \
                        self._code_tu_component(
                            rc, org_cv, pred_v, cx, cy, cw, chh, qp_c,
                            False, chroma_scale=crs,
                            try_ts=cfg.transform_skip)
                    ts_u, ts_v = mts_u == 1, mts_v == 1

        joint = False
        if cfg.joint_cbcr:
            res = self._try_joint_cbcr(rc, org_cu, org_cv, pred_u, pred_v,
                                       cx, cy, cw, chh, qp_c,
                                       cbf_u, lev_u, rec_u,
                                       cbf_v, lev_v, rec_v,
                                       chroma_scale=crs)
            if res[0] and lfnst_idx and cw >= 4 and chh >= 4:
                # joint levels must not break the already-committed LFNST
                # signalling constraint (violatesLfnstConstrained)
                last = self._scan_pos_last(res[2], cw, chh)
                max_pos = 7 if ((cw == 4 and chh == 4)
                                or (cw == 8 and chh == 8)) else 15
                if last > max_pos:
                    res = (False, cbf_u, lev_u, rec_u, cbf_v, lev_v, rec_v)
            (joint, cbf_u, lev_u, rec_u, cbf_v, lev_v, rec_v) = res
            if joint:
                ts_u = ts_v = False    # joint TU coded with the DCT2 path

        # ---- syntax: coding_unit ----
        # I-slice, no IBC/PLT -> pred_mode not coded; no bdpcm
        self._write_intra_luma_mode(enc, cu)
        self._write_intra_chroma_mode(enc, cclm=cu.cclm,
                                      lm_symbol=cu.lm_symbol,
                                      chroma_mode=cu.chroma_mode,
                                      luma_mode=cu.mode)
        cbf_mask = (2 if cbf_u else 0) + (1 if cbf_v else 0)
        if isp_trial is not None:
            # ISP transform tree: sub-TUs 0..n-2 luma-only; the last
            # sub-TU carries the chroma blocks (cbf_cb/cbf_cr before its
            # luma cbf, joint flag after, chroma residuals at the end)
            def _chroma_cbfs():
                enc.encode_bin(1 if cbf_u else 0, ctx("QtCbf1", 0))
                enc.encode_bin(1 if cbf_v else 0,
                               ctx("QtCbf2", 1 if cbf_u else 0))

            def _jccr_flag():
                if cfg.joint_cbcr and cbf_mask:
                    enc.encode_bin(1 if joint else 0,
                                   ctx("JointCbCrFlag", cbf_mask - 1))
            comps = self._write_isp_tus(enc, rc, isp_trial,
                                        before_last_cbf=_chroma_cbfs,
                                        after_last_cbf=_jccr_flag)
            if cbf_u:
                self._write_resid(rc, lev_u, cw, chh, False, ts=ts_u)
            if cbf_v and not joint:
                self._write_resid(rc, lev_v, cw, chh, False, ts=ts_v)
            if cbf_u and not ts_u:
                comps.append((cw, chh, lev_u))
            if cbf_v and not (ts_v or (joint and ts_u)):
                comps.append((cw, chh, lev_v))
            ts_used = (cbf_u and ts_u) or (cbf_v and ts_v)
            self._write_lfnst_idx(enc, cu, 0, comps, False,
                                  ts_used=ts_used)
        else:
            # transform_unit: cbf_cb, cbf_cr, then cbf_luma
            enc.encode_bin(1 if cbf_u else 0, ctx("QtCbf1", 0))
            enc.encode_bin(1 if cbf_v else 0,
                           ctx("QtCbf2", 1 if cbf_u else 0))
            enc.encode_bin(1 if cbf_y else 0, ctx("QtCbf0", 0))
            if cfg.joint_cbcr and cbf_mask:
                enc.encode_bin(1 if joint else 0,
                               ctx("JointCbCrFlag", cbf_mask - 1))
            last_pos_y, violates_mts = -1, False
            if cbf_y:
                last_pos_y, violates_mts = self._write_resid(
                    rc, lev_y, w, h, True, ts=ts_y)
            if cbf_u:
                self._write_resid(rc, lev_u, cw, chh, False, ts=ts_u)
            if cbf_v and not joint:
                self._write_resid(rc, lev_v, cw, chh, False, ts=ts_v)
            # residual_lfnst_mode then mts_idx (cu_residual tail order)
            comps = []
            if cbf_y and not ts_y:
                comps.append((w, h, lev_y))
            if cbf_u and not ts_u:
                comps.append((cw, chh, lev_u))
            if cbf_v and not (ts_v or (joint and ts_u)):
                comps.append((cw, chh, lev_v))
            ts_used = ((cbf_y and ts_y) or (cbf_u and ts_u)
                       or (cbf_v and ts_v))
            if lfnst_idx:
                self.n_lfnst += 1
            self._write_lfnst_idx(enc, cu, lfnst_idx, comps, False,
                                  ts_used=ts_used)
            if lfnst_idx == 0 and not ts_y:
                self._write_mts_idx(enc, mts_idx, w, h, cbf_y, last_pos_y,
                                    violates_mts)

        # ---- state update ----
        self.recon_u[cy:cy + chh, cx:cx + cw] = rec_u
        self.recon_v[cy:cy + chh, cx:cx + cw] = rec_v
        self.unit_joint2[cy // 2:(cy + chh) // 2,
                         cx // 2:(cx + cw) // 2] = \
            bool(joint and cbf_u and cbf_v)
        r, c = y // 4, x // 4
        self.coded[r:r + h // 4, c:c + w // 4] = True
        self.unit_mode[r:r + h // 4, c:c + w // 4] = cu.mode
        self.unit_w[r:r + h // 4, c:c + w // 4] = w
        self.unit_h[r:r + h // 4, c:c + w // 4] = h
        self.unit_qt[r:r + h // 4, c:c + w // 4] = cu.qt_depth
        self.unit_mip[r:r + h // 4, c:c + w // 4] = cu.mip
        self.unit_isp[r:r + h // 4, c:c + w // 4] = cu.isp != 0
        if cu.isp:
            self.leaf_l.extend(self._isp_deblock_units(x, y, w, h, cu.isp))
        else:
            self.leaf_l.append((x, y, w, h))
        self.leaf_c.append((x // 2, y // 2, w // 2, h // 2))

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

    def _rdo_decider(self):
        """Stock full RDO partitioning (no maps): every in-picture node
        <= 64 goes through the split search (EncCu stock mode list)."""
        cfg = self.cfg

        def decide(x, y, w, h, state):
            implicit = (x + w > cfg.width) or (y + h > cfg.height)
            if w > 64 or h > 64 or implicit:
                return Split.QT
            return RDO
        return decide

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
                     collect_bin_stats: bool = False, rdo: bool = False,
                     decide_fn=None, decide_c_fn=None):
        """Encode one frame. Returns (bitstream_bytes, recon (y,u,v)).

        ``maps``: optional (hor, ver, qt, dire) frame partition maps for
        full MTT map-driven coding; else ``qt_map`` drives QT-only coding.
        ``chroma_maps``: chroma-component maps for the dual chroma tree
        (defaults to ``maps``).  ``decide_fn``/``decide_c_fn``: explicit
        split deciders (override maps). ``collect_bin_stats``: keep the
        frame's bin statistics in ``bin_stats`` (``utils/stats.py``).
        ``rdo``: with no maps, every node of 64x64 or less inside the
        picture goes to the RDO split search, which is not ported: the
        first such node raises ``NotImplementedError``.
        """
        cfg = self.cfg
        if y.shape != (cfg.height, cfg.width):
            raise ValueError(f"luma plane {y.shape} is not {cfg.height}x{cfg.width}")
        # min-CB-multiple frames; boundary CTUs use implicit splits
        if cfg.width % 8 or cfg.height % 8:
            raise ValueError("frame sides must be multiples of 8")
        if cfg.dep_quant and cfg.sign_hiding:
            raise ValueError("dep-quant and sign-hiding are mutually exclusive "
                             "per slice")
        t0 = time.perf_counter()
        self._init_state()
        self._org_u = u.astype(np.int32)
        self._org_v = v.astype(np.int32)
        self._vpdu_adj = {}
        if decide_fn is not None:
            decide = decide_fn
        elif maps is not None:
            decide = self._map_decider(*maps)
        elif rdo:
            decide = self._rdo_decider()
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
            elif rdo:
                decide_c = self._rdo_decider()
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
        # serialized by the native C finalizer in one call; the CU coding's
        # RD trials read the running rate estimator the recorder adapts
        if self._rate_estimated:
            self.est = RateEstimator.standard_init(cfg.qp, 2)
            enc = RecordingEncoder(self)
        else:
            enc = RecordingEncoder()
        rc = ResidualCoder(enc, dep_quant=cfg.dep_quant,
                           sign_hiding=cfg.sign_hiding)
        y_orig = y.astype(np.int32)
        # with LMCS the luma is coded in the mapped domain (forward LUT on
        # the original; the intra references and recon stay mapped until the
        # inverse before the in-loop filters)
        y_cod = self.reshaper.fwd(y_orig).astype(np.int32) \
            if self.reshaper is not None else y_orig
        org = (y_cod, self._org_u, self._org_v)
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
                    # an unsplit 64x64 luma leaf coded with ISP bans CCLM
                    self._luma_root_isp = bool(
                        self.unit_isp[qy // 4, qx // 4]) \
                        and int(self.unit_w[qy // 4, qx // 4]) == 64 \
                        and int(self.unit_h[qy // 4, qx // 4]) == 64
                    self._encode_tree_ch(enc, rc, org, qx, qy, qw, qh,
                                         st, decide_c, True)
        self._time("code" if self._rate_estimated else "replay", t0)
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
        self.bin_stats = bin_stats(enc.ops) if collect_bin_stats else None
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
