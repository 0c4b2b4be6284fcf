"""Native all-intra VVC frame decoder (DecLib counterpart), on the card.

A port of the JAX package's ``codec/decoder.py``: an exact parse mirror of
``codec/encoder.py``'s syntax writes (reference VTM-10.0 CABACReader.cpp
coding_tree_unit/coding_tree/split_cu_mode/coding_unit/
intra_luma_pred_modes/intra_chroma_pred_mode/transform_unit/
residual_coding, DecCu.cpp xReconIntraQT, DecLib.cpp executeLoopFilters),
reusing the encoder's direction-neutral machinery: neighbour state,
reference construction, MPM derivation, ISP geometry, QP tables, and the
reconstruction ops (intra, MIP, MRL, ISP, CCLM, transforms, LFNST,
dependent quantization) plus the in-loop filters (deblocking, SAO, LMCS,
ALF and CC-ALF).

The block-level device work goes through the sequential encoder's K10
kernels on ``device`` (the card unless the caller passes ``device="cpu"``,
which runs their plain versions), numpy in and numpy out: luma and chroma
prediction through K10a ``ops/intra.py:predict_block`` (a chroma CU's U
and V rows in one call), MIP through K10b ``ops/mip.py:predict_mip_all``,
and a TU's dequantisation and inverse transform through K10c
``ops/quant.py:seq_tq`` as one launch with both stages in its mask (the
one-stage forms around the host's dependent dequantiser or inverse LFNST).

The BDPCM and the single-tree SCIPU (local dual tree) branches are the JAX
package's, verbatim. Neither encoder emits them, and the JAX package tests
them only on streams of the stock VTM encoder, so no test of this
repository reaches them.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..ops import depquant as dq_ops
from ..ops import intra as intra_ops
from ..ops import lfnst as lfnst_ops
from ..ops import mip as mip_ops
from ..ops.quant import (DEQUANT, INV, dequantize, dequantize_ts,
                         inverse_transform, seq_tq, ts_qp)
from .alf import (apply_alf_frame, parse_alf_aps, parse_alf_ctu,
                  parse_ccalf_ctu)
from .cabac import BinDecoder, ContextStore
from .deblock import deblock_frame
from .encoder import CuInfo, FrameEncoder, NUM_MPM, PLANAR
from .headers import VVCConfig
from .hlsparse import Bitstream, SliceInfo, parse_bitstream
from .lmcs import Reshaper, parse_lmcs_aps, scale_chroma_residual_inv
from .mtt import SplitState, get_implicit_split, parse_split_cu_mode
from .partition import Split
from .residual import ResidualParser, TSResidualParser, ctx, grouped_scan
from .sao import apply_sao_frame, parse_sao_ctu


class FrameDecoder(FrameEncoder):
    """Decodes one intra frame's slice payload to recon planes.

    Subclasses ``FrameEncoder`` ONLY to reuse its direction-neutral
    helpers (``_refs_for_block``, ``_mpm_list``, ``_mrl_refs``,
    ``_isp_*``, ``_cclm_candidates``, ``_chroma_adj``, QP tables, state
    arrays); no encoding entry point is used. ``device``: where the K10
    kernels run, as ``FrameEncoder``'s.
    """

    def __init__(self, cfg: VVCConfig, si: SliceInfo | None = None,
                 device=None):
        if si is None:
            si = SliceInfo(dep_quant=cfg.dep_quant,
                           sign_hiding=cfg.sign_hiding,
                           jccr_sign=cfg.joint_cbcr,
                           lmcs_enabled=cfg.lmcs,
                           chroma_residual_scale=cfg.lmcs_chroma_scaling,
                           sao_luma=cfg.sao, sao_chroma=cfg.sao)
        # PH-level switches override the encoder-side config defaults.
        # Work on a copy: the caller's cfg is shared across per-frame
        # decoders and must not absorb per-slice state.
        cfg = dataclasses.replace(
            cfg, lmcs_chroma_scaling=si.chroma_residual_scale)
        super().__init__(cfg, mode_select="planar", device=device)
        self.si = si
        if cfg.lmcs and si.lmcs_enabled:
            for rbsp in getattr(si, "aps", []) or []:
                try:
                    self.reshaper = Reshaper(parse_lmcs_aps(rbsp),
                                             cfg.bit_depth)
                    break
                except AssertionError:
                    continue
        elif not si.lmcs_enabled:
            self.reshaper = None
        self.alf_luma_apss = []
        self.alf_chroma_aps = None
        self.ccalf_cb_aps = self.ccalf_cr_aps = None
        if cfg.alf:
            by_id = getattr(si, "aps_by_id", None) or {}
            cache = {}

            def _alf(aid):
                key = (0 << 5) | aid     # aps_params_type ALF_APS = 0
                if key not in cache and key in by_id:
                    cache[key] = parse_alf_aps(by_id[key])
                return cache.get(key)

            self.alf_luma_apss = [_alf(a)
                                  for a in getattr(si, "alf_aps_ids", ())]
            if si.alf_cb or si.alf_cr:
                self.alf_chroma_aps = _alf(si.alf_aps_id_chroma)
            if si.ccalf_cb:
                self.ccalf_cb_aps = _alf(si.ccalf_cb_aps_id)
            if si.ccalf_cr:
                self.ccalf_cr_aps = _alf(si.ccalf_cr_aps_id)

    # ---- syntax parsing ---------------------------------------------------

    def _parse_split(self, x, y, w, h, state, chroma=False):
        cfg = self.cfg
        implicit = get_implicit_split(x, y, w, h, state, cfg, chroma)
        left = self._neighbor(x - 1, y, chroma)
        above = self._neighbor(x, y - 1, chroma)
        return parse_split_cu_mode(self.dec, w, h, state, cfg, left, above,
                                   chroma, implicit=implicit)

    def _parse_trunc_bin(self, max_symbol):
        """xReadTruncBinCode (CABACReader.cpp) — inverse of
        FrameEncoder._write_trunc_bin."""
        thresh = 0
        while (1 << (thresh + 1)) <= max_symbol:
            thresh += 1
        val = 1 << thresh
        b = max_symbol - val
        sym = self.dec.decode_bins_ep(thresh) if thresh else 0
        if sym >= val - b:
            sym = (sym << 1) | self.dec.decode_bin_ep()
            sym -= val - b
        return sym

    def _parse_intra_luma_mode(self, cu: CuInfo):
        cfg, dec = self.cfg, self.dec
        if cfg.mip:
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
            if dec.decode_bin(ctx("MipFlag", ctx_id)):
                cu.mip = True
                cu.mip_transpose = bool(dec.decode_bin_ep())
                cu.mip_mode = self._parse_trunc_bin(
                    mip_ops.num_modes(cu.w, cu.h))
                cu.mode = PLANAR
                return
        if cfg.mrl and cu.y % 128 != 0:
            if dec.decode_bin(ctx("MultiRefLineIdx", 0)):
                cu.mrl = 1 + dec.decode_bin(ctx("MultiRefLineIdx", 1))
        if cfg.isp and cu.mrl == 0 and intra_ops.can_use_isp(cu.w, cu.h):
            if dec.decode_bin(ctx("ISPMode", 0)):
                cu.isp = 1 + dec.decode_bin(ctx("ISPMode", 1))
        mpm = self._mpm_list(cu)
        mpm_flag = True if cu.mrl else \
            bool(dec.decode_bin(ctx("IntraLumaMpmFlag")))
        if mpm_flag:
            if cu.mrl == 0:
                not_planar = dec.decode_bin(
                    ctx("IntraLumaPlanarFlag", 0 if cu.isp else 1))
            else:
                not_planar = 1
            idx = 0
            if not_planar:
                idx = 1
                while idx < NUM_MPM - 1 and dec.decode_bin_ep():
                    idx += 1
            cu.mode = mpm[idx]
        else:
            mode = self._parse_trunc_bin(67 - NUM_MPM)
            for m in sorted(mpm):
                if mode >= m:
                    mode += 1
            cu.mode = mode

    def _parse_bdpcm_mode(self, cu: CuInfo, is_luma: bool) -> int:
        """CABACReader::bdpcm_mode (:1154) + CU::bdpcmAllowed
        (UnitTools.cpp:3810): 0 = off, 1 = horizontal, 2 = vertical."""
        cfg = self.cfg
        if not cfg.bdpcm:
            return 0
        mx = 1 << cfg.ts_max_log2
        if is_luma:
            if cu.w > mx or cu.h > mx:
                return 0
        elif cu.w // 2 > mx or cu.h // 2 > mx:
            return 0
        base = 0 if is_luma else 2
        m = self.dec.decode_bin(ctx("BDPCMMode", base))
        if m:
            m += self.dec.decode_bin(ctx("BDPCMMode", base + 1))
        return m

    def _bdpcm_pred(self, cu: CuInfo, is_luma: bool):
        """xPredIntraBDPCM (IntraPrediction.cpp:675): rows of the
        unfiltered left reference (mode 1) / columns of the above
        reference (mode 2)."""
        cfg = self.cfg
        if is_luma:
            refs = self._refs_for_block(self.recon_y, cu.x, cu.y, cu.w,
                                        cu.h, 1, cfg.bit_depth)
            top, left = np.asarray(refs[0])[0], np.asarray(refs[1])[0]
            if cu.bdpcm == 1:
                return np.repeat(left[1:1 + cu.h].astype(np.int32)
                                 [:, None], cu.w, axis=1)
            return np.repeat(top[1:1 + cu.w].astype(np.int32)[None, :],
                             cu.h, axis=0)
        cx, cy = cu.x // 2, cu.y // 2
        cw, chh = cu.w // 2, cu.h // 2
        coded = self.coded_c if cfg.dual_tree else self.coded
        out = []
        for plane in (self.recon_u, self.recon_v):
            refs = self._refs_for_block(plane, cx, cy, cw, chh, 2,
                                        cfg.bit_depth, coded=coded)
            top, left = np.asarray(refs[0])[0], np.asarray(refs[1])[0]
            if cu.bdpcm_c == 1:
                out.append(np.repeat(left[1:1 + chh].astype(np.int32)
                                     [:, None], cw, axis=1))
            else:
                out.append(np.repeat(top[1:1 + cw].astype(np.int32)
                                     [None, :], chh, axis=0))
        return out

    @staticmethod
    def _inv_res_dpcm(lev, dirm, max_log2=15):
        """invResDPCM (Quant.cpp:143-185): per-step clipped accumulation
        of the QUANTIZED residuals along the BDPCM direction."""
        out = np.asarray(lev, np.int64).copy()
        lo, hi = -(1 << max_log2), (1 << max_log2) - 1
        if dirm == 1:
            for c in range(1, out.shape[1]):
                out[:, c] = np.clip(out[:, c - 1] + out[:, c], lo, hi)
        else:
            for r in range(1, out.shape[0]):
                out[r] = np.clip(out[r - 1] + out[r], lo, hi)
        return out.astype(np.int32)

    def _parse_intra_chroma_mode(self, cclm_allowed, luma_mode=0):
        """Returns (cclm, lm_symbol, chroma_mode | None for DM).

        Non-DM list per UnitTools getIntraChromaCandModes: {PLANAR, VER,
        HOR, DC} with the entry equal to the co-located luma mode
        replaced by VDIA (66) — stock VTM streams use these; our encoder
        only emits DM/CCLM."""
        dec = self.dec
        if cclm_allowed:
            if dec.decode_bin(ctx("CclmModeFlag")):
                if dec.decode_bin(ctx("CclmModeIdx")) == 0:
                    return True, 0, None
                return True, 1 + dec.decode_bin_ep(), None
        if dec.decode_bin(ctx("IntraChromaPredMode")) == 0:
            return False, 0, None
        idx = (dec.decode_bin_ep() << 1) | dec.decode_bin_ep()
        cands = [0, 50, 18, 1]
        for i, m in enumerate(cands):
            if m == luma_mode:
                cands[i] = 66
        return False, 0, cands[idx]

    def _parse_lfnst_idx(self, cu, comps, sep_tree, ts_used=False):
        """Gate mirror of FrameEncoder._write_lfnst_idx.

        ``ts_used``: any cbf component coded with transform skip —
        lfnst_idx is then never coded (isTrSkip, CABACWriter.cpp:2789)."""
        cfg = self.cfg
        if not cfg.lfnst or ts_used:
            return 0
        isp = cu.isp if cu is not None else 0
        if isp and not intra_ops.can_use_lfnst_with_isp(cu.w, cu.h, isp):
            return 0
        if cu is not None and cu.mip and not (cu.w >= 16 and cu.h >= 16):
            return 0
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
        if (not last_ok and not isp) or viol:
            return 0
        idx = self.dec.decode_bin(ctx("LFNSTIdx", 1 if sep_tree else 0))
        if idx:
            idx += self.dec.decode_bin(ctx("LFNSTIdx", 2))
        return idx

    def _parse_mts_idx(self, cu_w, cu_h, cbf_y, last_pos, violates):
        cfg = self.cfg
        allowed = cfg.mts_intra and cu_w <= 32 and cu_h <= 32
        if not allowed or violates or not cbf_y or last_pos < 1:
            return 0
        if not self.dec.decode_bin(ctx("MTSIdx", 0)):
            return 0
        mts = 2
        for i in range(3):
            if not self.dec.decode_bin(ctx("MTSIdx", 1 + i)):
                break
            mts += 1
        return mts

    def _parse_resid(self, w, h, is_luma, isp=0, bdpcm=0):
        """ts_flag + residual parse for one TU component
        (CABACReader::residual_coding entry). Returns
        (lev, last_pos, violates_mts, ts).  ``bdpcm``: transform skip
        is inferred and the TS parser runs with the BDPCM context/
        level-mapping changes (CABACReader:2998)."""
        if bdpcm:
            return (self.rp_ts.parse(w, h, is_luma=is_luma, bdpcm=True),
                    -1, False, True)
        ts = False
        if self._ts_allowed(w, h, is_luma, isp):
            ts = bool(self.dec.decode_bin(
                ctx("TransformSkipFlag", 0 if is_luma else 1)))
        if ts:
            return self.rp_ts.parse(w, h, is_luma=is_luma), -1, False, True
        lev, last, viol = self.rp.parse(w, h, is_luma=is_luma)
        return lev, last, viol, False

    def _parse_isp_tus(self, cu, before_last_cbf=None, after_last_cbf=None):
        """Mirror of FrameEncoder._write_isp_tus; returns
        [(cbf, lev|None, (sx, sy, sw, sh))]."""
        dec = self.dec
        subs = self._isp_subs(cu.w, cu.h, cu.isp)
        n = len(subs)
        prev = any_prev = False
        out = []
        for k, (dx, dy, sw, sh) in enumerate(subs):
            is_last = k == n - 1
            if is_last and before_last_cbf is not None:
                before_last_cbf()
            inferred = is_last and not any_prev
            cbf = True if inferred else bool(dec.decode_bin(
                ctx("QtCbf0", 2 + (1 if prev else 0))))
            if is_last and after_last_cbf is not None:
                after_last_cbf()
            lev = None
            if cbf:
                lev, _, _ = self.rp.parse(sw, sh, is_luma=True)
            out.append((cbf, lev, (cu.x + dx, cu.y + dy, sw, sh)))
            prev = cbf
            any_prev = any_prev or cbf
        return out

    # ---- reconstruction ---------------------------------------------------

    def _recon_resid(self, lev, w, h, qp, mts_idx=0, lfnst_idx=0,
                     intra_mode=0, tr_kinds=None, ts=False):
        """Dequant + inverse transforms (decoder half of _tq_roundtrip):
        one K10c launch with both stages in its mask, or K10c's one-stage
        forms around the dependent dequantiser or the inverse LFNST."""
        bd = self.cfg.bit_depth
        if lev is None or not lev.any():
            return np.zeros((h, w), np.int32)
        if ts:
            # TS: scalar dequant at the clamped QP, identity transform
            # (Quant::dequant TS branch + TrQuant::xITransformSkip)
            return dequantize_ts(
                lev, ts_qp(qp, self.cfg.internal_minus_input))
        th, tv = tr_kinds if tr_kinds is not None else self._MTS_TR[mts_idx]
        if not self.si.dep_quant and not lfnst_idx:
            return self._host(seq_tq(self._dev(lev), DEQUANT | INV,
                                     kind_h=th, kind_v=tv, qp=qp,
                                     bit_depth=bd)[1])
        if self.si.dep_quant:
            scan = grouped_scan(w, h)[:, 0]
            deq = dq_ops.dep_dequant(lev, scan, w=w, h=h, qp=qp,
                                     bit_depth=bd).astype(np.int32)
        else:
            deq = self._host(dequantize(self._dev(lev), w=w, h=h, qp=qp,
                                        bit_depth=bd))
        if lfnst_idx:
            deq = lfnst_ops.inv_lfnst(deq, intra_mode, lfnst_idx,
                                      w, h).astype(np.int32)
        return self._host(inverse_transform(self._dev(deq), th, tv,
                                            bit_depth=bd))

    def _pred_luma(self, cu: CuInfo):
        cfg = self.cfg
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        refs = self._refs_for_block(self.recon_y, x, y, w, h, 1,
                                    cfg.bit_depth)
        if cu.mip:
            n = mip_ops.num_modes(w, h)
            refs_d = self._refs_dev(refs)
            preds = mip_ops.predict_mip_all(refs_d[0][0], refs_d[1][0],
                                            w=w, h=h,
                                            bit_depth=cfg.bit_depth)
            return self._host(
                preds[cu.mip_mode + (n if cu.mip_transpose else 0)]) \
                .astype(np.int32)
        if cu.mrl:
            mtop, mleft = self._mrl_refs(x, y, w, h, cu.mrl)
            return np.asarray(intra_ops.predict_mrl(
                mtop, mleft, w=w, h=h, mode=cu.mode, mri=cu.mrl,
                bit_depth=cfg.bit_depth), np.int32)
        return self._host(self._predict(refs, w, h, (cu.mode,), True)[0, 0]) \
            .astype(np.int32)

    def _recon_isp(self, cu: CuInfo, subs_parsed, qp_y):
        """Mirror of the recon loop in FrameEncoder._code_isp_trial."""
        cfg = self.cfg
        x, y, W, H = cu.x, cu.y, cu.w, cu.h
        ver = cu.isp == 2
        subs = self._isp_subs(W, H, cu.isp)
        tw, th_ = subs[0][2], subs[0][3]
        kinds = self._isp_tr_kinds(tw, th_)
        pw = max(tw, 4) if ver else W
        ph = H if ver else th_
        refs = self._refs_for_block(self.recon_y, x, y, W, H, 1,
                                    cfg.bit_depth)
        fill_top = np.asarray(refs[0][0], np.int64)
        fill_left = np.asarray(refs[1][0], np.int64)
        region_pred = None
        for (dx, dy, sw, sh), (cbf, lev, _) in zip(subs, subs_parsed):
            off = dx if ver else dy
            if off % (pw if ver else ph) == 0:
                r = off // (pw if ver else ph)
                top, left = self._isp_region_refs(cu, ver, r, pw, ph,
                                                  fill_top, fill_left)
                region_pred = intra_ops.predict_isp(
                    top, left, cu_w=W, cu_h=H, pw=pw, ph=ph,
                    mode=cu.mode, bit_depth=cfg.bit_depth)
            pred = region_pred[:, off % pw: off % pw + sw] if ver \
                else region_pred
            rr = self._recon_resid(lev, sw, sh, qp_y, tr_kinds=kinds) \
                if cbf else 0
            recon = np.clip(np.asarray(pred, np.int32) + rr, 0,
                            (1 << cfg.bit_depth) - 1)
            self.recon_y[y + dy:y + dy + sh, x + dx:x + dx + sw] = recon

    def _chroma_qp(self, joint=False):
        """Chroma QP; ``joint``: JOINT_CbCr component QP (same mapping
        table in this envelope, pps_joint_cbcr_qp_offset)."""
        cfg = self.cfg
        qpi = max(-self.qp_bd_offset, min(63, cfg.qp))
        off = cfg.jccr_qp_offset if joint else cfg.chroma_qp_offset
        qp_c = int(self.qp_table[qpi + self.qp_bd_offset]) + off
        return max(-self.qp_bd_offset, min(63, qp_c)) + self.qp_bd_offset

    def _pred_chroma(self, cu: CuInfo, coded_map):
        """(pred_u, pred_v) for the parsed chroma mode (DM or CCLM)."""
        cfg = self.cfg
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        refs_u = self._refs_for_block(self.recon_u, cx, cy, cw, chh, 2,
                                      cfg.bit_depth, coded=coded_map)
        refs_v = self._refs_for_block(self.recon_v, cx, cy, cw, chh, 2,
                                      cfg.bit_depth, coded=coded_map)
        if cu.cclm:
            for sym, pu_, pv_ in self._cclm_candidates(
                    x, y, w, h, refs_u, refs_v, coded_map):
                if sym == cu.lm_symbol:
                    return pu_.astype(np.int32), pv_.astype(np.int32)
            raise AssertionError("parsed CCLM symbol not derivable")
        cmode = cu.mode if cu.chroma_mode is None else cu.chroma_mode
        # U's and V's rows stacked: one K10a launch and one read-back
        refs_uv = tuple(np.concatenate(pair) for pair in zip(refs_u, refs_v))
        pu, pv = self._host(self._predict(refs_uv, cw, chh, (cmode,),
                                          False))[:, 0]
        return pu.astype(np.int32), pv.astype(np.int32)

    def _recon_chroma_pair(self, pred_u, pred_v, lev_u, lev_v,
                           cbf_u, cbf_v, joint, cw, chh, qp_c, crs,
                           ts_u=False, ts_v=False, lfnst_idx=0,
                           lfnst_mode=0):
        bd = self.cfg.bit_depth
        mx = (1 << bd) - 1
        lf = dict(lfnst_idx=lfnst_idx, intra_mode=lfnst_mode)

        def rr(lev, ts, qp):
            r = self._recon_resid(lev, cw, chh, qp, ts=ts,
                                  **({} if ts else lf))
            if crs is not None and lev is not None and lev.any():
                r = scale_chroma_residual_inv(r, crs, bd)
            return r

        if joint:
            # invTransformCbCr (TrQuant.cpp:139) via g_ictModes[sign][mask]
            # (UnitTools.cpp:3890); CRS scales each derived residual
            # (sign-magnitude, so it commutes with the negation)
            sign = self.si.jccr_sign
            mask = (2 if cbf_u else 0) + (1 if cbf_v else 0)
            if mask == 1:                      # Cr coded, Cb = ±Cr>>1
                res_cr = self._recon_resid(lev_v, cw, chh, qp_c, ts=ts_v,
                                           **({} if ts_v else lf))
                res_cb = (-res_cr) >> 1 if sign else res_cr >> 1
                nz = lev_v is not None and lev_v.any()
            elif mask == 2:                    # Cb coded, Cr = ±Cb>>1
                res_cb = self._recon_resid(lev_u, cw, chh, qp_c, ts=ts_u,
                                           **({} if ts_u else lf))
                res_cr = (-res_cb) >> 1 if sign else res_cb >> 1
                nz = lev_u is not None and lev_u.any()
            else:                              # mask 3, JOINT QP
                res_cb = self._recon_resid(
                    lev_u, cw, chh, self._chroma_qp(joint=True), ts=ts_u,
                    **({} if ts_u else lf))
                res_cr = np.where(res_cb == -32768, 32767,
                                  -res_cb) if sign else res_cb
                nz = lev_u is not None and lev_u.any()
            if crs is not None and nz:
                res_cb = scale_chroma_residual_inv(res_cb, crs, bd)
                res_cr = scale_chroma_residual_inv(res_cr, crs, bd)
            rec_u = np.clip(pred_u + res_cb, 0, mx)
            rec_v = np.clip(pred_v + res_cr, 0, mx)
            return rec_u, rec_v
        rec_u = np.clip(pred_u + (rr(lev_u, ts_u, qp_c) if cbf_u else 0),
                        0, mx)
        rec_v = np.clip(pred_v + (rr(lev_v, ts_v, qp_c) if cbf_v else 0),
                        0, mx)
        return rec_u, rec_v

    def _mark_luma(self, cu: CuInfo):
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        r, c = y // 4, x // 4
        self.coded[r:r + h // 4, c:c + w // 4] = True
        self.unit_mode[r:r + h // 4, c:c + w // 4] = cu.mode
        self.unit_w[r:r + h // 4, c:c + w // 4] = w
        self.unit_h[r:r + h // 4, c:c + w // 4] = h
        self.unit_qt[r:r + h // 4, c:c + w // 4] = cu.qt_depth
        self.unit_mip[r:r + h // 4, c:c + w // 4] = cu.mip
        self.unit_isp[r:r + h // 4, c:c + w // 4] = cu.isp != 0
        self.unit_bdpcm[r:r + h // 4, c:c + w // 4] = cu.bdpcm != 0
        self.unit_bdpcm_c[r:r + h // 4, c:c + w // 4] = cu.bdpcm_c != 0
        if cu.isp:
            self.leaf_l.extend(self._isp_deblock_units(x, y, w, h, cu.isp))
        else:
            self.leaf_l.append((x, y, w, h))

    # ---- CU decode --------------------------------------------------------

    def _decode_cu(self, cu: CuInfo):
        """Single-tree CU (mirror of FrameEncoder._encode_cu syntax)."""
        cfg, dec, rp = self.cfg, self.dec, self.rp
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        cu.bdpcm = self._parse_bdpcm_mode(cu, True)
        if cu.bdpcm:
            # intraDir inferred HOR/VER (CABACReader:1354-1356)
            cu.mode = 18 if cu.bdpcm == 1 else 50
        else:
            self._parse_intra_luma_mode(cu)
        cu.bdpcm_c = self._parse_bdpcm_mode(cu, False)
        if cu.bdpcm_c:
            cu.cclm, cu.lm_symbol = False, 0
            cu.chroma_mode = 18 if cu.bdpcm_c == 1 else 50
        else:
            cclm_ok = cfg.cclm and not cfg.dual_tree
            cu.cclm, cu.lm_symbol, cu.chroma_mode = \
                self._parse_intra_chroma_mode(cclm_ok, cu.mode)

        joint = False
        lev_y = lev_u = lev_v = None
        cbf_y = last_pos_y = violates = None
        ts_y = ts_u = ts_v = False
        if cu.isp:
            st = {}

            def _chroma_cbfs():
                st["u"] = bool(dec.decode_bin(ctx("QtCbf1", 0)))
                st["v"] = bool(dec.decode_bin(
                    ctx("QtCbf2", 1 if st["u"] else 0)))

            def _jccr():
                mask = (2 if st["u"] else 0) + (1 if st["v"] else 0)
                st["j"] = bool(cfg.joint_cbcr and mask and dec.decode_bin(
                    ctx("JointCbCrFlag", mask - 1)))

            subs = self._parse_isp_tus(cu, _chroma_cbfs, _jccr)
            cbf_u, cbf_v, joint = st["u"], st["v"], st.get("j", False)
            if cbf_u:
                lev_u, _, _, ts_u = self._parse_resid(cw, chh, False)
            if cbf_v and not (joint and cbf_u):
                lev_v, _, _, ts_v = self._parse_resid(cw, chh, False)
            comps = [(sw, sh, lv) for (cbf, lv, (_, _, sw, sh)) in subs
                     if cbf]
            if cbf_u and not ts_u:
                comps.append((cw, chh, lev_u))
            if cbf_v and not (ts_v or (joint and ts_u)):
                comps.append((cw, chh, lev_v if lev_v is not None
                              else lev_u))
            ts_used = (cbf_u and ts_u) or (cbf_v and (ts_v or
                                                      (joint and ts_u)))
            lfnst_idx = self._parse_lfnst_idx(cu, comps, False,
                                              ts_used=ts_used)
            assert lfnst_idx == 0, "encoder never pairs LFNST with ISP"
            mts_idx = 0
        else:
            # BDPCM overrides the cbf contexts (cbf_comp, :2638-2652)
            cbf_u = bool(dec.decode_bin(
                ctx("QtCbf1", 1 if cu.bdpcm_c else 0)))
            cbf_v = bool(dec.decode_bin(
                ctx("QtCbf2", 2 if cu.bdpcm_c else (1 if cbf_u else 0))))
            cbf_y = bool(dec.decode_bin(
                ctx("QtCbf0", 1 if cu.bdpcm else 0)))
            mask = (2 if cbf_u else 0) + (1 if cbf_v else 0)
            if cfg.joint_cbcr and mask:
                joint = bool(dec.decode_bin(ctx("JointCbCrFlag",
                                                mask - 1)))
            if cbf_y:
                lev_y, last_pos_y, violates, ts_y = \
                    self._parse_resid(w, h, True, bdpcm=cu.bdpcm)
            if cbf_u:
                lev_u, _, _, ts_u = self._parse_resid(
                    cw, chh, False, bdpcm=cu.bdpcm_c)
            if cbf_v and not (joint and cbf_u):
                lev_v, _, _, ts_v = self._parse_resid(
                    cw, chh, False, bdpcm=cu.bdpcm_c)
            comps = []
            if cbf_y and not ts_y:
                comps.append((w, h, lev_y))
            if cbf_u and not ts_u:
                comps.append((cw, chh, lev_u))
            if cbf_v and not (ts_v or (joint and ts_u)):
                comps.append((cw, chh, lev_v if not joint else lev_u))
            ts_used = ((cbf_y and ts_y) or (cbf_u and ts_u)
                       or (cbf_v and (ts_v or (joint and ts_u))))
            lfnst_idx = self._parse_lfnst_idx(cu, comps, False,
                                              ts_used=ts_used)
            mts_idx = 0
            if lfnst_idx == 0 and not ts_y:
                mts_idx = self._parse_mts_idx(
                    w, h, cbf_y, last_pos_y if cbf_y else -1,
                    violates if cbf_y else False)

        # ---- recon (luma first: CCLM reads the co-located luma) ----
        qp_y = cfg.qp + self.qp_bd_offset
        if cu.isp:
            self._recon_isp(cu, subs, qp_y)
        elif cu.bdpcm:
            pred_y = self._bdpcm_pred(cu, True)
            rr = self._recon_resid(
                self._inv_res_dpcm(lev_y, cu.bdpcm), w, h, qp_y,
                ts=True) if cbf_y else 0
            self.recon_y[y:y + h, x:x + w] = np.clip(
                pred_y + rr, 0, (1 << cfg.bit_depth) - 1)
        else:
            pred_y = self._pred_luma(cu)
            rr = self._recon_resid(lev_y, w, h, qp_y, mts_idx, lfnst_idx,
                                   cu.mode, ts=ts_y) if cbf_y else 0
            self.recon_y[y:y + h, x:x + w] = np.clip(
                pred_y + rr, 0, (1 << cfg.bit_depth) - 1)

        if cu.bdpcm_c:
            pred_u, pred_v = self._bdpcm_pred(cu, False)
            if cbf_u:
                lev_u = self._inv_res_dpcm(lev_u, cu.bdpcm_c)
            if cbf_v and lev_v is not None:
                lev_v = self._inv_res_dpcm(lev_v, cu.bdpcm_c)
        else:
            pred_u, pred_v = self._pred_chroma(cu, self.coded)
        crs = self._crs_scale(x, y, cw, chh)
        qp_c = self._chroma_qp()
        rec_u, rec_v = self._recon_chroma_pair(
            pred_u, pred_v, lev_u, lev_v, cbf_u, cbf_v, joint,
            cw, chh, qp_c, crs, ts_u=ts_u, ts_v=ts_v)
        self.recon_u[cy:cy + chh, cx:cx + cw] = rec_u
        self.recon_v[cy:cy + chh, cx:cx + cw] = rec_v
        self.unit_joint2[cy // 2:(cy + chh) // 2,
                         cx // 2:(cx + cw) // 2] = \
            bool(joint and cbf_u and cbf_v)
        self._mark_luma(cu)
        self.leaf_c.append((cx, cy, cw, chh))

    def _decode_luma_cu(self, cu: CuInfo):
        """Dual-tree luma CU (mirror of FrameEncoder._encode_luma_cu)."""
        cfg, dec, rp = self.cfg, self.dec, self.rp
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        cu.bdpcm = self._parse_bdpcm_mode(cu, True)
        if cu.bdpcm:
            cu.mode = 18 if cu.bdpcm == 1 else 50
        else:
            self._parse_intra_luma_mode(cu)
        qp_y = cfg.qp + self.qp_bd_offset
        if cu.isp:
            subs = self._parse_isp_tus(cu)
            comps = [(sw, sh, lv) for (cbf, lv, (_, _, sw, sh)) in subs
                     if cbf]
            lfnst_idx = self._parse_lfnst_idx(cu, comps, True)
            assert lfnst_idx == 0
            self._recon_isp(cu, subs, qp_y)
        else:
            cbf_y = bool(dec.decode_bin(
                ctx("QtCbf0", 1 if cu.bdpcm else 0)))
            lev_y = last_pos_y = violates = None
            ts_y = False
            if cbf_y:
                lev_y, last_pos_y, violates, ts_y = \
                    self._parse_resid(w, h, True, bdpcm=cu.bdpcm)
            lfnst_idx = self._parse_lfnst_idx(
                cu, [(w, h, lev_y)] if cbf_y and not ts_y else [], True,
                ts_used=cbf_y and ts_y)
            mts_idx = 0
            if lfnst_idx == 0 and not ts_y:
                mts_idx = self._parse_mts_idx(
                    w, h, cbf_y, last_pos_y if cbf_y else -1,
                    violates if cbf_y else False)
            if cu.bdpcm:
                pred_y = self._bdpcm_pred(cu, True)
                rr = self._recon_resid(
                    self._inv_res_dpcm(lev_y, cu.bdpcm), w, h, qp_y,
                    ts=True) if cbf_y else 0
            else:
                pred_y = self._pred_luma(cu)
                rr = self._recon_resid(lev_y, w, h, qp_y, mts_idx,
                                       lfnst_idx, cu.mode,
                                       ts=ts_y) if cbf_y else 0
            self.recon_y[y:y + h, x:x + w] = np.clip(
                pred_y + rr, 0, (1 << cfg.bit_depth) - 1)
        self._mark_luma(cu)

    def _decode_chroma_cu(self, cu: CuInfo, split_path=(None, None),
                          scipu=False):
        """Dual-tree chroma CU (mirror of _encode_chroma_cu); also the
        region chroma CU of a single-tree SCIPU local dual tree
        (``scipu``: CCLM always allowed, reference availability from
        the single-tree coded grid)."""
        cfg, dec, rp = self.cfg, self.dec, self.rp
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        cu.mode = int(self.unit_mode[(y + h // 2) // 4,
                                     (x + w // 2) // 4])
        cu.bdpcm_c = self._parse_bdpcm_mode(cu, False)
        if cu.bdpcm_c:
            cu.cclm, cu.lm_symbol = False, 0
            cu.chroma_mode = 18 if cu.bdpcm_c == 1 else 50
        else:
            cclm_ok = cfg.cclm if scipu else \
                (cfg.cclm and self._cclm_allowed_dual(split_path))
            cu.cclm, cu.lm_symbol, cu.chroma_mode = \
                self._parse_intra_chroma_mode(cclm_ok, cu.mode)
        cbf_u = bool(dec.decode_bin(
            ctx("QtCbf1", 1 if cu.bdpcm_c else 0)))
        cbf_v = bool(dec.decode_bin(
            ctx("QtCbf2", 2 if cu.bdpcm_c else (1 if cbf_u else 0))))
        cbf_mask = (2 if cbf_u else 0) + (1 if cbf_v else 0)
        joint = False
        if cfg.joint_cbcr and cbf_mask:
            joint = bool(dec.decode_bin(ctx("JointCbCrFlag",
                                            cbf_mask - 1)))
        lev_u = lev_v = None
        ts_u = ts_v = False
        lfnst_idx = 0
        if cbf_u:
            lev_u, _, _, ts_u = self._parse_resid(
                cw, chh, False, bdpcm=cu.bdpcm_c)
        if cbf_v and not (joint and cbf_u):
            lev_v, _, _, ts_v = self._parse_resid(
                cw, chh, False, bdpcm=cu.bdpcm_c)
        if min(cw, chh) >= 4:
            comps = []
            if cbf_u and not ts_u:
                comps.append((cw, chh, lev_u))
            if cbf_v and not (joint and cbf_u) and not ts_v:
                comps.append((cw, chh, lev_v))
            ts_used = (cbf_u and ts_u) or (cbf_v and (ts_v or
                                                      (joint and ts_u)))
            # chroma-tree LFNST (xInvLfnst: sep-tree chroma applies it;
            # the kernel-set mode is the CHROMA direction, CCLM -> the
            # co-located luma mode, TrQuant.cpp:xInvLfnst)
            lfnst_idx = self._parse_lfnst_idx(cu, comps, True,
                                              ts_used=ts_used)

        if cu.bdpcm_c:
            pred_u, pred_v = self._bdpcm_pred(cu, False)
            if cbf_u:
                lev_u = self._inv_res_dpcm(lev_u, cu.bdpcm_c)
            if cbf_v and lev_v is not None:
                lev_v = self._inv_res_dpcm(lev_v, cu.bdpcm_c)
        else:
            pred_u, pred_v = self._pred_chroma(
                cu, self.coded if scipu else self.coded_c)
        crs = self._crs_scale(x, y, cw, chh)
        lfnst_mode = cu.mode if (cu.cclm or cu.chroma_mode is None) \
            else cu.chroma_mode
        rec_u, rec_v = self._recon_chroma_pair(
            pred_u, pred_v, lev_u, lev_v, cbf_u, cbf_v, joint,
            cw, chh, self._chroma_qp(), crs, ts_u=ts_u, ts_v=ts_v,
            lfnst_idx=lfnst_idx, lfnst_mode=lfnst_mode)
        self.recon_u[cy:cy + chh, cx:cx + cw] = rec_u
        self.recon_v[cy:cy + chh, cx:cx + cw] = rec_v
        self.unit_joint2[cy // 2:(cy + chh) // 2,
                         cx // 2:(cx + cw) // 2] = \
            bool(joint and cbf_u and cbf_v)
        r, c = y // 4, x // 4
        self.coded_c[r:r + h // 4, c:c + w // 4] = True
        self.unit_bdpcm_c[r:r + h // 4, c:c + w // 4] = cu.bdpcm_c != 0
        self.unit_w_c[r:r + h // 4, c:c + w // 4] = w
        self.unit_h_c[r:r + h // 4, c:c + w // 4] = h
        self.unit_qt_c[r:r + h // 4, c:c + w // 4] = cu.qt_depth
        self.leaf_c.append((cx, cy, cw, chh))

    # ---- coding tree ------------------------------------------------------

    def _decode_tree(self, x, y, w, h, state, local_dual=False):
        cfg = self.cfg
        if x >= cfg.width or y >= cfg.height:
            return
        implicit = get_implicit_split(x, y, w, h, state, cfg)
        split = self._parse_split(x, y, w, h, state)
        if split != Split.NONE:
            scipu = (not local_dual) and self._scipu_cond(w, h, split)
            imp_bt = state.implicit_bt_depth + (
                1 if split == implicit
                and split in (Split.BT_H, Split.BT_V) else 0)
            for i, (nx, ny, nw, nh) in enumerate(
                    self._children(x, y, w, h, split)):
                cstate = SplitState(
                    last_split=split, part_idx=i,
                    qt_depth=state.qt_depth
                    + (1 if split == Split.QT else 0),
                    mtt_depth=state.mtt_depth
                    + (0 if split == Split.QT else 1),
                    implicit_bt_depth=imp_bt)
                self._decode_tree(nx, ny, nw, nh, cstate,
                                  local_dual=local_dual or scipu)
            if scipu:
                # the region's chroma: ONE CU covering the SCIPU node,
                # parsed after the luma subtree (coding_tree
                # chromaNotSplit; CCLM is allowed — checkCCLMAllowed
                # returns true outside slice-level dual tree)
                self.n_scipu = getattr(self, "n_scipu", 0) + 1
                self._decode_chroma_cu(CuInfo(x, y, w, h,
                                              state.qt_depth),
                                       scipu=True)
            return
        if local_dual:
            self._decode_luma_cu(CuInfo(x, y, w, h, state.qt_depth))
        else:
            self._decode_cu(CuInfo(x, y, w, h, state.qt_depth))

    def _decode_tree_ch(self, x, y, w, h, state, chroma, depth64=0,
                        path=(None, None)):
        cfg = self.cfg
        if x >= cfg.width or y >= cfg.height:
            return
        implicit = get_implicit_split(x, y, w, h, state, cfg, chroma)
        split = self._parse_split(x, y, w, h, state, chroma)
        if not chroma and depth64 == 0:
            # actual split of the 64x64 luma node (CU::getSplitAtDepth
            # for checkCCLMAllowed)
            self._luma_root_split = split
        if split != Split.NONE:
            npath = (split if depth64 == 0 else path[0],
                     split if depth64 == 1 else path[1])
            imp_bt = state.implicit_bt_depth + (
                1 if split == implicit
                and split in (Split.BT_H, Split.BT_V) else 0)
            for i, (nx, ny, nw, nh) in enumerate(
                    self._children(x, y, w, h, split)):
                cstate = SplitState(
                    last_split=split, part_idx=i,
                    qt_depth=state.qt_depth
                    + (1 if split == Split.QT else 0),
                    mtt_depth=state.mtt_depth
                    + (0 if split == Split.QT else 1),
                    implicit_bt_depth=imp_bt)
                self._decode_tree_ch(nx, ny, nw, nh, cstate, chroma,
                                     depth64 + 1, npath)
            return
        cu = CuInfo(x, y, w, h, state.qt_depth)
        if chroma:
            npath = (path[0] if depth64 > 0 else None,
                     path[1] if depth64 > 1 else None)
            self._decode_chroma_cu(cu, split_path=npath)
        else:
            self._decode_luma_cu(cu)

    # ---- frame ------------------------------------------------------------

    def decode_frame(self, slice_data: bytes):
        """Decode one slice payload. Returns (recon_y, recon_u, recon_v)."""
        cfg, si = self.cfg, self.si
        self._init_state()
        self._vpdu_adj = {}
        self.dec = BinDecoder(slice_data,
                              ContextStore.standard_init(cfg.qp, 2))
        self.rp = ResidualParser(self.dec, dep_quant=si.dep_quant,
                                 sign_hiding=si.sign_hiding)
        self.rp_ts = TSResidualParser(self.dec)
        sao_params = [] if cfg.sao else None
        n_ctu_x = (cfg.width + 127) // 128
        n_ctu_y = (cfg.height + 127) // 128
        alf_flags = alf_sets = alf_cb = alf_cr = cc_cb = cc_cr = None
        alt_cb = alt_cr = None
        n_alts = 1
        if self.alf_chroma_aps is not None and \
                self.alf_chroma_aps["chroma"] is not None:
            n_alts = self.alf_chroma_aps["chroma"].shape[0]
        if cfg.alf and si.alf_enabled:
            alf_flags = np.zeros((n_ctu_y, n_ctu_x), bool)
            alf_sets = np.zeros((n_ctu_y, n_ctu_x), np.int32)
            if si.alf_cb:
                alf_cb = np.zeros((n_ctu_y, n_ctu_x), bool)
                alt_cb = np.zeros((n_ctu_y, n_ctu_x), np.int32)
            if si.alf_cr:
                alf_cr = np.zeros((n_ctu_y, n_ctu_x), bool)
                alt_cr = np.zeros((n_ctu_y, n_ctu_x), np.int32)
        if si.ccalf_cb:
            cc_cb = np.zeros((n_ctu_y, n_ctu_x), np.int32)
        if si.ccalf_cr:
            cc_cr = np.zeros((n_ctu_y, n_ctu_x), np.int32)
        for cty in range(n_ctu_y):
            for ctx_i in range(n_ctu_x):
                if cfg.sao:
                    idx = cty * n_ctu_x + ctx_i
                    sao_params.append(parse_sao_ctu(
                        self.dec, ctx_i > 0, cty > 0, cfg.bit_depth,
                        left_par=sao_params[idx - 1] if ctx_i > 0
                        else None,
                        above_par=sao_params[idx - n_ctu_x] if cty > 0
                        else None))
                if alf_flags is not None:
                    parse_alf_ctu(self.dec, ctx, cty, ctx_i, alf_flags,
                                  alf_sets,
                                  num_aps=len(si.alf_aps_ids),
                                  flags_cb=alf_cb, flags_cr=alf_cr,
                                  alt_cb=alt_cb, alt_cr=alt_cr,
                                  num_alts=n_alts)
                    if cc_cb is not None or cc_cr is not None:
                        ncb = (self.ccalf_cb_aps["cc_cb"].shape[0]
                               if self.ccalf_cb_aps is not None and
                               self.ccalf_cb_aps["cc_cb"] is not None
                               else 1)
                        ncr = (self.ccalf_cr_aps["cc_cr"].shape[0]
                               if self.ccalf_cr_aps is not None and
                               self.ccalf_cr_aps["cc_cr"] is not None
                               else 1)
                        parse_ccalf_ctu(self.dec, ctx, cty, ctx_i,
                                        cc_cb, cc_cr,
                                        filter_counts=(ncb, ncr))
                bx, by = ctx_i * 128, cty * 128
                if not cfg.dual_tree:
                    self._decode_tree(bx, by, 128, 128, SplitState())
                    continue
                for (qx, qy, qw, qh) in self._children(bx, by, 128, 128,
                                                       Split.QT):
                    if qx >= cfg.width or qy >= cfg.height:
                        continue
                    st = SplitState(last_split=Split.QT, qt_depth=1)
                    self._decode_tree_ch(qx, qy, qw, qh, st, False)
                    self._luma_root_isp = bool(
                        self.unit_isp[qy // 4, qx // 4]) \
                        and int(self.unit_w[qy // 4, qx // 4]) == 64 \
                        and int(self.unit_h[qy // 4, qx // 4]) == 64
                    self._decode_tree_ch(qx, qy, qw, qh, st, True)
        assert self.dec.decode_bin_trm() == 1, "missing end_of_slice bit"

        if self.reshaper is not None:
            self.recon_y = self.reshaper.inv(self.recon_y).astype(np.int32)
        if not cfg.deblocking_disabled:
            qpi = max(-self.qp_bd_offset, min(63, cfg.qp))
            qp_c_db = max(-self.qp_bd_offset,
                          min(63,
                              int(self.qp_table[qpi + self.qp_bd_offset])
                              + cfg.chroma_qp_offset))
            qp_j_db = max(-self.qp_bd_offset,
                          min(63,
                              int(self.qp_table[qpi + self.qp_bd_offset])
                              + cfg.jccr_qp_offset))
            deblock_frame(self.recon_y, self.recon_u, self.recon_v,
                          self.leaf_l, self.leaf_c, cfg.qp, qp_c_db,
                          bit_depth=cfg.bit_depth, ctu_size=cfg.ctu_size,
                          qp_c_joint=qp_j_db, joint2=self.unit_joint2,
                          bdpcm_luma=self.unit_bdpcm,
                          bdpcm_chroma=self.unit_bdpcm_c)
        if cfg.sao:
            apply_sao_frame([self.recon_y, self.recon_u, self.recon_v],
                            sao_params, 128, bit_depth=cfg.bit_depth)
        if alf_flags is not None:
            self.recon_y, self.recon_u, self.recon_v = apply_alf_frame(
                self.recon_y, self.recon_u, self.recon_v,
                alf_flags, alf_sets, self.alf_luma_apss,
                self.alf_chroma_aps, alf_cb, alf_cr,
                cc_cb, cc_cr, alt_cb=alt_cb, alt_cr=alt_cr,
                cc_cb_aps=self.ccalf_cb_aps, cc_cr_aps=self.ccalf_cr_aps,
                bit_depth=cfg.bit_depth, ctu_size=cfg.ctu_size)
        return (self.recon_y.copy(), self.recon_u.copy(),
                self.recon_v.copy())


def decode_stream(data: bytes, verify_hash: bool = True, device=None):
    """Decode an Annex-B stream. Returns (cfg, [per-frame (y, u, v)]).

    With ``verify_hash``, each frame's recon is checked against the
    decoded-picture-hash SEI (DecoderApp "(OK)" equivalent); a mismatch
    raises. ``device``: where the K10 kernels run (``None``: the card,
    raising without CUDA; ``"cpu"``: their plain versions).
    """
    bs: Bitstream = parse_bitstream(data)
    frames = []
    decode_stream.n_scipu = 0        # exposed for tests/stats
    for i, si in enumerate(bs.slices):
        fd = FrameDecoder(bs.cfg, si, device=device)
        recon = fd.decode_frame(si.slice_data)
        decode_stream.n_scipu += getattr(fd, "n_scipu", 0)
        if verify_hash and bs.hashes[i] is not None:
            nbytes = (bs.cfg.bit_depth + 7) // 8
            for plane, want in zip(recon, bs.hashes[i]):
                dat = (np.asarray(plane).astype("<u2").tobytes()
                       if nbytes == 2 else
                       np.asarray(plane).astype(np.uint8).tobytes())
                got = hashlib.md5(dat).digest()
                assert got == want, f"picture hash mismatch on frame {i}"
        frames.append(recon)
    return bs.cfg, frames
