"""LMCS (luma mapping with chroma scaling) — reshaper + APS syntax.

Contracts:
- LUT construction from the PWL model: Reshape::constructReshaper
  (Reshape.cpp:240-280), FP_PREC=11, PIC_CODE_CW_BINS=16.
- AI (intra) model derivation: EncReshape::initLUTfromdQPModel
  (EncReshape.cpp:1127-1229) — a fixed luma-dQP curve
  dQP(Y10) = clip(0.015*Y - 7.5, -3, 6), slope 2^(dQP/6), zeroed outside
  [16, 235) << (bd-8), integrated and renormalised; pivots snapped to
  LMCS_SEG_NUM=32 segments (adjustLmcsPivot, :1331-1398).
- Chroma residual scaling: Reshape::calculateChromaAdjVpduNei
  (Reshape.cpp:106-190) — 64x64-VPDU above/left mapped-recon average ->
  chromaAdjHelpLUT; residual scaling AreaBuf::scaleSignal
  (Buffer.cpp:416-463), CSCALE_FP_PREC=11.
- APS syntax: HLSWriter::codeAPS / codeLmcsAps (VLCWriter.cpp:505-686),
  NAL_UNIT_PREFIX_APS=17, LMCS_APS type=1.

The AI model is content-independent, so one Reshaper serves the whole
sequence (LMCSUpdateCtrl=1, CTC).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bitstream import BitWriter, nal_unit

PIC_CODE_CW_BINS = 16
LMCS_SEG_NUM = 32
FP_PREC = 11
CSCALE_FP_PREC = 11
NAL_PREFIX_APS = 17
LMCS_APS_TYPE = 1


@dataclass
class ReshapeModel:
    min_bin_idx: int
    max_bin_idx: int
    bin_cw_delta: list            # len 16, valid in [min, max]
    chr_res_scaling_offset: int = 0
    max_nbits_delta_cw: int = 1


def _flog2(v: int) -> int:
    return int(v).bit_length() - 1


class Reshaper:
    """Decoder-exact fwd/inv LUTs + chroma scale from a ReshapeModel."""

    def __init__(self, model: ReshapeModel, bit_depth: int = 10):
        self.model = model
        self.bd = bit_depth
        lut_size = 1 << bit_depth
        init_cw = lut_size // PIC_CODE_CW_BINS
        self.init_cw = init_cw
        bin_cw = np.zeros(PIC_CODE_CW_BINS, np.int32)
        for i in range(model.min_bin_idx, model.max_bin_idx + 1):
            bin_cw[i] = model.bin_cw_delta[i] + init_cw
        self.bin_cw = bin_cw
        self.reshape_pivot = np.zeros(PIC_CODE_CW_BINS + 1, np.int32)
        self.input_pivot = np.arange(PIC_CODE_CW_BINS + 1,
                                     dtype=np.int32) * init_cw
        fwd_scale = np.zeros(PIC_CODE_CW_BINS, np.int32)
        inv_scale = np.zeros(PIC_CODE_CW_BINS, np.int32)
        self.chroma_adj_lut = np.full(PIC_CODE_CW_BINS, 1 << CSCALE_FP_PREC,
                                      np.int32)
        log2_bin = _flog2(init_cw)
        for i in range(PIC_CODE_CW_BINS):
            self.reshape_pivot[i + 1] = self.reshape_pivot[i] + bin_cw[i]
            fwd_scale[i] = (int(bin_cw[i]) * (1 << FP_PREC)
                            + (1 << (log2_bin - 1))) >> log2_bin
            if bin_cw[i]:
                inv_scale[i] = init_cw * (1 << FP_PREC) // int(bin_cw[i])
                self.chroma_adj_lut[i] = init_cw * (1 << FP_PREC) // (
                    int(bin_cw[i]) + model.chr_res_scaling_offset)
        samples = np.arange(lut_size)
        idx = samples // init_cw
        fwd = self.reshape_pivot[idx] + (
            (fwd_scale[idx] * (samples - self.input_pivot[idx])
             + (1 << (FP_PREC - 1))) >> FP_PREC)
        self.fwd_lut = np.clip(fwd, 0, lut_size - 1).astype(np.int32)
        idx_inv = self._pwl_idx_inv(samples)
        inv = self.input_pivot[idx_inv] + (
            (inv_scale[idx_inv] * (samples - self.reshape_pivot[idx_inv])
             + (1 << (FP_PREC - 1))) >> FP_PREC)
        self.inv_lut = np.clip(inv, 0, lut_size - 1).astype(np.int32)

    def _pwl_idx_inv(self, vals):
        """getPWLIdxInv (Reshape.cpp:203-214), vectorised."""
        m = self.model
        out = np.full(np.shape(vals), m.min_bin_idx, np.int32)
        for i in range(m.min_bin_idx, m.max_bin_idx + 1):
            out = np.where(np.asarray(vals) >= self.reshape_pivot[i + 1],
                           i + 1, out)
        return np.minimum(out, PIC_CODE_CW_BINS - 1)

    def fwd(self, plane):
        return self.fwd_lut[np.asarray(plane, np.int32)]

    def inv(self, plane):
        return self.inv_lut[np.asarray(plane, np.int32)]

    def chroma_adj(self, avg_luma: int) -> int:
        return int(self.chroma_adj_lut[int(self._pwl_idx_inv(avg_luma))])


def scale_chroma_residual_fwd(resi, scale, bit_depth=10):
    """Encoder-side forward scaling (scaleSignal dir=1)."""
    resi = np.asarray(resi, np.int64)
    max_abs = (1 << bit_depth) - 1
    sign = np.where(resi >= 0, 1, -1)
    absval = np.abs(resi)
    out = sign * (((absval << CSCALE_FP_PREC) + (scale >> 1)) // scale)
    return np.clip(out, -max_abs, max_abs).astype(np.int32)


def scale_chroma_residual_inv(resi, scale, bit_depth=10):
    """Decoder-side inverse scaling (scaleSignal dir=0)."""
    resi = np.asarray(resi, np.int64)
    max_abs = (1 << bit_depth) - 1
    resi = np.clip(resi, -max_abs - 1, max_abs)
    sign = np.where(resi >= 0, 1, -1)
    absval = np.abs(resi)
    out = sign * ((absval * scale + (1 << (CSCALE_FP_PREC - 1)))
                  >> CSCALE_FP_PREC)
    return np.clip(out, -32768, 32767).astype(np.int32)


def derive_ai_model(bit_depth: int = 10,
                    chr_offset: int = 2) -> ReshapeModel:
    """EncReshape::initLUTfromdQPModel — the AI SDR reshape model."""
    lut_size = 1 << bit_depth
    init_cw = lut_size // PIC_CODE_CW_BINS
    slope = np.zeros(lut_size)
    for i in range(lut_size):
        y10 = (i << (10 - bit_depth)) if bit_depth < 10 else \
            (i >> (bit_depth - 10)) if bit_depth > 10 else i
        dqp = min(max(0.015 * y10 - 7.5, -3.0), 6.0)
        slope[i] = 2.0 ** (dqp / 6.0)
    slope[:16 << (bit_depth - 8)] = 0.0
    slope[235 << (bit_depth - 8):] = 0.0
    fwd_hp = np.concatenate([[0.0], np.cumsum(slope[:-1])])
    fwd = np.int64(fwd_hp / fwd_hp[-1] * (lut_size - 1) + 0.5)

    min_bin, max_bin = 1, PIC_CODE_CW_BINS - 2
    pivot = np.zeros(PIC_CODE_CW_BINS + 1, np.int64)
    for i in range(PIC_CODE_CW_BINS):
        pivot[i] = fwd[i * init_cw]
    pivot[PIC_CODE_CW_BINS] = lut_size - 1
    bin_cw = np.diff(pivot).astype(np.int64)

    # adjustLmcsPivot (EncReshape.cpp:1331-1398)
    org_cw = init_cw
    log2_seg = bit_depth - _flog2(LMCS_SEG_NUM)
    pivot[0] = 0
    for i in range(PIC_CODE_CW_BINS):
        pivot[i + 1] = pivot[i] + bin_cw[i]
    seg_idx_max = int(pivot[max_bin + 1]) >> log2_seg
    i = min_bin
    while i <= max_bin:
        pivot[i + 1] = pivot[i] + bin_cw[i]
        seg_curr = int(pivot[i]) >> log2_seg
        seg_next = int(pivot[i + 1]) >> log2_seg
        if seg_curr == seg_next and pivot[i] != (seg_curr << log2_seg):
            if seg_curr == seg_idx_max:
                pivot[i] = pivot[max_bin + 1]
                for j in range(i, max_bin + 1):
                    pivot[j + 1] = pivot[i]
                    bin_cw[j] = 0
                bin_cw[i - 1] = pivot[i] - pivot[i - 1]
                break
            adjust = ((seg_curr + 1) << log2_seg) - int(pivot[i + 1])
            pivot[i + 1] += adjust
            bin_cw[i] += adjust
            for j in range(i + 1, max_bin + 1):
                if bin_cw[j] < adjust + (org_cw >> 3):
                    adjust -= int(bin_cw[j]) - (org_cw >> 3)
                    bin_cw[j] = org_cw >> 3
                else:
                    bin_cw[j] -= adjust
                    adjust = 0
                if adjust == 0:
                    break
        i += 1
    for i in range(PIC_CODE_CW_BINS - 1, -1, -1):
        if bin_cw[i] > 0:
            max_bin = i
            break

    deltas = [0] * PIC_CODE_CW_BINS
    max_abs = 0
    for i in range(min_bin, max_bin + 1):
        deltas[i] = int(bin_cw[i]) - init_cw
        max_abs = max(max_abs, abs(deltas[i]))
    nbits = max(1, 1 + _flog2(max_abs)) if max_abs else 1
    return ReshapeModel(min_bin, max_bin, deltas, chr_offset, nbits)


def lmcs_aps_nal(model: ReshapeModel, aps_id: int = 0,
                 chroma_present: bool = True) -> bytes:
    """Prefix-APS NAL with the LMCS payload (codeAPS/codeLmcsAps)."""
    bw = BitWriter()
    bw.write(LMCS_APS_TYPE, 3)          # aps_params_type
    bw.write(aps_id, 5)                 # adaptation_parameter_set_id
    bw.write_flag(1 if chroma_present else 0)   # aps_chroma_present_flag
    bw.write_uvlc(model.min_bin_idx)
    bw.write_uvlc(PIC_CODE_CW_BINS - 1 - model.max_bin_idx)
    bw.write_uvlc(model.max_nbits_delta_cw - 1)
    for i in range(model.min_bin_idx, model.max_bin_idx + 1):
        d = model.bin_cw_delta[i]
        bw.write(abs(d), model.max_nbits_delta_cw)
        if d != 0:
            bw.write_flag(1 if d < 0 else 0)
    if chroma_present:
        crs = model.chr_res_scaling_offset
        bw.write(abs(crs), 3)
        if crs != 0:
            bw.write_flag(1 if crs < 0 else 0)
    bw.write_flag(0)                    # aps_extension_flag
    bw.write(1, 1)
    bw.byte_align_zero()
    return nal_unit(NAL_PREFIX_APS, bw.bytes())


def parse_lmcs_aps(rbsp: bytes) -> ReshapeModel:
    """Parse mirror of ``lmcs_aps_nal`` (HLSyntaxReader::parseLmcsAps)."""
    from .bitstream import BitReader
    br = BitReader(rbsp)
    assert br.read(3) == LMCS_APS_TYPE, "not an LMCS APS"
    br.read(5)                          # aps id
    chroma_present = br.read_flag()
    min_bin = br.read_uvlc()
    max_bin = PIC_CODE_CW_BINS - 1 - br.read_uvlc()
    nbits = br.read_uvlc() + 1
    deltas = [0] * PIC_CODE_CW_BINS
    for i in range(min_bin, max_bin + 1):
        d = br.read(nbits)
        if d != 0 and br.read_flag():
            d = -d
        deltas[i] = d
    crs = 0
    if chroma_present:
        crs = br.read(3)
        if crs != 0 and br.read_flag():
            crs = -crs
    return ReshapeModel(min_bin, max_bin, deltas, crs, nbits)
