"""VVC CABAC engine: binary arithmetic encoder/decoder + probability model.

Byte-exact contracts:
- encoder: BinEncoder.cpp (start :94, encodeBin :354, encodeBinEP :156,
  encodeBinsEP :173, encodeBinTrm :246, encodeAlignedBinsEP :280,
  encodeRemAbsEP :208, writeOut :313, finish :105)
- decoder: BinDecoder.cpp (decodeBin, decodeBinEP, decodeBinsEP,
  decodeBinTrm, decodeRemAbsEP)
- probability model: Contexts.h:87-154 (two-window 10/14-bit estimates,
  per-context adaptation rates), Contexts.cpp (BinProbModel_Std::init,
  renorm table, fractional-bit table)

This host-side engine is the sequential finalizer of the TPU design: the
device emits per-CTU (kind, bin, ctxId) streams during the batched coding
pass; this engine (or its C sibling) turns them into the bitstream.
Context state is held in numpy arrays so bulk operations (estimation,
state snapshots) stay vectorized.
"""
from __future__ import annotations

import pathlib

import numpy as np

PROB_BITS = 15
PROB_BITS_0 = 10
PROB_BITS_1 = 14
MASK_0 = ((1 << PROB_BITS_0) - 1) << (PROB_BITS - PROB_BITS_0)
MASK_1 = ((1 << PROB_BITS_1) - 1) << (PROB_BITS - PROB_BITS_1)
DWS = 8  # default window sizes

RENORM_TABLE_32 = np.array(
    [6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.uint8)

_DATA = pathlib.Path(__file__).resolve().parent / "data"


def init_state(qp: int, init_id: int) -> int:
    """BinProbModel_Std::init (Contexts.cpp) -> p1 state (state<<8)."""
    slope = (init_id >> 3) - 4
    offset = ((init_id & 7) * 18) + 1
    inistate = ((slope * (qp - 16)) >> 1) + offset
    state_clip = min(127, max(1, inistate))
    return state_clip << 8


def rate_from_log2_window(log2_window: int) -> int:
    rate0 = 2 + ((log2_window >> 2) & 3)
    rate1 = 3 + rate0 + (log2_window & 3)
    return 16 * rate0 + rate1


class ContextStore:
    """Vectorized store of BinProbModel_Std states.

    state0/state1: the 10/14-bit probability estimates (stored in 15-bit
    scale); rate: packed adaptation rates (rate0*16 + rate1).
    """

    def __init__(self, n: int):
        half = 1 << (PROB_BITS - 1)
        # plain python lists: the per-bin hot path would pay ~3x for
        # numpy scalar indexing
        self.state0 = [half & MASK_0] * n
        self.state1 = [half & MASK_1] * n
        self.rate = [rate_from_log2_window(DWS)] * n

    @classmethod
    def standard_init(cls, qp: int, init_id: int):
        """Standard-table context init (Ctx::init). Uses the normative
        init states snapshot (codec/data/ctx_init.npz)."""
        with np.load(_DATA / "ctx_init.npz") as z:
            states = z["states"][init_id, qp]      # (NUM_CTX,) p1 sums
            rates = z["rates"]
        store = cls(states.shape[0])
        p1 = states.astype(np.int64)
        store.state0 = ((p1 >> 1) & MASK_0).tolist()
        store.state1 = ((p1 >> 1) & MASK_1).tolist()
        store.rate = rates.astype(np.int64).tolist()
        return store

    def state(self, ctx) -> int:
        return (self.state0[ctx] + self.state1[ctx]) >> 8

    def mps(self, ctx) -> int:
        return self.state(ctx) >> 7

    def get_lps(self, ctx, rng: int) -> int:
        q = self.state(ctx)
        if q & 0x80:
            q = q ^ 0xFF
        return ((q >> 2) * (rng >> 5) >> 1) + 4

    def update(self, ctx, bin_val: int) -> None:
        rate0 = self.rate[ctx] >> 4
        rate1 = self.rate[ctx] & 15
        self.state0[ctx] -= (self.state0[ctx] >> rate0) & MASK_0
        self.state1[ctx] -= (self.state1[ctx] >> rate1) & MASK_1
        if bin_val:
            self.state0[ctx] += (0x7FFF >> rate0) & MASK_0
            self.state1[ctx] += (0x7FFF >> rate1) & MASK_1


RENORM_LIST = [int(v) for v in RENORM_TABLE_32]


class BinEncoder:
    """Byte-exact VVC binary arithmetic encoder."""

    def __init__(self, ctx: ContextStore | None = None):
        self.ctx = ctx
        self.out = bytearray()
        self.start()

    def start(self):
        self.low = 0
        self.range = 510
        self.buffered_byte = 0xFF
        self.num_buffered = 0
        self.bits_left = 23
        self._held_val = 0
        self._held_nbits = 0

    def _write_out(self):
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead == 0xFF:
            self.num_buffered += 1
        elif self.num_buffered > 0:
            carry = lead >> 8
            self.out.append((self.buffered_byte + carry) & 0xFF)
            self.buffered_byte = lead & 0xFF
            fill = (0xFF + carry) & 0xFF
            while self.num_buffered > 1:
                self.out.append(fill)
                self.num_buffered -= 1
        else:
            self.num_buffered = 1
            self.buffered_byte = lead & 0xFF

    def encode_bin(self, bin_val: int, ctx_id: int):
        # inlined BinProbModel_Std get_lps/mps/update (hot path)
        c = self.ctx
        s0 = c.state0[ctx_id]
        s1 = c.state1[ctx_id]
        q = (s0 + s1) >> 8
        qa = q ^ 0xFF if q & 0x80 else q
        lps = ((qa >> 2) * (self.range >> 5) >> 1) + 4
        self.range -= lps
        if bin_val != (q >> 7):
            num_bits = RENORM_LIST[lps >> 3]
            self.bits_left -= num_bits
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            if self.bits_left < 12:
                self._write_out()
        elif self.range < 256:
            self.bits_left -= 1
            self.low <<= 1
            self.range <<= 1
            if self.bits_left < 12:
                self._write_out()
        rate = c.rate[ctx_id]
        r0 = rate >> 4
        r1 = rate & 15
        s0 -= (s0 >> r0) & MASK_0
        s1 -= (s1 >> r1) & MASK_1
        if bin_val:
            s0 += (0x7FFF >> r0) & MASK_0
            s1 += (0x7FFF >> r1) & MASK_1
        c.state0[ctx_id] = s0
        c.state1[ctx_id] = s1

    def encode_bin_ep(self, bin_val: int):
        self.bits_left -= 1
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.bits_left < 12:
            self._write_out()

    def encode_bins_ep(self, bins: int, num_bins: int):
        if self.range == 256:
            self._encode_aligned_bins_ep(bins, num_bins)
            return
        while num_bins > 8:
            num_bins -= 8
            pattern = bins >> num_bins
            self.low = (self.low << 8) + self.range * pattern
            bins -= pattern << num_bins
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        self.low = (self.low << num_bins) + self.range * bins
        self.bits_left -= num_bins
        if self.bits_left < 12:
            self._write_out()

    def _encode_aligned_bins_ep(self, bins: int, num_bins: int):
        rem = num_bins
        while rem > 0:
            n = min(rem, 8)
            new_bins = (bins >> (rem - n)) & ((1 << n) - 1)
            self.low = (self.low << n) + (new_bins << 8)
            rem -= n
            self.bits_left -= n
            if self.bits_left < 12:
                self._write_out()

    def align(self):
        self.range = 256

    def encode_bin_trm(self, bin_val: int):
        self.range -= 2
        if bin_val:
            self.low = (self.low + self.range) << 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_rem_abs_ep(self, value: int, rice_par: int, cutoff: int,
                          max_log2_dyn_range: int = 15):
        threshold = cutoff << rice_par
        if value < threshold:
            length = (value >> rice_par) + 1
            self.encode_bins_ep((1 << length) - 2, length)
            self.encode_bins_ep(value & ((1 << rice_par) - 1), rice_par)
        else:
            max_prefix = 32 - cutoff - max_log2_dyn_range
            code_value = (value >> rice_par) - cutoff
            if code_value >= (1 << max_prefix) - 1:
                prefix_len = max_prefix
                suffix_len = max_log2_dyn_range
            else:
                prefix_len = 0
                while code_value > (2 << prefix_len) - 2:
                    prefix_len += 1
                suffix_len = prefix_len + rice_par + 1
            total_prefix = prefix_len + cutoff
            prefix = (1 << total_prefix) - 1
            suffix = ((code_value - ((1 << prefix_len) - 1)) << rice_par) \
                | (value & ((1 << rice_par) - 1))
            self.encode_bins_ep(prefix, total_prefix)
            self.encode_bins_ep(suffix, suffix_len)

    def finish(self) -> bytes:
        """BinEncoderBase::finish. Returns the whole-byte FIFO; up to 7
        residual bits stay in the held-bit buffer exactly like VTM's
        OutputBitstream (flush them via write_stop_bit_and_align)."""
        if self.low >> (32 - self.bits_left):
            self.out.append((self.buffered_byte + 1) & 0xFF)
            while self.num_buffered > 1:
                self.out.append(0x00)
                self.num_buffered -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.out.append(self.buffered_byte)
            while self.num_buffered > 1:
                self.out.append(0xFF)
                self.num_buffered -= 1
        nbits = 24 - self.bits_left
        self._bit_write((self.low >> 8) & ((1 << nbits) - 1) if nbits else 0,
                        nbits)
        return bytes(self.out)

    def write_stop_bit_and_align(self) -> bytes:
        """rbsp_stop_one_bit + byte alignment (end-of-slice convention)."""
        self._bit_write(1, 1)
        if self._held_nbits:
            self._bit_write(0, 8 - self._held_nbits)
        return bytes(self.out)

    # Sub-byte writes accumulate in a held-bit buffer (OutputBitstream
    # semantics); only whole bytes enter ``out``.
    _held_val: int = 0
    _held_nbits: int = 0

    def _bit_write(self, val: int, nbits: int):
        self._held_val = (self._held_val << nbits) | (val & ((1 << nbits) - 1))
        self._held_nbits += nbits
        while self._held_nbits >= 8:
            self._held_nbits -= 8
            self.out.append((self._held_val >> self._held_nbits) & 0xFF)
        self._held_val &= (1 << self._held_nbits) - 1


class BinDecoder:
    """Byte-exact VVC binary arithmetic decoder."""

    def __init__(self, data: bytes, ctx: ContextStore | None = None):
        self.ctx = ctx
        self.data = data
        self.pos = 0
        self.range = 510
        self.value = (self._read_byte() << 8) + self._read_byte()
        self.bits_needed = -8

    def _read_byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode_bin(self, ctx_id: int) -> int:
        c = self.ctx
        bin_val = c.mps(ctx_id)
        lps = c.get_lps(ctx_id, self.range)
        self.range -= lps
        sr = self.range << 7
        if self.value < sr:
            if self.range < 256:
                self.range <<= 1
                self.value <<= 1
                self.bits_needed += 1
                if self.bits_needed >= 0:
                    self.value += self._read_byte() << self.bits_needed
                    self.bits_needed -= 8
        else:
            bin_val = 1 - bin_val
            num_bits = int(RENORM_TABLE_32[lps >> 3])
            self.value = (self.value - sr) << num_bits
            self.range = lps << num_bits
            self.bits_needed += num_bits
            if self.bits_needed >= 0:
                self.value += self._read_byte() << self.bits_needed
                self.bits_needed -= 8
        c.update(ctx_id, bin_val)
        return bin_val

    def decode_bin_ep(self) -> int:
        self.value += self.value
        self.bits_needed += 1
        if self.bits_needed >= 0:
            self.value += self._read_byte()
            self.bits_needed = -8
        sr = self.range << 7
        if self.value >= sr:
            self.value -= sr
            return 1
        return 0

    def decode_bins_ep(self, num_bins: int) -> int:
        if self.range == 256:
            return self._decode_aligned_bins_ep(num_bins)
        rem = num_bins
        bins = 0
        while rem > 8:
            self.value = (self.value << 8) + \
                (self._read_byte() << (8 + self.bits_needed))
            sr = self.range << 15
            for _ in range(8):
                bins += bins
                sr >>= 1
                if self.value >= sr:
                    bins += 1
                    self.value -= sr
            rem -= 8
        self.bits_needed += rem
        self.value <<= rem
        if self.bits_needed >= 0:
            self.value += self._read_byte() << self.bits_needed
            self.bits_needed -= 8
        sr = self.range << (rem + 7)
        for _ in range(rem):
            bins += bins
            sr >>= 1
            if self.value >= sr:
                bins += 1
                self.value -= sr
        return bins

    def _decode_aligned_bins_ep(self, num_bins: int) -> int:
        """BinDecoder.cpp decodeAlignedBinsEP (range known to be 256)."""
        bins = 0
        rem = num_bins
        while rem > 0:
            n = min(rem, 8)
            new_bins = (self.value >> (15 - n)) & ((1 << n) - 1)
            bins = (bins << n) | new_bins
            self.value = (self.value << n) & 0x7FFF
            rem -= n
            self.bits_needed += n
            if self.bits_needed >= 0:
                self.value |= self._read_byte() << self.bits_needed
                self.bits_needed -= 8
        return bins

    def decode_bin_trm(self) -> int:
        self.range -= 2
        sr = self.range << 7
        if self.value >= sr:
            return 1
        if self.range < 256:
            self.range += self.range
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.value += self._read_byte()
                self.bits_needed = -8
        return 0

    def decode_rem_abs_ep(self, rice_par: int, cutoff: int,
                          max_log2_dyn_range: int = 15) -> int:
        """BinDecoder.cpp:183-210 decodeRemAbsEP."""
        max_prefix = 32 - max_log2_dyn_range
        prefix = 0
        code_word = 0
        while True:
            prefix += 1
            code_word = self.decode_bin_ep()
            if not (code_word and prefix < max_prefix):
                break
        prefix -= 1 - code_word
        length = rice_par
        if prefix < cutoff:
            offset = prefix << rice_par
        else:
            offset = ((1 << (prefix - cutoff)) + cutoff - 1) << rice_par
            length += (max_log2_dyn_range - rice_par
                       if prefix == max_prefix else prefix - cutoff)
        return offset + self.decode_bins_ep(length)
