"""Bit-level writers: RBSP bit writer, exp-Golomb codes, NAL packing.

Contracts: BitStream.cpp (OutputBitstream::write, writeAlignOne/Zero),
VLCWriter's WRITE_FLAG/WRITE_CODE/WRITE_UVLC/WRITE_SVLC semantics, and
NALwrite.cpp emulation-prevention (00 00 0x -> 00 00 03 0x).
"""
from __future__ import annotations


class BitWriter:
    """MSB-first bit accumulator (OutputBitstream semantics)."""

    def __init__(self):
        self.out = bytearray()
        self._held = 0
        self._held_bits = 0

    def write(self, value: int, nbits: int):
        assert nbits >= 0 and (nbits >= 64 or value < (1 << nbits) or nbits == 0)
        self._held = (self._held << nbits) | (value & ((1 << nbits) - 1))
        self._held_bits += nbits
        while self._held_bits >= 8:
            self._held_bits -= 8
            self.out.append((self._held >> self._held_bits) & 0xFF)
        self._held &= (1 << self._held_bits) - 1

    def write_flag(self, flag):
        self.write(1 if flag else 0, 1)

    def write_uvlc(self, value: int):
        """ue(v) exp-Golomb."""
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.write(0, length - 1)
        self.write(code, length)

    def write_svlc(self, value: int):
        """se(v): mapped to ue via (2|v| - (v>0))."""
        self.write_uvlc((-2 * value) if value <= 0 else (2 * value - 1))

    def align_one(self):
        """writeAlignOne: pad with 1-bits to the next byte boundary."""
        while self._held_bits:
            self.write(1, 1)

    def byte_align_zero(self):
        if self._held_bits:
            self.write(0, 8 - self._held_bits)

    def append_bytes(self, data: bytes):
        assert self._held_bits == 0, "append on unaligned stream"
        self.out.extend(data)

    @property
    def bit_count(self) -> int:
        return len(self.out) * 8 + self._held_bits

    def bytes(self) -> bytes:
        assert self._held_bits == 0
        return bytes(self.out)


class BitReader:
    """MSB-first bit reader over an RBSP (InputBitstream semantics).

    Mirror of ``BitWriter`` for the native decoder (DecLib counterpart);
    operates on emulation-prevention-free payloads (see
    ``nalparse.remove_emulation_prevention``).
    """

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                 # bit position

    def read(self, nbits: int) -> int:
        v = 0
        p = self.pos
        for _ in range(nbits):
            byte = self.data[p >> 3]
            v = (v << 1) | ((byte >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def read_flag(self) -> bool:
        return bool(self.read(1))

    def read_uvlc(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            assert zeros < 64, "corrupt exp-Golomb code"
        return ((1 << zeros) | self.read(zeros)) - 1 if zeros else 0

    def read_svlc(self) -> int:
        u = self.read_uvlc()
        return (u + 1) >> 1 if u & 1 else -(u >> 1)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7

    def tail_bytes(self) -> bytes:
        """Remaining payload from the next byte boundary."""
        self.byte_align()
        return self.data[self.pos >> 3:]


def rbsp_trailing_bits(bw: BitWriter):
    bw.write(1, 1)
    bw.byte_align_zero()


def add_emulation_prevention(rbsp: bytes) -> bytes:
    """Insert 0x03 after any 00 00 followed by 00/01/02/03 (NALwrite.cpp)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_unit(nal_type: int, payload_rbsp: bytes, *, layer_id: int = 0,
             temporal_id: int = 0, long_start_code: bool = True) -> bytes:
    """Annex-B NAL unit: start code + 2-byte VVC NAL header + EPB'd RBSP.

    Header (spec 7.3.1.2): forbidden_zero(1) nuh_reserved_zero(1)
    nuh_layer_id(6) nal_unit_type(5) nuh_temporal_id_plus1(3).
    """
    hdr = BitWriter()
    hdr.write(0, 1)
    hdr.write(0, 1)
    hdr.write(layer_id, 6)
    hdr.write(nal_type, 5)
    hdr.write(temporal_id + 1, 3)
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + hdr.bytes() + add_emulation_prevention(payload_rbsp)
