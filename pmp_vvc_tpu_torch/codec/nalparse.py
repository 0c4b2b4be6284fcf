"""Annex-B NAL parsing utilities (for golden-stream comparison + debugging)."""
from __future__ import annotations

NAL_NAMES = {
    0: "TRAIL", 1: "STSA", 2: "RADL", 3: "RASL",
    7: "IDR_W_RADL", 8: "IDR_N_LP", 9: "CRA", 10: "GDR",
    12: "OPI", 13: "DCI", 14: "VPS", 15: "SPS", 16: "PPS",
    17: "PREFIX_APS", 18: "SUFFIX_APS", 19: "PH", 20: "AUD",
    21: "EOS", 22: "EOB", 23: "PREFIX_SEI", 24: "SUFFIX_SEI",
}


def split_nals(data: bytes):
    """Yield (nal_type, header2, rbsp_payload) per NAL in an Annex-B stream."""
    i = 0
    starts = []
    while i < len(data) - 3:
        if data[i] == 0 and data[i + 1] == 0:
            if data[i + 2] == 1:
                starts.append(i + 3)
                i += 3
                continue
            if data[i + 2] == 0 and i + 3 < len(data) and data[i + 3] == 1:
                starts.append(i + 4)
                i += 4
                continue
        i += 1
    for k, s in enumerate(starts):
        e = len(data)
        if k + 1 < len(starts):
            e = starts[k + 1]
            # trim trailing start-code prefix bytes
            while e > s and data[e - 1] in (0, 1):
                if data[e - 1] == 1 and e - 3 >= s and data[e - 3] == 0 \
                        and data[e - 2] == 0:
                    e -= 3
                    if e > s and data[e - 1] == 0:
                        e -= 1
                    break
                e -= 1
            else:
                e = starts[k + 1]
        nal = data[s:e]
        if len(nal) < 2:
            continue
        nal_type = (nal[1] >> 3) & 0x1F
        yield nal_type, nal[:2], remove_emulation_prevention(nal[2:])


def remove_emulation_prevention(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(rbsp):
        b = rbsp[i]
        if zeros >= 2 and b == 3 and i + 1 < len(rbsp) and rbsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def nal_summary(data: bytes):
    return [(NAL_NAMES.get(t, str(t)), len(p)) for t, _, p in split_nals(data)]
