"""Syntax-class bit statistics (CodingStatistics.h / dtrace counterpart).

Aggregates a recorded bin stream (encoder.RecordingEncoder ops) into
per-context-set counts, the same reporting axis as VTM's
RExt__DECODER_DEBUG_BIT_STATISTICS tables (CodingStatistics.h:1012).
"""
from __future__ import annotations

import json
import pathlib

_DATA = pathlib.Path(__file__).resolve().parent.parent / "codec" / "data"


def _set_ranges():
    with open(_DATA / "ctx_sets.json") as f:
        sets = json.load(f)
    ranges = sorted(((off, off + n, name)
                     for name, (off, n) in sets.items()))
    return ranges


def bin_stats(ops):
    """{syntax_set: ctx_bins} + {"_ep": n, "_ep_rem": n} from recorded ops."""
    ranges = _set_ranges()

    def set_of(ctx_id):
        for lo, hi, name in ranges:
            if lo <= ctx_id < hi:
                return name
        return f"ctx{ctx_id}"

    out = {"_ep": 0, "_ep_rem": 0}
    for op in ops:
        kind = op[0]
        if kind == "b":
            name = set_of(op[2])
            out[name] = out.get(name, 0) + 1
        elif kind == "ep":
            out["_ep"] += 1
        elif kind == "eps":
            out["_ep"] += op[2]
        else:                      # golomb-rice remainder
            out["_ep_rem"] += 1
    return out


def print_bin_stats(stats, top=15):
    """CodingStatistics-style table, largest classes first."""
    rows = sorted(((v, k) for k, v in stats.items() if not k.startswith("_")),
                  reverse=True)
    total = sum(v for v, _ in rows)
    print(f"context bins: {total}  ep bins: {stats.get('_ep', 0)}"
          f"  rice remainders: {stats.get('_ep_rem', 0)}")
    for v, k in rows[:top]:
        print(f"  {k:24s} {v:10d}  ({100.0 * v / max(1, total):5.1f}%)")
