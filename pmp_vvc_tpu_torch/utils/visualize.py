"""Partition visualizer + encode statistics report.

TPU-native counterparts of the reference debug/reporting subsystems:
- DecLib.cpp:827-996 (Print_Partition_fal): paint CU edges into the
  reconstructed YUV for visual inspection;
- Analyze.h printOut :191: per-frame bits / PSNR summary table.
"""
from __future__ import annotations

import math

import numpy as np


def paint_partition(recon_y, leaf_cus, value=None):
    """Return a copy of the luma plane with CU edges painted.

    ``leaf_cus``: (x, y, w, h) luma leaf CUs (FrameEncoder.leaf_l).
    ``value``: edge sample value (default: plane max = white).
    """
    out = np.asarray(recon_y).copy()
    v = int(out.max()) if value is None else value
    for (x, y, w, h) in leaf_cus:
        out[y, x:x + w] = v
        out[y:y + h, x] = v
        out[min(y + h, out.shape[0]) - 1, x:x + w] = v
        out[y:y + h, min(x + w, out.shape[1]) - 1] = v
    return out


def frame_summary(org, recon, n_bits, bit_depth=10):
    """Per-frame stats dict: bits + per-plane PSNR (Analyze.h printOut)."""
    stats = {"bits": int(n_bits)}
    peak = float((1 << bit_depth) - 1) ** 2
    for name, o, r in zip(("Y", "U", "V"), org, recon):
        mse = float(((np.asarray(r, np.float64)
                      - np.asarray(o, np.float64)) ** 2).mean())
        stats[f"psnr_{name}"] = (math.inf if mse == 0
                                 else 10.0 * math.log10(peak / mse))
    return stats


def print_summary(frames):
    """Sequence summary table (Analyze.h style)."""
    n = len(frames)
    tot_bits = sum(f["bits"] for f in frames)
    avg = {k: sum(f[k] for f in frames) / n
           for k in ("psnr_Y", "psnr_U", "psnr_V")}
    print(f"SUMMARY --------------------------------------------------------")
    print(f"  Total Frames |  Bitrate(bits/frame)  Y-PSNR   U-PSNR   V-PSNR")
    print(f"  {n:12d} |  {tot_bits / n:19.1f}  {avg['psnr_Y']:6.4f}  "
          f"{avg['psnr_U']:6.4f}  {avg['psnr_V']:6.4f}")
    return avg
