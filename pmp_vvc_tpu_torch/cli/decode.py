"""CLI: decode a VVC all-intra bitstream to YUV (DecoderApp counterpart),
on the card.

The port of the JAX package's ``cli/decode.py``: prints per-frame POC
lines with "(OK)" / "(MISMATCH)" decoded-picture-hash verdicts like the
stock VTM DecoderApp, writes 16-bit (10-bit content) or 8-bit planar
YUV420. The decoder's K10 kernels run on ``--device`` (default: the card;
``cpu`` runs their plain versions). Returns 1 if a hash mismatched.

Usage:
  python -m pmp_vvc_tpu_torch.cli.decode -b out.bin -o dec.yuv [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-b", "--bitstream", required=True)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--no-hash-check", action="store_true",
                    help="skip decoded-picture-hash SEI verification")
    ap.add_argument("--device", default=None,
                    help="where the kernels run (default: the card; 'cpu' "
                         "runs their plain versions)")
    args = ap.parse_args(argv)

    from ..codec.decoder import FrameDecoder
    from ..codec.hlsparse import parse_bitstream

    data = open(args.bitstream, "rb").read()
    bs = parse_bitstream(data)
    cfg = bs.cfg
    print(f"SPS: {cfg.width}x{cfg.height} {cfg.bit_depth}-bit QP{cfg.qp} "
          f"CTU{cfg.ctu_size}"
          + (" dual-tree" if cfg.dual_tree else ""))
    out = open(args.output, "wb") if args.output else None
    nbytes = (cfg.bit_depth + 7) // 8
    mismatches = 0
    t0 = time.time()
    for i, si in enumerate(bs.slices):
        fd = FrameDecoder(cfg, si, device=args.device)
        recon = fd.decode_frame(si.slice_data)
        verdict = ""
        if not args.no_hash_check and bs.hashes[i] is not None:
            ok = True
            for plane, want in zip(recon, bs.hashes[i]):
                dat = (np.asarray(plane).astype("<u2").tobytes()
                       if nbytes == 2 else
                       np.asarray(plane).astype(np.uint8).tobytes())
                ok &= hashlib.md5(dat).digest() == want
            verdict = " [MD5:16,(OK)]" if ok else " [MD5:16,(MISMATCH)]"
            mismatches += 0 if ok else 1
        print(f"POC {si.poc:4d} ( I-SLICE, QP {cfg.qp} ){verdict}")
        if out is not None:
            for plane in recon:
                arr = np.asarray(plane)
                out.write(arr.astype("<u2").tobytes() if nbytes == 2
                          else arr.astype(np.uint8).tobytes())
    if out is not None:
        out.close()
    dt = time.time() - t0
    print(f"decoded {len(bs.slices)} frame(s) in {dt:.2f}s")
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
