"""YUV420 ingest and CTU blocking.

Functional contracts:
- ``read_yuv420``  : Inference_QBD.py:78-102 / VideoIOYuv.cpp — planar 4:2:0,
  8- or 10-bit little-endian, optional temporal subsampling.
- ``extract_blocks``: Inference_QBD.py:104-149 — per-frame tiling into
  (block+halo) x (block+halo) patches with a top-left zero halo
  (4 px luma / 2 px chroma), raster order.

Blocking is pure reshape/pad on the host; arrays go to device as one batched
transfer (frames x blocks), keeping HBM traffic to a single H2D copy.

A copy of ``pmp_vvc_tpu/data/yuv.py``: the port imports nothing from the JAX
package, so it keeps its own copy of this host numpy code. The public layout
stays NHWC, as there.
"""
from __future__ import annotations

import pathlib

import numpy as np


def read_yuv420(path, width, height, num_frames=None, subsample=1,
                is10bit=False):
    """Read planar YUV420 -> (Y [N,H,W], U, V [N,H/2,W/2]) uint8/uint16."""
    path = pathlib.Path(path)
    dtype = np.uint16 if is10bit else np.uint8
    bpp = 2 if is10bit else 1
    frame_bytes = width * height * 3 // 2 * bpp
    total = path.stat().st_size // frame_bytes
    if num_frames is None:
        num_frames = total
    num_frames = min(num_frames, total)
    pix = width * height
    ys, us, vs = [], [], []
    with open(path, "rb") as fp:
        for i in range(0, num_frames, subsample):
            fp.seek(i * frame_bytes)
            buf = np.frombuffer(fp.read(frame_bytes), dtype=dtype)
            ys.append(buf[:pix].reshape(height, width))
            us.append(buf[pix:pix + pix // 4].reshape(height // 2, width // 2))
            vs.append(buf[pix + pix // 4:].reshape(height // 2, width // 2))
    return np.stack(ys), np.stack(us), np.stack(vs)


def write_yuv420(path, y, u, v):
    """Write planar YUV420 frames; dtype of ``y`` decides 8/10-bit layout."""
    with open(path, "wb") as fp:
        for i in range(y.shape[0]):
            fp.write(y[i].tobytes())
            fp.write(u[i].tobytes())
            fp.write(v[i].tobytes())


def squash_10bit(plane: np.ndarray) -> np.ndarray:
    """10-bit -> 8-bit CNN input squash (round(v/4), clip).

    Contract: Inference_QBD.py:106-109.
    """
    return np.clip(np.round(plane / 4.0), 0, 255).astype(np.uint8)


def extract_blocks(plane: np.ndarray, block_size: int, overlap: int):
    """Tile (N,H,W) frames into (N*nb, bs+overlap, bs+overlap) patches.

    A zero halo of ``overlap`` px is added on top/left of the frame; each
    patch spans [i*bs, (i+1)*bs + overlap) in the padded frame, i.e. carries
    ``overlap`` px of left/top context from its neighbours.
    """
    n, h, w = plane.shape
    bh, bw = h // block_size, w // block_size
    padded = np.zeros((n, h + overlap, w + overlap), dtype=plane.dtype)
    padded[:, overlap:, overlap:] = plane
    k = block_size + overlap
    # gather via stride tricks: windows at stride block_size
    out = np.empty((n, bh, bw, k, k), dtype=plane.dtype)
    for i in range(bh):
        for j in range(bw):
            out[:, i, j] = padded[:, i * block_size:i * block_size + k,
                                  j * block_size:j * block_size + k]
    return out.reshape(n * bh * bw, k, k)


def blocks_for_sequence(y, u, v, *, is10bit=False):
    """Full CNN input prep for one sequence.

    Returns (luma_in [B,68,68,1], chroma_in [B,34,34,3]) float32, where the
    chroma input stacks (2x2-max-pooled Y halo block, U, V) as channels.
    Contract: Inference_QBD.py:190-200 + Metrics.py:81-89.
    """
    if is10bit:
        y, u, v = squash_10bit(y), squash_10bit(u), squash_10bit(v)
    by = extract_blocks(y, 64, 4).astype(np.float32)
    bu = extract_blocks(u, 32, 2).astype(np.float32)
    bv = extract_blocks(v, 32, 2).astype(np.float32)
    # 2x2 max pool of the 68x68 luma block -> 34x34
    pooled = by.reshape(-1, 34, 2, 34, 2).max(axis=(2, 4))
    luma_in = by[..., None]
    chroma_in = np.stack([pooled, bu, bv], axis=-1)
    return luma_in, chroma_in
