"""Sequence-level prediction pipeline: YUV -> PartitionMat txt.

Counterpart of ``pmp_vvc_tpu/pmp/pipeline.py``: block the sequence, run the
(Q, MSBD) nets and the structural vote per component x QP, reconcile maps,
and write the encoder exchange txt. Each stage's wall time is recorded.
"""
from __future__ import annotations

import pathlib
import time
from dataclasses import dataclass, field

from ..data.yuv import blocks_for_sequence, read_yuv420
from .map2partition import blocks_to_frame_partition, write_partition_txt


@dataclass
class StageTimes:
    blocking: float = 0.0
    net: dict = field(default_factory=dict)      # (comp, qp) -> s
    post: dict = field(default_factory=dict)     # (comp, qp) -> s


def predict_sequence(yuv_path, width, height, *, predictors, out_dir,
                     seq_name=None, num_frames=None, subsample=30,
                     is10bit=False, qps=(22, 27, 32, 37)):
    """Run the full prediction pipeline for one sequence.

    ``predictors``: {("Luma"|"Chroma", qp): CompPredictor}.
    Writes ``<seq>_<comp>_QP<qp>_PartitionMat.txt`` per comp x qp.
    Returns StageTimes; the net stage includes copying the maps back to the
    host, so its time covers the device work.
    """
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    seq_name = seq_name or pathlib.Path(yuv_path).stem
    times = StageTimes()

    t0 = time.perf_counter()
    y, u, v = read_yuv420(yuv_path, width, height, num_frames,
                          subsample=subsample, is10bit=is10bit)
    luma_in, chroma_in = blocks_for_sequence(y, u, v, is10bit=is10bit)
    times.blocking = time.perf_counter() - t0

    n_frames = y.shape[0]
    bw, bh = width // 64, height // 64
    per_frame = bw * bh

    for comp, x in (("Luma", luma_in), ("Chroma", chroma_in)):
        for qp in qps:
            pred = predictors.get((comp, qp))
            if pred is None:
                continue
            t0 = time.perf_counter()
            qt, bt, dire = pred.predict(x)
            times.net[(comp, qp)] = time.perf_counter() - t0

            t0 = time.perf_counter()
            frames = []
            for f in range(n_frames):
                s = slice(f * per_frame, (f + 1) * per_frame)
                frames.append(blocks_to_frame_partition(
                    qt[s], bt[s], dire[s], width, height, comp == "Luma"))
            path = out_dir / f"{seq_name}_{comp}_QP{qp}_PartitionMat.txt"
            write_partition_txt(path, frames)
            times.post[(comp, qp)] = time.perf_counter() - t0
    return times
