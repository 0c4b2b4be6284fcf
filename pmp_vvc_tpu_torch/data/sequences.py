"""JVET CTC test-sequence database.

The reference ships a 26-row CSV (``VVC_Test_Sequences.txt``) consumed by
``Metrics.load_sequences_info`` (Metrics.py:703-731) and
``Inference_QBD.load_sequences_info`` (Inference_QBD.py:48-76) with
host-specific absolute paths.  We bundle the table itself (public JVET
common-test-conditions facts) so the pipeline is self-contained, and keep a
parser for external tables in the same ``name,file,W,H,frames,fps`` format.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional

__all__ = [
    "Sequence", "CTC_SEQUENCES", "load_sequence_table", "get_sequence",
    "sequences_by_class",
]


@dataclasses.dataclass(frozen=True)
class Sequence:
    name: str
    filename: str
    width: int
    height: int
    frames: int
    fps: int
    ctc_class: str = ""

    @property
    def is10bit(self) -> bool:
        return "10bit" in self.filename

    def sub_frame_count(self, subsample_ratio: int = 30) -> int:
        """Frames kept under temporal subsampling (Inference_QBD.py:70)."""
        return (self.frames + subsample_ratio - 1) // subsample_ratio

    def block_count(self, subsample_ratio: int = 30) -> int:
        """64x64 CTU-grid blocks over the kept frames (Metrics.py:727)."""
        return (self.width // 64) * (self.height // 64) * \
            self.sub_frame_count(subsample_ratio)


def _s(name, filename, w, h, n, fps, cls):
    return Sequence(name, filename, w, h, n, fps, cls)


# JVET CTC classes A1/A2 (4K, 10-bit), B (1080p), C (WVGA), D (WQVGA),
# E (720p conference), F (screen content) — the reference's 26-row table.
CTC_SEQUENCES: List[Sequence] = [
    _s("Tango2", "Tango2_3840x2160_60fps_10bit_420.yuv", 3840, 2160, 294, 60, "A1"),
    _s("FoodMarket4", "FoodMarket4_3840x2160_60fps_10bit_420.yuv", 3840, 2160, 300, 60, "A1"),
    _s("Campfire", "CampfireParty_3840x2160_30fps_10bit_420_jvet.yuv", 3840, 2160, 300, 30, "A1"),
    _s("CatRobot1", "CatRobot_3840x2160_60fps_10bit_420_jvet.yuv", 3840, 2160, 300, 60, "A2"),
    _s("DaylightRoad2", "DaylightRoad2_3840x2160_60fps_10bit_420.yuv", 3840, 2160, 300, 60, "A2"),
    _s("ParkRunning3", "ParkRunning3_3840x2160_50fps_10bit_420.yuv", 3840, 2160, 300, 50, "A2"),
    _s("MarketPlace", "MarketPlace_1920x1080_60fps_10bit_420.yuv", 1920, 1080, 600, 60, "B"),
    _s("RitualDance", "RitualDance_1920x1080_60fps_10bit_420.yuv", 1920, 1080, 600, 60, "B"),
    _s("Cactus", "Cactus_1920x1080_50.yuv", 1920, 1080, 500, 50, "B"),
    _s("BasketballDrive", "BasketballDrive_1920x1080_50.yuv", 1920, 1080, 500, 50, "B"),
    _s("BQTerrace", "BQTerrace_1920x1080_60.yuv", 1920, 1080, 600, 60, "B"),
    _s("BasketballDrill", "BasketballDrill_832x480_50.yuv", 832, 480, 500, 50, "C"),
    _s("BQMall", "BQMall_832x480_60.yuv", 832, 480, 600, 60, "C"),
    _s("PartyScene", "PartyScene_832x480_50.yuv", 832, 480, 500, 50, "C"),
    _s("RaceHorsesC", "RaceHorses_832x480_30.yuv", 832, 480, 300, 30, "C"),
    _s("BasketballPass", "BasketballPass_416x240_50.yuv", 416, 240, 500, 50, "D"),
    _s("BQSquare", "BQSquare_416x240_60.yuv", 416, 240, 600, 60, "D"),
    _s("BlowingBubbles", "BlowingBubbles_416x240_50.yuv", 416, 240, 500, 50, "D"),
    _s("RaceHorses", "RaceHorses_416x240_30.yuv", 416, 240, 300, 30, "D"),
    _s("FourPeople", "FourPeople_1280x720_60.yuv", 1280, 720, 600, 60, "E"),
    _s("Johnny", "Johnny_1280x720_60.yuv", 1280, 720, 600, 60, "E"),
    _s("KristenAndSara", "KristenAndSara_1280x720_60.yuv", 1280, 720, 600, 60, "E"),
    _s("BasketballDrillText", "BasketballDrillText_832x480_50.yuv", 832, 480, 500, 50, "F"),
    _s("ChinaSpeed", "ChinaSpeed_1024x768_30.yuv", 1024, 768, 500, 30, "F"),
    _s("SlideEditing", "SlideEditing_1280x720_30.yuv", 1280, 720, 300, 30, "F"),
    _s("SlideShow", "SlideShow_1280x720_20.yuv", 1280, 720, 500, 20, "F"),
]

_BY_NAME = {s.name: s for s in CTC_SEQUENCES}


def get_sequence(name: str) -> Sequence:
    return _BY_NAME[name]


def sequences_by_class(*classes: str) -> List[Sequence]:
    want = set(classes)
    return [s for s in CTC_SEQUENCES if s.ctc_class in want]


def load_sequence_table(path: str, limit: Optional[int] = None,
                        ) -> List[Sequence]:
    """Parse an external table in the reference CSV format.

    Rows: ``name,filename,width,height,frames,fps``; a line containing
    ``end!!!!`` terminates the list (Metrics.py:708-713).
    """
    out: List[Sequence] = []
    with open(path, "r") as fp:
        for line in fp:
            if "end!!!!" in line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            name, filename = parts[0], parts[1]
            w, h, n, fps = (int(p) for p in parts[2:6])
            out.append(Sequence(name, filename, w, h, n, fps,
                                _BY_NAME.get(name, Sequence(
                                    name, filename, w, h, n, fps)).ctc_class))
            if limit is not None and len(out) >= limit:
                break
    return out
