"""Map-driven QTMT partition scheduling.

Derives, for every CTU, the concrete partition tree (and flat leaf-CU list)
implied by the predicted partition maps — replacing VTM's recursive RDO
search with a single decision path per node.

Contracts:
- edge/direction/QT-depth map queries: QTBTPartitioner::mapBasedCanSplit
  (UnitPartitioner.cpp:469-546) — 6 candidate split edges tested for full
  presence, unanimous-direction vote, QT gating by predicted depth + 1
  (the implicit 128->64 split).
- decision priority + BT/TT disambiguation + accel levels:
  EncModeCtrlMTnoRQT::initCULevel (EncModeCtrl.cpp:1225-1345):
  exactly one split survives, priority QT > TTV > TTH > BTV > BTH; a
  BH/TH (BV/TV) tie is resolved by probing the would-be TT middle child
  one level deeper; acceleration level L in {0,1,2,3}: the map drives
  nodes with mttDepth < L (L>0), or all nodes while qtDepth < predicted
  (L==0); outside the gate the reference falls back to full RDO — those
  nodes are flagged ``needs_rdo`` here.

Coordinates follow the reference's convention: x = row, y = column,
h along rows, w along columns, all in luma pels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np


class Split(IntEnum):
    NONE = 0
    QT = 1
    BT_H = 2
    BT_V = 3
    TT_H = 4
    TT_V = 5


@dataclass(frozen=True)
class PartitionConstraints:
    """VVC partition legality (CTC all-intra defaults; sizes in luma pels).

    For the chroma tree of a dual-tree I-slice, sizes here stay in luma
    units; ``chroma`` doubles the minimum split sizes (min chroma CB 4x4
    chroma samples = 8x8 luma units for 4:2:0).
    """

    ctu_size: int = 128
    min_qt: int = 8
    max_bt: int = 32
    max_tt: int = 32
    max_mtt_depth: int = 3
    min_cb: int = 4
    chroma: bool = False

    def scale(self) -> int:
        return 2 if self.chroma else 1

    def can_split(self, split: Split, w: int, h: int, qt_depth: int,
                  mtt_depth: int) -> bool:
        s = self.scale()
        if split == Split.QT:
            return (w == h and w > max(self.min_qt * s, self.min_cb * s)
                    and mtt_depth == 0)
        if mtt_depth >= self.max_mtt_depth:
            return False
        # max sizes are signalled and compared in LUMA units for both
        # channel trees (UnitPartitioner.cpp canSplit: area = currArea().Y())
        if split == Split.BT_H:
            return h > self.min_cb * s and max(w, h) <= self.max_bt
        if split == Split.BT_V:
            return w > self.min_cb * s and max(w, h) <= self.max_bt
        if split == Split.TT_H:
            return (h >= 2 * self.min_cb * s * 2
                    and max(w, h) <= min(self.max_tt, 64))
        if split == Split.TT_V:
            return (w >= 2 * self.min_cb * s * 2
                    and max(w, h) <= min(self.max_tt, 64))
        return False


def split_children(x, y, h, w, split: Split):
    if split == Split.QT:
        h2, w2 = h // 2, w // 2
        return [(x, y, h2, w2), (x, y + w2, h2, w2),
                (x + h2, y, h2, w2), (x + h2, y + w2, h2, w2)]
    if split == Split.BT_H:
        return [(x, y, h // 2, w), (x + h // 2, y, h // 2, w)]
    if split == Split.BT_V:
        return [(x, y, h, w // 2), (x, y + w // 2, h, w // 2)]
    if split == Split.TT_H:
        return [(x, y, h // 4, w), (x + h // 4, y, h // 2, w),
                (x + 3 * h // 4, y, h // 4, w)]
    if split == Split.TT_V:
        return [(x, y, h, w // 4), (x, y + w // 4, h, w // 2),
                (x, y + 3 * w // 4, h, w // 4)]
    return [(x, y, h, w)]


@dataclass
class CuNode:
    x: int
    y: int
    h: int
    w: int
    qt_depth: int
    mtt_depth: int
    split: Split = Split.NONE
    needs_rdo: bool = False
    children: list = field(default_factory=list)

    def leaves(self):
        if not self.children:
            yield self
        else:
            for c in self.children:
                yield from c.leaves()


class MapPartitioner:
    """Partition-tree derivation from frame-level maps (one component)."""

    def __init__(self, hor, ver, qt, dire, *, accel_level: int = 3,
                 constraints: PartitionConstraints | None = None):
        self.hor = np.asarray(hor)          # (H/4, W/4) edge flags
        self.ver = np.asarray(ver)
        self.qt = np.asarray(qt)            # (H/8, W/8) predicted QT depth
        self.dire = np.asarray(dire)        # (3, H/4, W/4) in {-1, 0, 1, 2}
        self.level = accel_level
        self.c = constraints or PartitionConstraints()
        self.rows = self.hor.shape[0]       # in 4-pel units
        self.cols = self.hor.shape[1]

    # ---- map queries (mapBasedCanSplit) ----------------------------------

    def _unanimous_direction(self, x, y, h, w, mtt_depth) -> int:
        if mtt_depth >= 3:
            return 0
        win = self.dire[mtt_depth, x >> 2:(x + h) >> 2, y >> 2:(y + w) >> 2]
        first = int(win[0, 0])
        # reference scans i in [1, h/4), j in [1, w/4) — the first row and
        # column beyond [0,0] are NOT fully checked (UnitPartitioner.cpp:480)
        sub = win[1:, 1:]
        if sub.size and not (sub == first).all():
            return 0
        return first

    def _edge_full(self, kind: str, x, y, h, w, frac) -> bool:
        if kind == "hor":
            row = (x + (h * frac) // 4) >> 2
            seg = self.hor[row, y >> 2:(y + w) >> 2]
        else:
            col = (y + (w * frac) // 4) >> 2
            seg = self.ver[x >> 2:(x + h) >> 2, col]
        return bool((seg != 0).all())

    def map_can_split(self, x, y, h, w, qt_depth, mtt_depth, plus_depth=0):
        """mapBasedCanSplit contract. Returns dict of 5 booleans."""
        pred_qt = int(self.qt[x >> 3, y >> 3]) + 1
        direction = self._unanimous_direction(x, y, h, w,
                                              mtt_depth + plus_depth)
        hor1 = self._edge_full("hor", x, y, h, w, 1)
        hor2 = self._edge_full("hor", x, y, h, w, 2)
        hor3 = self._edge_full("hor", x, y, h, w, 3)
        ver1 = self._edge_full("ver", x, y, h, w, 1)
        ver2 = self._edge_full("ver", x, y, h, w, 2)
        ver3 = self._edge_full("ver", x, y, h, w, 3)
        return {
            Split.QT: h >= 16 and h == w and qt_depth < pred_qt
            and hor2 and ver2,
            Split.BT_H: h >= 8 and hor2 and direction == 1,
            Split.BT_V: w >= 8 and ver2 and direction in (-1, 2),
            Split.TT_H: h >= 16 and hor1 and hor3 and direction == 1,
            Split.TT_V: w >= 16 and ver1 and ver3 and direction in (-1, 2),
        }

    # ---- decision (initCULevel) ------------------------------------------

    def _covered(self, x, y, h, w) -> bool:
        return (x + h) <= self.rows * 4 and (y + w) <= self.cols * 4

    def _gated(self, x, y, h, w, qt_depth, mtt_depth) -> bool:
        if not self._covered(x, y, h, w):
            return False
        if self.level > 0:
            return mtt_depth < self.level
        pred_qt = int(self.qt[x >> 3, y >> 3]) + 1
        return qt_depth < pred_qt and mtt_depth < 3

    def decide(self, x, y, h, w, qt_depth, mtt_depth,
               last_split=Split.NONE, part_idx=0):
        """One split decision: (Split, needs_rdo)."""
        if not self._gated(x, y, h, w, qt_depth, mtt_depth):
            # outside the map gate the reference runs stock RDO; that is a
            # real deferral only if some split is still legal here
            any_legal = any(
                self.c.can_split(s, w, h, qt_depth, mtt_depth)
                for s in (Split.QT, Split.BT_H, Split.BT_V,
                          Split.TT_H, Split.TT_V))
            return Split.NONE, any_legal
        can = self.map_can_split(x, y, h, w, qt_depth, mtt_depth)
        c = self.c
        for s in (Split.QT, Split.BT_H, Split.BT_V, Split.TT_H, Split.TT_V):
            can[s] = can[s] and c.can_split(s, w, h, qt_depth, mtt_depth)
        # TT-middle parallel-BT ban (UnitPartitioner.cpp canSplit :419)
        if last_split == Split.TT_H and part_idx == 1:
            can[Split.BT_H] = False
        if last_split == Split.TT_V and part_idx == 1:
            can[Split.BT_V] = False

        if can[Split.BT_H] and can[Split.TT_H]:
            mid = self.map_can_split(x + (h >> 2), y, h >> 1, w,
                                     qt_depth, mtt_depth, plus_depth=1)
            if mid[Split.BT_V] or mid[Split.TT_V]:
                can[Split.BT_H] = False
            else:
                can[Split.TT_H] = False
        elif can[Split.BT_V] and can[Split.TT_V]:
            mid = self.map_can_split(x, y + (w >> 2), h, w >> 1,
                                     qt_depth, mtt_depth, plus_depth=1)
            if mid[Split.BT_H] or mid[Split.TT_H]:
                can[Split.BT_V] = False
            else:
                can[Split.TT_V] = False

        for s in (Split.QT, Split.TT_V, Split.TT_H, Split.BT_V, Split.BT_H):
            if can[s]:
                return s, False
        return Split.NONE, False

    def derive_tree(self, x, y, h, w, qt_depth=0, mtt_depth=0,
                    last_split=Split.NONE, part_idx=0) -> CuNode:
        node = CuNode(x, y, h, w, qt_depth, mtt_depth)
        split, needs_rdo = self.decide(x, y, h, w, qt_depth, mtt_depth,
                                       last_split, part_idx)
        node.split = split
        node.needs_rdo = needs_rdo
        if split != Split.NONE:
            for i, (cx, cy, ch, cw) in enumerate(
                    split_children(x, y, h, w, split)):
                cqt = qt_depth + 1 if split == Split.QT else qt_depth
                cmt = mtt_depth if split == Split.QT else mtt_depth + 1
                node.children.append(
                    self.derive_tree(cx, cy, ch, cw, cqt, cmt, split, i))
        return node

    def derive_ctu(self, ctu_row: int, ctu_col: int, size: int = 64):
        """Derive the tree for one 64x64 map unit (post implicit split).

        The 128 CTU's implicit QT to 64 means every 64x64 unit starts at
        qt_depth 1 (UnitPartitioner.cpp:476 "+1").
        """
        return self.derive_tree(ctu_row * size, ctu_col * size, size, size,
                                qt_depth=1, mtt_depth=0)

    def leaf_cus(self, frame_h: int, frame_w: int):
        """All leaf CUs of the frame, raster CTU order.

        Returns list of (x, y, h, w) and a parallel needs_rdo list.
        """
        leaves, rdo = [], []
        for r in range(frame_h // 64):
            for c in range(frame_w // 64):
                for leaf in self.derive_ctu(r, c).leaves():
                    leaves.append((leaf.x, leaf.y, leaf.h, leaf.w))
                    rdo.append(leaf.needs_rdo)
        return leaves, rdo


def read_partition_txt(path, frame_h: int, frame_w: int):
    """Parse a PartitionMat txt -> per-frame (hor, ver, qt, dire).

    Contract: EncAppCfg.cpp:4301-4396 (the encoder-side loader); frame
    dims are cropped to 64-multiples first (:4246-4249).
    """
    h64, w64 = (frame_h // 64) * 64, (frame_w // 64) * 64
    rows, cols = h64 // 4, w64 // 4
    qrows, qcols = h64 // 8, w64 // 8
    per_frame = 2 * rows * cols + qrows * qcols + 3 * rows * cols
    vals = np.loadtxt(path, dtype=np.int64)
    assert vals.size % per_frame == 0, (vals.size, per_frame)
    n = vals.size // per_frame
    frames = []
    for f in range(n):
        v = vals[f * per_frame:(f + 1) * per_frame]
        o = 0
        hor = v[o:o + rows * cols].reshape(rows, cols); o += rows * cols
        ver = v[o:o + rows * cols].reshape(rows, cols); o += rows * cols
        qt = v[o:o + qrows * qcols].reshape(qrows, qcols); o += qrows * qcols
        dire = v[o:].reshape(3, rows, cols)
        frames.append((hor, ver, qt, dire))
    return frames
