"""Partition-map -> partition-structure reconciliation.

Converts the CNN's raw per-CTU maps (QT-depth 8x8, 3-layer MTT-depth 16x16,
3-layer split-direction 16x16) into the split-edge vectors + cleaned
direction maps consumed by the map-driven encoder.

Functional contract: Map2Partition.py:98-427 — a bounded exhaustive
enumeration of all legal {no, BT-H, BT-V, TT-H, TT-V} split combinations up
to 3 MTT levels consistent with the thresholded maps
(lambda1..5 = 0.7/0.7/1.5/0.3/0.7), scored against the *raw* maps by L1
error with 0.8x direction weight; leaf enumeration order (and therefore
first-minimum tie-breaking) matches the reference exactly.

This is the host-side exact path. Coordinates are in 4-pel (luma) units:
x = row, y = column, h along rows, w along columns.

A copy of ``pmp_vvc_tpu/pmp/map2partition.py``: the port imports nothing
from the JAX package, so it keeps its own copy of this host numpy code.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

LAMBDAS = (0.7, 0.7, 1.5, 0.3, 0.7)

# split types
NO_SPLIT, BT_H, BT_V, TT_H, TT_V = 0, 1, 2, 3, 4


def th_round(x: np.ndarray, thd: float) -> np.ndarray:
    """Snap to {-1, 0, +1} with dead-zone |x| < thd."""
    return np.where(x >= thd, 1.0, np.where(x <= -thd, -1.0, 0.0))


def split_cu(x: int, y: int, h: int, w: int, split_type: int):
    if split_type == NO_SPLIT:
        return [(x, y, h, w)]
    if split_type == BT_H:
        return [(x, y, h // 2, w), (x + h // 2, y, h // 2, w)]
    if split_type == BT_V:
        return [(x, y, h, w // 2), (x, y + w // 2, h, w // 2)]
    if split_type == TT_H:
        return [(x, y, h // 4, w), (x + h // 4, y, h // 2, w),
                (x + (h * 3) // 4, y, h // 4, w)]
    if split_type == TT_V:
        return [(x, y, h, w // 4), (x, y + w // 4, h, w // 2),
                (x, y + (w * 3) // 4, h, w // 4)]
    raise ValueError(f"unknown split type {split_type}")


def apply_split_to_bt(bt: np.ndarray, parts, split_type: int) -> None:
    """Increment MTT-depth over the sub-CUs (+2 on TT outer thirds)."""
    for i, (sx, sy, sh, sw) in enumerate(parts):
        bt[sx:sx + sh, sy:sy + sw] += 1
        if split_type in (TT_H, TT_V) and i != 1:
            bt[sx:sx + sh, sy:sy + sw] += 1


@dataclass
class _Node:
    bt: np.ndarray          # (16,16) int MTT-depth map accumulated so far
    dire: np.ndarray        # (16,16) int direction decided at this level
    depth: int
    cus: list               # [(x, y, h, w)]
    parent: "_Node | None" = None


class MapToPartition:
    """Per-64x64-block reconciliation (one luma or chroma component)."""

    def __init__(self, qt_map, msbt_map, msdire_map, chroma_factor,
                 lambdas=LAMBDAS):
        self.qt_map = np.asarray(qt_map)
        self.ori_msbt = np.asarray(msbt_map, dtype=np.float64)
        self.ori_msdire = np.asarray(msdire_map, dtype=np.float64)
        self.msbt = np.round(self.ori_msbt)
        self.msdire = th_round(self.ori_msdire, 0.5)
        self.cf = chroma_factor
        self.l1, self.l2, self.l3, self.l4, self.l5 = lambdas
        self.par_vec = np.zeros((2, 17, 17), dtype=np.uint8)
        self.out_msdire = np.zeros((3, 16, 16), dtype=np.int8)

    # ---- candidate split enumeration -------------------------------------

    def _candidate_modes(self, x, y, h, w, cur_bt, depth):
        comp = self.msbt[2, x:x + h, y:y + w] - cur_bt[x:x + h, y:y + w]
        if np.count_nonzero(comp == 0) >= self.l1 * h * w:
            return [NO_SPLIT]
        dwin = self.msdire[depth, x:x + h, y:y + w]
        n_hor = np.count_nonzero(dwin == 1)
        n_ver = np.count_nonzero(dwin == -1)
        direction = 0
        if (n_hor + n_ver) >= self.l2 * h * w:
            if n_hor >= self.l3 * n_ver:
                direction = 1
            elif n_ver >= self.l3 * n_hor:
                direction = 2

        cands = [NO_SPLIT]
        bt_tmp = np.empty_like(cur_bt)
        for mode in (BT_H, BT_V, TT_H, TT_V):
            denom = (2 if mode in (BT_H, BT_V) else 4) * self.cf
            dim = h if mode in (BT_H, TT_H) else w
            if dim // denom == 0 or dim % denom != 0:
                continue
            if mode in (BT_H, TT_H) and direction == 2:
                continue
            if mode in (BT_V, TT_V) and direction == 1:
                continue
            parts = split_cu(x, y, h, w, mode)
            bt_tmp[:, :] = cur_bt
            ok = 0
            for i, (sx, sy, sh, sw) in enumerate(parts):
                bt_tmp[sx:sx + sh, sy:sy + sw] += 1
                if mode in (TT_H, TT_V) and i != 1:
                    bt_tmp[sx:sx + sh, sy:sy + sw] += 1
                comp = (self.msbt[depth, sx:sx + sh, sy:sy + sw]
                        - bt_tmp[sx:sx + sh, sy:sy + sw])
                n = sh * sw
                if (np.count_nonzero(comp < 0) < n * self.l4
                        and np.count_nonzero(comp == 0) > n * self.l5):
                    ok += 1
            if ok == len(parts):
                cands.append(mode)
        return cands

    # ---- tree construction / leaf enumeration ----------------------------

    def _leaves(self, node: _Node):
        """Yield all depth-3 leaves, DFS, combination order matching the
        reference's cartesian product (first CU varies slowest)."""
        if node.depth >= 3:
            yield node
            return
        cand_lists = [self._candidate_modes(*cu, node.bt, node.depth)
                      for cu in node.cus]
        for combo in itertools.product(*cand_lists):
            child_bt = node.bt.copy()
            child_dire = np.zeros_like(node.dire)
            child_cus = []
            for cu, mode in zip(node.cus, combo):
                x, y, h, w = cu
                parts = split_cu(x, y, h, w, mode)
                child_cus += parts
                if mode == NO_SPLIT:
                    child_dire[x:x + h, y:y + w] = 0
                    continue
                child_dire[x:x + h, y:y + w] = 1 if mode in (BT_H, TT_H) else -1
                apply_split_to_bt(child_bt, parts, mode)
            yield from self._leaves(
                _Node(child_bt, child_dire, node.depth + 1, child_cus, node))

    # ---- best-leaf selection ---------------------------------------------

    def _reconcile_bt(self, x, y, h, w):
        root = _Node(np.zeros((16, 16), np.int8), np.zeros((16, 16), np.int8),
                     0, [(x, y, h, w)])
        best_err = None
        best = None
        for leaf in self._leaves(root):
            n1 = leaf.parent
            n0 = n1.parent
            r = (slice(x, x + h), slice(y, y + w))
            err = (np.abs(n0.bt[r] - self.ori_msbt[0][r]).sum()
                   + np.abs(n1.bt[r] - self.ori_msbt[1][r]).sum()
                   + np.abs(leaf.bt[r] - self.ori_msbt[2][r]).sum()
                   + 0.8 * (np.abs(n0.dire[r] - self.ori_msdire[0][r]).sum()
                            + np.abs(n1.dire[r] - self.ori_msdire[1][r]).sum()
                            + np.abs(leaf.dire[r] - self.ori_msdire[2][r]).sum()))
            if best_err is None or err < best_err:
                best_err = err
                best = (n0.dire[r].copy(), n1.dire[r].copy(),
                        leaf.dire[r].copy(), list(leaf.cus))

        d0, d1, d2, cus = best
        r = (slice(x, x + h), slice(y, y + w))
        self.out_msdire[0][r] = d0
        self.out_msdire[1][r] = d1
        self.out_msdire[2][r] = d2
        for cx, cy, ch, cw in cus:
            self.par_vec[0, cx, cy:cy + cw] = 1
            self.par_vec[0, cx + ch, cy:cy + cw] = 1
            self.par_vec[1, cx:cx + ch, cy] = 1
            self.par_vec[1, cx:cx + ch, cy + cw] = 1

    # ---- QT recursion ----------------------------------------------------

    def _qt_recurse(self, depth, qx, qy):
        cur = self.qt_map[qx, qy]
        sub = 8 >> depth
        if cur == depth:
            self._reconcile_bt(2 * qx, 2 * qy, 2 * sub, 2 * sub)
        elif cur > depth:
            self.par_vec[0, 2 * qx + sub, 2 * qy:2 * qy + 2 * sub] = 1
            self.par_vec[1, 2 * qx:2 * qx + 2 * sub, 2 * qy + sub] = 1
            for di in range(2):
                for dj in range(2):
                    self._qt_recurse(depth + 1, qx + di * sub // 2,
                                     qy + dj * sub // 2)

    def get_partition(self):
        self._qt_recurse(0, 0, 0)
        return self.par_vec, self.out_msdire


def map_to_partition(qt_map, bt_map, dire_map, chroma_factor):
    """One block -> (hor edges 16x16, ver edges 16x16, direction 3x16x16)."""
    m = MapToPartition(qt_map, bt_map, dire_map, chroma_factor)
    p, d = m.get_partition()
    return p[0][:16, :16], p[1][:16, :16], d


def blocks_to_frame_partition(qt_blocks, bt_blocks, dire_blocks,
                              frm_width, frm_height, is_luma):
    """Assemble per-block reconciliations into frame-level matrices.

    Returns (hor [H/4,W/4], ver [H/4,W/4], qt [H/8,W/8], dire [3,H/4,W/4])
    for one frame given its blocks in raster order.
    Contract: Map2Partition.py:375-412.
    """
    cf = 1 if is_luma else 2
    bh, bw = frm_height // 64, frm_width // 64
    hor = np.zeros((bh * 16, bw * 16), np.uint8)
    ver = np.zeros((bh * 16, bw * 16), np.uint8)
    qt = np.zeros((bh * 8, bw * 8), np.uint8)
    dire = np.zeros((3, bh * 16, bw * 16), np.int8)
    for bx in range(bh):
        for by in range(bw):
            bid = bx * bw + by
            h, v, d = map_to_partition(qt_blocks[bid], bt_blocks[bid],
                                       dire_blocks[bid], cf)
            hor[bx * 16:(bx + 1) * 16, by * 16:(by + 1) * 16] = h
            ver[bx * 16:(bx + 1) * 16, by * 16:(by + 1) * 16] = v
            qt[bx * 8:(bx + 1) * 8, by * 8:(by + 1) * 8] = qt_blocks[bid]
            dire[:, bx * 16:(bx + 1) * 16, by * 16:(by + 1) * 16] = d
    return hor, ver, qt, dire


def write_partition_txt(path, frames):
    """Serialize per-frame (hor, ver, qt, dire) tuples to the exchange txt.

    Format (one integer per line, per frame): hor edges (H/4*W/4), ver edges
    (H/4*W/4), qt depth (H/8*W/8), direction (3*H/4*W/4).
    Contract: Map2Partition.py:400-412 / EncAppCfg.cpp:4301-4396.
    """
    with open(path, "w") as f:
        for hor, ver, qt, dire in frames:
            for arr, dt in ((hor, np.uint8), (ver, np.uint8),
                            (qt, np.uint8), (dire, np.int8)):
                flat = arr.astype(dt).reshape(-1)
                f.write("\n".join(str(int(v)) for v in flat))
                f.write("\n")
