"""Training-label synthesis (dataset creation).

Two producers:

1. ``MapToSubMap`` — reference-exact reimplementation of GenMSBtMap.py's
   multi-layer MTT-depth label synthesis (Map_to_SubMap, :89-371): re-runs
   the bounded split-combination search with the stricter thresholds
   (lambda = 0.8/1.0/1.2/0.2/0.2) against the encoder-dumped final BT map
   and records the best leaf's ancestor depth maps as layers 1..3.

2. ``labels_from_tree`` — the native path: our encoder/scheduler already
   knows the full partition tree per CTU, so per-layer labels are read off
   the tree directly (no synthesis step, exact by construction). This is
   the producer used with this framework's own encoder
   (CreateDataSet.py:188-264's role, without the text-dump round trip).

Coordinates: x = row, y = col in 4-pel units (reference convention).
"""
from __future__ import annotations

import itertools

import numpy as np

from ..codec.partition import CuNode, Split


class MapToSubMap:
    """GenMSBtMap.py Map_to_SubMap contract (label-layer synthesis)."""

    def __init__(self, qt_map, bt_map, dire_map, chroma_factor,
                 lambdas=(0.8, 1.0, 1.2, 0.2, 0.2)):
        self.qt_map = np.asarray(qt_map)
        self.bt_map = np.asarray(bt_map)
        self.dire_map = np.asarray(dire_map)
        self.cf = chroma_factor
        self.l1, self.l2, self.l3, self.l4, self.l5 = lambdas
        self.sub_map = np.zeros((3, 16, 16), np.uint8)

    def _split(self, x, y, h, w, mode):
        if mode == 0:
            return [(x, y, h, w)]
        if mode == 1:
            return [(x, y, h // 2, w), (x + h // 2, y, h // 2, w)]
        if mode == 2:
            return [(x, y, h, w // 2), (x, y + w // 2, h, w // 2)]
        if mode == 3:
            return [(x, y, h // 4, w), (x + h // 4, y, h // 2, w),
                    (x + 3 * h // 4, y, h // 4, w)]
        return [(x, y, h, w // 4), (x, y + w // 4, h, w // 2),
                (x, y + 3 * w // 4, h, w // 4)]

    def _candidates(self, x, y, h, w, cur_bt, depth):
        comp = self.bt_map[x:x + h, y:y + w] - cur_bt[x:x + h, y:y + w]
        if np.count_nonzero(comp == 0) >= self.l1 * h * w:
            return [0]
        dwin = self.dire_map[depth, x:x + h, y:y + w]
        n_hor = np.count_nonzero(dwin == 1)
        n_ver = np.count_nonzero(dwin == -1)
        if (n_hor + n_ver) < self.l2 * h * w:
            return [0]
        direction = 0
        if n_hor >= self.l3 * n_ver:
            direction = 1
        elif n_ver >= self.l3 * n_hor:
            direction = 2

        cands = []
        tmp = np.empty_like(cur_bt)
        for mode in (1, 2, 3, 4):
            denom = (2 if mode in (1, 2) else 4) * self.cf
            dim = h if mode in (1, 3) else w
            if dim // denom == 0 or dim % denom != 0:
                continue
            if mode in (1, 3) and direction == 2:
                continue
            if mode in (2, 4) and direction == 1:
                continue
            parts = self._split(x, y, h, w, mode)
            tmp[:, :] = cur_bt
            ok = 0
            for i, (sx, sy, sh, sw) in enumerate(parts):
                tmp[sx:sx + sh, sy:sy + sw] += 1
                if mode in (3, 4) and i != 1:
                    tmp[sx:sx + sh, sy:sy + sw] += 1
                comp = (self.bt_map[sx:sx + sh, sy:sy + sw]
                        - tmp[sx:sx + sh, sy:sy + sw])
                n = sh * sw
                n_minus = np.count_nonzero(comp < 0)
                n_zero = np.count_nonzero(comp == 0)
                if n_minus < n * self.l4 and (
                        n_zero < n * self.l5 or n_zero > n * (1 - self.l5)):
                    ok += 1
            if ok == len(parts):
                cands.append(mode)
        return cands

    def _leaves(self, bt, depth, cus, ancestry):
        """Yield (leaf_bt, ancestry_bts) in reference DFS order."""
        if depth >= 3:
            yield bt, ancestry
            return
        cand_lists = [self._candidates(*cu, bt, depth) for cu in cus]
        if any(len(c) == 0 for c in cand_lists):
            yield bt, ancestry
            return
        got_child = False
        for combo in itertools.product(*cand_lists):
            child_bt = bt.copy()
            child_cus = []
            for cu, mode in zip(cus, combo):
                parts = self._split(*cu, mode)
                child_cus += parts
                if mode == 0:
                    continue
                for i, (sx, sy, sh, sw) in enumerate(parts):
                    child_bt[sx:sx + sh, sy:sy + sw] += 1
                    if mode in (3, 4) and i != 1:
                        child_bt[sx:sx + sh, sy:sy + sw] += 1
            got_child = True
            yield from self._leaves(child_bt, depth + 1, child_cus,
                                    ancestry + [bt])
        if not got_child:
            yield bt, ancestry

    def _bt_sub_map(self, x, y, h, w):
        best = None
        r = (slice(x, x + h), slice(y, y + w))
        for leaf_bt, anc in self._leaves(
                np.zeros((16, 16), np.int64), 0, [(x, y, h, w)], []):
            err = np.abs(leaf_bt[r] - self.bt_map[r]).sum()
            if best is None or err < best[0]:
                best = (err, leaf_bt, anc)
        _, leaf_bt, anc = best
        # layers = (grandparent, parent, leaf) of the best depth-3 leaf;
        # shallow leaves (possible when no candidate survives) pad with
        # their own map (the reference would fault here)
        chain = (anc + [leaf_bt])
        while len(chain) < 3:
            chain.insert(0, chain[0])
        n1, n2, leaf = chain[-3], chain[-2], chain[-1]
        self.sub_map[0][r] = n1[r]
        self.sub_map[1][r] = n2[r]
        self.sub_map[2][r] = leaf[r]

    def _qt_recurse(self, depth, qx, qy):
        cur = self.qt_map[qx, qy]
        sub = 8 >> depth
        if cur == depth:
            self._bt_sub_map(2 * qx, 2 * qy, 2 * sub, 2 * sub)
        elif cur > depth:
            for di in range(2):
                for dj in range(2):
                    self._qt_recurse(depth + 1, qx + di * sub // 2,
                                     qy + dj * sub // 2)

    def get_sub_map(self):
        self._qt_recurse(0, 0, 0)
        return self.sub_map


def labels_from_tree(tree: CuNode):
    """Per-64x64 training labels directly from a partition tree.

    Returns (qt8 [8,8], msbt [3,16,16], msdire [3,16,16]) with the
    reference's conventions: msbt layer L = accumulated MTT depth after
    L+1 split levels (TT outer thirds +2), msdire layer L = direction
    decided at MTT level L (+1 hor, -1 ver, 0 none).
    """
    qt8 = np.zeros((8, 8), np.int32)
    msbt = np.zeros((3, 16, 16), np.int32)
    msdire = np.zeros((3, 16, 16), np.int32)
    bx, by = tree.x, tree.y

    def region4(node):
        return (slice((node.x - bx) // 4, (node.x - bx + node.h) // 4),
                slice((node.y - by) // 4, (node.y - by + node.w) // 4))

    def visit(node):
        if node.split == Split.QT:
            for c in node.children:
                visit(c)
            return
        if node.split == Split.NONE and node.mtt_depth == 0:
            qt8[(node.x - bx) // 8:(node.x - bx + node.h) // 8,
                (node.y - by) // 8:(node.y - by + node.w) // 8] \
                = node.qt_depth
        d = node.mtt_depth
        if node.split in (Split.BT_H, Split.TT_H):
            direc = 1
        elif node.split in (Split.BT_V, Split.TT_V):
            direc = -1
        else:
            direc = 0
        if d < 3:
            msdire[d][region4(node)] = direc
        if node.split != Split.NONE:
            for i, c in enumerate(node.children):
                inc = 2 if (node.split in (Split.TT_H, Split.TT_V)
                            and i != 1) else 1
                for layer in range(d, 3):
                    msbt[layer][region4(c)] += inc
                visit(c)

    # QT leaves can themselves be MTT roots: record their qt depth first
    def mark_qt(node):
        if node.split == Split.QT:
            for c in node.children:
                mark_qt(c)
        else:
            qt8[(node.x - bx) // 8:(node.x - bx + node.h) // 8,
                (node.y - by) // 8:(node.y - by + node.w) // 8] \
                = node.qt_depth

    def qt_leaves(node):
        """Depth map must reflect the QT leaf (pre-MTT) regions."""
        if node.split == Split.QT:
            for c in node.children:
                qt_leaves(c)
        elif node.mtt_depth == 0:
            qt8[(node.x - bx) // 8:(node.x - bx + node.h) // 8,
                (node.y - by) // 8:(node.y - by + node.w) // 8] \
                = node.qt_depth

    qt_leaves(tree)
    visit(tree)
    return qt8, msbt, msdire


def tree_from_leaves(leaves, bx, by, size=64, qt_depth=1, mtt_depth=0):
    """Reconstruct a 64x64 block's split tree from its final leaf CUs
    (encoder convention: (x=col, y=row, w, h) tuples), for label
    generation from RDO encodes — the native counterpart of the
    reference's decoder-side Save_Depth dump (DecLib.cpp:998, which has
    the true per-depth splits; from leaves alone a QT is preferred over
    the equivalent BT+BT pair, matching VVC's QT-before-MTT ordering).
    """
    cover = [(lx - bx, ly - by, w, h) for (lx, ly, w, h) in leaves
             if bx <= lx < bx + size and by <= ly < by + size]

    def clean_cut_v(x0, y0, w, h, cx):
        """No leaf straddles the vertical line x0+cx within the region."""
        return all(not (lx < x0 + cx < lx + lw)
                   for (lx, ly, lw, lh) in cover
                   if ly < y0 + h and ly + lh > y0 and lx < x0 + w
                   and lx + lw > x0)

    def clean_cut_h(x0, y0, w, h, cy):
        return all(not (ly < y0 + cy < ly + lh)
                   for (lx, ly, lw, lh) in cover
                   if ly < y0 + h and ly + lh > y0 and lx < x0 + w
                   and lx + lw > x0)

    def build(x0, y0, w, h, qd, md):
        # scheduler convention: CuNode(x=row, y=col, h, w)
        node = CuNode(y0, x0, h, w, qd, md)
        # is the region exactly one leaf?
        for (lx, ly, lw, lh) in cover:
            if (lx, ly, lw, lh) == (x0, y0, w, h):
                return node
        qt_ok = (w == h and w >= 16 and clean_cut_v(x0, y0, w, h, w // 2)
                 and clean_cut_h(x0, y0, w, h, h // 2) and md == 0)
        bh_ok = h >= 8 and clean_cut_h(x0, y0, w, h, h // 2)
        bv_ok = w >= 8 and clean_cut_v(x0, y0, w, h, w // 2)
        th_ok = h >= 16 and clean_cut_h(x0, y0, w, h, h // 4) \
            and clean_cut_h(x0, y0, w, h, 3 * h // 4) and not bh_ok
        tv_ok = w >= 16 and clean_cut_v(x0, y0, w, h, w // 4) \
            and clean_cut_v(x0, y0, w, h, 3 * w // 4) and not bv_ok
        if qt_ok:
            node.split = Split.QT
            kids = [(x0, y0, w // 2, h // 2), (x0 + w // 2, y0, w // 2, h // 2),
                    (x0, y0 + h // 2, w // 2, h // 2),
                    (x0 + w // 2, y0 + h // 2, w // 2, h // 2)]
            args = (qd + 1, 0)
        elif bh_ok:
            node.split = Split.BT_H
            kids = [(x0, y0, w, h // 2), (x0, y0 + h // 2, w, h // 2)]
            args = (qd, md + 1)
        elif bv_ok:
            node.split = Split.BT_V
            kids = [(x0, y0, w // 2, h), (x0 + w // 2, y0, w // 2, h)]
            args = (qd, md + 1)
        elif th_ok:
            node.split = Split.TT_H
            kids = [(x0, y0, w, h // 4), (x0, y0 + h // 4, w, h // 2),
                    (x0, y0 + 3 * h // 4, w, h // 4)]
            args = (qd, md + 1)
        elif tv_ok:
            node.split = Split.TT_V
            kids = [(x0, y0, w // 4, h), (x0 + w // 4, y0, w // 2, h),
                    (x0 + 3 * w // 4, y0, w // 4, h)]
            args = (qd, md + 1)
        else:
            raise ValueError(f"no consistent split at {(x0, y0, w, h)}")
        node.children = [build(kx, ky, kw, kh, *args)
                         for (kx, ky, kw, kh) in kids]
        return node

    root = build(0, 0, size, size, qt_depth, mtt_depth)

    def shift(n):
        n.x += by
        n.y += bx
        for c in n.children:
            shift(c)
    shift(root)
    return root
