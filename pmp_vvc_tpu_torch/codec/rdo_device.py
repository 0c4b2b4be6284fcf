"""Device-batched QTMT split search (EncCu::xCompressCU counterpart).

The port of the JAX package's ``codec/rdo_device.py``. The reference's RDO
is a sequential recursion in which every trial re-encodes a subtree against
the evolving reconstruction; this module replaces it with three stages:

1. HOST: enumerate every tree node reachable under the QTMT legality rules
   (``can_split_set``) for each CTU. The node set is static per geometry, so
   it is cached across frames and QPs (``_GEOM_CACHE``) and flattened into
   index arrays for a vectorised DP (``_Geom``).
2. DEVICE: every node's LEAF coding cost in one batched pass, open loop:
   intra references come from the ORIGINAL planes, so the whole frame's
   rects run as independent tiles (``ops/rdo_generic.py``: K1, K9a, K5, K4,
   K9c for the luma tree; K1, K9b, K6a, K4, K9c for the dual tree's chroma).
   Rects are bucketed into 8/16/32/64-pad tile classes; many frames run
   through one stream of calls, and several QP points share the mode search.
3. HOST: min-plus dynamic program over the node DAG with split-bin proxies,
   best(n) = min(leaf(n), split_bits(s) + sum children), vectorised over
   area-ascending groups.

Open-loop references and proxy rates make this a partition-decision engine,
not a bit-exact RD replica: it chooses the tree, which the wavefront path
then codes closed loop. Its uses: the L0-L2 operating points' fallback
(``WavefrontEncoder(rdo_fallback=True)``), ``encode_frame(rdo=True)``, and
the training labels (``search_frames`` with several encoders, one per QP).

Each search adds to its encoder's ``timings``: ``rdo_geometry`` (node
enumeration, cold runs only), ``rdo_leaf_costs`` (the leaf-cost calls and
their fetch), ``rdo_leaf_device`` (on the card, the span of those calls
between CUDA events) and ``rdo_dp`` (the DP and its deciders).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.rdo_generic import chroma_leaf_costs, luma_leaf_costs
from .mtt import Split, SplitState, can_split_set, get_implicit_split

# split-signalling bit proxies (split_cu_flag + qt/mtt bins)
_SPLITS = (Split.NONE, Split.QT, Split.BT_H, Split.BT_V, Split.TT_H,
           Split.TT_V)
_SPLIT_BITS = {Split.NONE: 1.0, Split.QT: 2.0, Split.BT_H: 3.0,
               Split.BT_V: 3.0, Split.TT_H: 4.0, Split.TT_V: 4.0}
_SPLIT_BITS_ARR = np.array([_SPLIT_BITS[s] for s in _SPLITS], np.float64)

_TILE_CLASSES = (8, 16, 32, 64)
# rects per leaf-cost call of each pad class (B * P^2 roughly constant); the
# costs do not depend on them
_BATCH_CPU = {8: 1024, 16: 512, 32: 128, 64: 32}
_BATCH_CUDA = {8: 16384, 16: 8192, 32: 2048, 64: 512}


def _pad_class(w, h):
    m = max(w, h)
    for p in _TILE_CLASSES:
        if m <= p:
            return p
    raise ValueError((w, h))


class _Geom:
    """Flattened node DAG of one frame geometry (shared across frames,
    QPs and DeviceRDO instances).  Arrays, area-ascending node order:

    - keys[i]    node key (x, y, w, h, state-tuple); key2idx inverse
    - entry ranges per node [e0[i], e0[i+1]); per entry: split id,
      leaf rect index (or -1), child ranges [c0[e], c0[e+1]) into the
      flat child-node-index array
    - groups: (start, end) node-index ranges of equal-area runs —
      each group's children land strictly earlier, so the DP is a
      short loop of vectorized group updates
    """

    def __init__(self, nodes, rects, roots, keys_asc):
        self.rects = rects
        self.rect_idx = {r: i for i, r in enumerate(rects)}
        self.keys = keys_asc
        self.key2idx = {k: i for i, k in enumerate(keys_asc)}
        self.roots = [self.key2idx[r] for r in roots if r is not None]
        e_split, e_leaf, e_node = [], [], []
        e0, c0, children = [0], [0], []
        for k in keys_asc:
            for s, ckeys in nodes[k]:
                e_node.append(self.key2idx[k])
                e_split.append(_SPLITS.index(s))
                if s == Split.NONE:
                    e_leaf.append(self.rect_idx[k[:4]])
                else:
                    e_leaf.append(-1)
                    children.extend(self.key2idx[ck] for ck in ckeys)
                c0.append(len(children))
            e0.append(len(e_split))
        self.e0 = np.asarray(e0, np.int64)
        self.e_node = np.asarray(e_node, np.int64)
        self.e_split = np.asarray(e_split, np.int8)
        self.e_leaf = np.asarray(e_leaf, np.int64)
        self.c0 = np.asarray(c0, np.int64)
        self.children = np.asarray(children, np.int64)
        self.e_nchild = self.c0[1:] - self.c0[:-1]
        areas = np.asarray([k[2] * k[3] for k in keys_asc], np.int64)
        bounds = [0] + list(np.nonzero(np.diff(areas))[0] + 1) \
            + [len(keys_asc)]
        self.groups = list(zip(bounds[:-1], bounds[1:]))
        # per-node geometry (for map-conditioned entry masks)
        self.node_x = np.asarray([k[0] for k in keys_asc], np.int64)
        self.node_y = np.asarray([k[1] for k in keys_asc], np.int64)
        self.node_qt = np.asarray([k[4][0] for k in keys_asc], np.int64)
        # the leaf rects as an (R, 4) array and their tile classes, for the
        # leaf-cost rows
        self.rect_arr = np.asarray(rects, np.int32).reshape(-1, 4)
        self.rect_pad = np.asarray([_pad_class(w, h) for _, _, w, h in rects], np.int64)

    def qt_ban_mask(self, qt_map):
        """Entry mask implementing the L0 tryMode QT ban
        (EncModeCtrl.cpp:2017-2035): QT split entries are disallowed
        once the node's qt_depth reaches the map-predicted depth + 1.
        ``qt_map``: (H/8, W/8) predicted QT depths; node x = column,
        y = row (scheduler convention)."""
        qt_map = np.asarray(qt_map)
        r = np.minimum(self.node_y // 8, qt_map.shape[0] - 1)
        c = np.minimum(self.node_x // 8, qt_map.shape[1] - 1)
        pred = qt_map[r, c] + 1
        banned_node = self.node_qt >= pred
        mask = np.ones(len(self.e_split), bool)
        is_qt = self.e_split == _SPLITS.index(Split.QT)
        mask[is_qt & banned_node[self.e_node]] = False
        return mask

    def solve(self, leaf_cost, lam, entry_mask=None):
        """Vectorized bottom-up min-plus DP; leaf_cost: (R,) array of
        rect costs.  ``entry_mask``: optional (E,) bool — False
        entries are excluded (e.g. the L0 QT ban).  Returns
        (best_cost (N,), chosen split id (N,)).  Ties go to the
        earliest entry: a reversed stable argsort, the last write
        winning."""
        E = len(self.e_split)
        e_cost = np.zeros(E)
        is_leaf = self.e_leaf >= 0
        e_cost[is_leaf] = leaf_cost[self.e_leaf[is_leaf]]
        e_cost += lam * _SPLIT_BITS_ARR[self.e_split]
        if entry_mask is not None:
            e_cost[~entry_mask] = np.inf
        best = np.full(len(self.keys), np.inf)
        chosen = np.zeros(len(self.keys), np.int8)
        for g0, g1 in self.groups:
            s, e = self.e0[g0], self.e0[g1]
            ec = e_cost[s:e].copy()
            nc = self.e_nchild[s:e]
            has_c = nc > 0
            if has_c.any():
                cs, ce = self.c0[s], self.c0[e]
                cvals = best[self.children[cs:ce]]
                seg = np.repeat(np.arange(e - s), nc)
                ec[has_c] += np.bincount(seg, weights=cvals,
                                         minlength=e - s)[has_c]
            nodes_g = self.e_node[s:e] - g0
            order = np.argsort(ec, kind="stable")[::-1]
            bc = np.full(g1 - g0, np.inf)
            bs = np.zeros(g1 - g0, np.int8)
            bc[nodes_g[order]] = ec[order]
            bs[nodes_g[order]] = self.e_split[s:e][order]
            best[g0:g1] = bc
            chosen[g0:g1] = bs
        return best, chosen


# geometry cache: cfg-derived key -> _Geom
_GEOM_CACHE = {}


def _skey(state):
    return (state.qt_depth, state.mtt_depth, state.last_split,
            state.part_idx, state.implicit_bt_depth)


class DeviceRDO:
    """Open-loop batched QTMT RDO over frames of one geometry, on the
    encoder's device (its ``device``: the card, or the CPU with the
    kernels' plain versions)."""

    def __init__(self, encoder):
        self.enc = encoder
        self.cfg = encoder.cfg
        self.device = encoder.device

    # ---- stage 1: node enumeration (cached per geometry) -------------

    def _geom_key(self):
        cfg = self.cfg
        return (cfg.width, cfg.height, cfg.log2_min_cb,
                cfg.max_mtt_depth_intra, cfg.min_qt_intra,
                cfg.max_bt_intra, cfg.max_tt_intra, cfg.dual_tree)

    def _enumerate(self, key, roots_of, visit_node):
        """Build (or fetch) the _Geom of ``key``: ``visit_node(x, y, w, h,
        state)`` returns a node's candidate splits and its implicit split;
        ``roots_of`` yields the root (x, y, w, h, state) of each CTU's
        walk."""
        hit = _GEOM_CACHE.get(key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        cfg = self.cfg
        nodes = {}       # key -> list of (split, children keys)
        rects = set()

        def visit(x, y, w, h, state):
            if x >= cfg.width or y >= cfg.height:
                return None
            key = (x, y, w, h) + (_skey(state),)
            if key in nodes:
                return key
            nodes[key] = []
            cands, implicit = visit_node(x, y, w, h, state)
            entry = []
            for s in cands:
                if s == Split.NONE:
                    rects.add((x, y, w, h))
                    entry.append((s, None))
                    continue
                imp_bt = state.implicit_bt_depth + (
                    1 if s == implicit
                    and s in (Split.BT_H, Split.BT_V) else 0)
                ckeys = []
                for i, (cx, cy, cw, chh) in enumerate(
                        self.enc._children(x, y, w, h, s)):
                    cstate = SplitState(
                        last_split=s, part_idx=i,
                        qt_depth=state.qt_depth
                        + (1 if s == Split.QT else 0),
                        mtt_depth=state.mtt_depth
                        + (0 if s == Split.QT else 1),
                        implicit_bt_depth=imp_bt)
                    ck = visit(cx, cy, cw, chh, cstate)
                    if ck is not None:
                        ckeys.append(ck)
                entry.append((s, ckeys))
            nodes[key] = entry
            return key

        roots = [visit(*r) for r in roots_of()]
        # children have strictly smaller area than their parent, so an
        # area-ascending order is a valid bottom-up DP schedule
        keys_asc = sorted(nodes, key=lambda k: k[2] * k[3])
        g = _Geom(nodes, sorted(rects), roots, keys_asc)
        _GEOM_CACHE[key] = g
        self.enc._time("rdo_geometry", t0)
        return g

    def _ctus(self):
        cfg = self.cfg
        for cty in range((cfg.height + 127) // 128):
            for ctx_i in range((cfg.width + 127) // 128):
                yield ctx_i * 128, cty * 128

    def geom(self) -> _Geom:
        cfg = self.cfg

        def visit_node(x, y, w, h, state):
            implicit = get_implicit_split(x, y, w, h, state, cfg)
            if implicit != Split.NONE:
                return [implicit], implicit
            can = can_split_set(w, h, state, cfg)
            cands = [s for s in _SPLITS if can[s]]
            if w > 64 or h > 64:
                # intra CUs are capped at 64 (the deciders force the
                # CTU-level QT; max TB size, SPS log2_max_tb)
                cands = [s for s in cands if s != Split.NONE]
            if not cfg.dual_tree:
                # single-tree RDO never explores SCIPU-triggering splits
                # (FrameEncoder._encode_tree refuses them)
                cands = [s for s in cands if s == Split.NONE
                         or not self.enc._scipu_cond(w, h, s)]
            return cands, implicit

        return self._enumerate(
            self._geom_key(),
            lambda: ((x, y, 128, 128, SplitState()) for x, y in self._ctus()),
            visit_node)

    # ---- stage 2: device leaf costs ----------------------------------

    @staticmethod
    def _qp_points(encoders):
        # the port's _qps also returns the joint Cb-Cr QP, which the
        # RDO does not use
        return tuple((*e._qps()[:2], float(e.lam), float(e.dw_c))
                     for e in encoders)

    def _leaf_costs_of(self, frames, geom, cost_fn):
        """Run ``cost_fn(rows, oy, ou, ov, P)`` over every (frame, rect of
        ``geom``) in chunks of each pad class, the last one filled with
        padding rows; returns (costs (nQP, F, R) float64, modes (F, R)
        int32, zero for the chroma tree)."""
        t0 = time.perf_counter()
        dev = self.device
        up = lambda i: torch.from_numpy(np.stack(
            [np.asarray(f[i], np.int32) for f in frames])).to(dev)
        oy, ou, ov = up(0), up(1), up(2)
        rects, pads = geom.rect_arr, geom.rect_pad
        F, R = len(frames), len(rects)
        bsz = _BATCH_CUDA if dev.type == "cuda" else _BATCH_CPU
        events = None
        if dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        pending = []
        for P in _TILE_CLASSES:
            ris = np.nonzero(pads == P)[0]
            if not len(ris):
                continue
            fs = np.repeat(np.arange(F), len(ris))
            rs = np.tile(ris, F)
            B = bsz[P]
            for i0 in range(0, len(fs), B):
                f_c, r_c = fs[i0:i0 + B], rs[i0:i0 + B]
                rows = np.zeros((B, 8), np.int32)     # padding rows: live 0
                n = len(f_c)
                rows[:n, 0] = f_c
                rows[:n, 1:5] = rects[r_c]
                rows[:n, 5:8] = 1                     # order id 1, live, CCLM gate
                out = cost_fn(torch.from_numpy(rows).to(dev), oy, ou, ov, P)
                pending.append((f_c, r_c, out))
        if events is not None:
            events[1].record()
        costs = None
        modes = np.zeros((F, R), np.int32)
        for f_c, r_c, out in pending:
            c, m = out if isinstance(out, tuple) else (out, None)
            c = c.cpu().numpy()
            if costs is None:
                costs = np.zeros((c.shape[0], F, R))
            costs[:, f_c, r_c] = c[:, :len(f_c)]
            if m is not None:
                modes[f_c, r_c] = m.cpu().numpy()[:len(f_c)]
        if events is not None:
            self.enc.timings["rdo_leaf_device"] = \
                self.enc.timings.get("rdo_leaf_device", 0.0) \
                + events[0].elapsed_time(events[1]) / 1e3
        self.enc._time("rdo_leaf_costs", t0)
        return costs, modes

    def leaf_cost_arrays(self, frames, encoders=None):
        """Leaf costs for every (QP, frame, rect): returns
        (costs (nQP, F, R) float64, modes (F, R) int32).  ``encoders``
        defaults to [self.enc]; extra encoders = extra QP operating
        points sharing the mode search."""
        cfg = self.cfg
        qps = self._qp_points(encoders or [self.enc])
        geom = self.geom()
        return self._leaf_costs_of(
            frames, geom,
            lambda rows, oy, ou, ov, P: luma_leaf_costs(
                rows, oy, ou, ov, P, qps, cfg.bit_depth, bool(cfg.rd_quant),
                bool(cfg.mts_intra)))

    # back-compat single-frame dict API (tests, tools)
    def _leaf_costs(self, rects, y, u, v):
        costs, modes = self.leaf_cost_arrays([(y, u, v)])
        geom = self.geom()
        return ({r: costs[0, 0, i] for i, r in enumerate(geom.rects)},
                {r: int(modes[0, i]) for i, r in enumerate(geom.rects)})

    # ---- stage 3: DP + outputs ---------------------------------------

    def _decide_fn(self, geom, chosen):
        """The decider of one DP solution; ``decide.chosen`` holds its
        split id per node (``geom.keys`` order)."""
        def decide(x, yy, w, h, state):
            key = (x, yy, w, h, (state.qt_depth, state.mtt_depth,
                                 state.last_split, state.part_idx,
                                 state.implicit_bt_depth))
            i = geom.key2idx.get(key)
            return Split.NONE if i is None else _SPLITS[chosen[i]]
        decide.chosen = chosen
        return decide

    def _solve_all(self, geom, costs, encoders, nframes, qt_ban_map):
        t0 = time.perf_counter()
        mask = geom.qt_ban_mask(qt_ban_map) \
            if qt_ban_map is not None else None
        out = []
        for qi, e in enumerate(encoders):
            lam = float(e.lam)
            row = []
            for f in range(nframes):
                _b, chosen = geom.solve(costs[qi, f], lam, mask)
                row.append(self._decide_fn(geom, chosen))
            out.append(row)
        self.enc._time("rdo_dp", t0)
        return out

    def search_frames(self, frames, encoders=None, qt_ban_map=None):
        """Batched search: returns per-QP lists of per-frame
        decide(x, y, w, h, state) functions — shape [nQP][F]
        (nQP = len(encoders or [self.enc])).  ``qt_ban_map``: predicted
        QT-depth map enabling the L0 QT ban (qt_ban_mask)."""
        encoders = encoders or [self.enc]
        geom = self.geom()
        costs, _modes = self.leaf_cost_arrays(frames, encoders)
        return self._solve_all(geom, costs, encoders, len(frames), qt_ban_map)

    def search(self, y, u, v):
        """Single-frame search; returns the decide function encoding
        the chosen tree (for the wavefront coder)."""
        return self.search_frames([(y, u, v)])[0][0]

    # ---- dual-tree CHROMA search --------------------------------------

    def _geom_key_chroma(self):
        cfg = self.cfg
        return ("chroma", cfg.width, cfg.height, cfg.log2_min_cb,
                cfg.chroma_max_mtt_depth, cfg.chroma_min_qt,
                cfg.chroma_max_bt, cfg.chroma_max_tt)

    def geom_chroma(self) -> _Geom:
        """Node DAG of the dual-tree CHROMA channel (luma-unit coords,
        EncCu.cpp:349-361 chroma pass; legality via
        can_split_set(chroma=True) incl. the implicit-BV
        chroma-width-4 -> QT replacement of the chroma walk)."""
        cfg = self.cfg

        def visit_node(x, y, w, h, state):
            implicit = get_implicit_split(x, y, w, h, state, cfg, True)
            if implicit != Split.NONE:
                if implicit == Split.BT_V and w // 2 == 4:
                    implicit = Split.QT
                return [implicit], implicit
            can = can_split_set(w, h, state, cfg, chroma=True)
            return [s for s in _SPLITS if can[s]], implicit

        def roots_of():
            for x, y in self._ctus():
                for (qx, qy, qw, qh) in self.enc._children(x, y, 128, 128, Split.QT):
                    yield qx, qy, qw, qh, SplitState(last_split=Split.QT, qt_depth=1)

        return self._enumerate(self._geom_key_chroma(), roots_of, visit_node)

    def chroma_leaf_cost_arrays(self, frames, encoders=None):
        """(nQP, F, R) chroma leaf costs over geom_chroma().rects."""
        cfg = self.cfg
        qps = self._qp_points(encoders or [self.enc])
        geom = self.geom_chroma()
        return self._leaf_costs_of(
            frames, geom,
            lambda rows, oy, ou, ov, P: chroma_leaf_costs(
                rows, oy, ou, ov, P, qps, cfg.bit_depth, bool(cfg.rd_quant),
                bool(cfg.cclm)))[0]

    def search_frames_chroma(self, frames, encoders=None,
                             qt_ban_map=None):
        """Chroma-tree decide functions, shape [nQP][F]."""
        encoders = encoders or [self.enc]
        geom = self.geom_chroma()
        costs = self.chroma_leaf_cost_arrays(frames, encoders)
        return self._solve_all(geom, costs, encoders, len(frames), qt_ban_map)
