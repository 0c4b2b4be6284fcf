"""Batched wavefront frame encoder — the card's execution path.

Replaces the reference's sequential CTU raster + CU recursion with a
dependency-levelled batched schedule. The partition maps fix the whole CU
tree before coding starts, so every leaf CU of the frame is known up front
(``_collect_leaves``); each leaf gets a wave level (``_schedule_waves``),
and levels of all frames are packed greedily into steps of at most
``batch[pad]`` CUs per tile class (``_batched_pass``).

The wave scan (``_wave_scan``) is a host loop over the steps. Schedules,
originals, order grids and the state planes are uploaded once; each step
launches, for each tile class with live rows, the wave-step kernels:

  K1 ``ref_gather``   reference rows with coding-order availability (one
                      warp per (CU, plane), the substitution a warp scan);
  K2 ``intra_rmd``    luma RMD + prediction, or chroma DM prediction;
  K3 ``mip_select``   (with ``mip``) the MIP candidates against K2's winner;
  K6a ``cclm_select`` (with ``cclm``) the chroma LM predictions against K2's
                      DM ones by joint U+V SATD;
  K5 ``tq_mts``       (luma) the candidate round trips — DCT-2, and with
                      ``mts_intra``, ``lfnst`` or ``transform_skip``
                      DST-7/DCT-8, DCT-2 + LFNST 1/2, transform skip — with
                      sign-data hiding (with ``sign_hiding``) and their
                      argmin, then coded vs zero;
  K4 ``tq``           (chroma) transform / quant / RD zeroing / sign-data
                      hiding / inverse, coded vs zero; with ``joint_cbcr``
                      the joint Cb-Cr trial (K6c) after the U and V TUs;
                      with LMCS chroma scaling, each CU's chroma residual
                      scale (K6b) from its VPDU's mapped luma neighbours,
                      applied in every round trip;
  K7 ``wave_scatter`` masked writes into the recon and level planes and
                      the mode, MIP, mts_idx and lfnst_idx code grids (luma)
                      or the CCLM / joint Cb-Cr grid (chroma), a team of
                      threads per (CU, plane) loading its samples before
                      it stores them.

The state planes are updated in place (the JAX version's scan carries new
arrays); nothing is read back inside the loop, and the results come back in
one fetch. The host then replays the decisions through the CABAC writer and
the frame tail of ``FrameEncoder``.

The JAX module's ``_refs_generic``, ``_avail_from_order`` and
``_gather_plane`` live in ``ops/intra_generic.py`` (``ref_gather_reference``,
``avail_from_order``, ``gather_plane``) and its ``_bits_proxy`` in
``ops/tq_generic.py`` (``bits_proxy``), beside the kernels that use them.

With LMCS the luma is coded in the mapped domain: the original is
forward-mapped on upload and the recon planes stay mapped; ``FrameEncoder``
inverse-maps the recon before the in-loop filters.

Supported: single or dual tree, map- or QT-driven partitioning, luma
MIP, chroma CCLM (LM_CHROMA), TU coding with DCT-2, MTS (DST-7/DCT-8),
LFNST and transform skip, joint Cb-Cr residuals, scalar quantisation,
RDOQ-lite zeroing and sign-data hiding, LMCS with chroma residual scaling,
deblocking, SAO, ALF and CC-ALF. With ``rdo_fallback`` the device RDO
(``codec/rdo_device.py``, K9) decides the nodes the maps defer at accel levels
L0-L2, lazily; ``encode_frame(rdo=True)`` takes the whole tree from it. The
sequential-only tools (MRL, ISP, dependent quantisation) raise
``NotImplementedError``: ``FrameEncoder`` codes them.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import time

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..ops.cclm_generic import cclm_select
from ..ops.intra_generic import intra_rmd, ref_gather
from ..ops.lmcs_generic import crs_lut
from ..ops.mip_generic import mip_select
from ..ops.rows import check_rows
from ..ops.tq_generic import tq, tq_mts
from ..parallel import comm
from ..parallel.wavefront_dp import check_device, round_batch, shard_rows
from .encoder import RDO, CuInfo, FrameEncoder
from .mtt import Split, SplitState, get_implicit_split
from .rdo_device import DeviceRDO, _skey
from .residual import ctx

DEFAULT_BATCH = {32: 16, 64: 8}   # CUs per step of the 32- and 64-pad classes
# the sequential-only tools the wave path never supported
UNSUPPORTED_TOOLS = ("mrl", "isp", "dep_quant")
MAX_GRIDS = 4     # code grids K7 writes in one launch: mode, MIP, mts_idx, lfnst_idx


# ---------------------------------------------------------------------------
# K7: masked scatter of one step's results into the state planes
# ---------------------------------------------------------------------------

def wave_scatter_reference(rows, pad, scale, planes, rec, lev, grids=()):
    """Plain version of K7.  ``planes``: one or two (recon int32, levels
    int16) (F, H, W) plane pairs, written in place over each live CU's
    (h, w) region from rec/lev (n, B, pad, pad) int32; ``grids``: up to
    ``MAX_GRIDS`` (grid, code) pairs, each uint8 (F, H_luma/4, W_luma/4)
    grid taking its int32 ``code`` (B,) over the CU's 4-sample cells (a
    chroma CU's cells are those of its luma-unit area). Writes outside a
    plane or grid are dropped."""
    fi, xs, ys, ws, hs, okv = (rows[:, k] for k in (0, 1, 2, 3, 4, 6))
    ok = okv > 0
    d = torch.arange(pad, device=rows.device, dtype=torch.int32)
    pr = ys[:, None, None] // scale + d[None, :, None]
    pc = xs[:, None, None] // scale + d[None, None, :]
    inside = (d[None, :, None] < (hs // scale)[:, None, None]) & \
        (d[None, None, :] < (ws // scale)[:, None, None])
    H, W = planes[0][0].shape[1], planes[0][0].shape[2]
    m = ok[:, None, None] & inside & (pr < H) & (pc < W)
    f3, pr, pc = (t.expand_as(m) for t in (fi[:, None, None], pr, pc))
    idx = (f3[m].long(), pr[m].long(), pc[m].long())
    for i, (rp, lp) in enumerate(planes):
        rp.index_put_(idx, rec[i][m])
        lp.index_put_(idx, lev[i][m].to(lp.dtype))
    g = torch.arange(pad * scale // 4, device=rows.device, dtype=torch.int32)
    gr = ys[:, None, None] // 4 + g[None, :, None]
    gc = xs[:, None, None] // 4 + g[None, None, :]
    for grid, code in grids:
        gm = ok[:, None, None] & (g[None, :, None] < (hs // 4)[:, None, None]) & \
            (g[None, None, :] < (ws // 4)[:, None, None]) & \
            (gr < grid.shape[1]) & (gc < grid.shape[2])
        gf, grr, gcc, vals = (t.expand_as(gm) for t in
                              (fi[:, None, None], gr, gc, code[:, None, None]))
        grid.index_put_((gf[gm].long(), grr[gm].long(), gcc[gm].long()),
                        vals[gm].to(grid.dtype))


SIGNATURES = {"wave_scatter": {"pmp_wave_scatter": (
    (_build.PTR,) + (_build.INT,) * 6 + (_build.PTR,) * 8 + (_build.INT,) * 3 + (_build.PTR,))}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def wave_scatter(rows, pad, scale, planes, rec, lev, grids=()):
    """K7: see ``wave_scatter_reference``; CPU tensors take it, CUDA
    tensors launch ``csrc/wave_scatter.cu`` (one launch for the planes and
    every grid)."""
    check_rows(rows)
    if len(planes) not in (1, 2) or rec.shape[0] != len(planes):
        raise ValueError("wave_scatter takes one or two plane pairs")
    if len(grids) > MAX_GRIDS:
        raise ValueError(f"wave_scatter takes at most {MAX_GRIDS} code grids")
    if rows.device.type == "cpu":
        return wave_scatter_reference(rows, pad, scale, planes, rec, lev, grids)
    _build.check_cuda("wave_scatter", rows, rec, lev,
                      *(t for p in planes for t in p), *(t for g in grids for t in g))
    if rows.data_ptr() % 16:
        raise ValueError("wave_scatter reads each schedule row as two int4: "
                         "rows must be 16-byte aligned")
    for rp, lp in planes:
        if rp.dtype != torch.int32 or lp.dtype != torch.int16:
            raise TypeError("wave_scatter writes int32 recon and int16 level planes")
    if rec.dtype != torch.int32 or lev.dtype != torch.int32 or rec.shape[2:] != (pad, pad):
        raise ValueError("rec and lev must be (n, B, pad, pad) int32")
    for grid, code in grids:
        if grid.dtype != torch.uint8 or code.dtype != torch.int32:
            raise TypeError("wave_scatter takes uint8 grids and int32 codes")
        if grid.shape != grids[0][0].shape or code.shape != (rows.shape[0],):
            raise ValueError("the code grids must share one shape, one code per row")
    B = rows.shape[0]
    _, H, W = planes[0][0].shape
    ptr = lambda t: t.data_ptr() if t is not None else None
    p1 = planes[1] if len(planes) == 2 else (None, None)
    gptr = (ctypes.c_void_p * MAX_GRIDS)(*(g.data_ptr() for g, _ in grids))
    cptr = (ctypes.c_void_p * MAX_GRIDS)(*(c.data_ptr() for _, c in grids))
    GH, GW = grids[0][0].shape[1:] if grids else (0, 0)
    err = _lib("wave_scatter").pmp_wave_scatter(
        rows.data_ptr(), B, pad, scale, len(planes), H, W, planes[0][0].data_ptr(),
        planes[0][1].data_ptr(), ptr(p1[0]), ptr(p1[1]), rec.data_ptr(), lev.data_ptr(),
        gptr, cptr, len(grids), GH, GW, _build.stream(rows))
    _build.count_launch(wave_scatter, err)


wave_scatter.launches = 0


# ---------------------------------------------------------------------------
# device-side wave step
# ---------------------------------------------------------------------------

class _Scan:
    """What the steps of one ``_wave_scan`` share: the state planes
    (updated in place), originals, order grids and the coding parameters.
    ``ts_max``: the largest transform-skip side, 0 with transform skip off;
    ``qp_j``: the internal QP of the joint Cb-Cr TU; ``crs_lut``: with LMCS
    chroma scaling, the (1 << bd,) int32 ``crs_lut`` on the device;
    ``mesh``: the ranks over which each step's rows are sharded (K12a)."""

    def __init__(self, state, oy, ou, ov, og4, og4c, qp_y, qp_c, bd, lam,
                 dw_c, rd_quant, mip=False, sdh=False, mts=False, lfnst=False,
                 ts_max=0, cclm=False, jccr=False, qp_j=0, crs_lut=None, mesh=None):
        self.state = state
        self.oy, self.ou, self.ov = oy, ou, ov
        self.og4, self.og4c = og4, og4c
        self.qp_y, self.qp_c, self.bd = qp_y, qp_c, bd
        self.lam, self.dw_c, self.rd_quant = lam, dw_c, rd_quant
        self.mip, self.sdh = mip, sdh
        self.mts, self.lfnst, self.ts_max = mts, lfnst, ts_max
        self.cclm, self.jccr, self.qp_j = cclm, jccr, qp_j
        self.crs_lut = crs_lut
        self.mesh = mesh

    def luma_tools(self, P):
        """(mts, lfnst, ts_max) of the P-pad class: MTS and transform skip
        only in the 32-pad class (the 64-pad class holds only CUs with a
        side > 32), LFNST in both."""
        small = P <= 32
        return self.mts and small, self.lfnst, self.ts_max if small else 0

    def _gather(self, rec, lev, codes):
        """K12a: this rank's block of per-CU outputs (rec, lev (n, b, P, P),
        codes (b,) each) gathered into the step's full B rows, in one
        all-gather of one packed (b, K) int32 buffer; as they are without a
        mesh."""
        if self.mesh is None:
            return rec, lev, codes
        n, b = rec.shape[:2]
        k = n * rec[0, 0].numel()
        flat = [t.transpose(0, 1).reshape(b, k).to(torch.int32) for t in (rec, lev)] + \
            [c.reshape(b, 1).to(torch.int32) for c in codes]
        full = comm.all_gather(self.mesh, torch.cat(flat, 1))
        B = full.shape[0]
        tile = lambda t: t.reshape(B, n, *rec.shape[2:]).transpose(0, 1).contiguous()
        return (tile(full[:, :k]), tile(full[:, k:2 * k]),
                [full[:, 2 * k + i].contiguous() for i in range(len(codes))])

    def step(self, kind, P, row):
        """Wave-segment body for the P-pad tile class (``kind``: "st"
        single tree — luma RMD (+ MIP) + TQ, then chroma DM (or LM) + TQ of
        the co-located half-res block; "luma" the dual-tree luma pass;
        "chroma" the dual-tree chroma pass, its DM mode read from the mode
        grid at the CU centre, with the chroma tree's own order grid).

        With a mesh, each pass computes this rank's ``shard_rows`` block,
        gathers the block's outputs into the full B (``_gather``; "st" has
        two passes, so two gathers) and scatters all B rows (K7) into the
        replicated planes."""
        ry, ru, rv, cY, cU, cV, mg, tg, pg, cg, lg = self.state
        bd = self.bd
        mine = row if self.mesh is None else shard_rows(self.mesh, row)
        lf = None
        if kind != "chroma":
            refs = ref_gather([ry], self.og4, mine, P, 1, bd)
            best, pred = intra_rmd(refs, self.oy, mg, mine, P, True, bd)
            code = None
            if self.mip:
                # a MIP winner shows PLANAR in the mode grid (the
                # neighbours' MPM, the chroma DM view and LFNST's kernel
                # set) and its code in the MIP grid
                best, pred, code = mip_select(refs, self.oy, mine, pred, best, P, bd)
            lev, rec, tr, lf = tq_mts([self.oy], pred, mine, P, self.qp_y, bd,
                                      self.rd_quant, self.lam, best, code,
                                      *self.luma_tools(P), self.sdh)
            codes = [best] + ([code] if self.mip else []) + [tr, lf]
            rec, lev, codes = self._gather(rec, lev, codes)
            grids = list(zip([mg] + ([pg] if self.mip else []) + [tg, lg], codes))
            wave_scatter(row, P, 1, [(ry, cY)], rec, lev, grids)
            if kind == "luma":
                return
        # chroma DM at half resolution, availability from the chroma
        # tree's order grid (the luma one for single tree), then LM against
        # DM (cclm) and the joint Cb-Cr trial (jccr); their choices go into
        # the code grid, bit 0 LM, bit 1 joint. A single-tree CU whose luma
        # chose LFNST keeps its chroma levels in LFNST's region. With LMCS
        # chroma scaling, K4 derives each CU's scale from the mapped luma
        # recon and the same order grid.
        Pc = P // 2
        refs = ref_gather([ru, rv], self.og4c, mine, Pc, 2, bd)
        _, pred = intra_rmd(refs, None, mg, mine, Pc, False, bd)
        use_lm = 0
        if self.cclm:
            pred, use_lm = cclm_select(refs, ry, [self.ou, self.ov], self.og4c, mine, pred,
                                       Pc, bd)
        crs_src = None if self.crs_lut is None else (ry, self.og4c, self.crs_lut)
        out = tq([self.ou, self.ov], pred, mine, Pc, 2, self.qp_c, bd, self.rd_quant,
                 self.lam, self.dw_c, sdh=self.sdh, lfnst_active=lf, jccr=self.jccr,
                 qp_j=self.qp_j, crs_src=crs_src)
        codes = [use_lm + (2 * out[2] if self.jccr else 0)] if self.cclm or self.jccr else []
        rec, lev, codes = self._gather(out[1], out[0], codes)
        wave_scatter(row, Pc, 2, [(ru, cU), (rv, cV)], rec, lev, [(cg, c) for c in codes])


def _collect_leaves_chroma(enc, decide, decide_luma=None):
    """Dual-tree CHROMA leaf collection (luma-unit coords) — mirrors
    FrameEncoder._encode_tree_ch's chroma walk incl. the implicit-BV
    chroma-width-4 ban.  Each leaf carries its checkCCLMAllowed flag
    (Unit.cpp:378-443), derived from the chroma split path and the
    co-located 64x64 luma node's split (re-derived from the luma
    decider)."""
    cfg = enc.cfg
    leaves = []
    luma_root = {"split": Split.NONE}

    def walk(x, y, w, h, state, depth64=0, path=(None, None)):
        if x >= cfg.width or y >= cfg.height:
            return
        implicit = get_implicit_split(x, y, w, h, state, cfg, True)
        if implicit != Split.NONE:
            split = implicit
            if split == Split.BT_V and w // 2 == 4:
                split = Split.QT
        else:
            split = decide(x, y, w, h, state)
        if split is RDO:
            raise NotImplementedError(
                "RDO fallback inside the wavefront path")
        if split != Split.NONE:
            npath = (split if depth64 == 0 else path[0],
                     split if depth64 == 1 else path[1])
            imp_bt = state.implicit_bt_depth + (
                1 if split == implicit
                and split in (Split.BT_H, Split.BT_V) else 0)
            for i, (cx, cy, cw, chh) in enumerate(
                    enc._children(x, y, w, h, split)):
                cstate = SplitState(
                    last_split=split, part_idx=i,
                    qt_depth=state.qt_depth
                    + (1 if split == Split.QT else 0),
                    mtt_depth=state.mtt_depth
                    + (0 if split == Split.QT else 1),
                    implicit_bt_depth=imp_bt)
                walk(cx, cy, cw, chh, cstate, depth64 + 1, npath)
            return
        npath = (path[0] if depth64 > 0 else None,
                 path[1] if depth64 > 1 else None)
        enc._luma_root_split = luma_root["split"]
        enc._luma_root_isp = False
        cok = 1 if (cfg.cclm and enc._cclm_allowed_dual(npath)) else 0
        leaves.append((x, y, w, h, state.qt_depth, cok))

    n_ctu_x = (cfg.width + 127) // 128
    n_ctu_y = (cfg.height + 127) // 128
    for cty in range(n_ctu_y):
        for ctx_i in range(n_ctu_x):
            for i, (qx, qy, qw, qh) in enumerate(enc._children(
                    ctx_i * 128, cty * 128, 128, 128, Split.QT)):
                if qx >= cfg.width or qy >= cfg.height:
                    continue
                st = SplitState(last_split=Split.QT, qt_depth=1)
                if decide_luma is not None:
                    # the luma quadrant's state, QT child index included,
                    # as the luma walk and the replay give it
                    lst = SplitState(last_split=Split.QT, qt_depth=1, part_idx=i)
                    imp = get_implicit_split(qx, qy, qw, qh, lst, cfg)
                    luma_root["split"] = imp if imp != Split.NONE \
                        else decide_luma(qx, qy, qw, qh, lst)
                walk(qx, qy, qw, qh, st)
    return leaves


# ---------------------------------------------------------------------------
# host-side scheduling
# ---------------------------------------------------------------------------

def _order_grid(leaves, width, height):
    """(H/4, W/4) grid of each unit's leaf index in coding order."""
    g = np.full((height // 4, width // 4), -1, np.int32)
    for i, leaf in enumerate(leaves):
        x, y, w, h = leaf[:4]
        g[y // 4:(y + h) // 4, x // 4:(x + w) // 4] = i
    return g


def _schedule_waves(leaves, order, width, height, vpdu_dep=False):
    """Wave level per leaf: 1 + max level over earlier-coding-order
    leaves intersecting the intra reference template (above row
    x-1..x+2w-1, left column y..y+2h-1).  ``vpdu_dep``: additionally
    wait for the leaf's 64x64 VPDU's above-row/left-column neighbours
    (the LMCS chroma-residual scale averages them)."""
    r4, c4 = order.shape
    wave = np.zeros(len(leaves), np.int32)
    for i, leaf in enumerate(leaves):
        x, y, w, h = leaf[:4]
        lvl = 0
        if y > 0:
            c0 = max(0, (x - 4) // 4)
            c1 = min(c4, (x + 2 * w + 3) // 4)
            row = order[(y - 4) // 4, c0:c1]
            m = row[(row >= 0) & (row < i)]
            if m.size:
                lvl = int(wave[m].max()) + 1
        if x > 0:
            r0 = y // 4
            r1 = min(r4, (y + 2 * h + 3) // 4)
            col = order[r0:r1, (x - 4) // 4]
            m = col[(col >= 0) & (col < i)]
            if m.size:
                lvl = max(lvl, int(wave[m].max()) + 1)
        if vpdu_dep:
            vx, vy = (x // 64) * 64, (y // 64) * 64
            if vx > 0:
                col = order[vy // 4:min(r4, (vy + 64) // 4), (vx - 4) // 4]
                m = col[(col >= 0) & (col < i)]
                if m.size:
                    lvl = max(lvl, int(wave[m].max()) + 1)
            if vy > 0:
                row = order[(vy - 4) // 4, vx // 4:min(c4, (vx + 64) // 4)]
                m = row[(row >= 0) & (row < i)]
                if m.size:
                    lvl = max(lvl, int(wave[m].max()) + 1)
        wave[i] = lvl
    return wave


def _pack_schedule(frames, width, height, batch, cclm=False, crs=False):
    """Greedy cross-frame packing of the frames' wave levels.

    frames: list of (leaves_luma, leaves_chroma_or_None).  Dual tree
    appends the chroma tree's levels after the frame's luma levels (DM
    reads the luma mode grid).  ``crs``: LMCS chroma scaling is on, so a
    single-tree CU, whose chroma is coded in its luma step, also waits for
    its VPDU's luma neighbours (``vpdu_dep``); the dual-tree chroma levels
    run after the whole luma plane and need no such wait.  CUs only depend
    on earlier levels of their OWN frame, so a step mixes frame A's level 3
    with frame B's level 7; a frame's next level becomes schedulable the
    step after its current one finishes.  Returns (active classes, {class: (S, B, 8) int32}, order
    grids, chroma order grids); a row is (frame, x, y, w, h, order id,
    live, flags)."""
    ogs, ogcs, per_frame = [], [], []
    for f, (leaves, cleaves) in enumerate(frames):
        order = _order_grid(leaves, width, height)
        wave = _schedule_waves(leaves, order, width, height,
                               vpdu_dep=crs and cleaves is None)
        ogs.append(order)
        by_lvl = collections.defaultdict(list)
        kind = "st" if cleaves is None else "luma"
        st_cclm = 1 if (cleaves is None and cclm) else 0
        for i, (x, y, w, h, _) in enumerate(leaves):
            p = 32 if max(w, h) <= 32 else 64
            by_lvl[int(wave[i])].append(
                ((kind, p), f, x, y, w, h, i, st_cclm))
        q = collections.deque(
            collections.deque(by_lvl[lv]) for lv in sorted(by_lvl))
        if cleaves is None:
            ogcs.append(order)       # single tree: shared order
        else:
            orderc = _order_grid(cleaves, width, height)
            wavec = _schedule_waves(cleaves, orderc, width, height)
            ogcs.append(orderc)
            by_lvl_c = collections.defaultdict(list)
            for i, (x, y, w, h, _, cok) in enumerate(cleaves):
                p = 32 if max(w, h) <= 32 else 64
                by_lvl_c[int(wavec[i])].append(
                    (("chroma", p), f, x, y, w, h, i, cok))
            q.extend(collections.deque(by_lvl_c[lv])
                     for lv in sorted(by_lvl_c))
        per_frame.append(q)

    F = len(frames)
    ready = [0] * F
    steps = []
    while any(per_frame):
        t = len(steps)
        step = collections.defaultdict(list)
        for f in range(F):
            q = per_frame[f]
            while q and ready[f] <= t:
                ents = q[0]
                while ents and len(step[ents[0][0]]) < batch[ents[0][0][1]]:
                    step[ents[0][0]].append(ents.popleft())
                if ents:
                    break              # class slots full this step
                q.popleft()
                ready[f] = t + 1       # next level waits a step
        steps.append(step)

    active = tuple(sorted({k2 for st in steps for k2 in st if st[k2]}))
    S = max(len(steps), 1)
    step_arr = {k2: np.zeros((S, batch[k2[1]], 8), np.int32) for k2 in active}
    for t, st in enumerate(steps):
        for k2, ents in st.items():
            for k, (_c, f, x, y, w, h, i, flg) in enumerate(ents):
                step_arr[k2][t, k] = (f, x, y, w, h, i, 1, flg)
    return active, step_arr, np.stack(ogs), np.stack(ogcs)


class WavefrontEncoder(FrameEncoder):
    """FrameEncoder with the CU compute on the card as batched
    wavefronts.  ``device=None`` means CUDA (and raises without it);
    ``device="cpu"`` runs the kernels' plain versions.  Streams are
    byte-identical to the JAX package's ``WavefrontEncoder`` for the same
    frames, maps and configuration.

    After each ``encode_frames`` call, ``leaves`` holds each frame's (luma,
    chroma or None) leaves and ``rdo_deferred`` one set per frame of the
    nodes its maps deferred to the device RDO (empty without
    ``rdo_fallback``).

    ``mesh`` (``parallel.make_mesh``): the wave scan's CU batches are
    sharded over its ranks (K12a, ``_Scan.step``); every class batch is
    rounded up to a multiple of the mesh size, the planes stay replicated,
    and every rank returns the single-device stream. The device defaults
    to the mesh's. The device RDO of ``rdo_fallback`` runs whole on every
    rank, as the JAX package shards only the wave scan."""

    #: the replay writes the device decisions and reads no rates
    _rate_estimated = False

    def __init__(self, cfg, *, mesh=None, batch=None, device=None, **kw):
        bad = [f for f in UNSUPPORTED_TOOLS if getattr(cfg, f)]
        if bad:
            raise NotImplementedError(
                f"wavefront path does not support {bad}; use FrameEncoder")
        if mesh is not None and device is None:
            device = mesh.device
        check_device(mesh, device)
        super().__init__(cfg, device=device, **kw)
        self._device = resolve_device(device)       # the wave path's uploads
        self.crs_lut = crs_lut(cfg.bit_depth, cfg.lmcs_offset) \
            if cfg.lmcs and cfg.lmcs_chroma_scaling else None
        self.mesh = mesh
        self.batch = dict(DEFAULT_BATCH)
        if batch:
            self.batch.update(batch)
        if mesh is not None:
            self.batch = round_batch(self.batch, mesh.size)
        self.steps = 0              # wave steps of the last pass
        self.leaves = []
        self.rdo_deferred = []

    # ---- phase A: leaf collection (geometry only) ----------------------

    def _collect_leaves(self, decide):
        cfg = self.cfg
        leaves = []

        def walk(x, y, w, h, state):
            if x >= cfg.width or y >= cfg.height:
                return
            implicit = get_implicit_split(x, y, w, h, state, cfg)
            split = implicit if implicit != Split.NONE \
                else decide(x, y, w, h, state)
            if split is RDO:
                raise NotImplementedError(
                    "RDO fallback inside the wavefront path")
            if (not cfg.dual_tree and split != Split.NONE
                    and self._scipu_cond(w, h, split)):
                # single tree: refuse SCIPU-triggering splits — must
                # mirror _encode_tree's guard or the replay tree would
                # diverge from the collected leaves
                if split == implicit:
                    raise NotImplementedError(
                        "implicit boundary split triggers SCIPU")
                split = Split.NONE
            if split != Split.NONE:
                imp_bt = state.implicit_bt_depth + (
                    1 if split == implicit
                    and split in (Split.BT_H, Split.BT_V) else 0)
                for i, (cx, cy, cw, chh) in enumerate(
                        self._children(x, y, w, h, split)):
                    cstate = SplitState(
                        last_split=split, part_idx=i,
                        qt_depth=state.qt_depth
                        + (1 if split == Split.QT else 0),
                        mtt_depth=state.mtt_depth
                        + (0 if split == Split.QT else 1),
                        implicit_bt_depth=imp_bt)
                    walk(cx, cy, cw, chh, cstate)
                return
            leaves.append((x, y, w, h, state.qt_depth))

        n_ctu_x = (cfg.width + 127) // 128
        n_ctu_y = (cfg.height + 127) // 128
        for cty in range(n_ctu_y):
            for ctx_i in range(n_ctu_x):
                walk(ctx_i * 128, cty * 128, 128, 128, SplitState())
        return leaves

    # ---- phase B: batched device waves ----------------------------------

    def _qps(self):
        cfg = self.cfg
        qp_y = cfg.qp + self.qp_bd_offset
        qpi = max(-self.qp_bd_offset, min(63, cfg.qp))
        qp_c = int(self.qp_table[qpi + self.qp_bd_offset]) \
            + cfg.chroma_qp_offset
        qp_c = max(-self.qp_bd_offset, min(63, qp_c)) + self.qp_bd_offset
        qp_j = qp_c - cfg.chroma_qp_offset + cfg.jccr_qp_offset
        return qp_y, qp_c, qp_j

    def _batched_pass(self, frames, fetch=True):
        """frames: list of (leaves_luma, leaves_chroma_or_None, y, u, v).
        Encodes all frames' waves together; returns the 11 result planes
        (recon as uint16, levels as int16, the mode/mts/mip/cclm-jccr/lfnst
        grids as uint8), each (F, ...).  ``fetch=False`` returns them still
        on the device, the scan possibly still running there."""
        cfg = self.cfg
        F, H, W = len(frames), cfg.height, cfg.width
        dev = self.device
        t0 = time.perf_counter()
        active, step_arr, ogs, ogcs = _pack_schedule(
            [fr[:2] for fr in frames], W, H, self.batch, cfg.cclm,
            self.crs_lut is not None)
        self.steps = next(iter(step_arr.values())).shape[0] if step_arr else 0
        self._time("schedule", t0)

        t0 = time.perf_counter()
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
        # with LMCS the luma is coded in the mapped domain
        fwd = self.reshaper.fwd if self.reshaper is not None else (lambda p: p)
        oy = up(np.stack([fwd(np.asarray(fr[2], np.int32)) for fr in frames]))
        ou = up(np.stack([fr[3] for fr in frames]))
        ov = up(np.stack([fr[4] for fr in frames]))
        og4, og4c = up(ogs), up(ogcs)
        scheds = [up(step_arr[k2]) for k2 in active]
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        state = [z((F, H, W), torch.int32), z((F, H // 2, W // 2), torch.int32),
                 z((F, H // 2, W // 2), torch.int32), z((F, H, W), torch.int16),
                 z((F, H // 2, W // 2), torch.int16),
                 z((F, H // 2, W // 2), torch.int16)] + \
            [z((F, H // 4, W // 4), torch.uint8) for _ in range(5)]
        qp_y, qp_c, qp_j = self._qps()
        scan = _Scan(state, oy, ou, ov, og4, og4c, qp_y, qp_c, cfg.bit_depth,
                     float(self.lam), float(self.dw_c), bool(cfg.rd_quant),
                     mip=bool(cfg.mip), sdh=bool(cfg.sign_hiding),
                     mts=bool(cfg.mts_intra), lfnst=bool(cfg.lfnst),
                     ts_max=(1 << cfg.ts_max_log2) if cfg.transform_skip else 0,
                     cclm=bool(cfg.cclm), jccr=bool(cfg.joint_cbcr), qp_j=qp_j,
                     crs_lut=None if self.crs_lut is None else up(self.crs_lut),
                     mesh=self.mesh)
        self._time("upload", t0)

        t0 = time.perf_counter()
        events = None
        if dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        self._wave_scan(scan, active, step_arr, scheds)
        if events is not None:
            events[1].record()
        self._time("scan", t0)
        ry, ru, rv = (p.to(torch.int16) for p in state[:3])
        packed = [ry, ru, rv] + state[3:]
        if not fetch:
            return packed, events
        return self._fetch(packed, events)

    def _wave_scan(self, scan, active, step_arr, scheds):
        """Every wave step of a frame batch: for each step, each tile
        class with live rows runs its step body (the host knows from the
        schedule which rows are live). Liveness is the whole step's, never
        a rank's block: under a mesh every rank enters every gather, its
        block empty or not."""
        live = [step_arr[k2][:, :, 6].any(axis=1) for k2 in active]
        S = len(live[0]) if live else 0
        for t in range(S):
            for ci, (kind, P) in enumerate(active):
                if live[ci][t]:
                    scan.step(kind, P, scheds[ci][t])

    def _fetch(self, packed, events=None):
        """One device-to-host copy of all result planes."""
        t0 = time.perf_counter()
        flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in packed])
        host = flat.cpu().numpy()
        if events is not None:
            self.timings["scan_device"] = self.timings.get("scan_device", 0.0) \
                + events[0].elapsed_time(events[1]) / 1e3
        out, off = [], 0
        dtypes = [np.uint16] * 3 + [np.int16] * 3 + [np.uint8] * 5
        for p, dt in zip(packed, dtypes):
            n = p.numel() * p.element_size()
            out.append(host[off:off + n].view(dt).reshape(tuple(p.shape)))
            off += n
        self._time("fetch", t0)
        return tuple(out)

    # ---- phase C: CABAC replay ------------------------------------------

    @staticmethod
    def _set_mip_fields(cu, code):
        """Decode a MIP grid code (0 = angular, else 1 + t*16 + mode)."""
        if code:
            cu.mip = True
            cu.mip_transpose = code - 1 >= 16
            cu.mip_mode = (code - 1) % 16

    @staticmethod
    def _chroma_codes(code):
        """(LM chroma, joint Cb-Cr) of a chroma code grid value."""
        return bool(code & 1), bool(code & 2)

    def _write_joint_flag(self, enc, cbf_u, cbf_v, joint):
        """tu_joint_cbcr_residual_flag (CABACWriter.cpp:2610), coded where
        the tool is on and a chroma TU is coded."""
        cbf_mask = (2 if cbf_u else 0) + (1 if cbf_v else 0)
        if self.cfg.joint_cbcr and cbf_mask:
            enc.encode_bin(1 if joint else 0, ctx("JointCbCrFlag", cbf_mask - 1))

    def _mark_joint(self, cx, cy, cw, chh, joint2):
        """Record a chroma CU coded as a joint TU with both cbfs (the
        deblocking QP of its edges)."""
        self.unit_joint2[cy // 2:(cy + chh) // 2, cx // 2:(cx + cw) // 2] = joint2

    def _encode_cu(self, enc, rc, org_y, org_u, org_v, cu: CuInfo):
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        f = self._cur_frame
        ry, ru, rv, cY, cU, cV, mg, tg, pg, cg, lg = self._dev_result
        cu.mode = int(mg[f, y // 4, x // 4])
        mts_idx = int(tg[f, y // 4, x // 4])
        lfnst_idx = int(lg[f, y // 4, x // 4])
        self._set_mip_fields(cu, int(pg[f, y // 4, x // 4]))
        cclm_flag, joint = self._chroma_codes(int(cg[f, y // 4, x // 4]))
        lev_y = cY[f, y:y + h, x:x + w].astype(np.int32)
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        lev_u = cU[f, cy:cy + chh, cx:cx + cw].astype(np.int32)
        lev_v = cV[f, cy:cy + chh, cx:cx + cw].astype(np.int32)
        cbf_y = bool(lev_y.any())
        cbf_u = bool(lev_u.any())
        cbf_v = bool(lev_v.any())

        self._write_intra_luma_mode(enc, cu)
        self._write_intra_chroma_mode(enc, cclm=cclm_flag, lm_symbol=0)
        enc.encode_bin(1 if cbf_u else 0, ctx("QtCbf1", 0))
        enc.encode_bin(1 if cbf_v else 0,
                       ctx("QtCbf2", 1 if cbf_u else 0))
        enc.encode_bin(1 if cbf_y else 0, ctx("QtCbf0", 0))
        self._write_joint_flag(enc, cbf_u, cbf_v, joint)
        ts_y = mts_idx == 1              # MTS_SKIP = transform skip
        last_pos_y, violates = -1, False
        if cbf_y:
            last_pos_y, violates = self._write_resid(rc, lev_y, w, h, True,
                                                     ts=ts_y)
        if cbf_u:
            self._write_resid(rc, lev_u, cw, chh, False)
        if cbf_v and not joint:
            self._write_resid(rc, lev_v, cw, chh, False)
        comps = [(w, h, lev_y)] if cbf_y and not ts_y else []
        comps += ([(cw, chh, lev_u)] if cbf_u else [])
        comps += ([(cw, chh, lev_v)] if cbf_v else [])
        if not cbf_y:
            lfnst_idx = 0
        self._write_lfnst_idx(enc, cu, lfnst_idx, comps, False,
                              ts_used=cbf_y and ts_y)
        if lfnst_idx == 0 and not ts_y:
            self._write_mts_idx(enc, mts_idx, w, h, cbf_y, last_pos_y,
                                violates)

        self.recon_y[y:y + h, x:x + w] = ry[f, y:y + h, x:x + w]
        self.recon_u[cy:cy + chh, cx:cx + cw] = ru[f, cy:cy + chh, cx:cx + cw]
        self.recon_v[cy:cy + chh, cx:cx + cw] = rv[f, cy:cy + chh, cx:cx + cw]
        self._mark_joint(cx, cy, cw, chh, joint and cbf_u and cbf_v)
        r, c = y // 4, x // 4
        self.coded[r:r + h // 4, c:c + w // 4] = True
        self.unit_mode[r:r + h // 4, c:c + w // 4] = cu.mode
        self.unit_w[r:r + h // 4, c:c + w // 4] = w
        self.unit_h[r:r + h // 4, c:c + w // 4] = h
        self.unit_qt[r:r + h // 4, c:c + w // 4] = cu.qt_depth
        self.unit_mip[r:r + h // 4, c:c + w // 4] = cu.mip
        self.leaf_l.append((x, y, w, h))
        self.leaf_c.append((cx, cy, cw, chh))

    def _encode_luma_cu(self, enc, rc, org_y, cu: CuInfo):
        """Dual-tree luma CU replay from device results."""
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        f = self._cur_frame
        ry, ru, rv, cY, cU, cV, mg, tg, pg, cg, lg = self._dev_result
        cu.mode = int(mg[f, y // 4, x // 4])
        mts_idx = int(tg[f, y // 4, x // 4])
        lfnst_idx = int(lg[f, y // 4, x // 4])
        self._set_mip_fields(cu, int(pg[f, y // 4, x // 4]))
        lev_y = cY[f, y:y + h, x:x + w].astype(np.int32)
        cbf_y = bool(lev_y.any())
        ts_y = mts_idx == 1              # MTS_SKIP = transform skip
        self._write_intra_luma_mode(enc, cu)
        enc.encode_bin(1 if cbf_y else 0, ctx("QtCbf0", 0))
        last_pos_y, violates = -1, False
        if cbf_y:
            last_pos_y, violates = self._write_resid(rc, lev_y, w, h, True,
                                                     ts=ts_y)
        if not cbf_y:
            lfnst_idx = 0
        self._write_lfnst_idx(enc, cu, lfnst_idx,
                              [(w, h, lev_y)] if cbf_y and not ts_y else [],
                              True, ts_used=cbf_y and ts_y)
        if lfnst_idx == 0 and not ts_y:
            self._write_mts_idx(enc, mts_idx, w, h, cbf_y, last_pos_y,
                                violates)
        self.recon_y[y:y + h, x:x + w] = ry[f, y:y + h, x:x + w]
        r, c = y // 4, x // 4
        self.coded[r:r + h // 4, c:c + w // 4] = True
        self.unit_mode[r:r + h // 4, c:c + w // 4] = cu.mode
        self.unit_w[r:r + h // 4, c:c + w // 4] = w
        self.unit_h[r:r + h // 4, c:c + w // 4] = h
        self.unit_qt[r:r + h // 4, c:c + w // 4] = cu.qt_depth
        self.unit_mip[r:r + h // 4, c:c + w // 4] = cu.mip
        self.leaf_l.append((x, y, w, h))

    def _encode_chroma_cu(self, enc, rc, org_u, org_v, cu: CuInfo,
                          split_path=(None, None)):
        """Dual-tree chroma CU replay from device results (DM or LM)."""
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        cx, cy, cw, chh = x // 2, y // 2, w // 2, h // 2
        f = self._cur_frame
        ry, ru, rv, cY, cU, cV, mg, tg, pg, cg, lg = self._dev_result
        cu.mode = int(self.unit_mode[(y + h // 2) // 4, (x + w // 2) // 4])
        lev_u = cU[f, cy:cy + chh, cx:cx + cw].astype(np.int32)
        lev_v = cV[f, cy:cy + chh, cx:cx + cw].astype(np.int32)
        cbf_u = bool(lev_u.any())
        cbf_v = bool(lev_v.any())
        cclm_flag, joint = self._chroma_codes(int(cg[f, y // 4, x // 4]))
        self._write_intra_chroma_mode(
            enc, cclm=cclm_flag,
            cclm_allowed=self.cfg.cclm and self._cclm_allowed_dual(split_path),
            lm_symbol=0, luma_mode=cu.mode)
        enc.encode_bin(1 if cbf_u else 0, ctx("QtCbf1", 0))
        enc.encode_bin(1 if cbf_v else 0, ctx("QtCbf2", 1 if cbf_u else 0))
        self._write_joint_flag(enc, cbf_u, cbf_v, joint)
        if cbf_u:
            self._write_resid(rc, lev_u, cw, chh, False)
        if cbf_v and not joint:
            self._write_resid(rc, lev_v, cw, chh, False)
        if min(cw, chh) >= 4:
            comps = ([(cw, chh, lev_u)] if cbf_u else []) \
                + ([(cw, chh, lev_v)] if cbf_v else [])
            self._write_lfnst_idx(enc, cu, 0, comps, True)
        self.recon_u[cy:cy + chh, cx:cx + cw] = ru[f, cy:cy + chh, cx:cx + cw]
        self.recon_v[cy:cy + chh, cx:cx + cw] = rv[f, cy:cy + chh, cx:cx + cw]
        self._mark_joint(cx, cy, cw, chh, joint and cbf_u and cbf_v)
        r, c = y // 4, x // 4
        self.coded_c[r:r + h // 4, c:c + w // 4] = True
        self.unit_w_c[r:r + h // 4, c:c + w // 4] = w
        self.unit_h_c[r:r + h // 4, c:c + w // 4] = h
        self.unit_qt_c[r:r + h // 4, c:c + w // 4] = cu.qt_depth
        self.leaf_c.append((cx, cy, cw, chh))

    # ---- entry points ----------------------------------------------------

    def _decider(self, qt_map, maps):
        if maps is not None:
            return self._apply_ablations(self._map_decider(*maps))
        qm = qt_map if qt_map is not None else \
            np.ones((self.cfg.height // 8, self.cfg.width // 8), np.int32)
        return self._apply_ablations(self._qt_map_decider(qm))

    def _decider_chroma(self, qt_map, maps, chroma_maps):
        """Chroma-tree decider (mirror of FrameEncoder.encode_frame's
        decide_c construction)."""
        cfg = self.cfg
        cmaps = chroma_maps or maps
        if cmaps is not None:
            return self._map_decider(*cmaps, chroma=True)
        cqt = qt_map if qt_map is not None else \
            np.ones((cfg.height // 8, cfg.width // 8), np.int32)

        def decide_c(x, yy, w, h, state, _q=cqt):
            if w > 64:
                return Split.QT
            if state.mtt_depth == 0 and w == h \
                    and w > cfg.chroma_min_qt:
                pred = int(_q[min(yy, cfg.height - 1) // 8,
                              min(x, cfg.width - 1) // 8]) + 1
                if state.qt_depth < pred:
                    return Split.QT
            return Split.NONE
        return decide_c

    @staticmethod
    def _hybrid(map_decide, rdo_decide):
        """Map decision inside the gate, device-RDO outside — the
        wavefront counterpart of EncModeCtrl.cpp:1242-1252's L<3
        stock-RDO re-enable (the map decider returns the RDO sentinel
        for needs_rdo nodes when rdo_fallback is on)."""
        def decide(x, y, w, h, state):
            s = map_decide(x, y, w, h, state)
            return rdo_decide(x, y, w, h, state) if s is RDO else s
        return decide

    def _rdo_decides(self, frames, maps=None, chroma_maps=None):
        """Per-frame (luma, chroma) device-RDO fallback deciders, LAZY:
        the batched open-loop search only runs if some node actually
        defers (at L3 with full map coverage nothing does, so the
        fallback costs nothing there).  At L0 the predicted QT map
        bans QT re-splits in the fallback (tryMode,
        EncModeCtrl.cpp:2017-2035).  The deferred nodes are recorded in
        one set per frame on ``rdo_deferred``."""
        cache = {}
        deferred = [set() for _ in frames]
        self.rdo_deferred.extend(deferred)
        qt_ban = maps[2] if (self.accel_level == 0
                             and maps is not None) else None
        cmaps = chroma_maps or maps
        qt_ban_c = cmaps[2] if (self.accel_level == 0
                                and cmaps is not None) else None

        def solve():
            if "l" not in cache:
                rdo = DeviceRDO(self)
                cache["l"] = rdo.search_frames(
                    frames, qt_ban_map=qt_ban)[0]
                cache["c"] = (rdo.search_frames_chroma(
                    frames, qt_ban_map=qt_ban_c)[0]
                    if self.cfg.dual_tree else None)
            return cache

        def mk(f, chroma):
            def decide(x, y, w, h, state):
                deferred[f].add((chroma, x, y, w, h, _skey(state)))
                c = solve()
                d = (c["c"] if chroma else c["l"])[f]
                return d(x, y, w, h, state)
            return decide

        return [(mk(f, False), mk(f, True))
                for f in range(len(frames))]

    def _deciders(self, qt_map, maps, chroma_maps, rdo_dec=None):
        """The (luma, chroma or None) split deciders of a frame: the
        maps' (or the QT map's), with ``rdo_dec``'s decisions where the
        maps defer."""
        decide = self._decider(qt_map, maps)
        decide_c = self._decider_chroma(qt_map, maps, chroma_maps) \
            if self.cfg.dual_tree else None
        if rdo_dec is not None:
            decide = self._hybrid(decide, rdo_dec[0])
            if decide_c is not None:
                decide_c = self._hybrid(decide_c, rdo_dec[1])
        return decide, decide_c

    def _collect_trees(self, decide, decide_c):
        leaves = self._collect_leaves(decide)
        cleaves = None if decide_c is None else \
            _collect_leaves_chroma(self, decide_c, decide_luma=decide)
        return leaves, cleaves

    def _collect_all(self, qt_map, maps, chroma_maps, rdo_dec=None):
        return self._collect_trees(
            *self._deciders(qt_map, maps, chroma_maps, rdo_dec))

    def _rdo_seconds(self):
        """Host seconds of the device RDO's stages so far."""
        return sum(self.timings.get(k, 0.0)
                   for k in ("rdo_geometry", "rdo_leaf_costs", "rdo_dp"))

    def encode_frames(self, frames, qt_map=None, maps=None,
                      chroma_maps=None, poc0: int = 0,
                      pipeline_chunk: int | None = None,
                      collect_bin_stats: bool = False):
        """Encode a batch of (y, u, v) frames in one device pass.

        Returns a list of (bitstream_bytes, recon) — one per frame; the
        caller concatenates payloads after the parameter sets.  ``maps``
        or ``chroma_maps`` may be per-frame lists.  With ``rdo_fallback``
        the trees are content-dependent (device RDO beyond map coverage
        at accel level < 3), so each frame's leaves are collected with its
        own lazy deciders, which the replay reuses; the ``collect`` stage
        then leaves out the RDO's own stages.

        ``pipeline_chunk``: split the frame set into chunks of this size,
        enqueue every chunk's wave scan first, then fetch and replay chunk
        k while later chunks may still run on the card.  The outputs do not
        depend on it. ``collect_bin_stats``: ``bin_stats`` holds the last
        frame's bin statistics."""
        F = len(frames)
        t0 = time.perf_counter()
        rdo0 = self._rdo_seconds()
        self.rdo_deferred = []
        maps_l = maps if isinstance(maps, list) else [maps] * F
        cmaps_l = chroma_maps if isinstance(chroma_maps, list) else [chroma_maps] * F
        deciders = [(None, None)] * F
        if not isinstance(maps, list) and not isinstance(chroma_maps, list) \
                and not self.rdo_fallback:
            self.leaves = [self._collect_all(qt_map, maps, chroma_maps)] * F
        else:
            self.leaves = []
            for f, (y, u, v) in enumerate(frames):
                rdo_dec = self._rdo_decides([(y, u, v)], maps_l[f], cmaps_l[f])[0] \
                    if self.rdo_fallback else None
                decide, decide_c = self._deciders(qt_map, maps_l[f], cmaps_l[f], rdo_dec)
                self.leaves.append(self._collect_trees(decide, decide_c))
                if rdo_dec is not None:
                    deciders[f] = (decide, decide_c)
        packed = [(*lv, *fr) for lv, fr in zip(self.leaves, frames)]
        self._time("collect", t0)
        self.timings["collect"] -= self._rdo_seconds() - rdo0
        chunk = pipeline_chunk or F
        passes = [(c0, self._batched_pass(packed[c0:c0 + chunk], fetch=False))
                  for c0 in range(0, F, chunk)]
        out = []
        for c0, (dev, events) in passes:
            self._dev_result = self._fetch(dev, events)
            for k in range(c0, min(c0 + chunk, F)):
                self._cur_frame = k - c0
                y, u, v = frames[k]
                dfn, dcfn = deciders[k]
                out.append(super().encode_frame(
                    y, u, v, qt_map=qt_map, maps=maps_l[k],
                    chroma_maps=cmaps_l[k], poc=poc0 + k,
                    collect_bin_stats=collect_bin_stats, decide_fn=dfn,
                    decide_c_fn=dcfn))
        return out

    def encode_frame(self, y, u, v, qt_map=None, maps=None,
                     chroma_maps=None, poc: int = 0,
                     collect_bin_stats: bool = False, rdo: bool = False):
        """Encode one frame (``encode_frames`` of one).  ``rdo``: the device
        RDO's open-loop search chooses the whole tree (the maps are not
        used), which the wavefront path then codes closed loop."""
        if rdo:
            drdo = DeviceRDO(self)
            decide = drdo.search(y, u, v)
            decide_c = drdo.search_frames_chroma([(y, u, v)])[0][0] \
                if self.cfg.dual_tree else None
            leaves, cleaves = self._collect_trees(decide, decide_c)
            self.leaves = [(leaves, cleaves)]
            self._dev_result = self._batched_pass([(leaves, cleaves, y, u, v)])
            self._cur_frame = 0
            return super().encode_frame(y, u, v, poc=poc,
                                        collect_bin_stats=collect_bin_stats,
                                        decide_fn=decide, decide_c_fn=decide_c)
        return self.encode_frames([(y, u, v)], qt_map=qt_map, maps=maps,
                                  chroma_maps=chroma_maps, poc0=poc,
                                  collect_bin_stats=collect_bin_stats)[0]
