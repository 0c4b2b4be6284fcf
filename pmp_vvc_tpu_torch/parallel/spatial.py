"""Spatially sharded wavefront encode: CTU-column stripes and a recon-halo
exchange after every wave step (K12b).

Each rank owns one vertical stripe of the frame (a multiple of the
128-sample CTU width) and keeps it with two halos:

  [ left halo 8 | stripe | right halo 128 ]

- the LEFT halo holds the left neighbour's rightmost recon columns (the
  left reference column, the corner and the CCLM taps reach 8 luma);
- the RIGHT halo holds the right neighbour's leftmost columns (the
  above-right reference reach of a 64-wide CU is 2 * 64 = 128 luma).

The wave schedule is computed globally, every rank runs the same number of
steps, and after every step (whether or not the rank had a live row in it)
the ranks swap their halo bands with ranks d - 1 and d + 1: ``halo_pack``
(``csrc/halo.cu``) gathers the six bands of ``ry``, ``ru`` and ``rv`` into
one buffer, ``comm.neighbour_exchange`` sends and receives it, and
``halo_unpack`` writes what arrived into the halos (rank 0's left edge and
rank D-1's right edge stay as they are). Integer arithmetic keeps the
result equal to the single-device encode.

The port's K5 runs MTS and transform skip only in the 32-pad tile class, so
each level's CUs go to the 32- and 64-pad classes as the port's wave
schedule puts them; the JAX package puts every CU of the stripe scan into
the 64-pad class. The CUs of one level are independent, so the planes are
the same. Envelope as in the JAX package: single tree, QT- or map-driven
partitioning, every tool but LMCS.
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from .. import _build
from ..codec.wavefront import _order_grid, _Scan, _schedule_waves
from . import comm

HL = 8          # left halo (luma columns)
HR = 128        # right halo (above-right reach of a 64-wide CU)


# ---------------------------------------------------------------------------
# K12b: the halo bands of one step
# ---------------------------------------------------------------------------

def band_size(H: int, width: int) -> int:
    """Elements of one band of ``y``, ``u`` and ``v``, ``width`` luma
    columns wide: band A (``hl``) starts the buffer, band B (``hr``)
    follows."""
    return H * width + 2 * (H // 2) * (width // 2)


def _bands(planes, hl, hr, strd):
    """(band A, band B) views of the three (1, H', W') stripe planes: the
    last ``hl`` owned columns (sent right) and the first ``hr`` (sent
    left), at half width in chroma; and the matching halo views (left halo,
    right halo)."""
    sends, halos = ([], []), ([], [])
    for i, p in enumerate(planes):
        s = 1 if i == 0 else 2
        lo, sp, hi = hl // s, strd // s, hr // s
        sends[0].append(p[0, :, sp:sp + lo])
        sends[1].append(p[0, :, lo:lo + hi])
        halos[0].append(p[0, :, :lo])
        halos[1].append(p[0, :, lo + sp:lo + sp + hi])
    return sends, halos


def _check_planes(planes, hl, hr, strd):
    ry = planes[0]
    if len(planes) != 3 or any(p.dtype != torch.int32 or p.ndim != 3 or p.shape[0] != 1
                               for p in planes):
        raise ValueError("the halo planes are ry, ru, rv, each (1, H', W') int32")
    H = ry.shape[1]
    if H % 2 or hl % 2 or hr % 2 or strd % 2 or min(hl, hr) <= 0 or strd < max(hl, hr):
        raise ValueError("halo widths, stripe width and height must be even, the "
                         "stripe at least as wide as each halo")
    if ry.shape[2] != hl + strd + hr or any(
            p.shape[1:] != (H // 2, (hl + strd + hr) // 2) for p in planes[1:]):
        raise ValueError("plane widths must be hl + strd + hr (half in chroma)")
    return H


def halo_pack_reference(planes, hl, hr, strd):
    """Plain version of K12b's pack: the buffer of bands A then B of ``ry``,
    ``ru``, ``rv`` (see ``csrc/halo.cu``), int32."""
    _check_planes(planes, hl, hr, strd)
    sends, _ = _bands(planes, hl, hr, strd)
    return torch.cat([b.reshape(-1) for band in sends for b in band])


def halo_unpack_reference(buf, planes, hl, hr, strd, has_left, has_right):
    """Plain version of K12b's unpack: band A of ``buf`` into the left halos
    where ``has_left``, band B into the right halos where ``has_right``,
    in place."""
    _check_planes(planes, hl, hr, strd)
    _, halos = _bands(planes, hl, hr, strd)
    off = 0
    for band, keep in zip(halos, (has_left, has_right)):
        for h in band:
            n = h.numel()
            if keep:
                h.copy_(buf[off:off + n].view(h.shape))
            off += n


SIGNATURES = {"halo": {
    "pmp_halo_pack": (_build.PTR,) * 3 + (_build.INT,) * 4 + (_build.PTR,) * 2,
    "pmp_halo_unpack": (_build.PTR,) * 4 + (_build.INT,) * 6 + (_build.PTR,)}}


@functools.cache
def _lib(name: str):
    return _build.bind(name, SIGNATURES[name])


def halo_pack(planes, hl, hr, strd):
    """K12b pack: see ``halo_pack_reference``; CPU tensors take it, CUDA
    tensors launch ``csrc/halo.cu``."""
    if planes[0].device.type == "cpu":
        return halo_pack_reference(planes, hl, hr, strd)
    H = _check_planes(planes, hl, hr, strd)
    _build.check_cuda("halo_pack", *planes)
    out = torch.empty((band_size(H, hl) + band_size(H, hr),), dtype=torch.int32,
                      device=planes[0].device)
    err = _lib("halo").pmp_halo_pack(*(p.data_ptr() for p in planes), H, hl, hr, strd,
                                     out.data_ptr(), _build.stream(planes[0]))
    _build.count_launch(halo_pack, err)
    return out


def halo_unpack(buf, planes, hl, hr, strd, has_left, has_right):
    """K12b unpack: see ``halo_unpack_reference``; CPU tensors take it,
    CUDA tensors launch ``csrc/halo.cu`` over the bands received, and
    nothing (no launch counted) where neither neighbour exists."""
    if planes[0].device.type == "cpu":
        return halo_unpack_reference(buf, planes, hl, hr, strd, has_left, has_right)
    H = _check_planes(planes, hl, hr, strd)
    _build.check_cuda("halo_unpack", buf, *planes)
    if buf.dtype != torch.int32 or buf.numel() != band_size(H, hl) + band_size(H, hr):
        raise ValueError("the halo buffer must be int32 and hold both bands")
    if not (has_left or has_right):
        return
    err = _lib("halo").pmp_halo_unpack(buf.data_ptr(), *(p.data_ptr() for p in planes),
                                       H, hl, hr, strd, int(bool(has_left)),
                                       int(bool(has_right)), _build.stream(buf))
    _build.count_launch(halo_unpack, err)


halo_pack.launches = 0
halo_unpack.launches = 0


def exchange(mesh, planes, strd):
    """One step's halo swap of ``planes`` (ry, ru, rv) over ``mesh``:
    pack, one neighbour exchange, unpack (the JAX package's ``exchange``
    for the three planes)."""
    buf = halo_pack(planes, HL, HR, strd)
    got = comm.neighbour_exchange(mesh, buf, band_size(planes[0].shape[1], HL))
    halo_unpack(got, planes, HL, HR, strd, mesh.rank > 0, mesh.rank < mesh.size - 1)


# ---------------------------------------------------------------------------
# the stripe scan
# ---------------------------------------------------------------------------

def _local_schedule(leaves, wave, stripe, D, me, batch, st_cclm):
    """This rank's steps: {class pad: (S, B, 8) int32} in local coordinates
    (x shifted by the stripe's start and the left halo). Every rank gets the
    same S: each level takes as many steps as its fullest (rank, class)
    needs, at least one."""
    by_lvl = collections.defaultdict(lambda: collections.defaultdict(list))
    for i, (x, y, w, h, _q) in enumerate(leaves):
        p = 32 if max(w, h) <= 32 else 64
        by_lvl[int(wave[i])][(x // stripe, p)].append(
            (0, x - (x // stripe) * stripe + HL, y, w, h, i, 1, st_cclm))
    n_lvl = int(wave.max()) + 1 if len(leaves) else 1
    steps = {p: [] for p in batch}
    for lvl in range(n_lvl):
        segs = by_lvl[lvl]
        n_seg = max([1] + [(len(v) + batch[p] - 1) // batch[p] for (_, p), v in segs.items()])
        for s in range(n_seg):
            for p, b in batch.items():
                rows = np.zeros((b, 8), np.int32)
                mine = segs[(me, p)][s * b:(s + 1) * b]
                if mine:
                    rows[:len(mine)] = mine
                steps[p].append(rows)
    return {p: np.stack(v) for p, v in steps.items()}


def _stripe(plane, d, hl, hr, strd):
    """Rank d's (H', hl + strd + hr) stripe of a global plane with its halos
    (zeros outside the frame)."""
    ph = np.asarray(plane, np.int32)
    out = np.zeros((ph.shape[0], hl + strd + hr), np.int32)
    x0 = d * strd - hl
    s0, s1 = max(x0, 0), min(d * strd + strd + hr, ph.shape[1])
    out[:, s0 - x0:s1 - x0] = ph[:, s0:s1]
    return out


def spatial_wave_planes(enc, leaves, y, u, v, mesh):
    """Run the wave compute of one frame spatially sharded over ``mesh``;
    returns, on every rank, the 11 result planes of the whole frame as
    ``WavefrontEncoder``'s fetch gives them (recon uint16, levels int16,
    the five code grids uint8, each (1, ...)), which
    ``FrameEncoder.encode_frame(enc, ...)`` replays.

    ``enc``: a single-tree ``WavefrontEncoder`` without LMCS on the mesh's
    device (no mesh of its own); ``leaves``: its collected luma leaves."""
    cfg = enc.cfg
    D, me = mesh.size, mesh.rank
    H, W = cfg.height, cfg.width
    assert W % (128 * D) == 0, "stripes must be CTU-column multiples"
    assert not cfg.lmcs, "spatial stripes: LMCS vpdu_dep scheduling not wired"
    assert not cfg.dual_tree, "spatial stripes: single tree only"
    stripe = W // D
    We = HL + stripe + HR
    dev = mesh.device
    qp_y, qp_c, qp_j = enc._qps()

    order = _order_grid(leaves, W, H)
    wave = _schedule_waves(leaves, order, W, H)
    sched = _local_schedule(leaves, wave, stripe, D, me, enc.batch, 1 if cfg.cclm else 0)
    og = np.full((H // 4, We // 4), -1, np.int32)
    x0 = me * stripe - HL
    s0, s1 = max(x0, 0), min(me * stripe + stripe + HR, W)
    og[:, (s0 - x0) // 4:(s1 - x0) // 4] = order[:, s0 // 4:s1 // 4]

    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    oy = up(_stripe(y, me, HL, HR, stripe)[None])
    ou = up(_stripe(u, me, HL // 2, HR // 2, stripe // 2)[None])
    ov = up(_stripe(v, me, HL // 2, HR // 2, stripe // 2)[None])
    og4 = up(og[None])
    z = lambda h, w, dt: torch.zeros((1, h, w), dtype=dt, device=dev)
    state = [z(H, We, torch.int32), z(H // 2, We // 2, torch.int32),
             z(H // 2, We // 2, torch.int32), z(H, We, torch.int16),
             z(H // 2, We // 2, torch.int16), z(H // 2, We // 2, torch.int16)] + \
        [z(H // 4, We // 4, torch.uint8) for _ in range(5)]
    scan = _Scan(state, oy, ou, ov, og4, og4, qp_y, qp_c, cfg.bit_depth, float(enc.lam),
                 float(enc.dw_c), bool(cfg.rd_quant), mip=bool(cfg.mip),
                 sdh=bool(cfg.sign_hiding), mts=bool(cfg.mts_intra), lfnst=bool(cfg.lfnst),
                 ts_max=(1 << cfg.ts_max_log2) if cfg.transform_skip else 0,
                 cclm=bool(cfg.cclm), jccr=bool(cfg.joint_cbcr), qp_j=qp_j)
    live = {p: s[:, :, 6].any(axis=1) for p, s in sched.items()}
    rows = {p: up(s) for p, s in sched.items()}
    for t in range(len(next(iter(live.values())))):
        for p in sched:
            if live[p][t]:
                scan.step("st", p, rows[p][t])
        exchange(mesh, state[:3], stripe)

    # the owned columns of every plane, gathered into the whole frame
    owned = [state[0][0, :, HL:HL + stripe].to(torch.int16)] + \
        [p[0, :, HL // 2:(HL + stripe) // 2].to(torch.int16) for p in state[1:3]] + \
        [state[3][0, :, HL:HL + stripe]] + \
        [p[0, :, HL // 2:(HL + stripe) // 2] for p in state[4:6]] + \
        [p[0, :, HL // 4:(HL + stripe) // 4] for p in state[6:]]
    flat = torch.cat([p.contiguous().view(torch.uint8).reshape(-1) for p in owned])
    host = comm.all_gather(mesh, flat[None]).cpu().numpy()
    out, off = [], 0
    dtypes = [np.uint16] * 3 + [np.int16] * 3 + [np.uint8] * 5
    for p, dt in zip(owned, dtypes):
        n = p.numel() * p.element_size()
        parts = [host[d, off:off + n].view(dt).reshape(tuple(p.shape)) for d in range(D)]
        out.append(np.concatenate(parts, axis=1)[None])
        off += n
    return tuple(out)
