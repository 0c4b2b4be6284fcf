"""The work layouts of K11a (``csrc/qbd_loss.cu``) and K12b
(``csrc/halo.cu``) emulated in numpy on the CPU, against the plain versions
and the JAX package.

K11a: positions a thread in index order, runs of 16 threads in turn and the
runs in turn, each block's partials summed by the last block in block order; the
emulated loss and gradients held to ``qbd_loss_reference`` and, at batch 32,
to ``train/losses.py``. K12b: the host's band table (plane, pitch, columns,
buffer offset, items, shift, first block), each block's band by its block
offsets, each item's row and quad by a shift or a division, 16-byte quads
where the call is aligned and samples otherwise, only the received bands on
unpack; held to ``halo_pack_reference`` / ``halo_unpack_reference`` and to
the JAX package's ``exchange`` over a mesh.
"""
import numpy as np
import pytest
import torch

from pmp_vvc_tpu_torch.ops import train_generic as tg
from pmp_vvc_tpu_torch.parallel import spatial as sp
from test_torch_train_losses import (assert_matches_jax, jax_loss_and_grads, kernel_mirror,
                                     loss_inputs, port_loss_and_grads)

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# K11a: the fixed-order sum of one launch
# ---------------------------------------------------------------------------

K11A_PPT, K11A_THREADS = 4, 64          # the shipped build


def block_sums(v, threads):
    """``block_sum`` of each row of ``v`` (blocks, threads): term k of
    threads 16g .. 16g + 15 added in turn (a run), then the runs in turn."""
    runs = v.reshape(v.shape[0], threads // 16, 16)
    acc = runs[:, :, 0].copy()
    for r in range(1, 16):
        acc = acc + runs[:, :, r]
    s = acc[:, 0].copy()
    for g in range(1, threads // 16):
        s = s + acc[:, g]
    return s


def k11a_total(ppt=K11A_PPT, threads=K11A_THREADS):
    """``kernel_mirror``'s ``total`` as K11a sums a term: a thread's ``ppt``
    positions in index order from 0.0, each block's ``block_sum``, then in
    the last block thread t sums blocks t, t + threads, ... in order and the
    same ``block_sum`` runs again."""
    def total(values, positions):
        blocks = -(-positions // (threads * ppt))
        v = np.zeros(blocks * threads * ppt)
        v[:values.size] = values
        per = v.reshape(-1, ppt)
        t = np.zeros(per.shape[0])
        for j in range(ppt):
            t = t + per[:, j]
        partials = block_sums(t.reshape(blocks, threads), threads)
        last = np.zeros(threads)
        for start in range(0, blocks, threads):
            chunk = partials[start:start + threads]
            last[:chunk.size] = last[:chunk.size] + chunk
        return block_sums(last[None], threads)[0]
    return total


def assert_matches_reference(got, want, mode):
    """The loss within 1e-6 relative, each gradient within 2 ulps of its
    largest element (``TRAIN_LOSS_REL``, ``TRAIN_GRAD_ULPS`` on the card)."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    pairs = ([(got[1], want[1])] if mode != "bd" else []) + \
        (list(zip(got[2], want[2])) if mode != "q" else [])
    for a, b in pairs:
        assert np.abs(a - b).max() <= 2 * np.spacing(np.abs(b).max())


@pytest.mark.parametrize("n", [1, 7, 32, 64, 257])
@pytest.mark.parametrize("mode,qp,is_luma", [("q", 22, True), ("bd", 37, False),
                                             ("qbd", 22, True)])
def test_k11a_reduction_matches_the_plain_version(mode, qp, is_luma, n):
    """Batches whose positions fill no whole block (1, 7, 257), one block
    (64 positions: batch 1 in mode q) or 32 (batch 32)."""
    args = loss_inputs(seed=n + 3, n=n)
    got = kernel_mirror(mode, qp, is_luma, *args, total=k11a_total())
    want = port_loss_and_grads(tg.qbd_loss_reference, mode, qp, is_luma, *args)
    assert_matches_reference(got, want, mode)


@pytest.mark.parametrize("ppt,threads", [(1, 64), (2, 64), (4, 32), (4, 128), (4, 256)])
def test_k11a_variants_match_the_plain_version(ppt, threads):
    """``K11A_VARIANTS``' build parameters at batch 257 in mode qbd."""
    args = loss_inputs(seed=11, n=257)
    got = kernel_mirror("qbd", 27, False, *args, total=k11a_total(ppt, threads))
    want = port_loss_and_grads(tg.qbd_loss_reference, "qbd", 27, False, *args)
    assert_matches_reference(got, want, "qbd")


@pytest.mark.parametrize("mode,qp,is_luma", [("q", 22, True), ("bd", 32, True),
                                             ("qbd", 37, False)])
def test_k11a_reduction_matches_jax(mode, qp, is_luma):
    args = loss_inputs(seed=5, n=32)
    got = kernel_mirror(mode, qp, is_luma, *args, total=k11a_total())
    assert_matches_jax(got, jax_loss_and_grads(mode, qp, is_luma, *args), mode, qp,
                       is_luma, *args)


def test_k11a_sum_order_is_the_kernels():
    """The emulated order is the kernel's, not numpy's: at one block it is
    the runs over the thread sums, and it sums every position once."""
    rng = np.random.RandomState(0)
    v = rng.rand(256).astype(np.float32).astype(np.float64).reshape(64, 4)
    per_thread = ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]
    assert k11a_total()(v.ravel(), 256) == block_sums(per_thread[None], 64)[0]
    ones = np.ones(257 * 256, np.float32)
    assert k11a_total()(ones, ones.size) == ones.size


def test_k11a_markstein_quotient_is_the_division():
    """The kernel's mean: q0 = RN(s y) with y = RN(1 / c), r = s - q0 c
    (exact, an FMA), RN(q0 + r y) (an FMA) equals RN(s / c) for the counts
    c = n * 64 and n * 256 and sums s of float32 magnitudes."""
    from fractions import Fraction
    rng = np.random.RandomState(2)
    for _ in range(4000):
        n = int(rng.randint(1, 5000))
        c = float(n * (64 if rng.rand() < 0.5 else 256))
        s = float(np.float32(rng.rand() * 10.0 ** rng.randint(-6, 4))) * c * rng.rand()
        y = 1.0 / c
        q0 = s * y
        r = Fraction(s) - Fraction(q0) * Fraction(c)
        assert Fraction(float(r)) == r                  # the residual is exact
        assert float(Fraction(q0) + r * Fraction(y)) == s / c


# ---------------------------------------------------------------------------
# K12b: the band table and the quad map
# ---------------------------------------------------------------------------

K12B_QPT, K12B_THREADS = 1, 256         # the shipped build
BANDS = 6


def k12b_layout(H, hl, hr, strd, pack, send_a, send_b, v, qpt=K12B_QPT,
                threads=K12B_THREADS):
    """``csrc/halo.cu:layout``: the table of the call's bands as dicts
    (plane index for the pointer) and its grid; ``k12b_pow2`` gives the
    instantiation."""
    table, blocks, off = [], 0, 0
    for k in range(BANDS):
        p, a = k % 3, k < 3
        s = 2 if p else 1
        bw, rows, hlp, spw = (hl if a else hr) // s, H // s, hl // s, strd // s
        if send_a if a else send_b:
            row_items = bw // v
            items = rows * row_items
            table.append(dict(plane=p, pitch=(hl + strd + hr) // s,
                              col=(spw if a else hlp) if pack else (0 if a else hlp + spw),
                              buf_off=off, items=items, row_items=row_items,
                              shift=(row_items & -row_items).bit_length() - 1,
                              block0=blocks))
            blocks += -(-items // (threads * qpt))
        off += rows * bw
    return table, blocks


def k12b_pow2(table):
    """The shift instantiation: every band's items a row a power of two."""
    return all(b["row_items"] & (b["row_items"] - 1) == 0 for b in table)


def k12b_vec(hl, hr, strd, aligned=True):
    """The kernel's 16-byte instantiation: the widths' and every pointer's
    alignment."""
    return aligned and hl % 8 == 0 and hr % 8 == 0 and strd % 8 == 0


def k12b_run(table, blocks, planes, buf, pack, v, qpt=K12B_QPT, threads=K12B_THREADS):
    """``halo_kernel`` over the grid in numpy: each block's band by its
    offsets, then each thread's ``qpt`` items (stride ``threads``), their
    rows and quads by shifts (every band's width a power of two) or a
    division, ``v`` samples each; every load before any store. ``planes``:
    three flat int32 arrays."""
    pow2 = k12b_pow2(table)
    for blk in range(blocks):
        bd = table[sum(blk >= b["block0"] for b in table[1:])]
        first = (blk - bd["block0"]) * threads * qpt + np.arange(threads)
        its = np.concatenate([first + j * threads for j in range(qpt)])
        its = its[its < bd["items"]]
        if pow2:
            row, q = its >> bd["shift"], its & (bd["row_items"] - 1)
        else:
            row = its // bd["row_items"]
            q = its - row * bd["row_items"]
        lanes = np.arange(v)
        at_plane = (row * bd["pitch"] + bd["col"] + q * v)[:, None] + lanes
        at_buf = (bd["buf_off"] + its * v)[:, None] + lanes
        plane = planes[bd["plane"]]
        if pack:
            vals = plane[at_plane]
            buf[at_buf] = vals
        else:
            vals = buf[at_buf]
            plane[at_plane] = vals


def k12b_pack(planes, hl, hr, strd, aligned=True, qpt=K12B_QPT, threads=K12B_THREADS):
    """``pmp_halo_pack`` emulated: the buffer of (1, H', W') numpy planes."""
    H = planes[0].shape[1]
    v = 4 if k12b_vec(hl, hr, strd, aligned) else 1
    table, blocks = k12b_layout(H, hl, hr, strd, True, True, True, v, qpt, threads)
    buf = np.full(sp.band_size(H, hl) + sp.band_size(H, hr), -7, np.int32)
    k12b_run(table, blocks, [p.reshape(-1) for p in planes], buf, True, v, qpt, threads)
    return buf


def k12b_unpack(buf, planes, hl, hr, strd, has_left, has_right, aligned=True,
                qpt=K12B_QPT, threads=K12B_THREADS):
    """``pmp_halo_unpack`` emulated, in place; returns the launch's block
    count (0: no launch)."""
    H = planes[0].shape[1]
    v = 4 if k12b_vec(hl, hr, strd, aligned) else 1
    table, blocks = k12b_layout(H, hl, hr, strd, False, has_left, has_right, v, qpt, threads)
    flat = [p.reshape(-1) for p in planes]
    if blocks:
        k12b_run(table, blocks, flat, buf, False, v, qpt, threads)
    return blocks


def jax_exchange(planes, hl, hr, strd):
    """numpy restatement of the JAX package's ``exchange`` (spatial.py:
    153-167) over every rank's (1, H', W') plane at once, in
    ``tests/test_torch_spatial.py:_jax_exchange``'s form."""
    D = len(planes)
    out = [p.copy() for p in planes]
    for d in range(D):
        if d > 0:                      # left halo <- left neighbour's last hl owned
            out[d][:, :, :hl] = planes[d - 1][:, :, strd:hl + strd]
        if d < D - 1:                  # right halo <- right neighbour's first hr owned
            out[d][:, :, hl + strd:] = planes[d + 1][:, :, hl:hl + hr]
    return out


def stripe_planes(rng, H, hl, hr, strd):
    we = hl + strd + hr
    return [rng.randint(-(1 << 31), (1 << 31) - 1, s, dtype=np.int64).astype(np.int32)
            for s in ((1, H, we), (1, H // 2, we // 2), (1, H // 2, we // 2))]


def mesh_exchange(H, strd, D, hl=sp.HL, hr=sp.HR, aligned=True, qpt=K12B_QPT,
                  threads=K12B_THREADS, seed=0):
    """One step's exchange over a mesh of D stripes through the emulated
    pack and unpack, each held to its plain version on the way; the planes
    after it, and the JAX package's exchange of the same planes."""
    rng = np.random.RandomState(seed + 1000 * D + H + strd)
    ranks = [stripe_planes(rng, H, hl, hr, strd) for _ in range(D)]
    want = [jax_exchange([r[i] for r in ranks], hl >> (i > 0), hr >> (i > 0), strd >> (i > 0))
            for i in range(3)]
    bufs = []
    for r in ranks:
        buf = k12b_pack(r, hl, hr, strd, aligned, qpt, threads)
        ref = sp.halo_pack_reference([torch.from_numpy(p) for p in r], hl, hr, strd)
        assert np.array_equal(buf, ref.numpy())
        bufs.append(buf)
    n_a = sp.band_size(H, hl)
    out = []
    for d, r in enumerate(ranks):
        got = np.full_like(bufs[d], -9)      # what a missing neighbour leaves: never read
        if d > 0:
            got[:n_a] = bufs[d - 1][:n_a]
        if d < D - 1:
            got[n_a:] = bufs[d + 1][n_a:]
        ref = [torch.from_numpy(p.copy()) for p in r]
        planes = [p.copy() for p in r]
        blocks = k12b_unpack(got, planes, hl, hr, strd, d > 0, d < D - 1, aligned, qpt, threads)
        sp.halo_unpack_reference(torch.from_numpy(got), ref, hl, hr, strd, d > 0, d < D - 1)
        assert all(np.array_equal(a, b.numpy()) for a, b in zip(planes, ref))
        assert (blocks == 0) == (D == 1)
        out.append(planes)
    return out, want


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("H", [2, 24, 1080])
@pytest.mark.parametrize("strd", [128, 130, 256, 640])
def test_k12b_index_map_matches_the_plain_versions_and_jax(strd, H, D):
    """strd 130 takes the scalar instantiation (chroma rows of 133
    samples); the others 16-byte quads."""
    got, want = mesh_exchange(H, strd, D)
    for d in range(D):
        for i in range(3):
            assert np.array_equal(got[d][i], want[i][d]), (d, i)


@pytest.mark.parametrize("case", ["scalar: a pointer off 16 bytes", "2 quads a thread",
                                  "4 quads a thread", "128 threads a block",
                                  "512 threads a block", "quads by division (hl 24, hr 96)",
                                  "samples by division (hl 6, hr 12)"])
def test_k12b_builds_and_odd_widths_match_jax(case):
    """``K12B_VARIANTS``' build parameters, the scalar instantiation of an
    aligned shape, and band widths whose items are no power of two."""
    kw = {"scalar: a pointer off 16 bytes": dict(aligned=False),
          "2 quads a thread": dict(qpt=2), "4 quads a thread": dict(qpt=4),
          "128 threads a block": dict(threads=128), "512 threads a block": dict(threads=512),
          "quads by division (hl 24, hr 96)": dict(hl=24, hr=96),
          "samples by division (hl 6, hr 12)": dict(hl=6, hr=12)}[case]
    hl, hr = kw.get("hl", sp.HL), kw.get("hr", sp.HR)
    table, _ = k12b_layout(24, hl, hr, 256, True, True, True,
                           4 if k12b_vec(hl, hr, 256, kw.get("aligned", True)) else 1)
    assert k12b_pow2(table) == ("division" not in case)
    got, want = mesh_exchange(24, 256, 3, **kw)
    for d in range(3):
        for i in range(3):
            assert np.array_equal(got[d][i], want[i][d]), (d, i)


def test_k12b_table_on_the_path():
    """At 3840x2160 over 2 stripes (strd 1920) every band's quads a row
    are a power of two (2 / 1 and 32 / 16), the buffer offsets whole quads,
    and the grid covers each band's items once; the unpack's table holds the
    received bands only."""
    table, blocks = k12b_layout(2160, sp.HL, sp.HR, 1920, True, True, True, 4)
    assert [b["row_items"] for b in table] == [2, 1, 1, 32, 16, 16]
    assert k12b_pow2(table) and all(b["buf_off"] % 4 == 0 for b in table)
    assert sum(b["items"] for b in table) * 4 == \
        sp.band_size(2160, sp.HL) + sp.band_size(2160, sp.HR)
    assert blocks == sum(-(-b["items"] // K12B_THREADS) for b in table)
    right, _ = k12b_layout(2160, sp.HL, sp.HR, 1920, False, False, True, 4)
    assert [(b["plane"], b["col"], b["buf_off"]) for b in right] == \
        [(0, 8 + 1920, sp.band_size(2160, sp.HL)),
         (1, 4 + 960, sp.band_size(2160, sp.HL) + 2160 * 128),
         (2, 4 + 960, sp.band_size(2160, sp.HL) + 2160 * 128 + 1080 * 64)]
    assert k12b_layout(2160, sp.HL, sp.HR, 1920, False, False, False, 4) == ([], 0)

