"""The work layouts of K8 (``csrc/structural_vote.cu``) and K10e
(``csrc/seq_dist.cu``) emulated in numpy on the CPU, against the plain
versions and the JAX package.

K8: the grid-strided loop over a warp's CTUs, lane f's float4, the packed
levels of the xor-2 pool, the half-warp's one ballot, the xor-4 quadrant sums
and the (p0, p0, p1, p1) stores, with an empty slot on the last map's address
for an odd N; the 8-lane variant's two rows a lane, two ballots and xor-2
quadrant sums. Every output float4 must be stored exactly once. Held to
``structural_vote_reference`` and to ``pmp_vvc_tpu/pmp/structural.py``.
K10e: each block of samples on a team of warps sized to it, its units
(int4s, or samples in the scalar instantiation) dealt to the team's lanes
in rounds of exactly the loads a lane needs, each lane's sum, each warp's
``__reduce_add_sync`` and the team's sum of its warps' sums, all modulo 2^32;
held to ``sad_reference`` / ``sse_reference`` and to
``pmp_vvc_tpu/ops/distortion.py``.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from pmp_vvc_tpu.ops import distortion as jdist
from pmp_vvc_tpu.pmp.structural import structural_vote as jax_vote
from pmp_vvc_tpu_torch.ops import distortion as tdist
from pmp_vvc_tpu_torch.pmp.structural import structural_vote_reference

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# K8: a half-warp per CTU
# ---------------------------------------------------------------------------

K8_LANES, K8_THREADS = 16, 256          # the shipped build
SMS = 132
LANE = np.arange(32)


def level(x):
    """clamp(rint(x), 0, 3) as an int (rint rounds half to even)."""
    return np.clip(np.rint(x), 0, 3).astype(np.int64)


def half_ballot(z, lanes):
    """``__popc(__ballot_sync(FULL, z) & mask)`` of each lane (warps, 32),
    ``mask`` the lane's group of ``lanes`` lanes."""
    ballot = (z.astype(np.uint64) << LANE.astype(np.uint64)).sum(axis=1).astype(np.uint32)
    mask = ((np.uint32(1 << lanes) - np.uint32(1)) << (LANE // lanes * lanes)).astype(np.uint32)
    return np.bitwise_count(ballot[:, None] & mask[None, :]).astype(np.int64)


def vote(p0, p1, num0, other_row):
    """``vote``: case A with the quadrant's (sum, count of 1s) packed and
    added across lane ^ other_row; case B."""
    a0, a1 = np.where(p0 == 0, 1, p0), np.where(p1 == 0, 1, p1)
    mine = ((a0 + a1) << 4) | ((a0 == 1).astype(np.int64) + (a1 == 1))
    quad = mine + mine[:, LANE ^ other_row]
    qsum, n1 = quad >> 4, quad & 15
    mixed = (qsum >= 5) & (qsum <= 10)
    fix = lambda a: np.where(~mixed, a, np.where(n1 >= 3, 1, np.where(a == 1, 2, a)))  # noqa: E731
    case_b = (num0 > 12) & (num0 < 16)
    p0 = np.where(num0 <= 12, fix(a0), np.where(case_b, 0, p0))
    p1 = np.where(num0 <= 12, fix(a1), np.where(case_b, 0, p1))
    return p0, p1


def k8_grid(n, lanes=K8_LANES, threads=K8_THREADS, sms=SMS):
    """The C entry point's grid: blocks covering the CTU groups, up to
    2,048 threads an SM; (groups, warps)."""
    groups = -(-n // (32 // lanes))
    blocks = min(-(-groups * 32 // threads), sms * (2048 // threads))
    return groups, blocks * threads // 32


def k8_run(x, lanes=K8_LANES, threads=K8_THREADS, sms=SMS):
    """``structural_vote_kernel`` over its grid in numpy: (N, 8, 8) float32
    maps -> (N, 8, 8), every float4 of the output stored exactly once."""
    n = len(x)
    src4 = x.reshape(n, 16, 4)
    out = np.zeros((n, 16, 4), np.float32)
    stores = np.zeros((n, 16), np.int64)
    groups, warps = k8_grid(n, lanes, threads, sms)
    slot, f = LANE // lanes, LANE % lanes
    for first in range(0, groups, warps):           # the loop's rounds
        g = np.arange(first, min(first + warps, groups))[:, None]
        c = g * (32 // lanes) + slot                  # (warps, 32)
        live = c < n
        src = src4[np.where(live, c, n - 1)]          # (warps, 32, 16, 4)
        at = lambda i: np.take_along_axis(src, i[..., None, None], axis=2)[:, :, 0]  # noqa: E731
        if lanes == 16:
            v = at(np.broadcast_to(f, c.shape))
            row = level(np.maximum(v[..., 0], v[..., 1])) | \
                (level(np.maximum(v[..., 2], v[..., 3])) << 2)
            other = row[:, LANE ^ 2]
            p0 = np.maximum(row & 3, other & 3)
            p1 = np.maximum(row >> 2, other >> 2)
            num0 = half_ballot(np.where(f & 2, p1 == 0, p0 == 0), lanes)
            p0, p1 = vote(p0, p1, num0, 4)
            at_out = [np.broadcast_to(f, c.shape)]
        else:
            r, b = f >> 1, f & 1
            v0, v1 = at(np.broadcast_to(4 * r + b, c.shape)), at(np.broadcast_to(4 * r + 2 + b,
                                                                                  c.shape))
            p0 = level(np.maximum(np.maximum(v0[..., 0], v0[..., 1]),
                                  np.maximum(v1[..., 0], v1[..., 1])))
            p1 = level(np.maximum(np.maximum(v0[..., 2], v0[..., 3]),
                                  np.maximum(v1[..., 2], v1[..., 3])))
            num0 = half_ballot(p0 == 0, lanes) + half_ballot(p1 == 0, lanes)
            p0, p1 = vote(p0, p1, num0, 2)
            at_out = [np.broadcast_to(4 * r + b, c.shape), np.broadcast_to(4 * r + 2 + b, c.shape)]
        value = np.stack([p0, p0, p1, p1], axis=-1).astype(np.float32)
        for i in at_out:
            out[c[live], i[live]] = value[live]
            np.add.at(stores, (c[live], i[live]), 1)
    assert (stores == 1).all(), "every output float4 is stored exactly once"
    return out.reshape(x.shape)


def plain_vote(x):
    return structural_vote_reference(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def maps():
    """``vote_inputs``: every 2x2 pattern in each quadrant, every zero count
    0..16, exact k + 0.5 ties, all-zero maps, random fill."""
    return chip_smoke.vote_inputs(4096, seed=5)


@pytest.fixture(scope="module")
def jax_votes(maps):
    return np.asarray(jax.jit(jax_vote)(jnp.asarray(maps)))


@pytest.mark.parametrize("lanes,threads,sms", [(16, 128, SMS), (16, 256, SMS), (8, 128, SMS),
                                               (8, 256, SMS), (16, 128, 1), (8, 256, 1)])
def test_k8_layout_matches_the_plain_version_and_jax(maps, jax_votes, lanes, threads, sms):
    """The shipped build, ``K8_VARIANTS``' (8 lanes a CTU, 128 threads a
    block) and a one-SM grid whose warps take several rounds of the loop."""
    got = k8_run(maps, lanes, threads, sms)
    np.testing.assert_array_equal(got, plain_vote(maps))
    np.testing.assert_array_equal(got, jax_votes)


def test_k8_inputs_cover_every_case(maps):
    pooled = level(maps.reshape(-1, 4, 2, 4, 2).max(axis=(2, 4)))
    num0 = (pooled == 0).sum(axis=(1, 2))
    assert set(num0.tolist()) == set(range(17))
    for q in range(4):
        r, c = 2 * (q >> 1), 2 * (q & 1)
        quads = pooled[q * 256:(q + 1) * 256, r:r + 2, c:c + 2].reshape(-1, 4)
        assert len({tuple(v) for v in quads}) == 256
    assert ((maps - np.floor(maps)) == 0.5).sum() > 1000


@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 507, 508, 512])
def test_k8_odd_and_path_counts(maps, jax_votes, n):
    """An odd N leaves the last warp's second CTU (and with 8 lanes up to
    three) empty; 508 and 512 are the prediction path's two chunks. The
    maps are spread over every kind of ``vote_inputs``."""
    pick = np.linspace(0, len(maps) - 1, n).astype(int)
    x, want = maps[pick], jax_votes[pick]
    for lanes in (16, 8):
        got = k8_run(x, lanes)
        np.testing.assert_array_equal(got, plain_vote(x))
        np.testing.assert_array_equal(got, want)


def test_k8_trailing_channel_layout(maps, jax_votes):
    """(N, 8, 8, 1) has the memory of (N, 8, 8): the kernel sees the same
    float4s."""
    x = maps[:33, :, :, None].copy()
    got = k8_run(x)
    assert got.shape == (33, 8, 8, 1)
    np.testing.assert_array_equal(got, plain_vote(x))
    np.testing.assert_array_equal(got[..., 0], jax_votes[:33])


# ---------------------------------------------------------------------------
# K10e: a team of warps per block of samples, exact loads a lane
# ---------------------------------------------------------------------------

K10E_WARPS, K10E_WARP_UNITS, K10E_LPL = 4, 64, 1   # the shipped build
TEAM_MAX = 32                        # a thread block's most warps
SIDES = (2, 4, 8, 16, 32, 64)
# (warps a block, units a warp at most, units a lane in a thread block):
# the shipped build and ``K10E_VARIANTS``'
BUILDS = [(4, 64, 1), (8, 64, 1), (2, 64, 1), (4, 32, 1), (4, 64, 2)]


def k10e_form(n, vec=True, warp_units=K10E_WARP_UNITS, lpl=K10E_LPL):
    """``dispatch``: (samples a unit, units, warps of a thread block per
    block of samples, 0 for a warp each, loads a lane a round, whether the
    rounds cover the units exactly) of a block of n samples; the int4
    instantiation where ``vec`` (both pointers on the 16-byte grain) and n
    is a multiple of 4."""
    u = 4 if vec and n % 4 == 0 else 1
    units, team = n // u, 0
    if units > warp_units:
        team = 1
        while team < TEAM_MAX and units > 32 * team * lpl:
            team *= 2
    lanes = 32 * max(team, 1)
    loads = 2 if units > lanes else 1
    return u, units, team, loads, units > 0 and units % (lanes * loads) == 0


def k10e_run(org, cur, square, vec=True, warps=K10E_WARPS, warp_units=K10E_WARP_UNITS,
             lpl=K10E_LPL):
    """``warp_dist_kernel`` or ``team_dist_kernel`` over its grid in numpy:
    org (h, w) or (K, h, w), cur (K, h, w) int32 -> (K,) int32."""
    k, h, w = cur.shape
    u, units, team, loads, exact = k10e_form(h * w, vec, warp_units, lpl)
    lanes = 32 * max(team, 1)
    o = org.reshape(-1, units, u).view(np.uint32)
    c = cur.reshape(k, units, u).view(np.uint32)
    d = o - c                                          # wraps
    t = d * d if square else np.where(d.view(np.int32) < 0, np.uint32(0) - d, d)
    per_unit = np.broadcast_to(t.sum(axis=2, dtype=np.uint32), (k, units))
    # thread t's load j of the round at base t + r * lanes * loads: unit
    # base + j * lanes, zero-filled past the end (never, where exact)
    rounds = -(-units // (lanes * loads))
    assert team or rounds == 1, "a warp covers its block in one round"
    i = (np.arange(lanes)[:, None, None] + np.arange(rounds)[None, :, None] * lanes * loads
         + np.arange(loads)[None, None, :] * lanes)
    inside = i < units
    assert inside.all() or not exact, "an exact instantiation loads past the block"
    assert (np.bincount(i[inside], minlength=units) == 1).all(), "each unit loaded once"
    got = np.where(inside, per_unit[:, np.minimum(i, units - 1)], np.uint32(0))
    lane_sums = got.reshape(k, lanes, -1).sum(axis=2, dtype=np.uint32)
    warp_sums = lane_sums.reshape(k, lanes // 32, 32).sum(axis=2, dtype=np.uint32)
    totals = warp_sums.sum(axis=1, dtype=np.uint32)    # the thread block's shared sums
    # the grid: K10E_WARPS warps a block, warp g of the launch on block g;
    # or a thread block per block of samples
    if not team:
        owners = np.arange(-(-k // warps) * warps)
        assert sorted(owners[owners < k].tolist()) == list(range(k))
    return totals.view(np.int32)


def test_k10e_forms():
    """The shipped build: a warp up to 64 int4s (16x16) at up to 2 a lane,
    above that a thread block at 1 a lane (8 warps at 32x32, 32 at 64x64);
    3x5 blocks and views off the 16-byte grain take samples, 64x64 of them
    in two rounds."""
    assert k10e_form(16) == (4, 4, 0, 1, False) and k10e_form(256) == (4, 64, 0, 2, True)
    assert k10e_form(512) == (4, 128, 4, 1, True) and k10e_form(4096) == (4, 1024, 32, 1, True)
    assert k10e_form(15) == (1, 15, 0, 1, False)
    assert k10e_form(256, vec=False) == (1, 256, 8, 1, True)
    assert k10e_form(4096, vec=False) == (1, 4096, 32, 2, True)
    assert k10e_form(256, warp_units=32) == (4, 64, 2, 1, True)
    assert k10e_form(4096, lpl=2) == (4, 1024, 16, 2, True)


@jax.jit
def jax_dists(org1, orgk, cur):
    return (jdist.sad(org1, cur), jdist.sse(org1, cur), jdist.sad(orgk, cur),
            jdist.sse(orgk, cur))


def plain_dists(org1, orgk, cur):
    t = [torch.from_numpy(a) for a in (org1, orgk, cur)]
    return [f(o, t[2]).numpy() for o in t[:2] for f in (tdist.sad_reference,
                                                        tdist.sse_reference)]


def check_dists(org1, orgk, cur):
    """Every build and both instantiations against the plain versions and
    the JAX package, on one original and on one per block."""
    want = [np.asarray(a) for a in jax_dists(org1, orgk, cur)]
    for got, w in zip(plain_dists(org1, orgk, cur), want):
        np.testing.assert_array_equal(got, w)
    for build, vec in itertools.product(BUILDS, (True, False)):
        got = [k10e_run(o, cur, sq, vec, *build) for o in (org1, orgk) for sq in (False, True)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("w", SIDES)
def test_k10e_layout_every_side(w):
    rng = np.random.RandomState(w)
    for h in SIDES:
        k = 67 if (w, h) == (16, 16) else 3
        cur = rng.randint(0, 1024, (k, h, w)).astype(np.int32)
        check_dists(rng.randint(0, 1024, (h, w)).astype(np.int32),
                    rng.randint(0, 1024, (k, h, w)).astype(np.int32), cur)


def test_k10e_layout_wraps_as_the_int32_sum():
    """A 64x64 block of differences of 1023 (its sse wraps to -8,384,512,
    in the block form) and differences at the int32 limits (the difference
    and its square wrap, |INT_MIN| stays INT_MIN), in both forms."""
    org = np.full((1, 64, 64), 1023, np.int32)
    cur = np.zeros((2, 64, 64), np.int32)
    for build in BUILDS:
        assert k10e_run(org, cur[:1], True, True, *build)[0] == -8_384_512
    check_dists(org[0], np.repeat(org, 2, 0), cur)
    lim = np.iinfo(np.int32)
    rng = np.random.RandomState(9)
    for h, w in ((8, 8), (64, 64), (5, 3)):
        check_dists(rng.choice([lim.max, lim.min, 0, 1], (h, w)).astype(np.int32),
                    rng.choice([lim.max, lim.min, 0, 1], (2, h, w)).astype(np.int32),
                    rng.choice([lim.max, lim.min, -1, 5], (2, h, w)).astype(np.int32))
