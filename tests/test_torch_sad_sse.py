"""K10e's plain versions ``sad`` / ``sse`` against the JAX package's.

The JAX package sums in int32 with x64 off, and the sum wraps: a 64x64 block
of differences of 1023 has ``sse`` -8,384,512, where ``torch.sum`` on int32
would promote to int64 and give 4,286,582,784. The port's plain versions
(which CPU tensors take) and its CUDA kernel (``csrc/seq_dist.cu``, held to
them on the card by chip_smoke.py) wrap the same way.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pmp_vvc_tpu.ops import distortion as jdist
from pmp_vvc_tpu_torch import ops
from pmp_vvc_tpu_torch.ops import distortion as tdist


def both(fn_name, org, cur, bd=10):
    want = np.asarray(getattr(jdist, fn_name)(jnp.asarray(org), jnp.asarray(cur), bit_depth=bd))
    got = getattr(ops, fn_name)(torch.from_numpy(org), torch.from_numpy(cur), bit_depth=bd)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("bd", [8, 10])
def test_basic_case_matches_jax(bd):
    """tests/test_distortion.py:test_sad_sse_basic's block."""
    org = np.array([[[10, 20], [30, 40]]], np.int32)
    cur = np.array([[[11, 18], [30, 44]]], np.int32)
    for name, value in (("sad", 7), ("sse", 21)):
        got, want = both(name, org, cur, bd)
        np.testing.assert_array_equal(got, want)
        assert int(got[0]) == value


def test_int32_sum_wraps_as_in_jax():
    org = np.full((1, 64, 64), 1023, np.int32)
    cur = np.zeros((1, 64, 64), np.int32)
    got, want = both("sse", org, cur)
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) == -8_384_512
    got, want = both("sad", org, cur)
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) == 64 * 64 * 1023
    # the int32 difference wraps too, and |INT_MIN| stays INT_MIN
    lim = np.iinfo(np.int32)
    rng = np.random.RandomState(0)
    a = rng.choice([lim.max, lim.min, 0, 1], (3, 8, 8)).astype(np.int32)
    b = rng.choice([lim.max, lim.min, -1, 5], (3, 8, 8)).astype(np.int32)
    for name in ("sad", "sse"):
        np.testing.assert_array_equal(*both(name, a, b))


@pytest.mark.parametrize("w,h", list(itertools.product((2, 4, 16, 64), repeat=2)))
def test_random_blocks_match_jax(w, h):
    rng = np.random.RandomState(w * 100 + h)
    cur = rng.randint(0, 1024, (3, h, w)).astype(np.int32)
    for org in (rng.randint(0, 1024, (h, w)).astype(np.int32),
                rng.randint(0, 1024, (3, h, w)).astype(np.int32)):
        for name in ("sad", "sse"):
            np.testing.assert_array_equal(*both(name, org, cur))


def test_cpu_tensors_take_the_plain_versions():
    org = torch.randint(0, 1024, (4, 8, 8), dtype=torch.int32)
    cur = torch.randint(0, 1024, (4, 8, 8), dtype=torch.int32)
    before = (tdist.sad.launches, tdist.sse.launches)
    assert torch.equal(tdist.sad(org, cur), tdist.sad_reference(org, cur))
    assert torch.equal(tdist.sse(org, cur), tdist.sse_reference(org, cur))
    assert (tdist.sad.launches, tdist.sse.launches) == before
