"""Structural vote (K8): the port's plain version against the JAX vote.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it against
the plain version there, on the same ``vote_inputs`` maps as below.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from pmp_vvc_tpu.pmp.structural import structural_vote as jax_vote
from pmp_vvc_tpu_torch._device import resolve_device
from pmp_vvc_tpu_torch.pmp.predict import CompPredictor
from pmp_vvc_tpu_torch.pmp.structural import (
    structural_vote, structural_vote_reference)

torch.set_num_threads(2)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "trained_models" / "bd"

TIES = [-1.5, -0.5, 0.5, 1.5, 2.5, 3.5]


def _jax(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax_vote(jnp.asarray(x)))


def _plain(x: np.ndarray) -> np.ndarray:
    return structural_vote_reference(torch.from_numpy(x)).numpy()


def _num0(x: np.ndarray) -> np.ndarray:
    pooled = np.clip(np.round(x.reshape(-1, 4, 2, 4, 2).max(axis=(2, 4))), 0, 3)
    return (pooled == 0).sum(axis=(1, 2))


CASES = {
    "random": lambda rng: rng.randn(512, 8, 8) * 1.5 + 1.0,
    "wide_range": lambda rng: rng.uniform(-3.0, 6.0, (512, 8, 8)),
    "exact_ties": lambda rng: rng.choice(TIES + [0.0, 1.0, 2.0, 3.0], (512, 8, 8)),
    "all_ties": lambda rng: rng.choice(TIES, (512, 8, 8)),
    "all_zero": lambda rng: np.zeros((16, 8, 8)),
    "all_below_half": lambda rng: rng.uniform(-3.0, 0.49, (64, 8, 8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_vote_matches_jax(case):
    x = CASES[case](np.random.RandomState(0)).astype(np.float32)
    np.testing.assert_array_equal(_plain(x), _jax(x))


@pytest.mark.parametrize("num0", range(17))
def test_plain_vote_matches_jax_in_every_zero_band(num0):
    x = chip_smoke.vote_inputs(4096, seed=1)
    sel = x[_num0(x) == num0]
    assert len(sel) >= 64, "vote_inputs must cover every zero count"
    np.testing.assert_array_equal(_plain(sel), _jax(sel))


@pytest.mark.parametrize("quadrant", range(4))
def test_plain_vote_matches_jax_on_every_quadrant_pattern(quadrant):
    # vote_inputs starts with 4 x 256 maps: every 2x2 pattern of values 0..3
    # in quadrant 0, 1, 2, 3 in turn
    x = chip_smoke.vote_inputs(4096, seed=2)[quadrant * 256:(quadrant + 1) * 256]
    pooled = np.clip(np.round(x.reshape(-1, 4, 2, 4, 2).max(axis=(2, 4))), 0, 3)
    r, c = 2 * (quadrant >> 1), 2 * (quadrant & 1)
    assert len({tuple(q.ravel()) for q in pooled[:, r:r + 2, c:c + 2]}) == 256
    np.testing.assert_array_equal(_plain(x), _jax(x))


def test_vote_inputs_hold_exact_ties():
    x = chip_smoke.vote_inputs(4096, seed=0)
    assert ((x - np.floor(x)) == 0.5).sum() > 1000
    np.testing.assert_array_equal(_plain(x), _jax(x))


def test_trailing_channel_layout():
    x = (np.random.RandomState(4).randn(32, 8, 8, 1) * 1.5 + 1).astype(np.float32)
    out = structural_vote(torch.from_numpy(x)).numpy()
    assert out.shape == (32, 8, 8, 1)
    np.testing.assert_array_equal(out, _jax(x))


def test_cpu_dispatch_uses_plain_version_without_launch():
    x = torch.from_numpy(chip_smoke.vote_inputs(2048, seed=3))
    before = structural_vote.launches
    assert torch.equal(structural_vote(x), structural_vote_reference(x))
    assert structural_vote.launches == before


def test_dispatch_rejects_other_devices_and_shapes():
    with pytest.raises(ValueError):
        structural_vote(torch.zeros(4, 8, 8, device="meta"))
    with pytest.raises(ValueError):
        structural_vote(torch.zeros(4, 4, 4))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompPredictor.from_trained(
            True, CKPT / "Luma_Q_QP32.msgpack", CKPT / "Luma_BD_QP32.msgpack")
    assert resolve_device("cpu") == torch.device("cpu")
