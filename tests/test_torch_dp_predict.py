"""The port's data-parallel predictor (K12c), ``dryrun_multichip_train`` and
``entry`` on the CPU, against the JAX package.

- ``CompPredictor.from_trained(..., mesh=)`` with the luma QP 22 nets of
  ``trained_models/bd/`` on 13 seeded CTUs (a ragged batch: padded to 14
  on two ranks, 15 on three), in two and three gloo rank processes
  (``torch_ranks.Ranks``), in one chunk and in chunks of 8: against the
  JAX package's ``CompPredictor`` on the same checkpoints with
  ``mesh=data_mesh()``, the 8 virtual devices of ``tests/conftest.py``
  (``from_trained``'s restore without its eager template init, as
  ``tests/test_torch_pipeline.py`` builds it), raw bt and dire within
  1e-4 and voted QT maps equal once the JAX raw maps keep a margin from
  every rounding threshold; every rank's arrays equal to the port's
  meshless ones.
- ``dryrun_multichip_train`` on two ranks, from the JAX dry run's initial
  parameters, against JAX's ``make_qbd_train_step`` on a two-device mesh
  with the same draws (``__graft_entry__.py:38-71``).
- ``entry()``'s ``fn`` against the JAX ``entry()``'s on its example, from
  the same parameters.

The JAX entry and dry run draw their initial parameters alike (``init``
with ``PRNGKey(0)`` for the Q net and ``PRNGKey(1)`` for the BD net; the
batch of the init input shapes no parameter), so both comparisons take
them from the JAX ``entry()``'s ``fn``: its eager init costs ~20 s, and a
second would double that.
"""
import inspect
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import __graft_entry__ as jax_entry
from pmp_vvc_tpu.models import LumaMSBDNet as JLumaMSBD, LumaQNet as JLumaQ
from pmp_vvc_tpu.pmp.predict import CompPredictor as JaxPredictor
from pmp_vvc_tpu.train import trainer as jt
from pmp_vvc_tpu_torch.entry import entry
from pmp_vvc_tpu_torch.models import params_from_jax
from pmp_vvc_tpu_torch.parallel import Mesh
from pmp_vvc_tpu_torch.parallel.dryrun import TRAIN_LR, TRAIN_QP, dryrun_train_batch
from pmp_vvc_tpu_torch.pmp.predict import CompPredictor
from torch_ranks import Ranks, same_on_every_rank

torch.set_num_threads(2)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "trained_models" / "bd"
Q_CKPT, BD_CKPT = CKPT / "Luma_Q_QP22.msgpack", CKPT / "Luma_BD_QP22.msgpack"
N_CTUS = 13
CHUNK = 8                   # the second run's chunk: 8 CTUs, then a ragged 5
ATOL = 1e-4                 # tests/test_train.py:118
# Seed 1 keeps every pooled JAX raw QT value at least MARGIN from a rounding
# threshold (test_jax_raw_maps_keep_a_margin), ten times ATOL
SEED = 1
MARGIN = 1e-3
LOSS_RTOL = 1e-5            # tests/test_torch_train_step.py
ENTRY_RTOL = 1e-4

_PREDICT_JOB = '''
from pmp_vvc_tpu_torch.parallel import comm
from pmp_vvc_tpu_torch.pmp.predict import CompPredictor


def run(mesh, x, q_ckpt, bd_ckpt, chunk):
    pred = CompPredictor.from_trained(True, q_ckpt, bd_ckpt, mesh=mesh)
    comm.reset_stats()
    out = {"maps": pred.predict(x), "device": str(pred.device)}
    out["gathers"] = list(comm.stats["all_gather"])
    out["chunked"] = pred.predict(x, batch_size=chunk)
    return out
'''
_TRAIN_JOB = '''
from pmp_vvc_tpu_torch.parallel.dryrun import dryrun_multichip_train


def run(mesh, params):
    return {"train": dryrun_multichip_train(mesh, params)}
'''


def _ctus():
    return np.random.RandomState(SEED).uniform(0, 255, (N_CTUS, 68, 68, 1)).astype(np.float32)


def _port_params(tree):
    return {k: params_from_jax(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_entry_run():
    """The JAX ``entry()``: (fn, example, its nets' initial parameters
    {"q", "bd"}, read from fn's closure)."""
    jfn, (jx,) = jax_entry.entry()
    env = inspect.getclosurevars(jfn).nonlocals
    return jfn, jx, {"q": env["q_params"], "bd": env["bd_params"]}


@pytest.fixture(scope="module")
def jax_init(jax_entry_run):
    return jax_entry_run[2]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The predictor on two ranks and on three, started together."""
    common = dict(x=_ctus(), q_ckpt=str(Q_CKPT), bd_ckpt=str(BD_CKPT), chunk=CHUNK)
    jobs = {w: Ranks(tmp_path_factory.mktemp(f"predict{w}"), w, _PREDICT_JOB, **common)
            for w in (2, 3)}
    yield jobs
    for job in jobs.values():
        for p in job.procs:
            p.kill()


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory, jax_init):
    """The dry run's training step on two ranks, from JAX's parameters."""
    job = Ranks(tmp_path_factory.mktemp("train"), 2, _TRAIN_JOB,
                params=_port_params(jax_init))
    yield job
    for p in job.procs:
        p.kill()


@pytest.fixture(scope="module")
def jax_maps():
    pred = JaxPredictor(JLumaQ(), JLumaMSBD(),
                        serialization.msgpack_restore(Q_CKPT.read_bytes()),
                        serialization.msgpack_restore(BD_CKPT.read_bytes()),
                        mesh=jt.data_mesh())
    assert pred.mesh.size == 8          # 13 CTUs padded to 16
    x = _ctus()
    qt_raw = pred.q_net.apply({"params": pred.q_params}, jnp.asarray(x))
    return pred.predict(x), np.asarray(qt_raw)[..., 0]


@pytest.fixture(scope="module")
def port_maps():
    pred = CompPredictor.from_trained(True, Q_CKPT, BD_CKPT, device="cpu")
    x = _ctus()
    qt_raw, _, _ = pred.forward(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return pred.predict(x), qt_raw.numpy()


def _pooled_margin(qt_raw) -> float:
    pooled = qt_raw.reshape(-1, 4, 2, 4, 2).max(axis=(2, 4))
    return float(np.abs(pooled - np.floor(pooled) - 0.5).min())


def test_jax_raw_maps_keep_a_margin(ranks, train_ranks, jax_maps, port_maps):
    """A pooled raw QT value within ATOL of a rounding threshold may round
    either way in two float32 programs; the seed keeps every one MARGIN
    away, and the port's raw maps within ATOL of JAX's. (The rank processes
    start here, first, and run while the JAX references are computed.)"""
    assert _pooled_margin(jax_maps[1]) >= MARGIN
    np.testing.assert_allclose(port_maps[1], jax_maps[1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("world", [2, 3])
def test_mesh_predictor_matches_jax_and_meshless(world, ranks, jax_maps, port_maps):
    (jqt, jbt, jdire), _ = jax_maps
    outs = ranks[world].results()
    maps = same_on_every_rank(outs, "maps")
    assert same_on_every_rank(outs, "device") == "cpu"
    qt, bt, dire = maps
    assert qt.shape == (N_CTUS, 8, 8) and bt.shape == dire.shape == (N_CTUS, 3, 16, 16)
    assert qt.dtype == bt.dtype == dire.dtype == np.float32
    assert _pooled_margin(jax_maps[1]) >= MARGIN
    np.testing.assert_array_equal(qt, jqt)
    np.testing.assert_allclose(bt, jbt, rtol=0, atol=ATOL)
    np.testing.assert_allclose(dire, jdire, rtol=0, atol=ATOL)
    # the meshless port: the same maps, chunked or not
    for a, b in zip(maps, port_maps[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(same_on_every_rank(outs, "chunked"), port_maps[0]):
        np.testing.assert_array_equal(a, b)
    # one gather a chunk: each rank's ceil(13 / world) rows of 1,600 values
    for o in outs:
        assert o["gathers"] == [1, -(-N_CTUS // world) * 1600 * 4]


def test_dryrun_multichip_train_matches_jax(train_ranks, jax_init):
    """The training half on two ranks: the loss each rank returns equals JAX's
    sharded step's on the same draws and initial parameters."""
    mesh = jt.data_mesh(jax.devices()[:2])
    opt = jt.make_optimizer(TRAIN_LR)
    run = jt.make_qbd_train_step(JLumaQ(), JLumaMSBD(), opt, mesh, qp=TRAIN_QP, is_luma=True)
    # the JAX dry run's own draws: the port's helper must give the same
    rng = np.random.RandomState(0)
    n = 4
    want = (rng.uniform(0, 255, (n, 68, 68, 1)).astype(np.float32),
            rng.randint(0, 4, (n, 8, 8, 1)).astype(np.float32),
            rng.randint(0, 3, (n, 16, 16, 3)).astype(np.float32),
            rng.randint(-1, 2, (n, 16, 16, 3)).astype(np.float32))
    for a, b in zip(dryrun_train_batch(n), want):
        np.testing.assert_array_equal(a, b)
    fresh = jax.tree.map(jnp.array, jax_init)       # the step donates its state
    _, loss = run(jt.init_state(opt, fresh), *want, TRAIN_LR)
    got = same_on_every_rank(train_ranks.results(), "train")
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(loss), rtol=LOSS_RTOL)


def test_entry_matches_jax(jax_entry_run):
    """Voted maps equal (the margin asserted first); bt and dire within
    ENTRY_RTOL of each output's largest magnitude: the random-init nets on
    0-255 samples reach 3e6, where a float32 ulp is 0.25."""
    jfn, jx, jax_init = jax_entry_run
    fn, (x,) = entry(device="cpu", params=_port_params(jax_init))
    assert x.shape == (8, 68, 68, 1) and x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    jqt, jbt, jdire = (np.asarray(a) for a in jfn(jx))
    qt_raw = JLumaQ().apply({"params": jax_init["q"]}, jx)
    assert _pooled_margin(np.asarray(qt_raw)[..., 0]) >= MARGIN
    qt, bt, dire = (a.numpy() for a in fn(x))
    assert qt.shape == jqt.shape == (8, 8, 8, 1) and bt.shape == jbt.shape == (8, 16, 16, 3)
    np.testing.assert_array_equal(qt, jqt)
    for got, want in ((bt, jbt), (dire, jdire)):
        for c in range(3):
            scale = float(np.abs(want[..., c]).max())
            np.testing.assert_allclose(got[..., c], want[..., c], rtol=0,
                                       atol=ENTRY_RTOL * scale)


def test_mesh_device_must_match():
    """The mesh's device is the predictor's: without ``device`` the mesh's,
    and another raises (an NCCL mesh, whose tensors live on the card, with
    the CPU among them)."""
    mesh = Mesh(None, 0, 2, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh"):
        CompPredictor.from_trained(True, Q_CKPT, BD_CKPT, device="cuda", mesh=mesh)
    nccl = Mesh(None, 0, 1, "nccl", torch.device("cuda"))
    with pytest.raises(ValueError, match="mesh"):
        CompPredictor.from_trained(True, Q_CKPT, BD_CKPT, device="cpu", mesh=nccl)
    pred = CompPredictor.from_trained(True, Q_CKPT, BD_CKPT, mesh=mesh)
    assert pred.device.type == "cpu" and pred.mesh is mesh
