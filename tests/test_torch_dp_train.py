"""The port's data-parallel training (K12c) on the CPU over gloo, against
the JAX package's sharded steps.

Two rank processes (``torch_ranks.Ranks``) run one job:

- for each stage (q, bd, qbd), two steps of the port's mesh step
  (``make_*_train_step(..., mesh=)``: each rank on its ``shard_batch``
  block, the gradient bucket ``bucket_pack`` scaled by 1/2, summed by
  ``comm.all_reduce_sum``, then K11b on the bucket's views), chroma nets
  from the committed QP 22 checkpoints, a global batch of 4 seeded float
  samples; against JAX's ``make_*_train_step(...,
  data_mesh(jax.devices()[:2]))`` on the same batch, within
  ``tests/test_torch_train_step.py``'s bounds; the two ranks' parameters
  bit-equal after every step, and the loss each returns equal to JAX's
  global loss;
- ``host_shard`` on equal and on unequal slices;
- the driver's ``train(..., mesh=)`` for one epoch of ``synth_dataset``:
  only rank 0 writes, and the ranks return equal rows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmp_vvc_tpu.models import ChromaMSBDNet as JChromaMSBD, ChromaQNet as JChromaQ
from pmp_vvc_tpu.train import trainer as jt
from pmp_vvc_tpu_torch.models import ChromaMSBDNet, ChromaQNet, load_trained, params_from_jax
from pmp_vvc_tpu_torch.ops.dp_generic import bucket_pack, bucket_pack_reference
from pmp_vvc_tpu_torch.ops.train_generic import ADAM_CONSTS, _flat_views
from pmp_vvc_tpu_torch.parallel import Mesh
from pmp_vvc_tpu_torch.train.driver import synth_dataset, train
from pmp_vvc_tpu_torch.train import trainer as tt
from test_torch_train_step import (CKPT, GRAD_ATOL, LOSS_RTOL, MARGIN, PARAM_ATOL, QP,
                                   _as_port, _nhwc)
from torch_ranks import Ranks, same_on_every_rank

torch.set_num_threads(2)

STAGES = (("q", 1e-3), ("bd", 1e-3), ("qbd", 2e-4))
STEPS = 2
BATCH = 4                   # global: two CTUs a rank
SYNTH_N, SYNTH_BATCH = 16, 8
# At step 2, optax's |mu_hat| / sqrt(nu_hat) is at most 1.0014 (Cauchy-Schwarz
# over the two gradients' weights), at step 1 exactly 1 where g != 0: a
# weight whose gradient signs differ in the two packages may end two steps
# apart by at most 2 lr (1 + 1.0014)
TWO_STEP_BOUND = 2 * (1 + 1.0014)

_JOB = '''
import pathlib
import numpy as np
import torch
from pmp_vvc_tpu_torch.models import ChromaMSBDNet, ChromaQNet
from pmp_vvc_tpu_torch.ops.train_generic import ADAM_CONSTS
from pmp_vvc_tpu_torch.parallel import comm, host_shard
from pmp_vvc_tpu_torch.train import trainer as tt
from pmp_vvc_tpu_torch.train.driver import synth_dataset, train


def stage_steps(mesh, stage, lr, trees, batch, steps, qp):
    q_net, bd_net = ChromaQNet(), ChromaMSBDNet()
    q_net.load_state_dict({k: torch.from_numpy(v) for k, v in trees["q"].items()})
    bd_net.load_state_dict({k: torch.from_numpy(v) for k, v in trees["bd"].items()})
    named = {"q": list(q_net.named_parameters()), "bd": list(bd_net.named_parameters()),
             "qbd": [(f"q.{k}", p) for k, p in q_net.named_parameters()]
             + [(f"bd.{k}", p) for k, p in bd_net.named_parameters()]}[stage]
    opt = tt.Adam([p for _, p in named])
    if stage == "q":
        run = tt.make_q_train_step(q_net, opt, mesh=mesh)
    elif stage == "bd":
        run = tt.make_bd_train_step(bd_net, opt, qp=qp, is_luma=False, mesh=mesh)
    else:
        run = tt.make_qbd_train_step(q_net, bd_net, opt, qp=qp, is_luma=False, mesh=mesh)
    x, qt, bt, dire = tt.shard_batch(mesh, tuple(torch.from_numpy(a) for a in batch))
    out = {"losses": [], "params": [], "grads": None, "block": x.numpy()}
    for step in range(steps):
        args = (x, qt) if stage == "q" else (x, qt, bt, dire)
        out["losses"].append(float(run(*args, lr)))
        out["params"].append({k: p.detach().numpy().copy() for k, p in named})
        if step == 0:   # the first step's reduced gradient, from Adam's first moment
            out["grads"], off = {}, 0
            for k, p in named:
                out["grads"][k] = (opt.mu[off:off + p.numel()].view_as(p)
                                   / float(ADAM_CONSTS[1])).numpy().copy()
                off += p.numel()
    return out


def run(mesh, stages, trees, batch, steps, qp, synth_n, synth_batch, out_dir):
    comm.reset_stats()
    res = {s: stage_steps(mesh, s, lr, trees, batch, steps, qp) for s, lr in stages}
    res["all_reduce"] = list(comm.stats["all_reduce"])
    x = np.arange(6 * 3, dtype=np.float32).reshape(6, 3)
    blocks = host_shard(mesh, (x[2 * mesh.rank:2 * mesh.rank + 2], x[:1]))
    res["host_shard"] = [b.numpy() for b in blocks]
    try:
        host_shard(mesh, x[:2 + mesh.rank])
        res["unequal"] = None
    except ValueError as e:
        res["unequal"] = str(e)
    d = pathlib.Path(out_dir) / f"rank{mesh.rank}"
    d.mkdir(parents=True)
    _, rows = train("qbd", synth_dataset(synth_n, seed=3), synth_dataset(8, seed=4),
                    qp=qp, epochs=1, batch=synth_batch, ckpt_dir=d, ckpt_every=1,
                    log_path=d / "loss.csv", device="cpu", mesh=mesh,
                    print_fn=lambda m: None)
    res["rows"] = rows
    res["written"] = sorted(p.name for p in d.glob("*"))
    return res
'''


@pytest.fixture(scope="module")
def batch():
    """A global batch of four chroma CTUs of seeded float samples in
    [0, 255] (NCHW) and seeded labels (float samples keep the nets away from
    the near-ties of 8-bit content; tests/test_torch_train_step.py)."""
    rng = np.random.RandomState(2)
    x = rng.uniform(0, 255, (BATCH, 3, 34, 34)).astype(np.float32)
    qt = rng.randint(0, 3, (BATCH, 1, 8, 8)).astype(np.float32)
    bt = rng.randint(0, 4, (BATCH, 3, 16, 16)).astype(np.float32)
    dire = rng.randint(-1, 2, (BATCH, 3, 16, 16)).astype(np.float32)
    return x, qt, bt, dire


@pytest.fixture(scope="module")
def trees():
    return {"q": load_trained(CKPT / f"Chroma_Q_QP{QP}.msgpack"),
            "bd": load_trained(CKPT / f"Chroma_BD_QP{QP}.msgpack")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, trees, batch):
    tmp = tmp_path_factory.mktemp("dp_train")
    port_trees = {k: {n: v.numpy() for n, v in params_from_jax(t).items()}
                  for k, t in trees.items()}
    job = Ranks(tmp / "job", 2, _JOB, stages=STAGES, trees=port_trees, batch=batch,
                steps=STEPS, qp=QP, synth_n=SYNTH_N, synth_batch=SYNTH_BATCH,
                out_dir=str(tmp / "out"))
    yield job
    for p in job.procs:
        p.kill()


def run_jax(stage, trees, batch, lr):
    """Two jitted JAX steps on a two-device mesh: (losses, params after each
    step, the first step's gradient tree from Adam's first moment)."""
    mesh = jt.data_mesh(jax.devices()[:2])
    q_net, bd_net = JChromaQ(), JChromaMSBD()
    opt = jt.make_optimizer(lr)
    fresh = lambda t: jax.tree.map(lambda a: jnp.array(np.asarray(a)), t)
    x, qt, bt, dire = (_nhwc(a) for a in batch)
    if stage == "q":
        state = jt.init_state(opt, fresh(trees["q"]))
        step = jt.make_q_train_step(q_net, opt, mesh)
        args = (x, qt)
    else:
        state = jt.init_state(opt, fresh(trees if stage == "qbd" else trees["bd"]))
        make = jt.make_bd_train_step if stage == "bd" else jt.make_qbd_train_step
        nets = (bd_net,) if stage == "bd" else (q_net, bd_net)
        step = make(*nets, opt, mesh, qp=QP, is_luma=False)
        args = (x, qt, bt, dire)
    losses, params, grads = [], [], None
    for k in range(STEPS):
        state, loss = step(state, *args, lr)
        losses.append(float(loss))
        # the step donates its state: copy it out before the next one
        params.append(jax.tree.map(np.asarray, state.params))
        if k == 0:
            grads = jax.tree.map(lambda m: np.asarray(m) / ADAM_CONSTS[1],
                                 state.opt_state.inner_state[0].mu)
    return losses, params, grads


@pytest.mark.parametrize("stage,lr", STAGES, ids=[s for s, _ in STAGES])
def test_two_rank_steps_match_jax_sharded(stage, lr, trees, batch, ranks):
    j_losses, j_params, j_grads = run_jax(stage, trees, batch, lr)
    outs = [o[stage] for o in ranks.results()]
    assert np.array_equal(outs[0]["block"], batch[0][:2])
    assert np.array_equal(outs[1]["block"], batch[0][2:])
    got = same_on_every_rank(outs, "params")        # bit-equal on both ranks
    losses = same_on_every_rank(outs, "losses")
    grads = same_on_every_rank(outs, "grads")
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    j_grads = _as_port(stage, j_grads)
    j_params = [_as_port(stage, p) for p in j_params]
    start = _as_port(stage, trees if stage == "qbd" else trees[stage])
    assert j_grads.keys() == grads.keys() == got[0].keys()
    for k in grads:
        np.testing.assert_allclose(grads[k], j_grads[k], rtol=0, atol=GRAD_ATOL, err_msg=k)
    # the first step: tests/test_torch_train_step.py's margin rule
    diff = max(float(np.abs(grads[k] - j_grads[k]).max()) for k in grads)
    cleared = total = 0
    for k in grads:
        big = np.abs(j_grads[k]) > MARGIN * diff
        cleared += int(big.sum())
        total += big.size
        np.testing.assert_allclose(got[0][k][big], j_params[0][k][big], rtol=1e-6,
                                   atol=PARAM_ATOL, err_msg=k)
        assert np.abs(got[0][k] - j_params[0][k]).max() <= 2 * lr * (1 + 1e-6), k
        assert (got[0][k][big] != start[k][big]).all(), k
        assert np.abs(got[1][k] - j_params[1][k]).max() <= TWO_STEP_BOUND * lr * (1 + 1e-6), k
    assert cleared > total / 20, (cleared, total)


def test_every_step_reduces_one_bucket(ranks):
    """One all-reduce a step, of every gradient and the loss."""
    for o in ranks.results():
        n_values = sum(g.size for g in o["qbd"]["grads"].values())
        q_values = sum(g.size for g in o["q"]["grads"].values())
        bd_values = sum(g.size for g in o["bd"]["grads"].values())
        assert n_values == q_values + bd_values
        calls, nbytes = o["all_reduce"]
        assert calls == 3 * STEPS
        assert nbytes == STEPS * 4 * (q_values + bd_values + n_values + 3)


def test_shard_batch_and_host_shard(ranks):
    mesh = Mesh(None, 1, 2, "gloo", torch.device("cpu"))
    x = torch.arange(12.0).reshape(6, 2)
    a, b = tt.shard_batch(mesh, (x, x[:4]))
    assert torch.equal(a, x[3:]) and torch.equal(b, x[2:4])
    with pytest.raises(ValueError, match="do not split"):
        tt.shard_batch(mesh, (x, x[:5]))
    with pytest.raises(ValueError, match="do not split"):
        tt.shard_batch(Mesh(None, 0, 4, "gloo", torch.device("cpu")), x)
    full = np.arange(18, dtype=np.float32).reshape(6, 3)
    for r, o in enumerate(ranks.results()):
        blocks = o["host_shard"]
        assert np.array_equal(blocks[0], full[2 * r:2 * r + 2])
        assert np.array_equal(blocks[1], full[:1])
        assert o["unequal"] is not None and "differ in length" in o["unequal"]


def test_mesh_device_must_match_the_parameters():
    """A step under an NCCL mesh, whose tensors live on the card, refuses
    nets on the CPU."""
    nccl = Mesh(None, 0, 1, "nccl", torch.device("cuda"))
    q_net, bd_net = ChromaQNet(), ChromaMSBDNet()
    opt = tt.Adam(list(q_net.parameters()) + list(bd_net.parameters()))
    with pytest.raises(ValueError, match="mesh"):
        tt.make_qbd_train_step(q_net, bd_net, opt, qp=QP, is_luma=False, mesh=nccl)
    with pytest.raises(ValueError, match="mesh"):
        tt.make_q_train_step(q_net, tt.Adam(q_net.parameters()), mesh=nccl)


def test_driver_trains_on_two_ranks(ranks, tmp_path):
    """One epoch of the qbd stage: the ranks' rows equal but for their wall
    time, only rank 0 wrote, and the epoch's mean loss near a single-process
    run's (2 steps; after the first, the runs differ where Adam's step on a
    near-zero gradient takes either sign: 1e-4 relative)."""
    outs = ranks.results()
    rows = [[{k: v for k, v in r.items() if k != "time_s"} for r in o["rows"]]
            for o in outs]
    assert rows[0] == rows[1] and len(rows[0]) == 1
    assert outs[0]["written"] == ["loss.csv", "qbd_epoch1.msgpack", "qbd_final.msgpack"]
    assert outs[1]["written"] == []
    _, single = train("qbd", synth_dataset(SYNTH_N, seed=3), synth_dataset(8, seed=4),
                      qp=QP, epochs=1, batch=SYNTH_BATCH, device="cpu",
                      print_fn=lambda m: None)
    np.testing.assert_allclose(rows[0][0]["train_loss"], single[0]["train_loss"], rtol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 0.5, 1 / 3])
def test_bucket_pack_reference_views(scale):
    """The bucket's views give back every gradient times the scale, and its
    last element is the loss times the scale; on the CPU the wrapper is the
    plain version and launches nothing."""
    rng = np.random.RandomState(5)
    grads = [torch.from_numpy(np.asarray(rng.randn(*s), np.float32))
             for s in ((16, 3, 3, 3), (16,), (), (0,), (2, 5))]
    loss = torch.tensor(1.75)
    before = bucket_pack.launches
    flat = bucket_pack(grads, loss, scale)
    assert bucket_pack.launches == before
    assert torch.equal(flat, bucket_pack_reference(grads, loss, scale))
    assert flat.dtype == torch.float32 and flat.numel() == 16 * 27 + 16 + 1 + 0 + 10 + 1
    s = np.float32(scale)
    for v, g in zip(_flat_views(flat[:-1], grads), grads):
        assert v.shape == g.shape
        assert np.array_equal(v.numpy(), g.numpy() * s)
    assert flat[-1].item() == np.float32(1.75) * s
    with pytest.raises(ValueError, match="one value"):
        bucket_pack(grads, torch.ones(2), scale)
    with pytest.raises(TypeError):
        bucket_pack([g.double() for g in grads], loss, scale)
