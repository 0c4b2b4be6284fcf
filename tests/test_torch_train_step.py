"""One step of each training stage (q, bd, qbd) in the port against the JAX
package's jitted steps, on the CPU: chroma nets at batch 2, both packages
starting from the committed chroma QP 22 checkpoints."""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pmp_vvc_tpu.models import ChromaMSBDNet as JChromaMSBD, ChromaQNet as JChromaQ
from pmp_vvc_tpu.train import trainer as jt
from pmp_vvc_tpu_torch.models import ChromaMSBDNet, ChromaQNet, load_trained, params_from_jax
from pmp_vvc_tpu_torch.ops.train_generic import ADAM_CONSTS
from pmp_vvc_tpu_torch.train import trainer as tt

torch.set_num_threads(2)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "trained_models" / "bd"
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4            # the bound tests/test_train.py:118 uses
# Adam's first step moves a weight by lr * g / (|g| + eps): where |g| clears
# the step's largest gradient difference (held below GRAD_ATOL first) by this
# factor, the two packages' signs agree and the steps agree to far below a
# float32 ulp of the weight
MARGIN = 10
PARAM_ATOL = 1e-7
QP = 22


@pytest.fixture(scope="module")
def batch():
    """Two chroma CTUs of seeded float samples in [0, 255] (NCHW) and
    seeded labels. Float samples keep the max-pool windows and ReLU inputs
    away from ties; on 8-bit content with flat areas the nets' early layers
    meet near-ties that rounding decides differently in the two packages."""
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 255, (2, 3, 34, 34)).astype(np.float32)
    qt = rng.randint(0, 3, (2, 1, 8, 8)).astype(np.float32)
    bt = rng.randint(0, 4, (2, 3, 16, 16)).astype(np.float32)
    dire = rng.randint(-1, 2, (2, 3, 16, 16)).astype(np.float32)
    return x, qt, bt, dire


@pytest.fixture(scope="module")
def trees():
    return {"q": load_trained(CKPT / f"Chroma_Q_QP{QP}.msgpack"),
            "bd": load_trained(CKPT / f"Chroma_BD_QP{QP}.msgpack")}


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


def run_jax(stage, trees, batch, lr):
    """One jitted JAX step on a one-device mesh: (loss, new params tree,
    gradient tree recovered from Adam's first moment)."""
    mesh = jt.data_mesh(jax.devices()[:1])
    q_net, bd_net = JChromaQ(), JChromaMSBD()
    opt = jt.make_optimizer(lr)
    fresh = lambda t: jax.tree.map(lambda a: jnp.array(np.asarray(a)), t)
    x, qt, bt, dire = (_nhwc(a) for a in batch)
    if stage == "q":
        state = jt.init_state(opt, fresh(trees["q"]))
        state, loss = jt.make_q_train_step(q_net, opt, mesh)(state, x, qt, lr)
    elif stage == "bd":
        state = jt.init_state(opt, fresh(trees["bd"]))
        run = jt.make_bd_train_step(bd_net, opt, mesh, qp=QP, is_luma=False)
        state, loss = run(state, x, qt, bt, dire, lr)
    else:
        state = jt.init_state(opt, fresh(trees))
        run = jt.make_qbd_train_step(q_net, bd_net, opt, mesh, qp=QP, is_luma=False)
        state, loss = run(state, x, qt, bt, dire, lr)
    omb1 = ADAM_CONSTS[1]
    grads = jax.tree.map(lambda m: np.asarray(m) / omb1, state.opt_state.inner_state[0].mu)
    return float(loss), jax.tree.map(np.asarray, state.params), grads


def run_port(stage, trees, batch, lr):
    """One port step on the CPU: (loss, {name: new param}, {name: gradient})."""
    q_net, bd_net = ChromaQNet(), ChromaMSBDNet()
    q_net.load_state_dict(params_from_jax(trees["q"]))
    bd_net.load_state_dict(params_from_jax(trees["bd"]))
    x, qt, bt, dire = (torch.from_numpy(a) for a in batch)
    named = {"q": list(q_net.named_parameters()), "bd": list(bd_net.named_parameters()),
             "qbd": [(f"q.{k}", p) for k, p in q_net.named_parameters()]
             + [(f"bd.{k}", p) for k, p in bd_net.named_parameters()]}[stage]
    opt = tt.Adam([p for _, p in named])
    if stage == "q":
        loss = tt.make_q_train_step(q_net, opt)(x, qt, lr)
    elif stage == "bd":
        loss = tt.make_bd_train_step(bd_net, opt, qp=QP, is_luma=False)(x, qt, bt, dire, lr)
    else:
        loss = tt.make_qbd_train_step(q_net, bd_net, opt, qp=QP, is_luma=False)(
            x, qt, bt, dire, lr)
    grads, off = {}, 0
    for k, p in named:
        grads[k] = (opt.mu[off:off + p.numel()].view_as(p) / float(ADAM_CONSTS[1])).numpy()
        off += p.numel()
    return float(loss), {k: p.detach().numpy() for k, p in named}, grads


def _as_port(stage, tree):
    """A JAX tree of the stage's params as {port name: OIHW array}."""
    if stage != "qbd":
        return {k: v.numpy() for k, v in params_from_jax(tree).items()}
    return {f"{net}.{k}": v.numpy() for net in ("q", "bd")
            for k, v in params_from_jax(tree[net]).items()}


@pytest.mark.parametrize("stage,lr", [("q", 1e-3), ("bd", 1e-3), ("qbd", 2e-4)])
def test_one_step_matches_jax(stage, lr, trees, batch):
    j_loss, j_params, j_grads = run_jax(stage, trees, batch, lr)
    p_loss, p_params, p_grads = run_port(stage, trees, batch, lr)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_RTOL)
    j_grads, j_params = _as_port(stage, j_grads), _as_port(stage, j_params)
    start = _as_port(stage, trees if stage == "qbd" else trees[stage])
    assert j_grads.keys() == p_grads.keys() == j_params.keys()
    for k in p_grads:
        np.testing.assert_allclose(p_grads[k], j_grads[k], rtol=0, atol=GRAD_ATOL,
                                   err_msg=k)
    diff = max(float(np.abs(p_grads[k] - j_grads[k]).max()) for k in p_grads)
    cleared = total = 0
    for k in p_grads:
        big = np.abs(j_grads[k]) > MARGIN * diff
        cleared += int(big.sum())
        total += big.size
        np.testing.assert_allclose(p_params[k][big], j_params[k][big], rtol=1e-6,
                                   atol=PARAM_ATOL, err_msg=k)
        # below the margin the two steps may differ in sign: at most 2 lr
        assert np.abs(p_params[k] - j_params[k]).max() <= 2 * lr * (1 + 1e-6), k
        assert (p_params[k][big] != start[k][big]).all(), k
    # the margin leaves a twentieth of the weights or more compared (6.8% in
    # the bd step, 43% in the q step: most weights of trained nets get
    # gradients below 1e-5 from two CTUs)
    assert cleared > total / 20, (cleared, total)
