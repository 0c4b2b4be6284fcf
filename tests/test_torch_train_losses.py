"""The port's training loss (K11a's plain version) and Adam update (K11b's
plain version) against the JAX package's losses and optax, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pmp_vvc_tpu.train import losses as jl
from pmp_vvc_tpu.train.trainer import step_decay_schedule as jax_schedule
from pmp_vvc_tpu_torch.ops import train_generic as tg
from pmp_vvc_tpu_torch.train import losses as tl
from pmp_vvc_tpu_torch.train.trainer import step_decay_schedule

torch.set_num_threads(2)

QPS = (22, 27, 32, 37)
LOSS_RTOL = 1e-6     # float32 means of 1,024 terms summed in another order
GRAD_ATOL = 1e-7     # gradients are (weight / count) * sign * wd: ~1e-3
N = 4


def loss_inputs(seed, n=N):
    """NCHW branch outputs and labels; a quarter of the positions has
    outputs exactly equal to the labels in every branch, so the L1, the
    direction and the residual terms all meet exact zeros."""
    rng = np.random.RandomState(seed)
    bt = rng.randint(0, 4, (n, 3, 16, 16)).astype(np.float32)
    dire = rng.randint(-1, 2, (n, 3, 16, 16)).astype(np.float32)
    bd = [rng.randn(n, 2, 16, 16).astype(np.float32) * 2 for _ in range(3)]
    exact = rng.rand(n, 16, 16) < 0.25
    for i in range(3):
        bd[i][:, 0][exact] = bt[:, i][exact]
        bd[i][:, 1][exact] = dire[:, i][exact]
    qt_lab = rng.randint(0, 4, (n, 1, 8, 8)).astype(np.float32)
    qt_out = (qt_lab + rng.randn(n, 1, 8, 8) * (rng.rand(n, 1, 8, 8) < 0.7)) \
        .astype(np.float32)
    return qt_out, bd, qt_lab, bt, dire


def _nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


@jax.jit
def _jax_q(qt_out, qt_lab):
    return jax.value_and_grad(lambda q: jnp.mean(jnp.abs(q - qt_lab)))(qt_out)


def _jax_value_and_grad(mode, qp, is_luma):
    def f(qt_out, bd, qt_lab, bt, dire):
        if mode == "bd":
            return jl.msbd_loss(bd, bt, dire, qp=qp, is_luma=is_luma)
        return jl.qbd_loss(qt_out, bd, qt_lab, bt, dire, qp=qp, is_luma=is_luma)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1)))


def jax_loss_and_grads(mode, qp, is_luma, qt_out, bd, qt_lab, bt, dire):
    """(loss, grad qt_out (N,1,8,8), [grad bd_i (N,2,16,16)]) from JAX."""
    if mode == "q":
        loss, g = _jax_q(_nhwc(qt_out), _nhwc(qt_lab))
        return float(loss), np.moveaxis(np.asarray(g), -1, 1), None
    loss, (gq, gbd) = _jax_value_and_grad(mode, qp, is_luma)(
        _nhwc(qt_out), [_nhwc(b) for b in bd], _nhwc(qt_lab), _nhwc(bt), _nhwc(dire))
    return (float(loss), np.moveaxis(np.asarray(gq), -1, 1),
            [np.moveaxis(np.asarray(g), -1, 1) for g in gbd])


def port_loss_and_grads(fn, mode, qp, is_luma, qt_out, bd, qt_lab, bt, dire):
    q = torch.tensor(qt_out, requires_grad=True)
    b = [torch.tensor(x, requires_grad=True) for x in bd]
    loss = fn(mode, q, b, torch.tensor(qt_lab), torch.tensor(bt), torch.tensor(dire),
              qp=qp, is_luma=is_luma)
    wrt = ([q] if mode != "bd" else []) + (b if mode != "q" else [])
    grads = [g.numpy() for g in torch.autograd.grad(loss, wrt)]
    return (float(loss.detach()), grads[0] if mode != "bd" else None,
            grads[-3:] if mode != "q" else None)


def fma_ties(bd, bt, dire, qp, is_luma):
    """Per branch i, the positions where the residual term's two products
    are equal (its argument is exactly 0 in the port) and wd_i times the
    label difference is not exact in float32. XLA's CPU backend contracts
    ``wd*a - wd*b`` into an FMA, so there JAX's argument is the rounding
    error of one product, of either sign, and its gradient's sign is that
    error's (JAX's rule at 0 is +1, which the port keeps)."""
    row = tl.weight_row(qp, is_luma).astype(np.float64)
    ties = []
    for i in range(3):
        r = dire[:, i].astype(np.float64)
        wd = np.float32(r * r + row[i]).astype(np.float64)
        if i == 0 and qp == 22:
            wd = np.ones_like(wd)
        dt = bt[:, i] if i == 0 else bt[:, i] - bt[:, i - 1]
        dd = bd[0][:, 0] if i == 0 else bd[i][:, 0] - bd[i - 1][:, 0]
        exact = np.float32(wd * dt).astype(np.float64) == wd * dt
        ties.append((dd == dt) & ~exact)
    return ties


LOSS_CASES = [("q", 22, True)] + [(mode, qp, is_luma) for mode in ("bd", "qbd")
                                   for qp in QPS for is_luma in (True, False)]


def assert_matches_jax(got, want, mode, qp, is_luma, qt_out, bd, qt_lab, bt, dire):
    """(loss, grad qt_out, [grad bd_i]) held to JAX's: the loss within
    LOSS_RTOL, the gradients within GRAD_ATOL but for one flipped sign of a
    residual term at an FMA tie, and +1 as |x|'s gradient at 0."""
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    if mode != "bd":
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GRAD_ATOL)
        # |x|'s gradient at 0 is JAX's +1, not torch's 0
        hit = qt_out == qt_lab
        assert hit.any() and (got[1][hit] > 0).all()
    if mode != "q":
        # at an FMA tie of branch i, the depth gradients of branches i and
        # i-1 may differ from JAX's by one flipped sign of that term
        ties = fma_ties(bd, bt, dire, qp, is_luma)
        scale = tg.loss_params(mode, bt.shape[0], qp, is_luma)[21:24]
        flip = [np.zeros(bt[:, 0].shape) for _ in range(3)]
        for i, tie in enumerate(ties):
            wd = 2 * scale[i] * (dire[:, i] ** 2 + tl.weight_row(qp, is_luma)[i])
            for j in ([i, i - 1] if i else [i]):
                flip[j] = np.maximum(flip[j], np.where(tie, wd, 0))
        # ties occur only where the inputs put outputs equal to the labels
        exact = np.logical_and.reduce([bd[i][:, 0] == bt[:, i] for i in range(3)])
        assert not any((t & ~exact).any() for t in ties)
        for i, (g, w) in enumerate(zip(got[2], want[2])):
            np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=0, atol=GRAD_ATOL)
            assert (np.abs(g[:, 0] - w[:, 0]) <= flip[i] + GRAD_ATOL).all()
            np.testing.assert_allclose(g[:, 0][flip[i] == 0], w[:, 0][flip[i] == 0],
                                       rtol=0, atol=GRAD_ATOL)
            hit = bd[i][:, 1] == dire[:, i]
            assert hit.any() and (g[:, 1][hit] > 0).all()


@pytest.mark.parametrize("mode,qp,is_luma", LOSS_CASES)
def test_loss_and_gradient_match_jax(mode, qp, is_luma):
    """Every QP and both components (the q loss takes neither)."""
    args = loss_inputs(seed=qp + 100 * is_luma)
    want = jax_loss_and_grads(mode, qp, is_luma, *args)
    got = port_loss_and_grads(tg.qbd_loss, mode, qp, is_luma, *args)
    assert_matches_jax(got, want, mode, qp, is_luma, *args)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = loss_inputs(seed=3)
    a = port_loss_and_grads(tg.qbd_loss, "qbd", 27, True, *args)
    b = port_loss_and_grads(tg.qbd_loss_reference, "qbd", 27, True, *args)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))
    assert tg.qbd_loss.launches == 0


def plain_total(values, positions):
    """A term's float64 sum over the label positions, in numpy's order."""
    return values.astype(np.float64).sum()


def kernel_mirror(mode, qp, is_luma, qt_out, bd, qt_lab, bt, dire, total=plain_total):
    """The arithmetic of csrc/qbd_loss.cu in numpy float32: every element in
    the JAX order, the term gradients from ``loss_params``, the depth
    gradient summed as the kernel sums it, the means in float64.
    ``total(values, positions)`` sums one term's |x| (float32, in position
    order) over a grid of ``positions`` label positions (n * 64 in mode "q",
    else n * 256)."""
    f = np.float32
    n = bt.shape[0] if mode != "q" else qt_out.shape[0]
    p = tg.loss_params(mode, n, qp, is_luma)
    m, qp22, c, g = p[:3], p[3], p[4:14], p[14:24]
    sgn = lambda x: np.where(x >= 0, f(1), f(-1))
    positions = n * (64 if mode == "q" else 256)
    term = lambda x: total(np.abs(x).ravel(), positions)
    sums = np.zeros(10)
    gq, gb = None, None
    if mode != "bd":
        d = qt_out - qt_lab
        sums[0] = term(d)
        gq = g[0] * sgn(d)
    if mode != "q":
        dep = [b[:, 0] for b in bd]
        dirp = [b[:, 1] for b in bd]
        t = [bt[:, i] for i in range(3)]
        r = [dire[:, i] for i in range(3)]
        wd = [r[i] * r[i] + m[i] for i in range(3)]
        if qp22:
            wd[0] = np.ones_like(wd[0])
        gres, gb = [], [np.zeros_like(b) for b in bd]
        for i in range(3):
            a = dep[i] - t[i]
            bdir = wd[i] * dirp[i] - wd[i] * r[i]
            cc = wd[0] * dep[0] - wd[0] * t[0] if i == 0 else \
                wd[i] * (dep[i] - dep[i - 1]) - wd[i] * (t[i] - t[i - 1])
            sums[1 + i] = term(a)
            sums[4 + i] = term(bdir)
            sums[7 + i] = term(cc)
            gres.append((g[7 + i] * sgn(cc)) * wd[i])
            gb[i][:, 1] = (g[4 + i] * sgn(bdir)) * wd[i]
        for i in range(3):
            gd = (-gres[i + 1] + gres[i]) if i < 2 else gres[i]
            gb[i][:, 0] = gd + g[1 + i] * sgn(dep[i] - t[i])
    mean = np.array([sums[0] / (n * 64)] + list(sums[1:] / (n * 256)), f)
    if mode == "q":
        return mean[0], gq, gb
    msbd = f(0)
    for i in range(3):
        for k in (1 + i, 4 + i, 7 + i):
            msbd = f(msbd + c[k] * mean[k])
    return (msbd if mode == "bd" else f(c[0] * mean[0] + msbd)), gq, gb


@pytest.mark.parametrize("mode,qp,is_luma", [("q", 22, True), ("bd", 22, False),
                                             ("bd", 37, True), ("qbd", 32, False),
                                             ("qbd", 22, True)])
def test_kernel_arithmetic_matches_the_plain_version(mode, qp, is_luma):
    """The kernel's formulas (mirrored in numpy) against autograd: the loss
    within 1e-6 relative, each gradient within 2 ulps of the largest."""
    args = loss_inputs(seed=7, n=32)
    want = port_loss_and_grads(tg.qbd_loss_reference, mode, qp, is_luma, *args)
    got = kernel_mirror(mode, qp, is_luma, *args)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    pairs = ([(got[1], want[1])] if mode != "bd" else []) + \
        (list(zip(got[2], want[2])) if mode != "q" else [])
    for a, b in pairs:
        bound = 2 * np.spacing(np.abs(b).max())
        assert np.abs(a - b).max() <= bound


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def assert_one_ulp(got, want, *addends):
    """|got - want| <= 1 ulp of the largest of the result and the addends of
    the last addition: XLA's CPU backend contracts ``a*b + c`` into an FMA,
    which rounds once where the plain version rounds twice, so under
    cancellation a few ulps of the result are one ulp of the operands."""
    top = np.maximum.reduce([np.abs(np.asarray(a, np.float32)) for a in (want, *addends)])
    assert (np.abs(np.asarray(got) - np.asarray(want)) <= np.spacing(top)).all()


def test_bias_corrections_match_optax():
    # inject_hyperparams holds b1 and b2 as float32 arrays
    f = jax.jit(lambda c: (1 - jnp.float32(0.9) ** c, 1 - jnp.float32(0.999) ** c))
    for count in list(range(1, 40)) + [999, 1000, 1001, 2000]:
        want = [float(np.float32(v)) for v in f(jnp.int32(count))]
        assert list(tg.bias_corrections(count)) == want, count


def test_adam_matches_optax_given_the_same_gradients():
    """Three steps (learning rates 1e-3, 5e-4, 2e-4) and one at count 1,000,
    each from optax's state after the step before, so that each step's
    rounding is held alone; gradients over ten decades, zero ones included."""
    rng = np.random.RandomState(0)
    shapes = [(5, 3, 3, 3), (32,), (8, 8, 1, 1), (2,)]
    params = [rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[(rng.randn(*s) * 10.0 ** rng.uniform(-9, 1, s)).astype(np.float32)
              for s in shapes] for _ in range(4)]
    for g in grads:
        g[1][:7] = 0.0                      # zero gradients
    grads[2][3][:] = 0.0
    lrs = [1e-3, 5e-4, 2e-4, 1e-4]
    counts = [0, 1, 2, 999]                 # optax's count before each step

    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)

    @jax.jit
    def jstep(jp, state, g, lr):
        state.hyperparams["learning_rate"] = lr
        up, state = opt.update(g, state, jp)
        return optax.apply_updates(jp, up), state

    f = np.float32
    b1, omb1, b2, omb2, _ = tg.ADAM_CONSTS
    for g, lr, count in zip(grads, lrs, counts):
        inner = state.inner_state[0]._replace(count=jnp.int32(count))
        state = state._replace(inner_state=(inner,) + tuple(state.inner_state[1:]))
        p0 = [np.asarray(p) for p in jp]
        mu0 = np.concatenate([np.asarray(m).ravel() for m in inner.mu])
        nu0 = np.concatenate([np.asarray(m).ravel() for m in inner.nu])
        tp = [torch.tensor(p) for p in p0]
        mu, nu = torch.tensor(mu0), torch.tensor(nu0)
        jp, state = jstep(jp, state, [jnp.asarray(x) for x in g], jnp.asarray(lr))
        tg.adam_update(tp, [torch.tensor(x) for x in g], mu, nu, lr,
                       *tg.bias_corrections(count + 1))
        adam_state = state.inner_state[0]
        assert int(adam_state.count) == count + 1
        gf = np.concatenate([x.ravel() for x in g])
        want_mu = np.concatenate([np.asarray(m).ravel() for m in adam_state.mu])
        want_nu = np.concatenate([np.asarray(m).ravel() for m in adam_state.nu])
        assert_one_ulp(mu.numpy(), want_mu, omb1 * gf, b1 * mu0)
        assert_one_ulp(nu.numpy(), want_nu, omb2 * (gf * gf), b2 * nu0)
        for a, b, p in zip(tp, jp, p0):
            step = a.numpy() - p                 # (-lr) u, up to a rounding
            assert_one_ulp(a.numpy(), np.asarray(b), p, step)
        assert (gf == 0).any()
    assert tg.adam_update.launches == 0


def test_adam_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        tg.adam_update([torch.zeros(3)], [torch.zeros(4)], torch.zeros(3), torch.zeros(3),
                       1e-3, *tg.bias_corrections(1))


def test_step_decay_schedule():
    s = step_decay_schedule(1e-3, 20)
    assert s(0) == 1e-3
    assert s(19) == 1e-3
    assert s(20) == 5e-4
    assert s(40) == 2.5e-4
    # frozen at the last value above 1e-6
    assert s(1000) > 1e-6
    j = jax_schedule(1e-3, 20)
    assert [s(e) for e in range(0, 400, 7)] == [j(e) for e in range(0, 400, 7)]


def test_loss_tables_are_the_jax_packages():
    np.testing.assert_array_equal(tl.LUMA_WEIGHT_MAT, jl.LUMA_WEIGHT_MAT)
    np.testing.assert_array_equal(tl.CHROMA_WEIGHT_MAT, jl.CHROMA_WEIGHT_MAT)
    assert tl.LossWeights() == tl.LossWeights(**vars(jl.LossWeights()))
