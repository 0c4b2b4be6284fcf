"""The port's nets and weight bridge against the JAX package, on the CPU.

Weights are the committed trained checkpoints (``trained_models/bd``); the
raw outputs must agree within atol 1e-4, the bound tests/test_train.py uses
for two runs of the JAX nets. The JAX params are the checkpoint restored by
``flax.serialization.msgpack_restore``, which is what
``CompPredictor.from_trained`` loads into its template (``from_bytes``),
without its eager template init, which takes half a minute on the CPU.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pmp_vvc_tpu.models.layers import max_pool2d as jax_max_pool2d
from pmp_vvc_tpu.models.layers import nearest_upsample as jax_upsample
from pmp_vvc_tpu.models.layers import zero_pad2d as jax_zero_pad2d
from pmp_vvc_tpu.models import ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet
from pmp_vvc_tpu_torch.models import load_trained, params_from_jax, read_flax_msgpack
from pmp_vvc_tpu_torch.models.layers import max_pool2d, nearest_upsample, zero_pad2d
from pmp_vvc_tpu_torch.pmp.predict import CompPredictor

torch.set_num_threads(2)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "trained_models" / "bd"
CHECKPOINTS = sorted(CKPT.glob("*.msgpack"))
NETS = [("Luma", 32), ("Chroma", 22)]
ATOL = 1e-4


def _paths(comp, qp):
    return CKPT / f"{comp}_Q_QP{qp}.msgpack", CKPT / f"{comp}_BD_QP{qp}.msgpack"


@pytest.fixture(scope="module")
def predictors():
    """{(comp, qp): ((jitted JAX Q-net, jitted JAX BD-net), port predictor
    on the CPU)}."""
    out = {}
    for comp, qp in NETS:
        q, bd = _paths(comp, qp)
        q_net, bd_net = ((LumaQNet(), LumaMSBDNet()) if comp == "Luma"
                         else (ChromaQNet(), ChromaMSBDNet()))
        q_params = serialization.msgpack_restore(q.read_bytes())
        bd_params = serialization.msgpack_restore(bd.read_bytes())
        jax_nets = (jax.jit(lambda x, n=q_net, p=q_params: n.apply({"params": p}, x)),
                    jax.jit(lambda x, t, n=bd_net, p=bd_params:
                            n.apply({"params": p}, x, t)))
        out[(comp, qp)] = (jax_nets, CompPredictor.from_trained(
            comp == "Luma", q, bd, device="cpu"))
    return out


def _inputs(comp, n, seed):
    rng = np.random.RandomState(seed)
    shape = (n, 68, 68, 1) if comp == "Luma" else (n, 34, 34, 3)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    q = rng.uniform(0, 3, (n, 8, 8, 1)).astype(np.float32)
    return x, q


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _same_tree(a, b, path=""):
    assert type(a) is dict and type(b) is dict, path
    assert sorted(a) == sorted(b), path
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k], f"{path}/{k}")
        else:
            assert isinstance(a[k], np.ndarray), f"{path}/{k}"
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), f"{path}/{k}"


@pytest.mark.parametrize("path", CHECKPOINTS, ids=[p.stem for p in CHECKPOINTS])
def test_msgpack_reader_matches_flax(path):
    data = path.read_bytes()
    _same_tree(read_flax_msgpack(data), serialization.msgpack_restore(data))


def test_msgpack_reader_decodes_every_type_flax_writes():
    tree = {"ints": {str(v): v for v in (0, 1, 127, 128, 255, 256, 65535,
                                         65536, 2**32, -1, -32, -33, -128,
                                         -129, -32768, -40000, -2**40)},
            "floats": [0.5, -1e300, 3.25], "s": "x" * 40, "long": "y" * 300,
            "flags": [True, False, None], "empty": {},
            "arrays": {"f64": np.arange(6, dtype=np.float64).reshape(2, 3),
                       "i32": np.arange(-3, 3, dtype=np.int32),
                       "big": np.arange(70000, dtype=np.float32)},
            "scalar": np.float32(2.5)}
    data = serialization.msgpack_serialize(tree)
    ours = read_flax_msgpack(data)
    theirs = serialization.msgpack_restore(data)
    assert ours["ints"] == theirs["ints"]
    assert ours["floats"] == theirs["floats"]
    assert ours["flags"] == theirs["flags"] and ours["empty"] == {}
    assert ours["s"] == theirs["s"] and ours["long"] == theirs["long"]
    _same_tree(ours["arrays"], theirs["arrays"])
    assert ours["scalar"] == theirs["scalar"] == np.float32(2.5)


def test_msgpack_reader_rejects_truncated_data():
    data = (CKPT / "Luma_Q_QP32.msgpack").read_bytes()
    with pytest.raises(ValueError):
        read_flax_msgpack(data[:-1])


def test_params_from_jax_renames_and_transposes():
    rng = np.random.RandomState(0)
    k = rng.randn(3, 5, 2, 4).astype(np.float32)          # HWIO
    b = rng.randn(4).astype(np.float32)
    state = params_from_jax({"core": {"conv": {"kernel": k, "bias": b}}})
    assert sorted(state) == ["core.conv.bias", "core.conv.weight"]
    w = state["core.conv.weight"].numpy()                 # OIHW
    assert w.shape == (4, 2, 3, 5)
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["core.conv.bias"].numpy(), b)


def test_luma_bd_checkpoint_size():
    tree = load_trained(CKPT / "Luma_BD_QP32.msgpack")
    state = params_from_jax(tree)
    assert len(state) == 72
    assert sum(v.numel() for v in state.values()) == 1_075_670
    assert all(v.dtype == torch.float32 for v in state.values())


@pytest.mark.parametrize("op", ["pad", "pool2", "pool4", "up2", "up8"])
def test_layer_helpers_match_jax(op):
    x = np.random.RandomState(1).randn(2, 8, 16, 3).astype(np.float32)  # NHWC
    ours, theirs = {
        "pad": (lambda t: zero_pad2d(t, 1, 2, 3, 4),
                lambda a: jax_zero_pad2d(a, 1, 2, 3, 4)),
        "pool2": (lambda t: max_pool2d(t, 2), lambda a: jax_max_pool2d(a, 2)),
        "pool4": (lambda t: max_pool2d(t, 4), lambda a: jax_max_pool2d(a, 4)),
        "up2": (lambda t: nearest_upsample(t, 2), lambda a: jax_upsample(a, 2)),
        "up8": (lambda t: nearest_upsample(t, 8), lambda a: jax_upsample(a, 8)),
    }[op]
    want = np.asarray(theirs(jnp.asarray(x))).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(ours(_nchw(x)).numpy(), want)


@pytest.mark.parametrize("comp,qp", NETS)
def test_q_net_matches_jax(predictors, comp, qp):
    (jq, _), tp = predictors[(comp, qp)]
    x, _ = _inputs(comp, 3, seed=2)
    want = np.asarray(jq(jnp.asarray(x)))
    with torch.inference_mode():
        got = tp.q_net(_nchw(x)).numpy()
    assert got.shape == (3, 1, 8, 8)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=ATOL, rtol=0)


@pytest.mark.parametrize("comp,qp", NETS)
def test_msbd_net_matches_jax(predictors, comp, qp):
    (_, jbd), tp = predictors[(comp, qp)]
    x, q = _inputs(comp, 3, seed=3)
    want = jbd(jnp.asarray(x), jnp.asarray(q))
    with torch.inference_mode():
        got = tp.bd_net(_nchw(x), _nchw(q))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (3, 2, 16, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("comp,qp", NETS)
def test_forward_raw_maps_match_jax(predictors, comp, qp):
    (jq, jbd), tp = predictors[(comp, qp)]
    x, _ = _inputs(comp, 3, seed=4)
    qt_raw = jq(jnp.asarray(x))
    bd = jbd(jnp.asarray(x), qt_raw)
    qt, bt, dire = tp.forward(_nchw(x))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qt_raw)[..., 0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        bt.numpy(), np.stack([np.asarray(o)[..., 0] for o in bd], 1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        dire.numpy(), np.stack([np.asarray(o)[..., 1] for o in bd], 1), atol=ATOL, rtol=0)


def test_predict_splits_batches_like_one_batch(predictors):
    _, tp = predictors[("Chroma", 22)]
    x, _ = _inputs("Chroma", 5, seed=5)
    whole = tp.predict(x)
    split = tp.predict(x, batch_size=2)
    assert [a.shape for a in whole] == [(5, 8, 8), (5, 3, 16, 16), (5, 3, 16, 16)]
    for a, b in zip(whole, split):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
