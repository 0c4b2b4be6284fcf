"""The port's checkpoint writer and flax-like initialisation."""
import pathlib

import numpy as np
import pytest
import torch

from pmp_vvc_tpu_torch.models import (ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet,
                                      init_params, load_into, load_trained, params_from_jax,
                                      params_to_jax, read_flax_msgpack, save_params,
                                      write_flax_msgpack)

torch.set_num_threads(2)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "trained_models" / "bd"


def test_rewriting_a_committed_checkpoint_gives_its_bytes():
    """No JAX or msgpack package: the port's reader and writer alone."""
    raw = (CKPT / "Luma_Q_QP22.msgpack").read_bytes()
    tree = read_flax_msgpack(raw)
    assert write_flax_msgpack(tree) == raw
    # through a state dict and back
    assert write_flax_msgpack(params_to_jax(params_from_jax(tree))) == raw


@pytest.mark.parametrize("name", ["Chroma_BD_QP22", "Luma_BD_QP37"])
def test_state_dict_round_trip_keeps_every_checkpoint(name):
    raw = (CKPT / f"{name}.msgpack").read_bytes()
    assert write_flax_msgpack(params_to_jax(params_from_jax(read_flax_msgpack(raw)))) == raw


def test_writer_encodes_every_length_class():
    """Headers of each size class decode back (fix / 8 / 16 / 32-bit forms)."""
    tree = {"k" * 40: {"a": np.arange(3, dtype=np.float32),
                       "b" * 300: np.zeros((70000,), np.float32),
                       "c": np.zeros((1, 1), np.float32)},
            **{f"m{i}": {} for i in range(20)}}
    back = read_flax_msgpack(write_flax_msgpack(tree))
    assert list(back) == list(tree)
    for k in tree["k" * 40]:
        np.testing.assert_array_equal(back["k" * 40][k], tree["k" * 40][k])
    with pytest.raises(TypeError):
        write_flax_msgpack({"x": 1.5})


def test_port_written_checkpoint_loads_in_the_jax_package(tmp_path):
    import jax
    import jax.numpy as jnp
    from pmp_vvc_tpu.models import ChromaQNet as JChromaQNet
    from pmp_vvc_tpu.models.checkpoint import load_params

    net = init_params(ChromaQNet(), torch.Generator().manual_seed(3))
    save_params(tmp_path / "q.msgpack", params_to_jax(net.state_dict()))
    jnet = JChromaQNet()
    template = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 34, 34, 3)))
    params = load_params(tmp_path / "q.msgpack", template["params"])
    x = np.random.RandomState(0).uniform(0, 255, (2, 34, 34, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x))
    with torch.no_grad():
        got = net(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-4, atol=1e-4)
    # and the port's own loader reads it back unchanged
    back = load_into(ChromaQNet(), tmp_path / "q.msgpack")
    assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                 net.state_dict().values()))


@pytest.mark.parametrize("net_cls", [LumaQNet, LumaMSBDNet, ChromaQNet, ChromaMSBDNet])
def test_init_matches_flax_lecun_normal(net_cls):
    """Per-layer standard deviation within 5% of sqrt(1 / fan_in) on every
    kernel of 4,096 values or more (sampling error below 1.6%), samples cut
    at two standard deviations, biases zero."""
    net = init_params(net_cls(), torch.Generator().manual_seed(0))
    checked = 0
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        std = (1.0 / p[0].numel()) ** 0.5
        limit = 2 * std / 0.87962566103423978
        assert p.abs().max() <= limit * (1 + 1e-6), name
        if p.numel() >= 4096:
            assert abs(float(p.detach().std()) / std - 1) < 0.05, name
            checked += 1
    assert checked >= 5


def test_init_is_seeded():
    a = init_params(ChromaQNet(), torch.Generator().manual_seed(5)).state_dict()
    b = init_params(ChromaQNet(), torch.Generator().manual_seed(5)).state_dict()
    c = init_params(ChromaQNet(), torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_load_trained_reads_what_save_params_writes(tmp_path):
    tree = {"q": params_to_jax(init_params(ChromaQNet(), torch.Generator().manual_seed(1))
                                .state_dict())}
    save_params(tmp_path / "sub" / "x.msgpack", tree)
    back = load_trained(tmp_path / "sub" / "x.msgpack")
    assert back.keys() == tree.keys()
    for k, v in params_from_jax(back["q"]).items():
        np.testing.assert_array_equal(v.numpy(), params_from_jax(tree["q"])[k].numpy())
