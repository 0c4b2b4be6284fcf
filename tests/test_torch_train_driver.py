"""The port's training driver, dataset tools and label modules against the
JAX package, on the CPU: ``synth_dataset``, ``load_npy_split`` on a dataset
the port's ``tools/gen_dataset.py`` writes from its RDO search, the labels
of the searched trees, a short ``train`` run, the CLI and
``tools/train_bd.py``."""
import csv
import pathlib

import numpy as np
import pytest
import torch

from pmp_vvc_tpu.data import labels as jlabels
from pmp_vvc_tpu.train import driver as jdriver
from pmp_vvc_tpu_torch.cli import train as cli_train
from pmp_vvc_tpu_torch.codec.rdo_device import DeviceRDO
from pmp_vvc_tpu_torch.codec.wavefront import WavefrontEncoder
from pmp_vvc_tpu_torch.data import labels as tlabels
from pmp_vvc_tpu_torch.data.synthcontent import natural_frame
from pmp_vvc_tpu_torch.models import load_trained, save_params
from pmp_vvc_tpu_torch.pmp.predict import CompPredictor
from pmp_vvc_tpu_torch.tools import gen_dataset, train_bd
from pmp_vvc_tpu_torch.train import driver

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H = 128, 64                 # two CTUs a frame
QPS = (22, 37)


def _nchw(a):
    return np.moveaxis(a, -1, 1)


@pytest.mark.parametrize("name", ["labels.py", "sequences.py"])
def test_label_modules_are_copies(name):
    assert (REPO / "pmp_vvc_tpu" / "data" / name).read_bytes() == \
        (REPO / "pmp_vvc_tpu_torch" / "data" / name).read_bytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_dataset_equals_jax(seed):
    got = driver.synth_dataset(40, seed=seed)
    want = jdriver.synth_dataset(40, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, _nchw(w))


def test_rounded_accuracy_metric():
    pred = np.array([0.4, 1.6, 2.2, 0.9])
    label = np.array([0.0, 2.0, 2.0, 0.0])
    assert driver.rounded_accuracy(pred, label) == 0.75


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A dataset written by the port's gen_dataset on the CPU: 128x64
    natural frames, luma at QP 22 and 37 (Train: 2 frames, Validate: 1) and
    chroma at QP 22."""
    out = tmp_path_factory.mktemp("corpus")
    for split, frames, seed0 in (("Train", 2, 1000), ("Validate", 1, 2000)):
        common = ["--out", str(out), "--frames", str(frames), "--width", str(W),
                  "--height", str(H), "--split", split, "--seed0", str(seed0),
                  "--device", "cpu"]
        gen_dataset.main(common + ["--qps", ",".join(map(str, QPS))])
        gen_dataset.main(common + ["--qps", "22", "--chroma"])
    return out


@pytest.mark.parametrize("comp,qp", [("Luma", 22), ("Luma", 37), ("Chroma", 22)])
def test_load_npy_split_equals_jax(corpus, comp, qp):
    got = driver.load_npy_split(corpus, "Train", comp, qp)
    want = jdriver.load_npy_split(corpus, "Train", comp, qp)
    assert got[0].shape == ((4, 1, 68, 68) if comp == "Luma" else (4, 3, 34, 34))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, _nchw(w))
    qt, bt, dire = got[1:]
    assert qt.min() >= 0 and bt.max() >= 1 and set(np.unique(dire)) <= {-1, 0, 1}


def test_searched_trees_give_the_jax_packages_labels(corpus):
    """Trees of a 2-QP port RDO search: the port's tree_from_leaves and
    labels_from_tree equal the JAX package's on every 64x64 block, and the
    dataset holds those labels."""
    frame = natural_frame(W, H, seed=1000)
    encs = [WavefrontEncoder(gen_dataset.label_config(W, H, qp, False), device="cpu")
            for qp in QPS]
    decides = DeviceRDO(encs[0]).search_frames([frame], encoders=encs)
    qt_file = np.load(corpus / "Train_Luma_QP37_QTdepth_Block8.npy")
    bt_file = np.load(corpus / "Train_Luma_QP37_MSBTdepth_Block16.npy")
    splits = 0
    for qi, qp in enumerate(QPS):
        leaves = [lf[:4] for lf in encs[qi]._collect_leaves(decides[qi][0])]
        for b, (bx, by) in enumerate((x, y) for y in range(0, H, 64) for x in range(0, W, 64)):
            got = tlabels.labels_from_tree(tlabels.tree_from_leaves(leaves, bx, by))
            want = jlabels.labels_from_tree(jlabels.tree_from_leaves(leaves, bx, by))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            splits += int(got[1].max() > 0)
            if qp == 37:
                np.testing.assert_array_equal(qt_file[b], got[0])
                np.testing.assert_array_equal(bt_file[b], got[1])
    assert splits > 0                       # some MTT split among the trees


def test_train_stage_q_loss_falls(tmp_path):
    data = driver.synth_dataset(64, seed=0)
    val = driver.synth_dataset(64, seed=1)
    params, rows = driver.train("q", data, val, epochs=2, lr=1e-3, batch=16,
                                ckpt_dir=tmp_path, ckpt_every=1,
                                log_path=tmp_path / "loss.csv", device="cpu",
                                print_fn=lambda *_: None)
    assert rows[-1]["train_loss"] < rows[0]["train_loss"]
    assert (tmp_path / "q_epoch2.msgpack").exists()
    final = load_trained(tmp_path / "q_final.msgpack")
    assert "conv_q1" in final and params["conv_q1.weight"].shape == (32, 1, 9, 9)
    with open(tmp_path / "loss.csv") as f:
        got = list(csv.DictReader(f))
    assert len(got) == 2 and "qt" in got[0]


def test_cli_trains_on_the_synthetic_set(tmp_path):
    """The joint stage from a {q, bd} checkpoint (--init, here the committed
    QP 22 pair) on the synthetic set: one step, a loss CSV, checkpoints."""
    init = {n: load_trained(REPO / "trained_models" / "bd" / f"Luma_{n.upper()}_QP22.msgpack")
            for n in ("q", "bd")}
    save_params(tmp_path / "init.msgpack", init)
    cli_train.main(["--stage", "qbd", "--synth", "32", "--epochs", "1", "--batch", "32",
                    "--qp", "22", "--init", str(tmp_path / "init.msgpack"),
                    "--ckpt-dir", str(tmp_path / "qbd"), "--log", str(tmp_path / "qbd.csv"),
                    "--device", "cpu"])
    assert (tmp_path / "qbd.csv").exists()
    final = load_trained(tmp_path / "qbd" / "qbd_final.msgpack")
    assert final.keys() == init.keys()
    moved = final["q"]["conv_q1"]["kernel"] - init["q"]["conv_q1"]["kernel"]
    assert 0 < np.abs(moved).max() <= 2e-3 + 1e-6     # one Adam step of lr 1e-3


def test_train_bd_writes_checkpoints_the_predictor_loads(corpus, tmp_path):
    params, bd_rows, qbd_rows = train_bd.train_component(
        corpus, tmp_path, "Chroma", 22, bd_epochs=1, joint_epochs=1, batch=2,
        device="cpu", print_fn=lambda *_: None)
    assert len(bd_rows) == len(qbd_rows) == 1
    assert (tmp_path / "bdc_qp22_loss.csv").exists() and (tmp_path / "qbdc_qp22_loss.csv").exists()
    pred = CompPredictor.from_trained(False, tmp_path / "Chroma_Q_QP22.msgpack",
                                      tmp_path / "Chroma_BD_QP22.msgpack", device="cpu")
    for net, key in ((pred.q_net, "q"), (pred.bd_net, "bd")):
        assert all(torch.equal(v, params[key][k]) for k, v in net.state_dict().items())
    x = driver.load_npy_split(corpus, "Validate", "Chroma", 22)[0]
    qt, bt, dire = pred.predict(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    assert qt.shape == (2, 8, 8) and np.isfinite(bt).all() and np.isfinite(dire).all()
