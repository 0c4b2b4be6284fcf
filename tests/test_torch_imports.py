"""The PyTorch port imports nothing of JAX and nothing of the JAX package."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pmp_vvc_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]

# Shared by the subprocess below and by test_blocker_spares_the_port.
_BLOCKER = '''
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "pmp_vvc_tpu")

def blocked(name):
    return name.split(".")[0] in BLOCKED

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ModuleNotFoundError(f"blocked import: {name}")
        return None
'''

_IMPORT_ALL = _BLOCKER + '''
sys.meta_path.insert(0, Blocker())
import importlib, pkgutil
import pmp_vvc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pmp_vvc_tpu_torch.__path__,
                                               "pmp_vvc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print(" ".join(names))
'''

# the training slice's modules, which the walk must import under the blocker
TRAIN_MODULES = {
    "pmp_vvc_tpu_torch." + m for m in (
        "train", "train.losses", "train.trainer", "train.driver", "cli", "cli.train",
        "tools", "tools.gen_dataset", "tools.train_bd", "data.labels", "data.sequences",
        "ops.train_generic")}
# the sequential encoder's slice: its new modules (the K10 wrappers live in
# ops.intra, ops.mip, ops.quant and ops.distortion, which the walk imports)
SEQ_MODULES = {
    "pmp_vvc_tpu_torch." + m for m in (
        "codec.estimator", "codec.encoder", "ops.depquant", "ops.lfnst", "ops.cclm",
        "ops.intra", "ops.mip", "ops.quant", "ops.distortion", "ops.transforms",
        "cli.encode", "utils", "utils.vtmcfg", "utils.visualize", "utils.stats")}
# the multi-device encoding slice's modules
PARALLEL_MODULES = {
    "pmp_vvc_tpu_torch." + m for m in (
        "parallel", "parallel.distributed", "parallel.wavefront_dp", "parallel.comm",
        "parallel.spatial", "parallel.dryrun")}

# the data-parallel CNN slice's new modules (K12c)
DP_MODULES = {"pmp_vvc_tpu_torch." + m for m in ("ops.dp_generic", "entry")}


def _blocker_namespace():
    ns = {}
    exec(_BLOCKER, ns)
    return ns


def test_blocker_spares_the_port():
    blocked = _blocker_namespace()["blocked"]
    assert blocked("pmp_vvc_tpu") and blocked("pmp_vvc_tpu.models.qbd")
    assert blocked("jax.numpy") and blocked("flax") and blocked("optax")
    assert not blocked("pmp_vvc_tpu_torch")
    assert not blocked("pmp_vvc_tpu_torch.pmp.structural")


def test_port_imports_every_module_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = set(proc.stdout.split())
    # data, models, pmp, codec, ops, native, train, cli, tools, utils,
    # parallel and their modules, _build, _device, entry: 46 before the
    # training slice, 58 with it, 64 with the sequential encoder's, 70 with
    # parallel, 72 with the data-parallel CNN's
    assert TRAIN_MODULES <= names and SEQ_MODULES <= names and PARALLEL_MODULES <= names
    assert DP_MODULES <= names
    assert len(names) >= 72


def test_rdo_modules_are_scanned():
    """The device RDO's modules are among the sources scanned above."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"pmp_vvc_tpu_torch/codec/rdo_device.py",
            "pmp_vvc_tpu_torch/ops/rdo_generic.py"} <= names


def test_seq_modules_are_scanned():
    """The sequential encoder's sources are among those scanned below."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    want = {m.replace(".", "/") for m in SEQ_MODULES}
    assert {w + ".py" if w + ".py" in names else w + "/__init__.py" for w in want} <= names


def test_parallel_modules_are_scanned():
    """The multi-device slice's sources are among those scanned below."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    want = {m.replace(".", "/") for m in PARALLEL_MODULES}
    assert {w + ".py" if w + ".py" in names else w + "/__init__.py" for w in want} <= names


def test_dp_modules_are_scanned():
    """The data-parallel CNN slice's sources are among those scanned below."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {m.replace(".", "/") + ".py" for m in DP_MODULES} <= names


def test_train_modules_are_scanned():
    """The training slice's sources are among those scanned below."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    want = {m.replace(".", "/") for m in TRAIN_MODULES}
    assert {w + ".py" if w + ".py" in names else w + "/__init__.py" for w in want} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_source_names_no_blocked_module(path):
    blocked = _blocker_namespace()["blocked"]
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if blocked(n)]
