"""Rank processes for the port's multi-device tests on the CPU.

``Ranks(tmp, world, code, **kwargs)`` starts ``world`` processes that each
bring up gloo from a ``file://`` store under ``tmp`` (so no port races
under xdist), build the mesh (``device="cpu"``: the kernels' plain
versions), run the job's ``run(mesh, **kwargs)`` from ``code`` and pickle
its result; ``results()`` waits for them. ``same_on_every_rank`` holds
every rank's result of one key to rank 0's.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 300          # seconds for a rank process, imports included

# One rank: bring up gloo from the store, build the mesh, run the job's
# ``run(mesh, **kwargs)`` and pickle its result.
_RANK = '''
import pickle, sys, torch
torch.set_num_threads(2)
from pmp_vvc_tpu_torch.parallel import initialize, make_mesh, shutdown
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
initialize(f"file://{tmp}/store", world, rank, device="cpu")
job = pickle.load(open(f"{tmp}/job.pkl", "rb"))
ns = {}
exec(job["code"], ns)
out = ns["run"](make_mesh(device="cpu"), **job["kwargs"])
pickle.dump(out, open(f"{tmp}/rank{rank}.pkl", "wb"))
shutdown()
'''


class Ranks:
    """``world`` rank processes running one job; ``results()`` waits for
    them (each within RANK_TIMEOUT) and returns each rank's result. A rank
    that fails or times out fails the test, and every rank is killed."""

    def __init__(self, tmp: pathlib.Path, world: int, code: str, **kwargs):
        tmp.mkdir(parents=True, exist_ok=True)
        with open(tmp / "job.pkl", "wb") as f:
            pickle.dump({"code": code, "kwargs": kwargs}, f)
        env = dict(os.environ, PYTHONPATH=str(REPO))
        self.tmp, self.world = tmp, world
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK, str(r), str(world), str(tmp)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self._out = None

    def results(self) -> list:
        if self._out is None:
            try:
                logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    p.kill()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} of {self.world} failed:\n{log[-4000:]}"
            self._out = [pickle.load(open(self.tmp / f"rank{r}.pkl", "rb"))
                         for r in range(self.world)]
        return self._out


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


def same_on_every_rank(outs, key):
    """Rank 0's ``key`` result, after holding every rank's to it."""
    for r, o in enumerate(outs[1:], 1):
        assert _equal(o[key], outs[0][key]), f"rank {r}'s {key} differs from rank 0's"
    return outs[0][key]
