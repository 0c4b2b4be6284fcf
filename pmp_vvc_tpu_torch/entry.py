"""The port's counterparts of the JAX package's driver hooks
(``__graft_entry__.py``).

- ``entry(device=None)``: the flagship forward on one device, the luma
  Q-net, the MSBD-net and the structural vote (K8) on a CTU batch; returns
  ``(fn, (example,))`` with the JAX function's shapes and draws (13-35):
  x (8, 68, 68, 1) from ``np.random.RandomState(0).uniform(0, 255)``, and
  ``fn(x) -> (voted qt (8, 8, 8, 1), bt (8, 16, 16, 3), dire (8, 16, 16,
  3))`` in the JAX package's NHWC layout.
- ``dryrun_multichip(mesh)``: one data-parallel joint training step
  (K12c) and the multi-device encodes on every rank of ``mesh``
  (``parallel/dryrun.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .parallel.dryrun import dryrun_multichip, luma_nets
from .pmp.predict import strict_fp32
from .pmp.structural import structural_vote

ENTRY_SHAPE = (8, 68, 68, 1)

__all__ = ["dryrun_multichip", "entry"]


def entry(device=None, params=None):
    """``(fn, (example,))`` on ``device`` (the card unless "cpu" is given);
    ``params`` ({"q": state dict, "bd": state dict}) replaces the nets'
    seeded initialisation."""
    dev = resolve_device(device)
    strict_fp32()
    q_net, bd_net = (net.eval() for net in luma_nets(params, dev))

    @torch.inference_mode()
    def fn(x: torch.Tensor):
        x = x.permute(0, 3, 1, 2).contiguous()
        qt_raw = q_net(x)
        bd = bd_net(x, qt_raw)
        bt = torch.cat([o[:, 0:1] for o in bd], 1).permute(0, 2, 3, 1)
        dire = torch.cat([o[:, 1:2] for o in bd], 1).permute(0, 2, 3, 1)
        return structural_vote(qt_raw.permute(0, 2, 3, 1).contiguous()), bt, dire

    example = torch.from_numpy(
        np.random.RandomState(0).uniform(0, 255, ENTRY_SHAPE).astype(np.float32)).to(dev)
    return fn, (example,)
