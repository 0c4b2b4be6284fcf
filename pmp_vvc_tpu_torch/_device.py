"""Device resolution for the port's entry points.

``device=None`` means the card. Without CUDA that raises: the port never
falls back to the CPU on its own. Callers that want the CPU (the tests) say
so with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
