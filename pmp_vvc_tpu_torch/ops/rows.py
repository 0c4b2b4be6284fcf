"""Schedule rows of the wave step.

A row is (frame, x, y, w, h, order id, live, flags) in luma units, int32;
one step of a tile class is a (B, 8) tensor of them, padding rows having
live == 0.
"""
from __future__ import annotations

import torch


def check_rows(rows: torch.Tensor) -> None:
    if rows.dtype != torch.int32 or rows.ndim != 2 or rows.shape[1] != 8:
        raise ValueError(f"schedule rows must be (B, 8) int32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")


def unpack_rows(rows: torch.Tensor, scale: int):
    """(fi, x, y, w, h, oi, live) of each row, coordinates in the plane of
    ``scale`` (1 luma, 2 chroma), ``live`` boolean."""
    fi, xs, ys, ws, hs, oi, okv = (rows[:, k] for k in range(7))
    return fi, xs // scale, ys // scale, ws // scale, hs // scale, oi, okv > 0
