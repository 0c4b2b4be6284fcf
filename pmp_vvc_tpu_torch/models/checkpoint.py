"""Weight bridge: flax msgpack checkpoints -> PyTorch state dicts.

The trained checkpoints (``trained_models/bd/*.msgpack``) were written by
``flax.serialization.to_bytes``. The port reads them with its own msgpack
decoder (no ``msgpack`` or ``flax`` package needed) and renames the flax
param tree into a state dict: ``a/b/kernel`` (HWIO) -> ``a.b.weight`` (OIHW),
``a/b/bias`` -> ``a.b.bias``.
"""
from __future__ import annotations

import pathlib
import struct

import numpy as np
import torch

# flax's ext code for ndarrays: payload is a msgpack array
# (shape, dtype_name, raw C-order bytes); see flax.serialization
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder for the msgpack subset flax writes: nil/bool, ints, floats,
    str, bin, arrays, maps and ext (ndarray / numpy scalar)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b in _FIXED:
            return self._unpack(_FIXED[b])
        if b in _LEN:
            kind, fmt = _LEN[b]
            n = self._unpack(fmt)
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(self._unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:                          # fixext 1/2/4/8/16
            return self._ext(self._unpack(">b"), 1 << (b - 0xD4))
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code: int, n: int):
        payload = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext code {code}")
        shape, dtype, raw = _Reader(payload).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
        0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
        0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
        0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def read_flax_msgpack(data: bytes):
    """Decode bytes written by ``flax.serialization.to_bytes``."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_trained(path) -> dict:
    """A flax msgpack checkpoint -> nested dict of numpy arrays."""
    return read_flax_msgpack(pathlib.Path(path).read_bytes())


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of numpy arrays) -> torch state dict."""
    state = {}

    def walk(node, prefix):
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + (name,))
            elif name == "kernel":
                state[".".join(prefix + ("weight",))] = torch.tensor(
                    np.ascontiguousarray(np.transpose(value, (3, 2, 0, 1))))
            elif name == "bias":
                state[".".join(prefix + ("bias",))] = torch.tensor(
                    np.array(value))
            else:
                raise ValueError(f"unexpected leaf {'/'.join(prefix + (name,))}")

    walk(tree, ())
    return state


def load_into(net: torch.nn.Module, path) -> torch.nn.Module:
    """Load a flax msgpack checkpoint into ``net`` (every key must match)."""
    net.load_state_dict(params_from_jax(load_trained(path)), strict=True)
    return net
