"""Weight bridge between flax msgpack checkpoints and PyTorch state dicts.

The trained checkpoints (``trained_models/bd/*.msgpack``) were written by
``flax.serialization.to_bytes``. The port reads and writes them with its own
msgpack coder (no ``msgpack`` or ``flax`` package needed) and renames the
flax param tree into a state dict and back: ``a/b/kernel`` (HWIO) <->
``a.b.weight`` (OIHW), ``a/b/bias`` <-> ``a.b.bias``. ``init_params`` draws
flax's default initialisation.
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# writing: the subset of msgpack that flax.serialization.to_bytes writes
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form when it fits, else the 8/16/32-bit one
    (``codes``; None where msgpack has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} items or bytes is too large")


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, bool) or obj is None:
        out.append(0xC0 if obj is None else 0xC2 + int(obj))
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        else:
            fmts = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
                    (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, 2 ** 64 - 1),
                    (0xD0, ">b", -128, 127), (0xD1, ">h", -2 ** 15, 2 ** 15 - 1),
                    (0xD2, ">i", -2 ** 31, 2 ** 31 - 1), (0xD3, ">q", -2 ** 63, 2 ** 63 - 1))
            code, fmt = next((c, f) for c, f, lo, hi in fmts
                             if (obj >= 0) == (lo == 0) and lo <= obj <= hi)
            out.append(code)
            out += struct.pack(fmt, obj)
    elif isinstance(obj, np.ndarray):
        payload = bytearray()
        _pack(payload, (tuple(int(d) for d in obj.shape), obj.dtype.name,
                        np.ascontiguousarray(obj).tobytes()))
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + (n.bit_length() - 1))
        else:
            _pack_len(out, n, None, -1, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as a flax checkpoint leaf")


def write_flax_msgpack(tree) -> bytes:
    """Encode a nested dict of numpy arrays as ``flax.serialization.to_bytes``
    does (keys in the dict's order)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def save_params(path, tree) -> None:
    """Write a flax param tree (nested dicts of numpy arrays, e.g. from
    ``params_to_jax``) as a msgpack checkpoint that the JAX package's
    ``models/checkpoint.py:load_params`` and this module's ``load_trained``
    read."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(write_flax_msgpack(tree))


def params_to_jax(state: dict) -> dict:
    """Torch state dict -> flax param tree (the inverse of ``params_from_jax``):
    ``a.b.weight`` (OIHW) -> ``a/b/kernel`` (HWIO), ``a.b.bias`` -> ``a/b/bias``,
    float32 numpy arrays on the host."""
    tree: dict = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
        elif leaf != "bias":
            raise ValueError(f"unexpected state dict key {key}")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"), a
# normal cut at +-2 whose scale is raised by this factor (the cut normal's
# standard deviation) so that the samples' variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(net: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Initialise ``net`` as flax initialises the JAX nets: every conv
    kernel from lecun_normal (a normal truncated at two standard deviations,
    variance 1 / fan_in, fan_in = in_channels * kh * kw), every bias zero.
    The distribution is flax's; the values come from ``generator``."""
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            fan_in = p[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            sample = torch.empty(p.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(sample, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.copy_(sample * std)
    return net
