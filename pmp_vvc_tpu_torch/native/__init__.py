"""Native runtime components (C, built on demand with the system cc).

``cabac_finalize(ops, ctx_store)`` drives the C arithmetic-coder finalizer
(``native/cabac.c``) over a recorded bin-op stream and returns the
terminated slice payload (end_of_slice bit + finish + rbsp stop bit +
alignment), byte-exact against the Python ``BinEncoder``.

The library is built at first use into ``build/native/`` at the root of the
checkout, keyed by a hash of the source. A failed build or a failed
known-answer self-test raises: the encode path has no silent fallback. The
Python ``BinEncoder`` stays as the reference the self-test and the tests use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "cabac.c"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "native"


def build() -> pathlib.Path:
    """Compile ``cabac.c`` into ``build/native/``; returns the library path."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libcabac-{tag}.so"
    if out.exists():
        return out
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        raise RuntimeError("no C compiler (cc, gcc or clang) to build native/cabac.c")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, "-O2", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed on {_SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.cabac_run.restype = ctypes.c_long
    lib.cabac_run.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long]
    _self_test(lib)
    return lib


def _self_test(lib: ctypes.CDLL) -> None:
    """Known-answer check: a small randomized op stream must match the
    Python BinEncoder byte for byte, else the library is rejected."""
    import random

    from ..codec.cabac import ContextStore

    rng = random.Random(20260818)
    ops = []
    for _ in range(256):
        k = rng.randrange(4)
        if k == 0:
            ops.append(("b", rng.randrange(2), rng.randrange(300)))
        elif k == 1:
            ops.append(("ep", rng.randrange(2)))
        elif k == 2:
            n = rng.randrange(1, 12)
            ops.append(("eps", rng.randrange(1 << n), n))
        else:
            ops.append(("rem", rng.randrange(4000), rng.randrange(4), 5, 15))
    got = _run(lib, ops, ContextStore.standard_init(32, 2))
    if got != python_finalize(ops, ContextStore.standard_init(32, 2)):
        raise RuntimeError("native CABAC finalizer failed its self-test "
                           "against the Python BinEncoder")


def python_finalize(ops, ctx_store) -> bytes:
    """The reference: the same payload from the Python ``BinEncoder``."""
    from ..codec.cabac import BinEncoder

    enc = BinEncoder(ctx_store)
    for op in ops:
        k = op[0]
        if k == "b":
            enc.encode_bin(op[1], op[2])
        elif k == "ep":
            enc.encode_bin_ep(op[1])
        elif k == "eps":
            enc.encode_bins_ep(op[1], op[2])
        else:
            enc.encode_rem_abs_ep(op[1], op[2], op[3], op[4])
    enc.encode_bin_trm(1)          # end_of_slice_one_bit
    enc.finish()
    return enc.write_stop_bit_and_align()


def _run(lib: ctypes.CDLL, ops, ctx_store) -> bytes:
    n = len(ops)
    kind = np.empty(n, np.int8)
    a = np.empty(n, np.int64)
    b = np.zeros(n, np.int32)
    c = np.zeros(n, np.int32)
    d = np.zeros(n, np.int32)
    for i, op in enumerate(ops):
        t = op[0]
        if t == "b":
            kind[i] = 0
            a[i] = op[1]
            b[i] = op[2]
        elif t == "ep":
            kind[i] = 1
            a[i] = op[1]
        elif t == "eps":
            kind[i] = 2
            a[i] = op[1]
            b[i] = op[2]
        else:                       # "rem"
            kind[i] = 3
            a[i] = op[1]
            b[i] = op[2]
            c[i] = op[3]
            d[i] = op[4]
    s0 = np.asarray(ctx_store.state0, np.int32)
    s1 = np.asarray(ctx_store.state1, np.int32)
    rate = np.asarray(ctx_store.rate, np.int32)
    cap = 4 * n + 4096
    out = np.empty(cap, np.uint8)
    r = lib.cabac_run(
        kind.ctypes.data, a.ctypes.data, b.ctypes.data, c.ctypes.data,
        d.ctypes.data, n, s0.ctypes.data, s1.ctypes.data,
        rate.ctypes.data, out.ctypes.data, cap)
    if r < 0:
        raise RuntimeError(f"native CABAC finalizer failed (code {r})")
    return out[:r].tobytes()


def cabac_finalize(ops, ctx_store) -> bytes:
    """Run the native finalizer over ``RecordingEncoder`` ops.

    ``ctx_store``: a fresh ``codec.cabac.ContextStore`` (its state lists are
    consumed). Raises if the library cannot be built or fails its self-test.
    """
    return _run(_lib(), ops, ctx_store)
