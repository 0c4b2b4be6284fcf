"""Build and bind the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by ``nvcc``
into its own shared library for ``sm_90a``, loaded with ``ctypes``; sources
may include the shared ``csrc/*.cuh`` headers. Nothing is built when a
module is imported: ``library(name)`` builds at first use into
``build/kernels/`` at the root of the checkout, keyed by a hash of the
source, the headers and the flags, so an unchanged source is not compiled
twice.
``build_all()`` compiles every source at once, one ``nvcc`` process each.
``bind`` gives a library's entry points the argument types of the wrapper
module's ``SIGNATURES`` table ({library: {function: ctypes argument
types}}; ``tests/test_torch_kernel_signatures.py`` holds every table to the
``extern "C"`` prototypes of ``csrc/*.cu``). ``check_cuda``, ``stream`` and
``count_launch`` are what every kernel wrapper does around its call.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu``; returns (library path, nvcc's output).

    The output is empty when an up-to-date library was already there.
    """
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` in parallel; {name: nvcc output}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        logs = list(pool.map(build, names))
    return {n: log for n, (_, log) in zip(names, logs)}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    return ctypes.CDLL(str(build(name)[0]))


# ctypes kinds of the entry points' C arguments: a pointer (a tensor's
# data_ptr() or the stream), an int, an int64_t, a float
PTR, INT, INT64, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """The library ``name`` with each function of ``signatures``
    ({function: argument types}) given those types and an int result."""
    lib = library(name)
    for fn, args in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(args)
        f.restype = ctypes.c_int
    return lib


def check_cuda(name: str, *tensors) -> None:
    """Every tensor given (None skipped) must be contiguous on the card."""
    for t in tensors:
        if t is not None and (t.device.type != "cuda" or not t.is_contiguous()):
            raise ValueError(f"{name} takes contiguous tensors on the card, "
                             f"got one on {t.device}")


def stream(t) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def count_launch(wrapper, err: int) -> None:
    """Raise on a launch's CUDA error, else count it on ``wrapper.launches``."""
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
