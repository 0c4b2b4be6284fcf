"""Every CUDA entry point's ctypes binding matches its C prototype.

Each wrapper module declares its kernels' argument types in a module-level
``SIGNATURES`` table ({library: {function: ctypes types}}) that its
``_lib`` applies through ``_build.bind``. Here every ``extern "C"`` prototype
of ``pmp_vvc_tpu_torch/csrc/*.cu`` is parsed and held to its table entry:
the same number of arguments, each of the same kind (a pointer — a tensor,
a pointer table or the stream — an int, an int64_t or a float), and the
table names no function that its library's source lacks. A binding with
too few arguments passes garbage to the kernel on the card; nothing on the
CPU would notice otherwise.
"""
import ctypes
import importlib
import pathlib
import re

import pytest

from pmp_vvc_tpu_torch import _build

CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
WRAPPERS = ("codec.wavefront", "ops.cclm_generic", "ops.distortion", "ops.dp_generic",
            "ops.intra", "ops.intra_generic", "ops.mip", "ops.mip_generic", "ops.quant",
            "ops.rdo_generic", "ops.tq_generic", "ops.train_generic", "parallel.spatial",
            "pmp.structural")
_PROTO = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _kind(arg: str) -> type:
    """The ctypes kind of one C parameter declaration."""
    decl = " ".join(arg.split())
    if "*" in decl or "cudaStream_t" in decl:
        return ctypes.c_void_p
    if "int64_t" in decl:
        return ctypes.c_int64
    if re.match(r"^(const\s+)?float\s+\w+$", decl):
        return ctypes.c_float
    if re.match(r"^(const\s+)?int\s+\w+$", decl):
        return ctypes.c_int
    raise ValueError(f"unknown C parameter kind: {decl!r}")


def _prototypes() -> dict:
    """{(library, function): [kinds]} of every csrc/*.cu entry point."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, args in _PROTO.findall(src.read_text()):
            out[(src.stem, name)] = [_kind(a) for a in args.split(",") if a.strip()]
    return out


def _tables() -> dict:
    """{(library, function): [ctypes types]} from every wrapper module."""
    out = {}
    for mod in WRAPPERS:
        table = importlib.import_module(f"pmp_vvc_tpu_torch.{mod}").SIGNATURES
        for lib, fns in table.items():
            for fn, types in fns.items():
                assert (lib, fn) not in out, f"{lib}.{fn} declared twice"
                out[(lib, fn)] = list(types)
    return out


PROTOS = _prototypes()


def test_every_source_has_an_entry_point():
    assert {lib for lib, _ in PROTOS} == {p.stem for p in CSRC.glob("*.cu")}
    assert len(PROTOS) >= 20 and {("halo", "pmp_halo_pack"), ("halo", "pmp_halo_unpack"),
                                  ("grad_bucket", "pmp_bucket_pack")} <= set(PROTOS)


def test_tables_name_only_real_entry_points():
    assert set(_tables()) == set(PROTOS)


@pytest.mark.parametrize("key", sorted(PROTOS), ids=[f"{a}.{b}" for a, b in sorted(PROTOS)])
def test_binding_matches_prototype(key):
    want = PROTOS[key]
    got = _tables()[key]
    assert len(got) == len(want), f"{key}: {len(got)} bound, {len(want)} in C"
    assert got == want, f"{key}: bound {got}, prototype {want}"


def test_kind_parser():
    assert _kind("const int32_t* __restrict__ x") is ctypes.c_void_p
    assert _kind("float* const* p") is ctypes.c_void_p
    assert _kind("cudaStream_t stream") is ctypes.c_void_p
    assert _kind("int64_t n") is ctypes.c_int64
    assert _kind("float lam") is ctypes.c_float
    assert _kind("int B") is ctypes.c_int


def test_bind_applies_the_table(monkeypatch):
    """``_build.bind`` sets each listed function's argument types and an int
    result on the library it loads."""
    class Fn:
        argtypes = restype = None

    class Lib:
        pmp_a, pmp_b = Fn(), Fn()

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    lib = _build.bind("x", {"pmp_a": (_build.PTR, _build.INT), "pmp_b": (_build.FLOAT,)})
    assert lib.pmp_a.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert lib.pmp_b.argtypes == [ctypes.c_float]
    assert lib.pmp_a.restype is ctypes.c_int and lib.pmp_b.restype is ctypes.c_int
