"""The ctypes signatures of the port's kernel libraries against their C
entry points.

ctypes does not check an argument list against the C function: a pointer
declared as an int, or a parameter left out (the stream, passed last by
``_build.KernelLib.launch``), is cut or read from the wrong place only on
the card. Here each ``extern "C"`` function of each source in
``_build.SOURCES`` is read from the text and its parameter and return
types are held to the ``argtypes``/``restype`` its wrapper declares.
"""

import ctypes
import re

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.carousel_update import ops as cu_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.lane_tick import ops as lt_ops
from repro_torch.kernels.mamba_scan import ops as ms_ops

LIBS = (lt_ops._LIB, cu_ops._LIB, fa_ops._SIMT, fa_ops._WGMMA, ms_ops._LIB)

_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float, "const char*": ctypes.c_char_p}


def _ctype(decl: str, named: bool = True):
    """The ctypes type of one C declaration (a parameter with its name, or
    a return type, ``named=False``): every pointer but ``const char*`` is
    ``c_void_p``."""
    decl = re.sub(r"\s+", " ", decl.strip())
    decl = re.sub(r"\s*\*\s*", "* ", decl).strip()
    if decl.startswith("const char*") and decl.count("*") == 1:
        return ctypes.c_char_p
    if "*" in decl:
        return ctypes.c_void_p
    return _C_TYPES[re.sub(r"\s*\w+$", "", decl) if named else decl]


def c_entry_points(source: str):
    """``{name: (param ctypes, return ctype)}`` of the functions defined in
    the ``extern "C"`` block of ``source``."""
    text = (_build._KERNELS_DIR / source).read_text()
    block = text[text.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^(int|long long|const char\*)\s+(\w+)\(([^)]*)\)"
                         r"\s*\{", block, re.M):
        ret, name, params = m.groups()
        params = [p for p in params.split(",") if p.strip()]
        out[name] = ([_ctype(p) for p in params], _ctype(ret, named=False))
    return out


@pytest.mark.parametrize("lib", LIBS, ids=lambda lib: lib.name)
def test_ctypes_signatures_match_the_c_entry_points(lib):
    entry = c_entry_points(_build.SOURCES[lib.name])
    for fn, (argtypes, restype) in lib.signatures.items():
        assert fn in entry, f"{lib.name}: no C entry point {fn}"
        params, ret = entry[fn]
        assert list(argtypes) == params, f"{lib.name}.{fn}: parameters"
        assert restype == ret, f"{lib.name}.{fn}: return type"


def test_parser_reads_pointers_sizes_and_the_stream():
    params, ret = c_entry_points(_build.SOURCES["lane_tick"])["lt_gcs_admit"]
    assert ret is ctypes.c_int
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert params == [P] * 6 + [I, LL, LL, I, I] + [P] * 6
