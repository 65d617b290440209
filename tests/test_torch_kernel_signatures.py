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
from repro_torch.kernels.tick_glue import ops as tg_ops
from repro_torch.kernels.trace_tick import ops as trk_ops

LIBS = (lt_ops._LIB, cu_ops._LIB, fa_ops._WGMMA, fa_ops._TF32X3,
        ms_ops._LIB, tg_ops._LIB, trk_ops._LIB)

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


def test_every_library_is_checked():
    """Each source of ``_build.SOURCES`` has its signatures checked here,
    and each of its C entry points is declared to ctypes."""
    assert {lib.name for lib in LIBS} == set(_build.SOURCES)
    for lib in LIBS:
        assert set(c_entry_points(_build.SOURCES[lib.name])) == \
            set(lib.signatures), lib.name


def test_glue_entry_points_are_declared():
    """The glue kernels' C entry points: the state pointers after the
    sizes, the stream last."""
    entry = c_entry_points(_build.SOURCES["tick_glue"])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert entry["tg_begin"] == ([P] * 4 + [I, I, LL] + [P] * 3, I)
    assert entry["tg_complete"] == ([P] * 10 + [I, I, LL] + [P] * 16, I)
    assert entry["tg_work_ints"] == ([I, I], LL)


def test_glue_scratch_and_wait_select_entry_points_are_declared():
    """The wait-queue selection (the planes, the sizes with ``W`` and the
    blocks a row after F, the scratch, both outputs, ``work`` and the
    stream) and the two scratch sizes (the selection's with the blocks a
    row too), as their wrappers declare them."""
    entry = c_entry_points(_build.SOURCES["tick_glue"])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert entry["tg_wait_select"] == ([P] * 2 + [I, I, LL, I, I] + [P] * 5,
                                       I)
    assert entry["tg_complete_scratch"] == ([I, I, LL], LL)
    assert entry["tg_wait_scratch"] == ([I, I, LL, I, I], LL)
    for fn in ("tg_wait_select", "tg_complete_scratch", "tg_wait_scratch",
               "tg_complete", "tg_work_ints"):
        assert tg_ops._SIGNATURES[fn] == entry[fn]


def test_trace_entry_points_are_declared():
    """The tick trace's two C entry points: the stamp (the accumulator and
    its row), and the counter (the tick counter, the stride as a 64-bit
    int, the two flag planes, the sizes with the blocks a lane after F,
    the five count sources, the counts), the stream last."""
    entry = c_entry_points(_build.SOURCES["trace_tick"])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert entry["trk_stamp"] == ([P, I, P], I)
    assert entry["trk_count"] == ([P, LL, P, P, I, I, LL, I] + [P] * 7, I)
    for fn in ("trk_stamp", "trk_count"):
        assert trk_ops._SIGNATURES[fn] == entry[fn]


def test_build_adds_the_libraries_built_with_a_library(monkeypatch,
                                                      tmp_path):
    """Building a tick library builds the tick's tracing with it, once,
    whichever of the two names it: ``build`` expands its names through
    ``BUILT_WITH`` (here every library is already built, so nothing is
    compiled)."""
    def built(name):
        path = tmp_path / f"{name}.so"
        path.touch()
        return path

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", built)
    assert _build.build(["lane_tick", "tick_glue"]) == {
        "lane_tick": 0.0, "tick_glue": 0.0, "trace_tick": 0.0}
    assert set(_build.build(["mamba_scan"])) == {"mamba_scan"}


def test_engine_entry_points_are_declared():
    """The tick engine's two C entry points: the start's count and the
    tick, whose tick count is a 64-bit int between the sizes and the
    state pointers."""
    entry = c_entry_points(_build.SOURCES["carousel_update"])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert entry["cu_engine_count"] == ([P, P, LL, I, P, P], I)
    assert entry["cu_engine_tick"] == (
        [P] * 6 + [ctypes.c_float, LL, I, LL] + [P] * 5, I)
    assert entry["cu_engine_blocks"] == ([LL], I)
    for fn in ("cu_engine_count", "cu_engine_tick", "cu_engine_max_links",
               "cu_engine_blocks"):
        assert cu_ops._SIGNATURES[fn] == entry[fn]


def test_wgmma_entry_points_are_declared():
    """The bf16 kernel's entry points keep their signatures with both
    loaders behind them: the forward's four pointers, eight ints (hd among
    them) and the scale, then the stream; the probe's five pointers, its
    width and the stream."""
    entry = c_entry_points(_build.SOURCES["flash_attention_wgmma"])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert entry["fa_wgmma_forward"] == ([P] * 4 + [I] * 8 + [F, P], I)
    assert entry["fa_wgmma_tile_check"] == ([P] * 5 + [I, P], I)
    for fn in ("fa_wgmma_forward", "fa_wgmma_tile_check"):
        assert fa_ops._WGMMA_SIGNATURES[fn] == entry[fn]


def test_scan_entry_point_is_declared():
    """The scan's entry point: dA, dBu, C and y, the four sizes, the
    launch geometry (warps a block, steps a ring stage), then the final
    state's pointer (null: none written) and the stream."""
    entry = c_entry_points(_build.SOURCES["mamba_scan"])
    P, I = ctypes.c_void_p, ctypes.c_int
    assert entry["ms_scan"] == ([P] * 4 + [I] * 6 + [P, P], I)
    assert ms_ops._SIGNATURES["ms_scan"] == entry["ms_scan"]


def test_selective_scan_entry_point_is_declared():
    """The fused entry: u, dt, A, B, C and y, the four sizes, B's and C's
    batch and row strides (64-bit), the bf16 flag and the launch geometry,
    then the final state's pointer and the stream."""
    entry = c_entry_points(_build.SOURCES["mamba_scan"])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert entry["ms_selective_scan"] == (
        [P] * 6 + [I] * 4 + [LL] * 4 + [I] * 3 + [P, P], I)
    assert ms_ops._SIGNATURES["ms_selective_scan"] == \
        entry["ms_selective_scan"]
