"""Build and load the port's CUDA kernels (plain C entry points + ctypes).

Each kernel library is one ``.cu`` source under ``repro_torch/kernels``,
compiled by ``nvcc`` for Hopper on first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

into ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), under a name keyed by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is loaded as is. The
compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<lib>.log``. Nothing here runs at import:
``nvcc`` is looked up and started only when a library is first needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_KERNELS_DIR = Path(__file__).resolve().parent

#: Kernel libraries of the port: name -> source, relative to this package.
SOURCES: Dict[str, str] = {
    "lane_tick": "lane_tick/csrc/lane_tick.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Build outputs: ``build/repro_torch`` at the root of the checkout
#: (``src/repro_torch/kernels`` is three levels below it).
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch"

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc`` (as PyTorch resolves
    ``CUDA_HOME``), else the one on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where library ``name`` is built: keyed by a hash of its source and
    the compiler flags."""
    src = _KERNELS_DIR / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` per source, all started together. Returns the
    seconds each build took (0.0 for a library already built). Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_KERNELS_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return seconds


def _kernel_name(mangled: str) -> str:
    """The last name of a mangled kernel's nested name: ``wa_kernel`` from
    ``_ZN45_GLOBAL__N__<hash>_12_lane_tick_cu_<hash>9wa_kernelE...`` or
    from ``_Z9wa_kernel...``; else the name as given."""
    m = re.match(r"_Z(N?)", mangled)
    name, i = mangled, m.end() if m else len(mangled)
    while m:
        d = re.match(r"\d+", mangled[i:])
        if d is None:
            break
        i += d.end()
        name = mangled[i:i + int(d.group())]
        i += int(d.group())
        if not m.group(1):  # not nested: one name only
            break
    return name


def ptxas_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel of library ``name``, read
    from the ``-Xptxas -v`` log kept beside its build:
    ``{kernel: {"registers", "spill_stores", "spill_loads"}}``."""
    usage: Dict[str, Dict[str, int]] = {}
    cur = None
    log = library_path(name).with_suffix(".log").read_text()
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = usage.setdefault(_kernel_name(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
