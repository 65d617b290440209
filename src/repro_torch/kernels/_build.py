"""Build and load the port's CUDA kernels (plain C entry points + ctypes).

Each kernel library is one ``.cu`` source under ``repro_torch/kernels``,
compiled by ``nvcc`` for Hopper on first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [<extra flags>] -o <lib>.so <source>.cu

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
    "carousel_update": "carousel_update/csrc/carousel_update.cu",
    "flash_attention_wgmma": "flash_attention/csrc/flash_attention_wgmma.cu",
    "flash_attention_tf32x3":
        "flash_attention/csrc/flash_attention_tf32x3.cu",
    "mamba_scan": "mamba_scan/csrc/mamba_scan.cu",
    "tick_glue": "tick_glue/csrc/tick_glue.cu",
    "trace_tick": "trace_tick/csrc/trace_tick.cu",
}

#: Libraries built together with a library, wherever it is built: the
#: tick's tracing with the tick's kernels, so a traced loop finds it built
#: (loading it is left to the first traced loop).
BUILT_WITH: Dict[str, tuple] = {
    "lane_tick": ("trace_tick",),
    "tick_glue": ("trace_tick",),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Flags of one library beside ``NVCC_FLAGS``: ``-split-compile=0`` runs
#: the optimiser on all the host's cores, for the source with one kernel
#: instance per head width.
EXTRA_FLAGS: Dict[str, tuple] = {
    "flash_attention_tf32x3": ("-split-compile=0",),
}


def nvcc_flags(name: str) -> tuple:
    """The compiler flags of library ``name``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


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
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every library in ``names`` (default: all) and the libraries
    :data:`BUILT_WITH` them that are not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took (0.0
    for a library already built). Raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    for name in list(names):
        names += [w for w in BUILT_WITH.get(name, ()) if w not in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp),
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


def _template_args(mangled: str, i: int):
    """The template arguments that start at ``mangled[i]`` (an ``I``), as
    text: integer literals (``Li128E``), builtin types by their one-letter
    code and named types (``13__nv_bfloat16``); ``None`` where there are
    none or they take another form."""
    if mangled[i:i + 1] != "I":
        return None
    args, i = [], i + 1
    while i < len(mangled) and mangled[i] != "E":
        m = (re.match(r"L[a-z](\d+)E", mangled[i:])
             or re.match(r"(\d+)", mangled[i:]))
        if m is None:
            args.append(mangled[i])  # a builtin type: f, i, ...
            i += 1
        elif mangled[i] == "L":
            args.append(m.group(1))
            i += m.end()
        else:
            n = int(m.group(1))
            args.append(mangled[i + m.end():i + m.end() + n])
            i += m.end() + n
    return ",".join(args) if i < len(mangled) else None


def _kernel_name(mangled: str) -> str:
    """The last name of a mangled kernel's nested name, with its template
    arguments: ``wa_kernel`` from
    ``_ZN45_GLOBAL__N__<hash>_12_lane_tick_cu_<hash>9wa_kernelE...`` or
    from ``_Z9wa_kernel...``, ``fa_kernel<f>`` from ``...9fa_kernelIfEEv...``;
    else the name as given."""
    m = re.match(r"_Z(N?)", mangled)
    name, i = mangled, m.end() if m else len(mangled)
    while m:
        d = re.match(r"\d+", mangled[i:])
        if d is None:
            break
        i += d.end()
        name = mangled[i:i + int(d.group())]
        i += int(d.group())
        args = _template_args(mangled, i)
        if args is not None:
            return f"{name}<{args}>"
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


def ptxas_warnings(name: str) -> list:
    """The compiler's warnings in the build log of library ``name`` (for
    example ``setmaxnreg`` ignored, or wgmma serialised)."""
    log = library_path(name).with_suffix(".log").read_text()
    return [line.strip() for line in log.splitlines()
            if "warning" in line.lower()]


def sass(name: str) -> str:
    """The SASS of library ``name`` (built first if needed), as the
    toolkit's ``cuobjdump -sass`` prints it (beside ``nvcc``)."""
    build([name])
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def sass_functions(text: str) -> Dict[str, list]:
    """``{kernel: [(address, opcode) or label]}`` of ``cuobjdump -sass``
    output: each ``Function :`` section's instructions in order (the opcode
    with its modifiers, the predicate dropped; a branch's target kept as
    ``"BRA <target>"``) and its labels (``.L_x_<n>``), under the kernel's
    name as :func:`_kernel_name` gives it."""
    funcs: Dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = funcs.setdefault(_kernel_name(m.group(1)), [])
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            cur.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m:
            ins = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            op = ins.split()[0] if ins else ""
            if op.startswith("BRA"):
                t = re.search(r"(\.L_x_\d+|0x[0-9a-f]+)", ins)
                op = f"BRA {t.group(1) if t else ''}"
            cur.append((int(m.group(1), 16), op))
    return funcs


def hot_loop(code: list, marker: str) -> Dict[str, int]:
    """Opcode counts of the innermost loop of ``code``
    (:func:`sass_functions`' list) that holds the most ``marker``
    instructions: a loop is the instructions from a backward branch's
    target to the branch, and an innermost one holds no other loop that
    holds ``marker``. Empty where no loop holds ``marker``."""
    where: Dict[str, int] = {}
    ins = []
    for item in code:
        if isinstance(item, str):
            where[item] = len(ins)
        else:
            where[f"0x{item[0]:x}"] = len(ins)
            ins.append(item[1])
    loops = []
    for i, op in enumerate(ins):
        if not op.startswith("BRA "):
            continue
        key = op[4:]
        if key.startswith("0x"):
            key = f"0x{int(key, 16):x}"
        j = where.get(key)
        if j is not None and j <= i and marker in ins[j:i + 1]:
            loops.append((j, i))
    inner = [(j, i) for j, i in loops
             if not any((j, i) != (a, b) and j <= a and b <= i
                        for a, b in loops)]
    best = max(inner, key=lambda r: (ins[r[0]:r[1] + 1].count(marker),
                                     r[0] - r[1]), default=None)
    counts: Dict[str, int] = {}
    for op in ins[best[0]:best[1] + 1] if best else ():
        counts[op] = counts.get(op, 0) + 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (with the
    libraries :data:`BUILT_WITH` it)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


class KernelLib:
    """One kernel library with its C entry points typed, loaded (and built)
    at its first :meth:`get`, and the launch count of each of its kernels.

    ``signatures`` maps each entry point to ``(argtypes, restype)``:
    pointers and the stream as ``c_void_p``, or ctypes would pass them as
    32-bit ints and cut them. ``error_fn`` names the library's
    ``cudaGetErrorString`` wrapper, which :meth:`launch` reports with.
    ``kernels`` names the wrappers whose launches are counted."""

    def __init__(self, name: str, signatures, error_fn: str,
                 kernels: Iterable[str]):
        self.name, self.signatures, self.error_fn = name, signatures, error_fn
        self.launches: Dict[str, int] = {k: 0 for k in kernels}
        self._lib: Optional[ctypes.CDLL] = None

    def launch_counts(self) -> Dict[str, int]:
        """Kernel launches per wrapper since the last reset (a call that
        went to the plain version does not count)."""
        return dict(self.launches)

    def reset_launch_counts(self) -> None:
        for k in self.launches:
            self.launches[k] = 0

    def add_launch_counts(self, counts: Dict[str, int], times: int) -> None:
        """Add ``counts`` ``times`` over: the launches of a CUDA graph's
        replays, which run no wrapper (``times`` is -1 for the capture,
        whose wrappers counted launches that did not run)."""
        for k, n in counts.items():
            self.launches[k] += n * times

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.name)
            for fn, (argtypes, restype) in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            self._lib = lib
        return self._lib

    def launch(self, kernel, fn: str, device, *args) -> None:
        """Call entry point ``fn`` with ``args`` and the current stream of
        ``device`` last; raise if it returns a CUDA error code, else count
        one launch of ``kernel`` (a name, or a tuple of names, each
        counted: a kernel and the variant of it that ran)."""
        import torch

        entry = getattr(self.get(), fn)
        if len(args) + 1 != len(entry.argtypes):  # ctypes would not check
            raise TypeError(f"{fn}: {len(args)} arguments and the stream "
                            f"for {len(entry.argtypes)} parameters")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = entry(*args, stream)
        if rc != 0:
            msg = getattr(self.get(), self.error_fn)(rc).decode()
            raise RuntimeError(f"{fn}: CUDA error {rc}: {msg}")
        for k in (kernel,) if isinstance(kernel, str) else kernel:
            self.launches[k] += 1


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``, and ``RuntimeError`` (:func:`refuse_grad`)
    if it requires grad under grad mode."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    refuse_grad(name, t)


def refuse_grad(name: str, t) -> None:
    """Raise ``RuntimeError`` if ``t`` requires grad while grad mode is on.
    A kernel writes its outputs through raw pointers, so they would leave
    with no ``grad_fn`` and autograd would pass around the kernel without
    a word; the entries that have a backward (``flash_attention``,
    ``selective_scan``) launch inside ``kernels.autograd.PlainBackward``,
    whose forward runs with grad mode off."""
    import torch

    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name} requires grad, and this kernel has no backward: call "
            f"it under torch.no_grad() or on detached inputs, or use the "
            f"plain version (impl='torch')")
