"""The traced run's reading of the device: one whole sweep call under
``torch.profiler``, reduced to device intervals, per-tick times by kernel
library, the idle share and the breakdown the result line carries.

A replayed tick is one launch of the captured tick's CUDA graph: the
device operations that carry the correlation id of a ``cudaGraphLaunch``
call on the host are that replay's, and its wall time runs from the start
of its first operation to the start of the next replay's. A device
operation is counted to the port's kernel library that holds it, as the
port's build lists them (``repro_torch.kernels._build``: each library's
source and the kernels the compiler built from it), and every other one
(PyTorch's launches, copies and fills) to ``other``. Neither depends on
what a kernel is called.
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

CALL_SPAN = "portbench.call"
GRAPH_LAUNCH = "cudaGraphLaunch"
OTHER = "other"


def kernel_id(name: str) -> str:
    """A device operation's own identifier in the profiler's name:
    ``tt_count_kernel`` from ``tt_count_kernel(float const*, ...)``,
    ``wa_fused_kernel`` from ``(anonymous namespace)::wa_fused_kernel(...)``,
    ``tg_wait_select_kernel`` from ``void tg_wait_select_kernel<4>(...)``,
    ``Memcpy`` from ``Memcpy DtoD (Device -> Device)``."""
    s = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    m = re.match(r"[\w:]+", s)
    return m.group(0).rsplit("::", 1)[-1] if m else name


def port_kernels() -> Dict[str, str]:
    """``{kernel identifier: library}`` of every built kernel library of
    the port, from the kernels the compiler reported for it (the build's
    log beside the library); a library not built ran nothing."""
    from repro_torch.kernels import _build

    out: Dict[str, str] = {}
    for lib in _build.SOURCES:
        try:
            kernels = _build.ptxas_usage(lib)
        except OSError:
            continue
        for k in kernels:
            out[k.split("<", 1)[0]] = lib
    return out


@contextmanager
def profiled_call(store: Dict):
    """Profile the wrapped call: CPU and CUDA activity, the call marked by
    a :data:`CALL_SPAN` range; the host's ``perf_counter`` at its start is
    kept to place the program's own spans on the profiler's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        host_ns = time.perf_counter_ns()
        with record_function(CALL_SPAN):
            yield
        torch.cuda.synchronize()
    store["prof"] = prof
    store["host_ns"] = host_ns


def reduce(prof, host_ns: int) -> Dict:
    """The profiled call's device events: ``kernels`` (name, start, end
    in ns, sorted by start), ``replays`` (for each launch of a CUDA graph,
    in launch order, the indices in ``kernels`` of its operations), the
    call's ``window`` and ``offset_ns``, the profiler's clock less the
    host's ``perf_counter``."""
    call = None
    raw: List[Tuple[str, int, int, int]] = []
    launches: List[Tuple[int, int]] = []
    for e in prof.profiler.kineto_results.events():
        on_device = "CUDA" in str(e.device_type())
        if e.is_user_annotation():  # the call's range, on either side
            if e.name() == CALL_SPAN and not on_device:
                call = (e.start_ns(), e.end_ns())
        elif on_device:
            raw.append((e.name(), e.start_ns(), e.end_ns(),
                        e.correlation_id()))
        elif e.name().startswith(GRAPH_LAUNCH):
            launches.append((e.start_ns(), e.correlation_id()))
    raw.sort(key=lambda k: k[1])
    if call is None or not raw:
        return {}
    return {"kernels": [k[:3] for k in raw],
            "replays": replays_of(raw, launches), "window": call,
            "offset_ns": call[0] - host_ns}


def replays_of(raw, launches) -> List[List[int]]:
    """Per graph launch (``(host start, correlation id)``), in launch
    order, the indices in ``raw`` (name, start, end, correlation id,
    sorted by start) of the device operations it ran."""
    order = {cid: j for j, (_, cid) in enumerate(sorted(launches))}
    out: List[List[int]] = [[] for _ in launches]
    for i, k in enumerate(raw):
        j = order.get(k[3])
        if j is not None:
            out[j].append(i)
    return [r for r in out if r]


def busy_intervals(kernels, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the device intervals inside ``[lo, hi]``."""
    out: List[List[int]] = []
    for _, a, b in kernels:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(kernels, lo: int, hi: int) -> int:
    return sum(b - a for a, b in busy_intervals(kernels, lo, hi))


def ticks(kernels, replays, libs: Dict[str, str],
          n_ticks: int) -> Dict[int, Dict[str, int]]:
    """Per replayed tick but the last, by its index in a call of
    ``n_ticks`` ticks (the last replay is the call's last tick): its wall
    ns on the device, from its first operation to the next replay's, and
    the device ns inside it of each kernel library of ``libs``
    (:func:`port_kernels`) and of :data:`OTHER` operations."""
    first = n_ticks - len(replays)
    out = {}
    for j, (r, nxt) in enumerate(zip(replays, replays[1:])):
        t = {"wall": kernels[nxt[0]][1] - kernels[r[0]][1], OTHER: 0}
        for i in r:
            name, a, b = kernels[i]
            group = libs.get(kernel_id(name), OTHER)
            t[group] = t.get(group, 0) + (b - a)
        out[first + j] = t
    return out


def spans_on_clock(events, offset_ns: int) -> List[Tuple[str, int, int]]:
    """The program's host spans (``obs`` trace events, microseconds of
    ``perf_counter``) on the profiler's clock."""
    out = []
    for e in events:
        if e.get("ph") == "X":
            a = e["ts"] * 1000 + offset_ns
            out.append((e["name"], a, a + e["dur"] * 1000))
    return out


def breakdown(red: Dict, spans) -> Dict:
    """The device operations that took most time in the profiled call,
    and its idle time by what the host was doing: packing, the tick
    program before its first replay (state, warm-up ticks, capture), the
    replays, the read-out after the last tick, billing, or the harness's
    own code outside the call's spans."""
    lo, hi = red["window"]
    kernels = red["kernels"]
    by_name: Dict[str, int] = {}
    for name, a, b in kernels:
        if a >= lo and b <= hi:
            by_name[name] = by_name.get(name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = busy_intervals(kernels, lo, hi)
    gaps = []
    prev = lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi > prev:
        gaps.append((prev, hi))
    pack = [(a, b) for n, a, b in spans if n == "pack_specs"]
    sim = [(a, b) for n, a, b in spans if n == "simulate_packed"]
    starts = [kernels[r[0]][1] for r in red["replays"]]
    first_replay = starts[0] if starts else None
    last_tick = starts[-1] if starts else None

    def label(t: int) -> str:
        if any(a <= t < b for a, b in pack):
            return "pack_specs"
        for a, b in sim:
            if a <= t < b:
                if first_replay is None or t < first_replay:
                    return "simulate_packed: state, warm-up, capture"
                if t >= last_tick:
                    return "simulate_packed: last tick, read-out"
                return "simulate_packed: replays"
        if sim and t >= max(b for _, b in sim):
            return "billing"
        return "harness"

    # a gap is split where a span or phase begins or ends inside it
    edges = sorted({t for _, a, b in spans for t in (a, b)}
                   | {t for t in (first_replay, last_tick) if t is not None})
    idle: Dict[str, int] = {}
    for a, b in gaps:
        cuts = [a] + [t for t in edges if a < t < b] + [b]
        for x, y in zip(cuts, cuts[1:]):
            key = label(x)
            idle[key] = idle.get(key, 0) + (y - x)
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps_by]}
