"""Span-based tracing with Chrome trace-event export, copied from
``repro.obs.trace``.

``Tracer.span`` wraps a phase of the sweep/decision pipeline — spec
packing, the tick program, cache get/put/re-bill, refinement rounds — in a
context manager that records a complete-duration event; ``instant``
records a marker with its numbers (``run_sweep_torch`` emits one a call:
specs, lanes, ticks, pack, capture and sweep seconds). ``dump`` writes the
Chrome trace-event JSON format, loadable in Perfetto or
``chrome://tracing``; every event carries the tracer's ``run_id`` in its
``args`` so traces from several runs correlate.

The tracer is **disabled by default**: an idle span is one attribute
check and a no-op context manager, so library code can wrap hot phases
unconditionally. ``device_profile`` (``repro``'s ``jax_device_profile``)
brackets a run in ``torch.profiler`` and writes its Chrome trace, when a
directory is given and the tracer is on.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional


class Tracer:
    """Process-local span recorder (Chrome trace-event JSON).

    Spans nest naturally per thread — the Chrome format reconstructs the
    flame graph from (tid, ts, dur) of complete ("ph": "X") events, so
    no explicit parent bookkeeping is needed.
    """

    def __init__(self, run_id: Optional[str] = None, enabled: bool = False):
        self.enabled = enabled
        self.run_id = run_id or uuid.uuid4().hex[:8]
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    # -- switches -----------------------------------------------------------
    def enable(self, run_id: Optional[str] = None) -> None:
        if run_id is not None:
            self.run_id = run_id
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events.clear()

    # -- recording ----------------------------------------------------------
    @contextmanager
    def span(self, name: str, **args: Any):
        """Record a complete-duration event around the wrapped block.

        ``args`` become the event's ``args`` payload (JSON-safe values
        only; non-serializable values are ``repr``-ed at dump time).
        Exceptions propagate; the span still closes and is annotated
        with ``error=True``.
        """
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        except BaseException:
            args = dict(args, error=True)
            raise
        finally:
            t1 = time.perf_counter_ns()
            self._append({
                "name": name, "ph": "X", "cat": "repro_torch",
                "ts": t0 // 1000, "dur": max((t1 - t0) // 1000, 1),
                "pid": os.getpid(), "tid": threading.get_ident(),
                "args": {**args, "run_id": self.run_id},
            })

    def instant(self, name: str, **args: Any) -> None:
        """Record a zero-duration marker event."""
        if not self.enabled:
            return
        self._append({
            "name": name, "ph": "i", "s": "p", "cat": "repro_torch",
            "ts": time.perf_counter_ns() // 1000,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": {**args, "run_id": self.run_id},
        })

    def _append(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)

    # -- export -------------------------------------------------------------
    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_chrome_dict(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON document (Perfetto-loadable)."""
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"run_id": self.run_id,
                          "exported_unix": time.time()},
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_dict(), f, indent=1, default=repr)


#: Process-global tracer: disabled until a caller enables it.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global :class:`Tracer`."""
    return _TRACER


@contextmanager
def device_profile(logdir: Optional[str]):
    """Optional ``torch.profiler`` bracket around a run (the CLIs'
    ``--device-profile``).

    Active only when ``logdir`` is set and the process-global tracer is
    enabled; every other combination is a no-op, and torch is imported
    only when active. Records the host and, where CUDA is available, the
    device, and writes ``<logdir>/device_trace.<run_id>.json`` (Chrome
    trace-event JSON) on exit.
    """
    if not logdir or not _TRACER.enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"device_trace.{_TRACER.run_id}.json"))


__all__: Iterable[str] = ["Tracer", "get_tracer", "device_profile"]
