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

Every span carries its own ``id`` and its enclosing span's (``parent``,
``None`` at the top; kept per thread), every span and instant the
``root`` of what it belongs to: the id that :meth:`Tracer.root` gave the
call it runs in (``run_sweep_torch`` opens one a call), else its
outermost enclosing span's. :meth:`Tracer.enable` records one
``obs.clock`` instant whose ``offset_ns`` places the spans' clock
(``perf_counter``) on the profiler's (``time.time_ns``, which
``torch.profiler`` stamps its events with): profiler ns = ``ts`` x 1000 +
``offset_ns``.

The tracer is **disabled by default**: an idle span is one attribute
check and a no-op context manager, so library code can wrap hot phases
unconditionally. ``device_profile`` (``repro``'s ``jax_device_profile``)
brackets a run in ``torch.profiler`` and writes its Chrome trace, when a
directory is given and the tracer is on.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional


class Tracer:
    """Process-local span recorder (Chrome trace-event JSON).

    Spans nest per thread: the Chrome format reconstructs the flame graph
    from (tid, ts, dur) of complete ("ph": "X") events, and each span's
    ``args`` name it (``id``), its enclosing span (``parent``) and the
    ``root`` it belongs to, from a stack kept per thread.
    """

    def __init__(self, run_id: Optional[str] = None, enabled: bool = False):
        self.enabled = enabled
        self.run_id = run_id or uuid.uuid4().hex[:8]
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- switches -----------------------------------------------------------
    def enable(self, run_id: Optional[str] = None) -> None:
        """Record from now on, starting with an ``obs.clock`` instant."""
        if run_id is not None:
            self.run_id = run_id
        self.enabled = True
        spread, offset = clock_offset_ns()
        self.instant("obs.clock", offset_ns=offset, spread_ns=spread,
                     clock="time.time_ns")

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events.clear()

    # -- recording ----------------------------------------------------------
    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _links(self, own: Optional[int] = None) -> Dict[str, Any]:
        """``parent`` and ``root`` of an event recorded now on this thread
        (``own``: the event's id, the root when nothing encloses it)."""
        stack = self._stack()
        root = getattr(self._local, "root", None)
        if root is None:
            root = stack[0] if stack else own
        return {"parent": stack[-1] if stack else None, "root": root}

    @contextmanager
    def root(self):
        """Give every span and instant recorded inside the block on this
        thread one ``root``, a new id, yielded (``None`` while disabled)."""
        if not self.enabled:
            yield None
            return
        prev = getattr(self._local, "root", None)
        self._local.root = rid = next(self._ids)
        try:
            yield rid
        finally:
            self._local.root = prev

    @contextmanager
    def span(self, name: str, **args: Any):
        """Record a complete-duration event around the wrapped block; yields
        its start (``perf_counter_ns``; ``None`` while disabled).

        ``args`` become the event's ``args`` payload (JSON-safe values
        only; non-serializable values are ``repr``-ed at dump time).
        Exceptions propagate; the span still closes and is annotated
        with ``error=True``.
        """
        if not self.enabled:
            yield None
            return
        sid = next(self._ids)
        links = self._links(sid)
        stack = self._stack()
        stack.append(sid)
        t0 = time.perf_counter_ns()
        try:
            yield t0
        except BaseException:
            args = dict(args, error=True)
            raise
        finally:
            t1 = time.perf_counter_ns()
            stack.pop()
            self._append(self._complete(name, t0, t1, args, sid, links))

    def record_span(self, name: str, t0_ns: int, t1_ns: int,
                    **args: Any) -> None:
        """Record a complete-duration event from ``t0_ns`` to ``t1_ns``
        (``perf_counter_ns``), inside the spans open now on this thread:
        for a phase no ``with`` block fits around."""
        if not self.enabled:
            return
        sid = next(self._ids)
        self._append(self._complete(name, t0_ns, t1_ns, args, sid,
                                    self._links(sid)))

    def _complete(self, name, t0, t1, args, sid, links) -> Dict[str, Any]:
        return {
            "name": name, "ph": "X", "cat": "repro_torch",
            "ts": t0 // 1000, "dur": max((t1 - t0) // 1000, 1),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": {**args, "run_id": self.run_id, "id": sid, **links},
        }

    def instant(self, name: str, **args: Any) -> None:
        """Record a zero-duration marker event."""
        if not self.enabled:
            return
        self._append({
            "name": name, "ph": "i", "s": "p", "cat": "repro_torch",
            "ts": time.perf_counter_ns() // 1000,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": {**args, "run_id": self.run_id, **self._links()},
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


def clock_offset_ns(readings: int = 8):
    """``(spread, offset)``: ``time.time_ns()`` less
    ``time.perf_counter_ns()``, from the tightest of ``readings`` wall-clock
    readings each bracketed by two ``perf_counter`` ones (``spread`` its
    bracket, ns)."""
    best = None
    for _ in range(readings):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best


#: Process-global tracer: disabled until a caller enables it.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global :class:`Tracer`."""
    return _TRACER


def traced_call(fn):
    """``fn`` with every span and instant of one call under one root of
    the process-global tracer (:meth:`Tracer.root`)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with _TRACER.root():
            return fn(*args, **kwargs)
    return call


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


__all__: Iterable[str] = ["Tracer", "get_tracer", "device_profile",
                          "clock_offset_ns", "traced_call"]
