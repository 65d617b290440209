"""Fleet worker of the port: the subprocess side of the runner/worker
split, copied from ``repro.sim.runners.worker``.

Run as ``python -m repro_torch.sim.runners.worker`` with frames on
stdin/stdout (``repro_torch.sim.runners.transport``). Protocol, in order:

1. ``{"op": "init", "ctx": {...}}`` — the shared job context, sent
   once. ``ctx["kind"]`` picks the runner: ``"scenario"`` executes
   ``ScenarioSpec`` payloads on the event engine through
   ``repro_torch.sim.sweep.run_scenario`` (host code: such a worker
   imports neither torch nor a device); ``"lanes"`` executes packed-grid
   lane-chunk payloads on the port's tick program
   (``repro_torch.sim.batched.lane_chunk_runner``), on the device and
   with the tick implementation the context names — the dispatcher
   resolved both, a worker never picks its own. The grid's shared tick
   arrays ship once here, never per job.
2. ``{"op": "ready", "startup_s": ...}`` back — import + runner-build
   time, observed into the ``workers.startup_s`` histogram.
3. Job frames ``{"op": "job", "job_id", "payload", "directive"}``,
   each answered by a result frame ``{"op": "result", "job_id", "ok",
   "result" | ("kind", "error"), "metrics"}``. ``metrics`` is this
   worker's registry snapshot delta (snapshot-then-reset), merged by
   the dispatcher so a fleet sweep's telemetry matches a serial run's;
   it carries ``worker.jobs`` and ``worker.busy_s``, the attempts run and
   the seconds spent in them, labeled with the worker's process id.
   A job that cannot run where the context says (``device="cuda"`` and
   no CUDA here) is answered with a not-ok ``"error"`` frame; the worker
   never runs it on the CPU instead.
4. ``{"op": "stop"}`` (or stdin EOF) ends the loop.

Fault directives (``repro_torch.sim.faults``) are acted out with real
worker semantics: ``crash`` is ``os._exit`` (the dispatcher sees the pipe
close mid-job and charges exactly this job), ``hang`` sleeps through the
dispatcher's deadline, ``transient`` fails the attempt retryably via the
result frame.

stdout discipline: the frame channel is stdout, so the worker re-points
file descriptor 1 at stderr before touching any library — a stray
``print`` (or a chatty import) degrades to a log line instead of
corrupting the stream.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Dict

from repro_torch.obs.metrics import get_registry, snapshot_and_reset
from repro_torch.sim.faults import TransientFault, perform_in_worker
from repro_torch.sim.runners.transport import recv_frame, send_frame


class ProtocolError(RuntimeError):
    """Protocol violation inside the worker (kills it; the dispatcher
    sees EOF and charges the in-flight job)."""


def build_runner(ctx: Dict[str, Any]) -> Callable[[Any], Any]:
    """Build the payload runner for one init context (shared with
    ``LocalTransport``, which runs it inline in the dispatcher)."""
    kind = ctx.get("kind", "scenario")
    if kind == "scenario":
        from repro_torch.sim.sweep import run_scenario

        return lambda payload: run_scenario(payload)
    if kind == "lanes":
        from repro_torch.sim.batched import lane_chunk_runner

        return lane_chunk_runner(ctx)
    raise ValueError(f"unknown worker context kind {kind!r}")


def attempt(runner: Callable[[Any], Any], msg: Dict[str, Any],
            snapshot: bool = True) -> Dict[str, Any]:
    """Run one job message to its result frame.

    ``crash``/``hang`` directives must be acted out by the caller (they
    are about the *worker*, not the attempt); ``transient`` raises here
    and folds into a retryable not-ok frame, and any other exception
    becomes a non-retryable ``"error"`` frame — the same kind split
    ``repro_torch.sim.jobs`` applies. ``snapshot=False`` skips the metrics
    round trip for in-process execution, where the work already landed
    in the caller's registry.
    """
    job_id = msg.get("job_id")
    frame: Dict[str, Any] = {"op": "result", "job_id": job_id}
    t0 = time.monotonic()
    try:
        directive = msg.get("directive")
        if directive is not None and directive["kind"] == "transient":
            raise TransientFault("injected transient fault")
        result = runner(msg["payload"])
    except TransientFault as e:
        frame.update(ok=False, kind="transient", error=str(e))
    except Exception as e:
        frame.update(ok=False, kind="error",
                     error=f"{type(e).__name__}: {e}")
    else:
        frame.update(ok=True, result=result)
    reg = get_registry()
    who = str(os.getpid())
    reg.inc("worker.jobs", worker=who,
            help="Job attempts a fleet worker ran, by worker process")
    reg.inc("worker.busy_s", time.monotonic() - t0, worker=who,
            help="Seconds a fleet worker spent in its job attempts")
    frame["metrics"] = snapshot_and_reset() if snapshot else None
    return frame


def main() -> int:
    # Claim the frame channel before anything can print: keep the real
    # stdout privately, then alias fd 1 to stderr for the rest of the
    # process (imports, user code, the CUDA runtime's messages).
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    inp = sys.stdin.buffer
    t0 = time.monotonic()
    init = recv_frame(inp)
    if init.get("op") != "init":
        raise ProtocolError(f"expected init frame, got {init!r}")
    runner = build_runner(init["ctx"])
    get_registry().reset()  # startup noise is not job work
    send_frame(out, {"op": "ready", "startup_s": time.monotonic() - t0})
    while True:
        try:
            msg = recv_frame(inp)
        except EOFError:
            return 0
        op = msg.get("op")
        if op == "stop":
            return 0
        if op != "job":
            raise ProtocolError(f"unexpected frame {op!r}")
        directive = msg.get("directive")
        if directive is not None and directive["kind"] in ("crash", "hang"):
            perform_in_worker(directive)  # crash exits 23; hang sleeps
        send_frame(out, attempt(runner, msg))


if __name__ == "__main__":
    sys.exit(main())
