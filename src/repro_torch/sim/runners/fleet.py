"""The port's fleet dispatcher: drain a ``JobRegistry`` through persistent
workers, copied from ``repro.sim.runners.fleet``.

``run_fleet_jobs`` is the second ``repro_torch.sim.jobs`` executor, next to
``run_local_jobs`` (serial in-process). Same contract — ``(results by
job_id, registry)``, abandoned jobs reported via ``registry.failures()``
instead of raising — different execution model: up to ``workers``
*persistent* workers, each reached through its own ``Transport``, each
initialized once with the shared job context and then fed jobs one at a
time.

What one-job-per-worker buys:

- **Exact crash attribution.** A dead pipe implicates precisely the job
  that worker carried; nothing is requeued as collateral damage.
- **Surgical deadline reaping.** A deadline overrun kills *that*
  worker; its peers keep running.
- **Amortized startup.** Workers import + build their runner once
  (``init`` frame) and the grid's shared arrays ship once, not per job —
  what makes lane-chunk jobs cheap to distribute.

Faults (``repro_torch.sim.faults``) inject per attempt exactly as on the
serial executor: the directive rides the job frame and the worker acts it
out (``crash`` = ``os._exit`` -> EOF here; ``hang`` sleeps into the
deadline; ``transient`` returns a retryable not-ok frame). Worker metrics
snapshots (``repro_torch.obs.metrics.snapshot_and_reset`` in the worker)
ride each result frame and merge into the dispatcher's registry.

Telemetry: ``workers.spawned`` / ``workers.alive`` / ``workers.lost`` /
``workers.killed{reason}`` / ``workers.startup_s`` for fleet lifecycle,
``dispatch.jobs`` / ``dispatch.results`` / ``dispatch.roundtrip_s`` for
job traffic.
"""

from __future__ import annotations

import time
from collections import deque
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.faults import FaultPlan
from repro_torch.sim.jobs import Job, JobRegistry, RetryPolicy
from repro_torch.sim.runners.transport import (Transport, TransportError,
                                         resolve_transport)


class _Slot:
    """One fleet seat: a live transport and its in-flight job (if any)."""

    __slots__ = ("transport", "job")

    def __init__(self, transport: Transport):
        self.transport = transport
        self.job: Optional[Job] = None


def run_fleet_jobs(jobs: Sequence[Job], *, workers: int,
                   transport: Any = "subprocess",
                   ctx: Optional[Dict[str, Any]] = None,
                   prepare: Optional[Callable[[Job], Any]] = None,
                   policy: Optional[RetryPolicy] = None,
                   registry: Optional[JobRegistry] = None,
                   faults: Optional[FaultPlan] = None,
                   progress: Optional[Callable[[int, int, Any], None]] = None,
                   on_done: Optional[Callable[[Job, Any], None]] = None,
                   poll_s: float = 0.05,
                   ) -> Tuple[Dict[str, Any], JobRegistry]:
    """Run registry jobs on a persistent worker fleet.

    ``transport`` selects the channel per worker: ``"subprocess"``
    (default; spawned local worker processes), ``"local"`` (inline
    execution, for tests), or any zero-arg factory returning a
    ``Transport`` (the remote-host seam). ``ctx`` is the shared init
    context every worker receives once (``{"kind": "lanes", ...}``, see
    ``repro_torch.sim.batched.lane_chunk_runner``);
    ``prepare(job)`` builds the per-job wire payload (default:
    ``job.payload`` as-is) — the lane-chunk path uses it to slice each
    job's lanes out of the grid instead of shipping the whole grid.

    Workers spawn lazily up to ``workers`` as ready jobs appear, are
    killed individually when their job exceeds its ``timeout_s``, and
    are respawned while work remains. ``on_done`` fires after each
    success (the checkpoint-journaling hook); ``progress(done, total,
    result)`` after each success too. Shutdown sends each worker a stop
    frame, then reaps it.
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers!r}")
    factory = resolve_transport(transport)
    reg = registry or JobRegistry(policy)
    for job in jobs:
        reg.add(job)
    total = len(reg.jobs)
    results: Dict[str, Any] = {}
    metrics = get_registry()
    tracer = get_tracer()
    init_msg = {"op": "init", "ctx": ctx or {"kind": "scenario"}}
    fleet: List[_Slot] = []
    n_done = 0

    def payload_of(job: Job) -> Any:
        return prepare(job) if prepare is not None else job.payload

    def publish_alive() -> None:
        metrics.set_gauge("workers.alive", len(fleet),
                          help="Fleet workers currently alive")

    def spawn() -> Optional[_Slot]:
        try:
            t = factory()
            t.start(init_msg)
        except Exception as e:  # spawn failure: report, don't spin
            metrics.inc("workers.spawn_failures",
                        help="Fleet workers that failed to start")
            tracer.instant("worker.spawn_failed", error=str(e))
            return None
        slot = _Slot(t)
        fleet.append(slot)
        metrics.inc("workers.spawned", help="Fleet workers spawned")
        publish_alive()
        return slot

    def drop(slot: _Slot, kill: bool = True) -> None:
        if kill:
            slot.transport.kill()
        if slot in fleet:
            fleet.remove(slot)
        publish_alive()

    def assign(slot: _Slot, job: Job) -> bool:
        reg.mark_running(job)
        job.injected = (faults.directive(job.job_id, job.labels,
                                         job.attempts)
                        if faults is not None else None)
        msg = {"op": "job", "job_id": job.job_id,
               "payload": payload_of(job), "directive": job.injected}
        try:
            slot.transport.send(msg)
        except TransportError:
            # Never delivered: the job is blameless, the channel is not.
            reg.requeue_lost(job)
            drop(slot)
            return False
        slot.job = job
        metrics.inc("dispatch.jobs",
                    help="Jobs dispatched to fleet workers")
        return True

    def handle(slot: _Slot, event: Tuple) -> None:
        nonlocal n_done
        if event[0] == "eof":
            job = slot.job
            slot.job = None
            metrics.inc("workers.lost",
                        help="Fleet workers that died unexpectedly")
            if job is not None:
                # One job per worker: a dead pipe implicates exactly it.
                reg.mark_failed(job, "crash", "worker died (channel EOF)")
            drop(slot, kill=True)
            return
        msg = event[1]
        op = msg.get("op")
        if op == "ready":
            metrics.observe("workers.startup_s",
                            float(msg.get("startup_s", 0.0)),
                            help="Worker import + runner-build time (s)")
            return
        if op != "result":
            return
        job = slot.job
        if job is None or msg.get("job_id") != job.job_id:
            return  # stale frame from a reassigned seat; drop it
        slot.job = None
        if (job.timeout_s is not None and job.started_at is not None
                and reg.clock() - job.started_at > job.timeout_s):
            # The frame beat the reaper but the deadline still stands
            # (an in-line transport's injected hang lands here). The
            # worker proved responsive, so it keeps its seat.
            reg.mark_failed(job, "timeout",
                            f"result arrived after the "
                            f"{job.timeout_s:g}s deadline")
            return
        metrics.merge(msg.get("metrics"))
        metrics.inc("dispatch.results",
                    help="Result frames received from fleet workers")
        if job.started_at is not None:
            metrics.observe("dispatch.roundtrip_s",
                            reg.clock() - job.started_at,
                            help="Dispatch-to-result round trip (s)")
        if msg.get("ok"):
            result = msg.get("result")
            reg.mark_done(job, result)
            results[job.job_id] = result
            n_done += 1
            tracer.instant("job.attempt", job=job.job_id,
                           attempt=job.attempts, state="done")
            if on_done is not None:
                on_done(job, result)
            if progress is not None:
                progress(n_done, total, result)
        else:
            reg.mark_failed(job, msg.get("kind", "error"),
                            msg.get("error", "unknown worker failure"))

    try:
        while reg.unsettled():
            now = reg.clock()
            # -- deadline reaping: kill only the offending worker ---------
            for slot in list(fleet):
                job = slot.job
                if (job is not None and job.timeout_s is not None
                        and job.started_at is not None
                        and now - job.started_at > job.timeout_s):
                    slot.job = None
                    reg.mark_failed(
                        job, "timeout",
                        f"exceeded the {job.timeout_s:g}s deadline")
                    metrics.inc("workers.killed", reason="deadline",
                                help="Fleet workers killed by the "
                                     "dispatcher")
                    drop(slot)
            # -- assign ready jobs to idle seats, spawning as needed ------
            ready = deque(reg.ready(now))
            for slot in list(fleet):
                if not ready:
                    break
                if slot.job is None and slot.transport.alive:
                    assign(slot, ready.popleft())
            spawn_denied = False
            while ready and len(fleet) < workers and not spawn_denied:
                slot = spawn()
                if slot is None:
                    spawn_denied = True
                    break
                assign(slot, ready.popleft())
            # -- poll every seat; handle whatever arrived -----------------
            got = False
            for slot in list(fleet):
                while True:
                    event = slot.transport.poll()
                    if event is None:
                        break
                    got = True
                    handle(slot, event)
            if got:
                continue
            if any(slot.job is not None for slot in fleet):
                time.sleep(min(poll_s, 0.02))
                continue
            wake = reg.next_wake()
            if wake is None:
                break
            if spawn_denied:
                # Nothing in flight and workers cannot start: abandon the
                # remainder rather than spinning forever.
                for job in reg.ready(reg.clock()):
                    reg.mark_running(job)
                    reg.mark_failed(job, "error",
                                    "no fleet worker could be started")
                continue
            time.sleep(min(max(wake - now, 0.0), poll_s))
    finally:
        for slot in list(fleet):
            try:
                slot.transport.send({"op": "stop"})
            except Exception:
                pass
            slot.transport.kill()
        fleet.clear()
        publish_alive()
    return results, reg


__all__ = ["run_fleet_jobs"]
