"""Fault-tolerant job execution for the port's sweeps, copied from
``repro.sim.jobs``.

Sweep work is sharded into ``Job``s — one ``PackedGrid`` lane chunk per
job on the batched program, one scenario per job on the event engine
(``backend="process"``) — tracked by a ``JobRegistry`` with explicit
states::

    pending -> running -> done
                  |-> failed ----> pending   (retry after backoff)
                  |-> abandoned              (retry budget exhausted)

Failed attempts retry under a deterministic exponential backoff
(``RetryPolicy``): delays are bounded by ``max_delay_s``, monotone
non-decreasing in the attempt number, and bitwise-reproducible for a fixed
seed — the jitter term is a pure hash of ``(seed, job_id)``. Worker death
(``BrokenProcessPool``) recycles the pool and requeues only the lost
jobs; wall-clock deadlines reap hung workers the same way. A job that
exhausts its budget is *abandoned*, not fatal: executors return whatever
completed plus the registry, and ``run_sweep`` folds abandoned jobs into
``SweepResult.failures`` instead of raising.

Everything is instrumented through ``repro_torch.obs``: ``jobs.retries`` /
``jobs.timeouts`` / ``jobs.crashes`` / ``jobs.requeued`` /
``jobs.abandoned`` counters, per-state ``jobs.state`` gauges, and a
``job.attempt`` span around every in-process attempt. Fault injection
(``repro_torch.sim.faults``) hooks in front of each attempt, keyed by
``(plan.seed, job_id, attempt)``.

Three executors drain the registry: ``run_local_jobs`` (serial
in-process), ``run_process_jobs`` (an anonymous spawned pool of
event-engine scenarios, recycled wholesale on a crash) and
``repro_torch.sim.runners.run_fleet_jobs`` (a persistent worker fleet over
a pluggable transport, with per-worker crash attribution) — all observing
the same state machine, retry policy and fault plan, and all producing
byte-identical results.
"""

from __future__ import annotations

import multiprocessing
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import get_registry, snapshot_and_reset
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.faults import (FaultPlan, JobTimeout, TransientFault,
                                    WorkerCrash, perform_in_worker,
                                    raise_local_fault, unit_hash)

#: Job lifecycle states.
PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"      # awaiting its backoff delay, will retry
ABANDONED = "abandoned"  # retry budget exhausted; reported as a failure

STATES = (PENDING, RUNNING, DONE, FAILED, ABANDONED)

#: Failure kinds that retry. Generic exceptions (``"error"``) do not:
#: a deterministic bug fails every attempt identically, so retrying it
#: only multiplies the wasted work — retries are for infrastructure
#: faults (lost workers, deadlines, declared-transient errors).
RETRYABLE_KINDS = ("crash", "timeout", "transient")


@dataclass(frozen=True)
class RetryPolicy:
    """Deterministic bounded exponential backoff.

    The delay after failed attempt ``a`` (1-based) of job ``j`` is::

        min(max_delay_s, base_delay_s * multiplier**(a-1) * (1 + jitter*u))

    with ``u = unit_hash(f"{seed}:{j}") in [0, 1)`` — jitter varies *per
    job*, not per attempt, so each job's delay sequence is monotone
    non-decreasing by construction while different jobs still spread out
    (no thundering herd on pool recycle). Pure function of its inputs:
    bounded, monotone, bitwise-reproducible for a fixed seed.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts!r}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, "
                             f"got {self.multiplier!r}")
        if not 0.0 <= self.jitter:
            raise ValueError(f"jitter must be >= 0, got {self.jitter!r}")

    def delay_s(self, job_id: str, attempt: int) -> float:
        """Backoff delay after the ``attempt``-th (1-based) failure."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt!r}")
        raw = self.base_delay_s * self.multiplier ** (attempt - 1)
        u = unit_hash(f"{self.seed}:{job_id}")
        return min(self.max_delay_s, raw * (1.0 + self.jitter * u))


@dataclass
class Job:
    """One retryable unit of sweep work."""

    job_id: str
    #: executor-defined work description (a ``ScenarioSpec`` on the
    #: process backend, a ``(lane_start, lane_stop)`` pair of the packed
    #: grid on the batched program)
    payload: Any = None
    #: human-readable tags (spec labels); fault plans filter on these
    labels: Tuple[str, ...] = ()
    #: wall-clock deadline per attempt; ``None`` = unlimited
    timeout_s: Optional[float] = None
    state: str = PENDING
    attempts: int = 0
    #: earliest monotonic time the next attempt may start (backoff)
    not_before: float = 0.0
    errors: List[str] = field(default_factory=list)
    last_kind: str = ""
    started_at: Optional[float] = None
    result: Any = None
    #: the fault directive injected into the current attempt, if any
    injected: Optional[Dict[str, Any]] = None


@dataclass
class JobFailure:
    """Structured report of one abandoned job (carried on
    ``SweepResult.failures`` instead of raising)."""

    job_id: str
    labels: Tuple[str, ...]
    kind: str
    attempts: int
    errors: List[str]

    def as_dict(self) -> Dict[str, Any]:
        return {"job_id": self.job_id, "labels": list(self.labels),
                "kind": self.kind, "attempts": self.attempts,
                "errors": list(self.errors)}


class JobRegistry:
    """State machine over a batch of jobs; executor-agnostic.

    Executors drive it through ``ready`` / ``mark_running`` /
    ``mark_done`` / ``mark_failed`` / ``requeue_lost`` and it keeps the
    books: attempt counts, backoff deadlines, error trails, and the
    ``jobs.*`` metrics (per-state gauges on every transition, counters
    for retries / timeouts / crashes / requeues / abandonments).
    """

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or RetryPolicy()
        self.clock = clock
        self.jobs: Dict[str, Job] = {}

    def add(self, job: Job) -> Job:
        if job.job_id in self.jobs:
            raise ValueError(f"duplicate job id {job.job_id!r}")
        self.jobs[job.job_id] = job
        self._publish()
        return job

    def counts(self) -> Dict[str, int]:
        out = {state: 0 for state in STATES}
        for job in self.jobs.values():
            out[job.state] += 1
        return out

    def _publish(self) -> None:
        reg = get_registry()
        for state, n in self.counts().items():
            reg.set_gauge("jobs.state", n, state=state,
                          help="Jobs currently in each lifecycle state")

    # -- scheduling ---------------------------------------------------------
    def ready(self, now: Optional[float] = None) -> List[Job]:
        """Jobs whose next attempt may start now (insertion order)."""
        if now is None:
            now = self.clock()
        return [j for j in self.jobs.values()
                if j.state == PENDING
                or (j.state == FAILED and j.not_before <= now)]

    def unsettled(self) -> bool:
        """True while any job can still change state."""
        return any(j.state in (PENDING, RUNNING, FAILED)
                   for j in self.jobs.values())

    def next_wake(self) -> Optional[float]:
        """Earliest time a non-running job becomes ready; ``None`` when
        nothing is waiting (all done/abandoned/running)."""
        wakes = [0.0 if j.state == PENDING else j.not_before
                 for j in self.jobs.values()
                 if j.state in (PENDING, FAILED)]
        return min(wakes) if wakes else None

    # -- transitions --------------------------------------------------------
    def mark_running(self, job: Job) -> None:
        job.state = RUNNING
        job.attempts += 1
        job.started_at = self.clock()
        self._publish()

    def mark_done(self, job: Job, result: Any = None) -> None:
        job.state = DONE
        job.result = result
        job.started_at = None
        self._publish()

    def mark_failed(self, job: Job, kind: str, error: str) -> bool:
        """Record a failed attempt; returns ``True`` if a retry was
        scheduled, ``False`` if the job is now abandoned. Only
        ``RETRYABLE_KINDS`` retry — a generic ``"error"`` abandons
        immediately (deterministic bugs fail every attempt)."""
        job.errors.append(f"attempt {job.attempts} [{kind}]: {error}")
        job.last_kind = kind
        job.started_at = None
        reg = get_registry()
        if kind == "timeout":
            reg.inc("jobs.timeouts",
                    help="Job attempts reaped at their wall-clock deadline")
        elif kind == "crash":
            reg.inc("jobs.crashes",
                    help="Job attempts lost to worker death")
        else:
            reg.inc("jobs.errors", kind=kind,
                    help="Job attempts that raised")
        retryable = (kind in RETRYABLE_KINDS
                     and job.attempts < self.policy.max_attempts)
        if not retryable:
            job.state = ABANDONED
            reg.inc("jobs.abandoned",
                    help="Jobs that exhausted their retry budget")
            self._publish()
            return False
        job.state = FAILED
        job.not_before = self.clock() + self.policy.delay_s(job.job_id,
                                                            job.attempts)
        reg.inc("jobs.retries",
                help="Retries scheduled after failed job attempts")
        self._publish()
        return True

    def requeue_lost(self, job: Job) -> None:
        """Return an in-flight job to the queue without charging an
        attempt — used when the job was collateral damage (its pool died
        because of a *different* job, or its job frame never reached a
        worker) rather than the failure itself."""
        job.attempts = max(job.attempts - 1, 0)
        job.state = PENDING
        job.not_before = 0.0
        job.started_at = None
        get_registry().inc(
            "jobs.requeued",
            help="In-flight jobs requeued after losing their worker or pool")
        self._publish()

    # -- reporting ----------------------------------------------------------
    def failures(self) -> List[JobFailure]:
        return [JobFailure(job_id=j.job_id, labels=j.labels,
                           kind=j.last_kind or "error",
                           attempts=j.attempts, errors=list(j.errors))
                for j in self.jobs.values() if j.state == ABANDONED]


# -- in-process executor ------------------------------------------------------

def run_local_jobs(jobs: Sequence[Job],
                   run_one: Callable[[Job], Any], *,
                   policy: Optional[RetryPolicy] = None,
                   registry: Optional[JobRegistry] = None,
                   faults: Optional[FaultPlan] = None,
                   progress: Optional[Callable[[int, int, Any], None]] = None,
                   on_done: Optional[Callable[[Job, Any], None]] = None,
                   sleep: Callable[[float], None] = time.sleep,
                   ) -> Tuple[Dict[str, Any], JobRegistry]:
    """Run jobs serially in-process with retry/backoff and fault injection.

    Used by the batched program's lane-chunk jobs and the serial process
    backend. Returns ``(results by job_id, registry)``; abandoned
    jobs are absent from the results and reported by
    ``registry.failures()``. ``on_done`` fires after each success (the
    checkpoint-journaling hook). Wall-clock deadlines cannot preempt
    in-process work, so they apply to injected hangs only (see
    ``repro_torch.sim.faults.raise_local_fault``); the process pool and the
    worker fleet
    enforces real deadlines.
    """
    reg = registry or JobRegistry(policy)
    for job in jobs:
        reg.add(job)
    total = len(reg.jobs)
    results: Dict[str, Any] = {}
    tracer = get_tracer()
    n_done = 0
    while True:
        now = reg.clock()
        batch = reg.ready(now)
        if not batch:
            wake = reg.next_wake()
            if wake is None:
                break
            sleep(max(wake - now, 0.0))
            continue
        for job in batch:
            reg.mark_running(job)
            job.injected = (faults.directive(job.job_id, job.labels,
                                             job.attempts)
                            if faults is not None else None)
            try:
                with tracer.span("job.attempt", job=job.job_id,
                                 attempt=job.attempts):
                    if job.injected is not None:
                        raise_local_fault(job.injected, job.timeout_s, sleep)
                    out = run_one(job)
            except JobTimeout as e:
                reg.mark_failed(job, "timeout", str(e))
            except WorkerCrash as e:
                reg.mark_failed(job, "crash", str(e))
            except TransientFault as e:
                reg.mark_failed(job, "transient", str(e))
            except Exception as e:
                reg.mark_failed(job, "error", f"{type(e).__name__}: {e}")
            else:
                reg.mark_done(job, out)
                results[job.job_id] = out
                n_done += 1
                if on_done is not None:
                    on_done(job, out)
                if progress is not None:
                    progress(n_done, total, out)
    return results, reg


# -- process-pool executor ----------------------------------------------------

def _pool_attempt(spec: Any, directive: Optional[Dict[str, Any]]):
    """Worker-side task: act out any injected fault, then run the
    scenario. Returns the result plus the worker registry's snapshot
    delta (``snapshot_and_reset``), which the parent merges, so a pooled
    sweep's metrics match a serial run's.
    Top-level for pickling."""
    perform_in_worker(directive)
    from repro_torch.sim.sweep import run_scenario

    result = run_scenario(spec)
    return result, snapshot_and_reset()


def _kill_pool(pool: ProcessPoolExecutor) -> None:
    """Tear a pool down *now*: running futures cannot be cancelled, so a
    deadline overrun or unattributable crash recycles the whole pool."""
    procs = list((getattr(pool, "_processes", None) or {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for p in procs:
        try:
            p.terminate()
        except Exception:
            pass
    for p in procs:
        try:
            p.join(timeout=2.0)
        except Exception:
            pass


def run_process_jobs(jobs: Sequence[Job], *, workers: int,
                     policy: Optional[RetryPolicy] = None,
                     registry: Optional[JobRegistry] = None,
                     faults: Optional[FaultPlan] = None,
                     progress: Optional[Callable[[int, int, Any], None]]
                     = None,
                     on_done: Optional[Callable[[Job, Any], None]] = None,
                     poll_s: float = 0.1,
                     ) -> Tuple[Dict[str, Any], JobRegistry]:
    """Run scenario jobs on a spawned process pool with crash recovery.

    Each ``job.payload`` must be a picklable ``ScenarioSpec``. The pool's
    workers are spawned, never forked (a forked child would inherit the
    caller's CUDA context), and run the event engine only: they import
    neither torch nor a device. The loop
    keeps at most ``workers`` jobs in flight (so ``started_at`` measures
    run time, not queue time), polls every ``poll_s`` seconds for
    deadline overruns, and survives worker death: ``BrokenProcessPool``
    fails the implicated job (when a crash directive identifies it),
    requeues the innocent in-flight jobs without charging an attempt,
    and respawns the pool. When no directive attributes the crash, every
    in-flight job is charged — bounded retries keep a genuine repeat-
    crasher from cycling the pool forever.

    Returns ``(results by job_id, registry)``; abandoned jobs are
    reported by ``registry.failures()`` instead of raising.
    """
    reg = registry or JobRegistry(policy)
    for job in jobs:
        reg.add(job)
    total = len(reg.jobs)
    results: Dict[str, Any] = {}
    metrics = get_registry()
    tracer = get_tracer()
    ctx = multiprocessing.get_context("spawn")
    pool: Optional[ProcessPoolExecutor] = None
    inflight: Dict[Any, Job] = {}
    n_done = 0

    from repro_torch.sim.sweep import _worker_init  # deferred: sweep imports us

    def ensure_pool() -> ProcessPoolExecutor:
        nonlocal pool
        if pool is None:
            pool = ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                                       initializer=_worker_init)
        return pool

    def recycle_pool() -> None:
        nonlocal pool
        if pool is not None:
            _kill_pool(pool)
            pool = None
        inflight.clear()

    try:
        while reg.unsettled():
            now = time.monotonic()
            overdue = [job for job in inflight.values()
                       if job.timeout_s is not None
                       and job.started_at is not None
                       and now - job.started_at > job.timeout_s]
            if overdue:
                # A running pool future cannot be cancelled: fail the
                # overdue jobs, requeue the innocent ones, recycle.
                innocent = [j for j in inflight.values()
                            if j not in overdue]
                for job in overdue:
                    reg.mark_failed(
                        job, "timeout",
                        f"exceeded the {job.timeout_s:g}s deadline")
                for job in innocent:
                    reg.requeue_lost(job)
                recycle_pool()
                continue
            broken_on_submit = False
            for job in reg.ready(now):
                if len(inflight) >= workers:
                    break
                reg.mark_running(job)
                job.injected = (faults.directive(job.job_id, job.labels,
                                                 job.attempts)
                                if faults is not None else None)
                try:
                    fut = ensure_pool().submit(_pool_attempt, job.payload,
                                               job.injected)
                except BrokenProcessPool:
                    reg.requeue_lost(job)
                    broken_on_submit = True
                    break
                inflight[fut] = job
            if broken_on_submit:
                for job in inflight.values():
                    reg.requeue_lost(job)
                recycle_pool()
                continue
            if not inflight:
                wake = reg.next_wake()
                if wake is None:
                    break
                time.sleep(min(max(wake - now, 0.0), poll_s))
                continue
            done_futs, _ = wait(set(inflight), timeout=poll_s,
                                return_when=FIRST_COMPLETED)
            crashed: List[Job] = []
            for fut in done_futs:
                job = inflight.pop(fut)
                try:
                    result, snap = fut.result()
                except BrokenProcessPool:
                    crashed.append(job)
                    continue
                except TransientFault as e:
                    reg.mark_failed(job, "transient", str(e))
                except Exception as e:
                    reg.mark_failed(job, "error",
                                    f"{type(e).__name__}: {e}")
                else:
                    metrics.merge(snap)
                    reg.mark_done(job, result)
                    results[job.job_id] = result
                    n_done += 1
                    tracer.instant("job.attempt", job=job.job_id,
                                   attempt=job.attempts, state=DONE)
                    if on_done is not None:
                        on_done(job, result)
                    if progress is not None:
                        progress(n_done, total, result)
            if crashed:
                # BrokenProcessPool fails every in-flight future at once.
                # Charge the jobs a crash directive implicates; the rest
                # are collateral and requeue free — unless nothing is
                # implicated, in which case everyone is charged (bounded
                # retries stop a real repeat-crasher).
                implicated = [j for j in crashed
                              if (j.injected or {}).get("kind") == "crash"]
                victims = implicated or crashed
                for job in crashed:
                    if job in victims:
                        reg.mark_failed(job, "crash",
                                        "worker died (BrokenProcessPool)")
                    else:
                        reg.requeue_lost(job)
                for job in list(inflight.values()):
                    reg.requeue_lost(job)
                recycle_pool()
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    return results, reg


__all__ = [
    "ABANDONED", "DONE", "FAILED", "PENDING", "RUNNING", "STATES",
    "RETRYABLE_KINDS", "Job", "JobFailure", "JobRegistry", "RetryPolicy",
    "run_local_jobs", "run_process_jobs",
]
