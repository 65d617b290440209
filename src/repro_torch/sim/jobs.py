"""Fault-tolerant job execution for the port's sweeps, copied from
``repro.sim.jobs``.

Sweep work is sharded into ``Job``s — one ``PackedGrid`` lane chunk per
job on the batched program — tracked by a ``JobRegistry`` with explicit
states::

    pending -> running -> done
                  |-> failed ----> pending   (retry after backoff)
                  |-> abandoned              (retry budget exhausted)

Failed attempts retry under a deterministic exponential backoff
(``RetryPolicy``): delays are bounded by ``max_delay_s``, monotone
non-decreasing in the attempt number, and bitwise-reproducible for a fixed
seed — the jitter term is a pure hash of ``(seed, job_id)``. A job that
exhausts its budget is *abandoned*, not fatal: executors return whatever
completed plus the registry, and ``run_sweep`` folds abandoned jobs into
``SweepResult.failures`` instead of raising.

Everything is instrumented through ``repro_torch.obs``: ``jobs.retries`` /
``jobs.timeouts`` / ``jobs.crashes`` / ``jobs.requeued`` /
``jobs.abandoned`` counters, per-state ``jobs.state`` gauges, and a
``job.attempt`` span around every in-process attempt. Fault injection
(``repro_torch.sim.faults``) hooks in front of each attempt, keyed by
``(plan.seed, job_id, attempt)``.

Two executors drain the registry: ``run_local_jobs`` (serial in-process)
and ``repro_torch.sim.runners.run_fleet_jobs`` (a persistent worker fleet
over a pluggable transport). The JAX package's third, the anonymous
process pool of event-engine scenarios (``run_process_jobs``), waits for
the port's event engine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.faults import (FaultPlan, JobTimeout, TransientFault,
                                    WorkerCrash, raise_local_fault,
                                    unit_hash)

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
    #: executor-defined work description (a ``(lane_start, lane_stop)``
    #: pair of the packed grid)
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
        attempt — used when the job was collateral damage (its job frame
        never reached a worker) rather than the failure itself."""
        job.attempts = max(job.attempts - 1, 0)
        job.state = PENDING
        job.not_before = 0.0
        job.started_at = None
        get_registry().inc(
            "jobs.requeued",
            help="In-flight jobs requeued after losing their worker")
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

    Used by the batched program's lane-chunk jobs. Returns ``(results by job_id, registry)``; abandoned
    jobs are absent from the results and reported by
    ``registry.failures()``. ``on_done`` fires after each success (the
    checkpoint-journaling hook). Wall-clock deadlines cannot preempt
    in-process work, so they apply to injected hangs only (see
    ``repro_torch.sim.faults.raise_local_fault``); the worker fleet
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


__all__ = [
    "ABANDONED", "DONE", "FAILED", "PENDING", "RUNNING", "STATES",
    "RETRYABLE_KINDS", "Job", "JobFailure", "JobRegistry", "RetryPolicy",
    "run_local_jobs",
]
