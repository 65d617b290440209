"""Deterministic fault injection for the port's sweep execution layer,
copied from ``repro.sim.faults``.

A seed-driven fault plan that the job layer (``repro_torch.sim.jobs``)
consults before every job attempt: whether *this* attempt of *this* job
crashes its worker, hangs past its deadline, raises a transient exception,
or reads corrupted bytes from the persistent result cache is a pure
function of ``(plan.seed, job_id, attempt)`` — no RNG state, no wall clock
— so a fault-injected run is exactly reproducible and a test can assert its
converged output bitwise against a fault-free run. For the same seed, job
id and attempt the schedule is the JAX package's.

The plan reaches the execution layer through ``run_sweep(faults=...)``
(a ``FaultPlan``, a spec string such as
``"seed=7,crash=0.2,hang=0.1,transient=0.3,hang_s=0.05"``, or a dict).
Every executor honors the same plan: the serial path consults it
in-process, and the worker fleet (``repro_torch.sim.runners``) ships the
directive with each job frame so a ``crash`` kills the real subprocess and
a ``hang`` trips the real deadline reaper.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.obs.metrics import get_registry


class TransientFault(RuntimeError):
    """Injected one-shot failure: the attempt raises, a retry succeeds."""


class WorkerCrash(RuntimeError):
    """Injected worker death (in-process executors raise this; pool
    workers ``os._exit`` so the parent sees ``BrokenProcessPool``)."""


class JobTimeout(RuntimeError):
    """A job attempt exceeded its wall-clock deadline and was reaped."""


def unit_hash(text: str) -> float:
    """Deterministic uniform draw in [0, 1) from a string.

    SHA-256 based, so it is stable across processes, platforms, and
    Python hash randomization — the property the bitwise-reproducibility
    guarantees of the fault plan and retry backoff rest on.
    """
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64


_RATE_FIELDS = ("crash", "hang", "transient", "corrupt")


@dataclass(frozen=True)
class FaultPlan:
    """Seed-driven injection plan; immutable and hashable.

    Rates are independent per-attempt probabilities except that at most
    one of ``crash``/``hang``/``transient`` fires for a given attempt
    (one uniform draw partitioned across the three, in that order), so
    their sum must stay <= 1. ``corrupt`` applies to cache reads, not
    job attempts, and draws separately per cache entry.

    ``attempts`` gates injection to the first N attempts of each job
    (default 1): with a retry budget above N, every fault-injected job
    converges to its fault-free result — the property the end-to-end
    bitwise test relies on. ``only`` restricts injection to jobs whose
    id or labels contain the substring (``""`` = all jobs).
    """

    seed: int = 0
    crash: float = 0.0
    hang: float = 0.0
    transient: float = 0.0
    corrupt: float = 0.0
    #: inject only on the first N attempts of each job
    attempts: int = 1
    #: how long an injected hang sleeps (seconds) before the deadline
    #: machinery reaps it
    hang_s: float = 5.0
    #: substring filter on job id / labels; empty = every job
    only: str = ""

    def __post_init__(self) -> None:
        for name in _RATE_FIELDS:
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v!r}")
        if self.crash + self.hang + self.transient > 1.0 + 1e-9:
            raise ValueError("crash + hang + transient must be <= 1 "
                             "(one draw is partitioned across them)")
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts!r}")
        if self.hang_s < 0:
            raise ValueError(f"hang_s must be >= 0, got {self.hang_s!r}")

    @property
    def active(self) -> bool:
        return any(getattr(self, name) > 0.0 for name in _RATE_FIELDS)

    def _selected(self, job_id: str, labels: Sequence[str]) -> bool:
        if not self.only:
            return True
        return self.only in job_id or any(self.only in lb for lb in labels)

    def directive(self, job_id: str, labels: Sequence[str],
                  attempt: int) -> Optional[Dict[str, Any]]:
        """The fault (if any) to inject into this attempt of this job.

        Returns ``None`` (no fault) or ``{"kind": "crash" | "hang" |
        "transient", ...}``; hang directives carry ``"seconds"``. One
        uniform draw per (job, attempt) is partitioned across the three
        rates, so the kinds are mutually exclusive and each fires with
        exactly its configured probability.
        """
        if attempt > self.attempts or not self._selected(job_id, labels):
            return None
        u = unit_hash(f"{self.seed}:{job_id}:{attempt}")
        if u < self.crash:
            return {"kind": "crash"}
        if u < self.crash + self.hang:
            return {"kind": "hang", "seconds": self.hang_s}
        if u < self.crash + self.hang + self.transient:
            return {"kind": "transient"}
        return None

    def corrupts(self, name: str, read_number: int) -> bool:
        """Whether the ``read_number``-th read of cache entry ``name``
        returns corrupted bytes. Only the first read of an entry can be
        corrupted: the cache treats corruption as a miss (delete +
        recompute + rewrite), so the refreshed entry must read back
        clean for the run to converge."""
        if read_number != 1 or not self._selected(name, ()):
            return False
        return unit_hash(f"{self.seed}:corrupt:{name}") < self.corrupt


def parse_faults(text: str) -> FaultPlan:
    """Parse a fault spec string.

    Comma-separated ``key=value`` pairs over the ``FaultPlan`` fields::

        "seed=7,crash=0.2,hang=0.1,transient=0.3,hang_s=0.05,only=lanes"
    """
    plan = FaultPlan()
    fields = {"seed": int, "attempts": int, "hang_s": float, "only": str}
    fields.update({name: float for name in _RATE_FIELDS})
    updates: Dict[str, Any] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad fault spec {part!r} (expected key=value)")
        key, _, value = part.partition("=")
        key = key.strip()
        if key not in fields:
            raise ValueError(f"unknown fault field {key!r} "
                             f"(expected one of {sorted(fields)})")
        updates[key] = fields[key](value.strip())
    return replace(plan, **updates)


def as_faults(faults: Any) -> Optional[FaultPlan]:
    """Coerce ``None`` / ``FaultPlan`` / spec string / dict to a plan."""
    if faults is None or isinstance(faults, FaultPlan):
        return faults
    if isinstance(faults, str):
        return parse_faults(faults)
    if isinstance(faults, dict):
        return FaultPlan(**faults)
    raise TypeError(f"cannot interpret {faults!r} as a FaultPlan")


def raise_local_fault(directive: Dict[str, Any], timeout_s: Optional[float],
                      sleep) -> None:
    """Act out a directive inside an in-process executor.

    ``crash`` and ``transient`` raise their exception types. ``hang``
    sleeps: if the hang outlasts the job's deadline the executor reaps
    it as a ``JobTimeout`` after sleeping the deadline out (we cannot
    preempt in-process work, so the deadline is simulated); a hang
    shorter than the deadline is just a slow attempt and returns
    normally.
    """
    kind = directive["kind"]
    if kind == "crash":
        raise WorkerCrash("injected worker crash")
    if kind == "transient":
        raise TransientFault("injected transient fault")
    if kind == "hang":
        seconds = float(directive["seconds"])
        budget = seconds if timeout_s is None else min(seconds, timeout_s)
        sleep(budget)
        if timeout_s is not None and seconds > timeout_s:
            raise JobTimeout(
                f"injected hang ({seconds:g}s) exceeded the "
                f"{timeout_s:g}s job deadline")
        return
    raise ValueError(f"unknown fault directive {directive!r}")


def perform_in_worker(directive: Optional[Dict[str, Any]]) -> None:
    """Act out a directive inside a pool worker process.

    ``crash`` kills the process outright (``os._exit``), which the
    parent observes as ``BrokenProcessPool`` — the real failure mode a
    dying worker produces. ``hang`` sleeps for its duration; the parent's
    deadline monitor reaps the job and recycles the pool if the sleep
    outlasts ``timeout_s``. ``transient`` raises and travels back
    through the future like any task exception.
    """
    if directive is None:
        return
    import os
    import time

    kind = directive["kind"]
    if kind == "crash":
        os._exit(23)
    elif kind == "hang":
        time.sleep(float(directive["seconds"]))
    elif kind == "transient":
        raise TransientFault("injected transient fault")
    else:
        raise ValueError(f"unknown fault directive {directive!r}")


class FaultyBackend:
    """``StorageBackend`` wrapper that corrupts reads per the plan.

    Exercises the result cache's corruption-as-miss path
    (``repro_torch.sim.cache``): a corrupted entry is detected by the payload
    checksum, deleted, recomputed, and rewritten — only the *first* read
    of an entry is ever corrupted (see ``FaultPlan.corrupts``), so the
    refreshed entry reads back clean and the run converges. Writes and
    deletes pass through untouched.
    """

    def __init__(self, inner: Any, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self._reads: Dict[str, int] = {}

    def read(self, name: str) -> Optional[bytes]:
        data = self.inner.read(name)
        if data is None:
            return None
        n = self._reads[name] = self._reads.get(name, 0) + 1
        if self.plan.corrupts(name, n):
            get_registry().inc("faults.injected", kind="corrupt",
                              help="Faults injected by the active plan")
            # Garble rather than truncate-to-empty so the payload still
            # parses far enough to reach the checksum comparison.
            half = len(data) // 2
            return data[:half] + bytes(reversed(data[half:]))
        return data

    def write(self, name: str, data: bytes) -> None:
        self.inner.write(name, data)

    def delete(self, name: str) -> None:
        self.inner.delete(name)


__all__: Tuple[str, ...] = (
    "FaultPlan", "FaultyBackend", "JobTimeout", "TransientFault",
    "WorkerCrash", "as_faults", "parse_faults", "perform_in_worker",
    "raise_local_fault", "unit_hash",
)
