"""Plain versions of the sweep tick's tracing, on the host clock: what a
traced tick on the CPU runs (eager and synchronous there, so the host's
clock times its phases), and the oracles of the ``trace_tick`` kernels.

A traced tick (``repro_torch.sim.batched``) stamps its start, its end and
every point where it passes from one layer to another (the lane-tick
kernels, the tick-glue kernels, PyTorch's own operations): each stamp adds
the time since the previous stamp to its segment's sum, maximum and count
(:data:`SEGMENTS`; the start stamp books the time since the previous
tick's end as ``replay_gap``). At its end it counts its work on ticks
``t % COUNT_STRIDE == 0`` (:data:`COUNTS`, a lane each).
"""

from __future__ import annotations

import time
from typing import Dict

import torch

#: The segments a traced tick books, in its order; each holds one layer's
#: work (``LAYERS``). ``replay_gap`` is booked by the tick's first stamp:
#: the time since the previous tick's last.
SEGMENTS = ("replay_gap", "clock", "begin", "transfer", "transfer_adds",
            "complete_link", "gcs_admit", "gcs_copy", "migrate",
            "job_window", "wait_select", "window_gather", "windows_admit",
            "plan_apply", "counters")

#: The row of each segment in the accumulator.
ROW = {name: i for i, name in enumerate(SEGMENTS)}

#: The layer each segment's work belongs to.
LAYERS = {
    "lane_tick": ("transfer", "gcs_admit", "windows_admit"),
    "tick_glue": ("begin", "complete_link", "migrate", "wait_select"),
    "torch": ("clock", "transfer_adds", "gcs_copy", "job_window",
              "window_gather", "plan_apply"),
    "trace_tick": ("counters",),
    "device": ("replay_gap",),
}

#: What the counter adds a lane on a counted tick, in its order (the last
#: is the number of ticks counted).
COUNTS = ("gcs_candidates", "migrations", "active_transfers",
          "waiting_files", "queued_links", "ticks")

#: Ticks between two counted ticks (tick 0 counted). Counting reads two
#: flag planes (2 B a file), tens of microseconds at a few lanes of
#: 2,000,000 files; on the other ticks the kernel returns at once.
COUNT_STRIDE = 128


def acc_size() -> int:
    """Int64 words of the stamp accumulator: the previous stamp, then sum,
    maximum and count a segment."""
    return 1 + 3 * len(SEGMENTS)


def state(L: int, device) -> Dict[str, torch.Tensor]:
    """The trace's tensors of a loop's state: ``trace_acc`` (the stamps)
    and ``trace_counts`` (``[L, len(COUNTS)]``), zeroed."""
    return {"trace_acc": torch.zeros((acc_size(),), dtype=torch.int64,
                                     device=device),
            "trace_counts": torch.zeros((L, len(COUNTS)), dtype=torch.int64,
                                        device=device)}


def clock_ns() -> int:
    """The host clock the CPU stamps read."""
    return time.perf_counter_ns()


def stamp(acc: torch.Tensor, row: int) -> None:
    """Book the time since the previous stamp into segment ``row`` (none
    after a reset) and make now the previous stamp."""
    now = clock_ns()
    a = acc.numpy()
    if a[0] != 0:
        r = 1 + 3 * row
        d = now - int(a[0])
        a[r] += d
        a[r + 1] = max(int(a[r + 1]), d)
        a[r + 2] += 1
    a[0] = now


def count(counts, tick, want, mig, occ3, lq_next, lq_serve, wq_wait) -> None:
    """On a tick ``t % COUNT_STRIDE == 0`` (``t = tick - 1``: the tick
    counter has been stepped), add a lane's GCS candidates (``want``),
    admitted migrations (``mig``), active transfers (``occ3`` summed),
    waiting files (``wq_wait``) and queued link transfers (``lq_next -
    lq_serve``) to ``counts``, and one counted tick."""
    if (int(tick[0]) - 1) % COUNT_STRIDE:
        return
    L = counts.shape[0]
    counts[:, 0] += want.reshape(L, -1).sum(-1)
    counts[:, 1] += mig.reshape(L, -1).sum(-1)
    counts[:, 2] += occ3.reshape(L, -1).to(torch.int64).sum(-1)
    counts[:, 3] += wq_wait.reshape(L, -1).sum(-1)
    counts[:, 4] += (lq_next - lq_serve).sum(-1)
    counts[:, 5] += 1
