"""What the program's traced tick records, as the per-layer readers take
it: the ``sweep.torch.tick`` instants a traced loop of the card records
(``repro_torch.sim.batched.TickLoop``: each tick segment's device
nanoseconds, stamped with ``%globaltimer``, and the counts of the tick's
work) and the host spans of the port's front door and tick program
(``tick.setup``, ``tick.replays``, ``billing``), each under its call's
``root``. Each reading returns ``None`` where the run recorded none of
what it reads (a program without the tracing, or a run on the CPU, whose
stamps read the host clock).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

TICK = "sweep.torch.tick"

#: The tick's segments by layer (the lane-tick kernels, the tick-glue
#: kernels, PyTorch's own operations), as the traced tick stamps them.
LANE_TICK = ("transfer", "gcs_admit", "windows_admit")
GLUE = ("begin", "complete_link", "migrate", "wait_select")
TORCH_OPS = ("clock", "transfer_adds", "gcs_copy", "job_window",
             "window_gather", "plan_apply")


def device_ticks(run) -> List[Dict]:
    """The args of the window's ``sweep.torch.tick`` instants stamped by
    the card's clock."""
    return [e["args"] for e in run.record.get("events", [])
            if e.get("name") == TICK
            and e.get("args", {}).get("clock") == "globaltimer"]


def segments_us(run, names: Iterable[str]) -> Optional[float]:
    """Device microseconds a stamped tick in the segments ``names``: their
    sums over every traced loop of the window over the ticks stamped."""
    ticks = device_ticks(run)
    n = sum(a["ticks"] for a in ticks)
    if not n or any(name not in a["segments"] for a in ticks
                    for name in names):
        return None
    return sum(a["segments"][name]["sum_ns"] for a in ticks
               for name in names) / n / 1e3


def replay_gap_us(run) -> Optional[float]:
    """Device microseconds from a stamped tick's end to the next one's
    start, the mean over every gap the window stamped."""
    ticks = device_ticks(run)
    n = sum(a["replay_gap"]["n"] for a in ticks)
    if not n:
        return None
    return sum(a["replay_gap"]["sum_ns"] for a in ticks) / n / 1e3


def per_lane_tick(run, key: str) -> Optional[float]:
    """A count of the tick's work (``key``) a lane a counted tick, over
    every traced loop of the window."""
    ticks = device_ticks(run)
    n = sum(a["lane_ticks"] for a in ticks)
    if not n or any(key not in a["counts"] for a in ticks):
        return None
    return sum(a["counts"][key] for a in ticks) / n


def card_calls(run) -> set:
    """The roots of the window's calls that ran the ``cuda`` tick (their
    ``sweep.torch`` instants)."""
    return {e["args"].get("root") for e in run.record.get("events", [])
            if e.get("name") == "sweep.torch"
            and e["args"].get("tick_impl") == "cuda"} - {None}


def ms_a_call(run, name: str, calls: set, **match) -> Optional[float]:
    """The mean over ``calls`` (roots) of the summed durations of their
    spans ``name`` whose args hold ``match``, in ms."""
    per: Dict = {}
    for e in run.record.get("events", []):
        a = e.get("args", {})
        if (e.get("name") == name and e.get("ph") == "X"
                and a.get("root") in calls
                and all(a.get(k) == v for k, v in match.items())):
            per[a["root"]] = per.get(a["root"], 0) + e["dur"]
    if not per:
        return None
    return sum(per.values()) / len(per) / 1e3
