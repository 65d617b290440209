"""The benchmark's one traffic generator: a traffic file's axes and a
seed into the spec grid of each call.

A traffic file (``portbench/traffic/<name>.json``) names the runner that
runs it and the grid of one call: the cache sizes, egress options and
storage prices swept, the seeds a call draws (``seeds_per_call``) and the
workload (``{"name": "steady"}`` or a named shape with its parameters:
``diurnal``, ``campaign``, ``zipf-drift``).
Call ``i`` of a run with seed ``s`` simulates lanes seeded from
``(s, i)``: no two calls share a lane, and a seed gives the same calls in
every run. Call 0 is set-up's warm call, never part of a window.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np


def call_seeds(seed: int, call: int, n: int) -> List[int]:
    """``n`` distinct lane seeds of call ``call`` of a run seeded ``seed``
    (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, int(call)])
    out: List[int] = []
    words = 2 * n
    while len(out) < n:
        state = ss.generate_state(words, np.uint64)
        out = list(dict.fromkeys(int(x) % 2 ** 63 for x in state))[:n]
        words *= 2
    return out


def call_specs(traffic: Dict, seed: int, call: int) -> List[Dict]:
    """The specs of one call, in the order the sweep receives them: cache
    size, egress, storage price, then the call's seeds fastest."""
    seeds = call_seeds(seed, call, int(traffic["seeds_per_call"]))
    wl = traffic.get("workload", {"name": "steady"})
    return [{"seed": s, "cache_tb": c, "egress": e, "storage_price": p,
             "workload": wl}
            for c, e, p in itertools.product(
                traffic["cache_tb"], traffic.get("egress", ["internet"]),
                traffic.get("storage_price", [None]))
            for s in seeds]
