"""The comparison that decides ``correct``: the sweep's results against
the reference's for the same specs.

Each spec is compared on everything the sweep reports for it: every
metric, the storage, network and operations bills and the raw monthly
quantities (GB-seconds, egress bytes, class A and B operations). Three
numbers come out, each held to its limit:

- ``missing``: specs the sweep returned no result for (limit 0);
- ``draws_off``: specs whose submitted-job count, drawn by the packer
  from the seed, differs from the reference's (exact, limit 0);
- ``gap``: the widest relative gap ``|a - b| / max(|a|, |b|)`` over every
  compared number of every spec (0 where both are 0).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

#: The limits of the numbers compared.
LIMITS = {"missing": 0, "draws_off": 0, "gap": 1e-3}


def flatten(result: Dict) -> Dict[str, float]:
    """One spec's numbers under flat names."""
    out = {f"metrics.{k}": float(v) for k, v in result["metrics"].items()}
    for k in ("storage_usd", "network_usd", "ops_usd"):
        out[k] = float(result[k])
    for k, vals in result["monthly"].items():
        if isinstance(vals, list):
            for i, v in enumerate(vals):
                out[f"monthly.{k}.{i}"] = float(v)
    return out


def rel_gap(a: float, b: float) -> float:
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return 1.0
    return abs(a - b) / max(abs(a), abs(b))


def compare(got: Sequence, want: Sequence[Dict]
            ) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """``got``: the sweep's results (dicts as :func:`flatten` reads, or
    ``None`` for a spec with no result), ``want``: the reference's, spec
    by spec. Returns ``{name: (value, limit)}`` and the worst few gaps
    named, for the log."""
    missing = draws_off = 0
    gap = 0.0
    worst: List[Tuple[float, str]] = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            missing += 1
            continue
        fg, fw = flatten(g), flatten(w)
        if fg.get("metrics.jobs_submitted") != fw["metrics.jobs_submitted"]:
            draws_off += 1
        for key, b in fw.items():
            a = fg.get(key, float("nan"))
            r = rel_gap(a, b)
            if r > 0:
                worst.append((r, f"spec {i} {key}: {a!r} vs {b!r}"))
            gap = max(gap, r)
        if set(fg) - set(fw):
            gap = 1.0
            worst.append((1.0, f"spec {i}: keys the reference lacks "
                               f"{sorted(set(fg) - set(fw))[:3]}"))
    missing += max(0, len(want) - len(got))
    numbers = {"missing": (missing, LIMITS["missing"]),
               "draws_off": (draws_off, LIMITS["draws_off"]),
               "gap": (gap, LIMITS["gap"])}
    worst.sort(reverse=True)
    return numbers, [w for _, w in worst[:5]]


def is_correct(numbers: Dict[str, Tuple[float, float]]) -> bool:
    return all(v <= lim for v, lim in numbers.values())
