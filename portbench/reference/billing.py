"""The bill of a simulated lane, frozen for the benchmark: the monthly
cloud quantities of a lane priced under one spec's cost model, and the
per-spec metrics of the sweep's results.

Pricing is the configuration's table (standard storage per GB-month over
the integrated GB-seconds, tiered internet egress or a flat peering price
per GiB, class A and B operations per 10,000). Every complete 30-day
month is billed; a trailing partial month only when it stored or sent
anything.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.reference.packer import GiB, MONTH_SECONDS


def egress_cost(prices: Dict, egress: str, monthly_bytes: float) -> float:
    if egress != "internet":
        return prices["peering_per_gib"][egress] * monthly_bytes / GiB
    cost, prev, left = 0.0, 0.0, monthly_bytes
    for bound, price in prices["egress_tiers"]:
        bound = float("inf") if bound is None else bound * 1024.0 ** 4
        span = min(left, bound - prev)
        if span <= 0:
            break
        cost += price * span / GiB
        left -= span
        prev = bound
    return cost


def bills(prices: Dict, spec: Dict, gbsec, egress, cls_a, cls_b,
          full_months: int) -> List[Dict[str, float]]:
    storage = spec.get("storage_price")
    if storage is None:
        storage = prices["storage_per_gb_month"]
    out = []
    for i in range(len(gbsec)):
        if i >= full_months and gbsec[i] <= 0 and egress[i] <= 0:
            continue
        a = int(round(float(cls_a[i])))
        b = int(round(float(cls_b[i])))
        out.append({
            "storage_usd": storage * float(gbsec[i]) / MONTH_SECONDS,
            "network_usd": egress_cost(prices, spec.get("egress", "internet"),
                                       float(egress[i])),
            "ops_usd": (a / 1e4 * prices["class_a_per_10k"]
                        + b / 1e4 * prices["class_b_per_10k"]),
        })
    return out


def results(cfg: Dict, grid, out: Dict[str, np.ndarray]) -> List[Dict]:
    """Each spec of ``grid`` as the sweep reports it: ``metrics``, the
    three bills' sums and the raw ``monthly`` quantities."""
    res = []
    for si, spec in enumerate(grid.specs):
        li = int(grid.lane_of[si])
        jobs_site = out["jobs_done_site"][li]
        m = {
            "jobs_done": float(jobs_site.sum()),
            "jobs_submitted": float(grid.n_jobs[li].sum()),
            "download_pb": float(out["download_b"][li].sum()) / 1e15,
            "gcs_to_disk_pb": float(out["gcsdisk_b"][li].sum()) / 1e15,
            "disk_to_gcs_pb": float(out["diskgcs_b"][li].sum()) / 1e15,
            "gcs_used_pb": float(out["gcs_used"][li]) / 1e15,
            "job_waiting_h_mean": (float(out["wait_h_sum"][li])
                                   / max(float(out["wait_n"][li]), 1.0)),
        }
        for s, name in enumerate(grid.site_names):
            m[f"{name}.tape_to_disk_pb"] = float(out["tape_b"][li, s]) / 1e15
            m[f"{name}.jobs_done"] = float(jobs_site[s])
            m[f"{name}.disk_used_pb"] = float(out["disk_used"][li, s]) / 1e15
        bl = bills(cfg["prices"], spec, out["gbsec_mo"][li],
                   out["egress_mo"][li], out["cls_a_mo"][li],
                   out["cls_b_mo"][li], grid.full_months)
        for i, b in enumerate(bl):
            m[f"month{i+1}.storage_usd"] = b["storage_usd"]
            m[f"month{i+1}.network_usd"] = b["network_usd"]
        res.append({
            "metrics": m,
            "storage_usd": sum(b["storage_usd"] for b in bl),
            "network_usd": sum(b["network_usd"] for b in bl),
            "ops_usd": sum(b["ops_usd"] for b in bl),
            "monthly": {
                "gb_seconds": [float(x) for x in out["gbsec_mo"][li]],
                "egress_bytes": [float(x) for x in out["egress_mo"][li]],
                "class_a": [float(x) for x in out["cls_a_mo"][li]],
                "class_b": [float(x) for x in out["cls_b_mo"][li]],
            },
        })
    return res
