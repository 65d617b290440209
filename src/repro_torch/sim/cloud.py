"""Cloud cost model (paper §4.1/§5.3), copied from ``repro.sim.cloud``.

Pricing is GCP's public table of 2020-09-10 (standard class, regional,
Europe): storage per GB-month integrated over byte-seconds, tiered internet
egress (0-1 TiB 0.12, 1-10 TiB 0.11, >10 TiB 0.08 USD/GiB/month) or a flat
peering price (direct 0.05, interconnect 0.02), class A/B operations. The
batched program accumulates the raw quantities per 30-day month on the
device; ``bills_from_monthly_totals`` folds them into ``MonthlyBill``s.
``GCSBucket`` (the event engine's storage element) is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.sim.infrastructure import GiB

MONTH_SECONDS = 30 * 24 * 3600

#: Flat egress prices (USD/GiB) for the paper's §5.3 peering alternatives
#: to tiered internet egress.
PEERING_PRICES = {"direct": 0.05, "interconnect": 0.02}


@dataclass
class GCSCostModel:
    """GCP price table (USD), 2020-09-10 snapshot."""

    storage_per_gb_month: float = 0.026
    # (tier upper bound in bytes/month, USD per GiB) — internet egress.
    egress_tiers: Tuple[Tuple[float, float], ...] = (
        (1 * 1024.0**4, 0.12),
        (10 * 1024.0**4, 0.11),
        (float("inf"), 0.08),
    )
    class_a_per_10k: float = 0.05
    class_b_per_10k: float = 0.004
    peering: Optional[str] = None  # None | "direct" | "interconnect"
    #: Flat egress price override (USD/GiB); takes precedence over both the
    #: peering table and the internet tiers.
    flat_egress_per_gib: Optional[float] = None

    def egress_cost(self, monthly_bytes: float) -> float:
        if self.flat_egress_per_gib is not None:
            return self.flat_egress_per_gib * monthly_bytes / GiB
        if self.peering is not None:
            return PEERING_PRICES[self.peering] * monthly_bytes / GiB
        cost, prev, left = 0.0, 0.0, monthly_bytes
        for bound, price in self.egress_tiers:
            span = min(left, bound - prev)
            if span <= 0:
                break
            cost += price * span / GiB
            left -= span
            prev = bound
        return cost

    def storage_cost(self, gb_seconds: float) -> float:
        return self.storage_per_gb_month * gb_seconds / MONTH_SECONDS

    def ops_cost(self, class_a: int, class_b: int) -> float:
        return class_a / 1e4 * self.class_a_per_10k + class_b / 1e4 * self.class_b_per_10k


@dataclass
class MonthlyBill:
    storage_usd: float = 0.0
    network_usd: float = 0.0
    ops_usd: float = 0.0


def sum_bills(bills: List[MonthlyBill]) -> MonthlyBill:
    """Aggregate monthly bills into one run-total bill."""
    return MonthlyBill(
        storage_usd=sum(b.storage_usd for b in bills),
        network_usd=sum(b.network_usd for b in bills),
        ops_usd=sum(b.ops_usd for b in bills),
    )


def bills_from_monthly_totals(cost_model: GCSCostModel,
                              gb_seconds: Sequence[float],
                              egress_bytes: Sequence[float],
                              class_a: Sequence[float],
                              class_b: Sequence[float],
                              full_months: int) -> List[MonthlyBill]:
    """Fold per-month aggregate arrays into ``MonthlyBill``s.

    Every *complete* month produces a bill (even an all-zero one), while a
    trailing partial month is billed only if it saw any stored volume or
    egress — the event engine's bucket emission rule.
    """
    bills: List[MonthlyBill] = []
    for i in range(len(gb_seconds)):
        if i >= full_months and gb_seconds[i] <= 0 and egress_bytes[i] <= 0:
            continue
        bills.append(MonthlyBill(
            storage_usd=cost_model.storage_cost(float(gb_seconds[i])),
            network_usd=cost_model.egress_cost(float(egress_bytes[i])),
            ops_usd=cost_model.ops_cost(int(round(float(class_a[i]))),
                                        int(round(float(class_b[i])))),
        ))
    return bills
