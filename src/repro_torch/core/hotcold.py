"""Hot/cold storage policies (paper §2.2 and §6), copied from
``repro.core.hotcold``.

``MigrationPolicy`` decides which evicted hot-tier files migrate to the
cold tier, ``ColdDeletionPolicy`` how the cold tier is trimmed (the batched
program rejects trimming, as ``repro``'s does), ``PopularityModel`` the
static popularity draw and the selection CDF both packers share.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class MigrationPolicy:
    """Hot -> cold migration decision at hot-tier eviction time.

    ``min_popularity``: only migrate data at least this popular. 0 =
    migrate everything (the paper's implemented variation).
    """

    min_popularity: int = 0


@dataclass
class ColdDeletionPolicy:
    """Cold-tier trimming (paper §6). Disabled when ``capacity_threshold``
    is None (the paper's configuration III)."""

    capacity_threshold: Optional[float] = None  # fraction of the limit


@dataclass
class PopularityModel:
    """Static popularity assignment (paper Table 3) + selection weighting.

    Jobs select input files with probability proportional to
    ``popularity ** selection_power`` (gamma = 3.5, calibrated to Table 7).
    A ``ZipfDrift`` workload overrides the power per generator tick.
    """

    p: float = 0.1
    lo: int = 1
    hi: int = 50
    selection_power: float = 3.5

    def sample_popularity(self, rng, n: int):
        return np.clip(rng.geometric(self.p, n), self.lo, self.hi - 1)

    def selection_weights(self, popularity, power: Optional[float] = None):
        p = self.selection_power if power is None else power
        return popularity.astype(float) ** p

    def selection_cdf(self, popularity, power: Optional[float] = None):
        """Normalized selection CDF for inverse-transform file draws
        (``searchsorted(cdf, u, side="right")``)."""
        cw = np.cumsum(self.selection_weights(popularity, power))
        return cw / cw[-1]
