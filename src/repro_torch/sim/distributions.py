"""Bounded random samplers of the paper's fitted parameters (Tables 1/3).

A copy of ``BoundedExponential`` and ``TruncatedNormalCount`` from
``repro.sim.distributions``: file sizes are exponential in GiB, bounds are
clamps on the sampled value, per-tick count rates are a normal truncated
below at 0. The draws go through the caller's ``numpy`` generator in the
same order, so packed grids stay bit-identical to ``repro``'s.
"""

from __future__ import annotations

import numpy as np


class BoundedExponential:
    """Exponential with rate ``lam`` (mean 1/lam), clamped to [lo, hi]."""

    def __init__(self, lam: float, lo: float = 0.0, hi: float = np.inf,
                 unit: float = 1.0):
        self.lam = lam
        self.lo = lo
        self.hi = hi
        self.unit = unit  # multiply samples by this (e.g. GiB)

    def sample(self, rng: np.random.Generator, n: int | None = None):
        x = rng.exponential(1.0 / self.lam, size=n)
        return np.clip(x, self.lo, self.hi) * self.unit


class TruncatedNormalCount:
    """Normal(mu, sigma) truncated below at 0 — per-tick count rates."""

    def __init__(self, mu: float, sigma: float):
        self.mu = mu
        self.sigma = sigma

    def sample(self, rng: np.random.Generator, n: int | None = None):
        x = rng.normal(self.mu, self.sigma, size=n)
        return np.maximum(x, 0.0)
