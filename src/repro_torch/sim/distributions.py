"""Bounded random samplers of the paper's fitted parameters (Tables 1/3),
copied from ``repro.sim.distributions``.

File sizes are exponential in GiB, bounds are clamps on the sampled value,
per-tick count rates are a normal truncated below at 0, and
``FractionalCounter`` turns real-valued per-tick samples into integer
counts whose long-run rate is the sample mean (the remainder carries to
the next tick). The draws go through the caller's ``numpy`` generator in
``repro``'s order, so packed grids and event-engine runs stay
bit-identical to ``repro``'s.
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

    @property
    def mean(self) -> float:
        """Mean of the clamped distribution (for napkin math/tests)."""
        lam, lo, hi = self.lam, self.lo, self.hi
        if not np.isfinite(hi):
            return (lo + 1.0 / lam) * self.unit
        # E[min(max(X, lo), hi)] for X ~ Exp(lam), lo ~ 0 assumed small.
        return (1.0 / lam - (hi - lo) / np.expm1(lam * (hi - lo)) + lo) * self.unit


class BoundedGeometric:
    """Geometric (support {1, 2, ...}), clamped to [lo, hi).

    HCDC popularity: p = 0.1, 1 <= x < 50 (Table 3).
    """

    def __init__(self, p: float, lo: int = 1, hi: int = 50):
        self.p = p
        self.lo = lo
        self.hi = hi

    def sample(self, rng: np.random.Generator, n: int | None = None):
        x = rng.geometric(self.p, size=n)
        return np.clip(x, self.lo, self.hi - 1)


class TruncatedNormalCount:
    """Normal(mu, sigma) truncated below at 0 — per-tick count rates."""

    def __init__(self, mu: float, sigma: float):
        self.mu = mu
        self.sigma = sigma

    def sample(self, rng: np.random.Generator, n: int | None = None):
        x = rng.normal(self.mu, self.sigma, size=n)
        return np.maximum(x, 0.0)

    @property
    def mean(self) -> float:
        from math import erf, exp, pi, sqrt

        a = self.mu / self.sigma
        phi = exp(-0.5 * a * a) / sqrt(2 * pi)
        Phi = 0.5 * (1 + erf(a / sqrt(2)))
        return self.mu * Phi + self.sigma * phi


class FractionalCounter:
    """Emit integer counts whose long-run rate equals the sampled mean.

    ``emit(x)`` adds the real sample to an accumulator and returns the
    integer part, carrying the remainder — the only carry rule that
    reproduces the reported long-run rates exactly (Table 2's 1.80
    transfers/10 s, Table 6's 996k submitted jobs).
    """

    def __init__(self) -> None:
        self.acc = 0.0

    def emit(self, x: float) -> int:
        self.acc += float(x)
        n = int(self.acc)
        self.acc -= n
        return n
