"""Order-statistic (binomial) confidence intervals on pooled latency
quantiles: the port's copy of the part of the reference's
``analysis/estimators.py`` that ``SweepReport`` uses (``IntervalEstimate``,
``binomial_rank_bounds``, ``pooled_quantile_ci``).  The interval is the
distribution-free one on the quantile of the pooled request population
across scenarios; it needs only the per-scenario latency histograms a sweep
already brings to the host.  The scenario-resampling bootstrap estimators
are not ported yet."""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

from asyncflow_tpu_torch.engines.results import hist_percentile


@dataclass(frozen=True)
class IntervalEstimate:
    """A point estimate with a two-sided confidence interval.  ``n_excluded``
    counts scenarios left out before estimation (0: the port quarantines
    none)."""

    point: float
    lo: float
    hi: float
    level: float
    n: int
    method: str
    n_excluded: int = 0

    @property
    def half_width(self) -> float:
        """Half the interval's width (NaN from an empty ensemble)."""
        return (self.hi - self.lo) / 2.0

    def meets(self, half_width: float, *, relative: bool = False) -> bool:
        """Does the interval resolve the metric to ``half_width``?"""
        hw = self.half_width
        if not math.isfinite(hw):
            return False
        if relative:
            scale = abs(self.point)
            return hw <= half_width * scale if scale > 0 else hw == 0.0
        return hw <= half_width

    def as_dict(self) -> dict:
        return {
            "point": self.point,
            "lo": self.lo,
            "hi": self.hi,
            "level": self.level,
            "n": self.n,
            "method": self.method,
            "half_width": self.half_width,
            "n_excluded": self.n_excluded,
        }


def _nan_interval(level: float, method: str) -> IntervalEstimate:
    nan = float("nan")
    return IntervalEstimate(nan, nan, nan, level, 0, method)


def _check_level(level: float) -> None:
    if not 0.0 < level < 1.0:
        msg = f"confidence level must be in (0, 1), got {level}"
        raise ValueError(msg)


def binomial_rank_bounds(n: int, p: float, level: float) -> tuple[int, int]:
    """1-indexed order-statistic ranks (r, s) with ``P(x_(r) <= xi_p <=
    x_(s)) >= level`` for n i.i.d. draws: exact binomial-CDF inversion up to
    n = 2000, the normal approximation to Bin(n, p) past it; clamped into
    [1, n]."""
    _check_level(level)
    if n < 1:
        msg = f"need at least one observation, got n={n}"
        raise ValueError(msg)
    alpha = 1.0 - level
    if n <= 2000:
        k = np.arange(n + 1, dtype=np.float64)
        lg = np.vectorize(math.lgamma)
        logpmf = (
            lg(n + 1.0)
            - lg(k + 1.0)
            - lg(n - k + 1.0)
            + k * math.log(max(p, 1e-300))
            + (n - k) * math.log1p(-min(p, 1.0 - 1e-16))
        )
        cdf = np.cumsum(np.exp(logpmf))
        # the largest r with F(r-1) <= alpha/2; the smallest s with F(s-1) >= 1-alpha/2
        r = int(np.searchsorted(cdf, alpha / 2.0, side="right"))
        s = int(np.searchsorted(cdf, 1.0 - alpha / 2.0, side="left")) + 1
    else:
        z = NormalDist().inv_cdf(1.0 - alpha / 2.0)
        mu = n * p
        sd = math.sqrt(n * p * (1.0 - p))
        r = int(math.floor(mu - z * sd))
        s = int(math.ceil(mu + z * sd)) + 1
    return max(r, 1), min(s, n)


def pooled_quantile_ci(
    counts: np.ndarray,
    edges: np.ndarray,
    q: float,
    level: float = 0.95,
) -> IntervalEstimate:
    """Order-statistic CI on the pooled latency quantile ``q`` (percent):
    ``counts`` is the (S, B) histogram stack (or a pooled (B,) row); the
    binomial rank bounds map through the pooled histogram's inverse CDF, so
    the resolution is one log bin."""
    _check_level(level)
    counts = np.asarray(counts, np.float64)
    pooled = counts.sum(axis=0) if counts.ndim == 2 else counts
    n = int(round(float(pooled.sum())))
    if n == 0:
        return _nan_interval(level, "order-statistic")
    point = float(hist_percentile(pooled, edges, q))
    r, s = binomial_rank_bounds(n, q / 100.0, level)
    lo = float(hist_percentile(pooled, edges, 100.0 * r / n))
    hi = float(hist_percentile(pooled, edges, 100.0 * s / n))
    return IntervalEstimate(point, lo, hi, level, n, "order-statistic")
