"""Monte-Carlo interval estimators over sweep ensembles (the port's subset of
the reference's ``analysis`` package)."""

from asyncflow_tpu_torch.analysis.estimators import (
    IntervalEstimate,
    binomial_rank_bounds,
    pooled_quantile_ci,
)

__all__ = ["IntervalEstimate", "binomial_rank_bounds", "pooled_quantile_ci"]
