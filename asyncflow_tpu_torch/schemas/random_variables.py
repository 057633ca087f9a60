"""Random-variable configuration shared by workload and edge latencies.

Same contract as the reference ``RVConfig``: ``mean`` is numeric, and
``variance`` defaults to ``mean`` for the distributions that need one
(normal, log-normal).
"""

from __future__ import annotations

from dataclasses import dataclass

from asyncflow_tpu_torch.config.constants import Distribution
from asyncflow_tpu_torch.schemas._fields import as_enum, as_float, read_fields

_NEEDS_VARIANCE = frozenset({Distribution.NORMAL, Distribution.LOG_NORMAL})


@dataclass
class RVConfig:
    """Declarative description of a scalar random variable."""

    mean: float
    distribution: Distribution = Distribution.POISSON
    variance: float | None = None

    def __post_init__(self) -> None:
        self.mean = as_float(self.mean, "mean")
        self.distribution = as_enum(Distribution, self.distribution, "distribution")
        if self.variance is not None:
            self.variance = as_float(self.variance, "variance")
        elif self.distribution in _NEEDS_VARIANCE:
            self.variance = self.mean

    @classmethod
    def from_dict(cls, data: object, where: str = "random variable") -> RVConfig:
        f = read_fields(
            data,
            where,
            known=("mean", "distribution", "variance"),
            required=("mean",),
        )
        return cls(**f)
