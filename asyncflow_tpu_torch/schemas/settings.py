"""Global simulation settings schema (same contract as the reference)."""

from __future__ import annotations

from dataclasses import dataclass, field

from asyncflow_tpu_torch.config.constants import (
    EventMetricName,
    SampledMetricName,
    SamplePeriods,
    TimeDefaults,
)
from asyncflow_tpu_torch.schemas._fields import (
    as_enum,
    as_float,
    as_int,
    as_list,
    check_range,
    read_fields,
)


def _default_sample_metrics() -> set[SampledMetricName]:
    return set(SampledMetricName)


@dataclass
class SimulationSettings:
    """Parameters that apply to the whole run.  The metric sets are
    accepted for file compatibility; sweeps collect their own outputs."""

    total_simulation_time: int = TimeDefaults.SIMULATION_TIME
    sample_period_s: float = SamplePeriods.STANDARD_TIME
    enabled_sample_metrics: set[SampledMetricName] = field(
        default_factory=_default_sample_metrics,
    )
    enabled_event_metrics: set[EventMetricName] = field(
        default_factory=lambda: {EventMetricName.RQS_CLOCK},
    )

    def __post_init__(self) -> None:
        self.total_simulation_time = as_int(
            self.total_simulation_time, "total_simulation_time",
        )
        check_range(
            self.total_simulation_time,
            "total_simulation_time",
            ge=TimeDefaults.MIN_SIMULATION_TIME,
        )
        self.sample_period_s = as_float(self.sample_period_s, "sample_period_s")
        check_range(
            self.sample_period_s,
            "sample_period_s",
            ge=SamplePeriods.MINIMUM_TIME,
            le=SamplePeriods.MAXIMUM_TIME,
        )
        self.enabled_sample_metrics = {
            as_enum(SampledMetricName, m, "enabled_sample_metrics")
            for m in as_list(list(self.enabled_sample_metrics), "enabled_sample_metrics")
        }
        self.enabled_event_metrics = {
            as_enum(EventMetricName, m, "enabled_event_metrics")
            for m in as_list(list(self.enabled_event_metrics), "enabled_event_metrics")
        }

    @classmethod
    def from_dict(cls, data: object) -> SimulationSettings:
        return cls(
            **read_fields(
                data,
                "sim_settings",
                known=(
                    "total_simulation_time",
                    "sample_period_s",
                    "enabled_sample_metrics",
                    "enabled_event_metrics",
                ),
            ),
        )
