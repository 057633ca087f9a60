"""Resilience schemas: the client's retry policy, hand-authored fault
timelines and chaos-campaign hazard models.

Same contract as the reference's ``schemas/resilience.py`` (``RetryPolicy``,
``FaultEvent``, ``FaultTimeline``, ``FailureDomain``, ``HazardModel``), as
plain dataclasses with explicit validation; unknown fields are refused, as
the reference's ``extra="forbid"`` refuses them.

- :class:`RetryPolicy`: every attempt carries a deadline
  ``request_timeout_s`` after its issue; a timed-out or failed attempt is
  re-issued after ``min(backoff_cap_s, backoff_base_s *
  backoff_multiplier**(k-1))`` seconds times a jitter factor uniform in
  ``[1 - jitter, 1 + jitter]``, at most ``max_attempts`` attempts in all;
  each re-issue spends a token of a bucket of ``budget_tokens`` refilled at
  ``budget_refill_per_s`` (``None``: no budget).
- :class:`FaultEvent`: a window in which a server hard-refuses arrivals
  (``server_outage``), an edge degrades (``edge_degrade``: latency
  multiplied, dropout boosted) or partitions (``edge_partition``).
- :class:`FailureDomain` / :class:`HazardModel`: correlated stochastic
  failure processes (alternating MTBF / MTTR draws per scenario and
  domain), sampled by the compiler into per-scenario fault tables.

The client's hedging and the LB's health gate (the reference's
``HedgePolicy`` and ``LbHealthPolicy``) are not modelled by the port and
are refused by name where they appear.
"""

from __future__ import annotations

from dataclasses import dataclass

from asyncflow_tpu_torch.config.constants import Distribution, FaultKind, RetryDefaults
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas._fields import (
    as_enum,
    as_float,
    as_int,
    as_list,
    as_str,
    check_range,
    read_fields,
)
from asyncflow_tpu_torch.schemas.random_variables import RVConfig

#: duration laws a hazard process draws its MTBF and MTTR from: the
#: distributions with a continuous inverse CDF
HAZARD_DISTRIBUTIONS = frozenset({
    Distribution.EXPONENTIAL,
    Distribution.NORMAL,
    Distribution.LOG_NORMAL,
})


def _duplicates(ids: list[str]) -> list[str]:
    return sorted({i for i in ids if ids.count(i) > 1})


@dataclass
class RetryPolicy:
    """Client-side request timeout and retry / backoff / budget discipline."""

    request_timeout_s: float
    max_attempts: int = RetryDefaults.MAX_ATTEMPTS
    backoff_base_s: float = 0.1
    backoff_multiplier: float = 2.0
    backoff_cap_s: float = 10.0
    jitter: float = 0.0
    budget_tokens: int | None = None
    budget_refill_per_s: float = 0.0

    def __post_init__(self) -> None:
        self.request_timeout_s = as_float(self.request_timeout_s, "request_timeout_s")
        check_range(self.request_timeout_s, "request_timeout_s", gt=0.0)
        self.max_attempts = as_int(self.max_attempts, "max_attempts")
        check_range(self.max_attempts, "max_attempts", ge=1,
                    le=RetryDefaults.MAX_ATTEMPTS_CAP)
        self.backoff_base_s = as_float(self.backoff_base_s, "backoff_base_s")
        check_range(self.backoff_base_s, "backoff_base_s", ge=0.0)
        self.backoff_multiplier = as_float(self.backoff_multiplier, "backoff_multiplier")
        check_range(self.backoff_multiplier, "backoff_multiplier", ge=1.0)
        self.backoff_cap_s = as_float(self.backoff_cap_s, "backoff_cap_s")
        check_range(self.backoff_cap_s, "backoff_cap_s", gt=0.0)
        self.jitter = as_float(self.jitter, "jitter")
        check_range(self.jitter, "jitter", ge=0.0, le=1.0)
        if self.budget_tokens is not None:
            self.budget_tokens = as_int(self.budget_tokens, "budget_tokens")
            check_range(self.budget_tokens, "budget_tokens", gt=0)
        self.budget_refill_per_s = as_float(self.budget_refill_per_s, "budget_refill_per_s")
        check_range(self.budget_refill_per_s, "budget_refill_per_s", ge=0.0)

    def backoff_delay(self, attempt: int) -> float:
        """Nominal (jitter-free) backoff before attempt ``attempt`` (2 is
        the first retry: ``backoff_base_s``)."""
        k = max(attempt - 2, 0)
        return min(float(self.backoff_cap_s),
                   float(self.backoff_base_s) * float(self.backoff_multiplier) ** k)

    @classmethod
    def from_dict(cls, data: object) -> RetryPolicy:
        return cls(
            **read_fields(
                data,
                "retry_policy",
                known=(
                    "request_timeout_s", "max_attempts", "backoff_base_s",
                    "backoff_multiplier", "backoff_cap_s", "jitter", "budget_tokens",
                    "budget_refill_per_s",
                ),
                required=("request_timeout_s",),
            ),
        )


@dataclass
class FaultEvent:
    """One scheduled fault window on a server or an edge."""

    fault_id: str
    kind: FaultKind
    target_id: str
    t_start: float
    t_end: float
    #: edge_degrade only: latency draws are multiplied by this
    latency_factor: float = 1.0
    #: edge_degrade only: added to the edge's dropout (clipped to 1)
    dropout_boost: float = 0.0

    def __post_init__(self) -> None:
        self.fault_id = as_str(self.fault_id, "fault_id")
        self.kind = as_enum(FaultKind, self.kind, "fault kind")
        self.target_id = as_str(self.target_id, "target_id")
        self.t_start = as_float(self.t_start, "t_start")
        check_range(self.t_start, "t_start", ge=0.0)
        self.t_end = as_float(self.t_end, "t_end")
        check_range(self.t_end, "t_end", gt=0.0)
        self.latency_factor = as_float(self.latency_factor, "latency_factor")
        check_range(self.latency_factor, "latency_factor", ge=1.0)
        self.dropout_boost = as_float(self.dropout_boost, "dropout_boost")
        check_range(self.dropout_boost, "dropout_boost", ge=0.0, le=1.0)
        if self.t_start >= self.t_end:
            msg = (f"fault {self.fault_id!r}: t_start={self.t_start} must be smaller than "
                   f"t_end={self.t_end}")
            raise PayloadError(msg)
        degrade = self.latency_factor != 1.0 or self.dropout_boost != 0.0
        if self.kind != FaultKind.EDGE_DEGRADE and degrade:
            msg = (f"fault {self.fault_id!r}: latency_factor/dropout_boost apply only to "
                   "edge_degrade faults")
            raise PayloadError(msg)
        if self.kind == FaultKind.EDGE_DEGRADE and not degrade:
            msg = (f"fault {self.fault_id!r}: edge_degrade needs latency_factor > 1 and/or "
                   "dropout_boost > 0")
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> FaultEvent:
        return cls(
            **read_fields(
                data,
                "fault event",
                known=("fault_id", "kind", "target_id", "t_start", "t_end",
                       "latency_factor", "dropout_boost"),
                required=("fault_id", "kind", "target_id", "t_start", "t_end"),
            ),
        )


@dataclass
class FaultTimeline:
    """The scenario's scheduled faults; their ids are unique."""

    events: list[FaultEvent]

    def __post_init__(self) -> None:
        dup = _duplicates([event.fault_id for event in self.events])
        if dup:
            msg = f"duplicate fault ids: {dup}"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> FaultTimeline:
        f = read_fields(data, "fault_timeline", known=("events",), required=("events",))
        return cls(events=[FaultEvent.from_dict(e) for e in as_list(f["events"], "events")])


@dataclass
class FailureDomain:
    """One correlated stochastic failure process: every target fails
    together, its windows an alternating recurrence of MTBF and MTTR
    draws; server targets go dark, edge targets degrade by
    ``latency_factor`` / ``dropout_boost``."""

    domain_id: str
    targets: list[str]
    mtbf: RVConfig
    mttr: RVConfig
    latency_factor: float = 1.0
    dropout_boost: float = 0.0

    def __post_init__(self) -> None:
        self.domain_id = as_str(self.domain_id, "domain_id")
        self.targets = [as_str(t, "failure-domain target") for t in self.targets]
        self.latency_factor = as_float(self.latency_factor, "latency_factor")
        check_range(self.latency_factor, "latency_factor", ge=1.0)
        self.dropout_boost = as_float(self.dropout_boost, "dropout_boost")
        check_range(self.dropout_boost, "dropout_boost", ge=0.0, le=1.0)
        where = f"failure domain {self.domain_id!r}"
        if not self.targets:
            msg = f"{where}: targets must be non-empty"
            raise PayloadError(msg)
        dup = _duplicates(self.targets)
        if dup:
            msg = f"{where}: duplicate targets {dup}"
            raise PayloadError(msg)
        for name, rv in (("mtbf", self.mtbf), ("mttr", self.mttr)):
            if rv.distribution not in HAZARD_DISTRIBUTIONS:
                allowed = sorted(d.value for d in HAZARD_DISTRIBUTIONS)
                msg = (f"{where}: {name} distribution {rv.distribution.value!r} is not a "
                       f"duration law; pick one of {allowed}")
                raise PayloadError(msg)
            if rv.mean <= 0:
                msg = f"{where}: {name} mean must be > 0, got {rv.mean}"
                raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> FailureDomain:
        f = read_fields(
            data,
            "failure domain",
            known=("domain_id", "targets", "mtbf", "mttr", "latency_factor", "dropout_boost"),
            required=("domain_id", "targets", "mtbf", "mttr"),
        )
        f["targets"] = as_list(f["targets"], "targets")
        f["mtbf"] = RVConfig.from_dict(f["mtbf"], "mtbf")
        f["mttr"] = RVConfig.from_dict(f["mttr"], "mttr")
        return cls(**f)


@dataclass
class HazardModel:
    """A chaos campaign: failure domains and the fault-window slots each
    (scenario, domain) gets in the lowered tables (windows past them are
    counted as truncated, never dropped silently)."""

    domains: list[FailureDomain]
    max_faults_per_component: int = 4

    def __post_init__(self) -> None:
        self.max_faults_per_component = as_int(self.max_faults_per_component,
                                               "max_faults_per_component")
        check_range(self.max_faults_per_component, "max_faults_per_component", gt=0, le=64)
        if not self.domains:
            msg = "hazard model: domains must be non-empty"
            raise PayloadError(msg)
        dup = _duplicates([d.domain_id for d in self.domains])
        if dup:
            msg = f"duplicate failure-domain ids: {dup}"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> HazardModel:
        f = read_fields(data, "hazard_model", known=("domains", "max_faults_per_component"),
                        required=("domains",))
        f["domains"] = [FailureDomain.from_dict(d) for d in as_list(f["domains"], "domains")]
        return cls(**f)
