"""Endpoint and step schemas: the per-request program a server executes.

Same contract as the reference ``Step`` / ``Endpoint``: a step carries
exactly one positive quantity whose key agrees with the step kind (CPU <->
cpu_time, RAM <-> necessary_ram, I/O <-> io_waiting_time), and endpoint
names are lowercased.  An ``io_cache`` step may carry hit/miss dynamics
(``cache_hit_probability`` and ``cache_miss_time``, together) and an
``io_llm`` step LLM call dynamics (``llm_tokens_mean``,
``llm_time_per_token`` and ``llm_cost_per_token``, together), with the
reference's validators and messages; any other I/O step is a plain sleep.
``llm_serve`` steps (the serving subsystem) are refused by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from asyncflow_tpu_torch.config.constants import (
    EndpointStepCPU,
    EndpointStepIO,
    EndpointStepRAM,
    StepOperation,
)
from asyncflow_tpu_torch.errors import PayloadError, UnsupportedFeatureError
from asyncflow_tpu_torch.schemas._fields import (
    as_float,
    as_list,
    as_str,
    check_range,
    read_fields,
)

StepKind = EndpointStepIO | EndpointStepCPU | EndpointStepRAM

_EXPECTED_OPERATION: dict[type, StepOperation] = {
    EndpointStepCPU: StepOperation.CPU_TIME,
    EndpointStepRAM: StepOperation.NECESSARY_RAM,
    EndpointStepIO: StepOperation.IO_WAITING_TIME,
}

_CACHE_FIELDS = ("cache_hit_probability", "cache_miss_time")
_LLM_FIELDS = ("llm_tokens_mean", "llm_time_per_token", "llm_cost_per_token")


def _step_kind(value: object) -> StepKind:
    if value == "llm_serve":
        raise UnsupportedFeatureError("llm_serve", "endpoint step")
    for enum_cls in (EndpointStepIO, EndpointStepCPU, EndpointStepRAM):
        try:
            return enum_cls(value)
        except ValueError:
            continue
    msg = f"unknown step kind {value!r}"
    raise PayloadError(msg)


@dataclass
class Step:
    """One unit of work inside an endpoint."""

    kind: StepKind
    step_operation: dict[StepOperation, float]
    #: hit/miss mixture of an io_cache step: the step sleeps its
    #: io_waiting_time (the hit latency) with this probability, else
    #: cache_miss_time, drawn per request
    cache_hit_probability: float | None = None
    cache_miss_time: float | None = None
    #: LLM call dynamics of an io_llm step: output tokens ~
    #: Poisson(llm_tokens_mean); the sleep is io_waiting_time + tokens *
    #: llm_time_per_token, and the request accrues tokens * llm_cost_per_token
    llm_tokens_mean: float | None = None
    llm_time_per_token: float | None = None
    llm_cost_per_token: float | None = None

    def __post_init__(self) -> None:
        self.kind = _step_kind(self.kind)
        if not isinstance(self.step_operation, dict) or not self.step_operation:
            msg = "step_operation cannot be empty"
            raise PayloadError(msg)
        if len(self.step_operation) != 1:
            msg = "step_operation must contain exactly one entry"
            raise PayloadError(msg)
        ((key, value),) = self.step_operation.items()
        try:
            op = StepOperation(key)
        except ValueError:
            msg = f"unknown step operation {key!r}"
            raise PayloadError(msg) from None
        for kind_cls, expected in _EXPECTED_OPERATION.items():
            if isinstance(self.kind, kind_cls) and op != expected:
                msg = (
                    f"A step of kind '{self.kind}' must use exactly "
                    f"the '{expected}' operation"
                )
                raise PayloadError(msg)
        quantity = as_float(value, f"{op}")
        check_range(quantity, f"{op}", gt=0.0)
        self.step_operation = {op: quantity}
        for name in (*_CACHE_FIELDS, *_LLM_FIELDS):
            if getattr(self, name) is not None:
                setattr(self, name, as_float(getattr(self, name), name))
        for name in ("cache_miss_time", "llm_tokens_mean"):
            if getattr(self, name) is not None:
                check_range(getattr(self, name), name, gt=0.0)
        self._check_cache_fields()
        self._check_llm_fields()

    def _check_cache_fields(self) -> None:
        """The reference's ``_cache_fields_coherent``."""
        has_p = self.cache_hit_probability is not None
        has_m = self.cache_miss_time is not None
        if not has_p and not has_m:
            return
        if not (has_p and has_m):
            msg = "cache_hit_probability and cache_miss_time must be given together"
            raise PayloadError(msg)
        if self.kind != EndpointStepIO.CACHE:
            msg = "cache hit/miss dynamics are only valid on io_cache steps"
            raise PayloadError(msg)
        if not 0.0 < self.cache_hit_probability < 1.0:
            msg = (
                "cache_hit_probability must be in (0, 1) — use a plain "
                "io_cache step for the degenerate cases"
            )
            raise PayloadError(msg)

    def _check_llm_fields(self) -> None:
        """The reference's ``_llm_fields_coherent``."""
        given = [getattr(self, name) for name in _LLM_FIELDS]
        if all(v is None for v in given):
            return
        if any(v is None for v in given):
            msg = (
                "llm_tokens_mean, llm_time_per_token and llm_cost_per_token "
                "must be given together"
            )
            raise PayloadError(msg)
        if self.kind != EndpointStepIO.LLM:
            msg = "LLM dynamics are only valid on io_llm steps"
            raise PayloadError(msg)
        if self.llm_time_per_token < 0 or self.llm_cost_per_token < 0:
            msg = "llm_time_per_token and llm_cost_per_token must be >= 0"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> Step:
        f = read_fields(
            data,
            "endpoint step",
            known=("kind", "step_operation", *_CACHE_FIELDS, *_LLM_FIELDS),
            required=("kind", "step_operation"),
        )
        return cls(**f)

    @property
    def quantity(self) -> float:
        """The single numeric payload of this step."""
        return float(next(iter(self.step_operation.values())))

    @property
    def is_cpu(self) -> bool:
        return isinstance(self.kind, EndpointStepCPU)

    @property
    def is_io(self) -> bool:
        return isinstance(self.kind, EndpointStepIO)

    @property
    def is_ram(self) -> bool:
        return isinstance(self.kind, EndpointStepRAM)

    @property
    def is_stochastic_cache(self) -> bool:
        return self.cache_hit_probability is not None

    @property
    def is_llm(self) -> bool:
        return self.llm_tokens_mean is not None


@dataclass
class Endpoint:
    """A named sequence of steps; ``selection_weight`` is the relative
    probability of a request hitting this endpoint within its server."""

    endpoint_name: str
    steps: list[Step] = field(default_factory=list)
    selection_weight: float = 1.0

    def __post_init__(self) -> None:
        self.endpoint_name = as_str(self.endpoint_name, "endpoint_name").lower()
        self.selection_weight = as_float(self.selection_weight, "selection_weight")
        check_range(self.selection_weight, "selection_weight", gt=0.0)

    @classmethod
    def from_dict(cls, data: object) -> Endpoint:
        f = read_fields(
            data,
            "endpoint",
            known=("endpoint_name", "steps", "selection_weight"),
            required=("endpoint_name", "steps"),
        )
        f["steps"] = [Step.from_dict(s) for s in as_list(f["steps"], "steps")]
        return cls(**f)
