"""Endpoint and step schemas: the per-request program a server executes.

Same contract as the reference ``Step`` / ``Endpoint``: a step carries
exactly one positive quantity whose key agrees with the step kind (CPU <->
cpu_time, RAM <-> necessary_ram, I/O <-> io_waiting_time), and endpoint
names are lowercased.  Every I/O kind is a plain sleep here; the cache,
LLM and serving dynamics of the reference are refused by name.
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

#: step fields of the reference that carry dynamics this slice does not model
_UNSUPPORTED_STEP_FIELDS = (
    "cache_hit_probability",
    "cache_miss_time",
    "llm_tokens_mean",
    "llm_time_per_token",
    "llm_cost_per_token",
)


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

    @classmethod
    def from_dict(cls, data: object) -> Step:
        f = read_fields(
            data,
            "endpoint step",
            known=("kind", "step_operation"),
            required=("kind", "step_operation"),
            unsupported=_UNSUPPORTED_STEP_FIELDS,
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
