"""Event-injection schemas: scheduled latency spikes and server outages.

Same contract as the reference: start and end markers are frozen and
reject unknown fields; start and end kinds pair up (``server_down`` with
``server_up``, ``network_spike_start`` with ``network_spike_end``);
``t_start < t_end``; ``spike_s`` is given exactly for network spikes.
"""

from __future__ import annotations

from dataclasses import dataclass

from asyncflow_tpu_torch.config.constants import EventDescription
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas._fields import (
    as_enum,
    as_float,
    as_str,
    check_range,
    read_fields,
)

_START_TO_END = {
    EventDescription.SERVER_DOWN: EventDescription.SERVER_UP,
    EventDescription.NETWORK_SPIKE_START: EventDescription.NETWORK_SPIKE_END,
}


def _kind(value: object, allowed: tuple[EventDescription, ...], name: str):
    kind = as_enum(EventDescription, value, name)
    if kind not in allowed:
        msg = f"{name} must be one of {[k.value for k in allowed]}, got {value!r}"
        raise PayloadError(msg)
    return kind


@dataclass(frozen=True)
class Start:
    """Opening marker of an event window."""

    kind: EventDescription
    t_start: float
    spike_s: float | None = None

    def __post_init__(self) -> None:
        kind = _kind(self.kind, tuple(_START_TO_END), "start kind")
        t_start = as_float(self.t_start, "t_start")
        check_range(t_start, "t_start", ge=0.0)
        spike = self.spike_s
        if spike is not None:
            spike = as_float(spike, "spike_s")
            check_range(spike, "spike_s", gt=0.0)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "t_start", t_start)
        object.__setattr__(self, "spike_s", spike)

    @classmethod
    def from_dict(cls, data: object) -> Start:
        return cls(
            **read_fields(
                data,
                "event start",
                known=("kind", "t_start", "spike_s"),
                required=("kind", "t_start"),
            ),
        )


@dataclass(frozen=True)
class End:
    """Closing marker of an event window."""

    kind: EventDescription
    t_end: float

    def __post_init__(self) -> None:
        kind = _kind(self.kind, tuple(_START_TO_END.values()), "end kind")
        t_end = as_float(self.t_end, "t_end")
        check_range(t_end, "t_end", gt=0.0)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "t_end", t_end)

    @classmethod
    def from_dict(cls, data: object) -> End:
        return cls(
            **read_fields(
                data, "event end", known=("kind", "t_end"), required=("kind", "t_end"),
            ),
        )


@dataclass
class EventInjection:
    """A deterministic what-if window applied to one topology component."""

    event_id: str
    target_id: str
    start: Start
    end: End

    def __post_init__(self) -> None:
        self.event_id = as_str(self.event_id, "event_id")
        self.target_id = as_str(self.target_id, "target_id")
        expected = _START_TO_END[self.start.kind]
        if self.end.kind != expected:
            msg = f"The event {self.event_id} must have as value of kind in end {expected}"
            raise PayloadError(msg)
        if self.start.t_start >= self.end.t_end:
            msg = (
                f"The starting time for the event {self.event_id} "
                "must be smaller than the ending time"
            )
            raise PayloadError(msg)
        is_spike = self.start.kind == EventDescription.NETWORK_SPIKE_START
        if is_spike and self.start.spike_s is None:
            msg = (
                f"The field spike_s for the event {self.event_id} "
                "must be defined as a positive float"
            )
            raise PayloadError(msg)
        if not is_spike and self.start.spike_s is not None:
            msg = f"Event {self.event_id}: spike_s must be omitted"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> EventInjection:
        f = read_fields(
            data,
            "event",
            known=("event_id", "target_id", "start", "end"),
            required=("event_id", "target_id", "start", "end"),
        )
        f["start"] = Start.from_dict(f["start"])
        f["end"] = End.from_dict(f["end"])
        return cls(**f)
