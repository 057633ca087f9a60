"""The fast path's observability planes (the port's copies of the
reference's ``observability/simtrace.py`` and ``observability/blame.py``):
the request flight recorder's layout and decoders, and the latency blame
grid's layout and host-side breakdowns.  Plain numpy and dataclasses."""

from asyncflow_tpu_torch.observability.simtrace import (
    FR_NAMES,
    FlightRecord,
    TraceConfig,
    decode_flight,
    flight_dropped_events,
)

__all__ = [
    "FR_NAMES",
    "FlightRecord",
    "TraceConfig",
    "decode_flight",
    "flight_dropped_events",
]
