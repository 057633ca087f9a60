"""The request flight recorder's shared layout (the reference's
``observability/simtrace.py``).

A scenario traces its first ``sample_requests`` spawned logical requests
(no draw picks them); each owns ``event_slots`` ring entries of ``(code,
node, sim-time)``, and writes past the budget are counted, not stored, so
truncation is explicit (:attr:`FlightRecord.dropped`).  A logical request
keeps its record across client retries; an orphaned attempt stops
recording at its client deadline.

``node`` depends on the code: the generator for :data:`FR_SPAWN`, the edge
for :data:`FR_TRANSIT` / :data:`FR_DROP`, the server for the server-side
codes, the failed attempt's number for the retry codes, and ``-1`` where no
component applies (the LB, the client).  The codes' numbers are the
reference's: renumbering breaks recorded artifacts.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field

import numpy as np

from asyncflow_tpu_torch.errors import PayloadError

FR_SPAWN = 1  #: generator emitted (or client re-issued) the request
FR_TRANSIT = 2  #: an edge traversal DELIVERED (t = delivery time)
FR_ARRIVE_LB = 3  #: arrived at the load balancer
FR_ARRIVE_SRV = 4  #: accepted by a server (refusals are FR_REJECT)
FR_WAIT_RAM = 5  #: parked in the RAM admission FIFO
FR_WAIT_CPU = 6  #: joined a ready queue (core busy or waiters ahead)
FR_WAIT_DB = 7  #: parked in a DB connection-pool FIFO
FR_RUN = 8  #: a wait resolved: service granted (core, RAM, connection)
FR_RETRY = 9  #: client scheduled a backoff re-issue (node = failed attempt)
FR_TIMEOUT = 10  #: client deadline fired; the attempt is orphaned
FR_DROP = 11  #: lost to edge dropout or an empty LB rotation
FR_REJECT = 12  #: refused (outage, rate limit, socket cap, shed, abandon,
#: fully-open breaker rotation, pool overflow)
FR_COMPLETE = 13  #: delivered back to the client: the request is done
FR_ABANDON = 14  #: client gave the logical request up (node = last attempt)
FR_HEDGE = 15  #: hedge timer fired: a duplicate issued (node = hedge ordinal)
FR_CANCEL = 16  #: attempt cancelled en route (its sibling won the race)
FR_PREFILL = 17  #: admitted to the batch: prefill started
FR_DECODE = 18  #: decode extension fit: generation started
FR_EVICT = 19  #: KV pressure evicted the request (prefill will be redone)

FR_NAMES: dict[int, str] = {
    FR_SPAWN: "spawn",
    FR_TRANSIT: "transit",
    FR_ARRIVE_LB: "arrive_lb",
    FR_ARRIVE_SRV: "arrive_srv",
    FR_WAIT_RAM: "wait_ram",
    FR_WAIT_CPU: "wait_cpu",
    FR_WAIT_DB: "wait_db",
    FR_RUN: "run",
    FR_RETRY: "retry",
    FR_TIMEOUT: "timeout",
    FR_DROP: "drop",
    FR_REJECT: "reject",
    FR_COMPLETE: "complete",
    FR_ABANDON: "abandon",
    FR_HEDGE: "hedge",
    FR_CANCEL: "cancel",
    FR_PREFILL: "prefill",
    FR_DECODE: "decode",
    FR_EVICT: "evict",
}

#: codes whose ``node`` field is an edge index
_EDGE_CODES = frozenset({FR_TRANSIT, FR_DROP})
#: codes whose ``node`` field is a server index
_SERVER_CODES = frozenset(
    {FR_ARRIVE_SRV, FR_WAIT_RAM, FR_WAIT_CPU, FR_WAIT_DB, FR_RUN,
     FR_PREFILL, FR_DECODE, FR_EVICT},
)

#: (name, low, high) of each budget, the reference's bounds
_BOUNDS = (("sample_requests", 1, 4096), ("event_slots", 4, 4096))


@dataclass(frozen=True)
class TraceConfig:
    """What the flight recorder samples and how much it may store.  The
    budgets size the rings; tracing consumes no draw and changes no other
    output."""

    #: trace the first K spawned logical requests of every scenario
    sample_requests: int = 8
    #: ring entries a traced request; writes past this are counted in
    #: :attr:`FlightRecord.dropped` instead of stored
    event_slots: int = 48

    def __post_init__(self) -> None:
        for name, lo, hi in _BOUNDS:
            value = getattr(self, name)
            if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
                msg = f"TraceConfig.{name} must be an integer, got {value!r}"
                raise PayloadError(msg)
            if not lo <= int(value) <= hi:
                msg = f"TraceConfig.{name} must be in [{lo}, {hi}], got {value}"
                raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: Mapping) -> TraceConfig:
        """A config from a mapping of its fields (unknown keys refused)."""
        if not isinstance(data, Mapping):
            msg = f"trace: expected a TraceConfig or a mapping, got {type(data).__name__}"
            raise PayloadError(msg)
        unknown = set(data) - {name for name, _, _ in _BOUNDS}
        if unknown:
            msg = f"TraceConfig: unknown field(s) {sorted(unknown)}"
            raise PayloadError(msg)
        return cls(**data)

    @classmethod
    def of(cls, trace) -> TraceConfig | None:
        """None, a config, or a mapping validated into one."""
        if trace is None or isinstance(trace, cls):
            return trace
        return cls.from_dict(trace)


@dataclass
class FlightRecord:
    """One traced request's lifecycle in event order: ``events`` are
    ``(code, node, sim_time_s)``; ``dropped`` counts transitions after the
    ring filled (the record covers the first ``event_slots``)."""

    req: int  #: spawn sequence number within the scenario (0-based)
    events: list[tuple[int, int, float]] = field(default_factory=list)
    dropped: int = 0

    def codes(self) -> list[int]:
        return [code for code, _node, _t in self.events]

    def describe(self, *, server_ids=None, edge_ids=None) -> list[str]:
        """Human-readable event lines (component ids resolved when given)."""
        out = []
        for code, node, t in self.events:
            name = FR_NAMES.get(code, f"code{code}")
            comp = ""
            if code in _EDGE_CODES and edge_ids and 0 <= node < len(edge_ids):
                comp = f" {edge_ids[node]}"
            elif code in _SERVER_CODES and server_ids and 0 <= node < len(server_ids):
                comp = f" {server_ids[node]}"
            elif code in (FR_RETRY, FR_TIMEOUT, FR_ABANDON):
                comp = f" attempt={node}"
            elif code == FR_HEDGE:
                comp = f" hedge={node}"
            elif node >= 0:
                comp = f" #{node}"
            out.append(f"t={t:.6f}s {name}{comp}")
        if self.dropped:
            out.append(f"... {self.dropped} later event(s) dropped (ring full)")
        return out


def decode_flight(fr_ev, fr_node, fr_t, fr_n) -> dict[int, FlightRecord]:
    """Rings ``(K, slots)`` and counts ``(K,)`` to per-request records.
    Rows that never spawned (count 0) are omitted; ``fr_n`` counts past the
    slot budget, so the overflow is the dropped-events counter."""
    fr_ev, fr_node, fr_t, fr_n = (np.asarray(a) for a in (fr_ev, fr_node, fr_t, fr_n))
    slots = fr_ev.shape[1]
    out: dict[int, FlightRecord] = {}
    for row in range(fr_ev.shape[0]):
        n = int(fr_n[row])
        if n <= 0:
            continue
        stored = min(n, slots)
        out[row] = FlightRecord(
            req=row,
            events=[(int(fr_ev[row, j]), int(fr_node[row, j]), float(fr_t[row, j]))
                    for j in range(stored)],
            dropped=n - stored,
        )
    return out


def flight_dropped_events(flight: dict[int, FlightRecord] | None) -> int:
    """Lifecycle transitions lost to full rings (0 without tracing)."""
    if not flight:
        return 0
    return sum(rec.dropped for rec in flight.values())
