"""Lower the fault timeline and retry policy to dense piecewise tables.

The port's copy of the reference's ``compiler/faults.py`` (``FaultArrays``,
``lower_faults``, ``RetryScalars``, ``lower_retry``): the same arrays for
the same payload, which the fast path reads on the device and the host
helpers here evaluate with ``np.searchsorted``.

Fault windows become breakpoint tables exactly like the network-spike
lowering in :mod:`asyncflow_tpu_torch.compiler.plan` — sorted unique change
times with a leading identity row at ``t = 0``, piecewise-constant values
on ``[t_k, t_{k+1})``:

- ``srv_down[k, s]`` — 1 while server ``s`` is inside a ``server_outage``
  window (overlapping windows union);
- ``edge_lat[k, e]`` — multiplicative latency factor on edge ``e``
  (superposed ``edge_degrade`` windows multiply);
- ``edge_drop[k, e]`` — additive dropout boost (superposed windows add;
  ``edge_partition`` contributes +1.0; engines clip base + boost to 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from asyncflow_tpu_torch.config.constants import FaultKind
from asyncflow_tpu_torch.schemas.payload import SimulationPayload
from asyncflow_tpu_torch.schemas.resilience import RetryPolicy


@dataclass
class FaultArrays:
    """Dense piecewise-constant fault tables (identity when no faults)."""

    #: (K,) f32 sorted change times, srv_times[0] == 0
    srv_times: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.float32),
    )
    #: (K, NS) i32, 1 = server inside an outage window
    srv_down: np.ndarray = field(
        default_factory=lambda: np.zeros((1, 0), np.int32),
    )
    #: (M,) f32 sorted change times, edge_times[0] == 0
    edge_times: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.float32),
    )
    #: (M, NE) f32 multiplicative latency factor (1 = no fault)
    edge_lat: np.ndarray = field(
        default_factory=lambda: np.ones((1, 0), np.float32),
    )
    #: (M, NE) f32 additive dropout boost (0 = no fault)
    edge_drop: np.ndarray = field(
        default_factory=lambda: np.zeros((1, 0), np.float32),
    )

    @property
    def has_faults(self) -> bool:
        return bool(
            np.any(self.srv_down != 0)
            or np.any(self.edge_lat != 1.0)
            or np.any(self.edge_drop != 0.0),
        )

    # host-side evaluation of the same tables --------

    def server_down(self, s: int, t: float) -> bool:
        k = int(np.searchsorted(self.srv_times, t, side="right")) - 1
        return bool(self.srv_down[max(k, 0), s])

    def edge_fault(self, e: int, t: float) -> tuple[float, float]:
        """(latency factor, dropout boost) active on edge ``e`` at ``t``."""
        k = max(int(np.searchsorted(self.edge_times, t, side="right")) - 1, 0)
        return float(self.edge_lat[k, e]), float(self.edge_drop[k, e])


def lower_faults(payload: SimulationPayload) -> FaultArrays:
    """Lower the payload's fault timeline against its topology order."""
    servers = payload.topology_graph.nodes.servers
    edges = payload.topology_graph.edges
    n_servers, n_edges = len(servers), len(edges)
    server_index = {s.id: i for i, s in enumerate(servers)}
    edge_index = {e.id: i for i, e in enumerate(edges)}

    empty = FaultArrays(
        srv_down=np.zeros((1, n_servers), np.int32),
        edge_lat=np.ones((1, n_edges), np.float32),
        edge_drop=np.zeros((1, n_edges), np.float32),
    )
    faults = (
        payload.fault_timeline.events if payload.fault_timeline else []
    )
    if not faults:
        return empty

    srv_marks: list[tuple[float, int, int]] = []  # (t, delta, server)
    edge_marks: list[tuple[float, float, float, int]] = []  # (t, log_lat, drop, edge)
    for fault in faults:
        if fault.kind == FaultKind.SERVER_OUTAGE:
            s = server_index[fault.target_id]
            srv_marks.append((float(fault.t_start), 1, s))
            srv_marks.append((float(fault.t_end), -1, s))
        else:
            e = edge_index[fault.target_id]
            if fault.kind == FaultKind.EDGE_PARTITION:
                log_lat, drop = 0.0, 1.0
            else:
                log_lat = math.log(float(fault.latency_factor))
                drop = float(fault.dropout_boost)
            edge_marks.append((float(fault.t_start), log_lat, drop, e))
            edge_marks.append((float(fault.t_end), -log_lat, -drop, e))

    def _table(times: set[float]) -> tuple[np.ndarray, dict[float, int]]:
        change = sorted({0.0} | times)
        return (
            np.array(change, np.float32),
            {t: i for i, t in enumerate(change)},
        )

    srv_times, srv_pos = _table({t for t, _, _ in srv_marks})
    srv_delta = np.zeros((len(srv_times), n_servers), np.int32)
    for t, delta, s in srv_marks:
        srv_delta[srv_pos[t], s] += delta
    srv_down = (np.cumsum(srv_delta, axis=0) > 0).astype(np.int32)

    edge_times, edge_pos = _table({t for t, _, _, _ in edge_marks})
    lat_delta = np.zeros((len(edge_times), n_edges), np.float64)
    drop_delta = np.zeros((len(edge_times), n_edges), np.float64)
    for t, log_lat, drop, e in edge_marks:
        lat_delta[edge_pos[t], e] += log_lat
        drop_delta[edge_pos[t], e] += drop
    edge_lat = np.exp(np.cumsum(lat_delta, axis=0)).astype(np.float32)
    # exp/log round trips can leave 1 +- eps outside windows; snap
    edge_lat[np.isclose(edge_lat, 1.0, atol=1e-6)] = 1.0
    edge_drop = np.clip(
        np.cumsum(drop_delta, axis=0), 0.0, None,
    ).astype(np.float32)

    return FaultArrays(
        srv_times=srv_times,
        srv_down=srv_down,
        edge_times=edge_times,
        edge_lat=edge_lat,
        edge_drop=edge_drop,
    )


@dataclass
class RetryScalars:
    """The retry policy lowered to plan scalars (inert defaults = none)."""

    timeout: float = -1.0  # < 0 = no retry policy
    max_attempts: int = 1
    backoff_base: float = 0.0
    backoff_mult: float = 1.0
    backoff_cap: float = 0.0
    jitter: float = 0.0
    budget_tokens: float = -1.0  # < 0 = unlimited budget
    budget_refill: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.timeout > 0


def lower_retry(policy: RetryPolicy | None) -> RetryScalars:
    if policy is None:
        return RetryScalars()
    return RetryScalars(
        timeout=float(policy.request_timeout_s),
        max_attempts=int(policy.max_attempts),
        backoff_base=float(policy.backoff_base_s),
        backoff_mult=float(policy.backoff_multiplier),
        backoff_cap=float(policy.backoff_cap_s),
        jitter=float(policy.jitter),
        budget_tokens=(
            float(policy.budget_tokens)
            if policy.budget_tokens is not None
            else -1.0
        ),
        budget_refill=float(policy.budget_refill_per_s),
    )
