"""Compile a validated payload into the dense, static plan the DES kernel reads.

The port's own copy of the reference compiler (``asyncflow_tpu/compiler/
plan.py``: ``compile_payload``, ``_compile_endpoint``, ``_estimate_capacity``
and the capacity block), cut to the fields the event kernel reads and to
the features this slice models.  The lowering decisions are the
reference's:

- endpoint programs become alternating CPU / IO segments (runs of CPU
  steps merge, as do runs of IO steps), END-terminated; RAM steps add up to
  an up-front working set (RAM-first admission);
- the path from the generator to the first LB or server is a static edge
  chain; each server's single out-edge leads to a server, the LB or the
  client;
- the request pool and the iteration cap come from the same fluid
  capacity model, so both packages size the kernel identically.

:func:`plan_from_arrays` carries a plan's fields, as numpy arrays, across
from the reference package; features outside the slice that such a plan
carries are recorded in :attr:`StaticPlan.unsupported` and refused by the
engine before any launch.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np

from asyncflow_tpu_torch.config.constants import Distribution, LbAlgorithmsName
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas.endpoint import Endpoint
from asyncflow_tpu_torch.schemas.payload import SimulationPayload

# segment kinds (the reference's numbering; the slice models END, CPU, IO)
SEG_END = 0
SEG_CPU = 1
SEG_IO = 2
SEG_DB = 3
SEG_CACHE = 4
SEG_LLM = 5
SEG_PREFILL = 6
SEG_DECODE = 7

#: segment kinds of the reference that this slice refuses, by feature name
UNSUPPORTED_SEGMENTS = {
    SEG_DB: "db_pool",
    SEG_CACHE: "cache",
    SEG_LLM: "llm",
    SEG_PREFILL: "serving",
    SEG_DECODE: "serving",
}

# node kinds a hop can land on
TARGET_SERVER = 1
TARGET_LB = 2
TARGET_CLIENT = 3

_DIST_IDS = {
    Distribution.UNIFORM: 0,
    Distribution.POISSON: 1,
    Distribution.EXPONENTIAL: 2,
    Distribution.NORMAL: 3,
    Distribution.LOG_NORMAL: 4,
}


@dataclass
class StaticPlan:
    """Dense arrays describing one scenario family for the DES kernel."""

    # ---- sizes ----
    n_servers: int
    n_edges: int
    n_lb_edges: int
    max_endpoints: int
    max_segments: int
    # ---- edges ----
    edge_dist: np.ndarray  # (NE,) i32
    edge_mean: np.ndarray  # (NE,) f32
    edge_var: np.ndarray  # (NE,) f32 (0 when unused)
    edge_dropout: np.ndarray  # (NE,) f32
    # ---- entry chain: generator -> ... -> first LB / server ----
    entry_edges: np.ndarray  # (K,) i32
    entry_target_kind: int  # TARGET_LB or TARGET_SERVER
    entry_target: int  # server index when TARGET_SERVER else -1
    # ---- servers ----
    server_cores: np.ndarray  # (NS,) i32
    server_ram: np.ndarray  # (NS,) f32
    n_endpoints: np.ndarray  # (NS,) i32
    seg_kind: np.ndarray  # (NS, NEP, NSEG+1) i32, END-terminated
    seg_dur: np.ndarray  # (NS, NEP, NSEG+1) f32
    endpoint_ram: np.ndarray  # (NS, NEP) f32
    endpoint_cum: np.ndarray  # (NS, NEP) f32 cumulative selection weights
    exit_edge: np.ndarray  # (NS,) i32
    exit_kind: np.ndarray  # (NS,) i32 (TARGET_*)
    exit_target: np.ndarray  # (NS,) i32 (server index when TARGET_SERVER)
    # ---- load balancer ----
    lb_algo: int  # 0 = round robin, 1 = least connections
    lb_edge_index: np.ndarray  # (EL,) i32 edge index per LB slot
    lb_target: np.ndarray  # (EL,) i32 server index per LB slot
    # ---- workload (one generator) ----
    user_mean: float
    user_var: float  # < 0 => Poisson users, else truncated-Gaussian scale
    user_window: float
    req_per_user_per_sec: float
    # ---- run geometry ----
    horizon: float
    pool_size: int
    max_iterations: int
    #: features outside this slice that the plan carries (only plans
    #: carried across with :func:`plan_from_arrays` can have any)
    unsupported: tuple[str, ...] = ()

    @property
    def n_windows(self) -> int:
        """Columns of the per-scenario arrival-rate table."""
        return int(np.ceil(self.horizon / self.user_window)) + 1

    @property
    def has_ram(self) -> bool:
        return bool(np.max(self.endpoint_ram) > 0)


#: the StaticPlan fields the DES kernel reads, in declaration order
KERNEL_FIELDS = tuple(
    name for name in StaticPlan.__dataclass_fields__ if name != "unsupported"
)


# ---------------------------------------------------------------------------
# payload lowering
# ---------------------------------------------------------------------------


def _compile_endpoint(endpoint: Endpoint) -> tuple[list[tuple[int, float]], float]:
    """Merge step runs into alternating (kind, duration) segments, plus the
    endpoint's RAM total (the reference's ``_compile_endpoint`` for plain
    CPU / IO / RAM steps)."""
    segments: list[tuple[int, float]] = []
    total_ram = 0.0
    for step in endpoint.steps:
        if step.is_ram:
            total_ram += step.quantity
            continue
        kind = SEG_CPU if step.is_cpu else SEG_IO
        if segments and segments[-1][0] == kind:
            segments[-1] = (kind, segments[-1][1] + step.quantity)
        else:
            segments.append((kind, step.quantity))
    return segments, total_ram


def _estimate_capacity(payload: SimulationPayload) -> tuple[int, int]:
    """(max_requests, pool_size): the reference's fluid capacity model.

    The pool holds every concurrently live request, queue backlog of a
    saturated resource included; ``max_requests`` is a 6-sigma bound on the
    arrival count.  Overflow stays possible and is counted, never hidden.
    """
    horizon = float(payload.sim_settings.total_simulation_time)
    workload = payload.rqs_input
    users = float(workload.avg_active_users.mean)
    rpu = float(workload.avg_request_per_minute_per_user.mean) / 60.0
    rate = users * rpu
    window = float(workload.user_sampling_window)
    users_var = (
        float(workload.avg_active_users.variance) ** 2
        if workload.avg_active_users.variance is not None
        else users  # Poisson users
    )
    n_windows = max(1.0, horizon / window)
    count_var = rate * horizon + n_windows * users_var * (rpu * window) ** 2
    max_requests = int(rate * horizon + 6.0 * math.sqrt(max(count_var, 1.0)) + 64)

    # ~3-sigma burst of the windowed user draw
    burst_rate = rate * (1.0 + 3.0 / math.sqrt(max(users, 1.0)))
    residence_max = 0.0
    backlog = 0.0
    burst_backlog = 0.0
    for server in payload.topology_graph.nodes.servers:
        cpu_req = 0.0
        io_req = 0.0
        ram_req = 0.0
        for endpoint in server.endpoints:
            segs, ram = _compile_endpoint(endpoint)
            cpu_req = max(cpu_req, sum(d for k, d in segs if k == SEG_CPU))
            io_req = max(io_req, sum(d for k, d in segs if k == SEG_IO))
            ram_req = max(ram_req, ram)
        residence = cpu_req + io_req
        residence_max = max(residence_max, residence)
        capacity = math.inf
        if cpu_req > 0:
            capacity = min(capacity, server.server_resources.cpu_cores / cpu_req)
        if ram_req > 0 and residence > 0:
            concurrent = server.server_resources.ram_mb / ram_req
            capacity = min(capacity, concurrent / residence)
        if capacity < math.inf:
            backlog += max(0.0, rate - capacity) * horizon
            burst_backlog += max(0.0, burst_rate - capacity) * min(window, horizon)

    edge_delay = sum(edge.latency.mean for edge in payload.topology_graph.edges)
    # the reference adds 2 x the summed network spikes here; the slice has none
    in_flight = rate * (residence_max + edge_delay + 0.0)
    want = 4.0 * in_flight + 1.5 * (backlog + burst_backlog) + 64.0
    pool = int(2 ** math.ceil(math.log2(max(64.0, want))))
    return max_requests, min(pool, 32768)


def compile_payload(
    payload: SimulationPayload,
    *,
    pool_size: int | None = None,
) -> StaticPlan:
    """Lower a validated payload to a :class:`StaticPlan`."""
    graph = payload.topology_graph
    servers = graph.nodes.servers
    edges = graph.edges
    client_id = graph.nodes.client.id
    lb = graph.nodes.load_balancer
    lb_id = lb.id if lb is not None else None

    server_index = {server.id: i for i, server in enumerate(servers)}
    edge_index = {edge.id: i for i, edge in enumerate(edges)}
    n_servers, n_edges = len(servers), len(edges)

    edge_dist = np.array(
        [_DIST_IDS[edge.latency.distribution] for edge in edges], dtype=np.int32,
    )
    edge_mean = np.array([edge.latency.mean for edge in edges], dtype=np.float32)
    edge_var = np.array(
        [edge.latency.variance or 0.0 for edge in edges], dtype=np.float32,
    )
    edge_dropout = np.array([edge.dropout_rate for edge in edges], dtype=np.float32)

    def target_of(node_id: str) -> tuple[int, int]:
        if node_id in server_index:
            return TARGET_SERVER, server_index[node_id]
        if node_id == lb_id:
            return TARGET_LB, -1
        if node_id == client_id:
            return TARGET_CLIENT, -1
        msg = f"unroutable node {node_id!r}"
        raise PayloadError(msg)

    out_edge_of = {
        edge.source: edge_index[edge.id] for edge in edges if edge.source != lb_id
    }

    # entry chain: generator -> (client ->)* first LB / server
    entry_edges: list[int] = []
    cursor = payload.rqs_input.id
    for _ in range(n_edges + 1):
        if cursor not in out_edge_of:
            msg = f"node {cursor!r} has no outgoing edge on the entry path"
            raise PayloadError(msg)
        eidx = out_edge_of[cursor]
        entry_edges.append(eidx)
        entry_kind, entry_target = target_of(edges[eidx].target)
        if entry_kind in (TARGET_LB, TARGET_SERVER):
            break
        cursor = edges[eidx].target
    else:
        msg = "entry path does not reach a server or load balancer"
        raise PayloadError(msg)

    # ---- servers ----
    max_endpoints = max(len(server.endpoints) for server in servers)
    compiled = [[_compile_endpoint(ep) for ep in server.endpoints] for server in servers]
    max_segments = max(
        (len(segs) for per_server in compiled for segs, _ in per_server), default=0,
    )
    shape = (n_servers, max_endpoints, max_segments + 1)
    seg_kind = np.zeros(shape, dtype=np.int32)
    seg_dur = np.zeros(shape, dtype=np.float32)
    endpoint_ram = np.zeros((n_servers, max_endpoints), dtype=np.float32)
    # padded columns carry 1.0 so an endpoint draw never lands on them
    endpoint_cum = np.ones((n_servers, max_endpoints), dtype=np.float32)
    n_endpoints = np.zeros(n_servers, dtype=np.int32)
    for s, server in enumerate(servers):
        w = np.array(
            [float(ep.selection_weight) for ep in server.endpoints], dtype=np.float64,
        )
        endpoint_cum[s, : len(w)] = np.cumsum(w / w.sum())
        n_endpoints[s] = len(server.endpoints)
        for e, (segs, ram) in enumerate(compiled[s]):
            endpoint_ram[s, e] = ram
            for k, (kind, dur) in enumerate(segs):
                seg_kind[s, e, k] = kind
                seg_dur[s, e, k] = dur

    server_cores = np.array(
        [server.server_resources.cpu_cores for server in servers], dtype=np.int32,
    )
    server_ram = np.array(
        [server.server_resources.ram_mb for server in servers], dtype=np.float32,
    )
    exit_edge = np.full(n_servers, -1, dtype=np.int32)
    exit_kind = np.full(n_servers, TARGET_CLIENT, dtype=np.int32)
    exit_target = np.full(n_servers, -1, dtype=np.int32)
    for server in servers:
        s = server_index[server.id]
        if server.id not in out_edge_of:
            msg = f"server {server.id!r} has no outgoing edge"
            raise PayloadError(msg)
        eidx = out_edge_of[server.id]
        exit_edge[s] = eidx
        exit_kind[s], exit_target[s] = target_of(edges[eidx].target)

    # ---- LB ----
    lb_slots = [edge_index[e.id] for e in edges if lb_id is not None and e.source == lb_id]
    lb_edge_index = np.array(lb_slots, dtype=np.int32)
    lb_target = np.array(
        [server_index[edges[eidx].target] for eidx in lb_slots], dtype=np.int32,
    )
    lb_algo = (
        1
        if lb is not None and lb.algorithms == LbAlgorithmsName.LEAST_CONNECTIONS
        else 0
    )

    # ---- capacities ----
    max_requests, pool_estimate = _estimate_capacity(payload)
    events_per_request = (
        2 * (len(entry_edges) + 2)  # spawn + entry hops + lb + exits
        + 3 * (max_segments + 1)  # segment starts / ends + grants
        + 4
    )
    max_iterations = max_requests * events_per_request + 1024

    gen = payload.rqs_input
    users = gen.avg_active_users
    return StaticPlan(
        n_servers=n_servers,
        n_edges=n_edges,
        n_lb_edges=len(lb_slots),
        max_endpoints=max_endpoints,
        max_segments=max_segments,
        edge_dist=edge_dist,
        edge_mean=edge_mean,
        edge_var=edge_var,
        edge_dropout=edge_dropout,
        entry_edges=np.array(entry_edges, dtype=np.int32),
        entry_target_kind=entry_kind,
        entry_target=entry_target,
        server_cores=server_cores,
        server_ram=server_ram,
        n_endpoints=n_endpoints,
        seg_kind=seg_kind,
        seg_dur=seg_dur,
        endpoint_ram=endpoint_ram,
        endpoint_cum=endpoint_cum,
        exit_edge=exit_edge,
        exit_kind=exit_kind,
        exit_target=exit_target,
        lb_algo=lb_algo,
        lb_edge_index=lb_edge_index,
        lb_target=lb_target,
        user_mean=float(users.mean),
        user_var=(
            float(users.variance)
            if users.distribution == Distribution.NORMAL and users.variance is not None
            else -1.0
        ),
        user_window=float(gen.user_sampling_window),
        req_per_user_per_sec=float(gen.avg_request_per_minute_per_user.mean) / 60.0,
        horizon=float(payload.sim_settings.total_simulation_time),
        pool_size=pool_size or pool_estimate,
        max_iterations=max_iterations,
    )


# ---------------------------------------------------------------------------
# plans carried across from the reference package
# ---------------------------------------------------------------------------


def _any(fields: Mapping, name: str, test) -> bool:
    if name not in fields:
        return False
    arr = np.asarray(fields[name])
    return bool(arr.size) and bool(np.any(test(arr)))


#: (feature name, predicate over a reference plan's fields)
_FEATURE_TESTS = (
    ("timeline", lambda f: np.asarray(f.get("timeline_times", ())).size > 0),
    ("spikes", lambda f: np.asarray(f.get("spike_times", (0.0,))).size > 1),
    ("queue_cap", lambda f: _any(f, "server_queue_cap", lambda a: a >= 0)),
    ("conn_cap", lambda f: _any(f, "server_conn_cap", lambda a: a >= 0)),
    ("rate_limit", lambda f: _any(f, "server_rate_limit", lambda a: a >= 0)),
    ("queue_timeout", lambda f: _any(f, "server_queue_timeout", lambda a: a >= 0)),
    ("circuit_breaker", lambda f: int(f.get("breaker_threshold", 0)) > 0),
    ("multi_generator", lambda f: np.asarray(f.get("gen_user_mean", (0.0,))).size > 1),
    (
        "faults",
        lambda f: _any(f, "fault_srv_down", lambda a: a != 0)
        or _any(f, "fault_edge_lat", lambda a: a != 1.0)
        or _any(f, "fault_edge_drop", lambda a: a != 0.0),
    ),
    ("hazards", lambda f: int(f.get("hz_max_faults", 0)) > 0),
    ("retry", lambda f: float(f.get("retry_timeout", 0.0)) > 0),
    ("hedge", lambda f: float(f.get("hedge_delay", 0.0)) > 0),
    ("health", lambda f: float(f.get("health_alpha", 0.0)) > 0),
    ("brownout", lambda f: _any(f, "server_brownout_q", lambda a: a >= 0)),
    ("replay", lambda f: np.asarray(f.get("replay_times", ())).size > 0),
)


def plan_from_arrays(fields: Mapping[str, object]) -> StaticPlan:
    """A :class:`StaticPlan` from a mapping of plan fields as numpy arrays
    and Python scalars (for example ``vars(reference_plan)``).

    The kernel fields are required; any other field is read only to find
    features outside this slice, which land in ``unsupported``.
    """
    missing = [name for name in KERNEL_FIELDS if name not in fields]
    if missing:
        msg = f"plan fields missing: {missing}"
        raise PayloadError(msg)
    kw: dict[str, object] = {}
    for name, spec in StaticPlan.__dataclass_fields__.items():
        if name == "unsupported":
            continue
        value = fields[name]
        if spec.type == "np.ndarray":
            kw[name] = np.array(value, copy=True)
        elif spec.type == "int":
            kw[name] = int(value)
        else:
            kw[name] = float(value)
    unsupported = [name for name, test in _FEATURE_TESTS if test(fields)]
    seg_kinds = set(np.unique(np.asarray(fields["seg_kind"])).tolist())
    unsupported += sorted(
        {UNSUPPORTED_SEGMENTS[k] for k in seg_kinds if k in UNSUPPORTED_SEGMENTS},
    )
    return StaticPlan(**kw, unsupported=tuple(unsupported))
