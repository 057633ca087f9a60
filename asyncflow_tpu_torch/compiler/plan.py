"""Compile a validated payload into the dense, static plan the DES kernel reads.

The port's own copy of the reference compiler (``asyncflow_tpu/compiler/
plan.py``: ``compile_payload``, ``_compile_endpoint``, ``_estimate_capacity``
and the capacity block), cut to the fields the event kernel reads and to
the features this slice models.  The lowering decisions are the
reference's:

- endpoint programs become alternating CPU / IO segments (runs of CPU
  steps merge, as do runs of IO steps), END-terminated; RAM steps add up to
  an up-front working set (RAM-first admission); an io_cache step with
  hit/miss dynamics, an io_llm step with call dynamics and, on a server
  whose DB connection pool may bind, each io_db step get a segment of
  their own (SEG_CACHE, SEG_LLM, SEG_DB) with their parameters in
  per-segment tables;
- the path from each generator to the first LB or server is a static edge
  chain (one per generator; generator 0's doubles as ``entry_edges``);
  each server's single out-edge leads to a server, the LB or the client;
- the request pool and the iteration cap come from the same fluid
  capacity model, so both packages size the kernel identically;
- a DB connection pool and each overload control (ready-queue cap,
  connection cap, token-bucket rate limit, dequeue deadline) are modelled
  only where the reference's non-binding proof fails; a control the proof shows unreachable is
  lowered away, and ``proof_rate_headroom`` records how far the workload
  may be scaled before that proof breaks;
- the LB circuit breaker is modelled only where a failure channel exists
  (a modelled control on a covered server, or dropout on an LB edge);
- event injection becomes a cumulative spike table per edge and a sorted
  outage timeline of LB slots (END before START on ties).

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

from asyncflow_tpu_torch.config.constants import (
    Distribution,
    EndpointStepIO,
    EventDescription,
    LbAlgorithmsName,
)
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas.endpoint import Endpoint
from asyncflow_tpu_torch.schemas.payload import SimulationPayload

# segment kinds (the reference's numbering; the port models all but the
# serving pair)
SEG_END = 0
SEG_CPU = 1
SEG_IO = 2
SEG_DB = 3  # an io_db step holding one of the server's K FIFO connections
SEG_CACHE = 4  # an io_cache sleep: hit latency with probability p, else miss
SEG_LLM = 5  # an io_llm sleep stretched by Poisson output tokens
SEG_PREFILL = 6
SEG_DECODE = 7

#: segment kinds of the reference that the port refuses, by feature name
UNSUPPORTED_SEGMENTS = {
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
    # SEG_CACHE: hit probability (0 elsewhere) and miss latency; seg_dur
    # holds the hit latency
    seg_hit_prob: np.ndarray  # (NS, NEP, NSEG+1) f32
    seg_miss_dur: np.ndarray  # (NS, NEP, NSEG+1) f32
    # SEG_LLM: Poisson token mean, seconds and cost units per token
    seg_llm_tokens: np.ndarray  # (NS, NEP, NSEG+1) f32
    seg_llm_tpt: np.ndarray  # (NS, NEP, NSEG+1) f32
    seg_llm_cost: np.ndarray  # (NS, NEP, NSEG+1) f32
    # modelled DB connection pool per server; -1 = unlimited (no pool, or
    # one proven non-binding and lowered away)
    server_db_pool: np.ndarray  # (NS,) i32
    exit_edge: np.ndarray  # (NS,) i32
    exit_kind: np.ndarray  # (NS,) i32 (TARGET_*)
    exit_target: np.ndarray  # (NS,) i32 (server index when TARGET_SERVER)
    # ---- load balancer ----
    lb_algo: int  # 0 = round robin, 1 = least connections
    lb_edge_index: np.ndarray  # (EL,) i32 edge index per LB slot
    lb_target: np.ndarray  # (EL,) i32 server index per LB slot
    # ---- event injection ----
    # spike breakpoints: cumulative spike per edge on [t_k, t_{k+1})
    spike_times: np.ndarray  # (NB,) f32, spike_times[0] == 0
    spike_values: np.ndarray  # (NB, NE) f32
    # outage timeline (END before START on ties)
    timeline_times: np.ndarray  # (NTL,) f32
    timeline_down: np.ndarray  # (NTL,) i32 (1 = down, 0 = up)
    timeline_slot: np.ndarray  # (NTL,) i32 LB slot affected (-1 none)
    # ---- workload: generator 0, then every generator ----
    user_mean: float
    user_var: float  # < 0 => Poisson users, else truncated-Gaussian scale
    user_window: float
    req_per_user_per_sec: float
    gen_user_mean: np.ndarray  # (G,) f64
    gen_user_var: np.ndarray  # (G,) f64
    gen_window: np.ndarray  # (G,) f64
    gen_rate: np.ndarray  # (G,) f64 requests per user per second
    gen_entry_edges: np.ndarray  # (G, L) i32 entry chains, -1-padded
    gen_entry_len: np.ndarray  # (G,) i32
    gen_entry_target_kind: np.ndarray  # (G,) i32 TARGET_LB or TARGET_SERVER
    gen_entry_target: np.ndarray  # (G,) i32 server index, or -1
    # ---- run geometry ----
    horizon: float
    pool_size: int
    max_iterations: int
    # ---- overload controls, per server; -1 = not modelled ----
    server_queue_cap: np.ndarray  # (NS,) i32 ready-queue cap (shed)
    server_conn_cap: np.ndarray  # (NS,) i32 connection cap (refuse)
    server_rate_limit: np.ndarray  # (NS,) f32 token refill per second
    server_rate_burst: np.ndarray  # (NS,) i32 bucket size (0 when unmodelled)
    server_queue_timeout: np.ndarray  # (NS,) f32 dequeue deadline (abandon)
    # ---- LB circuit breaker; threshold 0 = not modelled ----
    breaker_threshold: int
    breaker_cooldown: float
    breaker_probes: int
    #: a breaker was configured but lowered away (no failure channel)
    breaker_lowered: bool
    #: the largest workload-rate scale under which every lowered-away
    #: non-binding proof still holds (inf when none was lowered away)
    proof_rate_headroom: float
    #: features outside this slice that the plan carries (only plans
    #: carried across with :func:`plan_from_arrays` can have any)
    unsupported: tuple[str, ...] = ()

    @property
    def n_generators(self) -> int:
        return int(self.gen_user_mean.shape[0])

    @property
    def gen_windows(self) -> list[int]:
        """Columns of each generator's block of the arrival-rate table."""
        return [int(np.ceil(self.horizon / float(w))) + 1 for w in self.gen_window]

    @property
    def n_windows(self) -> int:
        """Columns of the per-scenario arrival-rate table (every block)."""
        return sum(self.gen_windows)

    @property
    def has_cache(self) -> bool:
        return bool(np.any(self.seg_kind == SEG_CACHE))

    @property
    def has_llm(self) -> bool:
        return bool(np.any(self.seg_kind == SEG_LLM))

    @property
    def has_db_pool(self) -> bool:
        return bool(np.any(self.seg_kind == SEG_DB))

    @property
    def has_ram(self) -> bool:
        return bool(np.max(self.endpoint_ram) > 0)

    @property
    def has_timeline(self) -> bool:
        return len(self.timeline_times) > 0

    @property
    def has_spikes(self) -> bool:
        return len(self.spike_times) > 1

    @property
    def has_queue_cap(self) -> bool:
        return bool(np.any(self.server_queue_cap >= 0))

    @property
    def has_conn_cap(self) -> bool:
        return bool(np.any(self.server_conn_cap >= 0))

    @property
    def has_rate_limit(self) -> bool:
        return bool(np.any(self.server_rate_limit >= 0))

    @property
    def has_queue_timeout(self) -> bool:
        return bool(np.any(self.server_queue_timeout >= 0))

    @property
    def has_breaker(self) -> bool:
        return self.breaker_threshold > 0


#: the StaticPlan fields the DES kernel reads, in declaration order
KERNEL_FIELDS = tuple(
    name for name in StaticPlan.__dataclass_fields__ if name != "unsupported"
)


# ---------------------------------------------------------------------------
# payload lowering
# ---------------------------------------------------------------------------


#: per-segment parameters of a cache mixture (hit probability, miss
#: latency) and of an LLM call (token mean, seconds and cost per token)
CacheParams = tuple[float, float]
LlmParams = tuple[float, float, float]


def _compile_endpoint(
    endpoint: Endpoint, *, db_pooled: bool = False,
) -> tuple[
    list[tuple[int, float]], float, list[CacheParams | None], list[LlmParams | None],
]:
    """Merge step runs into alternating (kind, duration) segments, plus the
    endpoint's RAM total and, aligned with the segments, each one's cache
    and LLM parameters (None where it has none): the reference's
    ``_compile_endpoint`` without its serving pair.

    A stochastic io_cache step, an io_llm step with call dynamics and, with
    ``db_pooled``, an io_db step each lower to a segment of their own that
    never merges with its neighbours (two queries release and re-acquire
    their connection); a cache segment's duration is its hit latency.
    """
    segments: list[tuple[int, float]] = []
    cache: list[CacheParams | None] = []
    llm: list[LlmParams | None] = []
    total_ram = 0.0
    for step in endpoint.steps:
        if step.is_ram:
            total_ram += step.quantity
            continue
        if step.is_cpu:
            kind = SEG_CPU
        elif step.is_stochastic_cache:
            kind = SEG_CACHE
        elif step.is_llm:
            kind = SEG_LLM
        elif db_pooled and step.kind == EndpointStepIO.DB:
            kind = SEG_DB
        else:
            kind = SEG_IO
        if segments and segments[-1][0] == kind and kind in (SEG_CPU, SEG_IO):
            segments[-1] = (kind, segments[-1][1] + step.quantity)
            continue
        segments.append((kind, step.quantity))
        cache.append(
            (float(step.cache_hit_probability), float(step.cache_miss_time))
            if kind == SEG_CACHE
            else None,
        )
        llm.append(
            (
                float(step.llm_tokens_mean),
                float(step.llm_time_per_token),
                float(step.llm_cost_per_token),
            )
            if kind == SEG_LLM
            else None,
        )
    return segments, total_ram, cache, llm


def _llm_worst(duration: float, params: LlmParams) -> float:
    """An LLM segment's duration at a 6-sigma token draw."""
    mean, per_token, _ = params
    return duration + (mean + 6.0 * math.sqrt(max(mean, 1.0))) * per_token


def _server_db_hold(server) -> float:
    """Worst-case time a request holds a DB connection: the largest sum of
    io_db step durations over the server's endpoints (the reference's
    ``_server_db_hold``, shared by the pool's proof and the pool estimate)."""
    return max(
        (
            sum(
                float(step.quantity)
                for step in ep.steps
                if step.is_io and step.kind == EndpointStepIO.DB
            )
            for ep in server.endpoints
        ),
        default=0.0,
    )


def _workload_count_model(workload, horizon: float) -> tuple[float, float, float, float]:
    """(users, rate, window, count_var) of one generator's arrival count:
    the Poisson part plus the windowed user-draw part of its variance."""
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
    return users, rate, window, count_var


def _estimate_capacity(payload: SimulationPayload) -> tuple[int, int]:
    """(max_requests, pool_size): the reference's fluid capacity model.

    The pool holds every concurrently live request, queue backlog of a
    saturated resource included; ``max_requests`` is a 6-sigma bound on the
    arrival count.  Generators are independent sources: their rates, users
    and count variances add.  Stochastic segments enter at their worst-case
    duration (a cache miss, a 6-sigma token draw), and a DB pool caps its
    server's throughput at K over the hold time.  Overflow stays possible
    and is counted, never hidden.
    """
    horizon = float(payload.sim_settings.total_simulation_time)
    rate = users = count_var = max_window = 0.0
    for workload in payload.generators:
        g_users, g_rate, window, g_count_var = _workload_count_model(workload, horizon)
        users += g_users
        rate += g_rate
        max_window = max(max_window, window)
        count_var += g_count_var
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
            segs, ram, cache, llm = _compile_endpoint(endpoint)
            worst = []
            for (kind, dur), c, m in zip(segs, cache, llm):
                if c is not None:
                    worst.append((SEG_IO, max(dur, c[1])))
                elif m is not None:
                    worst.append((SEG_IO, _llm_worst(dur, m)))
                else:
                    worst.append((kind, dur))
            cpu_req = max(cpu_req, sum(d for k, d in worst if k == SEG_CPU))
            io_req = max(io_req, sum(d for k, d in worst if k == SEG_IO))
            ram_req = max(ram_req, ram)
        residence = cpu_req + io_req
        residence_max = max(residence_max, residence)
        capacity = math.inf
        if cpu_req > 0:
            capacity = min(capacity, server.server_resources.cpu_cores / cpu_req)
        if ram_req > 0 and residence > 0:
            concurrent = server.server_resources.ram_mb / ram_req
            capacity = min(capacity, concurrent / residence)
        pool_k = server.server_resources.db_connection_pool
        if pool_k is not None:
            db_req = _server_db_hold(server)
            if db_req > 0:
                capacity = min(capacity, float(pool_k) / db_req)
        if capacity < math.inf:
            backlog += max(0.0, rate - capacity) * horizon
            # the longest sampling window sustains a burst the longest
            burst_backlog += max(0.0, burst_rate - capacity) * min(max_window, horizon)

    # spikes park in-flight requests on an edge, and their release floods the
    # downstream queue: budget rate x (max concurrent spike) per edge, twice
    spike_delay = 0.0
    for event in payload.events or []:
        if event.start.spike_s is not None:
            spike_delay += float(event.start.spike_s)

    edge_delay = sum(edge.latency.mean for edge in payload.topology_graph.edges)
    in_flight = rate * (residence_max + edge_delay + 2.0 * spike_delay)
    want = 4.0 * in_flight + 1.5 * (backlog + burst_backlog) + 64.0
    pool = int(2 ** math.ceil(math.log2(max(64.0, want))))
    return max_requests, min(pool, 32768)


def _server_entry_rates(payload: SimulationPayload) -> np.ndarray | None:
    """(NS,) nominal request rate into each server (the reference's
    ``_server_entry_rates``).

    Each generator's entry chain is walked to the first LB or server; an LB
    spreads the rate uniformly over the servers it covers, and
    server-to-server exits pass their rate downstream in topological order.
    None when the server chain has a cycle.  Dropout is ignored: these are
    upper bounds for the non-binding proofs.
    """
    servers = payload.topology_graph.nodes.servers
    server_index = {server.id: s for s, server in enumerate(servers)}
    lb = payload.topology_graph.nodes.load_balancer
    out_edge = {e.source: e for e in payload.topology_graph.edges}

    srv_rate = np.zeros(len(servers))
    for workload in payload.generators:
        rate = (
            float(workload.avg_active_users.mean)
            * float(workload.avg_request_per_minute_per_user.mean)
            / 60.0
        )
        node = workload.id
        for _ in range(len(payload.topology_graph.edges) + 1):
            e = out_edge.get(node)
            if e is None:
                break
            if e.target in server_index:
                srv_rate[server_index[e.target]] += rate
                break
            if lb is not None and e.target == lb.id:
                covered = sorted(lb.server_covered)
                for sid in covered:
                    srv_rate[server_index[sid]] += rate / len(covered)
                break
            node = e.target

    child = {}
    indeg = [0] * len(servers)
    for server in servers:
        e = out_edge.get(server.id)
        if e is not None and e.target in server_index:
            child[server_index[server.id]] = server_index[e.target]
            indeg[server_index[e.target]] += 1
    frontier = [s for s in range(len(servers)) if indeg[s] == 0]
    seen = 0
    while frontier:
        s = frontier.pop()
        seen += 1
        t = child.get(s)
        if t is not None:
            srv_rate[t] += srv_rate[s]
            indeg[t] -= 1
            if indeg[t] == 0:
                frontier.append(t)
    if seen != len(servers):
        return None
    return srv_rate


def _rho_cap_needed(rho_b: float) -> float:
    """Queue length whose stationary tail probability is below 1e-12 at
    burst utilisation ``rho_b`` (inf when the queue is not stable enough)."""
    if rho_b >= 0.9:
        return math.inf
    return math.log(1e-12) / math.log(max(rho_b, 1e-9)) + 16.0


@dataclass
class _Controls:
    """The DB pools and overload controls as the kernel models them, per
    server."""

    db_model: list[bool]
    queue_cap: np.ndarray
    conn_cap: np.ndarray
    rate_limit: np.ndarray
    rate_burst: np.ndarray
    queue_timeout: np.ndarray
    proof_rate_headroom: float


def _step_worst(step) -> float:
    """A step's worst-case duration: a cache step's miss latency, an LLM
    step's 6-sigma token draw."""
    if step.is_stochastic_cache:
        return max(float(step.quantity), float(step.cache_miss_time))
    if step.is_llm:
        params = (step.llm_tokens_mean, step.llm_time_per_token, 0.0)
        return _llm_worst(float(step.quantity), params)
    return float(step.quantity)


def _lower_overload(payload: SimulationPayload) -> _Controls:
    """Model each configured DB pool and overload control, or lower it away
    when the reference's non-binding proof shows it unreachable (the
    reference's ``_compile_payload``, DB pools to deadlines)."""
    servers = payload.topology_graph.nodes.servers
    n_servers = len(servers)
    srv_rates_est = _server_entry_rates(payload)
    users_est = sum(float(g.avg_active_users.mean) for g in payload.generators)
    burst_factor = 1.0 + 3.0 / math.sqrt(max(users_est, 1.0))
    headroom = math.inf

    # DB pools: K comfortably above the 6-sigma bound on concurrent io_db
    # holders (Little's law at the burst-inflated entry rate) never binds,
    # and io_db lowers to plain IO
    db_model: list[bool] = []
    for s_i, server in enumerate(servers):
        pool_k = server.server_resources.db_connection_pool
        db_dur = _server_db_hold(server)
        if pool_k is None or db_dur <= 0:
            db_model.append(False)  # no pool, or one no step holds
            continue
        if srv_rates_est is None:
            db_model.append(True)  # cyclic chain: no rate bound
            continue
        m = srv_rates_est[s_i] * burst_factor * db_dur
        binding = not pool_k >= m + 6.0 * math.sqrt(max(m, 1.0)) + 8.0
        db_model.append(binding)
        if not binding and pool_k > 8:
            # the proof holds up to the rate scale f with
            # K >= f*m + 6*sqrt(f*m) + 8
            t = (-6.0 + math.sqrt(36.0 + 4.0 * (pool_k - 8.0))) / 2.0
            headroom = min(headroom, (t * t) / max(m, 1e-12))

    def cpu_time(server) -> float:
        return max(
            (sum(st.quantity for st in ep.steps if st.is_cpu) for ep in server.endpoints),
            default=0.0,
        )

    # ready-queue caps: a stable queue's length has a geometric tail, so a
    # cap with rho_b^(cap-16) < 1e-12 is unreachable and lowers away
    queue_cap = np.full(n_servers, -1, dtype=np.int32)
    for s_i, server in enumerate(servers):
        cap = server.overload.max_ready_queue if server.overload else None
        if cap is None:
            continue
        cpu_dur = cpu_time(server)
        if cpu_dur <= 0 or srv_rates_est is None:
            queue_cap[s_i] = cap if cpu_dur > 0 else -1
            continue
        cores = server.server_resources.cpu_cores
        rho_b = srv_rates_est[s_i] * burst_factor * cpu_dur / max(cores, 1)
        needed = _rho_cap_needed(rho_b)
        cap = min(cap, 2**31 - 1)
        if cap >= needed:
            rho_max = min(0.9, math.exp(math.log(1e-12) / max(cap - 16.0, 1.0)))
            headroom = min(headroom, rho_max / max(rho_b, 1e-12))
        else:
            queue_cap[s_i] = cap

    # connection caps: residents ~ rate x (residence + core-queue waits) by
    # Little's law; a cap comfortably above the burst-inflated bound lowers
    # away, and the largest rate scale the proof covers is bisected
    conn_cap = np.full(n_servers, -1, dtype=np.int32)
    for s_i, server in enumerate(servers):
        cap = server.overload.max_connections if server.overload else None
        if cap is None:
            continue
        cap = min(cap, 2**31 - 1)
        if srv_rates_est is None or db_model[s_i]:
            # a modelled DB pool's waits are outside the residence bound
            conn_cap[s_i] = cap
            continue
        endpoints = server.endpoints
        residence = max(
            (sum(_step_worst(st) for st in ep.steps if not st.is_ram) for ep in endpoints),
            default=0.0,
        )
        cpu_dur = cpu_time(server)
        visits = max((sum(1 for st in ep.steps if st.is_cpu) for ep in endpoints), default=0)
        max_ram = max(
            (sum(st.quantity for st in ep.steps if st.is_ram) for ep in endpoints),
            default=0.0,
        )
        cores = server.server_resources.cpu_cores
        capacity_mb = float(server.server_resources.ram_mb)
        rate_here = srv_rates_est[s_i]

        def conn_proof_holds(scale: float, cap=cap, residence=residence,
                             cpu_dur=cpu_dur, visits=visits, cores=cores,
                             max_ram=max_ram, capacity_mb=capacity_mb,
                             rate_here=rate_here) -> bool:
            burst = rate_here * burst_factor * scale
            rho = burst * cpu_dur / max(cores, 1)
            if rho >= 0.95:
                return False
            wait = visits * rho / (1.0 - rho) * cpu_dur / max(cores, 1)
            # RAM admission waits are outside the residence bound: the
            # proof holds only while RAM itself cannot bind
            if max_ram > 0 and capacity_mb / max_ram < 4.0 * burst * (residence + wait) + 4.0:
                return False
            m = burst * (residence + wait)
            return cap >= 4.0 * m + 8.0

        if conn_proof_holds(1.0):
            lo, hi = 1.0, 1e6
            for _ in range(48):
                mid = (lo + hi) / 2.0
                if conn_proof_holds(mid):
                    lo = mid
                else:
                    hi = mid
            headroom = min(headroom, lo)
        else:
            conn_cap[s_i] = cap

    # token buckets: with burst-inflated demand below the refill rate the
    # bucket's deficit walk has a geometric tail; rho_rl^(burst-8) < 1e-12
    # never empties and lowers away
    rate_limit = np.full(n_servers, -1.0, dtype=np.float32)
    rate_burst = np.zeros(n_servers, dtype=np.int32)
    for s_i, server in enumerate(servers):
        rps = server.overload.rate_limit_rps if server.overload else None
        if rps is None:
            continue
        burst = int(server.overload.effective_burst)
        if srv_rates_est is None:
            rate_limit[s_i] = rps
            rate_burst[s_i] = burst
            continue
        rho_rl = srv_rates_est[s_i] * burst_factor / rps
        if rho_rl < 0.9 and rho_rl ** max(burst - 8.0, 1.0) < 1e-12:
            rho_max = min(0.9, math.exp(math.log(1e-12) / max(burst - 8.0, 1.0)))
            headroom = min(headroom, rho_max / max(rho_rl, 1e-12))
        else:
            rate_limit[s_i] = rps
            rate_burst[s_i] = burst

    # dequeue deadlines: a wait of D needs ~D * cores / cpu_dur requests
    # ahead, so the queue-cap tail bound applies at that length
    queue_timeout = np.full(n_servers, -1.0, dtype=np.float32)
    for s_i, server in enumerate(servers):
        deadline = server.overload.queue_timeout_s if server.overload else None
        if deadline is None:
            continue
        cpu_dur = cpu_time(server)
        if cpu_dur <= 0:
            continue  # no core queue: the deadline is inert
        if srv_rates_est is None:
            queue_timeout[s_i] = deadline
            continue
        cores = server.server_resources.cpu_cores
        rho_b = srv_rates_est[s_i] * burst_factor * cpu_dur / max(cores, 1)
        eq_len = deadline * cores / cpu_dur
        if eq_len >= _rho_cap_needed(rho_b):
            rho_max = min(0.9, math.exp(math.log(1e-12) / max(eq_len - 16.0, 1.0)))
            headroom = min(headroom, rho_max / max(rho_b, 1e-12))
        else:
            queue_timeout[s_i] = deadline

    return _Controls(
        db_model, queue_cap, conn_cap, rate_limit, rate_burst, queue_timeout, headroom,
    )


def _lower_breaker(
    lb, ctl: _Controls, lb_slots: list[int], lb_target: np.ndarray, edges,
) -> tuple[int, float, int, bool]:
    """(threshold, cooldown, probes, lowered) of the LB's circuit breaker.

    Modelled only where a failure channel exists: a modelled control on a
    covered server, or dropout on an LB out-edge (fault windows, the
    reference's other channel, are outside the slice).  Otherwise the
    breaker can never trip and lowers away.
    """
    breaker = lb.circuit_breaker if lb is not None else None
    if breaker is None or not lb_slots:
        return 0, 0.0, 0, False
    covered = set(lb_target.tolist())
    has_channel = any(
        ctl.queue_cap[s] >= 0
        or ctl.conn_cap[s] >= 0
        or ctl.rate_limit[s] >= 0
        or ctl.queue_timeout[s] >= 0
        for s in covered
    ) or any(float(edges[e].dropout_rate) > 0 for e in lb_slots)
    if not has_channel:
        return 0, 0.0, 0, True
    return (
        int(breaker.failure_threshold),
        float(breaker.cooldown_s),
        int(breaker.half_open_probes),
        False,
    )


def _lower_events(
    payload: SimulationPayload,
    edge_index: dict[str, int],
    server_index: dict[str, int],
    lb_target: np.ndarray,
) -> tuple[np.ndarray, ...]:
    """(spike_times, spike_values, timeline_times, timeline_down,
    timeline_slot): superposed spikes as a cumulative per-edge table on
    their breakpoints, and outages as LB-slot removals and re-insertions
    sorted by time, END before START on ties; a server the LB does not
    cover gets slot -1."""
    n_edges = len(edge_index)
    spikes: list[tuple[float, float, int]] = []  # (time, delta, edge)
    outages: list[tuple[float, int, int, int]] = []  # (time, start mark, down, slot)
    lb_slot_of_server = {int(lb_target[slot]): slot for slot in range(len(lb_target))}
    for event in payload.events or []:
        if event.start.kind == EventDescription.NETWORK_SPIKE_START:
            eidx = edge_index[event.target_id]
            spike = float(event.start.spike_s or 0.0)
            spikes.append((event.start.t_start, spike, eidx))
            spikes.append((event.end.t_end, -spike, eidx))
        else:
            slot = lb_slot_of_server.get(server_index[event.target_id], -1)
            outages.append((event.start.t_start, 1, 1, slot))
            outages.append((event.end.t_end, 0, 0, slot))

    change_times = sorted({0.0} | {t for t, _, _ in spikes})
    time_pos = {t: i for i, t in enumerate(change_times)}
    deltas = np.zeros((len(change_times), n_edges), dtype=np.float32)
    for t, delta, eidx in spikes:
        deltas[time_pos[t], eidx] += delta
    outages.sort(key=lambda entry: (entry[0], entry[1]))
    return (
        np.array(change_times, dtype=np.float32),
        np.cumsum(deltas, axis=0).astype(np.float32),
        np.array([t for t, _, _, _ in outages], dtype=np.float32),
        np.array([down for _, _, down, _ in outages], dtype=np.int32),
        np.array([slot for _, _, _, slot in outages], dtype=np.int32),
    )



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

    def entry_chain(gen_id: str) -> tuple[list[int], int, int]:
        """generator -> (client ->)* first LB / server"""
        chain: list[int] = []
        cursor = gen_id
        for _ in range(n_edges + 1):
            if cursor not in out_edge_of:
                msg = f"node {cursor!r} has no outgoing edge on the entry path"
                raise PayloadError(msg)
            eidx = out_edge_of[cursor]
            chain.append(eidx)
            kind, target = target_of(edges[eidx].target)
            if kind in (TARGET_LB, TARGET_SERVER):
                return chain, kind, target
            cursor = edges[eidx].target
        msg = "entry path does not reach a server or load balancer"
        raise PayloadError(msg)

    generators = payload.generators
    gen_chains = [entry_chain(g.id) for g in generators]
    entry_edges, entry_kind, entry_target = gen_chains[0]
    chain_width = max(len(c) for c, _, _ in gen_chains)
    gen_entry_edges = np.full((len(gen_chains), chain_width), -1, dtype=np.int32)
    for g, (chain, _, _) in enumerate(gen_chains):
        gen_entry_edges[g, : len(chain)] = chain

    # ---- DB pools and overload controls, then the servers ----
    ctl = _lower_overload(payload)
    max_endpoints = max(len(server.endpoints) for server in servers)
    compiled = [
        [_compile_endpoint(ep, db_pooled=ctl.db_model[s]) for ep in server.endpoints]
        for s, server in enumerate(servers)
    ]
    max_segments = max(
        (len(segs) for per_server in compiled for segs, *_ in per_server), default=0,
    )
    shape = (n_servers, max_endpoints, max_segments + 1)
    seg_kind = np.zeros(shape, dtype=np.int32)
    seg_dur = np.zeros(shape, dtype=np.float32)
    seg_hit_prob = np.zeros(shape, dtype=np.float32)
    seg_miss_dur = np.zeros(shape, dtype=np.float32)
    seg_llm_tokens = np.zeros(shape, dtype=np.float32)
    seg_llm_tpt = np.zeros(shape, dtype=np.float32)
    seg_llm_cost = np.zeros(shape, dtype=np.float32)
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
        for e, (segs, ram, cache, llm) in enumerate(compiled[s]):
            endpoint_ram[s, e] = ram
            for k, (kind, dur) in enumerate(segs):
                seg_kind[s, e, k] = kind
                seg_dur[s, e, k] = dur
                if cache[k] is not None:
                    seg_hit_prob[s, e, k], seg_miss_dur[s, e, k] = cache[k]
                if llm[k] is not None:
                    tokens, per_token, cost = llm[k]
                    seg_llm_tokens[s, e, k] = tokens
                    seg_llm_tpt[s, e, k] = per_token
                    seg_llm_cost[s, e, k] = cost
    server_db_pool = np.array(
        [
            server.server_resources.db_connection_pool if ctl.db_model[s] else -1
            for s, server in enumerate(servers)
        ],
        dtype=np.int32,
    )

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

    # ---- breaker, events ----
    breaker = _lower_breaker(lb, ctl, lb_slots, lb_target, edges)
    spike_times, spike_values, tl_times, tl_down, tl_slot = _lower_events(
        payload, edge_index, server_index, lb_target,
    )

    # ---- capacities ----
    max_requests, pool_estimate = _estimate_capacity(payload)
    events_per_request = (
        2 * (len(entry_edges) + 2)  # spawn + entry hops + lb + exits
        + 3 * (max_segments + 1)  # segment starts / ends + grants
        + 4
    )
    # one iteration per timeline entry
    max_iterations = max_requests * events_per_request + len(tl_times) + 1024

    def user_var(gen) -> float:
        users = gen.avg_active_users
        if users.distribution == Distribution.NORMAL and users.variance is not None:
            return float(users.variance)
        return -1.0

    gen = generators[0]
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
        seg_hit_prob=seg_hit_prob,
        seg_miss_dur=seg_miss_dur,
        seg_llm_tokens=seg_llm_tokens,
        seg_llm_tpt=seg_llm_tpt,
        seg_llm_cost=seg_llm_cost,
        server_db_pool=server_db_pool,
        exit_edge=exit_edge,
        exit_kind=exit_kind,
        exit_target=exit_target,
        lb_algo=lb_algo,
        lb_edge_index=lb_edge_index,
        lb_target=lb_target,
        spike_times=spike_times,
        spike_values=spike_values,
        timeline_times=tl_times,
        timeline_down=tl_down,
        timeline_slot=tl_slot,
        user_mean=float(gen.avg_active_users.mean),
        user_var=user_var(gen),
        user_window=float(gen.user_sampling_window),
        req_per_user_per_sec=float(gen.avg_request_per_minute_per_user.mean) / 60.0,
        gen_user_mean=np.array(
            [float(g.avg_active_users.mean) for g in generators], np.float64,
        ),
        gen_user_var=np.array([user_var(g) for g in generators], np.float64),
        gen_window=np.array(
            [float(g.user_sampling_window) for g in generators], np.float64,
        ),
        gen_rate=np.array(
            [float(g.avg_request_per_minute_per_user.mean) / 60.0 for g in generators],
            np.float64,
        ),
        gen_entry_edges=gen_entry_edges,
        gen_entry_len=np.array([len(c) for c, _, _ in gen_chains], np.int32),
        gen_entry_target_kind=np.array([k for _, k, _ in gen_chains], np.int32),
        gen_entry_target=np.array([t for _, _, t in gen_chains], np.int32),
        horizon=float(payload.sim_settings.total_simulation_time),
        pool_size=pool_size or pool_estimate,
        max_iterations=max_iterations,
        server_queue_cap=ctl.queue_cap,
        server_conn_cap=ctl.conn_cap,
        server_rate_limit=ctl.rate_limit,
        server_rate_burst=ctl.rate_burst,
        server_queue_timeout=ctl.queue_timeout,
        breaker_threshold=breaker[0],
        breaker_cooldown=breaker[1],
        breaker_probes=breaker[2],
        breaker_lowered=breaker[3],
        proof_rate_headroom=ctl.proof_rate_headroom,
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
        elif spec.type == "bool":
            kw[name] = bool(value)
        else:
            kw[name] = float(value)
    unsupported = [name for name, test in _FEATURE_TESTS if test(fields)]
    seg_kinds = set(np.unique(np.asarray(fields["seg_kind"])).tolist())
    unsupported += sorted(
        {UNSUPPORTED_SEGMENTS[k] for k in seg_kinds if k in UNSUPPORTED_SEGMENTS},
    )
    return StaticPlan(**kw, unsupported=tuple(unsupported))
