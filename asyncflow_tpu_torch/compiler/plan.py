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
  (a modelled control or a server-outage fault window on a covered server,
  or dropout, or a dropout-boosting edge fault, on an LB edge);
- event injection becomes a cumulative spike table per edge and a sorted
  outage timeline of LB slots (END before START on ties);
- a fault timeline becomes piecewise breakpoint tables (``fault_*``,
  ``compiler/faults.py``), a retry policy plan scalars (``retry_*``) that
  amplify the capacity bound by the attempt cap, and a hazard model dense
  per-domain arrays (``hz_*``, ``compiler/hazards.py``) whose windows are
  sampled per scenario at sweep time.

:func:`plan_from_arrays` carries a plan's fields, as numpy arrays, across
from the reference package; features outside the slice that such a plan
carries are recorded in :attr:`StaticPlan.unsupported` and refused by the
engine before any launch.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass, field

import numpy as np

from asyncflow_tpu_torch.config.constants import (
    Distribution,
    EndpointStepIO,
    EventDescription,
    LbAlgorithmsName,
)
from asyncflow_tpu_torch.compiler.faults import lower_faults, lower_retry
from asyncflow_tpu_torch.compiler.hazards import lower_hazards
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
    #: (G,) i64 6-sigma arrival-count bound of each stream: its lanes on the
    #: fast path
    gen_slots: np.ndarray
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
    # ---- core-queue visit view of the endpoint programs (scan fast path):
    # burst k is enqueued burst_pre_io[..., k] seconds after burst k-1 ends
    max_bursts: int  # KB: most CPU bursts of any endpoint
    n_bursts: np.ndarray  # (NS, NEP) i32
    burst_dur: np.ndarray  # (NS, NEP, max(KB, 1)) f32
    burst_pre_io: np.ndarray  # (NS, NEP, max(KB, 1)) f32
    endpoint_post_io: np.ndarray  # (NS, NEP) f32
    # the fast path's stochastic tables: each endpoint's trailing IO split
    # around its single DB query (zeros where it has none), and each cache
    # segment's placement (a burst index, CACHE_PRE_DB, CACHE_POST_DB or
    # CACHE_UNUSED), miss probability and miss-minus-hit extra
    fp_db_pre: np.ndarray  # (NS, NEP) f32
    fp_db_dur: np.ndarray  # (NS, NEP) f32
    fp_db_post: np.ndarray  # (NS, NEP) f32
    fp_cache_slot: np.ndarray  # (NS, NEP, CMAX) i32
    fp_cache_miss_prob: np.ndarray  # (NS, NEP, CMAX) f32
    fp_cache_extra: np.ndarray  # (NS, NEP, CMAX) f32
    # ---- gauge sampling and the arrival-count bound ----
    sample_period: float
    n_samples: int
    #: 6-sigma bound on a scenario's arrival count (the fast path's lanes)
    max_requests: int
    # ---- fast-path eligibility (the reference's _fastpath_analysis) ----
    fastpath_ok: bool
    fastpath_reason: str
    #: servers in topological order of the exit-chain DAG
    server_topo_order: list[int]
    #: per-server RAM admission on the fast path: -1 = proven non-binding
    #: (not modelled), 0 = no RAM steps, k > 0 = a FIFO admission queue of
    #: k slots (one uniform need, ram_mb // need)
    ram_slots: np.ndarray
    #: least-connections ring capacity per LB slot (0 = round robin / no LB)
    lc_ring: int
    #: highest nominal core utilisation of a multi-burst server (0 if none)
    relax_rho: float
    # ---- resilience (compiler/faults.py, compiler/hazards.py) ----
    #: fault tables: breakpoints with a leading identity row at t = 0; (K,)
    #: change times and (K, NS) outage flags, (M,) change times and (M, NE)
    #: latency factors and dropout boosts
    fault_srv_times: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float32))
    fault_srv_down: np.ndarray = field(default_factory=lambda: np.empty((1, 0), np.int32))
    fault_edge_times: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float32))
    fault_edge_lat: np.ndarray = field(default_factory=lambda: np.empty((1, 0), np.float32))
    fault_edge_drop: np.ndarray = field(default_factory=lambda: np.empty((1, 0), np.float32))
    #: the client retry policy (retry_timeout < 0: none; budget < 0: none)
    retry_timeout: float = -1.0
    retry_max_attempts: int = 1
    retry_backoff_base: float = 0.0
    retry_backoff_mult: float = 1.0
    retry_backoff_cap: float = 0.0
    retry_jitter: float = 0.0
    retry_budget_tokens: float = -1.0
    retry_budget_refill: float = 0.0
    #: the hazard model: (D,) per-domain MTBF / MTTR laws (_DIST_IDS codes),
    #: means and scales, edge degrade magnitudes, (D, NS) / (D, NE) target
    #: masks, and F window slots per (scenario, domain); size 0 = none
    hz_mtbf_dist: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    hz_mtbf_mean: np.ndarray = field(default_factory=lambda: np.empty(0, np.float64))
    hz_mtbf_var: np.ndarray = field(default_factory=lambda: np.empty(0, np.float64))
    hz_mttr_dist: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    hz_mttr_mean: np.ndarray = field(default_factory=lambda: np.empty(0, np.float64))
    hz_mttr_var: np.ndarray = field(default_factory=lambda: np.empty(0, np.float64))
    hz_lat_factor: np.ndarray = field(default_factory=lambda: np.empty(0, np.float64))
    hz_drop_boost: np.ndarray = field(default_factory=lambda: np.empty(0, np.float64))
    hz_srv_targets: np.ndarray = field(default_factory=lambda: np.empty((0, 0), np.int8))
    hz_edge_targets: np.ndarray = field(default_factory=lambda: np.empty((0, 0), np.int8))
    hz_max_faults: int = 0
    #: the servers' and edges' ids in plan order (the names a streamed gauge
    #: series selects its columns by)
    server_ids: list[str] = field(default_factory=list)
    edge_ids: list[str] = field(default_factory=list)
    #: features outside this slice that the plan carries (only plans
    #: carried across with :func:`plan_from_arrays` can have any)
    unsupported: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        # hand-built plans: identity fault tables at the plan's own widths
        if self.fault_srv_down.shape[1] != self.n_servers:
            self.fault_srv_times = np.zeros(1, np.float32)
            self.fault_srv_down = np.zeros((1, self.n_servers), np.int32)
        if self.fault_edge_lat.shape[1] != self.n_edges:
            self.fault_edge_times = np.zeros(1, np.float32)
            self.fault_edge_lat = np.ones((1, self.n_edges), np.float32)
            self.fault_edge_drop = np.zeros((1, self.n_edges), np.float32)

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

    @property
    def has_faults(self) -> bool:
        """Does a fault window change some server or edge."""
        return bool(
            np.any(self.fault_srv_down != 0)
            or np.any(self.fault_edge_lat != 1.0)
            or np.any(self.fault_edge_drop != 0.0),
        )

    @property
    def has_hazards(self) -> bool:
        """Is a chaos campaign lowered: fault windows sampled per scenario."""
        return bool(self.hz_mtbf_mean.size) and self.hz_max_faults > 0

    @property
    def hz_srv_mask(self) -> np.ndarray:
        """(NS,) bool: the server is a target of some failure domain."""
        if not self.hz_srv_targets.size:
            return np.zeros(self.n_servers, bool)
        return np.asarray(self.hz_srv_targets).any(axis=0)

    @property
    def hz_edge_mask(self) -> np.ndarray:
        """(NE,) bool: the edge is a target of some failure domain."""
        if not self.hz_edge_targets.size:
            return np.zeros(self.n_edges, bool)
        return np.asarray(self.hz_edge_targets).any(axis=0)

    @property
    def has_retry(self) -> bool:
        """Is a client retry / timeout policy modelled."""
        return self.retry_timeout > 0

    @property
    def n_gauges(self) -> int:
        """Gauge layout: [edge connections | ready | io | ram] per component."""
        return self.n_edges + 3 * self.n_servers

    def gauge_edge(self, edge_idx: int) -> int:
        return edge_idx

    def gauge_ready(self, server_idx: int) -> int:
        return self.n_edges + server_idx

    def gauge_io(self, server_idx: int) -> int:
        return self.n_edges + self.n_servers + server_idx

    def gauge_ram(self, server_idx: int) -> int:
        return self.n_edges + 2 * self.n_servers + server_idx


#: the StaticPlan fields carried across from a reference plan and held
#: equal to it, in declaration order
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


def _gen_slot_bounds(payload: SimulationPayload) -> np.ndarray:
    """(G,) per-generator 6-sigma arrival-count bounds: each stream's own
    slice of the fast path's lanes."""
    horizon = float(payload.sim_settings.total_simulation_time)
    out = []
    for workload in payload.generators:
        _, rate, _, count_var = _workload_count_model(workload, horizon)
        out.append(int(rate * horizon + 6.0 * math.sqrt(max(count_var, 1.0)) + 64))
    return np.array(out, np.int64)


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
    # retries amplify the offered load: a logical request may issue up to
    # max_attempts attempts, and a timed-out one keeps its server busy
    if payload.retry_policy is not None:
        amp = float(payload.retry_policy.max_attempts)
        rate *= amp
        count_var *= amp * amp
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
    lb, ctl: _Controls, lb_slots: list[int], lb_target: np.ndarray, edges, faults,
) -> tuple[int, float, int, bool]:
    """(threshold, cooldown, probes, lowered) of the LB's circuit breaker.

    Modelled only where a failure channel exists: a modelled control or a
    server-outage fault window on a covered server, or dropout or a
    dropout-boosting fault window on an LB out-edge.  Otherwise the breaker
    can never trip and lowers away.
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
        or bool(np.any(faults.srv_down[:, s] != 0))
        for s in covered
    ) or any(
        float(edges[e].dropout_rate) > 0 or bool(np.any(faults.edge_drop[:, e] > 0))
        for e in lb_slots
    )
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


# ---------------------------------------------------------------------------
# scan fast path: the visit view and the eligibility decision
# ---------------------------------------------------------------------------

#: nominal per-server core utilisation above which the multi-burst
#: relaxation is biased against the exact engines (the reference's measured
#: envelope, compiler/plan.py RELAX_RHO_MAX)
RELAX_RHO_MAX = 0.70

# fast-path placements of a stochastic cache segment's miss extra (values
# < 0; a value >= 0 is the index of the CPU burst whose pre-IO holds it)
CACHE_PRE_DB = -2
CACHE_POST_DB = -3
CACHE_UNUSED = -1


def _fastpath_lowering(
    segs: list[tuple[int, float]], cache: list[CacheParams | None],
) -> tuple[tuple[float, float, float], list[tuple[int, float, float]], str]:
    """One endpoint's fast-path tables: ``((db_pre, db_dur, db_post),
    cache_places, reason)``, the trailing IO split around its single DB
    segment, one ``(slot, miss_prob, miss_extra)`` per cache segment, and a
    non-empty ``reason`` for a shape outside the fast path's model (the
    reference's ``_fastpath_lowering``)."""
    n_cpu = sum(1 for k, _ in segs if k == SEG_CPU)
    db_seen = 0
    burst_idx = 0
    db_pre = db_dur = db_post = 0.0
    places: list[tuple[int, float, float]] = []
    for i, (kind, dur) in enumerate(segs):
        if kind == SEG_CPU:
            burst_idx += 1
            continue
        trailing = burst_idx >= n_cpu
        if kind == SEG_DB:
            if db_seen:
                return (0.0, 0.0, 0.0), [], "multiple DB queries per endpoint"
            if not trailing:
                return (
                    (0.0, 0.0, 0.0),
                    [],
                    "DB query before a CPU burst (pool wait feeds back "
                    "into the core queue)",
                )
            db_seen = 1
            db_dur = dur
            continue
        if kind == SEG_CACHE:
            hit_prob, miss = cache[i]
            slot = burst_idx if not trailing else (CACHE_POST_DB if db_seen else CACHE_PRE_DB)
            places.append((slot, 1.0 - hit_prob, miss - dur))
        if trailing:
            if db_seen:
                db_post += dur
            else:
                db_pre += dur
    return (db_pre, db_dur, db_post), places, ""


def _burst_decomposition(
    segs: list[tuple[int, float]],
) -> tuple[list[float], list[float], float]:
    """An alternating segment program as core-queue visits: ``(burst_dur,
    burst_pre_io, post_io)``.  Burst k holds a core ``burst_dur[k]`` seconds
    and is enqueued ``burst_pre_io[k]`` seconds after burst k-1 ends (IO
    holds no core); ``post_io`` runs after the last burst."""
    burst_dur: list[float] = []
    burst_pre: list[float] = []
    io_acc = 0.0
    for kind, dur in segs:
        if kind == SEG_CPU:
            burst_pre.append(io_acc)
            burst_dur.append(dur)
            io_acc = 0.0
        else:  # every other segment holds no core
            io_acc += dur
    return burst_dur, burst_pre, io_acc


def _socket_cap_scan_reason(
    compiled_s: list, cap: int, fp_lowered_s: list, db_binding: bool,
) -> str:
    """Why a modelled connection cap cannot ride the reference's socket
    scan ("" when it can)."""
    visits = max(
        (sum(1 for k, _ in segs if k == SEG_CPU) for segs, *_ in compiled_s), default=0,
    )
    if visits > 1:
        return "on a multi-burst endpoint"
    if cap > 128:
        return f"{cap} exceeds the scan ring bound (128)"
    if db_binding:
        return "with a binding DB connection pool"
    pre_offsets = set()
    for segs, *_ in compiled_s:
        _dur, pre, _post = _burst_decomposition(segs)
        if pre:
            pre_offsets.add(round(pre[0], 12))
    if len(pre_offsets) > 1:
        return "with heterogeneous pre-burst IO offsets"
    if any(slot >= 0 for _split, places, _reason in fp_lowered_s for slot, _p, _x in places):
        return "with stochastic pre-burst cache extras"
    return ""


@dataclass
class _FastDecision:
    ok: bool
    reason: str = ""
    topo: list[int] | None = None
    ram_slots: np.ndarray | None = None
    lc_ring: int = 0
    relax_rho: float = 0.0


def _fastpath_analysis(
    payload: SimulationPayload,
    compiled: list,
    fp_lowered: list,
    ctl: _Controls,
    server_db_pool: np.ndarray,
    exit_kind: np.ndarray,
    exit_target: np.ndarray,
    lb_algo: int,
    n_outage_marks: int,
    lb_edge_means: list[float],
    max_spike: float,
    breaker_threshold: int,
    gen_targets: list[tuple[int, int]],
) -> _FastDecision:
    """May the reference's scan fast path run this plan, and with what
    per-server treatment: the reference's ``_fastpath_analysis``, decision
    for decision and reason for reason.  Its refusals of serving steps,
    trace replay, retries with several streams, hedging, LB health gates
    and brownout are not repeated: the port's schemas refuse those
    features before a plan exists."""
    servers = payload.topology_graph.nodes.servers
    n_servers = len(servers)

    def refuse(reason: str) -> _FastDecision:
        return _FastDecision(False, reason, [], np.empty(0, np.int32), 0, 0.0)

    lb = payload.topology_graph.nodes.load_balancer
    if n_outage_marks > 0 and lb is None:
        return refuse("outage events without a load balancer")
    for edge in payload.topology_graph.edges:
        if edge.latency.distribution == Distribution.POISSON:
            return refuse(f"edge {edge.id}: poisson latency unsupported")
    if len(payload.generators) > 1 and len(set(gen_targets)) > 1:
        return refuse(
            "multiple generators with distinct entry targets (modeled on the event engines)",
        )
    rate = 0.0
    rate_var = 0.0
    for g in payload.generators:
        users_g = float(g.avg_active_users.mean)
        rpu_g = float(g.avg_request_per_minute_per_user.mean) / 60.0
        rate += users_g * rpu_g
        rate_var += users_g * rpu_g * rpu_g if users_g >= 1.0 else (users_g * rpu_g) ** 2
    burst_rate = rate + 3.0 * math.sqrt(rate_var)

    lc_ring = 0
    if lb is not None and lb_algo != 0:
        # a 6-sigma bound on one LB edge's in-flight count
        worst_delay = max(lb_edge_means or [0.0]) + max_spike
        m = burst_rate * worst_delay
        ring = int(math.ceil(m + 6.0 * math.sqrt(max(m, 1.0)) + 16.0))
        if ring > 128:
            return refuse(f"least-connections in-flight bound too large ({ring} slots)")
        lc_ring = ring

    def visits_of(segs) -> int:
        return sum(1 for k, _ in segs if k == SEG_CPU)

    max_visits = max(
        (visits_of(segs) for per_server in compiled for segs, *_ in per_server), default=0,
    )
    if max_visits > 8:
        return refuse(f"endpoint with {max_visits} CPU bursts")
    if breaker_threshold > 0:
        return refuse(
            "load balancer: circuit breaker with a live failure channel "
            "(modeled on the event engines)",
        )

    ram_slots = np.zeros(n_servers, dtype=np.int32)
    for s, server in enumerate(servers):
        if ctl.conn_cap[s] >= 0:
            reason = _socket_cap_scan_reason(
                compiled[s], int(ctl.conn_cap[s]), fp_lowered[s], bool(server_db_pool[s] > 0),
            )
            if reason:
                return refuse(
                    f"server {server.id}: reachable connection capacity {reason} "
                    "(socket refusal modeled on the event engines)",
                )
        cap_reachable = ctl.queue_cap[s] >= 0
        if cap_reachable or ctl.queue_timeout[s] >= 0:
            visits_s = max((visits_of(segs) for segs, *_ in compiled[s]), default=0)
            max_ram_s = max((ram for _, ram, *_ in compiled[s]), default=0.0)
            name = "ready-queue cap" if cap_reachable else "dequeue deadline"
            if visits_s > 1:
                return refuse(
                    f"server {server.id}: reachable {name} on a multi-burst "
                    "endpoint (modeled on the event engines)",
                )
            if max_ram_s > 0:
                return refuse(
                    f"server {server.id}: reachable {name} with a RAM "
                    "admission tier (modeled on the event engines)",
                )
            if cap_reachable and ctl.queue_cap[s] > 128:
                return refuse(
                    f"server {server.id}: ready-queue cap {ctl.queue_cap[s]} "
                    "exceeds the scan ring bound (128)",
                )
        if any(k == SEG_LLM for segs, *_ in compiled[s] for k, _ in segs):
            return refuse(
                f"server {server.id}: LLM call dynamics (token draws and "
                "cost accounting modeled on the event engines)",
            )
        for e, (_, _, reason) in enumerate(fp_lowered[s]):
            if reason:
                return refuse(
                    f"server {server.id} endpoint {server.endpoints[e].endpoint_name}: "
                    f"{reason} (modeled on the event engines)",
                )
        if exit_kind[s] == TARGET_LB:
            return refuse(f"server {server.id}: exit to LB creates a cycle")
        max_ram = 0.0
        residence = 0.0
        cpu_dur = 0.0
        db_dur_max = 0.0
        visits = 1
        needs: set[float] = set()
        for segs, ram, cache, *_ in compiled[s]:
            max_ram = max(max_ram, ram)
            if ram > 0:
                needs.add(ram)
            # worst-case residence: a cache segment may sleep its miss latency
            residence = max(
                residence,
                sum(
                    max(d, cache[i][1]) if cache[i] is not None else d
                    for i, (_, d) in enumerate(segs)
                ),
            )
            cpu_dur = max(cpu_dur, sum(d for k, d in segs if k == SEG_CPU))
            db_dur_max = max(db_dur_max, sum(d for k, d in segs if k == SEG_DB))
            visits = max(visits, visits_of(segs))
        has_db_station = bool(server_db_pool[s] >= 0 and db_dur_max > 0)
        if max_ram <= 0:
            continue
        # tier 1: RAM provably non-binding, queue waits included
        cores = server.server_resources.cpu_cores
        rho = burst_rate * cpu_dur / cores
        capacity_mb = float(server.server_resources.ram_mb)
        if rho < 0.95:
            wait_est = visits * rho / (1.0 - rho) * cpu_dur / cores
            if has_db_station:
                pool_k = int(server_db_pool[s])
                rho_db = burst_rate * db_dur_max / pool_k
                if rho_db >= 0.95:
                    return refuse(
                        f"server {server.id}: binding RAM with a saturated DB pool "
                        "(no wait bound; modeled on the event engines)",
                    )
                wait_est += rho_db / (1.0 - rho_db) * db_dur_max / pool_k
            if capacity_mb / max_ram >= 4.0 * burst_rate * (residence + wait_est) + 4.0:
                ram_slots[s] = -1
                continue
        # tier 2: one uniform need is a FIFO admission queue of cap // need
        # slots, settled with the core queue in one arrival-order pass
        if has_db_station:
            return refuse(f"server {server.id}: binding RAM with a binding DB pool")
        if any(slot >= 0 for _, places, _ in fp_lowered[s] for slot, _, _ in places):
            return refuse(
                f"server {server.id}: stochastic cache before a CPU burst with binding RAM",
            )
        if len(needs) == 1 and min(ram for _, ram, *_ in compiled[s]) > 0:
            if visits > 1:
                return refuse(f"server {server.id}: multi-burst endpoints with binding RAM")
            pre_ios = {
                _burst_decomposition(segs)[1][0]
                for segs, *_ in compiled[s]
                if any(k == SEG_CPU for k, _ in segs)
            }
            if len(pre_ios) > 1:
                return refuse(f"server {server.id}: varying pre-burst IO with binding RAM")
            slots = int(capacity_mb // next(iter(needs)))
            if 1 <= slots <= 1024:
                ram_slots[s] = slots
                continue
            if slots < 1:
                return refuse(f"server {server.id}: endpoint RAM exceeds server RAM")
            return refuse(f"server {server.id}: RAM admission needs {slots} slots")
        return refuse(f"server {server.id}: heterogeneous RAM needs can bind")

    for s, server in enumerate(servers):
        if ctl.conn_cap[s] >= 0 and ram_slots[s] > 0:
            return refuse(
                f"server {server.id}: reachable connection capacity with a "
                "binding RAM admission tier (socket refusal modeled on the "
                "event engines)",
            )

    # topological order of the server exit DAG
    indeg = [0] * n_servers
    for s in range(n_servers):
        if exit_kind[s] == TARGET_SERVER:
            indeg[int(exit_target[s])] += 1
    frontier = [s for s in range(n_servers) if indeg[s] == 0]
    topo: list[int] = []
    while frontier:
        s = frontier.pop()
        topo.append(s)
        if exit_kind[s] == TARGET_SERVER:
            t = int(exit_target[s])
            indeg[t] -= 1
            if indeg[t] == 0:
                frontier.append(t)
    if len(topo) != n_servers:
        return refuse("server exit chain has a cycle")

    # the multi-burst relaxation's validity envelope
    max_visits_per_server = [
        max((visits_of(segs) for segs, *_ in compiled[s]), default=0)
        for s in range(n_servers)
    ]
    relax_rho = 0.0
    if any(v > 1 for v in max_visits_per_server):
        srv_rate = _server_entry_rates(payload)
        # retries amplify the offered load up to the attempt cap: the
        # envelope must hold at the amplified rate
        retry_amp = (
            float(payload.retry_policy.max_attempts) if payload.retry_policy is not None
            else 1.0
        )
        for s in range(n_servers):
            if max_visits_per_server[s] <= 1:
                continue
            cpu_dur = max(
                (sum(d for k, d in segs if k == SEG_CPU) for segs, *_ in compiled[s]),
                default=0.0,
            )
            cores = servers[s].server_resources.cpu_cores
            rho = retry_amp * srv_rate[s] * cpu_dur / max(cores, 1)
            relax_rho = max(relax_rho, rho)
            if rho > RELAX_RHO_MAX:
                return refuse(
                    f"server {servers[s].id}: multi-burst endpoints at "
                    f"utilization {rho:.2f} > {RELAX_RHO_MAX} — outside "
                    "the relaxation's measured validity envelope "
                    "(docs/internals/fastpath.md §5)",
                )
    return _FastDecision(True, "", topo, ram_slots, lc_ring, relax_rho)



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
    # ---- the fast path's visit view and stochastic lowering ----
    bursts = [[_burst_decomposition(segs) for segs, *_ in per] for per in compiled]
    max_bursts = max((len(dur) for per in bursts for dur, _, _ in per), default=0)
    kb = max(max_bursts, 1)
    n_bursts = np.zeros((n_servers, max_endpoints), dtype=np.int32)
    burst_dur = np.zeros((n_servers, max_endpoints, kb), dtype=np.float32)
    burst_pre_io = np.zeros((n_servers, max_endpoints, kb), dtype=np.float32)
    endpoint_post_io = np.zeros((n_servers, max_endpoints), dtype=np.float32)
    for s, per in enumerate(bursts):
        for e, (dur_list, pre_list, post) in enumerate(per):
            n_bursts[s, e] = len(dur_list)
            burst_dur[s, e, : len(dur_list)] = dur_list
            burst_pre_io[s, e, : len(pre_list)] = pre_list
            endpoint_post_io[s, e] = post
    fp_lowered = [
        [_fastpath_lowering(segs, cache) for segs, _, cache, _ in per] for per in compiled
    ]
    cmax = max((len(places) for per in fp_lowered for _, places, _ in per), default=0)
    fp_db = np.zeros((3, n_servers, max_endpoints), dtype=np.float32)
    fp_cache_slot = np.full((n_servers, max_endpoints, cmax), CACHE_UNUSED, dtype=np.int32)
    fp_cache_miss_prob = np.zeros((n_servers, max_endpoints, cmax), dtype=np.float32)
    fp_cache_extra = np.zeros((n_servers, max_endpoints, cmax), dtype=np.float32)
    for s, per in enumerate(fp_lowered):
        for e, (db_split, places, reason) in enumerate(per):
            if reason:
                continue  # the analysis declines the plan; the tables stay zero
            fp_db[:, s, e] = db_split
            for j, (slot, miss_prob, extra) in enumerate(places):
                fp_cache_slot[s, e, j] = slot
                fp_cache_miss_prob[s, e, j] = miss_prob
                fp_cache_extra[s, e, j] = extra

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
    # ---- resilience: fault windows, the retry policy, the hazard model ----
    faults = lower_faults(payload)
    retry = lower_retry(payload.retry_policy)
    hazards = lower_hazards(payload)
    breaker = _lower_breaker(lb, ctl, lb_slots, lb_target, edges, faults)
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

    horizon = float(payload.sim_settings.total_simulation_time)
    sample_period = float(payload.sim_settings.sample_period_s)
    fast = _fastpath_analysis(
        payload,
        compiled,
        fp_lowered,
        ctl,
        server_db_pool,
        exit_kind,
        exit_target,
        lb_algo,
        len(tl_times),
        lb_edge_means=[float(edge_mean[e]) for e in lb_slots],
        max_spike=float(spike_values.max()) if spike_values.size else 0.0,
        breaker_threshold=breaker[0],
        gen_targets=[(int(k), int(t)) for _, k, t in gen_chains],
    )

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
        gen_slots=_gen_slot_bounds(payload),
        horizon=horizon,
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
        max_bursts=max_bursts,
        n_bursts=n_bursts,
        burst_dur=burst_dur,
        burst_pre_io=burst_pre_io,
        endpoint_post_io=endpoint_post_io,
        fp_db_pre=fp_db[0],
        fp_db_dur=fp_db[1],
        fp_db_post=fp_db[2],
        fp_cache_slot=fp_cache_slot,
        fp_cache_miss_prob=fp_cache_miss_prob,
        fp_cache_extra=fp_cache_extra,
        sample_period=sample_period,
        n_samples=max(0, math.ceil(round(horizon / sample_period, 9)) - 1),
        max_requests=max_requests,
        fastpath_ok=fast.ok,
        fastpath_reason=fast.reason,
        server_topo_order=fast.topo,
        ram_slots=fast.ram_slots,
        lc_ring=fast.lc_ring,
        relax_rho=fast.relax_rho,
        fault_srv_times=faults.srv_times,
        fault_srv_down=faults.srv_down,
        fault_edge_times=faults.edge_times,
        fault_edge_lat=faults.edge_lat,
        fault_edge_drop=faults.edge_drop,
        retry_timeout=retry.timeout,
        retry_max_attempts=retry.max_attempts,
        retry_backoff_base=retry.backoff_base,
        retry_backoff_mult=retry.backoff_mult,
        retry_backoff_cap=retry.backoff_cap,
        retry_jitter=retry.jitter,
        retry_budget_tokens=retry.budget_tokens,
        retry_budget_refill=retry.budget_refill,
        server_ids=[server.id for server in servers],
        edge_ids=[edge.id for edge in edges],
        **(
            {
                "hz_mtbf_dist": hazards.mtbf_dist,
                "hz_mtbf_mean": hazards.mtbf_mean,
                "hz_mtbf_var": hazards.mtbf_var,
                "hz_mttr_dist": hazards.mttr_dist,
                "hz_mttr_mean": hazards.mttr_mean,
                "hz_mttr_var": hazards.mttr_var,
                "hz_lat_factor": hazards.lat_factor,
                "hz_drop_boost": hazards.drop_boost,
                "hz_srv_targets": hazards.srv_targets,
                "hz_edge_targets": hazards.edge_targets,
                "hz_max_faults": hazards.max_faults,
            }
            if hazards is not None
            else {}
        ),
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
        elif spec.type == "list[int]":
            kw[name] = [int(x) for x in value]
        elif spec.type == "list[str]":
            kw[name] = [str(x) for x in value]
        elif spec.type == "str":
            kw[name] = str(value)
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
