"""Plain PyTorch twin of the DES kernel (``csrc/des_kernel.cu``).

A batched transcription of the reference's Pallas kernel
(``asyncflow_tpu/engines/jaxsim/pallas_engine.py``, ``PallasEngine._kernel``
and its helpers) into torch tensor operations on ``(S, P)`` tiles, with
every feature of that kernel: one generator or several superposed
streams; CPU, IO, RAM and END segments, cache hit/miss mixtures, LLM calls
with Poisson output tokens and their cost, and io_db segments holding one
of a server's FIFO DB connections; weighted endpoint pick; round-robin and
least-connection LB; all five edge distributions with dropout and network
spikes; the outage timeline (LB slots leave and re-enter the rotation);
the per-slot LB circuit breaker; the overload controls (ready-queue shed,
connection cap, token-bucket rate limit, dequeue deadline with its abandon
event); RAM admission with the strict-FIFO grant cascade; FIFO core
handoff; pool overflow and truncation at ``max_iterations``.  Each
optional feature costs nothing when the plan does not model it: its
tables are None and its state and branches are never built.

Precedence inside an iteration is the reference's: a timeline entry, then
the pool, then an arrival, at equal times.  A timeline pop is an iteration
of its own, so it advances the row's event counter like any other event.

Every scenario row advances by one event per loop iteration, so the shared
iteration counter ``it`` is also each row's own event counter: the CUDA
kernel, which runs one thread per scenario, reproduces it per thread and
draws the same threefry counters.  Randomness is threefry2x32 addressed by
``(it, site | seq << 10)``; the draw sites are the reference's (200 + g
for generator g's arrivals, 64 + 4j on a single generator's entry chain
and 600 + 4 g L + 4j on generator g's with several (L the longest chain),
32 on the LB edge, 48 on the exit edge, 4 for the endpoint pick, 24 for a
cache segment, 25 at seq 0, 1, ... for an LLM segment's tokens, +1 for
Box-Muller, +2 for the Poisson loop).  Float arithmetic is float32, one
operation at a time, so on the card the twin and the kernel (built with
``--fmad=false``) round alike.

It runs on either device.  The CPU tests use it; on the card it is the
yardstick the kernel is held to, and never the main path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from asyncflow_tpu_torch.compiler.plan import (
    SEG_CACHE,
    SEG_CPU,
    SEG_DB,
    SEG_END,
    SEG_IO,
    SEG_LLM,
    TARGET_CLIENT,
    TARGET_LB,
    TARGET_SERVER,
    StaticPlan,
)
from asyncflow_tpu_torch.engines.torchsim.keys import (
    MASK32,
    threefry2x32,
    uniform_from_bits,
)
from asyncflow_tpu_torch.engines.torchsim.params import (
    EV_ABANDON,
    EV_ARRIVE_LB,
    EV_ARRIVE_SRV,
    EV_IDLE,
    EV_RESUME,
    EV_SEG_END,
    EV_WAIT_CPU,
    EV_WAIT_DB,
    EV_WAIT_RAM,
    INF,
    NO_TICKET,
)
from asyncflow_tpu_torch.engines.torchsim.sampling import (
    D_EXPONENTIAL,
    D_LOGNORMAL,
    D_NORMAL,
    D_POISSON,
    D_UNIFORM,
    N_HIST_BINS,
    TINY,
    f32,
    hist_constants,
    latency_bin,
)

_TINY = f32(TINY)
_TWO_PI = f32(2.0 * np.pi)
_INF = f32(INF)


@dataclass
class DesTables:
    """Static inputs of the DES kernel for one plan: the plan tables as
    int32 / float32 tensors on the device, plus the scalar geometry."""

    seg_kind: torch.Tensor  # (NS*NEP*NSEGP,) i32
    seg_dur: torch.Tensor  # (NS*NEP*NSEGP,) f32
    ep_ram: torch.Tensor  # (NS*NEP,) f32
    ep_cum: torch.Tensor  # (NS*NEP,) f32
    edge_dist: torch.Tensor  # (NE,) i32
    exit_edge: torch.Tensor  # (NS,) i32
    exit_kind: torch.Tensor  # (NS,) i32
    exit_target: torch.Tensor  # (NS,) i32
    n_endpoints: torch.Tensor  # (NS,) i32
    server_cores: torch.Tensor  # (NS,) i32
    server_ram: torch.Tensor  # (NS,) f32
    lb_edge_index: torch.Tensor  # (max(EL,1),) i32
    lb_target: torch.Tensor  # (max(EL,1),) i32
    entry_edges: torch.Tensor  # (K,) i32
    # optional tables: None when the plan does not model the feature
    spike_times: torch.Tensor | None  # (NB,) f32
    spike_vals: torch.Tensor | None  # (NB*NE,) f32
    tl_times: torch.Tensor | None  # (NTL,) f32
    tl_down: torch.Tensor | None  # (NTL,) i32
    tl_slot: torch.Tensor | None  # (NTL,) i32
    queue_cap: torch.Tensor | None  # (NS,) i32
    conn_cap: torch.Tensor | None  # (NS,) i32
    rate_limit: torch.Tensor | None  # (NS,) f32
    rate_burst: torch.Tensor | None  # (NS,) f32
    queue_timeout: torch.Tensor | None  # (NS,) f32
    seg_hit_prob: torch.Tensor | None  # (NS*NEP*NSEGP,) f32, cache
    seg_miss_dur: torch.Tensor | None  # (NS*NEP*NSEGP,) f32, cache
    seg_llm_tokens: torch.Tensor | None  # (NS*NEP*NSEGP,) f32, LLM
    seg_llm_tpt: torch.Tensor | None  # (NS*NEP*NSEGP,) f32, LLM
    seg_llm_cost: torch.Tensor | None  # (NS*NEP*NSEGP,) f32, LLM
    db_pool: torch.Tensor | None  # (NS,) i32 connections (2**30 = unlimited)
    # several generators (None with one): per stream, its entry chain
    # (-1-padded to the longest, L), entry event and target, sampling
    # window and block of the arrival-rate table
    gen_entry_edges: torch.Tensor | None  # (G*L,) i32
    gen_entry_len: torch.Tensor | None  # (G,) i32
    gen_entry_ev: torch.Tensor | None  # (G,) i32
    gen_entry_target: torch.Tensor | None  # (G,) i32
    gen_window: torch.Tensor | None  # (G,) f32
    gen_lam_off: torch.Tensor | None  # (G,) i32
    gen_nw: torch.Tensor | None  # (G,) i32
    pool: int
    n_servers: int
    n_edges: int
    n_ep: int  # NEP: endpoint stride
    n_segp: int  # NSEG+1: segment stride
    n_lb: int  # EL (0 without a load balancer)
    n_windows: int
    n_hist_bins: int
    n_thr: int
    max_iterations: int
    entry_ev: int  # EV_ARRIVE_LB or EV_ARRIVE_SRV
    entry_target: int
    lb_algo: int
    has_ram: int
    horizon: float  # float32 values, as Python floats
    window: float
    hist_lo: float
    hist_scale: float
    dists: tuple[int, ...]  # distribution ids present on the plan's edges
    breaker_threshold: int  # 0 = no breaker
    breaker_cooldown: float  # float32 value
    breaker_probes: int
    n_gen: int  # generators (G)

    @property
    def max_chain(self) -> int:
        """The longest entry chain (L) of a plan with several generators."""
        if self.gen_entry_edges is None:
            return 0
        return int(self.gen_entry_edges.numel()) // self.n_gen

    @property
    def n_spikes(self) -> int:
        """Spike breakpoints (0 without spikes)."""
        return 0 if self.spike_times is None else int(self.spike_times.numel())

    @property
    def n_timeline(self) -> int:
        """Timeline entries (0 without a timeline)."""
        return 0 if self.tl_times is None else int(self.tl_times.numel())

    def tensors(self) -> list[torch.Tensor]:
        """The table tensors (what the kernel reads besides its inputs)."""
        return [v for v in vars(self).values() if isinstance(v, torch.Tensor)]


def make_des_tables(plan: StaticPlan, *, device: torch.device | str) -> DesTables:
    """The kernel's plan tables (``pallas_engine.py:382-447``, the slice's
    rows); a feature's tables are built only when the plan models it."""

    def i32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32).reshape(-1), device=device)

    def fl32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32).reshape(-1), device=device)

    def opt(flag: bool, make, a):
        return make(a) if flag else None

    el = plan.n_lb_edges
    lo, scale = hist_constants()
    spikes, tl = plan.has_spikes, plan.has_timeline
    cache, llm, db = plan.has_cache, plan.has_llm, plan.has_db_pool
    multi = plan.n_generators > 1
    entry_ev = [
        EV_ARRIVE_LB if kind == TARGET_LB else EV_ARRIVE_SRV
        for kind in np.asarray(plan.gen_entry_target_kind).tolist()
    ]
    lam_off = np.cumsum([0, *plan.gen_windows[:-1]])
    return DesTables(
        seg_kind=i32(plan.seg_kind),
        seg_dur=fl32(plan.seg_dur),
        ep_ram=fl32(plan.endpoint_ram),
        ep_cum=fl32(plan.endpoint_cum),
        edge_dist=i32(plan.edge_dist),
        exit_edge=i32(plan.exit_edge),
        exit_kind=i32(plan.exit_kind),
        exit_target=i32(plan.exit_target),
        n_endpoints=i32(plan.n_endpoints),
        server_cores=i32(plan.server_cores),
        server_ram=fl32(plan.server_ram),
        lb_edge_index=i32(plan.lb_edge_index if el else [0]),
        lb_target=i32(plan.lb_target if el else [0]),
        entry_edges=i32(plan.entry_edges),
        spike_times=opt(spikes, fl32, plan.spike_times),
        spike_vals=opt(spikes, fl32, plan.spike_values),
        tl_times=opt(tl, fl32, plan.timeline_times),
        tl_down=opt(tl, i32, plan.timeline_down),
        tl_slot=opt(tl, i32, plan.timeline_slot),
        queue_cap=opt(plan.has_queue_cap, i32, plan.server_queue_cap),
        conn_cap=opt(plan.has_conn_cap, i32, plan.server_conn_cap),
        rate_limit=opt(plan.has_rate_limit, fl32, plan.server_rate_limit),
        rate_burst=opt(plan.has_rate_limit, fl32, plan.server_rate_burst),
        queue_timeout=opt(plan.has_queue_timeout, fl32, plan.server_queue_timeout),
        seg_hit_prob=opt(cache, fl32, plan.seg_hit_prob),
        seg_miss_dur=opt(cache, fl32, plan.seg_miss_dur),
        seg_llm_tokens=opt(llm, fl32, plan.seg_llm_tokens),
        seg_llm_tpt=opt(llm, fl32, plan.seg_llm_tpt),
        seg_llm_cost=opt(llm, fl32, plan.seg_llm_cost),
        # -1 (unlimited) becomes a pool so large that acquire never blocks
        db_pool=opt(
            db, i32, np.where(plan.server_db_pool >= 0, plan.server_db_pool, 2**30),
        ),
        gen_entry_edges=opt(multi, i32, plan.gen_entry_edges),
        gen_entry_len=opt(multi, i32, plan.gen_entry_len),
        gen_entry_ev=opt(multi, i32, entry_ev),
        gen_entry_target=opt(multi, i32, np.maximum(plan.gen_entry_target, 0)),
        gen_window=opt(multi, fl32, plan.gen_window),
        gen_lam_off=opt(multi, i32, lam_off),
        gen_nw=opt(multi, i32, plan.gen_windows),
        pool=int(plan.pool_size),
        n_servers=plan.n_servers,
        n_edges=plan.n_edges,
        n_ep=max(plan.max_endpoints, 1),
        n_segp=int(plan.seg_kind.shape[2]),
        n_lb=el,
        n_windows=plan.n_windows,
        n_hist_bins=N_HIST_BINS,
        n_thr=int(np.ceil(plan.horizon)) or 1,
        max_iterations=int(plan.max_iterations),
        entry_ev=EV_ARRIVE_LB if plan.entry_target_kind == TARGET_LB else EV_ARRIVE_SRV,
        entry_target=max(int(plan.entry_target), 0),
        lb_algo=int(plan.lb_algo),
        has_ram=int(plan.has_ram),
        horizon=f32(plan.horizon),
        window=f32(plan.user_window),
        hist_lo=lo,
        hist_scale=scale,
        dists=tuple(sorted(set(np.asarray(plan.edge_dist).tolist()))),
        breaker_threshold=int(plan.breaker_threshold),
        breaker_cooldown=f32(plan.breaker_cooldown),
        breaker_probes=int(plan.breaker_probes),
        n_gen=plan.n_generators,
    )


#: columns of the kernel's ``work`` output: the work of the optional
#: features each scenario did, counted where the kernel does it (the bound
#: in ``chip_smoke.py`` prices them; the slice-1 work it counts from the
#: other outputs): timeline pops, token-bucket refills, breaker reports and
#: abandons; then threefry draws of LLM token loops, cache draws, requests
#: that waited for a DB connection and connections handed to a waiter
WORK_KINDS = (
    "timeline_pops", "token_refills", "breaker_reports", "abandons",
    "llm_token_draws", "cache_draws", "db_waits", "db_grants",
)
(
    W_TIMELINE, W_REFILL, W_BREAKER, W_ABANDON, W_LLM_DRAWS, W_CACHE, W_DB_WAIT, W_DB_GRANT,
) = range(len(WORK_KINDS))
#: seq values of an LLM token loop drawn in one batched threefry pass
LLM_DRAW_BLOCK = 64


class DesOutputs(NamedTuple):
    """The kernel's outputs, one row per scenario."""

    hist: torch.Tensor  # (S, B) i32 latency histogram
    thr: torch.Tensor  # (S, TH) i32 completions per second
    momf: torch.Tensor  # (S, 6) f32 lat sum, sumsq, min, max, LLM cost sum, sumsq
    momi: torch.Tensor  # (S, 5) i32 completed, generated, dropped, overflow, rejected
    trunc: torch.Tensor  # (S,) i32 iteration cap fired with work pending
    n_events: torch.Tensor  # (S,) i32 events simulated
    work: torch.Tensor  # (S, len(WORK_KINDS)) i32 work done, by kind


def _first_min(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (argmin, min), ties to the lowest index."""
    vmin = values.min(dim=1, keepdim=True).values
    lane = torch.arange(values.shape[1], device=values.device)
    idx = torch.where(values == vmin, lane, values.shape[1]).min(dim=1).values
    return idx, vmin[:, 0]


def _col(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[r, idx[r]]`` per row; ``idx`` is int64 and inside the row."""
    return arr.gather(1, idx[:, None])[:, 0]


def _put(arr: torch.Tensor, idx: torch.Tensor, val, pred: torch.Tensor) -> None:
    """``arr[r, idx[r]] = val[r]`` where ``pred[r]`` (in place)."""
    ix = idx[:, None]
    if isinstance(val, torch.Tensor):
        val = val.to(arr.dtype)[:, None]
    arr.scatter_(1, ix, torch.where(pred[:, None], val, arr.gather(1, ix)))


def _add(arr: torch.Tensor, idx: torch.Tensor, val, pred: torch.Tensor) -> None:
    """``arr[r, idx[r]] += val[r]`` where ``pred[r]`` (in place)."""
    ix = idx[:, None]
    old = arr.gather(1, ix)
    if isinstance(val, torch.Tensor):
        val = val[:, None]
    arr.scatter_(1, ix, torch.where(pred[:, None], old + val, old))


def _gather_by_order(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[r, pos] = values[r, order[r, pos]]`` (0 where the order entry
    is outside the row), over the tiny LB slot axis."""
    out = torch.zeros_like(order, dtype=values.dtype)
    for j in range(values.shape[1]):
        out = torch.where(order == j, values[:, j : j + 1], out)
    return out


def _rot_remove(order, length, slot, pred):
    """Remove ``slot`` from the length-prefix of the rotation: the lanes at
    and past it shift left (those past ``length`` too; the last lane keeps
    its value), and the length drops by one (``_rot_remove``)."""
    el = order.shape[1]
    lane = torch.arange(el, device=order.device)[None, :]
    hit = torch.where((order == slot[:, None]) & (lane < length[:, None]), lane, el)
    at = hit.min(dim=1).values
    act = pred & (at < el)
    shifted = torch.roll(order, -1, dims=1)
    moved = act[:, None] & (lane >= at[:, None]) & (lane < el - 1)
    return torch.where(moved, shifted, order), torch.where(act, length - 1, length)


def _rot_insert(order, length, slot, pred):
    """Append ``slot`` at the tail of the length-prefix unless it is there
    already (``_rot_insert``)."""
    el = order.shape[1]
    lane = torch.arange(el, device=order.device)[None, :]
    present = ((order == slot[:, None]) & (lane < length[:, None])).any(dim=1)
    act = pred & ~present
    idx = length.clamp(0, el - 1)
    order = torch.where(act[:, None] & (lane == idx[:, None]), slot[:, None], order)
    return order, torch.where(act, torch.clamp_max(length + 1, el), length)


class _Twin:
    """One batched run; attributes are the kernel's per-scenario state.

    Index-valued state (server, endpoint, segment, LB slot) is held as
    int64 so it can index directly; every index a row uses is inside its
    table, and where a masked-out row carries -1 the index is clamped and
    the row's result is discarded, as the one-hot reads of the reference
    discard it.
    """

    def __init__(self, t: DesTables, k0, k1, lam, em, ev, ed) -> None:
        dev = k0.device
        s, p = k0.shape[0], t.pool
        self.t = t
        self.k0 = k0.to(torch.int64) & MASK32
        self.k1 = k1.to(torch.int64) & MASK32
        self.lam, self.em, self.ev, self.ed = lam, em, ev, ed
        # per generator: entry chain, its first draw site, entry event and
        # target, sampling window (f32), block of the arrival-rate table
        g_n = t.n_gen
        if g_n == 1:
            self.chains = [t.entry_edges.tolist()]
            self.chain_site = [64]
            self.gen_ev, self.gen_target = [t.entry_ev], [t.entry_target]
            self.gen_window, self.gen_off, self.gen_nw = [t.window], [0], [t.n_windows]
        else:
            width = t.max_chain
            edges = t.gen_entry_edges.tolist()
            self.chains = [
                edges[g * width : g * width + n]
                for g, n in enumerate(t.gen_entry_len.tolist())
            ]
            # a stride of 4 per edge (an edge draw uses sites +0..+2) and a
            # block of the longest chain per stream
            self.chain_site = [600 + 4 * width * g for g in range(g_n)]
            self.gen_ev = t.gen_entry_ev.tolist()
            self.gen_target = t.gen_entry_target.tolist()
            self.gen_window = t.gen_window.tolist()
            self.gen_off, self.gen_nw = t.gen_lam_off.tolist(), t.gen_nw.tolist()
        # draw sites read at seq 0, drawn together once per iteration
        sites = [4, 32, 33, 34, 48, 49, 50] + [200 + g for g in range(g_n)]
        if t.seg_hit_prob is not None:
            sites.append(24)
        for base, chain in zip(self.chain_site, self.chains):
            for j in range(len(chain)):
                sites += [base + 4 * j, base + 1 + 4 * j, base + 2 + 4 * j]
        self.site_col = {site: c for c, site in enumerate(sites)}
        self.site_x1 = torch.tensor(sites, dtype=torch.int64, device=dev)[None, :]
        self.cache_it = -1
        self.cache = (torch.empty(0), torch.empty(0))
        i32, i64, f = torch.int32, torch.int64, torch.float32

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        self.req_t = full((s, p), _INF, f)
        self.req_ev = full((s, p), EV_IDLE, i32)
        self.req_srv = full((s, p), 0, i64)
        self.req_ep = full((s, p), 0, i64)
        self.req_seg = full((s, p), 0, i64)
        self.req_ram = full((s, p), 0.0, f)
        self.req_ticket = full((s, p), NO_TICKET, i32)
        self.req_start = full((s, p), 0.0, f)
        self.req_lbslot = full((s, p), -1, i64)
        ns, el = t.n_servers, max(t.n_lb, 1)
        self.cores_free = t.server_cores[None, :].expand(s, ns).clone()
        self.ram_free = t.server_ram[None, :].expand(s, ns).clone()
        self.cpu_ticket = full((s, ns), 0, i32)
        self.ram_ticket = full((s, ns), 0, i32)
        self.cpu_wait_n = full((s, ns), 0, i32)
        self.ram_wait_n = full((s, ns), 0, i32)
        self.lb_order = torch.arange(el, dtype=i64, device=dev).repeat(s, 1)
        self.lb_len = full((s,), t.n_lb, i64)
        self.lb_conn = full((s, el), 0, i32)
        # arrival sampler state, one column per generator
        self.smp_now = full((s, g_n), 0.0, f)
        self.smp_window_end = full((s, g_n), 0.0, f)
        self.widx = full((s, g_n), -1, i64)
        self.next_arrival = full((s, g_n), 0.0, f)
        self.hist = full((s, t.n_hist_bins), 0, i32)
        self.thr = full((s, t.n_thr), 0, i32)
        self.lat_count = full((s,), 0, i32)
        self.lat_sum = full((s,), 0.0, f)
        self.lat_sumsq = full((s,), 0.0, f)
        self.lat_min = full((s,), _INF, f)
        self.lat_max = full((s,), 0.0, f)
        self.n_generated = full((s,), 0, i32)
        self.n_dropped = full((s,), 0, i32)
        self.n_overflow = full((s,), 0, i32)
        self.n_rejected = full((s,), 0, i32)
        self.llm_sum = full((s,), 0.0, f)
        self.llm_sumsq = full((s,), 0.0, f)
        self.n_events = full((s,), 0, i32)
        self.work = full((s, len(WORK_KINDS)), 0, i32)
        # state of the optional features, built only when the plan has them
        self.has_shed = t.queue_cap is not None
        self.has_conn = t.conn_cap is not None
        self.has_rl = t.rate_limit is not None
        self.has_timeout = t.queue_timeout is not None
        self.has_breaker = t.breaker_threshold > 0
        self.has_cache = t.seg_hit_prob is not None
        self.has_llm = t.seg_llm_tokens is not None
        self.has_db = t.db_pool is not None
        if t.n_timeline:
            self.tl_ptr = full((s,), 0, i64)
            self.tl_slot = t.tl_slot.long()
        if self.has_conn:
            self.srv_conn = full((s, ns), 0, i32)
        if self.has_rl:
            self.rl_tokens = t.rate_burst[None, :].expand(s, ns).clone()
            self.rl_last = full((s, ns), 0.0, f)
        if self.has_timeout:
            self.req_wait_t = full((s, p), 0.0, f)
        if self.has_breaker:
            self.cb_state = full((s, el), 0, i32)
            self.cb_open_until = full((s, el), 0.0, f)
            self.cb_consec = full((s, el), 0, i32)
            self.cb_probes_out = full((s, el), 0, i32)
            self.cb_probe_ok = full((s, el), 0, i32)
            self.req_cbslot = full((s, p), -1, i64)
            self.req_probe = full((s, p), 0, i32)
        if self.has_llm:
            self.req_llm = full((s, p), 0.0, f)
        if self.has_db:
            self.db_free = t.db_pool[None, :].expand(s, ns).clone()
            self.db_ticket = full((s, ns), 0, i32)
            self.db_wait_n = full((s, ns), 0, i32)
        # long copies of the index tables
        self.seg_kind = t.seg_kind.long()
        self.exit_edge = t.exit_edge.long()
        self.exit_kind = t.exit_kind.long()
        self.exit_target = t.exit_target.long()
        self.n_endpoints = t.n_endpoints.long()
        self.edge_dist = t.edge_dist.long()
        self.lb_edge_index = t.lb_edge_index.long()
        self.lb_target = t.lb_target.long()

    def seg_idx(self, s, ep, seg):
        return (s * self.t.n_ep + ep) * self.t.n_segp + seg

    def count(self, kind: int, pred: torch.Tensor, n: torch.Tensor | int = 1) -> None:
        """Add ``n`` to work column ``kind`` of the rows in ``pred``."""
        self.work[:, kind] += torch.where(pred, n, 0).to(torch.int32)

    # ---- randomness ----

    def pair(self, it: int, site: int, seq: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """Two uniforms of the draw at counter ``(it, site | seq << 10)``."""
        col = self.site_col.get(site) if seq == 0 else None
        if col is not None:
            if self.cache_it != it:
                x0 = torch.full_like(self.site_x1, it & MASK32)
                b0, b1 = threefry2x32(self.k0[:, None], self.k1[:, None], x0, self.site_x1)
                self.cache = (uniform_from_bits(b0), uniform_from_bits(b1))
                self.cache_it = it
            return self.cache[0][:, col], self.cache[1][:, col]
        x0 = torch.full_like(self.k0, it & MASK32)
        x1 = torch.full_like(self.k0, (site + (seq << 10)) & MASK32)
        b0, b1 = threefry2x32(self.k0, self.k1, x0, x1)
        return uniform_from_bits(b0), uniform_from_bits(b1)

    def edge_draw(self, it: int, site: int, e: torch.Tensor, pred: torch.Tensor, t_send):
        """(dropped, delay) on per-row edge ``e``, the delay including the
        spike in force at ``t_send`` (``_edge_draw``)."""
        t = self.t
        mean = _col(self.em, e)
        var = _col(self.ev, e)
        drop_p = _col(self.ed, e)
        dist = self.edge_dist[e]
        u_drop, u = self.pair(it, site)
        delay = torch.zeros_like(mean)
        if D_UNIFORM in t.dists:
            delay = torch.where(dist == D_UNIFORM, u, delay)
        if D_EXPONENTIAL in t.dists:
            g = (-mean) * torch.log(torch.clamp_min(1.0 - u, _TINY))
            delay = torch.where(dist == D_EXPONENTIAL, g, delay)
        if D_NORMAL in t.dists or D_LOGNORMAL in t.dists:
            u1, u2 = self.pair(it, site + 1)
            z = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, _TINY))) * torch.cos(
                _TWO_PI * u2,
            )
            x = mean + var * z
            delay = torch.where(dist == D_NORMAL, torch.clamp_min(x, 0.0), delay)
            delay = torch.where(dist == D_LOGNORMAL, torch.exp(x), delay)
        if D_POISSON in t.dists:
            # exp-sum counting process: K ~ Poisson(mean) exactly
            live = pred & (dist == D_POISSON)
            limit = torch.clamp_min(mean, _TINY)
            acc = torch.zeros_like(mean)
            k = torch.zeros_like(dist)
            seq = 0
            while bool(live.any()):
                u_p = self.pair(it, site + 2, seq)[0]
                acc = acc + (-torch.log(torch.clamp_min(1.0 - u_p, _TINY)))
                live = live & ~(acc > limit)
                k = k + live.to(k.dtype)
                seq += 1
            delay = torch.where(dist == D_POISSON, k.to(delay.dtype), delay)
        if t.n_spikes:
            # breakpoint in force at t_send; spike_times[0] == 0
            bp = (t.spike_times[None, :] <= t_send[:, None]).sum(dim=1) - 1
            delay = delay + t.spike_vals[bp * t.n_edges + e]
        return u_drop < drop_p, delay

    # ---- kernel pieces ----

    def advance_arrival(self, it: int, pred: torch.Tensor, gen: int = 0) -> None:
        """Window-jump exponential-gap sampler of generator ``gen``
        (``_advance_arrival``): its own block of the arrival-rate table,
        sampling window and draw site."""
        t = self.t
        horizon, window = t.horizon, self.gen_window[gen]
        off, nw = self.gen_off[gen], self.gen_nw[gen]
        smp_now = self.smp_now[:, gen]
        window_end = self.smp_window_end[:, gen]
        widx = self.widx[:, gen]
        status = torch.where(pred, 0, 1)
        gap = torch.zeros_like(smp_now)
        dctr = 0
        while bool((status == 0).any()):
            active = status == 0
            done_h = active & (smp_now >= horizon)
            status = torch.where(done_h, 2, status)
            active = active & ~done_h
            need = active & (smp_now >= window_end)
            widx = torch.where(need, widx + 1, widx)
            # rows with widx -1 are inactive: their clamped read is discarded
            lam = _col(self.lam, off + widx.clamp(0, nw - 1))
            window_end = torch.where(need, smp_now + window, window_end)
            no_users = lam <= 0.0
            u = torch.clamp_min(self.pair(it, 200 + gen, dctr)[0], _TINY)
            g = (-torch.log(torch.clamp_min(1.0 - u, _TINY))) / torch.clamp_min(lam, _TINY)
            ahead = smp_now + g
            beyond = ahead > horizon
            crosses = ahead >= window_end
            smp_next = torch.where(
                no_users,
                window_end,
                torch.where(beyond, smp_now, torch.where(crosses, window_end, ahead)),
            )
            new_status = torch.where(
                no_users, 0, torch.where(beyond, 2, torch.where(crosses, 0, 1)),
            )
            smp_now = torch.where(active, smp_next, smp_now)
            gap = torch.where(active & (new_status == 1), g, gap)
            status = torch.where(active, new_status, status)
            dctr += 1
        nxt = torch.where(status == 2, _INF, self.next_arrival[:, gen] + gap)
        for name, new in (("smp_now", smp_now), ("smp_window_end", window_end),
                          ("widx", widx), ("next_arrival", nxt)):
            col = getattr(self, name)[:, gen]
            col.copy_(torch.where(pred, new, col))

    def complete(self, i, start, finish, pred) -> None:
        """Histogram bin, throughput bin, latency moments and the LLM cost
        moments of slot ``i``'s request (``_complete``)."""
        t = self.t
        if self.has_llm:
            cost = _col(self.req_llm, i)
            self.llm_sum = torch.where(pred, self.llm_sum + cost, self.llm_sum)
            self.llm_sumsq = torch.where(pred, self.llm_sumsq + cost * cost, self.llm_sumsq)
        latency = finish - start
        lbin = latency_bin(latency, t.hist_lo, t.hist_scale, t.n_hist_bins)
        _add(self.hist, lbin.long(), 1, pred)
        tbin = torch.clamp(torch.ceil(finish).to(torch.int32) - 1, 0, t.n_thr - 1)
        _add(self.thr, tbin.long(), 1, pred)
        self.lat_count = self.lat_count + pred.to(torch.int32)
        self.lat_sum = torch.where(pred, self.lat_sum + latency, self.lat_sum)
        sumsq = self.lat_sumsq + latency * latency
        self.lat_sumsq = torch.where(pred, sumsq, self.lat_sumsq)
        self.lat_min = torch.where(pred, torch.minimum(self.lat_min, latency), self.lat_min)
        self.lat_max = torch.where(pred, torch.maximum(self.lat_max, latency), self.lat_max)

    def release_ram(self, i, s, now, pred) -> None:
        """RAM release plus the strict-FIFO grant cascade (``_release_ram``)."""
        if not self.t.has_ram:
            return
        _add(self.ram_free, s, _col(self.req_ram, i), pred)
        _put(self.req_ram, i, 0.0, pred)
        # masked-out rows match no waiter (server -1) and write nothing
        srv_col = torch.where(pred, s, -1)
        srv = s
        while True:
            waiting = (self.req_ev == EV_WAIT_RAM) & (self.req_srv == srv_col[:, None])
            tick = torch.where(waiting, self.req_ticket, NO_TICKET)
            head, tmin = _first_min(tick)
            fits = pred & (tmin < NO_TICKET) & (
                _col(self.req_ram, head) <= _col(self.ram_free, srv)
            )
            if not bool(fits.any()):
                return
            _put(self.req_ev, head, EV_RESUME, fits)
            _put(self.req_t, head, now, fits)
            _put(self.req_ticket, head, NO_TICKET, fits)
            _add(self.ram_free, srv, -_col(self.req_ram, head), fits)
            _add(self.ram_wait_n, srv, -1, fits)

    def leave(self, i, pred) -> None:
        """Free slot ``i``: the request leaves the system."""
        _put(self.req_ev, i, EV_IDLE, pred)
        _put(self.req_t, i, _INF, pred)

    def reject(self, i, s, now, pred, *, release: bool) -> None:
        """A refusal, shed or abandon: free the slot, count it rejected and
        report a failure to the request's breaker slot; ``release`` also
        gives back its RAM and its connection."""
        if release:
            self.release_ram(i, s, now, pred)
            if self.has_conn:
                _add(self.srv_conn, s, -1, pred)
        self.leave(i, pred)
        self.n_rejected = self.n_rejected + pred.to(torch.int32)
        self.breaker_server_report(i, now, True, pred)

    def breaker_report(self, slot, is_probe, failed: bool, now, pred) -> None:
        """One success or failure report to breaker slot ``slot``: the
        consecutive-failure, cooldown and half-open state machine
        (``_breaker_report``)."""
        t = self.t
        self.count(W_BREAKER, pred)
        probe = pred & is_probe
        plain = pred & ~is_probe
        stt = _col(self.cb_state, slot)
        _add(self.cb_probes_out, slot, -1, probe)
        self.cb_probes_out.clamp_(min=0)
        if failed:
            c_fail = plain & (stt == 0)
            consec = _col(self.cb_consec, slot) + c_fail.to(torch.int32)
            trips = c_fail & (consec >= t.breaker_threshold)
            opens = probe | trips
            _put(self.cb_consec, slot, torch.where(trips, 0, consec), pred)
            _put(self.cb_state, slot, 1, opens)
            _put(self.cb_open_until, slot, now + t.breaker_cooldown, opens)
            return
        _put(self.cb_consec, slot, 0, plain & (stt == 0))
        probe_ok = _col(self.cb_probe_ok, slot) + probe.to(torch.int32)
        closes = probe & (stt == 2) & (probe_ok >= t.breaker_probes)
        _put(self.cb_probe_ok, slot, probe_ok, probe)
        _put(self.cb_state, slot, 0, closes)
        _put(self.cb_consec, slot, 0, closes)

    def breaker_server_report(self, i, now, failed: bool, pred) -> None:
        """Report slot ``i``'s routing outcome once; a no-op after the
        report cleared its breaker slot (``_breaker_server_report``)."""
        if not self.has_breaker:
            return
        slot = _col(self.req_cbslot, i)
        act = pred & (slot >= 0)
        if not bool(act.any()):
            return
        self.breaker_report(
            slot.clamp_min(0), _col(self.req_probe, i) > 0, failed, now, act,
        )
        _put(self.req_cbslot, i, -1, act)
        _put(self.req_probe, i, 0, act)

    def exit_flow(self, it, i, s, now, pred) -> None:
        """Release RAM and the connection, report success, route the exit
        edge, complete or drop (``_exit_flow``)."""
        if not bool(pred.any()):
            return
        t = self.t
        self.release_ram(i, s, now, pred)
        if self.has_conn:
            _add(self.srv_conn, s, -1, pred)
        self.breaker_server_report(i, now, False, pred)
        e = self.exit_edge[s]
        kind = self.exit_kind[s]
        target = self.exit_target[s]
        dropped, delay = self.edge_draw(it, 48, e, pred, now)
        arrive = now + delay
        to_server = pred & (kind == TARGET_SERVER) & ~dropped
        to_lb = pred & (kind == TARGET_LB) & ~dropped
        to_client = pred & (kind == TARGET_CLIENT) & ~dropped
        drop_here = pred & dropped
        self.complete(i, _col(self.req_start, i), arrive, to_client & (arrive < t.horizon))
        free = drop_here | to_client
        moved = free | to_server | to_lb
        _put(
            self.req_ev,
            i,
            torch.where(free, EV_IDLE, torch.where(to_server, EV_ARRIVE_SRV, EV_ARRIVE_LB)),
            moved,
        )
        _put(self.req_t, i, torch.where(free, _INF, arrive), moved)
        _put(self.req_srv, i, target, to_server)
        _put(self.req_lbslot, i, -1, pred)
        self.n_dropped = self.n_dropped + drop_here.to(torch.int32)

    def llm_tokens(self, it: int, limit: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """Output tokens of an LLM segment: the exp-sum counting process on
        site 25, seq 0, 1, ... (``_seg_start``): the number of partial sums
        of ``-log(max(1 - u, TINY))`` that stay at or below ``limit``.

        The uniforms are drawn LLM_DRAW_BLOCK seqs at a time in one batched
        threefry pass; the partial sums are then taken one column at a time,
        in the reference's order, so they round as its sequential loop does.
        The summands are never negative, so a row's partial sums only grow,
        and its count is the number of them at or below its limit.
        """
        dev = limit.device
        tokens = torch.zeros_like(limit, dtype=torch.int32)
        acc = torch.zeros_like(limit)
        seq0 = 0
        while bool(live.any()):
            seqs = torch.arange(seq0, seq0 + LLM_DRAW_BLOCK, dtype=torch.int64, device=dev)
            x1 = ((25 + (seqs << 10)) & MASK32)[None, :]
            x0 = torch.full_like(x1, it)
            b0, _ = threefry2x32(self.k0[:, None], self.k1[:, None], x0, x1)
            u = uniform_from_bits(b0)
            gaps = (-torch.log(torch.clamp_min(1.0 - u, _TINY))).T.contiguous()
            sums = torch.empty_like(gaps)
            torch.add(acc, gaps[0], out=sums[0])
            for c in range(1, LLM_DRAW_BLOCK):
                torch.add(sums[c - 1], gaps[c], out=sums[c])
            inside = (sums <= limit[None, :]) & live[None, :]
            tokens = tokens + inside.sum(dim=0, dtype=torch.int32)
            acc = sums[-1]
            live = live & ~(acc > limit)
            seq0 += LLM_DRAW_BLOCK
        return tokens

    def seg_start(self, it, i, s, ep, seg, now, pred) -> None:
        """Segment dispatch (``_seg_start``): CPU with the ready-queue shed,
        IO, a cache mixture or an LLM call (sleeps), a DB query (acquire a
        connection or wait FIFO for one), END."""
        if not bool(pred.any()):
            return
        t = self.t
        # masked-out rows may point one past their program: clamp, discard
        sidx = self.seg_idx(s, ep, seg).clamp(0, self.seg_kind.shape[0] - 1)
        kind = self.seg_kind[sidx]
        dur = t.seg_dur[sidx]
        is_cpu = pred & (kind == SEG_CPU)
        is_io = pred & (kind == SEG_IO)
        is_end = pred & (kind == SEG_END)
        if self.has_cache:
            # a miss sleeps the backing store's latency
            is_cache = pred & (kind == SEG_CACHE)
            self.count(W_CACHE, is_cache)
            u_cache = self.pair(it, 24)[0]
            miss = is_cache & (u_cache >= t.seg_hit_prob[sidx])
            dur = torch.where(miss, t.seg_miss_dur[sidx], dur)
            is_io = is_io | is_cache
        if self.has_llm:
            # the sleep stretches by tokens x seconds per token, and the
            # request accrues tokens x cost per token
            is_llm = pred & (kind == SEG_LLM)
            if bool(is_llm.any()):
                limit = torch.clamp_min(t.seg_llm_tokens[sidx], f32(1e-6))
                tokens = self.llm_tokens(it, limit, is_llm)
                # the loop's draws: one per token and the one past the limit
                self.count(W_LLM_DRAWS, is_llm, tokens + 1)
                tokens = tokens.to(torch.float32)
                dur = torch.where(is_llm, dur + tokens * t.seg_llm_tpt[sidx], dur)
                _add(self.req_llm, i, tokens * t.seg_llm_cost[sidx], is_llm)
            is_io = is_io | is_llm
        waiting_n = _col(self.cpu_wait_n, s)
        can_take = (_col(self.cores_free, s) > 0) & ~(waiting_n > 0)
        cpu_run = is_cpu & can_take
        cpu_wait = is_cpu & ~can_take
        if self.has_shed:
            # joining a full ready queue sheds the request
            cap = t.queue_cap[s]
            shed = cpu_wait & (cap >= 0) & (waiting_n >= cap)
            cpu_wait = cpu_wait & ~shed
        run_now = cpu_run | is_io
        db_wait = torch.zeros_like(pred)
        if self.has_db:
            # acquire a free connection unless others wait for one
            is_db = pred & (kind == SEG_DB)
            db_can = (_col(self.db_free, s) > 0) & ~(_col(self.db_wait_n, s) > 0)
            db_run = is_db & db_can
            db_wait = is_db & ~db_can
            run_now = run_now | db_run
            self.count(W_DB_WAIT, db_wait)
            _add(self.db_free, s, -1, db_run)
            _add(self.db_ticket, s, 1, db_wait)
            _add(self.db_wait_n, s, 1, db_wait)
        _add(self.cores_free, s, -1, cpu_run)
        _add(self.cpu_ticket, s, 1, cpu_wait)
        _add(self.cpu_wait_n, s, 1, cpu_wait)
        parked = run_now | cpu_wait | db_wait
        _put(
            self.req_ev, i,
            torch.where(
                run_now, EV_SEG_END, torch.where(cpu_wait, EV_WAIT_CPU, EV_WAIT_DB),
            ),
            parked,
        )
        _put(self.req_t, i, torch.where(run_now, now + dur, _INF), parked)
        _put(self.req_ticket, i, _col(self.cpu_ticket, s), cpu_wait)
        if self.has_db:
            _put(self.req_ticket, i, _col(self.db_ticket, s), db_wait)
        if self.has_timeout:
            _put(self.req_wait_t, i, now, cpu_wait)
        if self.has_shed and bool(shed.any()):
            self.reject(i, s, now, shed, release=True)
        _put(self.req_seg, i, seg, pred)
        self.exit_flow(it, i, s, now, is_end)

    def spawn(self, it, now, pred) -> None:
        """The spawning generator's entry chain, first free pool slot, its
        next arrival (``_spawn_branch``).  The spawning generator is the one
        with the earliest next arrival, the lowest index on ties."""
        t = self.t
        self.n_generated = self.n_generated + pred.to(torch.int32)
        g_idx, _ = _first_min(self.next_arrival)
        alive_all = torch.zeros_like(pred)
        t_all = now
        ev0 = torch.zeros_like(self.lb_len)
        target = torch.zeros_like(self.lb_len)
        for g, chain in enumerate(self.chains):
            mine = g_idx == g
            alive = pred & mine
            if not bool(alive.any()):
                continue
            t_cur = now
            for j, eidx in enumerate(chain):
                e = torch.full_like(self.lb_len, eidx)
                # a spike applies at the time the request reaches this edge
                site = self.chain_site[g] + 4 * j
                dropped, delay = self.edge_draw(it, site, e, alive, t_cur)
                self.n_dropped = self.n_dropped + (alive & dropped).to(torch.int32)
                survives = alive & ~dropped
                t_cur = torch.where(survives, t_cur + delay, t_cur)
                alive = survives
            alive_all = alive_all | alive
            t_all = torch.where(mine, t_cur, t_all)
            ev0 = torch.where(mine, self.gen_ev[g], ev0)
            target = torch.where(mine, self.gen_target[g], target)
        idle = self.req_ev == EV_IDLE
        has_free = idle.any(dim=1)
        lane = torch.arange(t.pool, device=idle.device)
        slot = torch.where(idle, lane, t.pool).min(dim=1).values.clamp_max(t.pool - 1)
        place = alive_all & has_free
        _put(self.req_ev, slot, ev0, place)
        _put(self.req_t, slot, t_all, place)
        _put(self.req_srv, slot, target, place)
        _put(self.req_start, slot, now, place)
        _put(self.req_lbslot, slot, -1, place)
        _put(self.req_ram, slot, 0.0, place)
        _put(self.req_ticket, slot, NO_TICKET, place)
        if self.has_llm:
            _put(self.req_llm, slot, 0.0, place)
        self.n_overflow = self.n_overflow + (alive_all & ~has_free).to(torch.int32)
        for g in range(t.n_gen):
            mine = pred & (g_idx == g)
            if bool(mine.any()):
                self.advance_arrival(it, mine, g)

    def timeline(self, pred) -> None:
        """Pop one timeline entry: the LB slot leaves the rotation (down) or
        re-enters it at the tail (up) (``_timeline_branch``)."""
        t = self.t
        self.count(W_TIMELINE, pred)
        ptr = self.tl_ptr.clamp(0, t.n_timeline - 1)
        slot = self.tl_slot[ptr]
        down = t.tl_down[ptr] == 1
        act = pred & (slot >= 0)
        order, length = _rot_remove(self.lb_order, self.lb_len, slot, act & down)
        self.lb_order, self.lb_len = _rot_insert(order, length, slot, act & ~down)
        self.tl_ptr = self.tl_ptr + pred.to(torch.int64)

    def lb_pick(self):
        """(slot, rotated order) without a breaker (``_lb_pick``)."""
        t = self.t
        el = t.n_lb
        lane = torch.arange(el, device=self.lb_order.device)[None, :]
        length = self.lb_len[:, None]
        if t.lb_algo == 0:
            shifted = torch.roll(self.lb_order, -1, dims=1)
            rotated = torch.where(
                lane < length - 1,
                shifted,
                torch.where(lane == length - 1, self.lb_order[:, :1], self.lb_order),
            )
            return self.lb_order[:, 0], rotated
        conn_rot = _gather_by_order(self.lb_order, self.lb_conn)
        key = torch.where(lane < length, conn_rot * el + lane, 2**30)
        best, _ = _first_min(key)
        return _col(self.lb_order, best), self.lb_order

    def lb_pick_breaker(self, admits):
        """(slot, rotated order, none admitting): RR takes the first
        admitting rotation member and moves only it to the tail; LC takes
        the first least-connection admitting member (``_lb_pick_breaker``)."""
        t = self.t
        el = t.n_lb
        lane = torch.arange(el, device=self.lb_order.device)[None, :]
        elig = (lane < self.lb_len[:, None]) & (
            _gather_by_order(self.lb_order, admits.to(torch.int32)) > 0
        )
        any_elig = elig.any(dim=1)
        if t.lb_algo == 0:
            pos = torch.where(elig, lane, el).min(dim=1).values.clamp_max(el - 1)
            slot = _col(self.lb_order, pos)
            order, length = _rot_remove(self.lb_order, self.lb_len, slot, any_elig)
            order, _ = _rot_insert(order, length, slot, any_elig)
            return slot, order, ~any_elig
        conn_rot = _gather_by_order(self.lb_order, self.lb_conn)
        key = torch.where(elig, conn_rot * el + lane, 2**30)
        best, _ = _first_min(key)
        return _col(self.lb_order, best), self.lb_order, ~any_elig

    def arrive_lb(self, it, i, now, pred) -> None:
        """LB routing, the breaker's admission, the LB edge
        (``_arrive_lb_branch``)."""
        t = self.t
        if t.n_lb == 0:
            return
        empty = self.lb_len <= 0
        drop_empty = pred & empty
        route = pred & ~empty
        if self.has_breaker:
            # lazy cooldown expiry over every slot of the row: open slots
            # whose cooldown elapsed turn half-open with fresh probe counts
            wake = route[:, None] & (self.cb_state == 1) & (now[:, None] >= self.cb_open_until)
            self.cb_state = torch.where(wake, 2, self.cb_state)
            self.cb_probes_out = torch.where(wake, 0, self.cb_probes_out)
            self.cb_probe_ok = torch.where(wake, 0, self.cb_probe_ok)
            admits = (self.cb_state == 0) | (
                (self.cb_state == 2) & (self.cb_probes_out < t.breaker_probes)
            )
            slot, rotated, none_open = self.lb_pick_breaker(admits)
            refused = route & none_open
            route = route & ~none_open
            self.n_rejected = self.n_rejected + refused.to(torch.int32)
            self.leave(i, refused)
            probe = route & (_col(self.cb_state, slot) == 2)
            _add(self.cb_probes_out, slot, 1, probe)
            _put(self.req_cbslot, i, slot, route)
            _put(self.req_probe, i, probe.to(torch.int32), route)
        else:
            slot, rotated = self.lb_pick()
        self.lb_order = torch.where(route[:, None], rotated, self.lb_order)
        e = self.lb_edge_index[slot]
        dropped, delay = self.edge_draw(it, 32, e, route, now)
        arrive = now + delay
        ok = route & ~dropped
        drop_edge = route & dropped
        free = drop_empty | drop_edge
        # a dropped send on the routing edge is a connection failure
        self.breaker_server_report(i, now, True, drop_edge)
        _add(self.lb_conn, slot, 1, ok)
        _put(self.req_ev, i, torch.where(free, EV_IDLE, EV_ARRIVE_SRV), free | ok)
        _put(self.req_t, i, torch.where(free, _INF, arrive), free | ok)
        _put(self.req_srv, i, self.lb_target[slot], ok)
        _put(self.req_lbslot, i, slot, ok)
        self.n_dropped = self.n_dropped + free.to(torch.int32)

    def arrive_srv(self, it, i, now, pred) -> None:
        """Rate limit, connection cap, endpoint pick and RAM-first admission
        (``_arrive_srv_branch``)."""
        t = self.t
        s = _col(self.req_srv, i)
        if t.n_lb > 0:
            lbslot = _col(self.req_lbslot, i)
            _add(self.lb_conn, torch.clamp_min(lbslot, 0), -1, pred & (lbslot >= 0))
            _put(self.req_lbslot, i, -1, pred)
        if self.has_rl:
            # token bucket: lazy refill at arrival, refuse without a whole token
            rps = t.rate_limit[s]
            limited_row = pred & (rps >= 0)
            self.count(W_REFILL, limited_row)
            refill = (now - _col(self.rl_last, s)) * torch.clamp_min(rps, 0.0)
            tokens = torch.minimum(t.rate_burst[s], _col(self.rl_tokens, s) + refill)
            limited = limited_row & (tokens < 1.0)
            _put(self.rl_tokens, s, tokens - torch.where(limited, 0.0, 1.0), limited_row)
            _put(self.rl_last, s, now, limited_row)
            self.reject(i, s, now, limited, release=False)
            pred = pred & ~limited
        if self.has_conn:
            # the server refuses an arrival when it holds its cap of residents
            cap = t.conn_cap[s]
            refuse = pred & (cap >= 0) & (_col(self.srv_conn, s) >= cap)
            self.reject(i, s, now, refuse, release=False)
            pred = pred & ~refuse
            _add(self.srv_conn, s, 1, pred)
        u = self.pair(it, 4)[0]
        nep = self.n_endpoints[s]
        ep = torch.zeros_like(s)
        for k in range(t.n_ep):
            ep = ep + (t.ep_cum[s * t.n_ep + k] <= u).to(ep.dtype)
        ep = torch.minimum(ep, nep - 1)
        _put(self.req_ep, i, ep, pred)
        zero = torch.zeros_like(ep)
        if not t.has_ram:
            self.seg_start(it, i, s, ep, zero, now, pred)
            return
        need = t.ep_ram[s * t.n_ep + ep]
        _put(self.req_ram, i, need, pred)
        waiters = _col(self.ram_wait_n, s) > 0
        granted = pred & ((need <= 0) | (~waiters & (_col(self.ram_free, s) >= need)))
        blocked = pred & ~granted
        _add(self.ram_free, s, -need, granted)
        _add(self.ram_ticket, s, 1, blocked)
        _add(self.ram_wait_n, s, 1, blocked)
        _put(self.req_ev, i, EV_WAIT_RAM, blocked)
        _put(self.req_t, i, _INF, blocked)
        _put(self.req_ticket, i, _col(self.ram_ticket, s), blocked)
        self.seg_start(it, i, s, ep, zero, now, granted)

    def resume(self, it, i, now, pred) -> None:
        """RAM-grant resume (``_resume_branch``)."""
        if not self.t.has_ram:
            return
        s = _col(self.req_srv, i)
        ep = _col(self.req_ep, i)
        self.seg_start(it, i, s, ep, torch.zeros_like(ep), now, pred)

    def cpu_handoff(self, s, now, was_cpu) -> None:
        """Release one core of ``s`` or grant it to the head FIFO waiter; a
        grantee past its dequeue deadline takes it for zero service as an
        abandon event at ``now`` (``_cpu_handoff``)."""
        srv_col = torch.where(was_cpu, s, -1)
        waiting = (self.req_ev == EV_WAIT_CPU) & (self.req_srv == srv_col[:, None])
        tick = torch.where(waiting, self.req_ticket, NO_TICKET)
        j, tmin = _first_min(tick)
        grant = was_cpu & (tmin < NO_TICKET)
        release = was_cpu & ~grant
        jdur = self.t.seg_dur[
            self.seg_idx(_col(self.req_srv, j), _col(self.req_ep, j), _col(self.req_seg, j))
        ]
        ev_next = torch.full_like(j, EV_SEG_END)
        t_next = now + jdur
        if self.has_timeout:
            deadline = self.t.queue_timeout[s]
            expired = grant & (deadline >= 0) & (now - _col(self.req_wait_t, j) > deadline)
            ev_next = torch.where(expired, EV_ABANDON, ev_next)
            t_next = torch.where(expired, now, t_next)
        _add(self.cores_free, s, 1, release)
        _add(self.cpu_wait_n, s, -1, grant)
        _put(self.req_ev, j, ev_next, grant)
        _put(self.req_t, j, t_next, grant)
        _put(self.req_ticket, j, NO_TICKET, grant)

    def abandon(self, it, i, now, pred) -> None:
        """Dequeue deadline exceeded: hand the core on, release RAM and the
        connection, count a rejection (``_abandon_branch``)."""
        self.count(W_ABANDON, pred)
        s = _col(self.req_srv, i)
        self.cpu_handoff(s, now, pred)
        self.reject(i, s, now, pred, release=True)

    def seg_end(self, it, i, now, pred) -> None:
        """Core handoff, then the next segment (``_seg_end_branch``)."""
        s = _col(self.req_srv, i)
        ep = _col(self.req_ep, i)
        seg = _col(self.req_seg, i)
        kind = self.seg_kind[self.seg_idx(s, ep, seg)]
        was_cpu = pred & (kind == SEG_CPU)
        if bool(was_cpu.any()):
            self.cpu_handoff(s, now, was_cpu)
        if self.has_db:
            was_db = pred & (kind == SEG_DB)
            if bool(was_db.any()):
                self.db_handoff(s, now, was_db)
        self.seg_start(it, i, s, ep, seg + 1, now, pred)

    def db_handoff(self, s, now, was_db) -> None:
        """Release a DB connection of ``s`` or hand it to the head FIFO
        waiter, whose query then runs for its own segment's duration
        (``_seg_end_branch``)."""
        srv_col = torch.where(was_db, s, -1)
        waiting = (self.req_ev == EV_WAIT_DB) & (self.req_srv == srv_col[:, None])
        tick = torch.where(waiting, self.req_ticket, NO_TICKET)
        j, tmin = _first_min(tick)
        grant = was_db & (tmin < NO_TICKET)
        release = was_db & ~grant
        self.count(W_DB_GRANT, grant)
        jdur = self.t.seg_dur[
            self.seg_idx(_col(self.req_srv, j), _col(self.req_ep, j), _col(self.req_seg, j))
        ]
        _add(self.db_free, s, 1, release)
        _add(self.db_wait_n, s, -1, grant)
        _put(self.req_ev, j, EV_SEG_END, grant)
        _put(self.req_t, j, now + jdur, grant)
        _put(self.req_ticket, j, NO_TICKET, grant)

    def timeline_time(self) -> torch.Tensor:
        """Time of each row's next timeline entry (INF past the last)."""
        t = self.t
        if not t.n_timeline:
            return torch.full_like(self.lat_sum, _INF)
        nxt = t.tl_times[self.tl_ptr.clamp(0, t.n_timeline - 1)]
        return torch.where(self.tl_ptr < t.n_timeline, nxt, _INF)

    def run(self) -> DesOutputs:
        t = self.t
        horizon = t.horizon
        for g in range(t.n_gen):
            self.advance_arrival(0, torch.ones_like(self.lb_len, dtype=torch.bool), g)
        nxt_i, nxt_t = _first_min(self.req_t)
        branches = [
            (EV_ARRIVE_LB, self.arrive_lb),
            (EV_ARRIVE_SRV, self.arrive_srv),
            (EV_RESUME, self.resume),
            (EV_SEG_END, self.seg_end),
        ]
        if self.has_timeout:
            branches.append((EV_ABANDON, self.abandon))
        it = 1
        while it < t.max_iterations:
            t_tl = self.timeline_time()
            t_arr = self.next_arrival.min(dim=1).values
            now = torch.minimum(torch.minimum(nxt_t, t_arr), t_tl)
            live = now < horizon
            if not bool(live.any()):
                break
            self.n_events = self.n_events + live.to(torch.int32)
            # precedence: the timeline, then the pool, then an arrival
            is_tl = live & (t_tl <= now)
            is_pool = live & ~is_tl & (nxt_t <= now)
            is_arr = live & ~is_tl & ~is_pool
            if bool(is_tl.any()):
                self.timeline(is_tl)
            if bool(is_arr.any()):
                self.spawn(it, now, is_arr)
            ev = _col(self.req_ev, nxt_i)
            for code, branch in branches:
                pred = is_pool & (ev == code)
                if bool(pred.any()):
                    branch(it, nxt_i, now, pred)
            nxt_i, nxt_t = _first_min(self.req_t)
            it += 1
        t_arr = self.next_arrival.min(dim=1).values
        t_min = torch.minimum(torch.minimum(nxt_t, t_arr), self.timeline_time())
        trunc = ((it >= t.max_iterations) & (t_min < horizon)).to(torch.int32)
        return DesOutputs(
            hist=self.hist,
            thr=self.thr,
            momf=torch.stack(
                [self.lat_sum, self.lat_sumsq, self.lat_min, self.lat_max, self.llm_sum,
                 self.llm_sumsq],
                dim=1,
            ),
            momi=torch.stack(
                [self.lat_count, self.n_generated, self.n_dropped, self.n_overflow,
                 self.n_rejected],
                dim=1,
            ),
            trunc=trunc,
            n_events=self.n_events,
            work=self.work,
        )


def des_reference(
    tables: DesTables,
    k0: torch.Tensor,
    k1: torch.Tensor,
    lam: torch.Tensor,
    em: torch.Tensor,
    ev: torch.Tensor,
    ed: torch.Tensor,
) -> DesOutputs:
    """Run the DES for S scenarios with plain tensor operations.

    ``k0, k1``: (S,) int32 key words; ``lam``: (S, NW) f32 arrival rates per
    user window; ``em, ev, ed``: (S, NE) f32 edge mean, scale and dropout.
    """
    if k0.device.type != "cpu":
        return _Twin(tables, k0, k1, lam, em, ev, ed).run()
    # the tiles are tiny: intra-op threads only add overhead
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _Twin(tables, k0, k1, lam, em, ev, ed).run()
    finally:
        torch.set_num_threads(threads)
