"""Plain PyTorch twin of the DES kernel (``csrc/des_kernel.cu``).

A batched transcription of the reference's Pallas kernel
(``asyncflow_tpu/engines/jaxsim/pallas_engine.py``, ``PallasEngine._kernel``
and its helpers) into torch tensor operations on ``(S, P)`` tiles, cut to
this slice's features: one generator; CPU, IO, RAM and END segments;
weighted endpoint pick; round-robin and least-connection LB; all five edge
distributions with dropout; RAM admission with the strict-FIFO grant
cascade; FIFO core handoff; pool overflow and truncation at
``max_iterations``.

Every scenario row advances by one event per loop iteration, so the shared
iteration counter ``it`` is also each row's own event counter: the CUDA
kernel, which runs one thread per scenario, reproduces it per thread and
draws the same threefry counters.  Randomness is threefry2x32 addressed by
``(it, site | seq << 10)``; the draw sites are the reference's (200 for
arrivals, 64 + 4j on the entry chain, 32 on the LB edge, 48 on the exit
edge, 4 for the endpoint pick, +1 for Box-Muller, +2 for the Poisson
loop).  Float arithmetic is float32, one operation at a time, so on the
card the twin and the kernel (built with ``--fmad=false``) round alike.

It runs on either device.  The CPU tests use it; on the card it is the
yardstick the kernel is held to, and never the main path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from asyncflow_tpu_torch.compiler.plan import (
    SEG_CPU,
    SEG_END,
    SEG_IO,
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
    EV_ARRIVE_LB,
    EV_ARRIVE_SRV,
    EV_IDLE,
    EV_RESUME,
    EV_SEG_END,
    EV_WAIT_CPU,
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

    def tensors(self) -> list[torch.Tensor]:
        """The table tensors (what the kernel reads besides its inputs)."""
        return [v for v in vars(self).values() if isinstance(v, torch.Tensor)]


def make_des_tables(plan: StaticPlan, *, device: torch.device | str) -> DesTables:
    """The kernel's plan tables (``pallas_engine.py:382-447``, the slice's rows)."""

    def i32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32).reshape(-1), device=device)

    def fl32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32).reshape(-1), device=device)

    el = plan.n_lb_edges
    lo, scale = hist_constants()
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
    )


class DesOutputs(NamedTuple):
    """The kernel's outputs, one row per scenario."""

    hist: torch.Tensor  # (S, B) i32 latency histogram
    thr: torch.Tensor  # (S, TH) i32 completions per second
    momf: torch.Tensor  # (S, 6) f32 lat sum, sumsq, min, max, 0, 0
    momi: torch.Tensor  # (S, 5) i32 completed, generated, dropped, overflow, 0
    trunc: torch.Tensor  # (S,) i32 iteration cap fired with work pending
    n_events: torch.Tensor  # (S,) i32 events simulated


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
        self.entry = t.entry_edges.tolist()
        # draw sites read at seq 0, drawn together once per iteration
        sites = [4, 32, 33, 34, 48, 49, 50, 200]
        for j in range(len(self.entry)):
            sites += [64 + 4 * j, 65 + 4 * j, 66 + 4 * j]
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
        self.smp_now = full((s,), 0.0, f)
        self.smp_window_end = full((s,), 0.0, f)
        self.widx = full((s,), -1, i64)
        self.next_arrival = full((s,), 0.0, f)
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
        self.n_events = full((s,), 0, i32)
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

    def edge_draw(self, it: int, site: int, e: torch.Tensor, pred: torch.Tensor):
        """(dropped, delay) on per-row edge ``e`` (``_edge_draw``, no spikes)."""
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
        return u_drop < drop_p, delay

    # ---- kernel pieces ----

    def advance_arrival(self, it: int, pred: torch.Tensor) -> None:
        """Window-jump exponential-gap sampler (``_advance_arrival``)."""
        t = self.t
        horizon, window = t.horizon, t.window
        smp_now = self.smp_now
        window_end = self.smp_window_end
        widx = self.widx
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
            lam = _col(self.lam, widx.clamp(0, t.n_windows - 1))
            window_end = torch.where(need, smp_now + window, window_end)
            no_users = lam <= 0.0
            u = torch.clamp_min(self.pair(it, 200, dctr)[0], _TINY)
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
        nxt = torch.where(status == 2, _INF, self.next_arrival + gap)
        self.smp_now = torch.where(pred, smp_now, self.smp_now)
        self.smp_window_end = torch.where(pred, window_end, self.smp_window_end)
        self.widx = torch.where(pred, widx, self.widx)
        self.next_arrival = torch.where(pred, nxt, self.next_arrival)

    def complete(self, start, finish, pred) -> None:
        """Histogram bin, throughput bin and latency moments (``_complete``)."""
        t = self.t
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

    def exit_flow(self, it, i, s, now, pred) -> None:
        """Release RAM, route the exit edge, complete or drop (``_exit_flow``)."""
        if not bool(pred.any()):
            return
        t = self.t
        self.release_ram(i, s, now, pred)
        e = self.exit_edge[s]
        kind = self.exit_kind[s]
        target = self.exit_target[s]
        dropped, delay = self.edge_draw(it, 48, e, pred)
        arrive = now + delay
        to_server = pred & (kind == TARGET_SERVER) & ~dropped
        to_lb = pred & (kind == TARGET_LB) & ~dropped
        to_client = pred & (kind == TARGET_CLIENT) & ~dropped
        drop_here = pred & dropped
        self.complete(_col(self.req_start, i), arrive, to_client & (arrive < t.horizon))
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

    def seg_start(self, it, i, s, ep, seg, now, pred) -> None:
        """Segment dispatch for CPU, IO and END (``_seg_start``)."""
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
        has_waiters = _col(self.cpu_wait_n, s) > 0
        can_take = (_col(self.cores_free, s) > 0) & ~has_waiters
        cpu_run = is_cpu & can_take
        cpu_wait = is_cpu & ~can_take
        run_now = cpu_run | is_io
        _add(self.cores_free, s, -1, cpu_run)
        _add(self.cpu_ticket, s, 1, cpu_wait)
        _add(self.cpu_wait_n, s, 1, cpu_wait)
        parked = run_now | cpu_wait
        _put(self.req_ev, i, torch.where(run_now, EV_SEG_END, EV_WAIT_CPU), parked)
        _put(self.req_t, i, torch.where(run_now, now + dur, _INF), parked)
        _put(self.req_ticket, i, _col(self.cpu_ticket, s), cpu_wait)
        _put(self.req_seg, i, seg, pred)
        self.exit_flow(it, i, s, now, is_end)

    def spawn(self, it, now, pred) -> None:
        """Entry chain, first free pool slot, next arrival (``_spawn_branch``)."""
        t = self.t
        self.n_generated = self.n_generated + pred.to(torch.int32)
        alive = pred
        t_cur = now
        for j, eidx in enumerate(self.entry):
            e = torch.full_like(self.lb_len, eidx)
            dropped, delay = self.edge_draw(it, 64 + 4 * j, e, alive)
            self.n_dropped = self.n_dropped + (alive & dropped).to(torch.int32)
            survives = alive & ~dropped
            t_cur = torch.where(survives, t_cur + delay, t_cur)
            alive = survives
        idle = self.req_ev == EV_IDLE
        has_free = idle.any(dim=1)
        lane = torch.arange(t.pool, device=idle.device)
        slot = torch.where(idle, lane, t.pool).min(dim=1).values.clamp_max(t.pool - 1)
        place = alive & has_free
        _put(self.req_ev, slot, t.entry_ev, place)
        _put(self.req_t, slot, t_cur, place)
        _put(self.req_srv, slot, t.entry_target, place)
        _put(self.req_start, slot, now, place)
        _put(self.req_lbslot, slot, -1, place)
        _put(self.req_ram, slot, 0.0, place)
        _put(self.req_ticket, slot, NO_TICKET, place)
        self.n_overflow = self.n_overflow + (alive & ~has_free).to(torch.int32)
        self.advance_arrival(it, pred)

    def arrive_lb(self, it, i, now, pred) -> None:
        """LB routing and the LB edge (``_arrive_lb_branch`` with ``_lb_pick``)."""
        t = self.t
        if t.n_lb == 0:
            return
        el = t.n_lb
        empty = self.lb_len <= 0
        drop_empty = pred & empty
        route = pred & ~empty
        lane = torch.arange(el, device=self.lb_order.device)[None, :]
        length = self.lb_len[:, None]
        if t.lb_algo == 0:
            slot = self.lb_order[:, 0]
            shifted = torch.roll(self.lb_order, -1, dims=1)
            rotated = torch.where(
                lane < length - 1,
                shifted,
                torch.where(lane == length - 1, self.lb_order[:, :1], self.lb_order),
            )
        else:
            conn_rot = torch.zeros_like(self.lb_order)
            for j in range(el):
                conn_j = self.lb_conn[:, j : j + 1]
                conn_rot = torch.where(self.lb_order == j, conn_j, conn_rot)
            key = torch.where(lane < length, conn_rot * el + lane, 2**30)
            best, _ = _first_min(key)
            slot = _col(self.lb_order, best)
            rotated = self.lb_order
        self.lb_order = torch.where(route[:, None], rotated, self.lb_order)
        e = self.lb_edge_index[slot]
        dropped, delay = self.edge_draw(it, 32, e, route)
        arrive = now + delay
        ok = route & ~dropped
        free = drop_empty | (route & dropped)
        _add(self.lb_conn, slot, 1, ok)
        _put(self.req_ev, i, torch.where(free, EV_IDLE, EV_ARRIVE_SRV), free | ok)
        _put(self.req_t, i, torch.where(free, _INF, arrive), free | ok)
        _put(self.req_srv, i, self.lb_target[slot], ok)
        _put(self.req_lbslot, i, slot, ok)
        self.n_dropped = self.n_dropped + free.to(torch.int32)

    def arrive_srv(self, it, i, now, pred) -> None:
        """Endpoint pick and RAM-first admission (``_arrive_srv_branch``)."""
        t = self.t
        s = _col(self.req_srv, i)
        if t.n_lb > 0:
            lbslot = _col(self.req_lbslot, i)
            _add(self.lb_conn, torch.clamp_min(lbslot, 0), -1, pred & (lbslot >= 0))
            _put(self.req_lbslot, i, -1, pred)
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
        """Release one core of ``s`` or grant it to the head FIFO waiter."""
        srv_col = torch.where(was_cpu, s, -1)
        waiting = (self.req_ev == EV_WAIT_CPU) & (self.req_srv == srv_col[:, None])
        tick = torch.where(waiting, self.req_ticket, NO_TICKET)
        j, tmin = _first_min(tick)
        grant = was_cpu & (tmin < NO_TICKET)
        release = was_cpu & ~grant
        jdur = self.t.seg_dur[
            self.seg_idx(_col(self.req_srv, j), _col(self.req_ep, j), _col(self.req_seg, j))
        ]
        _add(self.cores_free, s, 1, release)
        _add(self.cpu_wait_n, s, -1, grant)
        _put(self.req_ev, j, EV_SEG_END, grant)
        _put(self.req_t, j, now + jdur, grant)
        _put(self.req_ticket, j, NO_TICKET, grant)

    def seg_end(self, it, i, now, pred) -> None:
        """Core handoff, then the next segment (``_seg_end_branch``)."""
        s = _col(self.req_srv, i)
        ep = _col(self.req_ep, i)
        seg = _col(self.req_seg, i)
        was_cpu = pred & (self.seg_kind[self.seg_idx(s, ep, seg)] == SEG_CPU)
        if bool(was_cpu.any()):
            self.cpu_handoff(s, now, was_cpu)
        self.seg_start(it, i, s, ep, seg + 1, now, pred)

    def run(self) -> DesOutputs:
        t = self.t
        horizon = t.horizon
        self.advance_arrival(0, torch.ones_like(self.lb_len, dtype=torch.bool))
        nxt_i, nxt_t = _first_min(self.req_t)
        branches = (
            (EV_ARRIVE_LB, self.arrive_lb),
            (EV_ARRIVE_SRV, self.arrive_srv),
            (EV_RESUME, self.resume),
            (EV_SEG_END, self.seg_end),
        )
        it = 1
        while it < t.max_iterations:
            now = torch.minimum(nxt_t, self.next_arrival)
            live = now < horizon
            if not bool(live.any()):
                break
            self.n_events = self.n_events + live.to(torch.int32)
            # precedence: the pool (t_pool <= now) beats an arrival at the same time
            is_pool = live & (nxt_t <= now)
            is_arr = live & ~is_pool
            if bool(is_arr.any()):
                self.spawn(it, now, is_arr)
            ev = _col(self.req_ev, nxt_i)
            for code, branch in branches:
                pred = is_pool & (ev == code)
                if bool(pred.any()):
                    branch(it, nxt_i, now, pred)
            nxt_i, nxt_t = _first_min(self.req_t)
            it += 1
        t_min = torch.minimum(nxt_t, self.next_arrival)
        trunc = ((it >= t.max_iterations) & (t_min < horizon)).to(torch.int32)
        zf = torch.zeros_like(self.lat_sum)
        zi = torch.zeros_like(self.lat_count)
        return DesOutputs(
            hist=self.hist,
            thr=self.thr,
            momf=torch.stack(
                [self.lat_sum, self.lat_sumsq, self.lat_min, self.lat_max, zf, zf], dim=1,
            ),
            momi=torch.stack(
                [self.lat_count, self.n_generated, self.n_dropped, self.n_overflow, zi],
                dim=1,
            ),
            trunc=trunc,
            n_events=self.n_events,
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
