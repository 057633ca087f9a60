"""The scan fast path: the counterpart of the reference's ``FastEngine``
(``asyncflow_tpu/engines/jaxsim/fastpath.py``) for this slice's plans.

For a plan the compiler proves faithful (``plan.fastpath_ok``), each
scenario's discrete-event loop collapses into array work over its request
lanes, here batched over scenarios as (S, n) tensors:

1. arrivals: per user-sampling window a Poisson count of requests placed as
   normalised partial sums of exponential gaps, less each window's dropped
   residual (``_arrivals_stream``);
2. edges: one uniform a lane settles dropout and delay (``_edge_hop``);
3. round robin with fixed membership: the LB slot is the lane's arrival
   rank modulo the slots;
4. each server is a FIFO G/G/c core queue visited once a CPU burst; its
   merged visit stream is sorted by enqueue time and walked by the station
   scan (Lindley for one core, Kiefer-Wolfowitz for several); multi-burst
   endpoints relax to the fixed point; a binding RAM tier runs the joint
   RAM and core scan;
5. chained servers run in the exit DAG's topological order.

The slice: one generator; round robin with fixed membership, or no LB; any
servers and cores, chained or not; alternating CPU / IO endpoints with one
or several bursts, weighted and IO-only endpoints; non-binding or binding
RAM; uniform, exponential, normal and lognormal edges with dropout.
Everything else is refused by name before any work (:func:`fast_refusal`).

Every draw site folds the reference's constants into the scenario key
(arrivals ``fold_in(key, 0)`` then 3 and 4; entry hop j ``16 + j``; the LB
hop 32; the shared endpoint pick 6 and exit 7; per server ``64 + s`` and
``128 + s``), so the per-lane uniforms and normals are the reference's.
The per-window user and count draws come from the port's own keyed
sampler (users from the DES kernel's arrival-rate stream, counts from
``fold_in(key, COUNT_STREAM)``); tests inject the reference's through
``run_batch(window_draws=...)``.

On a CUDA device the draws run in the ``edge_draws`` kernel and the
station recursions in the ``station_scan`` kernel; on the CPU both run
their plain versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from asyncflow_tpu_torch.compiler.plan import (
    SEG_CACHE,
    SEG_DB,
    TARGET_SERVER,
    StaticPlan,
)
from asyncflow_tpu_torch.device import resolve_device
from asyncflow_tpu_torch.engines.torchsim.draws import EdgeDraws, hop_keys
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import (
    _edge_table,
    _float_tensor,
    _keys_tensor,
    _poisson_inverse,
    _uniform53,
    lam_table,
)
from asyncflow_tpu_torch.engines.torchsim.keys import fold_in, threefry2x32
from asyncflow_tpu_torch.engines.torchsim.params import (
    INF,
    ScenarioOverrides,
    base_overrides,
)
from asyncflow_tpu_torch.engines.torchsim.sampling import (
    N_HIST_BINS,
    TINY,
    f32,
    hist_constants,
    latency_bin,
)
from asyncflow_tpu_torch.engines.torchsim.sortutil import (
    searchsorted_small,
    time_rank,
    to_sorted,
)
from asyncflow_tpu_torch.engines.torchsim.station_scan import StationScan
from asyncflow_tpu_torch.errors import FastPathIneligibleError, UnsupportedFeatureError

#: fold-in tag of the per-window arrival-count stream (counter (w, 0))
COUNT_STREAM = 0x77C0


class FastState(NamedTuple):
    """Per-scenario outputs of a fast-path batch (numpy, leading axis S):
    the reference's ``FastState`` fields of this slice."""

    hist: np.ndarray
    lat_count: np.ndarray
    lat_sum: np.ndarray
    lat_sumsq: np.ndarray
    lat_min: np.ndarray
    lat_max: np.ndarray
    thr: np.ndarray
    #: (S, n, 2) (arrival, finish) of the completed requests in arrival
    #: order, compacted to the front; (1, 2) zeros without collect_clocks
    clock: np.ndarray
    clock_n: np.ndarray
    n_generated: np.ndarray
    n_dropped: np.ndarray
    n_overflow: np.ndarray
    #: (S, n_gauges) exact time-average of every gauge over the horizon
    gauge_means: np.ndarray
    n_rejected: np.ndarray


def fast_refusal(plan: StaticPlan) -> tuple[str, str] | None:
    """(feature, where) of the first feature of ``plan`` that this slice's
    fast engine does not model, or None when it models the plan.  A plan
    the reference's own analysis declines (``fastpath_ok`` false) is
    reported as ``("fastpath", reason)``."""
    if plan.unsupported:
        return plan.unsupported[0], "plan"
    if not plan.fastpath_ok:
        return "fastpath", plan.fastpath_reason
    checks = (
        (plan.n_generators > 1, "several generators", "workload"),
        (plan.n_lb_edges > 0 and plan.lb_algo != 0, "least-connections routing",
         "load balancer"),
        (plan.has_timeline, "outage timeline", "events"),
        (plan.has_spikes, "network spikes", "events"),
        (plan.has_rate_limit, "rate limit", "server overload"),
        (plan.has_queue_cap, "ready-queue cap", "server overload"),
        (plan.has_queue_timeout, "dequeue deadline", "server overload"),
        (plan.has_conn_cap, "connection cap", "server overload"),
        (bool(np.any(plan.seg_kind == SEG_DB)), "DB connection pool", "server"),
        (bool(np.any(plan.seg_kind == SEG_CACHE)), "cache mixture", "endpoint step"),
    )
    for hit, feature, where in checks:
        if hit:
            return feature, where
    return None


def check_fast_slice(plan: StaticPlan) -> None:
    """Raise for a plan the fast engine does not run: the reference's own
    refusal as :class:`FastPathIneligibleError`, a feature outside this
    slice as :class:`UnsupportedFeatureError`."""
    refusal = fast_refusal(plan)
    if refusal is None:
        return
    feature, where = refusal
    if feature == "fastpath":
        msg = f"the plan is not eligible for the scan fast path: {where}"
        raise FastPathIneligibleError(msg)
    raise UnsupportedFeatureError(feature, f"fast path, {where}")


def _span(a, b, on, horizon, amount=1.0) -> torch.Tensor:
    """(S,) sum over lanes of ``amount`` x the horizon-clipped length of
    ``[a, b)`` where ``on``."""
    lo = torch.clamp_max(a, horizon)
    hi = torch.clamp_max(b, horizon)
    return torch.where(on, amount * torch.clamp_min(hi - lo, 0.0), 0.0).sum(dim=-1)


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the (short) visit axis, in visit order."""
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] = out[..., k - 1] + x[..., k]
    return out


class FastEngine:
    """Batched scan engine for one eligible :class:`StaticPlan`."""

    def __init__(
        self,
        plan: StaticPlan,
        *,
        device: torch.device | str | None = None,
        max_requests: int | None = None,
        n_hist_bins: int = N_HIST_BINS,
        collect_clocks: bool = False,
        relax_sweeps: int | None = None,
        collect_gauges: bool = False,
        gauge_series_stride: int = 0,
        trace=None,
        blame: bool = False,
    ) -> None:
        check_fast_slice(plan)
        for on, feature in (
            (collect_gauges, "gauge grid"),
            (gauge_series_stride, "gauge grid"),
            (trace is not None, "flight recorder"),
            (blame, "blame"),
        ):
            if on:
                raise UnsupportedFeatureError(feature, "fast path option")
        if relax_sweeps is not None and relax_sweeps < 1:
            msg = f"relax_sweeps must be >= 1, got {relax_sweeps}"
            raise ValueError(msg)
        self.plan = plan
        self.device = resolve_device(device)
        self.n = int(max_requests or plan.max_requests)
        self.n_hist_bins = n_hist_bins
        self.hist_lo, self.hist_scale = hist_constants(n_hist_bins)
        self.collect_clocks = collect_clocks
        self.relax_sweeps = relax_sweeps
        self.n_windows = int(np.ceil(plan.horizon / plan.user_window))
        self.n_thr = int(np.ceil(plan.horizon)) or 1
        self.draws = EdgeDraws()
        self.scan = StationScan()
        dev = self.device
        self._dist = np.asarray(plan.edge_dist, np.int32)
        self._tables = {
            name: torch.as_tensor(np.asarray(getattr(plan, name)), device=dev)
            for name in ("endpoint_cum", "endpoint_ram", "endpoint_post_io", "n_bursts",
                         "burst_dur", "burst_pre_io", "lb_edge_index", "lb_target")
        }

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def shares_entry_sort(self, s: int) -> bool:
        """May server ``s`` reuse the shared arrival rank (``_shares_entry_sort``):
        entry tier, one burst with one enqueue offset, no modelled RAM."""
        plan = self.plan
        if s in {int(x) for x, k in zip(plan.exit_target, plan.exit_kind)
                 if k == TARGET_SERVER}:
            return False
        nep = int(plan.n_endpoints[s])
        kb = int(plan.n_bursts[s, :nep].max()) if nep else 0
        if kb != 1 or int(plan.ram_slots[s]) > 0:
            return False
        if nep > 1:
            nb = plan.n_bursts[s, :nep]
            pre0 = plan.burst_pre_io[s, :nep, 0]
            if not (np.all(nb == nb[0]) and np.all(pre0 == pre0[0])):
                return False
        return True

    def window_draws(self, keys: torch.Tensor, user_mean, req_rate) -> tuple:
        """(lam, counts), (S, NW) each: the arrival rate of every window
        (users from the DES kernel's rate stream ``fold_in(key, 0x77AB)`` x
        requests per user) and its Poisson count of arrivals, by CDF
        inversion of the uniform at counter (w, 0) of ``fold_in(key,
        COUNT_STREAM)``."""
        plan = self.plan
        lam = lam_table(keys, user_mean, req_rate, n_windows=self.n_windows,
                        user_var=plan.user_var)
        return lam, self._counts(keys, lam)

    def _window_lens(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(starts, ends, lengths) of the user windows, float32."""
        plan = self.plan
        starts = torch.arange(self.n_windows, dtype=torch.float32, device=self.device)
        starts = starts * f32(plan.user_window)
        ends = torch.clamp_max(starts + f32(plan.user_window), f32(plan.horizon))
        return starts, ends, ends - starts

    def _counts(self, keys: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
        _, _, lens = self._window_lens()
        mean = torch.clamp_min(lam * lens, f32(TINY))
        w = torch.arange(self.n_windows, dtype=torch.int64, device=keys.device)[None, :]
        kc = fold_in(keys, COUNT_STREAM)
        b0, b1 = threefry2x32(kc[:, 0:1], kc[:, 1:2], w, torch.zeros_like(w))
        top = float(mean.max()) if mean.numel() else 0.0
        kmax = math.ceil(top + 12.0 * math.sqrt(max(top, 1.0)) + 20.0)
        counts = _poisson_inverse(mean.to(torch.float64), _uniform53(b0, b1), kmax)
        return torch.where(lam > 0, counts, 0).to(torch.int32)

    # ------------------------------------------------------------------
    # arrivals
    # ------------------------------------------------------------------

    def _arrivals(self, k_arr: torch.Tensor, counts: torch.Tensor):
        """(t, valid, overflow): simulation-clock arrival times (S, n), INF
        on unused lanes (``_arrivals_stream``)."""
        n, nw, dev = self.n, self.n_windows, self.device
        s = counts.shape[0]
        starts, ends, lens = self._window_lens()
        offsets = torch.cumsum(counts.to(torch.int64), dim=1)
        total = torch.clamp_max(offsets[:, -1], n)
        slot = torch.arange(n, device=dev)
        valid = slot[None, :] < total[:, None]
        win = searchsorted_small(offsets, slot.expand(s, n), "right").clamp_(0, nw - 1)
        gaps = -torch.log1p(-self.draws.uniform(fold_in(k_arr, 3), n))
        cum = torch.cumsum(gaps, dim=1)
        del gaps
        prefix = torch.cat([cum.new_zeros((s, 1)), cum], dim=1)
        begin = torch.cat([offsets.new_zeros((s, 1)), offsets[:, :-1]], dim=1)
        base = prefix.gather(1, begin.clamp(0, n))
        wsum = prefix.gather(1, offsets.clamp(0, n)) - base
        del prefix
        extra = -torch.log1p(-self.draws.uniform(fold_in(k_arr, 4), nw))
        denom = torch.clamp_min(wsum + extra, f32(TINY))
        u = torch.clamp((cum - base.gather(1, win)) / denom.gather(1, win), 0.0, 1.0)
        del cum
        sampler_t = torch.where(valid, starts[win] + u * lens[win], INF)
        del u
        # the last arrival of each window: sampler_t is nondecreasing within
        # a window (every step from cum is monotone), so the maximum over a
        # window's valid lanes is its last valid lane's
        end = torch.minimum(offsets, total[:, None])
        last = torch.where(
            end > begin, sampler_t.gather(1, (end - 1).clamp(0, n - 1)), -math.inf,
        )
        last = torch.maximum(last, starts)
        residual = torch.where(lens > 0, ends - last, 0.0)
        cum_res = torch.cat(
            [residual.new_zeros((s, 1)), torch.cumsum(residual, dim=1)], dim=1,
        )[:, :-1]
        t = torch.where(valid, sampler_t - cum_res.gather(1, win), INF)
        return t, valid, (offsets[:, -1] - total).to(torch.int32)

    # ------------------------------------------------------------------
    # the journey
    # ------------------------------------------------------------------

    def _hop(self, keys, site: int, ov: dict, *, edge=None, eidx=None, u=None):
        uk, zk = hop_keys(keys, site)
        return self.draws.hop(
            None if u is not None else uk, zk, self._dist, ov["em"], ov["ev"], ov["ed"],
            self.n, u=u, edge=edge, eidx=eidx,
        )

    def _journey(self, keys, ov: dict, t: torch.Tensor, alive: torch.Tensor):
        """Entry chain, routing, the servers in topological order and the
        exits (``_journey`` without retries): (finish, completed,
        gauge_means, n_dropped)."""
        plan, dev, n = self.plan, self.device, self.n
        s_rows = t.shape[0]
        horizon = f32(plan.horizon)
        gm = torch.zeros((s_rows, plan.n_gauges), dtype=torch.float32, device=dev)
        n_dropped = torch.zeros(s_rows, dtype=torch.int64, device=dev)
        tab = self._tables

        # ---- entry chain ----
        for j, eidx in enumerate(plan.entry_edges.tolist()):
            alive = alive & (t < horizon)
            dropped, delay = self._hop(keys, 16 + j, ov, edge=eidx)
            ok = alive & ~dropped
            gm[:, eidx] += _span(t, t + delay, ok, horizon)
            n_dropped += (alive & dropped).sum(dim=1)
            t = torch.where(ok, t + delay, t)
            alive = ok

        # ---- routing: round robin by arrival rank ----
        alive = alive & (t < horizon)
        srv = torch.full_like(t, max(plan.entry_target, 0), dtype=torch.int64)
        if plan.n_lb_edges > 0:
            rank = time_rank(t, alive)
            slot = torch.where(alive, rank % plan.n_lb_edges, 0)
            del rank
            eidx_arr = tab["lb_edge_index"][slot].to(torch.int32)
            dropped, delay = self._hop(keys, 32, ov, eidx=eidx_arr)
            del eidx_arr
            srv = tab["lb_target"][slot].to(torch.int64)
            ok = alive & ~dropped
            lo = torch.clamp_max(t, horizon)
            hi = torch.clamp_max(t + delay, horizon)
            span = torch.where(ok, torch.clamp_min(hi - lo, 0.0), 0.0)
            for k, e in enumerate(plan.lb_edge_index.tolist()):
                gm[:, e] += torch.where(slot == k, span, 0.0).sum(dim=1)
            n_dropped += (alive & dropped).sum(dim=1)
            t = torch.where(ok, t + delay, t)
            alive = ok

        # ---- servers in topological order ----
        finish = torch.full_like(t, INF)
        completed = torch.zeros_like(alive)
        topo = list(plan.server_topo_order)
        shared_rank = (
            time_rank(t, alive) if any(self.shares_entry_sort(s) for s in topo) else None
        )
        chained = any(int(k) == TARGET_SERVER for k in plan.exit_kind)
        u_ep_shared = None if chained else self.draws.uniform(fold_in(keys, 6), n)
        u_exit_shared = None if chained else self.draws.uniform(fold_in(keys, 7), n)
        for s in topo:
            mine = alive & (srv == s) & (t < horizon)
            nep = int(plan.n_endpoints[s])
            u = u_ep_shared if u_ep_shared is not None else self.draws.uniform(
                fold_in(keys, 64 + s), n)
            ep = torch.clamp_max(searchsorted_small(tab["endpoint_cum"][s], u, "right"),
                                 nep - 1)
            ram = tab["endpoint_ram"][s][ep]
            post = tab["endpoint_post_io"][s][ep]
            cores = int(plan.server_cores[s])
            kb = int(plan.n_bursts[s, :nep].max()) if nep else 0
            ram_k = int(plan.ram_slots[s]) if len(plan.ram_slots) else 0
            w_ram = torch.zeros_like(t)
            visits = 0
            if kb == 0 and ram_k <= 0:
                dep = t + post
            elif ram_k > 0:
                nb = tab["n_bursts"][s][ep]
                pre0 = torch.where(nb >= 1, tab["burst_pre_io"][s][ep][..., 0], 0.0)
                dur0 = torch.where(nb >= 1, tab["burst_dur"][s][ep][..., 0], 0.0)
                arr = torch.where(mine, t, INF)
                rank_r = time_rank(arr, mine)
                w_ram_s, w_cpu_s, _ = self.scan.ram_core(
                    to_sorted(arr, rank_r, INF),
                    to_sorted(pre0, rank_r, 0.0),
                    to_sorted(torch.where(mine, dur0, 0.0), rank_r, 0.0),
                    to_sorted(post, rank_r, 0.0),
                    to_sorted(mine, rank_r, False),
                    ram_k,
                    cores,
                )
                w_ram = torch.where(mine, w_ram_s.gather(1, rank_r), 0.0)
                w_cpu = torch.where(mine & (dur0 > 0), w_cpu_s.gather(1, rank_r), 0.0)
                del w_ram_s, w_cpu_s, rank_r
                enq = (t + w_ram + pre0)[..., None]
                wait = w_cpu[..., None]
                pre = pre0[..., None]
                validb = mine[..., None] & (nb[..., None] > 0)
                dep = t + w_ram + pre0 + w_cpu + dur0 + post
                visits = min(kb, 1)
            else:
                enq, wait, pre, validb, dep = self._core_queue(
                    s, kb, cores, t, mine, ep, post, shared_rank,
                )
                visits = kb
            for k in range(visits):
                vb = validb[..., k]
                gm[:, plan.gauge_ready(s)] += _span(enq[..., k], enq[..., k] + wait[..., k],
                                                   vb, horizon)
                gm[:, plan.gauge_io(s)] += _span(enq[..., k] - pre[..., k], enq[..., k], vb,
                                                horizon)
            trail_start = dep - post
            gm[:, plan.gauge_io(s)] += _span(trail_start, dep, mine & (dep > trail_start),
                                            horizon)
            gm[:, plan.gauge_ram(s)] += _span(t + w_ram, dep, mine, horizon, amount=ram)

            # exit edge: the send happens only while the clock runs
            sendable = mine & (dep < horizon)
            eidx = int(plan.exit_edge[s])
            dropped, delay = self._hop(keys, 128 + s, ov, edge=eidx, u=u_exit_shared)
            ok = sendable & ~dropped
            gm[:, eidx] += _span(dep, dep + delay, ok, horizon)
            n_dropped += (sendable & dropped).sum(dim=1)
            if int(plan.exit_kind[s]) == TARGET_SERVER:
                t = torch.where(ok, dep + delay, t)
                srv = torch.where(ok, int(plan.exit_target[s]), srv)
                alive = torch.where(mine, ok, alive)
            else:
                fin = dep + delay
                done = ok & (fin < horizon)
                finish = torch.where(done, fin, finish)
                completed = completed | done
                alive = torch.where(mine, False, alive)
        return finish, completed, gm, n_dropped

    def _core_queue(self, s, kb, cores, t, mine, ep, post, shared_rank):
        """The FIFO core queue of server ``s`` visited once a burst:
        (enqueue, wait, pre-IO, valid), (S, n, kb) each, and the departure
        (S, n).  One sweep is exact for single-burst endpoints; several
        bursts relax to the fixed point (2 kb + 2 sweeps)."""
        tab = self._tables
        s_rows, n = t.shape
        nb = tab["n_bursts"][s][ep]
        ks = torch.arange(kb, device=t.device)
        validb = mine[..., None] & (ks < nb[..., None])
        dur = torch.where(validb, tab["burst_dur"][s][ep][..., :kb], 0.0)
        pre = torch.where(validb, tab["burst_pre_io"][s][ep][..., :kb], 0.0)
        pre_cum = _cumsum_last(pre)
        use_shared = shared_rank is not None and self.shares_entry_sort(s)

        def enqueue(wait):
            busy_prev = _cumsum_last(wait + dur) - (wait + dur)
            return t[..., None] + pre_cum + busy_prev

        def queue_waits(wait):
            flat_e = torch.where(validb, enqueue(wait), INF).reshape(s_rows, n * kb)
            flat_v = validb.reshape(s_rows, n * kb)
            rank = shared_rank if use_shared else time_rank(flat_e, flat_v)
            w_s = self.scan.waits(
                to_sorted(flat_e, rank, INF),
                to_sorted(dur.reshape(s_rows, n * kb), rank, 0.0),
                to_sorted(flat_v, rank, False),
                cores,
            )
            new = w_s.gather(1, rank).reshape(s_rows, n, kb)
            return torch.where(validb & (dur > 0), new, 0.0)

        sweeps = self.relax_sweeps or (1 if kb == 1 else 2 * kb + 2)
        wait = torch.zeros_like(dur)
        for _ in range(sweeps):
            wait = queue_waits(wait)
        enq = enqueue(wait)
        busy = torch.where(validb, pre + wait + dur, 0.0)
        total = busy[..., 0]
        for k in range(1, kb):
            total = total + busy[..., k]
        return enq, wait, pre, validb, t + total + post

    # ------------------------------------------------------------------
    # batch
    # ------------------------------------------------------------------

    def _overrides(self, ov: ScenarioOverrides, s: int) -> dict:
        dev, ne = self.device, self.plan.n_edges

        def per_scenario(x):
            arr = _float_tensor(x, dev)
            return arr.expand(s).contiguous() if arr.ndim == 0 else arr

        return {
            "em": _edge_table(ov.edge_mean, s, ne, dev),
            "ev": _edge_table(ov.edge_var, s, ne, dev),
            "ed": _edge_table(ov.edge_dropout, s, ne, dev),
            "um": np.asarray(ov.user_mean, np.float32),
            "rr": per_scenario(ov.req_rate),
        }

    def run_tensors(self, keys, overrides: ScenarioOverrides | None = None, *,
                    window_draws=None) -> dict:
        """:meth:`run_batch`'s outputs as tensors on the engine's device."""
        plan, dev, n = self.plan, self.device, self.n
        kt = _keys_tensor(keys, dev)
        s = kt.shape[0]
        ov = self._overrides(overrides if overrides is not None else base_overrides(plan), s)
        if window_draws is None:
            lam, counts = self.window_draws(kt, ov["um"], ov["rr"])
        else:
            users, counts = (torch.as_tensor(np.array(x), device=dev) for x in window_draws)
            lam = users.to(torch.float32) * ov["rr"][:, None]
            counts = torch.where(lam > 0, counts.to(torch.int32), 0)
        t0, valid, overflow = self._arrivals(fold_in(kt, 0), counts)
        finish, success, gm, n_dropped = self._journey(kt, ov, t0, valid)

        latency = torch.where(success, finish - t0, 0.0)
        bins = self.n_hist_bins
        lbin = latency_bin(latency, self.hist_lo, self.hist_scale, bins).to(torch.int64)
        ones = success.to(torch.int64)
        hist = torch.zeros((s, bins + 1), dtype=torch.int64, device=dev).scatter_add_(
            1, torch.where(success, lbin, bins), ones)[:, :bins]
        fin = torch.where(success, finish, 0.0)
        tbin = torch.clamp(torch.ceil(fin).to(torch.int64) - 1, 0, self.n_thr - 1)
        thr = torch.zeros((s, self.n_thr + 1), dtype=torch.int64, device=dev).scatter_add_(
            1, torch.where(success, tbin, self.n_thr), ones)[:, :self.n_thr]
        if self.collect_clocks:
            idx = torch.where(success, torch.cumsum(ones, dim=1) - 1, n)
            clock = torch.zeros((s, n + 1, 2), dtype=torch.float32, device=dev)
            clock[..., 0].scatter_(1, idx, t0)
            clock[..., 1].scatter_(1, idx, finish)
            clock = clock[:, :n]
        else:
            clock = torch.zeros((1, 2), dtype=torch.float32, device=dev)
        count = ones.sum(dim=1).to(torch.int32)
        return {
            "hist": hist.to(torch.int32),
            "lat_count": count,
            "lat_sum": latency.sum(dim=1),
            "lat_sumsq": (latency * latency).sum(dim=1),
            "lat_min": torch.where(success, latency, INF).min(dim=1).values,
            "lat_max": torch.where(success, latency, 0.0).max(dim=1).values,
            "thr": thr.to(torch.int32),
            "clock": clock,
            "clock_n": count,
            "n_generated": valid.sum(dim=1).to(torch.int32),
            "n_dropped": n_dropped.to(torch.int32),
            "n_overflow": overflow,
            "gauge_means": gm / f32(plan.horizon),
            "n_rejected": torch.zeros(s, dtype=torch.int32, device=dev),
        }

    def run_batch(self, keys, overrides: ScenarioOverrides | None = None, *,
                  window_draws=None, antithetic: bool = False) -> FastState:
        """Run S scenarios: ``keys`` (S, 2) are the port's int64 keys or the
        reference's uint32 key data; ``overrides`` fields are base-shaped or
        carry a leading scenario axis; ``window_draws`` = (users, counts),
        (S, NW) each, injects every window's user and arrival-count draws
        instead of drawing them."""
        if antithetic:
            raise UnsupportedFeatureError("antithetic draws", "fast path option")
        out = self.run_tensors(keys, overrides, window_draws=window_draws)
        return FastState(**{k: v.cpu().numpy() for k, v in out.items()})

    def run_batch_scanned(self, *_args, **_kw):
        """The reference's scanned-program entry point: not in this slice."""
        raise UnsupportedFeatureError("run_batch_scanned", "fast path")
