"""The scan fast path: the counterpart of the reference's ``FastEngine``
(``asyncflow_tpu/engines/jaxsim/fastpath.py``) for this slice's plans.

For a plan the compiler proves faithful (``plan.fastpath_ok``), each
scenario's discrete-event loop collapses into array work over its request
lanes, here batched over scenarios as (S, n) tensors:

1. arrivals: per user-sampling window a Poisson count of requests placed as
   normalised partial sums of exponential gaps, less each window's dropped
   residual (``_arrivals_stream``); with several generators each stream
   builds its own on its own contiguous lanes (``gen_slots``), and walks
   its own entry chain before the streams' lanes are put side by side;
2. edges: one uniform a lane settles dropout and delay, and one fused hop
   also writes the lanes' next times and each scenario's drops and edge
   gauge spans (``_edge_hop``, ``_add_spike`` and their epilogue);
3. round robin: with fixed membership the LB slot is the lane's arrival
   rank modulo the slots; under an outage timeline the ``lb_route`` kernel
   gives each lane its slot from the rotation's segments between marks
   (``_routed_slots``), -1 (dropped at the LB) where every server is down;
   least connections draws every slot's candidate send (keyed 32 + slot),
   and the ``lb_route`` kernel walks the arrivals in time order with each
   slot's ring of outstanding deliveries (``_routed_slots_lc``);
4. each server is a FIFO G/G/c core queue visited once a CPU burst; its
   merged visit stream is sorted by enqueue time and walked by the station
   scan (Lindley for one core, Kiefer-Wolfowitz for several); multi-burst
   endpoints relax to the fixed point; a binding RAM tier runs the joint
   RAM and core scan; a cache segment's miss adds its extra to the pre-IO
   or trailing IO it sits in; a modelled DB pool is one more FIFO station
   of K connections after the last burst, whose wait delays the departure;
5. chained servers run in the exit DAG's topological order;
6. overload controls: a server's token bucket limits its arrivals in time
   order (the station kernel's bucket mode); a ready-queue cap or a
   dequeue deadline runs the controlled scan over the enqueue times, a
   connection cap the socket scan over the arrivals (its two modes): they
   shed at the enqueue, abandon at the deadline and refuse at the arrival;
7. resilience: an edge's fault windows (a hand-authored timeline, or a
   chaos campaign's per-scenario tables) boost its dropout and multiply
   its delay at the send time, inside the hop; a server inside a dark
   window refuses an arrival before anything else there; with a client
   retry policy the lanes are blocks of attempts (block a holds attempt
   a + 1 of each logical request), the journey runs once per attempt, and
   between passes the deadlines, failures, backoffs and the retry budget
   (a token bucket over the retry wants in time order) decide which
   attempts re-issue (``_run_one``'s retry branch);
8. observability planes (``trace``, ``blame``; ``tapes.py``): the journey
   emits the flight recorder's candidates at the reference's sites in its
   order, gathered at the traced lanes, and each server's and hop's
   latency credits of every lane, which ``blame_grid`` sums keyed by each
   lane's coarse latency bin.  Neither consumes a draw.

The slice: every plan the reference's analysis accepts (``fastpath_ok``):
any number of generators; round robin with fixed membership or under an
outage timeline, least connections, or no LB; any servers and cores,
chained or not; alternating CPU / IO endpoints with one or several bursts,
weighted and IO-only endpoints; non-binding or binding RAM; stochastic
cache segments; DB connection pools; rate limits, ready-queue caps,
dequeue deadlines and connection caps; uniform, exponential, normal and
lognormal edges with dropout; network spikes (added to an edge's delay at
its send time); fault timelines, chaos-campaign hazard tables and client
retries.  Anything else is refused by name before any work
(:func:`fast_refusal`).

Every draw site folds the reference's constants into the scenario key
(arrivals ``fold_in(key, 0)`` then, per stream g of several, ``101 + g``,
then 3 and 4; entry hop j ``16 + j``, or ``1024 + stride g + j`` per
stream; the LB hop 32, or least connections' candidate on slot k ``32 +
k``; the shared endpoint pick 6 and exit 7; per server
``64 + s``, ``128 + s`` and the cache draws ``160 + s``), so the per-lane
uniforms and normals are the reference's.  The per-window user and count
draws come from the port's own keyed sampler (users from the DES kernel's
arrival-rate stream of each generator, counts from ``fold_in(key,
COUNT_STREAM)`` at counter (window, stream)); tests inject the reference's
through ``run_batch(window_draws=...)``.

The arrival times are the reference's bit for bit: the gaps go through
XLA's CPU ``log1p`` and their prefix sum keeps XLA's CPU ``cumsum`` order
(``draws.log1p_xla``, ``draws.prefix_sum_xla``).  On a CUDA device the
draws and hops run in the ``edge_draws`` kernel, the station recursions,
rate limits and overload controls in the ``station_scan`` kernel and the
timeline's routing and least connections in the ``lb_route`` kernels; on
the CPU each runs its plain version.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from asyncflow_tpu_torch.compiler.plan import (
    CACHE_POST_DB,
    CACHE_PRE_DB,
    CACHE_UNUSED,
    TARGET_SERVER,
    StaticPlan,
)
from asyncflow_tpu_torch.device import resolve_device
from asyncflow_tpu_torch.engines.torchsim.draws import (
    EdgeDraws,
    EdgeTables,
    HopOut,
    fault_rows,
    fma_xla,
    hop_keys,
    log_xla,
    prefix_sum_xla,
)
from asyncflow_tpu_torch.engines.torchsim.blame_grid import BlameGrid
from asyncflow_tpu_torch.engines.torchsim.gauge_grid import GaugeGrid
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
    fill_overrides,
)
from asyncflow_tpu_torch.engines.torchsim.routing import (
    LbRoute,
    Timeline,
    route_lanes,
    route_lanes_lc,
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
from asyncflow_tpu_torch.engines.torchsim.station_scan import (
    FLAG_ABANDONED,
    FLAG_REFUSED,
    FLAG_SHED,
    StationScan,
)
from asyncflow_tpu_torch.engines.torchsim.tapes import (
    BlameTape,
    FlightTape,
    blame_store,
    flight_rings,
)
from asyncflow_tpu_torch.errors import FastPathIneligibleError, UnsupportedFeatureError
from asyncflow_tpu_torch.observability import blame as bl
from asyncflow_tpu_torch.observability.simtrace import (
    FR_ABANDON,
    FR_ARRIVE_LB,
    FR_ARRIVE_SRV,
    FR_COMPLETE,
    FR_DROP,
    FR_REJECT,
    FR_RETRY,
    FR_RUN,
    FR_SPAWN,
    FR_TIMEOUT,
    FR_TRANSIT,
    FR_WAIT_CPU,
    FR_WAIT_DB,
    FR_WAIT_RAM,
    TraceConfig,
)

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
    #: (S, rows, n_gauges) interval endpoints of every gauge on the sample
    #: ticks (a cumulative sum over the rows gives each tick's value):
    #: ``n_samples + 2`` rows with collect_gauges, ``n_samples // k + 2``
    #: with gauge_series_stride k; (S, 1, 1) zeros without either
    gauge: np.ndarray
    #: (S, n, 2) (arrival, finish) of the completed requests in arrival
    #: order, compacted to the front; (1, 2) zeros without collect_clocks
    clock: np.ndarray
    clock_n: np.ndarray
    n_generated: np.ndarray
    n_dropped: np.ndarray
    n_overflow: np.ndarray
    #: (S, n_gauges) exact time-average of every gauge over the horizon
    gauge_means: np.ndarray
    #: arrivals refused by a dark fault window or a rate limit, shed by a
    #: ready-queue cap, abandoned at a dequeue deadline or refused by a
    #: connection cap
    n_rejected: np.ndarray
    #: the dark-window subset of n_rejected: the availability numerator
    n_dark_lost: np.ndarray
    #: client deadlines that fired while their attempt was in flight
    n_timed_out: np.ndarray
    #: granted re-issues
    n_retries: np.ndarray
    #: retry wants the budget denied
    n_budget_exhausted: np.ndarray
    #: (S, max_attempts) attempts used by each ended logical request
    #: (completed or given up); (S, 1) zeros without a retry policy
    att_hist: np.ndarray
    #: the flight recorder's rings (``trace``): (S, K, slots) codes, nodes
    #: and times of each traced request's events, (S, K) its event counts
    #: (past ``slots``: the dropped events); (S, 1, 1) and (S, 1) zeros
    #: untraced
    fr_ev: np.ndarray
    fr_node: np.ndarray
    fr_t: np.ndarray
    fr_n: np.ndarray
    #: the blame plane (``blame``): (S, n_cells, n_blame_bins) seconds a
    #: (component x phase cell, coarse latency bin), (S, n_blame_bins) the
    #: latency totals, and with collect_clocks (S, n, n_cells) each
    #: completed request's credits in clock order; (S, 1, 1), (S, 1) and
    #: (S, 1, 1) zeros without blame
    bl_grid: np.ndarray
    bl_lat: np.ndarray
    bl_store: np.ndarray


def fast_refusal(plan: StaticPlan) -> tuple[str, str] | None:
    """(feature, where) of the first feature of ``plan`` that the fast
    engine does not model, or None when it models the plan.  A plan the
    reference's own analysis declines (``fastpath_ok`` false) is reported
    as ``("fastpath", reason)``."""
    if plan.unsupported:
        return plan.unsupported[0], "plan"
    if not plan.fastpath_ok:
        return "fastpath", plan.fastpath_reason
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


def stream_slots(plan: StaticPlan, max_requests: int | None = None) -> list[int]:
    """Each generator stream's lanes: its own 6-sigma count bound
    (``plan.gen_slots``), or with one stream ``plan.max_requests``.  An
    explicit ``max_requests`` is the total: several streams' bounds are
    rescaled to it, every stream keeping at least one lane, the rounding
    settled largest remainder first (the reference's ``FastEngine``)."""
    if plan.n_generators == 1:
        return [int(max_requests or plan.max_requests)]
    base = [int(x) for x in plan.gen_slots]
    if not max_requests:
        return base
    if max_requests < len(base):
        msg = (f"max_requests={max_requests} cannot cover {len(base)} generator streams "
               "(every stream needs at least one slot)")
        raise ValueError(msg)
    total = sum(base)
    shares = [b * max_requests / total for b in base]
    scaled = [max(1, int(x)) for x in shares]
    by_frac = sorted(range(len(base)), key=lambda g: shares[g] - int(shares[g]), reverse=True)
    residual = max_requests - sum(scaled)
    i = 0
    while residual != 0:
        g = by_frac[i % len(base)]
        if residual > 0:
            scaled[g] += 1
            residual -= 1
        elif scaled[g] > 1:
            scaled[g] -= 1
            residual += 1
        i += 1
    return scaled


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
        """``collect_gauges`` collects every gauge on the fine grid of the
        plan's sample ticks; ``gauge_series_stride`` k > 0, without it, on a
        grid coarsened k-fold (period ``sample_period * k``, ``n_samples //
        k`` ticks), the sweep's streamed series: the value at a coarse tick
        is the fine grid's at that time.  The grid consumes no draws.

        ``trace`` (a :class:`TraceConfig` or a mapping of its fields) runs
        the flight recorder: each scenario's first ``sample_requests``
        logical requests, their events in rings of ``event_slots``.
        ``blame`` runs the blame plane: every completed request's latency
        split into (component, phase) credits, summed a coarse latency bin
        (with ``collect_clocks`` also each request's row).  Neither consumes
        a draw or changes another output."""
        check_fast_slice(plan)
        self.trace = TraceConfig.of(trace)
        self.blame = bool(blame)
        if relax_sweeps is not None and relax_sweeps < 1:
            msg = f"relax_sweeps must be >= 1, got {relax_sweeps}"
            raise ValueError(msg)
        if gauge_series_stride < 0:
            msg = f"gauge_series_stride must be >= 0, got {gauge_series_stride}"
            raise ValueError(msg)
        self.plan = plan
        if collect_gauges:
            self._gauge_period = plan.sample_period
            self._gauge_samples = plan.n_samples
        elif gauge_series_stride:
            self._gauge_period = plan.sample_period * gauge_series_stride
            self._gauge_samples = plan.n_samples // gauge_series_stride
        else:
            self._gauge_period = plan.sample_period
            self._gauge_samples = 0
        self._collect_gauge_grid = collect_gauges or gauge_series_stride > 0
        self.gauge_series_stride = 0 if collect_gauges else gauge_series_stride
        self.device = resolve_device(device)
        #: each stream's arrival lanes, a contiguous slice each, in generator
        #: order
        self.gen_n = stream_slots(plan, max_requests)
        self.n = sum(self.gen_n)
        #: attempts a logical request may use: with a retry policy the n
        #: lanes are A blocks of n // A, block a holding attempt a + 1 of
        #: the logical request of its lane's offset (arrivals in block 0)
        self.attempts = max(int(plan.retry_max_attempts), 1) if plan.has_retry else 1
        if self.attempts > 1:
            n1 = max(self.n // self.attempts, 1)
            self.gen_n = [n1]
            self.n = n1 * self.attempts
        #: are the lanes' failure times needed (by the retry driver only)
        self.track_fail = plan.has_retry
        #: do fault windows reach some server, or some edge (a timeline's
        #: or a chaos campaign's)
        self.srv_faulted = (np.any(plan.fault_srv_down != 0, axis=0)
                            | np.asarray(plan.hz_srv_mask, bool))
        self.has_edge_faults = bool(
            np.any(plan.fault_edge_lat != 1.0) or np.any(plan.fault_edge_drop != 0.0)
            or np.any(plan.hz_edge_mask))
        self.n_hist_bins = n_hist_bins
        self.hist_lo, self.hist_scale = hist_constants(n_hist_bins)
        self.collect_clocks = collect_clocks
        self.relax_sweeps = relax_sweeps
        if plan.n_generators > 1:
            self._streams = [
                (float(plan.gen_window[g]), float(plan.gen_user_var[g]))
                for g in range(plan.n_generators)
            ]
        else:
            self._streams = [(float(plan.user_window), float(plan.user_var))]
        #: user windows of each stream
        self.stream_windows = [int(np.ceil(plan.horizon / w)) for w, _ in self._streams]
        self.n_windows = self.stream_windows[0]
        self.n_thr = int(np.ceil(plan.horizon)) or 1
        self.draws = EdgeDraws()
        self.scan = StationScan()
        self.route = LbRoute()
        self.gauge = GaugeGrid()
        self.blame_grid = BlameGrid()
        self._bl_cells = bl.n_cells(plan.n_servers, plan.n_edges)
        self._bl_bins = bl.n_blame_bins(n_hist_bins)
        self._bl_stride = bl.blame_stride(n_hist_bins)
        dev = self.device
        self._dist = np.asarray(plan.edge_dist, np.int32)
        self._tables = {
            name: torch.as_tensor(np.asarray(getattr(plan, name)), device=dev)
            for name in ("endpoint_cum", "endpoint_ram", "endpoint_post_io", "n_bursts",
                         "burst_dur", "burst_pre_io", "fp_db_pre", "fp_db_dur",
                         "fp_cache_slot", "fp_cache_miss_prob", "fp_cache_extra")
        }

        def table(x, dtype) -> torch.Tensor:
            return torch.as_tensor(np.asarray(x), device=dev).to(dtype).contiguous()

        # what every hop reads of the plan: the LB's slots and the spikes
        self._hop_static = {}
        if plan.n_lb_edges > 0:
            self._hop_static.update(lb_edge=table(plan.lb_edge_index, torch.int32),
                                    lb_target=table(plan.lb_target, torch.int32))
        if plan.has_spikes:
            self._hop_static.update(spike_t=table(plan.spike_times, torch.float32),
                                    spike_v=table(plan.spike_values, torch.float32))
        #: least connections' LB (its marks, if any, apply in its walk)
        self.lc = plan.n_lb_edges > 0 and plan.lb_algo == 1
        #: the LB's outage timeline, where round robin runs under one; always
        #: under least connections (no marks without outages)
        self.timeline = (
            Timeline(plan.timeline_times, plan.timeline_down, plan.timeline_slot,
                     plan.n_lb_edges, dev)
            if plan.n_lb_edges > 0 and (plan.has_timeline or self.lc) else None
        )

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def has_cache(self, s: int) -> bool:
        """Does server ``s`` draw stochastic cache extras."""
        slots = self.plan.fp_cache_slot
        return bool(slots.size) and bool(np.any(slots[s] != CACHE_UNUSED))

    def shares_entry_sort(self, s: int) -> bool:
        """May server ``s`` reuse the shared arrival rank (``_shares_entry_sort``):
        entry tier, one burst with one enqueue offset, no modelled RAM and no
        cache extra before its burst."""
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
        return not (plan.fp_cache_slot.size and np.any(plan.fp_cache_slot[s] >= 0))

    def window_draws(self, keys: torch.Tensor, user_mean, req_rate) -> tuple[list, list]:
        """(lam, counts): a list of (S, NW_g) tensors each, one a stream.
        Stream g's arrival rates are its users (from the DES kernel's rate
        stream ``fold_in(key, 0x77AB + g)``) x requests per user, and its
        Poisson counts invert the uniform at counter (w, g) of ``fold_in(key,
        COUNT_STREAM)``.  ``user_mean`` and ``req_rate`` are lists of each
        stream's scalar or (S,) values."""
        lams, counts = [], []
        for g, (_window, user_var) in enumerate(self._streams):
            lam = lam_table(keys, user_mean[g], req_rate[g], n_windows=self.stream_windows[g],
                            user_var=user_var, stream=g)
            lams.append(lam)
            counts.append(self._counts(keys, lam, g))
        return lams, counts

    def _window_lens(self, g: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(starts, ends, lengths) of stream ``g``'s user windows, float32."""
        window = f32(self._streams[g][0])
        starts = torch.arange(self.stream_windows[g], dtype=torch.float32, device=self.device)
        starts = starts * window
        ends = torch.clamp_max(starts + window, f32(self.plan.horizon))
        return starts, ends, ends - starts

    def _counts(self, keys: torch.Tensor, lam: torch.Tensor, g: int = 0) -> torch.Tensor:
        _, _, lens = self._window_lens(g)
        mean = torch.clamp_min(lam * lens, f32(TINY))
        w = torch.arange(lam.shape[1], dtype=torch.int64, device=keys.device)[None, :]
        kc = fold_in(keys, COUNT_STREAM)
        b0, b1 = threefry2x32(kc[:, 0:1], kc[:, 1:2], w, torch.full_like(w, g))
        top = float(mean.max()) if mean.numel() else 0.0
        kmax = math.ceil(top + 12.0 * math.sqrt(max(top, 1.0)) + 20.0)
        counts = _poisson_inverse(mean.to(torch.float64), _uniform53(b0, b1), kmax)
        return torch.where(lam > 0, counts, 0).to(torch.int32)

    # ------------------------------------------------------------------
    # arrivals
    # ------------------------------------------------------------------

    def _arrivals(self, k_arr: torch.Tensor, counts: torch.Tensor, g: int = 0):
        """(t, valid, overflow) of stream ``g`` keyed ``k_arr``: simulation-
        clock arrival times (S, n_g), INF on unused lanes
        (``_arrivals_stream``)."""
        n, nw, dev = self.gen_n[g], self.stream_windows[g], self.device
        s = counts.shape[0]
        starts, ends, lens = self._window_lens(g)
        offsets = torch.cumsum(counts.to(torch.int64), dim=1)
        total = torch.clamp_max(offsets[:, -1], n)
        slot = torch.arange(n, device=dev)
        valid = slot[None, :] < total[:, None]
        win = searchsorted_small(offsets, slot.expand(s, n), "right").clamp_(0, nw - 1)
        # the gaps' prefix sum in XLA's association order, so that the
        # arrivals take the reference's values, after a leading zero
        prefix = self.draws.gap_cumsum(fold_in(k_arr, 3), n)
        cum = prefix[:, 1:]
        begin = torch.cat([offsets.new_zeros((s, 1)), offsets[:, :-1]], dim=1)
        base = prefix.gather(1, begin.clamp(0, n))
        wsum = prefix.gather(1, offsets.clamp(0, n)) - base
        del prefix
        extra = self.draws.uniform(fold_in(k_arr, 4), nw, gap=True)
        denom = torch.clamp_min(wsum + extra, f32(TINY))
        u = torch.clamp((cum - base.gather(1, win)) / denom.gather(1, win), 0.0, 1.0)
        del cum
        # XLA's CPU compiler fuses ``starts[win] + u * lens[win]`` into one
        # rounding, but for two windows: their two-entry table's lookup
        # becomes a select whose arms share the product, which it then
        # rounds on its own (one window: the same either way)
        sampler_t = torch.where(
            valid, fma_xla(u, lens[win], starts[win]) if nw != 2 else starts[win] + u * lens[win],
            INF)
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
        cum_res = F.pad(prefix_sum_xla(residual), (1, 0))[:, :-1]
        t = torch.where(valid, sampler_t - cum_res.gather(1, win), INF)
        return t, valid, (offsets[:, -1] - total).to(torch.int32)

    def _stream_arrivals(self, k_arr: torch.Tensor, counts: list) -> tuple:
        """Every stream's (t, valid) on its own (S, n_g) lanes, and the
        scenarios' overflow: one stream keyed ``k_arr``, or stream g keyed
        ``fold_in(k_arr, 101 + g)`` (``_arrivals``)."""
        ts, valids, overflow = [], [], None
        for g in range(len(self.gen_n)):
            key = k_arr if len(self.gen_n) == 1 else fold_in(k_arr, 101 + g)
            t, valid, over = self._arrivals(key, counts[g], g)
            ts.append(t)
            valids.append(valid)
            overflow = over if overflow is None else overflow + over
        return ts, valids, overflow

    # ------------------------------------------------------------------
    # the journey
    # ------------------------------------------------------------------

    def _edge_tables(self, ov: dict) -> EdgeTables:
        faults = {}
        if self.has_edge_faults:
            faults = {"fault_t": ov["fe_t"], "fault_lat": ov["fe_lat"],
                      "fault_drop": ov["fe_drop"]}
        return EdgeTables(
            dist=self._dist, mean=ov["em"], var=ov["ev"], drop=ov["ed"],
            horizon=self.plan.horizon, **self._hop_static, **faults,
        )

    def _hop(self, tables: EdgeTables, keys, site: int, t, alive, *, ukey=None,
             **lanes) -> HopOut:
        """The fused hop keyed ``fold_in(key, site)`` (its uniform stream, or
        the shared ``ukey``) of the lanes ``alive`` sending at ``t`` over
        ``edge=``, or the LB's ``rank=`` or ``slot=``."""
        uk, zk = hop_keys(keys, site)
        return self.draws.hop(tables, t, alive, uk if ukey is None else ukey, zk, **lanes)

    def _lc_route(self, tables: EdgeTables, keys, t, alive):
        """Least connections: every slot's candidate send of the lanes
        ``alive`` at ``t`` (the static hop keyed ``32 + slot``, in one
        launch for all slots, (S, n, slots), no sums: they belong to the
        lanes that pick the slot), the picks, and the picked slot's outcome:
        (slot (S, n) int64, -1 where no target is healthy; its arrival time
        and sent flag)."""
        plan = self.plan
        edges = plan.lb_edge_index.tolist()
        uk, zk = zip(*(hop_keys(keys, 32 + k) for k in range(len(edges))))
        deliv, sent = self.draws.candidates(tables, t, alive, torch.stack(uk, dim=1),
                                            torch.stack(zk, dim=1), edges)
        slot = route_lanes_lc(self.route, self.timeline, t, alive, deliv, ~sent,
                              int(plan.lc_ring)).long()
        pick = torch.clamp_min(slot, 0)[..., None]
        return slot, deliv.gather(2, pick)[..., 0], sent.gather(2, pick)[..., 0]

    def _entry_chains(self, keys, tables, ts: list, valids: list, gm, n_dropped, record=True,
                      grid=None, tape=None, btape=None):
        """Each stream's entry chain on its own lanes, then the streams'
        lanes side by side: (t, alive, fail_t), (S, n), ``fail_t`` the issue
        time of a lane dropped on the chain (INF elsewhere; None where the
        engine tracks no failure times).  One stream folds hop j in at site
        16 + j; stream g of several at 1024 + stride g + j.  A hop's drop
        and delivery go on ``tape`` (processed at the issue: the chain is
        walked inside the spawn event), its realised advance on ``btape``."""
        plan = self.plan
        if len(ts) == 1:
            chains = [plan.entry_edges.tolist()]
            site = lambda _g, j: 16 + j  # noqa: E731
        else:
            chains = [plan.gen_entry_edges[g, : plan.gen_entry_len[g]].tolist()
                      for g in range(len(ts))]
            stride = max(len(c) for c in chains)
            site = lambda g, j: 1024 + stride * g + j  # noqa: E731
        horizon = f32(plan.horizon)
        width = sum(x.shape[1] for x in ts)
        out_t, out_alive, out_fail = [], [], []
        off = 0
        for g, chain in enumerate(chains):
            t, alive = ts[g], valids[g]
            t0 = t
            fail = torch.full_like(t, INF) if self.track_fail else None
            # each hop sends only while the clock runs (alive & t < horizon)
            for j, eidx in enumerate(chain):
                hop = self._hop(tables, keys, site(g, j), t, alive, edge=eidx)
                if record:
                    gm[:, eidx] += hop.span[:, 0]
                    self._gauge_intervals(grid, eidx, t, hop.t_next, 1.0, hop.ok)
                    n_dropped += hop.dropped
                if fail is not None:
                    fail = torch.where(alive & (t < horizon) & ~hop.ok, t0, fail)
                if tape is not None:
                    tape.emit(FR_DROP, eidx, t, t0, alive & (t < horizon) & ~hop.ok, off=off)
                    tape.emit(FR_TRANSIT, eidx, hop.t_next, t0, hop.ok, off=off)
                if btape is not None:
                    btape.credit(btape.transit(eidx), hop.t_next - t, hop.ok, off=off, n=width)
                t, alive = hop.t_next, hop.ok
            off += t.shape[1]
            out_t.append(t)
            out_alive.append(alive)
            out_fail.append(fail)
        if len(out_t) == 1:
            return out_t[0], out_alive[0], out_fail[0]
        fail = torch.cat(out_fail, dim=1) if self.track_fail else None
        return torch.cat(out_t, dim=1), torch.cat(out_alive, dim=1), fail

    def _cache_extras(self, keys, s: int, ep: torch.Tensor):
        """Server ``s``'s stochastic cache draws: the (S, n, CMAX) placement
        of each lane's segments and their extras (miss minus hit where the
        uniform of ``fold_in(key, 160 + s)``, counted over n x CMAX in row
        order, misses)."""
        tab = self._tables
        s_rows, n = ep.shape
        cmax = int(tab["fp_cache_slot"].shape[2])
        u = self.draws.uniform(fold_in(keys, 160 + s), n * cmax).view(s_rows, n, cmax)
        place = tab["fp_cache_slot"][s][ep]
        missed = u < tab["fp_cache_miss_prob"][s][ep]
        return place, torch.where(missed, tab["fp_cache_extra"][s][ep], 0.0)

    def _journey(self, keys, ov: dict, ts: list, valids: list, *, record: bool = True,
                 tape: FlightTape | None = None, btape: BlameTape | None = None):
        """One pass of entry chains, routing, the servers in topological
        order and the exits (``_journey``): (finish, completed, fail_t,
        gauge_means, n_dropped, n_rejected, n_dark_lost, gauge grid).  ``fail_t`` (None
        but for the retry driver, ``track_fail``) is a lane's failure time as
        its client sees it (INF where it completed or was in flight at the
        horizon): a drop on the entry chain at the attempt's issue, a drop
        at the LB or on its edge at the send there, a dark refusal, a rate
        limit or a connection cap's refusal at the arrival, a shed at the
        enqueue, an abandon at the deadline, a drop on the exit edge at the
        departure.  ``record=False`` skips every gauge and counter (the
        retry driver's relaxation passes need only the outcome times); the
        grid is None where it does not record or collects no grid.  ``tape``
        takes the flight recorder's candidates at the reference's sites in
        its order (processing times: the event's own, or the issue on the
        entry chain, or for a completion the departure (the delivery under
        a retry policy)); ``btape`` each server's queue waits and service
        (the exact remainder of its occupancy) and each hop's realised
        advance."""
        plan, dev, n = self.plan, self.device, self.n
        s_rows = ts[0].shape[0]
        horizon = f32(plan.horizon)
        gm = torch.zeros((s_rows, plan.n_gauges), dtype=torch.float32, device=dev)
        n_dropped = torch.zeros(s_rows, dtype=torch.int64, device=dev)
        n_dark = torch.zeros(s_rows, dtype=torch.int64, device=dev)
        n_rej = torch.zeros(s_rows, dtype=torch.int64, device=dev)
        grid = (torch.zeros((s_rows, self._gauge_samples + 2, plan.n_gauges),
                            dtype=torch.float32, device=dev)
                if record and self._collect_gauge_grid else None)
        tab = self._tables
        tables = self._edge_tables(ov)
        t, alive, fail_t = self._entry_chains(keys, tables, ts, valids, gm, n_dropped, record,
                                              grid, tape, btape)

        # ---- routing: least connections, or round robin by arrival rank or
        # under the timeline ----
        alive = alive & (t < horizon)
        srv = torch.full_like(t, max(plan.entry_target, 0), dtype=torch.int32)
        lb_cells = [bl.cell(bl.comp_edge(plan.n_servers, e), bl.PH_TRANSIT)
                    for e in plan.lb_edge_index.tolist()]
        if plan.n_lb_edges > 0 and tape is not None:
            tape.emit(FR_ARRIVE_LB, -1, t, t, alive)
        if self.lc:
            slot, t_next, sent = self._lc_route(tables, keys, t, alive)
            unrouted = alive & (slot < 0)
            alive = alive & ~unrouted
            ok = alive & sent
            self._lb_planes(tape, btape, lb_cells, t, t_next, unrouted, alive & ~sent, ok, slot)
            if record:
                lane_span = torch.where(ok, torch.clamp_min(
                    torch.clamp_max(t_next, horizon) - torch.clamp_max(t, horizon), 0.0), 0.0)
                edges = plan.lb_edge_index.tolist()
                for k, e in enumerate(edges):
                    gm[:, e] += torch.where(slot == k, lane_span, 0.0).double().sum(dim=1).float()
                if grid is not None:
                    self.gauge.add_slots(grid, edges, t, t_next, ok, self._gauge_period,
                                         slot=slot)
                del lane_span
                n_dropped += unrouted.sum(dim=1) + (alive & ~sent).sum(dim=1)
            if fail_t is not None:
                # no healthy target, or dropped on the picked edge: at the send
                fail_t = torch.where(unrouted | (alive & ~sent), t, fail_t)
            srv = self._hop_static["lb_target"][torch.clamp_min(slot, 0)]
            t, alive = torch.where(ok, t_next, t), ok
            del slot, t_next, sent, unrouted
        elif plan.n_lb_edges > 0:
            if self.timeline is None:
                lanes = {"rank": time_rank(t, alive)}
            else:
                lanes = {"slot": route_lanes(self.route, self.timeline, t, alive)}
            hop = self._hop(tables, keys, 32, t, alive, **lanes)
            srv = hop.target
            if tape is not None or btape is not None:
                if "rank" in lanes:
                    unrouted = torch.zeros_like(alive)
                    slot = torch.where(alive, lanes["rank"] % plan.n_lb_edges, 0)
                else:
                    unrouted = alive & (lanes["slot"] < 0)
                    slot = lanes["slot"]
                self._lb_planes(tape, btape, lb_cells, t, hop.t_next, unrouted,
                                alive & ~unrouted & ~hop.ok, hop.ok, slot)
                del unrouted, slot
            if record:
                edges = plan.lb_edge_index.tolist()
                for k, e in enumerate(edges):
                    gm[:, e] += hop.span[:, k]
                if grid is not None:
                    # each lane's edge: its slot, or its rank modulo the slots
                    self.gauge.add_slots(grid, edges, t, hop.t_next, hop.ok,
                                         self._gauge_period, **lanes)
                n_dropped += hop.dropped
            del lanes
            if fail_t is not None:
                # no healthy target, or dropped on the LB's edge: at the send
                fail_t = torch.where(alive & ~hop.ok, t, fail_t)
            t, alive = hop.t_next, hop.ok

        # ---- servers in topological order ----
        finish = torch.full_like(t, INF)
        completed = torch.zeros_like(alive)
        topo = list(plan.server_topo_order)
        shared_rank = (
            time_rank(t, alive) if any(self.shares_entry_sort(s) for s in topo) else None
        )
        chained = any(int(k) == TARGET_SERVER for k in plan.exit_kind)
        # unchained servers serve disjoint lanes: one endpoint-pick stream and
        # one exit-edge stream for all of them
        u_ep_shared = None if chained else self.draws.uniform(fold_in(keys, 6), n)
        exit_key = None if chained else fold_in(keys, 7)
        for s in topo:
            mine = alive & (srv == s) & (t < horizon)
            if self.srv_faulted[s]:
                # a dark window refuses the arrival before anything else here
                dark = mine & self._server_down(ov, s, t)
                if record:
                    n_dark += dark.sum(dim=1)
                    n_rej += dark.sum(dim=1)
                if fail_t is not None:
                    fail_t = torch.where(dark, t, fail_t)
                if tape is not None:
                    tape.emit(FR_REJECT, s, t, t, dark)
                alive = alive & ~dark
                mine = mine & ~dark
            rate = float(plan.server_rate_limit[s]) if len(plan.server_rate_limit) else -1.0
            if rate >= 0:
                # the token bucket over the server's arrivals in time order
                rank_rl = time_rank(t, mine)
                accepted = self.scan.bucket(
                    to_sorted(torch.where(mine, t, INF), rank_rl, INF),
                    to_sorted(mine, rank_rl, False), rate, float(plan.server_rate_burst[s]),
                ).gather(1, rank_rl)
                limited = mine & ~accepted
                del rank_rl, accepted
                if record:
                    n_rej += limited.sum(dim=1)
                if fail_t is not None:
                    fail_t = torch.where(limited, t, fail_t)
                if tape is not None:
                    tape.emit(FR_REJECT, s, t, t, limited)
                alive = alive & ~limited
                mine = mine & ~limited
            nep = int(plan.n_endpoints[s])
            u = u_ep_shared if u_ep_shared is not None else self.draws.uniform(
                fold_in(keys, 64 + s), n)
            ep = torch.clamp_max(searchsorted_small(tab["endpoint_cum"][s], u, "right"),
                                 nep - 1)
            ram = tab["endpoint_ram"][s][ep]
            post = tab["endpoint_post_io"][s][ep]
            # stochastic cache segments: each miss adds its extra to the
            # burst pre-IO or the trailing IO the segment occupies
            place = extra = trail_extra = None
            if self.has_cache(s):
                place, extra = self._cache_extras(keys, s, ep)
                pre_db = torch.zeros_like(t)
                post_db = torch.zeros_like(t)
                for c in range(place.shape[2]):
                    pre_db = pre_db + torch.where(place[..., c] == CACHE_PRE_DB,
                                                  extra[..., c], 0.0)
                    post_db = post_db + torch.where(place[..., c] == CACHE_POST_DB,
                                                    extra[..., c], 0.0)
                trail_extra = pre_db
                post = post + pre_db + post_db
            cores = int(plan.server_cores[s])
            kb = int(plan.n_bursts[s, :nep].max()) if nep else 0
            ram_k = int(plan.ram_slots[s]) if len(plan.ram_slots) else 0
            w_ram = None  # the RAM tier's wait: none but under a binding tier
            w_cpu = None  # the lanes' core-queue waits summed over their visits
            visits = 0
            cap = int(plan.server_queue_cap[s]) if len(plan.server_queue_cap) else -1
            timeout = (float(plan.server_queue_timeout[s]) if len(plan.server_queue_timeout)
                       else -1.0)
            conn = int(plan.server_conn_cap[s]) if len(plan.server_conn_cap) else -1
            if tape is not None and conn < 0:
                # a connection cap's refusals come before the arrival
                tape.emit(FR_ARRIVE_SRV, s, t, t, mine)
            if conn >= 0 or (kb > 0 and ram_k <= 0 and (cap >= 0 or timeout >= 0)):
                # the overload controls' scans (at most one burst, no RAM
                # tier): their rejections leave the lanes here
                enq, wait, pre, validb, (dep, trail_start), rejected, fail_at = self._controlled_queue(
                    s, cores, t, mine, ep, post, place, extra, cap, timeout, conn, ram, gm,
                    record, grid, tape)
                if record:
                    n_rej += rejected.sum(dim=1)
                if fail_t is not None:
                    fail_t = torch.where(rejected, fail_at, fail_t)
                alive = alive & ~rejected
                mine = mine & ~rejected
                visits = kb
                if btape is not None:
                    w_cpu = torch.where(mine, wait[..., 0], 0.0)
                del rejected, fail_at
            elif kb == 0 and ram_k <= 0:
                dep, trail_start = self._departure(t, None, post, s, place)
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
                dep, trail_start = self._departure(t + w_ram + pre0 + w_cpu, dur0, post, s,
                                                   place)
                visits = min(kb, 1)
                if tape is not None:
                    # a blocked acquire: the wait at the enqueue, the run at
                    # the grant; nothing where the resource was free
                    rwait = mine & (w_ram > 0)
                    tape.emit(FR_WAIT_RAM, s, t, t, rwait)
                    tape.emit(FR_RUN, s, t + w_ram, t + w_ram, rwait)
                    qwait = mine & (w_cpu > 0)
                    tape.emit(FR_WAIT_CPU, s, enq[..., 0], enq[..., 0], qwait)
                    ran = enq[..., 0] + w_cpu
                    tape.emit(FR_RUN, s, ran, ran, qwait)
                    del rwait, qwait, ran
            else:
                enq, wait, pre, validb, busy = self._core_queue(
                    s, kb, cores, t, mine, ep, post, shared_rank, place, extra,
                )
                dep, trail_start = self._departure(t + busy, None, post, s, place)
                visits = kb
                if tape is not None:
                    for k in range(kb):
                        qwait = validb[..., k] & (wait[..., k] > 0)
                        tape.emit(FR_WAIT_CPU, s, enq[..., k], enq[..., k], qwait)
                        ran = enq[..., k] + wait[..., k]
                        tape.emit(FR_RUN, s, ran, ran, qwait)
                        del qwait, ran
                if btape is not None:
                    w_cpu = torch.where(validb[..., 0], wait[..., 0], 0.0)
                    for k in range(1, kb):
                        w_cpu = w_cpu + torch.where(validb[..., k], wait[..., k], 0.0)
            for k in range(visits if record else 0):
                vb = validb[..., k]
                e_k, w_k, p_k = enq[..., k], wait[..., k], pre[..., k]
                gm[:, plan.gauge_ready(s)] += _span(e_k, e_k + w_k, vb, horizon)
                gm[:, plan.gauge_io(s)] += _span(e_k - p_k, e_k, vb, horizon)
                if grid is not None:
                    self.gauge.add_queue(grid, (plan.gauge_ready(s), plan.gauge_io(s)), e_k, w_k,
                                         p_k, vb, self._gauge_period)
                del e_k, w_k, p_k
            dep, w_db = self._db_station(s, ep, mine, trail_start, trail_extra, dep, tape)
            if record:
                # the trailing IO sleep holds the DB pool's wait too
                gm[:, plan.gauge_io(s)] += _span(trail_start, dep, mine & (dep > trail_start),
                                                horizon)
                held = t if w_ram is None else t + w_ram
                gm[:, plan.gauge_ram(s)] += _span(held, dep, mine, horizon, amount=ram)
                del held
                if grid is not None:
                    self.gauge.add_trail(grid, (plan.gauge_io(s), plan.gauge_ram(s)),
                                         trail_start, dep, t, w_ram, mine, ram,
                                         self._gauge_period)
            if btape is not None:
                self._server_credits(btape, s, t, dep, mine, w_cpu, w_ram, w_db)
            del w_cpu, w_db

            # exit edge: the send happens only while the clock runs
            eidx = int(plan.exit_edge[s])
            hop = self._hop(tables, keys, 128 + s, dep, mine, edge=eidx, ukey=exit_key)
            if record:
                gm[:, eidx] += hop.span[:, 0]
                self._gauge_intervals(grid, eidx, dep, hop.t_next, 1.0, hop.ok)
                n_dropped += hop.dropped
            if fail_t is not None:
                fail_t = torch.where(mine & (dep < horizon) & ~hop.ok, dep, fail_t)
            if tape is not None:
                tape.emit(FR_DROP, eidx, dep, dep, mine & (dep < horizon) & ~hop.ok)
                tape.emit(FR_TRANSIT, eidx, hop.t_next, dep, hop.ok)
            if btape is not None:
                btape.credit(btape.transit(eidx), hop.t_next - dep, hop.ok)
            ok = hop.ok
            if int(plan.exit_kind[s]) == TARGET_SERVER:
                t = torch.where(ok, hop.t_next, t)
                srv = torch.where(ok, int(plan.exit_target[s]), srv)
                alive = torch.where(mine, ok, alive)
            else:
                done = ok & (hop.t_next < horizon)
                if tape is not None:
                    # a retry plan's client notices the completion at the
                    # delivery; else it is recorded with the departure
                    tape.emit(FR_COMPLETE, -1, hop.t_next,
                              hop.t_next if plan.has_retry else dep, done)
                finish = torch.where(done, hop.t_next, finish)
                completed = completed | done
                alive = torch.where(mine, False, alive)
        return finish, completed, fail_t, gm, n_dropped, n_rej, n_dark, grid

    @staticmethod
    def _server_credits(btape, s: int, t, dep, mine, w_cpu, w_ram, w_db) -> None:
        """Server ``s``'s credits of the lanes ``mine``: the core queue's,
        the RAM tier's and the DB pool's waits where positive (each where
        the server has it), then the service as the exact remainder of its
        occupancy, ``max((dep - t) - waits, 0)``, so that a lane's credits
        here sum to ``dep - t``."""
        svc = dep - t
        for phase, wait in ((bl.PH_Q_CPU, w_cpu), (bl.PH_Q_RAM, w_ram), (bl.PH_Q_DB, w_db)):
            if wait is not None:
                btape.credit(btape.server(s, phase), wait, mine & (wait > 0))
                svc = svc - wait
        btape.credit(btape.server(s, bl.PH_SERVICE), torch.clamp_min(svc, 0.0), mine)

    def _lb_planes(self, tape, btape, cells: list, t, t_next, unrouted, dropped, ok,
                   slot) -> None:
        """The LB hop on the planes: a lane with no healthy target dropped at
        the LB (node -1), a drop on its slot's edge or the delivery over it
        (at ``t_next``), and the delivery's advance into that edge's transit
        cell (``cells`` by slot)."""
        if tape is not None:
            edge = (self._hop_static["lb_edge"], slot)
            tape.emit(FR_DROP, -1, t, t, unrouted)
            tape.emit(FR_DROP, edge, t, t, dropped)
            tape.emit(FR_TRANSIT, edge, t_next, t, ok)
        if btape is not None:
            btape.credit_slots(cells, slot, t_next - t, ok)

    def _gauge_intervals(self, grid, gidx: int, t0, t1, amount, on) -> None:
        """+amount at ``t0``'s bucket and -amount at ``t1``'s in column
        ``gidx`` of ``grid`` where ``on`` (``_gauge_intervals``), a site
        alone; nothing without a grid (the grouped sites, the LB's edges, a
        visit's queue and a server's trailing IO and RAM, call the grid's
        groups themselves)."""
        if grid is not None:
            self.gauge.add(grid, gidx, t0, t1, on, amount, self._gauge_period)

    def _controlled_queue(self, s, cores, t, mine, ep, post, place, extra, cap: int,
                          timeout: float, conn: int, ram, gm, record: bool, grid=None,
                          tape=None):
        """Server ``s``'s single-burst core queue under its overload
        controls: with a connection cap the socket scan in arrival order,
        else the controlled scan (a ready-queue cap, a dequeue deadline) in
        enqueue order (a cache extra before the burst shifts the enqueue;
        io-only endpoints skip the queue).  Returns the gauge shapes
        (enqueue, wait, pre-IO, valid), (S, n, 1) each (a shed request
        waits 0, an abandon its full wait), the departure and the trailing
        IO's start (:meth:`_departure`), the rejected
        lanes and the instant each fails at (refused: the arrival, shed: the
        enqueue, abandoned: the end of its wait).  Under a connection cap a
        shed or abandoned request holds its RAM from the arrival to that
        instant (added to ``gm`` and the grid here).  On ``tape``: a
        refusal, the arrival, a shed at the enqueue, a wait and its run,
        an abandon at the deadline."""
        plan, tab = self.plan, self._tables
        horizon = f32(plan.horizon)
        nb = tab["n_bursts"][s][ep]
        is_b = nb >= 1
        pre0 = torch.where(is_b, tab["burst_pre_io"][s][ep][..., 0], 0.0)
        dur0 = torch.where(is_b, tab["burst_dur"][s][ep][..., 0], 0.0)
        if conn >= 0:
            arr = torch.where(mine, t, INF)
            rank = time_rank(arr, mine)
            w_s, f_s = self.scan.socket(
                to_sorted(arr, rank, INF),
                to_sorted(torch.where(mine, t + pre0, INF), rank, INF),
                to_sorted(torch.where(mine, dur0, 0.0), rank, 0.0),
                to_sorted(torch.where(mine, post, 0.0), rank, 0.0),
                to_sorted(mine & is_b, rank, False), to_sorted(mine, rank, False),
                cores, conn, cap, timeout,
            )
            flags = torch.where(mine, f_s.gather(1, rank), 0)
            refused = (flags & FLAG_REFUSED) != 0
            shed = (flags & FLAG_SHED) != 0
            part = mine & is_b & ~refused
            wait = torch.where(part & ~shed, w_s.gather(1, rank), 0.0)
        else:
            if place is not None:
                # a cache miss before the burst shifts the enqueue time
                pre_extra = torch.zeros_like(pre0)
                for c in range(place.shape[2]):
                    pre_extra = pre_extra + torch.where(place[..., c] == 0, extra[..., c], 0.0)
                pre0 = pre0 + torch.where(is_b, pre_extra, 0.0)
            part = mine & is_b
            enq = torch.where(part, t + pre0, INF)
            rank = time_rank(enq, part)
            w_s, f_s = self.scan.controlled(
                to_sorted(enq, rank, INF), to_sorted(torch.where(part, dur0, 0.0), rank, 0.0),
                to_sorted(part, rank, False), cores, cap, timeout,
            )
            flags = torch.where(part, f_s.gather(1, rank), 0)
            refused = torch.zeros_like(mine)
            shed = (flags & FLAG_SHED) != 0
            wait = torch.where(part, w_s.gather(1, rank), 0.0)
        del rank, w_s, f_s
        abandoned = (flags & FLAG_ABANDONED) != 0
        enq0 = t + pre0
        fail_at = torch.where(refused, t, torch.where(shed, enq0, enq0 + wait))
        if tape is not None:
            if conn >= 0:
                tape.emit(FR_REJECT, s, t, t, refused)
                tape.emit(FR_ARRIVE_SRV, s, t, t, mine & ~refused)
            qwait = part & ~shed & (wait > 0)
            ran = enq0 + wait
            tape.emit(FR_REJECT, s, enq0, enq0, shed)
            tape.emit(FR_WAIT_CPU, s, enq0, enq0, qwait)
            tape.emit(FR_RUN, s, ran, ran, qwait)
            tape.emit(FR_REJECT, s, ran, ran, abandoned)
            del qwait, ran
        if conn >= 0 and record:
            # a shed or abandoned request's RAM, held until it leaves
            rej_end = torch.where(shed, enq0, enq0 + wait)
            rej_ram = (shed | abandoned) & (ram > 0)
            gm[:, plan.gauge_ram(s)] += _span(t, rej_end, rej_ram, horizon, amount=ram)
            if grid is not None:
                self._gauge_intervals(grid, plan.gauge_ram(s), t, rej_end, ram, rej_ram)
            del rej_end, rej_ram
        dep = self._departure(t + pre0 + wait, dur0, post, s, place)
        return (enq0[..., None], torch.where(shed, 0.0, wait)[..., None], pre0[..., None],
                part[..., None], dep, refused | shed | abandoned, fail_at)

    def _departure(self, x, dur0, post, s: int, place) -> tuple:
        """(departure, start of the trailing IO) of server ``s``'s lanes from
        ``x``, what comes before the last burst's service ``dur0`` (None:
        none) and the trailing IO ``post``: ``(x + dur0) + post`` and the
        departure less ``post``.  Where the plan's endpoint tables hold one
        entry (one server with one endpoint) and no cache extra joins the
        trailing IO, their lookups are scalar constants of the jitted
        reference's program, and XLA's simplifier folds them: ``(x + c1) +
        c2`` into ``x + (c1 + c2)`` and ``(x + c) - post`` into ``x + (c -
        post)`` (``x`` where that is 0); so does this, the constants' sums
        rounded to float32.  Larger tables it does not fold so (held against
        the jitted reference on two-server plans, uniform or not)."""
        plan = self.plan
        if plan.n_bursts.shape != (1, 1) or place is not None:
            dep = x + post if dur0 is None else x + dur0 + post
            return dep, dep - post
        dur = (np.float32(plan.burst_dur[s, 0, 0])
               if dur0 is not None and plan.n_bursts[s, 0] >= 1 else np.float32(0))
        post_c = np.float32(plan.endpoint_post_io[s, 0])
        tail = dur + post_c
        rest = float(tail - post_c)
        return x + float(tail), (x if rest == 0.0 else x + rest)

    def _server_down(self, ov: dict, s: int, t: torch.Tensor) -> torch.Tensor:
        """(S, n) bool: server ``s`` sits in a dark window at each lane's
        time ``t`` (the row ``max(searchsorted(times, t, right) - 1, 0)``
        of the scenario's outage table)."""
        idx = fault_rows(ov["fs_t"], t)
        down = ov["fs_down"]
        col = down[:, s][idx] if down.ndim == 2 else down[:, :, s].gather(1, idx)
        return col == 1

    def _db_station(self, s, ep, mine, trail_start, trail_extra, dep, tape=None):
        """(departures, waits) of server ``s`` after its modelled DB pool:
        one FIFO station of K connections, entered ``db_pre`` (and any cache
        extra before the query) after the trailing IO starts, its merged
        stream ordered by that time; Lindley for K = 1, Kiefer-Wolfowitz
        for more.  The wait only delays the departure.  Without a pool the
        departures as given and None; on ``tape`` a wait and its run."""
        plan, tab = self.plan, self._tables
        pool_k = int(plan.server_db_pool[s])
        if pool_k <= 0 or not bool(np.any(plan.fp_db_dur[s] > 0)):
            return dep, None
        dur = torch.where(mine, tab["fp_db_dur"][s][ep], 0.0)
        use = mine & (dur > 0)
        pre = tab["fp_db_pre"][s][ep]
        if trail_extra is not None:
            pre = pre + trail_extra
        enq = torch.where(use, trail_start + pre, INF)
        rank = time_rank(enq, use)
        w_s = self.scan.waits(
            to_sorted(enq, rank, INF), to_sorted(dur, rank, 0.0), to_sorted(use, rank, False),
            pool_k,
        )
        wait = torch.where(use, w_s.gather(1, rank), 0.0)
        if tape is not None:
            dwait = use & (wait > 0)
            tape.emit(FR_WAIT_DB, s, enq, enq, dwait)
            tape.emit(FR_RUN, s, enq + wait, enq + wait, dwait)
        return dep + wait, wait

    def _core_queue(self, s, kb, cores, t, mine, ep, post, shared_rank, place=None,
                    extra=None):
        """The FIFO core queue of server ``s`` visited once a burst:
        (enqueue, wait, pre-IO, valid), (S, n, kb) each, and the lanes' busy
        time (S, n), their visits' pre-IO, waits and services summed.  A cache miss placed before burst k (``place``, ``extra``)
        lengthens its pre-IO.  One sweep is exact for single-burst
        endpoints; several bursts relax to the fixed point (2 kb + 2
        sweeps)."""
        tab = self._tables
        s_rows, n = t.shape
        nb = tab["n_bursts"][s][ep]
        ks = torch.arange(kb, device=t.device)
        validb = mine[..., None] & (ks < nb[..., None])
        dur = torch.where(validb, tab["burst_dur"][s][ep][..., :kb], 0.0)
        pre = torch.where(validb, tab["burst_pre_io"][s][ep][..., :kb], 0.0)
        if place is not None:
            pre_extra = torch.zeros_like(pre)
            for c in range(place.shape[2]):
                pre_extra = pre_extra + torch.where(place[..., c, None] == ks,
                                                    extra[..., c, None], 0.0)
            pre = pre + torch.where(validb, pre_extra, 0.0)
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
        return enq, wait, pre, validb, total

    # ------------------------------------------------------------------
    # batch
    # ------------------------------------------------------------------

    def _overrides(self, ov: ScenarioOverrides, s: int) -> dict:
        """The run's edge tables (S, NE), each stream's users and rate (with
        several generators the workload fields are (G,) or (S, G)), the
        fault tables where faults reach a server or an edge (shared or a
        row a scenario; the edge tables' times and values alike, as the hop
        kernel takes them) and the client timeout (S,)."""
        dev, ne = self.device, self.plan.n_edges
        ov = fill_overrides(ov, base_overrides(self.plan))

        def per_scenario(x):
            arr = _float_tensor(x, dev)
            return arr.expand(s).contiguous() if arr.ndim == 0 else arr

        um = np.asarray(ov.user_mean, np.float32)
        rr = np.asarray(ov.req_rate, np.float32)
        if len(self.gen_n) > 1:
            ums = [um[..., g] for g in range(len(self.gen_n))]
            rrs = [per_scenario(rr[..., g]) for g in range(len(self.gen_n))]
        else:
            ums, rrs = [um], [per_scenario(rr)]
        out = {
            "em": _edge_table(ov.edge_mean, s, ne, dev),
            "ev": _edge_table(ov.edge_var, s, ne, dev),
            "ed": _edge_table(ov.edge_dropout, s, ne, dev),
            "um": ums,
            "rr": rrs,
            "rt": per_scenario(ov.retry_timeout),
        }
        if self.srv_faulted.any():
            out["fs_t"] = _float_tensor(ov.fault_srv_times, dev)
            out["fs_down"] = torch.as_tensor(np.asarray(ov.fault_srv_down, np.int32),
                                             device=dev)
        if self.has_edge_faults:
            fe_t = _float_tensor(ov.fault_edge_times, dev)
            fe_lat = _float_tensor(ov.fault_edge_lat, dev)
            fe_drop = _float_tensor(ov.fault_edge_drop, dev)
            if fe_t.ndim == 2 or fe_lat.ndim == 3:
                m = fe_t.shape[-1]
                fe_t = fe_t.expand(s, m).contiguous()
                fe_lat = fe_lat.expand(s, m, ne).contiguous()
                fe_drop = fe_drop.expand(s, m, ne).contiguous()
            out.update(fe_t=fe_t, fe_lat=fe_lat, fe_drop=fe_drop)
        return out

    def _backoffs(self, keys: torch.Tensor) -> torch.Tensor | None:
        """(S, n - n1) backoff of each re-issue lane (blocks 1 .. A-1):
        ``min(cap, base * mult**(a-1))`` for block a, times ``1 + jitter (2 u
        - 1)`` with u the block's uniform at ``fold_in(key, 2048 + a)``."""
        plan, n1 = self.plan, self.gen_n[0]
        parts = []
        for a in range(1, self.attempts):
            d = f32(min(float(plan.retry_backoff_cap),
                        float(plan.retry_backoff_base) * float(plan.retry_backoff_mult)
                        ** float(a - 1)))
            if plan.retry_jitter > 0:
                u = self.draws.uniform(fold_in(keys, 2048 + a), n1)
                parts.append(d * (1.0 + f32(plan.retry_jitter) * (2.0 * u - 1.0)))
            else:
                parts.append(torch.full((keys.shape[0], n1), d, dtype=torch.float32,
                                        device=keys.device))
        return torch.cat(parts, dim=1) if parts else None

    def _attempts(self, keys, ov: dict, t1: torch.Tensor, v1: torch.Tensor, *, tape=None,
                  btape=None):
        """The retry branch of ``_run_one``: the journey run once per attempt
        over the A lane blocks (only the last pass records, and only it
        takes ``tape`` and ``btape``), each pass re-issuing into block a + 1
        the granted retries of block a at their want time plus the backoff.
        A deadline ``D = T + timeout`` fires where it comes no later than
        the completion and the failure and before the horizon; a failed or
        timed-out attempt wants a retry (within the attempt cap), and the
        budget, one token bucket over the wants in time order, grants it (a
        grant whose re-issue would land past the horizon spends its token
        all the same).  Returns the last pass's journey outputs, the lanes'
        issue times T, the successes and the (timed out, retries, denied,
        ended, failed, want time) lanes."""
        plan, n, n1 = self.plan, self.n, self.gen_n[0]
        s_rows = t1.shape[0]
        horizon = f32(plan.horizon)
        big_t = torch.full((s_rows, n), INF, dtype=torch.float32, device=t1.device)
        big_t[:, :n1] = torch.where(v1, t1, INF)
        boff = self._backoffs(keys)
        rt = ov["rt"][:, None]
        can_retry = (torch.arange(n, device=t1.device) // n1) < (self.attempts - 1)
        budget = float(plan.retry_budget_tokens)
        for p in range(self.attempts):
            last = p == self.attempts - 1
            issued = big_t < INF
            out = self._journey(keys, ov, [big_t], [issued], record=last,
                                tape=tape if last else None, btape=btape if last else None)
            finish, completed, fail_t = out[:3]
            c_time = torch.where(completed, finish, INF)
            deadline = big_t + rt
            timed = issued & (deadline <= torch.minimum(c_time, fail_t)) & (deadline < horizon)
            failed = issued & ~timed & (fail_t < INF)
            want_t = torch.where(timed, deadline, fail_t)
            want = (timed | failed) & can_retry
            if budget >= 0:
                wt = torch.where(want, want_t, INF)
                rank = time_rank(wt, want)
                acc = self.scan.bucket(to_sorted(wt, rank, INF), to_sorted(want, rank, False),
                                       float(plan.retry_budget_refill), budget)
                grant = want & acc.gather(1, rank)
                del wt, rank, acc
            else:
                grant = want
            if not last:
                tn = want_t[:, : n - n1] + boff
                big_t = torch.cat(
                    [big_t[:, :n1], torch.where(grant[:, : n - n1] & (tn < horizon), tn, INF)],
                    dim=1,
                )
        success = issued & ~timed & completed
        denied = want & ~grant
        ended = success | denied | ((timed | failed) & ~can_retry)
        return out, big_t, success, (timed, grant, denied, ended, failed, want_t)

    def _trace_lanes(self, t0: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(S, R) the traced rows' lanes: the first K spawned requests, in
        arrival order (the first K lanes of one stream; of several, by the
        stable time rank), or with a retry policy the first min(K, n1)
        logical requests of each attempt block, block-major."""
        k = int(self.trace.sample_requests)
        s_rows, n = t0.shape
        dev = t0.device
        if self.plan.has_retry:
            n1 = self.gen_n[0]
            k2 = min(k, n1)
            lanes = (torch.arange(self.attempts, device=dev)[:, None] * n1
                     + torch.arange(k2, device=dev)[None, :]).reshape(-1)
        elif len(self.gen_n) > 1:
            rank = time_rank(t0, valid)
            lane_of_rank = torch.zeros_like(rank).scatter_(
                1, rank, torch.arange(n, device=dev).expand(s_rows, n).contiguous())
            return lane_of_rank[:, : min(k, n)].contiguous()
        else:
            lanes = torch.arange(min(k, n), device=dev)
        return lanes.expand(s_rows, lanes.shape[0]).contiguous()

    def _retry_rings(self, tape: FlightTape, big_t, rt, retry_masks) -> tuple:
        """The rings of a retry plan: each attempt block's [spawn, the
        journey's candidates, a timeout, a retry or an abandon], a logical
        request's blocks one after another; a timed-out attempt's events
        processed at or after its deadline are orphaned (not recorded)."""
        timed, grant, _denied, _ended, failed, want_t = retry_masks
        n1 = self.gen_n[0]
        lanes = tape.lanes
        deadline = big_t + rt
        attempt = (torch.arange(self.n, device=big_t.device) // n1 + 1).to(torch.int32)
        attempt = attempt.expand_as(big_t)
        d_l, timed_l = deadline.gather(1, lanes), timed.gather(1, lanes)
        out = FlightTape(lanes, proc=True)
        out.emit(FR_SPAWN, 0, big_t, big_t, big_t < INF)
        for code, node, rec, proc, pred in tape.cands:
            out.cands.append((code, node, rec, proc, pred & ~(timed_l & (proc >= d_l))))
        out.emit(FR_TIMEOUT, attempt, deadline, deadline, timed)
        out.emit(FR_RETRY, attempt, want_t, want_t, grant)
        out.emit(FR_ABANDON, attempt, want_t, want_t, (timed | failed) & ~grant)
        k2 = min(int(self.trace.sample_requests), n1)
        return flight_rings(out.cands, int(self.trace.sample_requests),
                            int(self.trace.event_slots), blocks=(self.attempts, k2))

    def run_tensors(self, keys, overrides: ScenarioOverrides | None = None, *,
                    window_draws=None) -> dict:
        """:meth:`run_batch`'s outputs as tensors on the engine's device."""
        plan, dev, n = self.plan, self.device, self.n
        kt = _keys_tensor(keys, dev)
        s = kt.shape[0]
        ov = self._overrides(overrides if overrides is not None else base_overrides(plan), s)
        if window_draws is None:
            _lam, counts = self.window_draws(kt, ov["um"], ov["rr"])
        else:
            users, counts_in = window_draws
            if len(self.gen_n) == 1:
                users, counts_in = [users], [counts_in]
            counts = []
            for g, (u_g, c_g) in enumerate(zip(users, counts_in)):
                lam = torch.as_tensor(np.array(u_g), device=dev).to(torch.float32)
                lam = lam * ov["rr"][g][:, None]
                c_g = torch.as_tensor(np.array(c_g), device=dev).to(torch.int32)
                counts.append(torch.where(lam > 0, c_g, 0))
        ts, valids, overflow = self._stream_arrivals(fold_in(kt, 0), counts)
        t0 = ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)
        valid = valids[0] if len(valids) == 1 else torch.cat(valids, dim=1)
        zero = torch.zeros(s, dtype=torch.int64, device=dev)
        tape = None
        if self.trace is not None:
            tape = FlightTape(self._trace_lanes(t0, valid), proc=plan.has_retry)
        btape = BlameTape(plan.n_servers) if self.blame else None
        rings = None
        if not plan.has_retry:
            if tape is not None:
                gen = 0
                if len(self.gen_n) > 1:
                    gen = torch.cat([torch.full((s, w), g, dtype=torch.int32, device=dev)
                                     for g, w in enumerate(self.gen_n)], dim=1)
                tape.emit(FR_SPAWN, gen, t0, t0, valid)
            out = self._journey(kt, ov, ts, valids, tape=tape, btape=btape)
            finish, success = out[0], out[1]
            timed_out = retries = denied = zero
            att_hist = torch.zeros((s, 1), dtype=torch.int32, device=dev)
            if tape is not None:
                rings = flight_rings(tape.cands, int(self.trace.sample_requests),
                                     int(self.trace.event_slots))
        else:
            out, t0, success, masks = self._attempts(kt, ov, t0, valid, tape=tape, btape=btape)
            timed, grant, deny, ended = masks[:4]
            finish = out[0]
            timed_out, retries, denied = (m.sum(dim=1) for m in (timed, grant, deny))
            blk = torch.arange(n, device=dev) // self.gen_n[0]
            att_hist = torch.zeros((s, self.attempts + 1), dtype=torch.int64, device=dev)
            att_hist = att_hist.scatter_add_(
                1, torch.where(ended, blk, self.attempts), ended.to(torch.int64),
            )[:, : self.attempts].to(torch.int32)
            if tape is not None:
                rings = self._retry_rings(tape, t0, ov["rt"][:, None], masks)
            del timed, grant, deny, ended, masks
        gm, n_dropped, n_rej, n_dark, grid = out[3:]
        if grid is None:
            grid = torch.zeros((s, 1, 1), dtype=torch.float32, device=dev)
        del ts, valids, out, tape

        latency = torch.where(success, finish - t0, 0.0)
        bins = self.n_hist_bins
        lbin = latency_bin(latency, self.hist_lo, self.hist_scale, bins, log=log_xla).to(
            torch.int64)
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
        planes = self._plane_outputs(s, rings, btape, success, lbin, latency)
        del btape
        return {
            "hist": hist.to(torch.int32),
            "lat_count": count,
            "lat_sum": latency.sum(dim=1),
            "lat_sumsq": (latency * latency).sum(dim=1),
            "lat_min": torch.where(success, latency, INF).min(dim=1).values,
            "lat_max": torch.where(success, latency, 0.0).max(dim=1).values,
            "thr": thr.to(torch.int32),
            "gauge": grid,
            "clock": clock,
            "clock_n": count,
            "n_generated": valid.sum(dim=1).to(torch.int32),
            "n_dropped": n_dropped.to(torch.int32),
            "n_overflow": overflow,
            "gauge_means": gm / f32(plan.horizon),
            "n_rejected": n_rej.to(torch.int32),
            "n_dark_lost": n_dark.to(torch.int32),
            "n_timed_out": timed_out.to(torch.int32),
            "n_retries": retries.to(torch.int32),
            "n_budget_exhausted": denied.to(torch.int32),
            "att_hist": att_hist,
            **planes,
        }

    def _plane_outputs(self, s: int, rings, btape, success, lbin, latency) -> dict:
        """The planes' outputs: the rings (placeholders untraced) and the
        blame grid of every credit keyed by each successful lane's coarse
        bin, ``clip(lbin // stride, 0, nbb - 1)`` (the others' target is
        ``nbb``: dropped), its latency totals and, with collect_clocks, the
        per-request rows (placeholders without blame)."""
        dev = success.device
        if rings is None:
            rings = (torch.zeros((s, 1, 1), dtype=torch.int32, device=dev),
                     torch.zeros((s, 1, 1), dtype=torch.int32, device=dev),
                     torch.zeros((s, 1, 1), dtype=torch.float32, device=dev),
                     torch.zeros((s, 1), dtype=torch.int32, device=dev))
        bl_grid = torch.zeros((s, 1, 1), dtype=torch.float32, device=dev)
        bl_lat = torch.zeros((s, 1), dtype=torch.float32, device=dev)
        bl_rows = torch.zeros((s, 1, 1), dtype=torch.float32, device=dev)
        if btape is not None:
            nbb = self._bl_bins
            target = torch.where(success, torch.clamp(lbin // self._bl_stride, 0, nbb - 1),
                                 nbb).to(torch.int16)
            bl_grid, bl_lat = self.blame_grid.reduce(btape.credits, target, latency,
                                                     self._bl_cells, nbb)
            if self.collect_clocks:
                bl_rows = blame_store(btape.credits, success, self._bl_cells)
        return dict(zip(("fr_ev", "fr_node", "fr_t", "fr_n"), rings),
                    bl_grid=bl_grid, bl_lat=bl_lat, bl_store=bl_rows)

    def run_batch(self, keys, overrides: ScenarioOverrides | None = None, *,
                  window_draws=None, antithetic: bool = False) -> FastState:
        """Run S scenarios: ``keys`` (S, 2) are the port's int64 keys or the
        reference's uint32 key data; ``overrides`` fields are base-shaped or
        carry a leading scenario axis; ``window_draws`` = (users, counts),
        (S, NW) each, injects every window's user and arrival-count draws
        instead of drawing them (with several generators, two lists of
        each stream's (S, NW_g) draws)."""
        if antithetic:
            raise UnsupportedFeatureError("antithetic draws", "fast path option")
        out = self.run_tensors(keys, overrides, window_draws=window_draws)
        return FastState(**{k: v.cpu().numpy() for k, v in out.items()})

    def run_batch_scanned(self, *_args, **_kw):
        """The reference's scanned-program entry point: not in this slice."""
        raise UnsupportedFeatureError("run_batch_scanned", "fast path")
