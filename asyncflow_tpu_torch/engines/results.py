"""Host-side sweep results: the slice's subset of the reference's
``engines/results.py`` (``SweepResults``, ``hist_percentile``, the streamed
gauge series' band histograms) and of ``engines/jaxsim/engine.py:sweep_results``."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from asyncflow_tpu_torch.engines.torchsim.params import hist_edges
from asyncflow_tpu_torch.schemas.settings import SimulationSettings

#: fixed-bin resolution of the streamed gauge histograms behind
#: :attr:`SweepResults.gauge_bands`: linear bins over [0, cap) a gauge
#: column, so a band value is exact to cap / GAUGE_HIST_BINS
GAUGE_HIST_BINS = 128

#: the quantiles :attr:`SweepResults.gauge_bands` reports, in row order
GAUGE_BAND_QS = (50.0, 90.0, 99.0)


def gauge_hist_caps(plan, sel) -> np.ndarray:
    """Each selected gauge column's value cap for the band histograms: the
    request pool for connection and queue gauges, the server's RAM for
    ``ram_in_use`` (``sel`` holds columns of the ``[edges | ready | io |
    ram]`` layout)."""
    sel = np.asarray(sel, np.int64)
    caps = np.full(sel.shape, float(plan.pool_size), np.float64)
    ram0 = plan.n_edges + 2 * plan.n_servers
    is_ram = sel >= ram0
    if np.any(is_ram):
        caps[is_ram] = np.asarray(plan.server_ram, np.float64)[sel[is_ram] - ram0]
    return np.maximum(caps, 1e-9)


def build_gauge_hist(series: np.ndarray, caps: np.ndarray, *,
                     n_bins: int = GAUGE_HIST_BINS) -> np.ndarray:
    """An ``(S, T_g, k)`` gauge series reduced to ``(T_g, k, B)`` int64
    fixed-bin counts over the scenario axis: float64 ``floor(v / cap * B)``
    clipped to ``[0, B - 1]`` (the reference's rule; counted with one
    ``bincount`` over (tick, column, bin) cells in place of its
    ``np.add.at``, ~3x faster at the headline's 2048 x 599 x 2)."""
    series = np.asarray(series)
    _, n_t, k = series.shape
    caps = np.asarray(caps, np.float64).reshape(1, 1, k)
    idx = np.clip(np.floor(series.astype(np.float64) / caps * n_bins).astype(np.int64),
                  0, n_bins - 1)
    cell = (np.arange(n_t)[None, :, None] * k + np.arange(k)[None, None, :]) * n_bins
    counts = np.bincount((cell + idx).ravel(), minlength=n_t * k * n_bins)
    return counts.reshape(n_t, k, n_bins).astype(np.int64)


def gauge_series_of(grid, sel) -> np.ndarray:
    """(S, T_g, k) streamed series of the grid's columns ``sel``: the
    columns sliced before the cumulative sum over the rows, which runs on
    the grid's device, then the first and last rows (before the first tick,
    past the horizon) cut."""
    grid = torch.as_tensor(grid)
    cols = torch.as_tensor(np.asarray(sel, np.int64), device=grid.device)
    return torch.cumsum(grid.index_select(2, cols), dim=1)[:, 1:-1].cpu().numpy()


@dataclass
class SweepResults:
    """Stacked per-scenario outputs of a Monte-Carlo sweep."""

    settings: SimulationSettings | None
    #: (S,) completed-request counts per scenario
    completed: np.ndarray
    #: (S, B) latency histogram counts (log-spaced bins)
    latency_hist: np.ndarray
    #: (B + 1,) shared histogram bin edges (seconds)
    hist_edges: np.ndarray
    #: (S,) sums of latency and squared latency
    latency_sum: np.ndarray
    latency_sumsq: np.ndarray
    #: (S,) min / max latency
    latency_min: np.ndarray
    latency_max: np.ndarray
    #: (S, T) completions per 1-second window
    throughput: np.ndarray
    #: (S,) generated / dropped / overflow counters
    total_generated: np.ndarray
    total_dropped: np.ndarray
    overflow_dropped: np.ndarray
    #: (S,) requests rejected: refused by a rate limit or connection cap, shed
    #: from a full ready queue, abandoned past a dequeue deadline, or refused
    #: by an LB whose breakers all stay open
    total_rejected: np.ndarray
    #: (S,) bool: the DES kernel's iteration cap fired with work pending
    #: (None on the fast path, which has no cap)
    truncated: np.ndarray | None = None
    #: (S,) events each scenario simulated (DES kernel only; None on the
    #: fast path)
    events: np.ndarray | None = None
    #: (S, n_gauges) exact per-scenario time-averages of every gauge (fast
    #: path only; None otherwise).  Layout: [edges | ready | io | ram]
    gauge_means: np.ndarray | None = None
    #: (S,) LLM cost units of the completed requests, and their squares
    #: (for confidence intervals); None when the plan has no LLM segment
    llm_cost_sum: np.ndarray | None = None
    llm_cost_sumsq: np.ndarray | None = None
    #: (S,) client deadlines fired, re-issues granted, retry wants the
    #: budget denied, and (S, max_attempts) attempts used by each ended
    #: logical request; None without a retry policy
    total_timed_out: np.ndarray | None = None
    total_retries: np.ndarray | None = None
    retry_budget_exhausted: np.ndarray | None = None
    attempts_hist: np.ndarray | None = None
    #: the resilience scorecard, None on plans without faults or hazards:
    #: (S,) arrivals lost to dark windows; from a chaos campaign's sampled
    #: tables (host-side): (S, NS) dark seconds of each server inside the
    #: horizon, (S,) completions in 1-second windows that overlap a fault,
    #: (S,) in-horizon windows past the slot budget, and (S,) seconds from
    #: the last window's end until the ready queues drain (NaN: not
    #: measured, as without a streamed ready-queue series)
    dark_lost: np.ndarray | None = None
    unavailable_s: np.ndarray | None = None
    degraded_goodput: np.ndarray | None = None
    hazard_truncated: np.ndarray | None = None
    time_to_drain: np.ndarray | None = None
    #: (S, T_g, k) streamed gauge series on the coarse grid (fast-path
    #: sweeps with a gauge_series spec; None otherwise): column j is the
    #: j-th selected gauge, row i its value at t = (i + 1) x the period
    gauge_series: np.ndarray | None = None
    #: seconds between gauge_series rows (sample_period x stride)
    gauge_series_period: float | None = None
    #: (T_g, k, B) int64 band histograms over the scenarios of each coarse
    #: tick and selected column (``B = GAUGE_HIST_BINS`` linear bins over
    #: [0, cap)), built per chunk and summed over chunks
    gauge_hist: np.ndarray | None = None
    #: (k,) each column's histogram cap (:func:`gauge_hist_caps`)
    gauge_hist_cap: np.ndarray | None = None

    def percentile(self, q: float) -> np.ndarray:
        """Per-scenario latency percentile estimated from the histograms."""
        return hist_percentile(self.latency_hist, self.hist_edges, q)

    @property
    def gauge_bands(self) -> np.ndarray | None:
        """(3, T_g, k) bands over the scenarios of the streamed series, rows
        in :data:`GAUGE_BAND_QS` order, from the band histograms with
        :func:`hist_percentile`'s interpolation (exact to cap /
        GAUGE_HIST_BINS); None without a gauge_series spec."""
        if self.gauge_hist is None or self.gauge_hist_cap is None:
            return None
        n_t, k, bins = self.gauge_hist.shape
        out = np.zeros((len(GAUGE_BAND_QS), n_t, k))
        for j in range(k):
            edges = np.linspace(0.0, float(self.gauge_hist_cap[j]), bins + 1)
            for qi, q in enumerate(GAUGE_BAND_QS):
                out[qi, :, j] = hist_percentile(self.gauge_hist[:, j, :], edges, q)
        return out


#: fields that are not stacked over scenarios: shared by the chunks, or (the
#: band histograms) summed over them
_UNSTACKED = ("settings", "hist_edges", "gauge_series_period", "gauge_hist", "gauge_hist_cap")


def concat_results(parts: list[SweepResults]) -> SweepResults:
    """Chunks of one sweep, concatenated along the scenario axis in order;
    the gauge band histograms are summed."""
    first = parts[0]
    return dataclasses.replace(
        first,
        **{
            f.name: np.concatenate([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(first)
            if f.name not in _UNSTACKED and getattr(first, f.name) is not None
        },
        gauge_hist=(None if first.gauge_hist is None
                    else np.sum([p.gauge_hist for p in parts], axis=0)),
    )


def _optional(state, name: str, dtype=None) -> np.ndarray | None:
    value = getattr(state, name, None)
    return None if value is None else np.asarray(value, dtype)


def sweep_results(state, settings=None, *, has_llm: bool = False, has_retry: bool = False,
                  has_faults: bool = False, gauge_sel=None, series_period: float | None = None,
                  gauge_hist_cap: np.ndarray | None = None) -> SweepResults:
    """Host-side :class:`SweepResults` of a batched DES-kernel or fast-path
    state; the LLM cost moments are kept where the plan has LLM segments,
    the retry counters where it has a retry policy and the dark-lost count
    where it has faults or hazards.  With ``gauge_sel``, the fast path's
    streamed series of those columns of ``state.gauge`` (a stride grid,
    numpy or a tensor on its device; :func:`gauge_series_of`), its
    ``series_period`` and its band histograms over ``gauge_hist_cap``."""

    def when(on: bool, name: str):
        return _optional(state, name) if on else None

    series = hist = None
    if gauge_sel is not None:
        series = gauge_series_of(state.gauge, gauge_sel)
        hist = build_gauge_hist(series, gauge_hist_cap)
    return SweepResults(
        gauge_series=series,
        gauge_series_period=series_period if series is not None else None,
        gauge_hist=hist,
        gauge_hist_cap=gauge_hist_cap if series is not None else None,
        settings=settings,
        completed=np.asarray(state.lat_count),
        latency_hist=np.asarray(state.hist),
        hist_edges=hist_edges(np.asarray(state.hist).shape[-1]),
        latency_sum=np.asarray(state.lat_sum),
        latency_sumsq=np.asarray(state.lat_sumsq),
        latency_min=np.asarray(state.lat_min),
        latency_max=np.asarray(state.lat_max),
        throughput=np.asarray(state.thr),
        total_generated=np.asarray(state.n_generated),
        total_dropped=np.asarray(state.n_dropped),
        overflow_dropped=np.asarray(state.n_overflow),
        truncated=_optional(state, "truncated", bool),
        total_rejected=np.asarray(state.n_rejected),
        events=_optional(state, "n_events"),
        gauge_means=_optional(state, "gauge_means"),
        llm_cost_sum=np.asarray(state.llm_sum) if has_llm else None,
        llm_cost_sumsq=np.asarray(state.llm_sumsq) if has_llm else None,
        total_timed_out=when(has_retry, "n_timed_out"),
        total_retries=when(has_retry, "n_retries"),
        retry_budget_exhausted=when(has_retry, "n_budget_exhausted"),
        attempts_hist=when(has_retry, "att_hist"),
        dark_lost=when(has_faults, "n_dark_lost"),
    )


def hist_percentile(counts: np.ndarray, edges: np.ndarray, q: float) -> np.ndarray:
    """Latency percentile from log-binned histogram counts: linear
    interpolation inside the first bin whose CDF reaches ``q`` (the
    reference's single percentile definition).  ``counts`` is ``(B,)`` or
    ``(S, B)``; ``edges`` has ``B + 1`` entries."""
    counts = np.asarray(counts, np.float64)
    single = counts.ndim == 1
    counts = np.atleast_2d(counts)
    totals = counts.sum(axis=1, keepdims=True)
    cdf = np.cumsum(counts, axis=1) / np.maximum(totals, 1.0)
    idx = np.argmax(cdf >= q / 100.0, axis=1)
    lo = edges[idx]
    hi = edges[idx + 1]
    prev = np.take_along_axis(
        np.pad(cdf, ((0, 0), (1, 0)))[:, :-1], idx[:, None], axis=1,
    )[:, 0]
    cur = np.take_along_axis(cdf, idx[:, None], axis=1)[:, 0]
    frac = np.where(cur > prev, (q / 100.0 - prev) / (cur - prev), 0.0)
    out = lo + frac * (hi - lo)
    return out[0] if single else out
