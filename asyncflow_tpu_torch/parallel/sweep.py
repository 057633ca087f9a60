"""Chunked Monte-Carlo sweeps over one scenario family: the slice's subset of
the reference's ``parallel/sweep.py`` (``SweepRunner``, ``SweepReport``).

``engine="kernel"`` is the counterpart of the reference's ``"pallas"``: the
DES kernel, which models no fault window, hazard or retry policy (as the
reference's Pallas kernel does not) and refuses such plans by name.
``engine="fast"`` is the scan fast path (``FastEngine``), which refuses by
name a plan outside its slice (least connections and the overload
controls).  ``engine="auto"`` takes the fast
path, as the reference does, where the compiler proved the plan eligible
(``plan.fastpath_ok``) and the port's fast engine models it, and the DES
kernel otherwise; ``engine_kind`` says which.  The reference's event
engine is not ported yet.  Scenario ``i`` always gets key
``fold_in(PRNGKey(seed), i)``, so any chunking gives the same results.
A sweep runs in chunks sized per engine for one H100 (:data:`FAST_CHUNK_LANES`,
:data:`KERNEL_CHUNK`) unless ``chunk_size`` says otherwise.

Overrides that raise the workload rate past ``plan.proof_rate_headroom``
are refused with :class:`ProofHeadroomError` (the reference's
``_guard_db_headroom``): the compiler lowered away an overload control
that it proved unreachable at the base rate, and the proof does not cover
the overridden one.  On the fast path, overrides that leave its own
compile-time proofs are refused with :class:`FastPathOverrideError` (the
reference's ``_guard_overrides_against_plan``), as are resilience overrides
the plan cannot honour (``_guard_resilience_overrides``).

A chaos campaign's fault tables are sampled once a run, for the whole
block of scenarios, before it is cut into chunks (each chunk slices them),
so no chunk size changes a window; the run's results then carry the
resilience scorecard (``SweepResults.unavailable_s``, ``degraded_goodput``,
``hazard_truncated``, ``time_to_drain``), reduced on the host from those
tables (the time to drain from a streamed ready-queue series).
:func:`make_overrides` builds the edge, workload and resilience sweep axes.

``SweepRunner(gauge_series=(metric, component_ids, resample_s))`` streams
each scenario's series of one gauge for the named components on a grid of
``resample_s`` seconds (the fast path's gauge grid, coarsened on the
device); the report reads them back with :meth:`SweepReport.gauge_series`,
bands over the scenarios with :meth:`SweepReport.gauge_series_band` and
:meth:`SweepReport.gauge_bands`, and confidence intervals with
:meth:`SweepReport.metric_ci`, :meth:`SweepReport.per_scenario_percentile_mean_ci`
and :meth:`SweepReport.pooled_percentile_ci`.
"""

from __future__ import annotations

import math
import time
import warnings
from collections.abc import Mapping
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np
import torch

from asyncflow_tpu_torch.analysis.estimators import IntervalEstimate, pooled_quantile_ci
from asyncflow_tpu_torch.compiler import hazards
from asyncflow_tpu_torch.compiler.plan import RELAX_RHO_MAX, StaticPlan, compile_payload
from asyncflow_tpu_torch.config.constants import SampledMetricName
from asyncflow_tpu_torch.engines.results import (
    SweepResults,
    concat_results,
    gauge_hist_caps,
    hist_percentile,
    sweep_results,
)
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine, FastState, fast_refusal
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.engines.torchsim.params import (
    ScenarioOverrides,
    base_overrides,
    fill_overrides,
)
from asyncflow_tpu_torch.errors import (
    FastPathOverrideError,
    ProofHeadroomError,
    UnsupportedFeatureError,
)
from asyncflow_tpu_torch.schemas.payload import SimulationPayload

#: the fast path's lanes a chunk (scenarios x lanes a scenario, a
#: scenario's lanes summed over its generator streams): the headline's
#: 2048 x 87,840, whose sweep peaked at 27.17 GB of the card's 80 GB; its
#: device memory grows with the lanes
FAST_CHUNK_LANES = 2048 * 87_840
#: the DES kernel's scenarios a chunk: its time a scenario is flat from
#: about 528 scenarios up (the card is full and issue-bound), and every DES
#: path was measured at 2048; its state is a few kB a scenario
KERNEL_CHUNK = 2048


@dataclass
class SweepReport:
    """Host-side sweep summary with pooled statistics."""

    results: SweepResults
    n_scenarios: int
    wall_seconds: float
    plan: StaticPlan | None = None
    #: component ids of the gauge_series columns (the sweep's spec)
    gauge_series_ids: list[str] | None = None

    def mean_gauge(self, metric: str, component_id: str) -> np.ndarray:
        """(S,) each scenario's time-average of one gauge (fast-path sweeps):
        ``metric`` a :class:`SampledMetricName` value, ``component_id`` an
        edge id (edge concurrency) or a server id (ready, io, ram)."""
        if self.results.gauge_means is None or self.plan is None:
            msg = "per-scenario gauge means are only recorded by the fast path"
            raise ValueError(msg)
        return self.results.gauge_means[:, _gauge_index(self.plan, metric, component_id)]

    def gauge_series(self, component_id: str) -> tuple[np.ndarray, np.ndarray]:
        """(times, (S, T) series) of one component's streamed gauge (a sweep
        run with a ``gauge_series`` spec naming it; the metric is the
        spec's).  ``times`` are the coarse ticks, seconds."""
        if self.results.gauge_series is None or self.gauge_series_ids is None:
            msg = (
                "no streaming gauge series were collected: construct "
                "SweepRunner(..., gauge_series=(metric, component_ids, resample_s))"
            )
            raise ValueError(msg)
        if component_id not in self.gauge_series_ids:
            msg = (f"{component_id!r} is not in this sweep's gauge_series spec "
                   f"{self.gauge_series_ids}")
            raise ValueError(msg)
        col = self.gauge_series_ids.index(component_id)
        period = self.results.gauge_series_period
        n = self.results.gauge_series.shape[1]
        times = (np.arange(1, n + 1) * period).astype(np.float64)
        return times, self.results.gauge_series[:, :, col]

    def gauge_series_band(
        self, component_id: str, lo_q: float = 10.0, hi_q: float = 90.0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(times, lo, median, hi): at every coarse tick, the ``lo_q``, 50th
        and ``hi_q`` percentiles of a streamed gauge over the scenarios."""
        times, series = self.gauge_series(component_id)
        lo, med, hi = np.percentile(series, [lo_q, 50.0, hi_q], axis=0)
        return times, lo, med, hi

    def gauge_bands(self, component_id: str) -> tuple[np.ndarray, np.ndarray]:
        """(times, (3, T) bands): p50 / p90 / p99 over the scenarios at
        every coarse tick from the band histograms the chunks sum
        (:attr:`SweepResults.gauge_bands`, rows in ``GAUGE_BAND_QS``
        order)."""
        times, _ = self.gauge_series(component_id)
        bands = self.results.gauge_bands
        if bands is None:
            msg = "this sweep carries no gauge-band histograms"
            raise ValueError(msg)
        col = self.gauge_series_ids.index(component_id)
        return times, bands[:, :, col]

    @property
    def scenarios_per_second(self) -> float:
        return self.n_scenarios / max(self.wall_seconds, 1e-9)

    def aggregate_percentile(self, q: float) -> float:
        """Percentile of the pooled latency distribution across scenarios."""
        pooled = self.results.latency_hist.sum(axis=0)
        if pooled.sum() == 0:
            return float("nan")
        return float(hist_percentile(pooled, self.results.hist_edges, q))

    def per_scenario_percentile_mean_ci(
        self, q: float, level: float = 0.95,
    ) -> tuple[float, float, float]:
        """(point, lo, hi): the mean over scenarios of each scenario's
        latency percentile ``q``, with a ``level`` normal-approximation
        interval (the scenarios are i.i.d. replications).  An interval on
        the average scenario's percentile, not on the pooled quantile
        (:meth:`pooled_percentile_ci`)."""
        per = self.results.percentile(q)
        return _mean_ci(per[np.isfinite(per)], level)

    def percentile_ci(self, q: float, level: float = 0.95) -> tuple[float, float, float]:
        """Deprecated alias of :meth:`per_scenario_percentile_mean_ci`."""
        warnings.warn(
            "SweepReport.percentile_ci is a CI on the MEAN of per-scenario "
            "percentiles, not on the pooled quantile; it was renamed "
            "per_scenario_percentile_mean_ci.  For an interval on the "
            "pooled p-quantile use pooled_percentile_ci.",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.per_scenario_percentile_mean_ci(q, level)

    def pooled_percentile_ci(self, q: float, level: float = 0.95) -> IntervalEstimate:
        """Order-statistic (binomial) interval on the percentile ``q`` of the
        pooled request population across every scenario."""
        return pooled_quantile_ci(self.results.latency_hist, self.results.hist_edges, q,
                                  level)

    def metric_ci(self, values: np.ndarray, level: float = 0.95) -> tuple[float, float, float]:
        """(point, lo, hi) interval on the mean of any per-scenario metric
        (``results.completed``, ``mean_gauge(...)``)."""
        values = np.asarray(values, np.float64)
        return _mean_ci(values[np.isfinite(values)], level)

    def summary(self) -> dict:
        """The reference summary's keys that this slice has."""
        res = self.results
        completed = res.completed.sum()
        generated = int(res.total_generated.sum())

        def total(x) -> int:
            return int(x.sum()) if x is not None else 0

        return {
            "n_scenarios": self.n_scenarios,
            "scenarios_per_second": self.scenarios_per_second,
            "completed_total": int(completed),
            "dropped_total": int(res.total_dropped.sum()),
            "overflow_total": int(res.overflow_dropped.sum()),
            "rejected_total": int(res.total_rejected.sum()),
            "truncated_total": int(res.truncated.sum()) if res.truncated is not None else 0,
            "timed_out_total": total(res.total_timed_out),
            "retries_total": total(res.total_retries),
            "retry_budget_exhausted_total": total(res.retry_budget_exhausted),
            # completions over offered issues: spawns and re-issues
            "goodput_fraction": float(
                completed / max(generated + total(res.total_retries), 1),
            ),
            "latency_mean_s": float(res.latency_sum.sum() / max(completed, 1)),
            "llm_cost_total": (
                float(res.llm_cost_sum.sum()) if res.llm_cost_sum is not None else None
            ),
            "llm_cost_mean_per_request": (
                float(res.llm_cost_sum.sum() / max(completed, 1))
                if res.llm_cost_sum is not None
                else None
            ),
            "latency_p50_s": self.aggregate_percentile(50),
            "latency_p95_s": self.aggregate_percentile(95),
            "latency_p99_s": self.aggregate_percentile(99),
            # the resilience scorecard, on plans with faults or hazards only
            **self._scorecard_fields(res),
        }

    @staticmethod
    def _scorecard_fields(res: SweepResults) -> dict:
        """The resilience scorecard's summary keys; none on plain sweeps."""
        if res.dark_lost is None:
            return {}
        completed = int(res.completed.sum())
        dark = int(res.dark_lost.sum())
        out: dict = {
            "dark_lost_total": dark,
            # completions over completions and arrivals lost to dark windows
            "availability_fraction": float(completed / max(completed + dark, 1)),
        }
        if res.unavailable_s is not None:
            out["unavailable_s_total"] = float(res.unavailable_s.sum())
        if res.degraded_goodput is not None:
            out["degraded_goodput_total"] = float(res.degraded_goodput.sum())
        if res.hazard_truncated is not None:
            out["hazard_truncated_total"] = int(res.hazard_truncated.sum())
        if res.time_to_drain is not None:
            ttd = np.asarray(res.time_to_drain, np.float64)
            finite = ttd[np.isfinite(ttd)]
            out["time_to_drain_mean_s"] = float(finite.mean()) if finite.size else None
        return out


def _slice_overrides(
    ov: ScenarioOverrides | None, base: ScenarioOverrides, start: int, take: int,
) -> ScenarioOverrides | None:
    """Rows ``start .. start+take`` of the override fields that carry a
    scenario axis (more dimensions than the base plan's value); the others
    pass through."""
    if ov is None:
        return None
    fields = []
    for value, b in zip(ov, base):
        arr = np.asarray(value)
        fields.append(arr[start : start + take] if arr.ndim > np.ndim(b) else value)
    return ScenarioOverrides(*fields)


def make_overrides(
    plan: StaticPlan,
    n_scenarios: int,
    *,
    edge_mean_scale: np.ndarray | None = None,
    edge_var_scale: np.ndarray | None = None,
    dropout_scale: np.ndarray | None = None,
    user_mean: np.ndarray | None = None,
    req_per_minute: np.ndarray | None = None,
    fault_shift: np.ndarray | None = None,
    retry_timeout: np.ndarray | None = None,
    hazard_scale: np.ndarray | None = None,
    mttr_scale: np.ndarray | None = None,
) -> ScenarioOverrides:
    """Per-scenario overrides (the reference's ``make_overrides`` axes of
    this slice).

    - ``edge_mean_scale``, ``edge_var_scale``, ``dropout_scale``: (S,) or
      (S, NE) factors on the plan's edge means, variances and dropouts (the
      dropout clipped to [0, 1]);
    - ``user_mean``: (S,) mean active users, ``req_per_minute``: (S,)
      requests per user a minute; on a plan of G generators both are (S, G),
      a value a scenario and stream;

    and the resilience axes, each (S,):

    - ``fault_shift``: seconds added to every fault-window breakpoint (the
      windows' timing; their shapes stay the plan's); shifted times clip
      at 0 and the leading identity row stays at t = 0;
    - ``retry_timeout``: the client's request timeout;
    - ``hazard_scale``: divides every failure domain's MTBF mean (more
      chaos); ``mttr_scale``: multiplies its MTTR mean (slower repair).
      Both reuse the campaign's uniforms, so scale sweeps are paired.

    Each needs the base plan to model what it moves (a fault timeline, a
    retry policy, a hazard model)."""
    base = base_overrides(plan)
    for name, arr in (("hazard_scale", hazard_scale), ("mttr_scale", mttr_scale)):
        if arr is not None and not plan.has_hazards:
            msg = (f"{name} overrides need a hazard_model in the payload: the sampled "
                   "fault campaign they rescale must exist")
            raise ValueError(msg)
    if fault_shift is not None and not plan.has_faults:
        msg = ("fault_shift overrides need a fault_timeline in the payload: the compiler "
               "lowers the window shapes; overrides only move their timings")
        raise ValueError(msg)
    if retry_timeout is not None and not plan.has_retry:
        msg = ("retry_timeout overrides need a retry_policy in the payload: the retry "
               "machinery runs only where the base plan models it")
        raise ValueError(msg)
    g = plan.n_generators
    if g > 1:
        for name, arr in (("user_mean", user_mean), ("req_per_minute", req_per_minute)):
            if arr is not None and np.asarray(arr).shape != (n_scenarios, g):
                msg = (f"{name} on a {g}-generator plan must have shape ({n_scenarios}, {g}), "
                       f"got {np.asarray(arr).shape}")
                raise ValueError(msg)

    def edges(scale, base_arr: np.ndarray) -> np.ndarray:
        if scale is None:
            return base_arr
        scale = np.asarray(scale, np.float32)
        if scale.ndim == 1:
            scale = scale[:, None]
        if scale.shape[0] != n_scenarios:
            msg = f"scale must have leading axis {n_scenarios}"
            raise ValueError(msg)
        return base_arr[None, :] * scale

    def axis(arr, name: str) -> np.ndarray:
        out = np.asarray(arr, np.float32)
        if out.shape != (n_scenarios,):
            msg = f"{name} must have shape ({n_scenarios},), got {out.shape}"
            raise ValueError(msg)
        return out

    def shifted(times: np.ndarray) -> np.ndarray:
        shift = axis(fault_shift, "fault_shift")
        out = np.maximum(times[None, :] + shift[:, None], np.float32(0.0))
        # the leading row is the state before any window: it stays at t = 0
        out[:, 0] = 0.0
        return out

    return base._replace(
        edge_mean=edges(edge_mean_scale, base.edge_mean),
        edge_var=edges(edge_var_scale, base.edge_var),
        edge_dropout=np.clip(edges(dropout_scale, base.edge_dropout), 0.0, 1.0),
        user_mean=base.user_mean if user_mean is None else np.asarray(user_mean, np.float32),
        req_rate=(base.req_rate if req_per_minute is None
                  else np.asarray(req_per_minute, np.float32) / np.float32(60.0)),
        fault_srv_times=(base.fault_srv_times if fault_shift is None
                         else shifted(base.fault_srv_times)),
        fault_edge_times=(base.fault_edge_times if fault_shift is None
                          else shifted(base.fault_edge_times)),
        retry_timeout=(base.retry_timeout if retry_timeout is None
                       else axis(retry_timeout, "retry_timeout")),
        hazard_scale=(base.hazard_scale if hazard_scale is None
                      else axis(hazard_scale, "hazard_scale")),
        mttr_scale=base.mttr_scale if mttr_scale is None else axis(mttr_scale, "mttr_scale"),
    )


_FAULT_TABLES = ("fault_srv_times", "fault_edge_times", "fault_srv_down", "fault_edge_lat",
                 "fault_edge_drop")


def _differs(value, base) -> bool:
    arr = np.asarray(value)
    return arr.shape != np.shape(base) or not np.allclose(arr, base)


def _guard_resilience_overrides(plan: StaticPlan, overrides: ScenarioOverrides | None) -> None:
    """Refuse resilience overrides the plan cannot honour: the engines run
    the fault and retry machinery only where the base plan models it, and
    a chaos campaign's tables are sampled, so an override of them would be
    overwritten (the reference's ``_guard_resilience_overrides``)."""
    if overrides is None:
        return
    if not plan.has_retry and overrides.retry_timeout is not None:
        rt = np.asarray(overrides.retry_timeout)
        if rt.ndim > 0 or not np.isclose(float(rt), float(plan.retry_timeout)):
            msg = ("retry_timeout overrides need a retry_policy in the payload: the retry "
                   "machinery runs only where the base plan models it")
            raise FastPathOverrideError(msg)
    for name in _FAULT_TABLES:
        value = getattr(overrides, name)
        if value is None or not _differs(value, getattr(plan, name)):
            continue
        if plan.has_hazards:
            msg = (f"{name} overrides conflict with the payload's hazard_model: the chaos "
                   "campaign samples these tables per scenario and would overwrite the "
                   "override; use the hazard_scale / mttr_scale axes to reshape it")
            raise FastPathOverrideError(msg)
        if not plan.has_faults:
            msg = (f"{name} overrides need a fault_timeline or a hazard_model in the "
                   "payload: the window machinery runs only where the base plan models it")
            raise FastPathOverrideError(msg)
    if not plan.has_hazards:
        for name in ("hazard_scale", "mttr_scale"):
            value = getattr(overrides, name)
            if value is not None and not np.allclose(np.asarray(value), 1.0):
                msg = (f"{name} overrides need a hazard_model in the payload: the sampled "
                       "fault campaign they rescale must exist")
                raise FastPathOverrideError(msg)


def _override_rate_scale(plan: StaticPlan, overrides: ScenarioOverrides) -> float:
    """The largest workload-rate scale the overrides apply to the base plan:
    max users x max requests per user, over the base rate.

    With several generators the ratio is per stream (the largest over
    scenarios and streams of users x rate over the stream's base): the
    proofs are per server, and each stream feeds its own entry chain, so
    shifting load between streams at a constant total can still push one
    server past its proof.  A stream that is off in the base plan and on
    in an override scales without bound."""
    base = base_overrides(plan)
    if plan.n_generators > 1:
        base_g = (np.asarray(base.user_mean, np.float64)
                  * np.asarray(base.req_rate, np.float64))
        um, rr = np.broadcast_arrays(
            np.asarray(overrides.user_mean, np.float64),
            np.asarray(overrides.req_rate, np.float64),
        )
        rates = um * rr
        ratios = np.where(
            base_g > 0,
            rates / np.maximum(base_g, 1e-300),
            np.where(rates > 0, np.inf, 1.0),
        )
        return float(np.max(ratios))
    base_rate = float(base.user_mean) * float(base.req_rate)
    if base_rate <= 0:
        return 1.0
    max_rate = float(np.max(overrides.user_mean)) * float(np.max(overrides.req_rate))
    return max_rate / base_rate


def _guard_rate_headroom(plan: StaticPlan, overrides: ScenarioOverrides | None) -> None:
    """Refuse overrides that scale the workload past the headroom of a
    lowered-away non-binding proof (``_guard_db_headroom``)."""
    if overrides is None or math.isinf(plan.proof_rate_headroom):
        return
    scale = _override_rate_scale(plan, overrides)
    if scale > plan.proof_rate_headroom * 1.001:
        msg = (
            f"overrides scale the workload {scale:.2f}x, past the "
            f"{plan.proof_rate_headroom:.2f}x headroom of a non-binding proof (an "
            "overload control was lowered away at the base rate and could bind at "
            "this one); raise the base workload so the compiler models it"
        )
        raise ProofHeadroomError(msg)


def _guard_fast_overrides(plan: StaticPlan, overrides: ScenarioOverrides | None) -> None:
    """Refuse overrides that leave the fast path's compile-time proofs: a
    rate raise over a proven non-binding RAM tier or under least
    connections (its in-flight ring was sized at the base rate), a mean
    raised on one of least connections' LB edges (the ring was sized from
    each LB edge's delay), a rate that takes a multi-burst server past the
    relaxation's envelope, or dropout raised on an LB edge whose breaker
    was lowered away at the base dropout (the reference's
    ``_guard_overrides_against_plan``)."""
    if overrides is None:
        return
    if plan.breaker_lowered:
        ov_drop = np.asarray(overrides.edge_dropout)
        for e in plan.lb_edge_index.tolist():
            col = ov_drop[..., e] if ov_drop.ndim else ov_drop
            if float(np.max(col)) > float(plan.edge_dropout[e]) + 1e-12:
                msg = (
                    "overrides raise dropout on a load-balancer edge, but the "
                    "configured circuit breaker was lowered away as trip-proof at the "
                    "base dropout; use engine='kernel' or set the base dropout to the "
                    "swept maximum"
                )
                raise FastPathOverrideError(msg)
    tier1 = bool(np.any(plan.ram_slots == -1))
    if not tier1 and plan.lc_ring == 0 and plan.relax_rho == 0.0:
        return
    scale = _override_rate_scale(plan, overrides)
    rate_raised = scale > 1.001
    if plan.relax_rho > 0.0 and plan.relax_rho * scale > RELAX_RHO_MAX:
        msg = (
            f"overrides scale the workload to utilization {plan.relax_rho * scale:.2f} "
            f"on a multi-burst server, outside the relaxation's validity envelope "
            f"({RELAX_RHO_MAX}); use engine='kernel' for these scenarios"
        )
        raise FastPathOverrideError(msg)
    lb_mean_raised = False
    if plan.lc_ring > 0:
        # compared edge by edge: a large non-LB edge must not mask an LB
        # edge's raise
        ov_mean = np.asarray(overrides.edge_mean)
        for e in plan.lb_edge_index.tolist():
            col = ov_mean[..., e] if ov_mean.ndim else ov_mean
            if float(np.max(col)) > float(plan.edge_mean[e]) * 1.001:
                lb_mean_raised = True
                break
    if (rate_raised and (tier1 or plan.lc_ring > 0)) or lb_mean_raised:
        proof = ("RAM non-binding proof" if rate_raised and tier1
                 else "least-connections in-flight bound")
        msg = (
            f"overrides raise the workload above the base plan, which invalidates the "
            f"fast path's {proof}; use engine='kernel' or raise the base workload"
        )
        raise FastPathOverrideError(msg)


def _gauge_index(plan: StaticPlan, metric: str, component_id: str) -> int:
    """The gauge column of one (metric, component) pair."""

    def server_idx() -> int:
        if component_id not in plan.server_ids:
            msg = f"unknown server {component_id!r}; valid: {plan.server_ids}"
            raise ValueError(msg)
        return plan.server_ids.index(component_id)

    if metric == SampledMetricName.EDGE_CONCURRENT_CONNECTION:
        if component_id not in plan.edge_ids:
            msg = f"unknown edge {component_id!r}; valid: {plan.edge_ids}"
            raise ValueError(msg)
        return plan.gauge_edge(plan.edge_ids.index(component_id))
    if metric == SampledMetricName.READY_QUEUE_LEN:
        return plan.gauge_ready(server_idx())
    if metric == SampledMetricName.EVENT_LOOP_IO_SLEEP:
        return plan.gauge_io(server_idx())
    if metric == SampledMetricName.RAM_IN_USE:
        return plan.gauge_ram(server_idx())
    msg = f"unknown sampled metric {metric!r}"
    raise ValueError(msg)


def _resolve_gauge_series(plan: StaticPlan, spec: tuple) -> tuple[np.ndarray, int, list[str]]:
    """A ``(metric, component_ids, resample_s)`` spec checked against the
    plan: (the gauge columns, the grid's stride, the component ids)."""
    try:
        metric, component_ids, resample_s = spec
    except (TypeError, ValueError):
        msg = f"gauge_series must be a (metric, component_ids, resample_s) tuple, got {spec!r}"
        raise ValueError(msg) from None
    if isinstance(component_ids, str):
        component_ids = [component_ids]
    component_ids = list(component_ids)
    if not component_ids:
        # an empty selection would still collect the coarse grid of every
        # gauge, for nothing
        msg = "gauge_series component_ids must name at least one component"
        raise ValueError(msg)
    resample_s = float(resample_s)
    if resample_s < plan.sample_period:
        # a finer resample would collect the whole fine grid a scenario: the
        # memory that streaming exists to avoid
        msg = (f"resample_s={resample_s} is finer than the sample period "
               f"({plan.sample_period}s); streaming series need a coarser grid")
        raise ValueError(msg)
    stride = max(1, round(resample_s / plan.sample_period))
    if plan.n_samples // stride < 1:
        msg = f"resample_s={resample_s} leaves no grid rows inside the {plan.horizon}s horizon"
        raise ValueError(msg)
    sel = np.array([_gauge_index(plan, metric, cid) for cid in component_ids], dtype=np.int64)
    return sel, stride, component_ids


class SweepRunner:
    """Chunked Monte-Carlo sweep over one scenario family on one device."""

    def __init__(
        self,
        payload: SimulationPayload | Mapping,
        *,
        engine: str = "auto",
        device: torch.device | str | None = None,
        gauge_series: tuple | None = None,
    ) -> None:
        """``gauge_series``: ``(metric, component_ids, resample_s)`` streams
        each scenario's series of the gauge ``metric`` (a
        :class:`SampledMetricName` value) of the named components (edge ids
        for edge concurrency, server ids for ready, io and ram), resampled
        to ``resample_s`` seconds, on the fast path (the DES kernel collects
        no gauge grid and refuses it)."""
        if engine not in ("auto", "fast", "kernel"):
            msg = f"engine must be 'auto', 'fast' or 'kernel', got {engine!r}"
            raise ValueError(msg)
        if isinstance(payload, Mapping):
            payload = SimulationPayload.from_dict(payload)
        self.payload = payload
        self.plan = compile_payload(payload)
        self._gauge_sel: np.ndarray | None = None
        self._gauge_series_ids: list[str] | None = None
        self._gauge_series_metric: str | None = None
        stride = 0
        if gauge_series is not None:
            self._gauge_sel, stride, self._gauge_series_ids = _resolve_gauge_series(
                self.plan, gauge_series)
            # the scorecard's time to drain reads only a ready-queue series
            self._gauge_series_metric = str(gauge_series[0])
        fast = engine == "fast" or (engine == "auto" and fast_refusal(self.plan) is None)
        if self._gauge_sel is not None and not fast:
            # the series ride the fast path's gauge grid; the DES kernel has
            # none, and the reference's event engine, which would take a
            # plan the fast path declines, is not ported
            where = ("engine='kernel'" if engine == "kernel"
                     else "engine='auto' on a plan the fast path declines")
            raise UnsupportedFeatureError("streaming gauge series", where)
        # each engine refuses what it does not model before any launch
        if fast:
            self.engine = FastEngine(self.plan, device=device, gauge_series_stride=stride)
            self.engine_kind = "fast"
        else:
            self.engine = KernelEngine(self.plan, device=device)
            self.engine_kind = "kernel"

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def default_chunk(self) -> int:
        """Scenarios a chunk when ``run`` is given no ``chunk_size``."""
        if self.engine_kind == "fast":
            return max(1, FAST_CHUNK_LANES // self.engine.n)
        return KERNEL_CHUNK

    def run(
        self,
        n_scenarios: int,
        *,
        seed: int = 0,
        overrides: ScenarioOverrides | None = None,
        chunk_size: int | None = None,
        first_scenario: int = 0,
    ) -> SweepReport:
        """Run scenarios ``first_scenario .. first_scenario + n_scenarios``
        of the deterministic grid of ``seed``, ``chunk_size`` per launch
        (:attr:`default_chunk` by default).  ``overrides`` rows are local."""
        if n_scenarios < 1:
            msg = "n_scenarios must be at least 1"
            raise ValueError(msg)
        plan = self.plan
        base = base_overrides(plan)
        if overrides is not None:
            overrides = fill_overrides(overrides, base)
        _guard_rate_headroom(plan, overrides)
        if self.engine_kind == "fast":
            _guard_fast_overrides(plan, overrides)
        _guard_resilience_overrides(plan, overrides)
        chunk = chunk_size or self.default_chunk
        parts = []
        t0 = time.perf_counter()
        tables = None
        if plan.has_hazards:
            # the campaign's windows for the whole block, before chunking
            overrides = overrides if overrides is not None else base
            tables = hazards.hazard_fault_tables(
                plan, seed, first_scenario, n_scenarios,
                hazard_scale=_hazard_axis(overrides.hazard_scale),
                mttr_scale=_hazard_axis(overrides.mttr_scale),
            )
            overrides = overrides._replace(
                fault_srv_times=tables.srv_times, fault_srv_down=tables.srv_down,
                fault_edge_times=tables.edge_times, fault_edge_lat=tables.edge_lat,
                fault_edge_drop=tables.edge_drop,
            )
        for start in range(0, n_scenarios, chunk):
            take = min(chunk, n_scenarios - start)
            keys = scenario_keys(
                seed, take, first=first_scenario + start, device=self.device,
            )
            chunk_ov = _slice_overrides(overrides, base, start, take)
            series = {}
            if self._gauge_sel is None:
                state = self.engine.run_batch(keys, chunk_ov)
            else:
                # the grid stays on the device, where its selected columns'
                # cumulative sum runs
                out = self.engine.run_tensors(keys, chunk_ov)
                grid = out.pop("gauge")
                state = FastState(gauge=grid, **{k: v.cpu().numpy() for k, v in out.items()})
                series = {"gauge_sel": self._gauge_sel,
                          "series_period": plan.sample_period * self.engine.gauge_series_stride,
                          "gauge_hist_cap": gauge_hist_caps(plan, self._gauge_sel)}
            parts.append(
                sweep_results(state, self.payload.sim_settings, has_llm=plan.has_llm,
                              has_retry=plan.has_retry,
                              has_faults=plan.has_faults or plan.has_hazards, **series),
            )
            del state
        merged = concat_results(parts)
        if tables is not None:
            _attach_scorecard(merged, tables, plan.horizon, self._gauge_series_metric)
        wall = time.perf_counter() - t0
        return SweepReport(
            results=merged,
            n_scenarios=n_scenarios,
            wall_seconds=wall,
            plan=plan,
            gauge_series_ids=self._gauge_series_ids,
        )


def _hazard_axis(x):
    arr = np.asarray(x, np.float64)
    return arr if arr.ndim else float(arr)


def _attach_scorecard(merged: SweepResults, tables, horizon: float,
                      series_metric: str | None = None) -> None:
    """The resilience scorecard of a chaos campaign, reduced on the host
    from its sampled tables (the reference's ``_attach_scorecard``).  The
    time to drain reads the streamed series of ``series_metric``: only a
    ready-queue series defines it; without one it is NaN, "not
    measured"."""
    merged.hazard_truncated = np.asarray(tables.truncated, np.int64)
    merged.unavailable_s = hazards.unavailable_seconds(tables.srv_times, tables.srv_down,
                                                       float(horizon))
    thr = np.asarray(merged.throughput, np.float64)
    mask = hazards.degraded_seconds_mask(tables, float(horizon), thr.shape[1])
    merged.degraded_goodput = (thr * mask).sum(axis=1)
    drain = np.full(thr.shape[0], np.nan)
    if merged.gauge_series is not None and series_metric == SampledMetricName.READY_QUEUE_LEN:
        first_start, last_end = hazards.window_span(tables, float(horizon))
        drain = hazards.time_to_drain(np.asarray(merged.gauge_series, np.float64),
                                      float(merged.gauge_series_period), first_start,
                                      last_end)
    merged.time_to_drain = drain


def _mean_ci(values: np.ndarray, level: float) -> tuple[float, float, float]:
    """Normal-approximation interval on the mean of i.i.d. per-scenario
    values: (point, lo, hi), NaN bounds from fewer than two values."""
    if not 0.0 < level < 1.0:
        msg = f"confidence level must be in (0, 1), got {level}"
        raise ValueError(msg)
    if values.size == 0:
        return float("nan"), float("nan"), float("nan")
    point = float(values.mean())
    if values.size == 1:
        return point, float("nan"), float("nan")
    z = NormalDist().inv_cdf(0.5 + level / 2.0)
    half = z * float(values.std(ddof=1)) / float(np.sqrt(values.size))
    return point, point - half, point + half
