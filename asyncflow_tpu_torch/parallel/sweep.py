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
tables.  :func:`make_overrides` builds the resilience sweep axes.
"""

from __future__ import annotations

import math
import time
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from asyncflow_tpu_torch.compiler import hazards
from asyncflow_tpu_torch.compiler.plan import RELAX_RHO_MAX, StaticPlan, compile_payload
from asyncflow_tpu_torch.engines.results import (
    SweepResults,
    concat_results,
    hist_percentile,
    sweep_results,
)
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine, fast_refusal
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.engines.torchsim.params import (
    ScenarioOverrides,
    base_overrides,
    fill_overrides,
)
from asyncflow_tpu_torch.errors import FastPathOverrideError, ProofHeadroomError
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

    @property
    def scenarios_per_second(self) -> float:
        return self.n_scenarios / max(self.wall_seconds, 1e-9)

    def aggregate_percentile(self, q: float) -> float:
        """Percentile of the pooled latency distribution across scenarios."""
        pooled = self.results.latency_hist.sum(axis=0)
        if pooled.sum() == 0:
            return float("nan")
        return float(hist_percentile(pooled, self.results.hist_edges, q))

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
    fault_shift: np.ndarray | None = None,
    retry_timeout: np.ndarray | None = None,
    hazard_scale: np.ndarray | None = None,
    mttr_scale: np.ndarray | None = None,
) -> ScenarioOverrides:
    """Per-scenario resilience overrides (the reference's ``make_overrides``
    axes of this slice), each (S,):

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
    rate raise over a proven non-binding RAM tier, a rate that takes a
    multi-burst server past the relaxation's envelope, or dropout raised on
    an LB edge whose breaker was lowered away at the base dropout."""
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
    if not tier1 and plan.relax_rho == 0.0:
        return
    scale = _override_rate_scale(plan, overrides)
    if plan.relax_rho > 0.0 and plan.relax_rho * scale > RELAX_RHO_MAX:
        msg = (
            f"overrides scale the workload to utilization {plan.relax_rho * scale:.2f} "
            f"on a multi-burst server, outside the relaxation's validity envelope "
            f"({RELAX_RHO_MAX}); use engine='kernel' for these scenarios"
        )
        raise FastPathOverrideError(msg)
    if tier1 and scale > 1.001:
        msg = (
            "overrides raise the workload above the base plan, which invalidates the "
            "fast path's RAM non-binding proof; use engine='kernel' or raise the base "
            "workload"
        )
        raise FastPathOverrideError(msg)


class SweepRunner:
    """Chunked Monte-Carlo sweep over one scenario family on one device."""

    def __init__(
        self,
        payload: SimulationPayload | Mapping,
        *,
        engine: str = "auto",
        device: torch.device | str | None = None,
    ) -> None:
        if engine not in ("auto", "fast", "kernel"):
            msg = f"engine must be 'auto', 'fast' or 'kernel', got {engine!r}"
            raise ValueError(msg)
        if isinstance(payload, Mapping):
            payload = SimulationPayload.from_dict(payload)
        self.payload = payload
        self.plan = compile_payload(payload)
        # each engine refuses what it does not model before any launch
        if engine == "fast" or (engine == "auto" and fast_refusal(self.plan) is None):
            self.engine = FastEngine(self.plan, device=device)
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
            state = self.engine.run_batch(keys, _slice_overrides(overrides, base, start, take))
            parts.append(
                sweep_results(state, self.payload.sim_settings, has_llm=plan.has_llm,
                              has_retry=plan.has_retry,
                              has_faults=plan.has_faults or plan.has_hazards),
            )
        merged = concat_results(parts)
        if tables is not None:
            _attach_scorecard(merged, tables, plan.horizon)
        wall = time.perf_counter() - t0
        return SweepReport(
            results=merged,
            n_scenarios=n_scenarios,
            wall_seconds=wall,
            plan=plan,
        )


def _hazard_axis(x):
    arr = np.asarray(x, np.float64)
    return arr if arr.ndim else float(arr)


def _attach_scorecard(merged: SweepResults, tables, horizon: float) -> None:
    """The resilience scorecard of a chaos campaign, reduced on the host
    from its sampled tables (the reference's ``_attach_scorecard``).  The
    time to drain needs a streamed ready-queue series, which the port does
    not collect yet: NaN, "not measured"."""
    merged.hazard_truncated = np.asarray(tables.truncated, np.int64)
    merged.unavailable_s = hazards.unavailable_seconds(tables.srv_times, tables.srv_down,
                                                       float(horizon))
    thr = np.asarray(merged.throughput, np.float64)
    mask = hazards.degraded_seconds_mask(tables, float(horizon), thr.shape[1])
    merged.degraded_goodput = (thr * mask).sum(axis=1)
    merged.time_to_drain = np.full(thr.shape[0], np.nan)
