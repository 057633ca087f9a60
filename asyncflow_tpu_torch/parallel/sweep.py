"""Chunked Monte-Carlo sweeps over one scenario family: the slice's subset of
the reference's ``parallel/sweep.py`` (``SweepRunner``, ``SweepReport``).

``engine="kernel"`` is the counterpart of the reference's ``"pallas"``: the
DES kernel.  ``engine="auto"`` picks the kernel for every plan inside this
slice; the reference's fast path and event engine are not ported yet, so a
plan outside the slice raises :class:`UnsupportedFeatureError` instead of
being routed elsewhere.  Scenario ``i`` always gets key
``fold_in(PRNGKey(seed), i)``, so any chunking gives the same results.

Overrides that raise the workload rate past ``plan.proof_rate_headroom``
are refused with :class:`ProofHeadroomError` (the reference's
``_guard_db_headroom``): the compiler lowered away an overload control
that it proved unreachable at the base rate, and the proof does not cover
the overridden one.
"""

from __future__ import annotations

import math
import time
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from asyncflow_tpu_torch.compiler.plan import StaticPlan, compile_payload
from asyncflow_tpu_torch.engines.results import (
    SweepResults,
    concat_results,
    hist_percentile,
    sweep_results,
)
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.engines.torchsim.params import ScenarioOverrides, base_overrides
from asyncflow_tpu_torch.errors import ProofHeadroomError
from asyncflow_tpu_torch.schemas.payload import SimulationPayload


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
        return {
            "n_scenarios": self.n_scenarios,
            "scenarios_per_second": self.scenarios_per_second,
            "completed_total": int(completed),
            "dropped_total": int(res.total_dropped.sum()),
            "overflow_total": int(res.overflow_dropped.sum()),
            "rejected_total": int(res.total_rejected.sum()),
            "truncated_total": int(res.truncated.sum()),
            "goodput_fraction": float(completed / max(generated, 1)),
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
        }


def _slice_overrides(
    ov: ScenarioOverrides | None, start: int, take: int, n_generators: int,
) -> ScenarioOverrides | None:
    """Rows ``start .. start+take`` of per-scenario override fields (the
    workload fields are (S, G) per scenario with several generators)."""
    if ov is None:
        return None
    workload_ndim = 2 if n_generators > 1 else 1
    per_scenario_ndim = {"edge_mean": 2, "edge_var": 2, "edge_dropout": 2,
                         "user_mean": workload_ndim, "req_rate": workload_ndim}
    fields = {}
    for name, value in ov._asdict().items():
        arr = np.asarray(value, np.float32)
        if arr.ndim == per_scenario_ndim.get(name, 1):
            arr = arr[start : start + take]
        fields[name] = arr
    return ScenarioOverrides(**fields)


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


class SweepRunner:
    """Chunked Monte-Carlo sweep over one scenario family on one device."""

    def __init__(
        self,
        payload: SimulationPayload | Mapping,
        *,
        engine: str = "auto",
        device: torch.device | str | None = None,
    ) -> None:
        if engine not in ("auto", "kernel"):
            msg = f"engine must be 'auto' or 'kernel', got {engine!r}"
            raise ValueError(msg)
        if isinstance(payload, Mapping):
            payload = SimulationPayload.from_dict(payload)
        self.payload = payload
        self.plan = compile_payload(payload)
        # both choices land on the kernel: it is the only ported engine, and
        # KernelEngine refuses what it does not model before any launch
        self.engine = KernelEngine(self.plan, device=device)
        self.engine_kind = "kernel"

    @property
    def device(self) -> torch.device:
        return self.engine.device

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
        (all in one launch by default).  ``overrides`` rows are local."""
        if n_scenarios < 1:
            msg = "n_scenarios must be at least 1"
            raise ValueError(msg)
        _guard_rate_headroom(self.plan, overrides)
        chunk = chunk_size or n_scenarios
        parts = []
        t0 = time.perf_counter()
        for start in range(0, n_scenarios, chunk):
            take = min(chunk, n_scenarios - start)
            keys = scenario_keys(
                seed, take, first=first_scenario + start, device=self.device,
            )
            state = self.engine.run_batch(
                keys, _slice_overrides(overrides, start, take, self.plan.n_generators),
            )
            parts.append(
                sweep_results(state, self.payload.sim_settings, has_llm=self.plan.has_llm),
            )
        wall = time.perf_counter() - t0
        return SweepReport(
            results=concat_results(parts),
            n_scenarios=n_scenarios,
            wall_seconds=wall,
            plan=self.plan,
        )
