"""Chunked Monte-Carlo sweeps over one scenario family: the slice's subset of
the reference's ``parallel/sweep.py`` (``SweepRunner``, ``SweepReport``).

``engine="kernel"`` is the counterpart of the reference's ``"pallas"``: the
DES kernel.  ``engine="auto"`` picks the kernel for every plan inside this
slice; the reference's fast path and event engine are not ported yet, so a
plan outside the slice raises :class:`UnsupportedFeatureError` instead of
being routed elsewhere.  Scenario ``i`` always gets key
``fold_in(PRNGKey(seed), i)``, so any chunking gives the same results.
"""

from __future__ import annotations

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
from asyncflow_tpu_torch.engines.torchsim.params import ScenarioOverrides
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
            "latency_p50_s": self.aggregate_percentile(50),
            "latency_p95_s": self.aggregate_percentile(95),
            "latency_p99_s": self.aggregate_percentile(99),
        }


def _slice_overrides(
    ov: ScenarioOverrides | None, start: int, take: int,
) -> ScenarioOverrides | None:
    """Rows ``start .. start+take`` of per-scenario override fields."""
    if ov is None:
        return None
    per_scenario_ndim = {"edge_mean": 2, "edge_var": 2, "edge_dropout": 2}
    fields = {}
    for name, value in ov._asdict().items():
        arr = np.asarray(value, np.float32)
        if arr.ndim == per_scenario_ndim.get(name, 1):
            arr = arr[start : start + take]
        fields[name] = arr
    return ScenarioOverrides(**fields)


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
        chunk = chunk_size or n_scenarios
        parts = []
        t0 = time.perf_counter()
        for start in range(0, n_scenarios, chunk):
            take = min(chunk, n_scenarios - start)
            keys = scenario_keys(
                seed, take, first=first_scenario + start, device=self.device,
            )
            state = self.engine.run_batch(keys, _slice_overrides(overrides, start, take))
            parts.append(sweep_results(state, self.payload.sim_settings))
        wall = time.perf_counter() - t0
        return SweepReport(
            results=concat_results(parts),
            n_scenarios=n_scenarios,
            wall_seconds=wall,
            plan=self.plan,
        )
