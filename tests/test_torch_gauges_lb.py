"""The gauge grid and the streamed series on the headline's LB loaded so
that its ready queues build and its RAM tier binds, and a chaos campaign's
time to drain, held against the JAX reference on the CPU: the grids, the
series and bands, the report's statistics and intervals
(``torch_gauge_cases``)."""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    ONE_BIN,
    example,
    hazard_overrides,
    one_torch_thread,
    torch_inference_mode,
)
from torch_gauge_cases import (
    N,
    SEED,
    SERIES,
    check_grid,
    grid_cases,
    loaded_lb,
    reference_report,
)

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.results import SweepResults as PortResults
from asyncflow_tpu_torch.parallel import SweepRunner
from asyncflow_tpu_torch.parallel.sweep import SweepReport
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

#: the headline's LB loaded so that its ready queues build and its RAM
#: tier binds
GRID_CASES = grid_cases("ram_bound_lb")


@pytest.mark.parametrize(("name", "mode"), GRID_CASES)
def test_grid_equals_reference(name: str, mode: str) -> None:
    """``collect_gauges`` (n_samples + 2 rows) and ``gauge_series_stride``
    (n_samples // k + 2 rows) grids equal the JAX FastEngine's, bit for
    bit; the same run without a grid gives every other output unchanged."""
    check_grid(name, mode)


@pytest.fixture(scope="module")
def lb_reports():
    return reference_report("ram_bound_lb", SERIES)


def test_series_and_bands_equal_thereference(lb_reports) -> None:
    ref, got = lb_reports
    assert got.gauge_series_ids == ref.gauge_series_ids == ["srv-1", "srv-2"]
    assert got.results.gauge_series_period == ref.results.gauge_series_period
    assert np.array_equal(got.results.gauge_series, ref.results.gauge_series)
    assert np.array_equal(got.results.gauge_hist, ref.results.gauge_hist)
    assert np.array_equal(got.results.gauge_hist_cap, ref.results.gauge_hist_cap)
    assert got.results.gauge_series.max() > 0
    for cid in ("srv-1", "srv-2"):
        for a, b in zip(got.gauge_series(cid), ref.gauge_series(cid)):
            assert np.array_equal(a, b)
        for a, b in zip(got.gauge_series_band(cid, 20, 80), ref.gauge_series_band(cid, 20, 80)):
            assert np.array_equal(a, b)
        for a, b in zip(got.gauge_bands(cid), ref.gauge_bands(cid)):
            assert np.array_equal(a, b)
    assert np.array_equal(got.results.gauge_bands, ref.results.gauge_bands)


def _port_report(ref) -> SweepReport:
    """The reference report's results, read by the port's SweepReport."""
    fields = {f.name: getattr(ref.results, f.name, None)
              for f in dataclasses.fields(PortResults)}
    plan = compile_payload(SimulationPayload.from_dict(loaded_lb()))
    return SweepReport(PortResults(**fields), ref.n_scenarios, ref.wall_seconds, plan,
                       gauge_series_ids=ref.gauge_series_ids)


def test_report_statistics_equal_thereference(lb_reports) -> None:
    """On the same results the port's report computes the reference's
    mean gauges and the four confidence intervals; the port's own sweep
    agrees with the reference's within the parity contract (exact counters,
    pooled percentiles within one histogram bin)."""
    ref, got = lb_reports
    same = _port_report(ref)
    for metric, cid in (("ready_queue_len", "srv-1"), ("ram_in_use", "srv-2"),
                        ("edge_concurrent_connection", "lb-srv1")):
        assert np.array_equal(same.mean_gauge(metric, cid), ref.mean_gauge(metric, cid))
        np.testing.assert_allclose(got.mean_gauge(metric, cid), ref.mean_gauge(metric, cid),
                                   rtol=1e-3, atol=1e-6)
    values = ref.results.completed
    assert same.metric_ci(values, 0.9) == ref.metric_ci(values, 0.9)
    assert got.metric_ci(got.results.completed) == ref.metric_ci(ref.results.completed)
    for q in (50, 95):
        assert (same.per_scenario_percentile_mean_ci(q)
                == ref.per_scenario_percentile_mean_ci(q))
        with pytest.warns(DeprecationWarning, match="per_scenario_percentile_mean_ci"):
            alias = same.percentile_ci(q, 0.9)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert alias == ref.percentile_ci(q, 0.9)
        assert same.pooled_percentile_ci(q).as_dict() == ref.pooled_percentile_ci(q).as_dict()
        mine, theirs = got.pooled_percentile_ci(q), ref.pooled_percentile_ci(q)
        assert mine.n == theirs.n and mine.method == theirs.method == "order-statistic"
        for a, b in ((mine.point, theirs.point), (mine.lo, theirs.lo), (mine.hi, theirs.hi)):
            assert abs(np.log(a / b)) <= np.log(ONE_BIN), (q, a, b)
    with pytest.raises(ValueError, match="confidence level"):
        got.metric_ci(values, 1.0)


def test_time_to_drain_equals_thereference() -> None:
    """A chaos campaign streaming its ready queues, its failures made three
    times as frequent and its repairs ten times as quick, so that windows
    close inside 30 s: the scorecard's time to drain (the reference's
    ``_attach_scorecard`` on its engine's series and the same sampled
    tables) is finite where one does and equals the port's sweep's; without
    the series it is NaN, "not measured"."""
    from types import SimpleNamespace

    from asyncflow_tpu.parallel import SweepRunner as JaxRunner

    from asyncflow_tpu_torch.compiler.hazards import hazard_fault_tables
    from asyncflow_tpu_torch.parallel import make_overrides

    data = example("chaos_campaign", horizon=30)
    ids = [s["id"] for s in data["topology_graph"]["nodes"]["servers"]]
    spec = ("ready_queue_len", ids, 1.0)
    # the sweep axes are float32, as make_overrides makes them; the tables
    # are sampled from those values
    axes = {"hazard_scale": np.full(N, 3.0, np.float32),
            "mttr_scale": np.full(N, 0.1, np.float32)}
    scales = {k: v.astype(np.float64) for k, v in axes.items()}
    ref, got = reference_report(
        "chaos_campaign", spec, data,
        overrides=lambda plan: hazard_overrides(plan, SEED, N, **scales),
        port_overrides=lambda plan: make_overrides(plan, N, **axes))
    tables = hazard_fault_tables(ref.plan, SEED, 0, N, **scales)
    JaxRunner._attach_scorecard(SimpleNamespace(plan=ref.plan, _gauge_series_metric=spec[0]),
                                ref.results, tables)
    assert np.array_equal(got.results.gauge_series, ref.results.gauge_series)
    assert np.isfinite(got.results.time_to_drain).any()
    np.testing.assert_array_equal(got.results.time_to_drain, ref.results.time_to_drain)
    assert got.summary()["time_to_drain_mean_s"] == ref.summary()["time_to_drain_mean_s"]
    plain = SweepRunner(data, engine="fast", device="cpu")
    drained = plain.run(N, seed=SEED, overrides=make_overrides(plain.plan, N, **axes)).results
    assert np.isnan(drained.time_to_drain).all()
