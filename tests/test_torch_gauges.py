"""The fast path's gauge grid and the sweep plane's streamed gauge series,
bands, time to drain and confidence intervals, held against the JAX
reference on the CPU.

The grid's intervals are the reference's (same lanes, same sample-tick
bucket: XLA's float32 reciprocal of the period), and its amounts are queue
lengths, connections and whole MB of RAM, whose float32 sums are exact in
any order, so the port's grids equal the reference's bit for bit where the
port runs the reference's window draws (``torch_fast_cases``).  Turning the
grid on consumes no draws: every other output stays as it was.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    ONE_BIN,
    example,
    hazard_overrides,
    inject_reference_draws,
    mutated,
    one_torch_thread,
    reference_window_draws,
    scaled_events,
    torch_inference_mode,
)

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.results import SweepResults as PortResults
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
from asyncflow_tpu_torch.engines.torchsim.gauge_grid import GaugeGrid, gauge_add_plain
from asyncflow_tpu_torch.engines.torchsim.sampling import sample_bucket
from asyncflow_tpu_torch.errors import UnsupportedFeatureError
from asyncflow_tpu_torch.parallel import SweepRunner
from asyncflow_tpu_torch.parallel.sweep import SweepReport, _resolve_gauge_series
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

def _loaded_lb() -> dict:
    """The headline's LB payload at 20 s, loaded so that the ready queues
    build and its RAM tier binds: 240 users, 20 ms of CPU a request."""
    data = example("two_servers_lb", horizon=20)
    data["rqs_input"]["avg_active_users"]["mean"] = 240
    for srv in data["topology_graph"]["nodes"]["servers"]:
        srv["endpoints"][0]["steps"][0]["step_operation"]["cpu_time"] = 0.02
    return data


#: the payloads whose grids are held to the reference's: one server, an LB
#: under outages and spikes (scaled into 30 s), a loaded LB whose RAM tier
#: binds, a ready-queue cap, a retry plan (only the last pass records) and,
#: fine grid only, a connection cap (its shed and abandoned RAM)
GRID_PAYLOADS = {
    "single_server": lambda: example("single_server", horizon=20),
    "event_inj_lb": lambda: scaled_events(example("event_inj_lb"), 30),
    "ram_bound_lb": _loaded_lb,
    "overload_cap8": lambda: mutated("overload_cap8", horizon=20),
    "outage_retry": lambda: mutated("outage_retry", horizon=30),
    "overload_sockets": lambda: mutated("overload_sockets", horizon=20),
}
GRID_CASES = [(name, mode) for name in GRID_PAYLOADS for mode in ("fine", "stride")
              if (name, mode) != ("overload_sockets", "stride")]
#: the coarse grid's stride in sample periods (1 s at their 0.05 s)
STRIDE = 20
SEED, N = 4, 6
SERIES = ("ready_queue_len", ["srv-1", "srv-2"], 1.0)

#: (payload, mode) -> (reference plan, reference engine, its state): each
#: reference program compiles once a file
_REFERENCE: dict = {}
#: payload -> the port's run without a grid, on the reference's draws
_WITHOUT_GRID: dict = {}


def _plans(data: dict):
    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    return (jax_compile(JaxPayload.model_validate(data)),
            compile_payload(SimulationPayload.from_dict(data)))


def _option(mode: str) -> dict:
    return {"collect_gauges": True} if mode == "fine" else {"gauge_series_stride": STRIDE}


def _reference(name: str, mode: str, data: dict | None = None, overrides=None) -> tuple:
    """The JAX FastEngine's run of scenarios 0 .. N-1 of SEED on a
    payload of GRID_PAYLOADS (or ``data``), memoised."""
    import jax

    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine

    if (name, mode) not in _REFERENCE:
        ref_plan, _ = _plans(data if data is not None else GRID_PAYLOADS[name]())
        eng = JaxFastEngine(ref_plan, **_option(mode))
        jov = overrides(ref_plan) if overrides is not None else None
        state = jax.tree_util.tree_map(np.asarray, eng.run_batch(jax_keys(SEED, N), jov))
        _REFERENCE[name, mode] = (ref_plan, eng, state)
    return _REFERENCE[name, mode]


@pytest.mark.parametrize(("name", "mode"), GRID_CASES)
def test_grid_equals_reference(name: str, mode: str) -> None:
    """``collect_gauges`` (n_samples + 2 rows) and ``gauge_series_stride``
    (n_samples // k + 2 rows) grids equal the JAX FastEngine's, bit for
    bit; the same run without a grid gives every other output unchanged."""
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys

    ref_plan, _, ref = _reference(name, mode)
    plan = compile_payload(SimulationPayload.from_dict(GRID_PAYLOADS[name]()))
    keys = np.asarray(jax_keys(SEED, N))
    windows = reference_window_draws(ref_plan, keys)
    eng = FastEngine(plan, device="cpu", **_option(mode))
    got = eng.run_batch(keys, window_draws=windows)
    rows = plan.n_samples + 2 if mode == "fine" else plan.n_samples // STRIDE + 2
    assert got.gauge.shape == ref.gauge.shape == (N, rows, plan.n_gauges)
    assert np.array_equal(got.gauge, ref.gauge), name
    assert np.abs(got.gauge).sum() > 0
    assert eng.gauge_series_stride == (0 if mode == "fine" else STRIDE)
    if name not in _WITHOUT_GRID:
        _WITHOUT_GRID[name] = FastEngine(plan, device="cpu").run_batch(keys,
                                                                        window_draws=windows)
    off = _WITHOUT_GRID[name]
    assert off.gauge.shape == (N, 1, 1)
    for field in off._fields:
        if field != "gauge":
            assert np.array_equal(getattr(got, field), getattr(off, field)), (name, field)


def test_stride_grid_samples_the_fine_grid() -> None:
    """The value at a coarse tick is the fine grid's at that time."""
    plan = compile_payload(SimulationPayload.from_dict(example("two_servers_lb", horizon=10)))
    keys = np.asarray([[0, 7], [0, 9]], np.uint32)
    fine = FastEngine(plan, device="cpu", collect_gauges=True).run_batch(keys).gauge
    coarse = FastEngine(plan, device="cpu", gauge_series_stride=STRIDE).run_batch(keys).gauge
    fine_v = np.cumsum(fine, axis=1)[:, 1:-1]
    coarse_v = np.cumsum(coarse, axis=1)[:, 1:-1]
    assert coarse_v.shape[1] == plan.n_samples // STRIDE
    assert np.array_equal(coarse_v, fine_v[:, STRIDE - 1 :: STRIDE][:, : coarse_v.shape[1]])


def test_sample_bucket_is_xlas() -> None:
    """ceil(t / period) clipped to [0, n_samples + 1], with XLA's float32
    quotient (the reciprocal's product), on random times, the ticks
    themselves, zero and "never"."""
    import jax

    from asyncflow_tpu.engines.jaxsim.sampling import sample_bucket as jax_bucket

    rng = np.random.default_rng(3)
    for period, ns in ((0.05, 399), (0.03, 1000), (1.0, 19), (0.01 * 7, 85)):
        t = np.concatenate([
            rng.uniform(0.0, period * (ns + 3), 20_000).astype(np.float32),
            np.arange(ns + 3, dtype=np.float32) * np.float32(period),
            np.array([1e30, 0.0], np.float32),
        ])
        want = np.asarray(jax.jit(lambda x, p=period, k=ns: jax_bucket(x, p, k))(t))
        got = sample_bucket(torch.from_numpy(t), period, ns).numpy()
        assert np.array_equal(got, want), period


def test_gauge_grid_wrapper_runs_the_plain_scatter_on_cpu() -> None:
    """On CPU tensors the wrapper is the plain scatter (and counts no
    launch): +amount at t0's bucket, -amount at t1's, where ``on``."""
    g = torch.Generator().manual_seed(2)
    t0 = torch.rand((2, 50), generator=g) * 3
    t1 = t0 + torch.rand((2, 50), generator=g)
    on = torch.rand((2, 50), generator=g) > 0.3
    ram = torch.randint(1, 64, (2, 50), generator=g).float()
    grid = torch.zeros((2, 7, 3))
    wrapper = GaugeGrid()
    wrapper.add(grid, 1, t0, t1, on, ram, 0.5)
    assert wrapper.launches == 0
    want = np.zeros((2, 7), np.float32)
    a0, a1, mask, amount = t0.numpy(), t1.numpy(), on.numpy(), ram.numpy()
    for r in range(2):
        for i in range(50):
            if mask[r, i]:
                want[r, min(int(np.ceil(a0[r, i] * np.float32(2.0))), 6)] += amount[r, i]
                want[r, min(int(np.ceil(a1[r, i] * np.float32(2.0))), 6)] -= amount[r, i]
    assert np.array_equal(grid[:, :, 1].numpy(), want)
    assert not grid[:, :, [0, 2]].any()
    again = torch.zeros((2, 7, 3))
    gauge_add_plain(again, 1, t0, t1, on, ram, 0.5)
    assert torch.equal(again, grid)


def _reference_report(name: str, spec: tuple, data: dict | None = None, overrides=None,
                      port_overrides=None):
    """The reference's SweepReport of its FastEngine's stride run (its own
    ``sweep_results``: the series' columns, cumulative sum and band
    histograms) and the port's SweepRunner report of the same scenarios on
    the reference's window draws; ``overrides`` and ``port_overrides`` map
    each package's plan to its overrides."""
    from asyncflow_tpu.engines.jaxsim.engine import sweep_results as jax_results
    from asyncflow_tpu.parallel.sweep import SweepReport as JaxReport
    from asyncflow_tpu.parallel.sweep import _resolve_gauge_series as jax_resolve

    ref_plan, eng, state = _reference(name, "stride", data, overrides)
    sel, stride, ids = jax_resolve(ref_plan, spec)
    assert stride == STRIDE
    results = jax_results(eng, state, None, gauge_sel=sel)
    ref = JaxReport(results, N, 1.0, ref_plan, gauge_series_ids=ids)
    runner = SweepRunner(data if data is not None else GRID_PAYLOADS[name](), engine="fast",
                         device="cpu", gauge_series=spec)
    inject_reference_draws(runner, ref_plan)
    port_ov = port_overrides(runner.plan) if port_overrides is not None else None
    return ref, runner.run(N, seed=SEED, chunk_size=4, overrides=port_ov)


@pytest.fixture(scope="module")
def lb_reports():
    return _reference_report("ram_bound_lb", SERIES)


def test_series_and_bands_equal_the_reference(lb_reports) -> None:
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
    plan = compile_payload(SimulationPayload.from_dict(_loaded_lb()))
    return SweepReport(PortResults(**fields), ref.n_scenarios, ref.wall_seconds, plan,
                       gauge_series_ids=ref.gauge_series_ids)


def test_report_statistics_equal_the_reference(lb_reports) -> None:
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


def test_time_to_drain_equals_the_reference() -> None:
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
    ref, got = _reference_report(
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


@pytest.mark.parametrize(
    "spec",
    [
        ("ready_queue_len", ["srv-1"]),
        ("ready_queue_len", [], 1.0),
        ("ready_queue_len", ["srv-1"], 0.001),
        ("ready_queue_len", ["srv-1"], 50.0),
        ("ready_queue_len", ["nope"], 1.0),
        ("edge_concurrent_connection", ["nope"], 1.0),
        ("cpu_busy", ["srv-1"], 1.0),
    ],
)
def test_spec_validation_messages_are_the_references(spec: tuple) -> None:
    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.parallel.sweep import _resolve_gauge_series as jax_resolve
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    data = example("two_servers_lb", horizon=20)
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    plan = compile_payload(SimulationPayload.from_dict(data))
    with pytest.raises(ValueError) as want:
        jax_resolve(ref_plan, spec)
    with pytest.raises(ValueError) as got:
        _resolve_gauge_series(plan, spec)
    assert str(got.value) == str(want.value)


def test_spec_resolution_equals_the_references() -> None:
    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.parallel.sweep import _resolve_gauge_series as jax_resolve
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    data = example("two_servers_lb", horizon=20)
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    plan = compile_payload(SimulationPayload.from_dict(data))
    for spec in (SERIES, ("ram_in_use", "srv-2", 0.25),
                 ("event_loop_io_sleep", ["srv-2", "srv-1"], 2.0),
                 ("edge_concurrent_connection", ["lb-srv1", "client-lb"], 1.0)):
        sel, stride, ids = _resolve_gauge_series(plan, spec)
        r_sel, r_stride, r_ids = jax_resolve(ref_plan, spec)
        assert np.array_equal(sel, r_sel) and stride == r_stride and ids == r_ids


def test_refusals_by_name() -> None:
    """The DES kernel collects no gauge grid, and a plan the fast path
    declines would take the reference's event engine, which the port does
    not have: both refuse streaming series by name, with the engine."""
    data = example("two_servers_lb", horizon=10)
    with pytest.raises(UnsupportedFeatureError, match="streaming gauge series.*kernel"):
        SweepRunner(data, engine="kernel", device="cpu", gauge_series=SERIES)
    declined = mutated("heterogeneous_ram", horizon=5)
    with pytest.raises(UnsupportedFeatureError, match="streaming gauge series.*auto"):
        SweepRunner(declined, device="cpu", gauge_series=("ready_queue_len", ["srv-1"], 1.0))
    assert SweepRunner(declined, device="cpu").engine_kind == "kernel"
    report = SweepRunner(data, device="cpu").run(2, seed=1)
    with pytest.raises(ValueError, match="no streaming gauge series"):
        report.gauge_series("srv-1")
    with pytest.raises(ValueError, match="gauge_series_stride must be >= 0"):
        FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cpu",
                   gauge_series_stride=-1)


def test_sweep_with_series_changes_no_other_output() -> None:
    """A sweep streaming a series equals the same sweep without it in
    every other result, chunked or not."""
    data = mutated("outage_retry", horizon=30)
    spec = ("ready_queue_len", ["srv-1"], 1.0)
    on = SweepRunner(data, device="cpu", gauge_series=spec).run(4, seed=3, chunk_size=3)
    off = SweepRunner(data, device="cpu").run(4, seed=3)
    for f in dataclasses.fields(PortResults):
        a, b = getattr(on.results, f.name), getattr(off.results, f.name)
        if f.name.startswith("gauge_") and f.name != "gauge_means":
            assert a is not None and b is None, f.name
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
    assert on.results.gauge_series.shape == (4, 29, 1)


def test_band_histograms_are_the_references() -> None:
    """The band histograms and their caps from the reference's helpers, on
    series that cross every bin edge, fall below zero and pass the cap."""
    from asyncflow_tpu.engines.results import build_gauge_hist as jax_hist
    from asyncflow_tpu.engines.results import gauge_hist_caps as jax_caps

    from asyncflow_tpu_torch.engines.results import build_gauge_hist, gauge_hist_caps

    data = _loaded_lb()
    ref_plan, plan = _plans(data)
    sel = np.array([0, plan.gauge_ready(1), plan.gauge_ram(0), plan.gauge_ram(1)])
    caps = gauge_hist_caps(plan, sel)
    assert np.array_equal(caps, jax_caps(ref_plan, sel))
    rng = np.random.default_rng(8)
    series = rng.uniform(-2.0, 1.1, (9, 13, 4)) * caps
    series[0, 0] = caps / 128 * 3  # exactly on a bin edge
    series = series.astype(np.float32)
    assert np.array_equal(build_gauge_hist(series, caps), jax_hist(series, caps))
