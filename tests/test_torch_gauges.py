"""The fast path's gauge grid and the sweep plane's streamed gauge series,
held against the JAX reference on the CPU: the grids of one server and of
an LB under outages and spikes, the bucket, the wrapper's plain scatter,
the series' specs and refusals.  The loaded LB's grids and reports, the
overload and retry payloads' grids and the time to drain are in
``test_torch_gauges_lb.py`` and ``test_torch_gauges_overload.py``.

The grid's intervals are the reference's (same lanes, same sample-tick
bucket: XLA's float32 reciprocal of the period), and its amounts are queue
lengths, connections and whole MB of RAM, whose float32 sums are exact in
any order, so the port's grids equal the reference's bit for bit where the
port runs the reference's window draws (``torch_fast_cases``).  Turning the
grid on consumes no draws: every other output stays as it was.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    example,
    mutated,
    one_torch_thread,
    torch_inference_mode,
)
from torch_gauge_cases import SERIES, STRIDE, check_grid, grid_cases, loaded_lb, plans

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.results import SweepResults as PortResults
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
from asyncflow_tpu_torch.engines.torchsim.gauge_grid import GaugeGrid, gauge_add_plain
from asyncflow_tpu_torch.engines.torchsim.sampling import sample_bucket
from asyncflow_tpu_torch.errors import UnsupportedFeatureError
from asyncflow_tpu_torch.parallel import SweepRunner
from asyncflow_tpu_torch.parallel.sweep import _resolve_gauge_series
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

#: one server, and an LB under outages and spikes (scaled into 30 s)
GRID_CASES = grid_cases("single_server", "event_inj_lb")


@pytest.mark.parametrize(("name", "mode"), GRID_CASES)
def test_grid_equals_reference(name: str, mode: str) -> None:
    """``collect_gauges`` (n_samples + 2 rows) and ``gauge_series_stride``
    (n_samples // k + 2 rows) grids equal the JAX FastEngine's, bit for
    bit; the same run without a grid gives every other output unchanged."""
    check_grid(name, mode)


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

    data = loaded_lb()
    ref_plan, plan = plans(data)
    sel = np.array([0, plan.gauge_ready(1), plan.gauge_ram(0), plan.gauge_ram(1)])
    caps = gauge_hist_caps(plan, sel)
    assert np.array_equal(caps, jax_caps(ref_plan, sel))
    rng = np.random.default_rng(8)
    series = rng.uniform(-2.0, 1.1, (9, 13, 4)) * caps
    series[0, 0] = caps / 128 * 3  # exactly on a bin edge
    series = series.astype(np.float32)
    assert np.array_equal(build_gauge_hist(series, caps), jax_hist(series, caps))
