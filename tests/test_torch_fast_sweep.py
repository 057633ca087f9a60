"""The sweep plane over the fast path: ``engine="auto"`` takes the fast path
where the reference's analysis and this slice's engine allow it and the
DES kernel otherwise; ``engine="fast"`` refuses an out-of-slice plan by
name; rate-raising overrides past the fast path's proofs are refused;
chunked sweeps equal unchunked ones."""

from __future__ import annotations

import numpy as np
import pytest
from torch_fast_cases import example, mutated

from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
from asyncflow_tpu_torch.errors import (
    FastPathIneligibleError,
    FastPathOverrideError,
    UnsupportedFeatureError,
)
from asyncflow_tpu_torch.parallel import SweepRunner


def _rate_limited() -> dict:
    data = example("single_server", horizon=5)
    data["topology_graph"]["nodes"]["servers"][0]["overload"] = {
        "rate_limit_rps": 3.0, "rate_limit_burst": 3,
    }
    return data


@pytest.mark.parametrize(
    ("make", "kind"),
    [
        (lambda: example("two_servers_lb", horizon=5), "fast"),
        (lambda: example("single_server", horizon=5), "fast"),
        (lambda: mutated("two_core_multi_burst", horizon=5), "fast"),
        (lambda: mutated("outage", horizon=20), "kernel"),
        (lambda: mutated("least_connections", horizon=5), "kernel"),
        (lambda: mutated("heterogeneous_ram", horizon=5), "kernel"),
        (_rate_limited, "kernel"),
    ],
)
def test_auto_picks_fast_where_it_may(make, kind: str) -> None:
    runner = SweepRunner(make(), device="cpu")
    assert runner.engine_kind == kind
    assert type(runner.engine).__name__ == ("FastEngine" if kind == "fast" else "KernelEngine")


@pytest.mark.parametrize(
    ("make", "error", "match"),
    [
        (lambda: mutated("least_connections", horizon=5), UnsupportedFeatureError,
         "least-connections"),
        (lambda: mutated("outage", horizon=20), UnsupportedFeatureError, "outage timeline"),
        (_rate_limited, UnsupportedFeatureError, "rate limit"),
        (lambda: mutated("heterogeneous_ram", horizon=5), FastPathIneligibleError,
         "heterogeneous RAM"),
    ],
)
def test_engine_fast_refuses_out_of_slice_plans(make, error, match: str) -> None:
    with pytest.raises(error, match=match):
        SweepRunner(make(), engine="fast", device="cpu")


def test_fast_sweep_results() -> None:
    report = SweepRunner(example("single_server", horizon=20), device="cpu").run(3, seed=2)
    res = report.results
    assert res.truncated is None and res.events is None
    assert res.gauge_means.shape == (3, report.plan.n_gauges)
    summary = report.summary()
    assert summary["truncated_total"] == 0 and summary["completed_total"] > 0
    in_flight = (res.total_generated - res.completed - res.total_dropped
                 - res.overflow_dropped - res.total_rejected)
    assert (in_flight >= 0).all()


def test_fast_chunked_equals_unchunked() -> None:
    runner = SweepRunner(example("two_servers_lb", horizon=8), device="cpu")
    whole = runner.run(5, seed=3).results
    chunked = runner.run(5, seed=3, chunk_size=2).results
    tail = runner.run(3, seed=3, first_scenario=2).results
    for field in ("completed", "latency_hist", "latency_sum", "latency_sumsq",
                  "latency_min", "latency_max", "throughput", "total_generated",
                  "total_dropped", "overflow_dropped", "gauge_means"):
        np.testing.assert_array_equal(getattr(whole, field), getattr(chunked, field))
        np.testing.assert_array_equal(getattr(whole, field)[2:], getattr(tail, field))


def test_fast_override_guard() -> None:
    """The headline's RAM tier was proven non-binding at the base rate: a
    rate raise is refused on the fast path, a cut is not."""
    runner = SweepRunner(example("two_servers_lb", horizon=5), device="cpu")
    assert runner.plan.ram_slots.tolist() == [-1, -1]
    base = base_overrides(runner.plan)
    lower = base._replace(user_mean=np.full(2, 0.5 * base.user_mean, np.float32))
    assert runner.run(2, seed=0, overrides=lower).summary()["completed_total"] > 0
    higher = base._replace(user_mean=np.full(2, 1.5 * base.user_mean, np.float32))
    with pytest.raises(FastPathOverrideError, match="RAM non-binding"):
        runner.run(2, seed=0, overrides=higher)
    kernel = SweepRunner(example("two_servers_lb", horizon=5), engine="kernel", device="cpu")
    assert kernel.run(2, seed=0, overrides=higher).summary()["completed_total"] > 0


def test_per_scenario_overrides_move_the_fast_path() -> None:
    """Per-scenario edge overrides: a slower exit edge lengthens latency."""
    runner = SweepRunner(example("single_server", horizon=10), device="cpu")
    base = base_overrides(runner.plan)
    mean = np.tile(base.edge_mean, (2, 1))
    mean[1, 2] *= 10.0
    res = runner.run(2, seed=1, overrides=base._replace(edge_mean=mean)).results
    assert res.latency_sum[1] / res.completed[1] > res.latency_sum[0] / res.completed[0]


def test_engine_options() -> None:
    """``max_requests`` sets the lanes (arrivals past them overflow, counted),
    ``n_hist_bins`` the histogram, ``collect_clocks`` the compacted
    (arrival, finish) pairs, and ``relax_sweeps`` the relaxation of a
    multi-burst server."""
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.schemas import SimulationPayload

    plan = compile_payload(SimulationPayload.from_dict(example("single_server", horizon=10)))
    keys = scenario_keys(1, 2)
    full = FastEngine(plan, device="cpu", collect_clocks=True).run_batch(keys)
    cut = FastEngine(plan, device="cpu", max_requests=100, n_hist_bins=256).run_batch(keys)
    assert cut.hist.shape == (2, 256) and full.hist.shape == (2, 1024)
    assert np.array_equal(cut.n_overflow, full.n_generated - 100)
    assert np.array_equal(cut.n_generated, np.full(2, 100))
    assert full.clock.shape == (2, plan.max_requests, 2)
    for s in range(2):
        done = full.clock[s, : full.clock_n[s]]
        assert np.all(done[:, 1] > done[:, 0]) and np.all(np.diff(done[:, 0]) >= 0)
    burst = compile_payload(SimulationPayload.from_dict(mutated("multi_burst", horizon=10)))
    relaxed = FastEngine(burst, device="cpu").run_batch(keys)
    once = FastEngine(burst, device="cpu", relax_sweeps=1).run_batch(keys)
    assert not np.array_equal(relaxed.lat_sum, once.lat_sum)
    with pytest.raises(ValueError, match="relax_sweeps"):
        FastEngine(burst, device="cpu", relax_sweeps=0)
