"""The sweep plane over the fast path: ``engine="auto"`` takes the fast path
where the reference's analysis and this slice's engine allow it and the
DES kernel otherwise; ``engine="fast"`` refuses a plan the reference's
analysis declines, with its reason; rate-raising overrides past the fast
path's proofs are refused; chunked sweeps, by the default chunk or a given
one, equal unchunked ones."""

from __future__ import annotations

import numpy as np
import pytest
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    example,
    mutated,
    one_torch_thread,
    port_examples,
    torch_inference_mode,
)

from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
from asyncflow_tpu_torch.errors import (
    FastPathIneligibleError,
    FastPathOverrideError,
)
from asyncflow_tpu_torch.parallel import SweepRunner

one_torch_thread()


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
        (lambda: example("event_inj_single_server"), "fast"),
        (lambda: example("heavy_inj_single_server"), "fast"),
        (lambda: mutated("outage", horizon=20), "fast"),
        (lambda: example("event_inj_lb"), "fast"),
        (lambda: mutated("two_gen_lb", horizon=5), "fast"),
        (lambda: mutated("db_pool_k2", horizon=5), "fast"),
        (lambda: mutated("queue_cap", horizon=5), "fast"),
        (lambda: mutated("least_connections", horizon=5), "fast"),
        (lambda: mutated("conn_cap", horizon=5), "fast"),
        (lambda: mutated("heterogeneous_ram", horizon=5), "kernel"),
        (_rate_limited, "fast"),
    ],
)
def test_auto_picks_fast_where_it_may(make, kind: str) -> None:
    runner = SweepRunner(make(), device="cpu")
    assert runner.engine_kind == kind
    assert type(runner.engine).__name__ == ("FastEngine" if kind == "fast" else "KernelEngine")
    if kind == "fast":
        assert SweepRunner(make(), engine="fast", device="cpu").engine_kind == "fast"


def _smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _resilience_deadline() -> dict:
    """resilience_controls.py's "deadline" variant: srv-1's dequeue deadline
    beside srv-2's token bucket (the reference declines it)."""
    data = mutated("rate_limited_lb", horizon=120)
    data["topology_graph"]["nodes"]["servers"][0]["overload"] = {"queue_timeout_s": 0.080}
    return data


#: the documented overload and routing sweeps' payloads: the resilience
#: example's "none" (a rate limit) and "deadline" variants, the overload
#: example's cap of 8 and its server under a deadline and under a
#: connection cap, and the mixed fleet's least connections at 24 MB and at
#: a binding 320 MB
SWEEP_PAYLOADS = {
    "resilience_controls_none": lambda: mutated("rate_limited_lb", horizon=120),
    "resilience_controls_deadline": _resilience_deadline,
    "overload_policy_cap8": lambda: mutated("overload_cap8", horizon=120),
    "overload_policy_deadline": lambda: mutated("overload_deadline", horizon=120),
    "overload_policy_sockets": lambda: mutated("overload_sockets", horizon=120),
    "mixed_fleet_24mb": lambda: _smoke().mixed_fleet_payload(24.0, horizon=30),
    "mixed_fleet_320mb": lambda: _smoke().mixed_fleet_payload(320.0, horizon=30),
}


@pytest.mark.parametrize("name", port_examples() + sorted(SWEEP_PAYLOADS))
def test_auto_takes_the_reference_engine_on_every_example(name: str) -> None:
    """The reference's ``auto`` takes its fast path where its plan's
    ``fastpath_ok`` holds; the port's takes its own there, and the DES
    kernel elsewhere: on every example YAML and on the overload and routing
    sweeps' payloads."""
    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    data = SWEEP_PAYLOADS[name]() if name in SWEEP_PAYLOADS else example(name)
    want = "fast" if jax_compile(JaxPayload.model_validate(data)).fastpath_ok else "kernel"
    assert SweepRunner(data, device="cpu").engine_kind == want
    if name in SWEEP_PAYLOADS:
        declined = ("resilience_controls_deadline", "mixed_fleet_320mb")
        assert want == ("kernel" if name in declined else "fast")


def test_per_stream_overrides_on_the_fast_path() -> None:
    """Two streams: (G,) and (S, G) workload overrides run, chunked as
    unchunked; raising one stream past the base is refused (the headline
    topology's RAM was proven non-binding at the base rate)."""
    runner = SweepRunner(mutated("two_gen_lb", horizon=5), device="cpu")
    assert runner.engine_kind == "fast" and runner.plan.n_generators == 2
    base = base_overrides(runner.plan)
    assert base.user_mean.shape == (2,)
    per_scenario = base._replace(
        user_mean=np.array([[0.5, 0.25], [0.25, 0.5], [1.0, 1.0]], np.float32)
        * base.user_mean)
    whole = runner.run(3, seed=4, overrides=per_scenario).results
    chunked = runner.run(3, seed=4, overrides=per_scenario, chunk_size=2).results
    np.testing.assert_array_equal(whole.latency_hist, chunked.latency_hist)
    assert whole.total_generated[0] < whole.total_generated[2]
    assert runner.run(2, seed=4, overrides=base._replace(
        user_mean=0.5 * base.user_mean)).summary()["completed_total"] > 0
    one_up = base._replace(user_mean=base.user_mean * np.array([1.0, 1.5], np.float32))
    with pytest.raises(FastPathOverrideError, match="RAM non-binding"):
        runner.run(2, seed=4, overrides=one_up)


@pytest.mark.parametrize(
    ("make", "match"),
    [
        (lambda: mutated("heterogeneous_ram", horizon=5), "heterogeneous RAM"),
        (SWEEP_PAYLOADS["resilience_controls_deadline"],
         "dequeue deadline with a RAM admission tier"),
        (SWEEP_PAYLOADS["mixed_fleet_320mb"], "heterogeneous RAM needs can bind"),
    ],
)
def test_engine_fast_refuses_out_of_slice_plans(make, match: str) -> None:
    """A plan the reference's analysis declines is refused with its reason."""
    with pytest.raises(FastPathIneligibleError, match=match):
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


def test_fast_chunked_equals_unchunked(monkeypatch) -> None:
    """One chunk, chunks of 2, and the default chunk forced down to two
    scenarios' lanes (so that a sweep of 5 runs in three chunks)."""
    from asyncflow_tpu_torch.parallel import sweep

    runner = SweepRunner(example("two_servers_lb", horizon=8), device="cpu")
    assert runner.default_chunk == sweep.FAST_CHUNK_LANES // runner.engine.n >= 2048
    whole = runner.run(5, seed=3, chunk_size=5).results
    chunked = runner.run(5, seed=3, chunk_size=2).results
    tail = runner.run(3, seed=3, first_scenario=2).results
    monkeypatch.setattr(sweep, "FAST_CHUNK_LANES", 2 * runner.engine.n + 1)
    assert runner.default_chunk == 2
    by_default = runner.run(5, seed=3).results
    for field in ("completed", "latency_hist", "latency_sum", "latency_sumsq",
                  "latency_min", "latency_max", "throughput", "total_generated",
                  "total_dropped", "overflow_dropped", "gauge_means"):
        np.testing.assert_array_equal(getattr(whole, field), getattr(chunked, field))
        np.testing.assert_array_equal(getattr(whole, field), getattr(by_default, field))
        np.testing.assert_array_equal(getattr(whole, field)[2:], getattr(tail, field))


def test_default_chunks_per_engine() -> None:
    """The fast path's default chunk is its lane budget over the plan's
    lanes (heavy_inj_single_server's 100,085: 1,797 scenarios); the DES
    kernel's is KERNEL_CHUNK scenarios."""
    from asyncflow_tpu_torch.parallel import sweep

    heavy = SweepRunner(example("heavy_inj_single_server"), device="cpu")
    assert heavy.engine.n == 100_085
    assert heavy.default_chunk == 1797
    kernel = SweepRunner(example("heavy_inj_single_server"), engine="kernel", device="cpu")
    assert kernel.default_chunk == sweep.KERNEL_CHUNK == 2048


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
