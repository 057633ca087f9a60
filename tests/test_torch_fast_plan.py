"""The port's fast-path lowering and decision against the JAX reference:
the visit tables, the DB split and cache placements (``fp_*``), each
stream's lanes (``gen_slots``), ``fastpath_ok`` and its reason,
``ram_slots``, ``server_topo_order``, ``lc_ring``, ``relax_rho``,
``max_requests`` and the gauge layout equal the reference plan's on every
example YAML the port can compile, on ``chip_smoke.py``'s payloads and on
the reference parity suite's mutations; and the fast engine refuses by
name what it does not model yet."""

from __future__ import annotations

import numpy as np
import pytest
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    EXAMPLES,
    MUTATIONS,
    example,
    mutated,
    one_torch_thread,
    port_examples,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload, plan_from_arrays
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine, fast_refusal
from asyncflow_tpu_torch.errors import (
    FastPathIneligibleError,
    UnsupportedFeatureError,
)
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

FAST_FIELDS = (
    "max_bursts", "n_bursts", "burst_dur", "burst_pre_io", "endpoint_post_io",
    "sample_period", "n_samples", "max_requests", "fastpath_ok", "fastpath_reason",
    "server_topo_order", "ram_slots", "lc_ring", "relax_rho", "n_gauges",
    "fp_db_pre", "fp_db_dur", "fp_db_post", "fp_cache_slot", "fp_cache_miss_prob",
    "fp_cache_extra", "gen_slots",
)


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


def _both(data: dict):
    return (compile_payload(SimulationPayload.from_dict(data)),
            jax_compile(JaxPayload.model_validate(data)))


EXAMPLE_NAMES = port_examples()


def test_the_examples_cover_the_fast_paths() -> None:
    assert {"two_servers_lb", "single_server", "event_inj_lb"} <= set(EXAMPLE_NAMES)


@pytest.mark.parametrize("name", EXAMPLE_NAMES)
def test_fast_fields_match_reference_on_examples(name: str) -> None:
    got, ref = _both(example(name))
    diff = [f for f in FAST_FIELDS if not _equal(getattr(got, f), getattr(ref, f))]
    assert diff == []
    for s in range(got.n_servers):
        assert (got.gauge_ready(s), got.gauge_io(s), got.gauge_ram(s)) == (
            ref.gauge_ready(s), ref.gauge_io(s), ref.gauge_ram(s))


def _smoke_payloads() -> dict:
    """chip_smoke.py's payloads by name: its DES paths, its fast paths and
    its 5 s workload plans."""
    import importlib.util

    path = EXAMPLES.parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return {
        **smoke.PAYLOADS, **smoke.FAST_PAYLOADS,
        **{name: make() for name, (make, _) in smoke.WORKLOAD_PAYLOADS.items()},
    }


SMOKE_PAYLOADS = _smoke_payloads()


@pytest.mark.parametrize("name", sorted(SMOKE_PAYLOADS))
def test_fast_fields_match_reference_on_smoke_payloads(name: str) -> None:
    got, ref = _both(SMOKE_PAYLOADS[name])
    diff = [f for f in FAST_FIELDS if not _equal(getattr(got, f), getattr(ref, f))]
    assert diff == []


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_fast_fields_match_reference_on_mutations(name: str) -> None:
    got, ref = _both(mutated(name))
    diff = [f for f in FAST_FIELDS if not _equal(getattr(got, f), getattr(ref, f))]
    assert diff == []


def test_decisions_reach_both_sides() -> None:
    """The mutations reach the analysis' tiers and refusals."""
    plans = {name: _both(mutated(name))[0] for name in MUTATIONS}
    assert plans["binding_ram"].ram_slots.tolist() == [1]
    assert plans["multi_burst"].max_bursts == 2 and plans["multi_burst"].relax_rho > 0
    assert len(plans["server_chain"].server_topo_order) == 2
    assert plans["least_connections"].lc_ring > 0
    for name, reason in (
        ("heterogeneous_ram", "heterogeneous RAM"),
        ("varying_pre_io", "pre-burst IO"),
        ("many_bursts", "CPU bursts"),
        ("outside_envelope", "validity envelope"),
        ("oversized_ram", "exceeds server RAM"),
        ("huge_inflight", "in-flight bound"),
    ):
        assert not plans[name].fastpath_ok
        assert reason in plans[name].fastpath_reason
    single, _ = _both(example("single_server"))
    assert single.ram_slots.tolist() == [20]
    head, _ = _both(example("two_servers_lb"))
    assert head.ram_slots.tolist() == [-1, -1] and head.max_requests == 87840


@pytest.mark.parametrize(
    ("field", "value", "feature"),
    [
        ("hedge_delay", 0.05, "hedge"),
        ("health_alpha", 0.3, "health"),
        ("server_brownout_q", np.array([4], dtype=np.int32), "brownout"),
    ],
)
def test_out_of_slice_features_are_refused_by_name(field: str, value, feature: str) -> None:
    """A plan carrying a feature the port does not model (set here on a
    plan's fields, as a reference plan carries it) is refused by its name."""
    fields = dict(vars(compile_payload(SimulationPayload.from_dict(example("single_server")))))
    fields[field] = value
    plan = plan_from_arrays(fields)
    assert plan.fastpath_ok
    assert fast_refusal(plan) == (feature, "plan")
    with pytest.raises(UnsupportedFeatureError, match=feature):
        FastEngine(plan, device="cpu")


@pytest.mark.parametrize(
    ("name", "holds"),
    [
        ("least_connections", lambda plan: plan.lb_algo == 1),
        ("queue_cap", lambda plan: plan.has_queue_cap),
        ("conn_cap", lambda plan: plan.has_conn_cap),
    ],
)
def test_overload_and_routing_controls_build_on_the_fast_path(name: str, holds) -> None:
    """Least connections, the ready-queue cap and the connection cap, which
    the fast engine once refused by name, build where the reference's
    analysis accepts the plan."""
    plan = compile_payload(SimulationPayload.from_dict(mutated(name)))
    assert plan.fastpath_ok and holds(plan)
    assert fast_refusal(plan) is None
    assert FastEngine(plan, device="cpu").plan is plan


def test_event_inj_lb_runs_on_the_fast_path() -> None:
    """Its outages route under the timeline (``lb_route``), its spikes ride
    the hops."""
    plan = compile_payload(SimulationPayload.from_dict(example("event_inj_lb")))
    assert plan.fastpath_ok and plan.has_timeline and plan.has_spikes
    assert fast_refusal(plan) is None
    eng = FastEngine(plan, device="cpu")
    assert eng.timeline is not None and eng.timeline.n_marks == 4


def test_ineligible_plan_is_refused_with_the_reason() -> None:
    plan = compile_payload(SimulationPayload.from_dict(mutated("heterogeneous_ram")))
    with pytest.raises(FastPathIneligibleError, match="heterogeneous RAM"):
        FastEngine(plan, device="cpu")


@pytest.mark.parametrize(
    ("option", "feature"),
    [({"trace": {}}, "flight recorder"), ({"blame": True}, "blame")],
)
def test_out_of_slice_options_are_refused_by_name(option: dict, feature: str) -> None:
    """The flight recorder and blame run on the fast path (a trace mapping
    validated into a TraceConfig); antithetic draws and the scanned entry
    point are still refused by name."""
    from asyncflow_tpu_torch.observability import TraceConfig

    plan = compile_payload(SimulationPayload.from_dict(example("single_server")))
    on = FastEngine(plan, device="cpu", **option)
    if feature == "flight recorder":
        assert on.trace == TraceConfig() and not on.blame
    else:
        assert on.trace is None and on.blame
    eng = FastEngine(plan, device="cpu")
    with pytest.raises(UnsupportedFeatureError, match="antithetic"):
        eng.run_batch(np.zeros((1, 2), np.uint32), antithetic=True)
    with pytest.raises(UnsupportedFeatureError, match="run_batch_scanned"):
        eng.run_batch_scanned(np.zeros((1, 2), np.uint32))


@pytest.mark.parametrize(
    ("option", "rows"),
    [({"collect_gauges": True}, lambda plan: plan.n_samples + 2),
     ({"gauge_series_stride": 7}, lambda plan: plan.n_samples // 7 + 2)],
)
def test_gauge_grid_options_run(option: dict, rows) -> None:
    """The gauge grid, once refused by name, runs: every gauge's interval
    endpoints on the fine grid or on one coarsened k-fold."""
    plan = compile_payload(SimulationPayload.from_dict(example("single_server", horizon=5)))
    state = FastEngine(plan, device="cpu", **option).run_batch(np.zeros((2, 2), np.uint32))
    assert state.gauge.shape == (2, rows(plan), plan.n_gauges)
    assert np.abs(state.gauge).sum() > 0
