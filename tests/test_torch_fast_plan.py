"""The port's fast-path lowering and decision against the JAX reference:
the visit tables, ``fastpath_ok`` and its reason, ``ram_slots``,
``server_topo_order``, ``lc_ring``, ``relax_rho``, ``max_requests`` and the
gauge layout equal the reference plan's on every example YAML the port
can compile and on the reference parity suite's mutations; and the fast
engine refuses by name what this slice does not model."""

from __future__ import annotations

import numpy as np
import pytest
from torch_fast_cases import EXAMPLES, MUTATIONS, example, mutated

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine, fast_refusal
from asyncflow_tpu_torch.errors import (
    FastPathIneligibleError,
    UnsupportedFeatureError,
)
from asyncflow_tpu_torch.schemas import SimulationPayload

FAST_FIELDS = (
    "max_bursts", "n_bursts", "burst_dur", "burst_pre_io", "endpoint_post_io",
    "sample_period", "n_samples", "max_requests", "fastpath_ok", "fastpath_reason",
    "server_topo_order", "ram_slots", "lc_ring", "relax_rho", "n_gauges",
)


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


def _both(data: dict):
    return (compile_payload(SimulationPayload.from_dict(data)),
            jax_compile(JaxPayload.model_validate(data)))


def _port_examples() -> list[str]:
    """Every example YAML whose features the port's schemas accept."""
    names = []
    for path in sorted(EXAMPLES.glob("*.yml")):
        try:
            compile_payload(SimulationPayload.from_dict(example(path.stem)))
        except UnsupportedFeatureError:
            continue
        names.append(path.stem)
    return names


EXAMPLE_NAMES = _port_examples()


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
    ("name", "feature"),
    [
        ("least_connections", "least-connections routing"),
        ("outage", "outage timeline"),
    ],
)
def test_out_of_slice_features_are_refused_by_name(name: str, feature: str) -> None:
    plan = compile_payload(SimulationPayload.from_dict(mutated(name)))
    assert plan.fastpath_ok
    assert fast_refusal(plan)[0] == feature
    with pytest.raises(UnsupportedFeatureError, match=feature):
        FastEngine(plan, device="cpu")


def test_event_inj_lb_is_refused_for_its_outages() -> None:
    plan = compile_payload(SimulationPayload.from_dict(example("event_inj_lb")))
    assert plan.fastpath_ok
    with pytest.raises(UnsupportedFeatureError, match="outage timeline"):
        FastEngine(plan, device="cpu")


def test_ineligible_plan_is_refused_with_the_reason() -> None:
    plan = compile_payload(SimulationPayload.from_dict(mutated("heterogeneous_ram")))
    with pytest.raises(FastPathIneligibleError, match="heterogeneous RAM"):
        FastEngine(plan, device="cpu")


@pytest.mark.parametrize(
    ("option", "feature"),
    [({"collect_gauges": True}, "gauge grid"), ({"trace": {}}, "flight recorder"),
     ({"blame": True}, "blame")],
)
def test_out_of_slice_options_are_refused_by_name(option: dict, feature: str) -> None:
    plan = compile_payload(SimulationPayload.from_dict(example("single_server")))
    with pytest.raises(UnsupportedFeatureError, match=feature):
        FastEngine(plan, device="cpu", **option)
    eng = FastEngine(plan, device="cpu")
    with pytest.raises(UnsupportedFeatureError, match="antithetic"):
        eng.run_batch(np.zeros((1, 2), np.uint32), antithetic=True)
    with pytest.raises(UnsupportedFeatureError, match="run_batch_scanned"):
        eng.run_batch_scanned(np.zeros((1, 2), np.uint32))
