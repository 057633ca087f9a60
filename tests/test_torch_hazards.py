"""Chaos-campaign fault tables: the port's ``hazard_fault_tables`` against
the reference's, exactly, for chaos_campaign.yml at two seeds, from the
first scenario and from scenario 37, with and without per-scenario
``hazard_scale`` / ``mttr_scale`` (the contract of the reference's
``tests/parity/test_hazard_determinism.py``); the lockstep uniforms bit
for bit; and the scorecard reducers on those tables."""

from __future__ import annotations

import numpy as np
import pytest
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    BASE,
    example,
    load,
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.compiler import hazards as jax_hazards
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload, hazards
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

COUNT = 24
TABLE_FIELDS = ("srv_times", "srv_down", "edge_times", "edge_lat", "edge_drop", "starts",
                "ends", "truncated")


def _plans(data: dict):
    return (compile_payload(SimulationPayload.from_dict(data)),
            jax_compile(JaxPayload.model_validate(data)))


def _scales(case: str) -> dict:
    g = np.random.default_rng(9)
    if case == "scaled":
        return {"hazard_scale": g.uniform(0.5, 8.0, COUNT),
                "mttr_scale": g.uniform(0.25, 3.0, COUNT)}
    if case == "scalar":
        return {"hazard_scale": 4.0, "mttr_scale": 0.5}
    return {}


def test_uniforms_are_jax_uniforms_bit_for_bit() -> None:
    got = hazards._hz_uniforms(5, 37, COUNT, 2, 8)
    want = jax_hazards._hz_uniforms(5, 37, COUNT, 2, 8)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("first", [0, 37])
@pytest.mark.parametrize("case", ["base", "scaled", "scalar"])
def test_hazard_tables_equal_the_reference(seed: int, first: int, case: str) -> None:
    plan, ref_plan = _plans(example("chaos_campaign"))
    got = hazards.hazard_fault_tables(plan, seed, first, COUNT, **_scales(case))
    want = jax_hazards.hazard_fault_tables(ref_plan, seed, first, COUNT, **_scales(case))
    for name in TABLE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.srv_times.shape == (COUNT, 17) and got.edge_lat.shape == (COUNT, 17, 6)
    horizon = float(plan.horizon)
    assert np.array_equal(
        hazards.unavailable_seconds(got.srv_times, got.srv_down, horizon),
        jax_hazards.unavailable_seconds(want.srv_times, want.srv_down, horizon))
    assert np.array_equal(hazards.degraded_seconds_mask(got, horizon, 600),
                          jax_hazards.degraded_seconds_mask(want, horizon, 600))
    for a, b in zip(hazards.window_span(got, horizon), jax_hazards.window_span(want, horizon)):
        assert np.array_equal(a, b, equal_nan=True)


def test_tables_are_prefix_stable() -> None:
    """Scenario i's windows are the same in any block that holds it."""
    plan, _ = _plans(example("chaos_campaign"))
    whole = hazards.hazard_fault_tables(plan, 3, 0, 40)
    part = hazards.hazard_fault_tables(plan, 3, 25, 15)
    for name in TABLE_FIELDS:
        assert np.array_equal(getattr(whole, name)[25:], getattr(part, name)), name


def test_every_law_and_a_static_timeline_merge_like_the_reference() -> None:
    """Normal, lognormal and exponential laws, a domain over a server and an
    edge, merged with a hand-authored outage and degrade (union, products,
    sums); and the time to drain of a synthetic series."""

    def mutate(data: dict) -> None:
        data["sim_settings"]["total_simulation_time"] = 300
        data["fault_timeline"] = {"events": [
            {"fault_id": "o", "kind": "server_outage", "target_id": "srv-1",
             "t_start": 50.0, "t_end": 80.0},
            {"fault_id": "d", "kind": "edge_degrade", "target_id": "client-srv",
             "t_start": 10.0, "t_end": 200.0, "latency_factor": 2.0, "dropout_boost": 0.1},
        ]}
        data["hazard_model"] = {"max_faults_per_component": 4, "domains": [
            {"domain_id": "a", "targets": ["srv-1", "client-srv"],
             "mtbf": {"mean": 40.0, "distribution": "normal", "variance": 10.0},
             "mttr": {"mean": 1.0, "distribution": "log_normal", "variance": 0.5},
             "latency_factor": 3.0, "dropout_boost": 0.05},
            {"domain_id": "b", "targets": ["srv-client"],
             "mtbf": {"mean": 60.0, "distribution": "exponential"},
             "mttr": {"mean": 5.0, "distribution": "exponential"},
             "dropout_boost": 0.3},
        ]}

    plan, ref_plan = _plans(load(BASE, mutate))
    got = hazards.hazard_fault_tables(plan, 2, 5, COUNT)
    want = jax_hazards.hazard_fault_tables(ref_plan, 2, 5, COUNT)
    for name in TABLE_FIELDS:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.truncated.sum() > 0  # the slot budget binds on some scenario
    g = np.random.default_rng(1)
    series = g.exponential(1.0, (COUNT, 300, 2))
    first, last = hazards.window_span(got, float(plan.horizon))
    args = (series, 0.5, first, last)
    assert np.array_equal(hazards.time_to_drain(*args), jax_hazards.time_to_drain(*args),
                          equal_nan=True)
