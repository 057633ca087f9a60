"""The port's resilience schemas and their lowering against the reference:
every valid retry policy, fault timeline and hazard model of the
reference's data loads in both packages; every case the reference refuses
the port refuses with ``PayloadError``; hedging stays refused by name; and
the compiled plans of the resilience payloads (chaos_campaign,
trace_parity_resilient, the resilience guide's outage sweep, a timeline of
overlapping edge degrades and a partition) equal the reference's field for
field, ``max_requests`` and ``breaker_lowered`` included."""

from __future__ import annotations

import copy

import numpy as np
import pytest
from pydantic import ValidationError
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    BASE,
    GUIDE_RETRY,
    LB,
    ROOT,
    example,
    load,
    mutated,
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import KERNEL_FIELDS, compile_payload
from asyncflow_tpu_torch.errors import PayloadError, UnsupportedFeatureError
from asyncflow_tpu_torch.parallel import SweepRunner
from asyncflow_tpu_torch.schemas import RetryPolicy, SimulationPayload

one_torch_thread()

ZERO_AVAILABILITY = BASE.parent / "zero_availability.yml"


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _outage_sweep(data: dict) -> None:
    """The resilience guide's runnable outage sweep (single_server.yml at
    120 s, its retry policy and an outage of srv-1 from 10 s to 25 s)."""
    data["sim_settings"]["total_simulation_time"] = 120
    data["retry_policy"] = dict(GUIDE_RETRY)
    data["fault_timeline"] = {"events": [{
        "fault_id": "crash", "kind": "server_outage", "target_id": "srv-1",
        "t_start": 10.0, "t_end": 25.0,
    }]}


def _breaker_outage(data: dict) -> None:
    """A circuit breaker on the LB (its edges without dropout) and an outage
    of a covered server: the outage is the breaker's failure channel, so the
    breaker is modelled."""
    data["topology_graph"]["nodes"]["load_balancer"]["circuit_breaker"] = {
        "failure_threshold": 3, "cooldown_s": 1.0}
    for edge in data["topology_graph"]["edges"]:
        if edge["source"] == "lb-1":
            edge["dropout_rate"] = 0.0
    data["fault_timeline"] = {"events": [{
        "fault_id": "down", "kind": "server_outage", "target_id": "srv-1",
        "t_start": 2.0, "t_end": 4.0,
    }]}


def _breaker_boost(data: dict) -> None:
    """A breaker, and a dropout boost on an LB out-edge: the other channel."""
    _breaker_outage(data)
    data["fault_timeline"]["events"][0] = {
        "fault_id": "lossy", "kind": "edge_degrade", "target_id": "lb-srv2",
        "t_start": 1.0, "t_end": 3.0, "dropout_boost": 0.2,
    }


def _breaker_slow(data: dict) -> None:
    """A breaker and a latency-only degrade of an LB out-edge: no channel,
    the breaker lowers away."""
    _breaker_boost(data)
    data["fault_timeline"]["events"][0].update(dropout_boost=0.0, latency_factor=4.0)


PAYLOADS = {
    "chaos_campaign": lambda: example("chaos_campaign"),
    "trace_parity_resilient": lambda: example("trace_parity_resilient"),
    "zero_availability": lambda: load(ZERO_AVAILABILITY),
    "outage_sweep": lambda: load(BASE, _outage_sweep),
    "resilient_edges": lambda: mutated("resilient_edges", horizon=20),
    "empty_timeline": lambda: load(BASE, lambda d: d.update(fault_timeline={"events": []})),
    "retry_one_attempt": lambda: load(BASE, lambda d: d.update(retry_policy={
        "request_timeout_s": 0.2, "max_attempts": 1, "budget_tokens": 3})),
    "breaker_outage": lambda: load(LB, _breaker_outage),
    "breaker_boost": lambda: load(LB, _breaker_boost),
    "breaker_slow": lambda: load(LB, _breaker_slow),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_resilience_plan_matches_reference(name: str) -> None:
    data = PAYLOADS[name]()
    ref = jax_compile(JaxPayload.model_validate(copy.deepcopy(data)))
    got = compile_payload(SimulationPayload.from_dict(data))
    diff = [f for f in KERNEL_FIELDS if not _equal(getattr(got, f), getattr(ref, f))]
    assert not diff, diff
    assert got.max_requests == ref.max_requests
    assert got.breaker_lowered == ref.breaker_lowered
    for flag in ("has_faults", "has_hazards", "has_retry"):
        assert getattr(got, flag) == getattr(ref, flag), flag


def test_outage_sweep_capacity_is_amplified() -> None:
    """The retry policy's attempt cap scales the capacity bound: the guide's
    sweep has 9,752 lanes, 3 attempt blocks of 3,250 on the fast path."""
    plan = compile_payload(SimulationPayload.from_dict(PAYLOADS["outage_sweep"]()))
    assert plan.max_requests == 9752
    runner = SweepRunner(PAYLOADS["outage_sweep"](), device="cpu")
    assert runner.engine_kind == "fast"
    assert (runner.engine.n, runner.engine.gen_n) == (9750, [3250])


def test_empty_timeline_is_identity() -> None:
    """``fault_timeline: {events: []}`` is valid in the reference: no fault,
    identity tables."""
    plan = compile_payload(SimulationPayload.from_dict(PAYLOADS["empty_timeline"]()))
    assert not plan.has_faults
    assert plan.fault_srv_times.tolist() == [0.0]
    assert np.all(plan.fault_edge_lat == 1.0) and np.all(plan.fault_edge_drop == 0.0)


def test_breaker_channels_decide_like_the_reference() -> None:
    """An outage on a covered server or a dropout boost on an LB edge keeps
    the breaker (the plan leaves the fast path, and the DES kernel refuses
    its faults by name); a latency-only degrade lowers it away."""
    for name, lowered in (("breaker_outage", False), ("breaker_boost", False),
                          ("breaker_slow", True)):
        plan = compile_payload(SimulationPayload.from_dict(PAYLOADS[name]()))
        assert plan.breaker_lowered == lowered, name
        assert plan.has_breaker == (not lowered), name
    with pytest.raises(UnsupportedFeatureError) as err:
        SweepRunner(PAYLOADS["breaker_outage"](), device="cpu")
    assert err.value.feature == "faults"


def test_retry_policy_defaults_and_backoff() -> None:
    policy = RetryPolicy(request_timeout_s=1.0)
    assert policy.max_attempts == 3 and policy.budget_tokens is None
    capped = RetryPolicy(request_timeout_s=1.0, backoff_base_s=0.1, backoff_multiplier=2.0,
                         backoff_cap_s=0.35, max_attempts=5)
    assert [capped.backoff_delay(a) for a in (2, 3, 4, 5)] == pytest.approx(
        [0.1, 0.2, 0.35, 0.35])


def _fault(**kw) -> dict:
    event = {"fault_id": "f", "kind": "server_outage", "target_id": "srv-1",
             "t_start": 0.0, "t_end": 1.0}
    event.update(kw)
    return event


def _domain(**kw) -> dict:
    domain = {"domain_id": "d", "targets": ["srv-1"],
              "mtbf": {"mean": 30.0, "distribution": "exponential"},
              "mttr": {"mean": 2.0, "distribution": "exponential"}}
    domain.update(kw)
    return domain


def _with(block: str, value) -> dict:
    return load(BASE, lambda d: d.update({block: value}))


#: payloads with a resilience block the reference refuses (ValidationError)
INVALID = {
    # the cases this file took over from test_torch_plan.py's refusals by
    # name: the reference refuses both dicts
    "retry_without_timeout": lambda: _with("retry_policy", {"max_attempts": 2}),
    "hazard_without_domains": lambda: _with("hazard_model", {"domains": []}),
    "retry_zero_timeout": lambda: _with("retry_policy", {"request_timeout_s": 0.0}),
    "retry_zero_attempts": lambda: _with("retry_policy", {"request_timeout_s": 1.0,
                                                          "max_attempts": 0}),
    "retry_past_the_cap": lambda: _with("retry_policy", {"request_timeout_s": 1.0,
                                                         "max_attempts": 17}),
    "retry_jitter": lambda: _with("retry_policy", {"request_timeout_s": 1.0, "jitter": 1.5}),
    "retry_multiplier": lambda: _with("retry_policy", {"request_timeout_s": 1.0,
                                                       "backoff_multiplier": 0.5}),
    "retry_budget": lambda: _with("retry_policy", {"request_timeout_s": 1.0,
                                                   "budget_tokens": 0}),
    "retry_unknown_field": lambda: _with("retry_policy", {"request_timeout_s": 1.0,
                                                          "retries": 2}),
    "retry_two_generators": lambda: mutated("two_gen_lb", horizon=5) | {
        "retry_policy": {"request_timeout_s": 1.0}},
    "fault_empty_window": lambda: _with("fault_timeline", {"events": [
        _fault(t_start=5.0, t_end=5.0)]}),
    "fault_degrade_fields_on_outage": lambda: _with("fault_timeline", {"events": [
        _fault(latency_factor=2.0)]}),
    "fault_degrade_without_fields": lambda: _with("fault_timeline", {"events": [
        _fault(kind="edge_degrade", target_id="client-srv")]}),
    "fault_duplicate_ids": lambda: _with("fault_timeline", {"events": [_fault(), _fault()]}),
    "fault_unknown_server": lambda: _with("fault_timeline", {"events": [
        _fault(target_id="no-such-server")]}),
    "fault_partition_on_a_server": lambda: _with("fault_timeline", {"events": [
        _fault(kind="edge_partition")]}),
    "fault_past_the_horizon": lambda: _with("fault_timeline", {"events": [
        _fault(t_end=1e6)]}),
    "fault_boost_above_one": lambda: _with("fault_timeline", {"events": [
        _fault(kind="edge_degrade", target_id="client-srv", dropout_boost=1.5)]}),
    "hazard_poisson_law": lambda: _with("hazard_model", {"domains": [
        _domain(mtbf={"mean": 30.0, "distribution": "poisson"})]}),
    "hazard_zero_mean": lambda: _with("hazard_model", {"domains": [
        _domain(mttr={"mean": 0.0, "distribution": "exponential"})]}),
    "hazard_no_targets": lambda: _with("hazard_model", {"domains": [_domain(targets=[])]}),
    "hazard_duplicate_targets": lambda: _with("hazard_model", {"domains": [
        _domain(targets=["srv-1", "srv-1"])]}),
    "hazard_duplicate_domains": lambda: _with("hazard_model", {"domains": [
        _domain(), _domain()]}),
    "hazard_unknown_target": lambda: _with("hazard_model", {"domains": [
        _domain(targets=["nowhere"])]}),
    "hazard_edge_without_degrade": lambda: _with("hazard_model", {"domains": [
        _domain(targets=["client-srv"])]}),
    "hazard_too_many_slots": lambda: _with("hazard_model", {
        "domains": [_domain()], "max_faults_per_component": 65}),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_resilience_blocks_are_refused(case: str) -> None:
    data = INVALID[case]()
    with pytest.raises(ValidationError):
        JaxPayload.model_validate(copy.deepcopy(data))
    with pytest.raises(PayloadError) as err:
        SimulationPayload.from_dict(data)
    assert not isinstance(err.value, UnsupportedFeatureError)


def test_overlapping_fault_windows_are_legal() -> None:
    """Overlapping windows, and outages darkening every server at once,
    validate in both packages (the reference refuses neither)."""
    data = mutated("resilient_edges", horizon=20)
    data["fault_timeline"]["events"] += [
        _fault(fault_id="a", target_id="srv-1", t_start=1.0, t_end=4.0),
        _fault(fault_id="b", target_id="srv-1", t_start=2.0, t_end=5.0),
        _fault(fault_id="c", target_id="srv-2", t_start=2.0, t_end=5.0),
    ]
    JaxPayload.model_validate(copy.deepcopy(data))
    plan = compile_payload(SimulationPayload.from_dict(data))
    assert plan.fault_srv_down.max(axis=1).tolist().count(1) >= 1


def test_hedge_policy_is_still_refused_by_name() -> None:
    with pytest.raises(UnsupportedFeatureError) as err:
        SimulationPayload.from_dict(_with("hedge_policy", {"hedge_delay_s": 0.05}))
    assert err.value.feature == "hedge_policy"
    assert "ROADMAP.md" in str(err.value)


def test_chip_smoke_resilience_literals_equal_their_sources() -> None:
    """chip_smoke.py's resilience payloads (PyYAML may be missing on the
    card's machine) equal the YAML files, and the guide's outage sweep."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.CHAOS_CAMPAIGN == example("chaos_campaign")
    assert smoke.TRACE_PARITY_RESILIENT == example("trace_parity_resilient")
    assert smoke.OUTAGE_RETRY == PAYLOADS["outage_sweep"]()
    axes = smoke.FAST_SWEEP_AXES["outage_retry"](4)
    assert axes["fault_shift"].tolist() == [0.0, 30.0, 60.0, 90.0]
