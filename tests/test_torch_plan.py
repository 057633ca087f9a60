"""The port's schemas and compiler against the JAX reference.

``compile_payload`` of both packages must agree field by field on every
field the DES kernel reads; ``plan_from_arrays`` carries a reference plan
across; every feature outside the slice is refused by name.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import pytest
import yaml
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import KERNEL_FIELDS, compile_payload, plan_from_arrays
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.errors import PayloadError, UnsupportedFeatureError
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "examples" / "yaml_input" / "data"


def _yaml(name: str) -> dict:
    return yaml.safe_load((DATA / name).read_text())


def _lc_mixed() -> dict:
    """Least-connection LB over normal, lognormal, uniform and Poisson edges."""
    data = _yaml("two_servers_lb.yml")
    data["sim_settings"]["total_simulation_time"] = 8
    data["topology_graph"]["nodes"]["load_balancer"]["algorithms"] = "least_connection"
    edges = data["topology_graph"]["edges"]
    edges[1]["latency"] = {"mean": 0.002, "distribution": "normal", "variance": 0.001}
    edges[2]["latency"] = {"mean": 0.001, "distribution": "log_normal", "variance": 0.1}
    edges[3]["latency"] = {"mean": 0.003, "distribution": "uniform"}
    edges[4]["latency"] = {"mean": 0.002, "distribution": "poisson"}
    edges[5]["dropout_rate"] = 0.05
    data["rqs_input"]["avg_active_users"] = {"mean": 20, "distribution": "normal",
                                             "variance": 4}
    return data


def _ram_bound() -> dict:
    """One server whose RAM admits two requests at a time, two endpoints
    with unequal weights and a multi-segment program."""
    data = _yaml("single_server.yml")
    data["sim_settings"]["total_simulation_time"] = 8
    data["rqs_input"]["avg_active_users"] = {"mean": 40}
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["server_resources"] = {"cpu_cores": 1, "ram_mb": 256}
    ep = srv["endpoints"][0]
    ep["steps"][1]["step_operation"] = {"necessary_ram": 128}
    ep["steps"].append(
        {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.002}},
    )
    ep["selection_weight"] = 3.0
    other = copy.deepcopy(ep)
    other["endpoint_name"] = "ep-2"
    other["selection_weight"] = 1.0
    other["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.001}},
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.001}},
        {"kind": "io_db", "step_operation": {"io_waiting_time": 0.02}},
    ]
    srv["endpoints"].append(other)
    return data


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _controlled(overload: dict, *, users: int, cpu: float, io: float = 0.010) -> dict:
    """One server, a CPU then an IO step, under an overload policy (the
    reference's parity fixture ``_controlled``)."""
    data = _yaml("single_server.yml")
    data["sim_settings"]["total_simulation_time"] = 10
    data["rqs_input"]["avg_active_users"] = {"mean": users}
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": cpu}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": io}},
    ]
    srv["overload"] = overload
    return data


def _lowered_controls() -> dict:
    """Every control configured far above the load, so the compiler lowers
    each away (the connection cap through its bisection), and a breaker
    with no failure channel left, which lowers away too."""
    data = _yaml("two_servers_lb.yml")
    _server(data)["overload"] = {
        "max_ready_queue": 200, "max_connections": 5000,
        "rate_limit_rps": 2000.0, "rate_limit_burst": 400, "queue_timeout_s": 5.0,
    }
    for edge in data["topology_graph"]["edges"]:
        if edge["source"] == "lb-1":
            edge["dropout_rate"] = 0.0
    data["topology_graph"]["nodes"]["load_balancer"]["circuit_breaker"] = {
        "failure_threshold": 3, "cooldown_s": 1.0,
    }
    return data


PAYLOADS = {
    "two_servers_lb": lambda: _yaml("two_servers_lb.yml"),
    "single_server": lambda: _yaml("single_server.yml"),
    "lc_mixed": _lc_mixed,
    "ram_bound": _ram_bound,
    "event_inj_lb": lambda: _yaml("event_inj_lb.yml"),
    "resilience_all": lambda: _smoke().RESILIENCE_ALL,
    "queue_cap": lambda: _controlled({"max_ready_queue": 3}, users=40, cpu=0.040),
    "conn_cap": lambda: _controlled({"max_connections": 4}, users=40, cpu=0.002, io=0.2),
    "rate_limit": lambda: _controlled(
        {"rate_limit_rps": 6.0, "rate_limit_burst": 6}, users=30, cpu=0.002,
    ),
    "queue_timeout": lambda: _controlled({"queue_timeout_s": 0.120}, users=45, cpu=0.045),
    "lowered_controls": _lowered_controls,
}


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_compile_payload_matches_reference(name: str) -> None:
    data = PAYLOADS[name]()
    ref = jax_compile(JaxPayload.model_validate(data))
    got = compile_payload(SimulationPayload.from_dict(data))
    diff = [f for f in KERNEL_FIELDS if not _equal(getattr(got, f), getattr(ref, f))]
    assert diff == []
    assert got.unsupported == ()


def test_controls_are_modelled_or_lowered_as_the_reference_decides() -> None:
    """The fixtures reach both sides of every non-binding proof."""
    plans = {name: compile_payload(SimulationPayload.from_dict(PAYLOADS[name]()))
             for name in ("queue_cap", "conn_cap", "rate_limit", "queue_timeout",
                          "lowered_controls", "resilience_all", "event_inj_lb")}
    assert plans["queue_cap"].has_queue_cap
    assert plans["conn_cap"].has_conn_cap
    assert plans["rate_limit"].has_rate_limit
    assert plans["queue_timeout"].has_queue_timeout
    low = plans["lowered_controls"]
    assert not (low.has_queue_cap or low.has_conn_cap or low.has_rate_limit
                or low.has_queue_timeout or low.has_breaker)
    assert low.breaker_lowered
    assert 1.0 < low.proof_rate_headroom < np.inf
    res = plans["resilience_all"]
    assert res.has_rate_limit and res.has_queue_timeout and res.breaker_threshold == 5
    ev = plans["event_inj_lb"]
    assert ev.has_timeline and ev.has_spikes
    assert ev.timeline_slot.tolist() == [0, 0, 1, 1]


def test_plan_from_arrays_round_trips_a_reference_plan() -> None:
    data = _lc_mixed()
    ref = jax_compile(JaxPayload.model_validate(data))
    carried = plan_from_arrays(vars(ref))
    local = compile_payload(SimulationPayload.from_dict(data))
    assert carried.unsupported == ()
    for field in KERNEL_FIELDS:
        assert _equal(getattr(carried, field), getattr(local, field)), field
    # a copy, not a view of the reference's arrays
    carried.seg_dur[...] = 0
    assert np.any(ref.seg_dur != 0)


def test_chip_smoke_literal_equals_the_yaml() -> None:
    assert _smoke().TWO_SERVERS_LB == _yaml("two_servers_lb.yml")


def _with(mutate) -> dict:
    data = _yaml("two_servers_lb.yml")
    mutate(data)
    return data


def _server(data) -> dict:
    return data["topology_graph"]["nodes"]["servers"][0]


def _step(data) -> dict:
    return _server(data)["endpoints"][0]["steps"][2]


def _lb_node(data) -> dict:
    return data["topology_graph"]["nodes"]["load_balancer"]


UNSUPPORTED = {
    "brownout_queue_threshold": lambda d: _server(d).update(overload={
        "max_ready_queue": 4, "brownout_queue_threshold": 2, "brownout_cpu_factor": 0.5,
    }),
    "hedge_policy": lambda d: d.update(hedge_policy={"delay_s": 0.05}),
    "replay": lambda d: d["rqs_input"].update(replay={"times": [0.1]}),
    "serving": lambda d: _server(d).update(serving={"max_batch_tokens": 64}),
    "health": lambda d: _lb_node(d).update(health={"alpha": 0.2}),
    "health_on_breaker_lb": lambda d: _lb_node(d).update(
        circuit_breaker={"failure_threshold": 3, "cooldown_s": 1.0},
        health={"alpha": 0.2},
    ),
    "llm_serve": lambda d: _step(d).update(kind="llm_serve"),
}


def _reference_plan(data: dict):
    return jax_compile(JaxPayload.model_validate(data))


#: plans of the reference with a feature the port refuses (the kernel's
#: first refusal is the case's name); cache, LLM, DB pool and
#: multi-generator plans are accepted (tests/test_torch_plan_workload.py)
REFERENCE_PLANS = {
    "brownout": lambda: _reference_plan(_with(UNSUPPORTED["brownout_queue_threshold"])),
    "faults": lambda: _reference_plan(_yaml("trace_parity_resilient.yml")),
    "hazards": lambda: _reference_plan(_yaml("chaos_campaign.yml")),
    "health": lambda: _reference_plan(_with(
        lambda d: _lb_node(d).update(health={"ewma_alpha": 0.2}))),
    "replay": lambda: _reference_plan(_with(UNSUPPORTED["replay"])),
    "retry": lambda: _reference_plan(_with(
        lambda d: d.update(retry_policy={"max_attempts": 2, "request_timeout_s": 0.5}))),
    "serving": lambda: _reference_plan(_yaml("serving_parity.yml")),
}
#: the feature each refusal case names, where the case id is not the name
FEATURE_OF = {"health_on_breaker_lb": "health"}


@pytest.mark.parametrize(
    ("where", "case"),
    [("payload", f) for f in sorted(UNSUPPORTED)]
    + [("plan", f) for f in sorted(REFERENCE_PLANS)],
)
def test_unsupported_feature_is_refused_by_name(where: str, case: str) -> None:
    with pytest.raises(UnsupportedFeatureError) as err:
        if where == "payload":
            SimulationPayload.from_dict(_with(UNSUPPORTED[case]))
        else:
            KernelEngine(plan_from_arrays(vars(REFERENCE_PLANS[case]())), device="cpu")
    assert err.value.feature == FEATURE_OF.get(case, case)
    assert "ROADMAP.md" in str(err.value)


@pytest.mark.parametrize(
    "mutate",
    [
        lambda d: d["rqs_input"].update(unknown_field=1),
        lambda d: d["topology_graph"]["edges"][0].update(dropout_rate=1.5),
        lambda d: d["topology_graph"]["edges"][0]["latency"].update(mean=0),
        lambda d: _server(d)["server_resources"].update(ram_mb=128),
        lambda d: d["sim_settings"].update(total_simulation_time=2),
        lambda d: _step(d).update(step_operation={"cpu_time": 0.01}),
        lambda d: d["topology_graph"]["edges"].append(dict(
            d["topology_graph"]["edges"][0], id="dup-source", target="lb-1")),
        lambda d: d["rqs_input"]["avg_request_per_minute_per_user"].update(
            distribution="normal"),
    ],
    ids=["unknown", "dropout", "latency", "ram", "horizon", "operation", "fanout",
         "rate"],
)
def test_invalid_payloads_are_rejected(mutate) -> None:
    with pytest.raises(PayloadError):
        SimulationPayload.from_dict(_with(mutate))


def _outage(eid: str, target: str, t0: float, t1: float) -> dict:
    return {"event_id": eid, "target_id": target,
            "start": {"kind": "server_down", "t_start": t0},
            "end": {"kind": "server_up", "t_end": t1}}


@pytest.mark.parametrize(
    ("events", "match"),
    [
        ([_outage("a", "srv-1", 10.0, 20.0), _outage("b", "srv-2", 15.0, 25.0)],
         "all servers are down"),
        ([_outage("a", "srv-1", 10.0, 20.0), _outage("b", "srv-1", 15.0, 25.0)],
         "Overlapping events for server 'srv-1'"),
        ([{"event_id": "a", "target_id": "srv-1",
           "start": {"kind": "network_spike_start", "t_start": 1.0, "spike_s": 0.01},
           "end": {"kind": "network_spike_end", "t_end": 2.0}}],
         "regarding an edge does not have a compatible target id"),
        ([_outage("a", "srv-1", 10.0, 700.0)], "exceeds simulation horizon"),
    ],
    ids=["all_down", "overlap", "spike_on_server", "past_horizon"],
)
def test_invalid_events_are_rejected_as_the_reference_does(events, match) -> None:
    """Each case trips the same validator, with the same message, in both
    packages."""
    import pydantic

    data = _with(lambda d: d.update(events=events))
    with pytest.raises(pydantic.ValidationError, match=match):
        JaxPayload.model_validate(data)
    with pytest.raises(PayloadError, match=match):
        SimulationPayload.from_dict(data)


def test_back_to_back_outages_are_legal() -> None:
    """END before START on ties: one window may end when the next starts."""
    data = _with(lambda d: d.update(events=[
        _outage("a", "srv-1", 10.0, 20.0), _outage("b", "srv-2", 20.0, 30.0),
        _outage("c", "srv-1", 30.0, 40.0),
    ]))
    plan = compile_payload(SimulationPayload.from_dict(data))
    ref = jax_compile(JaxPayload.model_validate(data))
    assert plan.timeline_down.tolist() == ref.timeline_down.tolist() == [1, 0, 1, 0, 1, 0]
