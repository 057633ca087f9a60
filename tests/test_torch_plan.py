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

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import KERNEL_FIELDS, compile_payload, plan_from_arrays
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.errors import PayloadError, UnsupportedFeatureError
from asyncflow_tpu_torch.schemas import SimulationPayload

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


PAYLOADS = {
    "two_servers_lb": lambda: _yaml("two_servers_lb.yml"),
    "single_server": lambda: _yaml("single_server.yml"),
    "lc_mixed": _lc_mixed,
    "ram_bound": _ram_bound,
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
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.TWO_SERVERS_LB == _yaml("two_servers_lb.yml")


def _with(mutate) -> dict:
    data = _yaml("two_servers_lb.yml")
    mutate(data)
    return data


def _server(data) -> dict:
    return data["topology_graph"]["nodes"]["servers"][0]


def _step(data) -> dict:
    return _server(data)["endpoints"][0]["steps"][2]


UNSUPPORTED = {
    "events": lambda d: d.update(events=[{
        "event_id": "out", "target_id": "srv-1",
        "start": {"kind": "server_down", "t_start": 1.0},
        "end": {"kind": "server_up", "t_end": 2.0},
    }]),
    "retry_policy": lambda d: d.update(retry_policy={"max_attempts": 2}),
    "fault_timeline": lambda d: d.update(fault_timeline={"events": []}),
    "hedge_policy": lambda d: d.update(hedge_policy={"delay_s": 0.05}),
    "hazard_model": lambda d: d.update(hazard_model={"domains": []}),
    "multi_generator": lambda d: d.update(
        rqs_input=[d["rqs_input"], {**d["rqs_input"], "id": "rqs-2"}],
    ),
    "replay": lambda d: d["rqs_input"].update(replay={"times": [0.1]}),
    "overload": lambda d: _server(d).update(overload={"max_ready_queue": 4}),
    "serving": lambda d: _server(d).update(serving={"max_batch_tokens": 64}),
    "db_connection_pool": lambda d: _server(d)["server_resources"].update(
        db_connection_pool=2,
    ),
    "circuit_breaker": lambda d: d["topology_graph"]["nodes"]["load_balancer"].update(
        circuit_breaker={"failure_threshold": 3, "cooldown_s": 1.0},
    ),
    "health": lambda d: d["topology_graph"]["nodes"]["load_balancer"].update(
        health={"alpha": 0.2},
    ),
    "cache_hit_probability": lambda d: _step(d).update(
        kind="io_cache", cache_hit_probability=0.9, cache_miss_time=0.05,
    ),
    "llm_tokens_mean": lambda d: _step(d).update(
        kind="io_llm", llm_tokens_mean=20.0, llm_time_per_token=0.01,
        llm_cost_per_token=1.0,
    ),
    "llm_serve": lambda d: _step(d).update(kind="llm_serve"),
}


def _timeline_plan():
    return jax_compile(JaxPayload.model_validate(_yaml("event_inj_lb.yml")))


def _cache_plan():
    data = _yaml("two_servers_lb.yml")
    _step(data).update(kind="io_cache", cache_hit_probability=0.9, cache_miss_time=0.05)
    return jax_compile(JaxPayload.model_validate(data))


REFERENCE_PLANS = {"timeline": _timeline_plan, "cache": _cache_plan}


@pytest.mark.parametrize(
    ("where", "feature"),
    [("payload", f) for f in sorted(UNSUPPORTED)]
    + [("plan", f) for f in sorted(REFERENCE_PLANS)],
)
def test_unsupported_feature_is_refused_by_name(where: str, feature: str) -> None:
    with pytest.raises(UnsupportedFeatureError) as err:
        if where == "payload":
            SimulationPayload.from_dict(_with(UNSUPPORTED[feature]))
        else:
            KernelEngine(plan_from_arrays(vars(REFERENCE_PLANS[feature]())), device="cpu")
    assert err.value.feature == feature
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
