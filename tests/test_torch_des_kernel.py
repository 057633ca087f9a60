"""The DES kernel's plain twin against the reference Pallas kernel.

Both packages run the same payload on the same scenario keys and the same
arrival-rate table (drawn by the reference engine's own ``_lam_table`` and
injected into the port), the reference through
``PallasEngine(plan, block=8, interpret=True)``, the port through
``KernelEngine(plan, device="cpu")`` (the twin).  Every draw is threefry at
the same counters, so the outputs agree exactly unless a float32 ``log``,
``exp`` or ``cos`` rounds differently in XLA and in torch on the CPU (about
one result in seven differs by one ulp; a latency that sits on a histogram
bin edge then moves one bin).  Stated tolerance: integer outputs equal in at
least S - 1 of S scenarios, pooled counts equal within 1, float moments
within rtol 1e-4.  Agreement seen when this was written: integer outputs
equal in every scenario of every case, and the float moments within 2e-7
relative (``lat_sumsq`` by one ulp, where XLA fuses the multiply-add); on
slice 2's cases (event injection, the four overload controls, the RR and
LC breakers) integers equal everywhere too, and the moments within 5.5e-7
relative.

The CUDA kernel itself is held to the twin on the card
(``tests/test_torch_cuda.py``, and phase 2 of ``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import yaml
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_scenario_keys
from asyncflow_tpu.engines.jaxsim.pallas_engine import PallasEngine
from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base_overrides
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

S = 8
DATA = Path(__file__).resolve().parents[1] / "examples" / "yaml_input" / "data"
MOMENT_RTOL = 1e-4
INT_FIELDS = ("hist", "thr", "lat_count", "n_generated", "n_dropped", "n_overflow",
              "n_rejected", "truncated")
FLOAT_FIELDS = ("lat_sum", "lat_sumsq", "lat_min", "lat_max")


def _edge(eid, src, dst, latency, dropout=0.01) -> dict:
    return {"id": eid, "source": src, "target": dst, "latency": latency,
            "dropout_rate": dropout}


def _exp(mean: float) -> dict:
    return {"mean": mean, "distribution": "exponential"}


def _server(sid: str, *, ram_mb=1024, ram=64, io=0.02) -> dict:
    return {
        "id": sid,
        "server_resources": {"cpu_cores": 1, "ram_mb": ram_mb},
        "endpoints": [{
            "endpoint_name": "ep",
            "steps": [
                {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.004}},
                {"kind": "ram", "step_operation": {"necessary_ram": ram}},
                {"kind": "io_wait", "step_operation": {"io_waiting_time": io}},
            ],
        }],
    }


def _single(horizon=8, **server) -> dict:
    return {
        "rqs_input": {
            "id": "g",
            "avg_active_users": {"mean": 15},
            "avg_request_per_minute_per_user": {"mean": 30},
            "user_sampling_window": 4,
        },
        "topology_graph": {
            "nodes": {"client": {"id": "c"}, "servers": [_server("s1", **server)]},
            "edges": [
                _edge("g-c", "g", "c", _exp(0.003)),
                _edge("c-s", "c", "s1", _exp(0.003)),
                _edge("s-c", "s1", "c", _exp(0.003)),
            ],
        },
        "sim_settings": {"total_simulation_time": horizon, "sample_period_s": 0.01},
    }


def _lb(algorithm="round_robin", horizon=8) -> dict:
    data = _single(horizon)
    nodes = data["topology_graph"]["nodes"]
    nodes["servers"].append(_server("s2"))
    nodes["load_balancer"] = {"id": "lb", "algorithms": algorithm,
                              "server_covered": ["s1", "s2"]}
    data["topology_graph"]["edges"] = [
        _edge("g-c", "g", "c", _exp(0.003)),
        _edge("c-lb", "c", "lb", _exp(0.002)),
        _edge("lb-s1", "lb", "s1", _exp(0.002)),
        _edge("lb-s2", "lb", "s2", _exp(0.002)),
        _edge("s1-c", "s1", "c", _exp(0.003)),
        _edge("s2-c", "s2", "c", _exp(0.003)),
    ]
    return data


def _lc_mixed() -> dict:
    data = _lb("least_connection")
    data["rqs_input"]["avg_active_users"] = {"mean": 15, "distribution": "normal",
                                             "variance": 4}
    edges = data["topology_graph"]["edges"]
    edges[1]["latency"] = {"mean": 0.002, "distribution": "normal", "variance": 0.001}
    edges[2]["latency"] = {"mean": 0.001, "distribution": "log_normal", "variance": 0.1}
    edges[3]["latency"] = {"mean": 0.003, "distribution": "uniform"}
    edges[4]["latency"] = {"mean": 0.002, "distribution": "poisson"}
    edges[5]["dropout_rate"] = 0.1
    return data


def _ram_bound() -> dict:
    """RAM admits two requests at a time; offered load ~95% of that."""
    return _single(ram_mb=256, ram=128, io=0.25)


def _event_inj(horizon: float = 8.0) -> dict:
    """event_inj_lb.yml cut to ``horizon`` seconds, its five windows scaled
    into the first 7/8 of the cut (three spikes, one outage per server)."""
    data = yaml.safe_load((DATA / "event_inj_lb.yml").read_text())
    scale = 0.875 * horizon / data["sim_settings"]["total_simulation_time"]
    data["sim_settings"]["total_simulation_time"] = horizon
    for event in data["events"]:
        event["start"]["t_start"] *= scale
        event["end"]["t_end"] *= scale
    return data


def _controlled(overload: dict, *, users: int, cpu: float, io: float = 0.010) -> dict:
    """One server with a CPU then an IO step under an overload policy
    (the reference's parity fixture ``_controlled``), 6 s."""
    data = _single(horizon=6)
    data["rqs_input"]["avg_active_users"] = {"mean": users}
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": cpu}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": io}},
    ]
    srv["overload"] = overload
    return data


CONTROLS = {
    "queue_cap": lambda: _controlled({"max_ready_queue": 3}, users=40, cpu=0.040),
    "conn_cap": lambda: _controlled({"max_connections": 4}, users=40, cpu=0.002, io=0.2),
    "rate_limit": lambda: _controlled(
        {"rate_limit_rps": 6.0, "rate_limit_burst": 6}, users=30, cpu=0.002,
    ),
    "queue_timeout": lambda: _controlled({"queue_timeout_s": 0.120}, users=45, cpu=0.045),
}


def _breaker(algorithm: str) -> dict:
    """A rate-limited s2 in the rotation trips the LB breaker (the
    reference's ``test_circuit_breaker_parity`` fixture, 8 s, 60 users)."""
    data = _lb(algorithm)
    data["rqs_input"]["avg_active_users"] = {"mean": 60}
    data["topology_graph"]["edges"][3]["latency"] = {
        "mean": 0.002, "distribution": "normal", "variance": 0.001,
    }
    data["topology_graph"]["nodes"]["servers"][1]["overload"] = {
        "rate_limit_rps": 4.0, "rate_limit_burst": 4,
    }
    data["topology_graph"]["nodes"]["load_balancer"]["circuit_breaker"] = {
        "failure_threshold": 5, "cooldown_s": 2.0, "half_open_probes": 2,
    }
    return data


def _lc_breaker_outage() -> dict:
    """Least connection with the breaker, the rate-limited s2 and one s1
    outage: the LC branch of the breaker's pick, and a slot removed from
    an LC rotation."""
    data = _breaker("least_connection")
    lb = data["topology_graph"]["nodes"]["load_balancer"]
    lb["circuit_breaker"] = {"failure_threshold": 3, "cooldown_s": 1.0,
                             "half_open_probes": 2}
    data["events"] = [{
        "event_id": "s1-down", "target_id": "s1",
        "start": {"kind": "server_down", "t_start": 2.0},
        "end": {"kind": "server_up", "t_end": 3.5},
    }]
    return data


def _run_both(data: dict, *, pool_size=None, max_iterations=None):
    jplan = jax_compile(JaxPayload.model_validate(data))
    tplan = compile_payload(SimulationPayload.from_dict(data), pool_size=pool_size)
    if max_iterations is not None:
        jplan = dataclasses.replace(jplan, max_iterations=max_iterations)
        tplan = dataclasses.replace(tplan, max_iterations=max_iterations)
    ref = PallasEngine(jplan, block=S, pool_size=pool_size, interpret=True)
    keys = jax_scenario_keys(2, S)
    ov = jax_base_overrides(jplan)
    lam = np.asarray(ref._lam_table(keys, ov.user_mean, ov.req_rate))
    want = ref.run_batch(keys)
    got = KernelEngine(tplan, device="cpu").run_batch(
        np.asarray(keys), lam_table=lam,
    )
    return want, got


def _assert_agree(want, got) -> None:
    rows_equal = np.ones(S, bool)
    for field in INT_FIELDS:
        a = np.asarray(getattr(want, field)).reshape(S, -1)
        b = np.asarray(getattr(got, field)).reshape(S, -1)
        rows_equal &= (a == b).all(axis=1)
        pooled = int(a.astype(np.int64).sum()) - int(b.astype(np.int64).sum())
        assert abs(pooled) <= 1, field
    assert rows_equal.sum() >= S - 1, rows_equal
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, field), getattr(want, field), rtol=MOMENT_RTOL, err_msg=field,
        )


def test_round_robin_matches_reference() -> None:
    want, got = _run_both(_lb())
    _assert_agree(want, got)
    assert want.lat_count.min() > 0


def test_least_connection_mixed_distributions_match_reference() -> None:
    want, got = _run_both(_lc_mixed())
    _assert_agree(want, got)
    assert want.n_dropped.sum() > 0


def test_binding_ram_matches_reference() -> None:
    want, got = _run_both(_ram_bound())
    _assert_agree(want, got)
    # RAM waits stretch the tail well past the 0.26 s unqueued residence
    assert float(np.max(want.lat_max)) > 0.4


def test_overflow_matches_reference() -> None:
    want, got = _run_both(_ram_bound(), pool_size=2)
    _assert_agree(want, got)
    assert want.n_overflow.sum() > 0


def test_truncation_matches_reference() -> None:
    want, got = _run_both(_lb(horizon=5), max_iterations=40)
    _assert_agree(want, got)
    assert want.truncated.all()


def test_conservation_and_events() -> None:
    """generated = completed + dropped + overflow + rejected + in flight,
    with in flight bounded by the pool; every scenario simulated events."""
    plan = compile_payload(SimulationPayload.from_dict(_lb()))
    state = KernelEngine(plan, device="cpu").run_batch(scenario_keys(4, S))
    slack = (state.n_generated - state.lat_count - state.n_dropped
             - state.n_overflow - state.n_rejected)
    assert (slack >= 0).all()
    assert (slack <= plan.pool_size).all()
    assert (state.n_events > state.n_generated).all()


def test_event_injection_matches_reference() -> None:
    """Three spikes and two outages inside an 8 s cut of event_inj_lb.yml:
    the timeline pops, the slot removals and re-insertions, and the spike
    breakpoints on the entry chain, the LB edge and an exit edge."""
    data = _event_inj()
    want, got = _run_both(data)
    _assert_agree(want, got)
    last = max(e["end"]["t_end"] for e in data["events"])
    # every scenario completes requests after the last window closed
    assert (want.thr[:, int(np.ceil(last)):].sum(axis=1) > 0).all()
    assert want.n_dropped.sum() > 0


@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_overload_control_matches_reference(name: str) -> None:
    want, got = _run_both(CONTROLS[name]())
    _assert_agree(want, got)
    assert want.n_rejected.sum() > 0


@pytest.mark.parametrize(
    "make", [lambda: _breaker("round_robin"), _lc_breaker_outage],
    ids=["rr_breaker", "lc_breaker_outage"],
)
def test_circuit_breaker_matches_reference(make) -> None:
    want, got = _run_both(make())
    _assert_agree(want, got)
    assert want.n_rejected.sum() > 0


def test_conservation_with_rejections() -> None:
    """generated = completed + dropped + overflow + rejected + in flight
    under every overload control and the breaker at once."""
    data = _breaker("round_robin")
    data["topology_graph"]["nodes"]["servers"][0]["overload"] = {
        "max_ready_queue": 2, "max_connections": 6, "queue_timeout_s": 0.02,
    }
    plan = compile_payload(SimulationPayload.from_dict(data))
    assert plan.has_queue_cap and plan.has_conn_cap and plan.has_queue_timeout
    state = KernelEngine(plan, device="cpu").run_batch(scenario_keys(4, S))
    slack = (state.n_generated - state.lat_count - state.n_dropped
             - state.n_overflow - state.n_rejected)
    assert state.n_rejected.sum() > 0
    assert (slack >= 0).all()
    assert (slack <= plan.pool_size).all()
