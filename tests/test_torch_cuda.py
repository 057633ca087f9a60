"""Tests of the port that need a CUDA card (marker ``cuda``).

They skip without one.  This file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).
"""

from __future__ import annotations

import pytest
import torch

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import des_kernel
from asyncflow_tpu_torch.engines.torchsim.des_reference import des_reference
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.parallel import SweepRunner
from asyncflow_tpu_torch.schemas import SimulationPayload


def _exp(mean: float) -> dict:
    return {"mean": mean, "distribution": "exponential"}


def _payload(*, lb: str | None = None, ram_mb=1024, ram=64, io=0.02) -> dict:
    """~7.5 req/s into one server, or through an LB into two."""
    servers = [
        {
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
        for sid in (("s1", "s2") if lb else ("s1",))
    ]
    nodes = {"client": {"id": "c"}, "servers": servers}
    if lb:
        nodes["load_balancer"] = {"id": "lb", "algorithms": lb,
                                  "server_covered": ["s1", "s2"]}
        edges = [("g-c", "g", "c"), ("c-lb", "c", "lb"), ("lb-s1", "lb", "s1"),
                 ("lb-s2", "lb", "s2"), ("s1-c", "s1", "c"), ("s2-c", "s2", "c")]
    else:
        edges = [("g-c", "g", "c"), ("c-s", "c", "s1"), ("s-c", "s1", "c")]
    return {
        "rqs_input": {
            "id": "g",
            "avg_active_users": {"mean": 15},
            "avg_request_per_minute_per_user": {"mean": 30},
            "user_sampling_window": 4,
        },
        "topology_graph": {
            "nodes": nodes,
            "edges": [{"id": e, "source": a, "target": b, "latency": _exp(0.003)}
                      for e, a, b in edges],
        },
        "sim_settings": {"total_simulation_time": 8, "sample_period_s": 0.01},
    }


def _lc_mixed() -> dict:
    data = _payload(lb="least_connection")
    edges = data["topology_graph"]["edges"]
    edges[1]["latency"] = {"mean": 0.002, "distribution": "normal", "variance": 0.001}
    edges[2]["latency"] = {"mean": 0.001, "distribution": "log_normal", "variance": 0.1}
    edges[3]["latency"] = {"mean": 0.003, "distribution": "uniform"}
    edges[4]["latency"] = {"mean": 0.002, "distribution": "poisson"}
    edges[5]["dropout_rate"] = 0.1
    return data


def _event_inj() -> dict:
    """Two spikes and one outage per server inside the 8 s."""
    data = _payload(lb="round_robin")

    def window(eid, target, t0, t1, spike=None):
        start = {"kind": "server_down", "t_start": t0}
        end = {"kind": "server_up", "t_end": t1}
        if spike is not None:
            start = {"kind": "network_spike_start", "t_start": t0, "spike_s": spike}
            end = {"kind": "network_spike_end", "t_end": t1}
        return {"event_id": eid, "target_id": target, "start": start, "end": end}

    data["events"] = [
        window("spike-c-lb", "c-lb", 1.0, 3.0, 0.015),
        window("s1-down", "s1", 2.0, 4.0),
        window("spike-lb-s2", "lb-s2", 4.0, 6.0, 0.02),
        window("s2-down", "s2", 5.0, 7.0),
    ]
    return data


def _controls_breaker(lb: str) -> dict:
    """Every overload control and the LB breaker at once."""
    data = _payload(lb=lb)
    data["rqs_input"]["avg_active_users"] = {"mean": 60}
    s1, s2 = data["topology_graph"]["nodes"]["servers"]
    s1["overload"] = {"max_ready_queue": 2, "max_connections": 6, "queue_timeout_s": 0.02}
    s2["overload"] = {"rate_limit_rps": 3.0, "rate_limit_burst": 3}
    data["topology_graph"]["nodes"]["load_balancer"]["circuit_breaker"] = {
        "failure_threshold": 3, "cooldown_s": 1.0, "half_open_probes": 2,
    }
    return data


def _events_and_controls() -> dict:
    """The outages and spikes with every control and the breaker."""
    data = _controls_breaker("least_connection")
    data["events"] = _event_inj()["events"]
    return data


def _steps(*steps: tuple) -> list:
    kinds = {"cpu": ("initial_parsing", "cpu_time"), "io": ("io_wait", "io_waiting_time"),
             "db": ("io_db", "io_waiting_time")}
    out = []
    for kind, value, *extra in steps:
        name, op = kinds.get(kind, (kind, "io_waiting_time"))
        fields = extra[0] if extra else {}
        out.append({"kind": name, "step_operation": {op: value}, **fields})
    return out


CACHE_STEP = ("io_cache", 0.002, {"cache_hit_probability": 0.8, "cache_miss_time": 0.05})
LLM_STEP = ("io_llm", 0.004, {"llm_tokens_mean": 40.0, "llm_time_per_token": 0.0005,
                              "llm_cost_per_token": 0.01})


def _workload(steps: list, *, users=15, pool=None) -> dict:
    """One server running ``steps``, ``users`` x 30 req/min, 8 s."""
    data = _payload()
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["endpoints"][0]["steps"] = steps
    if pool is not None:
        srv["server_resources"]["db_connection_pool"] = pool
    data["rqs_input"]["avg_active_users"] = {"mean": users}
    return data


def _cache() -> dict:
    return _workload(_steps(("cpu", 0.002), CACHE_STEP), users=30)


def _llm() -> dict:
    return _workload(_steps(("cpu", 0.002), LLM_STEP), users=30)


def _db_pool(pool: int) -> dict:
    """~10 req/s through a 60 ms query on ``pool`` connections."""
    return _workload(_steps(("cpu", 0.002), ("db", 0.06)), users=20, pool=pool)


def _featured() -> dict:
    """A DB pool of 2, a cache mixture, an LLM call and weighted endpoints."""
    data = _workload(_steps(("cpu", 0.002), CACHE_STEP, ("db", 0.02)), users=25, pool=2)
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["endpoints"][0]["selection_weight"] = 3.0
    srv["endpoints"].append({"endpoint_name": "llm", "steps": _steps(LLM_STEP)})
    return data


def _two_gen(data: dict | None = None, *, normal_entry=False) -> dict:
    """A second stream (10 users x 60 req/min, window 4 s) on its own
    exponential entry edge; the first enters over a normal edge when asked."""
    data = data if data is not None else _payload(lb="round_robin")
    client = data["topology_graph"]["nodes"]["client"]["id"]
    data["rqs_input"] = [data["rqs_input"], {
        "id": "g2",
        "avg_active_users": {"mean": 10},
        "avg_request_per_minute_per_user": {"mean": 60},
        "user_sampling_window": 4,
    }]
    data["topology_graph"]["edges"].append(
        {"id": "g2-c", "source": "g2", "target": client, "latency": _exp(0.004)},
    )
    if normal_entry:
        data["topology_graph"]["edges"][0]["latency"] = {
            "mean": 0.004, "distribution": "normal", "variance": 0.002,
        }
    return data


#: the workload group's cases: (name, payload, iteration cap or None)
WORKLOAD_CASES = {
    "cache": (_cache, None),
    "llm": (_llm, None),
    "db_pool_k2": (lambda: _db_pool(2), None),
    "db_pool_k1": (lambda: _db_pool(1), None),
    "featured_truncated": (_featured, 200),
    "two_gen": (_two_gen, None),
    "two_gen_normal_entry": (lambda: _two_gen(normal_entry=True), None),
    "two_gen_events_controls": (lambda: _two_gen(_events_and_controls()), None),
}


#: plans forced to a pool size, with the placement the kernel takes for it:
#: a binding RAM whose grant cascades tie, on a pool that is no multiple of
#: 32 and on one of 16 slots a lane; and a pool too large for its scanned
#: fields to fit a scenario's share of shared memory
POOL_CASES = {
    "pool_not_multiple_of_32": (lambda: _payload(ram_mb=256, ram=128, io=0.25), 37,
                                "scan_shared"),
    "pool_scan_shared": (lambda: _payload(ram_mb=256, ram=128, io=0.25), 512, "scan_shared"),
    "pool_global": (lambda: _payload(lb="least_connection"), 2048, "global"),
}


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    ("name", "data", "pool_size"),
    [
        ("round_robin", _payload(lb="round_robin"), None),
        ("lc_mixed", _lc_mixed(), None),
        ("ram_overflow", _payload(ram_mb=256, ram=128, io=0.25), 2),
        ("event_inj", _event_inj(), None),
        ("controls_breaker_rr", _controls_breaker("round_robin"), None),
        ("controls_breaker_lc", _controls_breaker("least_connection"), None),
        ("controls_events", _events_and_controls(), None),
        *((name, make(), pool) for name, (make, pool, _) in POOL_CASES.items()),
    ],
)
def test_kernel_matches_twin_on_cuda(cuda_device, name, data, pool_size) -> None:
    """The CUDA kernel and its twin, both on the card: bit-exact integers,
    float moments within rtol 1e-6."""
    plan = compile_payload(SimulationPayload.from_dict(data), pool_size=pool_size)
    eng = KernelEngine(plan, device=cuda_device)
    args = eng.prepare(scenario_keys(3, 64, device=cuda_device))
    got = eng.kernel(*args)
    want = des_reference(*args)
    for field in ("hist", "thr", "momi", "trunc", "n_events", "work"):
        assert torch.equal(getattr(got, field), getattr(want, field)), (name, field)
    torch.testing.assert_close(got.momf, want.momf, rtol=1e-6, atol=0.0)
    assert eng.kernel.launches == 1
    if name == "ram_overflow":
        assert int(got.momi[:, 3].sum()) > 0
    if name in POOL_CASES:
        assert des_kernel.launch_layout(args[0])["placement"] == POOL_CASES[name][2]
    if name.startswith("controls"):
        assert int(got.momi[:, 4].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WORKLOAD_CASES))
def test_workload_kernel_matches_twin_on_cuda(cuda_device, name) -> None:
    """The workload group's instances against the twin on the card: every
    integer output bit-exact, ``work`` included, and the float moments
    (LLM cost too) equal to the last bit."""
    import dataclasses

    make, cap = WORKLOAD_CASES[name]
    plan = compile_payload(SimulationPayload.from_dict(make()))
    if cap is not None:
        plan = dataclasses.replace(plan, max_iterations=cap)
    eng = KernelEngine(plan, device=cuda_device)
    args = eng.prepare(scenario_keys(3, 64, device=cuda_device))
    got = eng.kernel(*args)
    want = des_reference(*args)
    for field in ("hist", "thr", "momi", "trunc", "n_events", "work"):
        assert torch.equal(getattr(got, field), getattr(want, field)), (name, field)
    assert torch.equal(got.momf, want.momf), name
    assert eng.kernel.launches == 1
    if cap is not None:
        assert bool(got.trunc.all())


@pytest.mark.cuda
def test_sweep_defaults_to_cuda_and_launches_the_kernel(cuda_device) -> None:
    runner = SweepRunner(_payload(lb="round_robin"), engine="kernel")
    assert runner.device.type == "cuda"
    report = runner.run(96, seed=1, chunk_size=64)
    assert runner.engine.kernel.launches == 2
    summary = report.summary()
    assert summary["completed_total"] > 0
    assert summary["truncated_total"] == 0
