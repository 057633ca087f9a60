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
    for field in ("hist", "thr", "momi", "trunc", "n_events"):
        assert torch.equal(getattr(got, field), getattr(want, field)), (name, field)
    torch.testing.assert_close(got.momf, want.momf, rtol=1e-6, atol=0.0)
    assert eng.kernel.launches == 1
    if pool_size:
        assert int(got.momi[:, 3].sum()) > 0


@pytest.mark.cuda
def test_sweep_defaults_to_cuda_and_launches_the_kernel(cuda_device) -> None:
    runner = SweepRunner(_payload(lb="round_robin"))
    assert runner.device.type == "cuda"
    report = runner.run(96, seed=1, chunk_size=64)
    assert runner.engine.kernel.launches == 2
    summary = report.summary()
    assert summary["completed_total"] > 0
    assert summary["truncated_total"] == 0
