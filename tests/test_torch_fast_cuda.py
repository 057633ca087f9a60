"""The fast path's kernels against their plain versions on a CUDA card
(marker ``cuda``; skipped without one).  This file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fast_cuda.py

Every comparison is exact: kernel and plain version run on the same card,
one float operation at a time (the kernels are built with --fmad=false).
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import draws, station_scan
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.engines.torchsim.sampling import (
    D_EXPONENTIAL,
    D_LOGNORMAL,
    D_NORMAL,
    D_UNIFORM,
)
from asyncflow_tpu_torch.parallel import SweepRunner
from asyncflow_tpu_torch.schemas import SimulationPayload

S, N = 64, 20_011
DIST = np.array([D_UNIFORM, D_EXPONENTIAL, D_NORMAL, D_LOGNORMAL], np.int32)


@pytest.fixture
def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _edge_params(dev):
    g = np.random.default_rng(5)
    mean = torch.tensor(g.uniform(0.001, 0.01, (S, 4)), dtype=torch.float32, device=dev)
    var = torch.tensor(g.uniform(0.0005, 0.3, (S, 4)), dtype=torch.float32, device=dev)
    drop = torch.tensor(np.tile([0.0, 0.05, 0.0, 0.2], (S, 1)), dtype=torch.float32,
                        device=dev)
    return mean, var, drop


@pytest.mark.cuda
def test_edge_draws_match_plain_on_cuda(cuda_device) -> None:
    kernel, plain = draws.EdgeDraws(), draws.PlainEdgeDraws()
    keys = scenario_keys(21, S, device=cuda_device)
    assert torch.equal(kernel.uniform(keys, N), plain.uniform(keys, N))
    uk, zk = draws.hop_keys(keys, 32)
    mean, var, drop = _edge_params(cuda_device)
    eidx = torch.tensor(np.random.default_rng(1).integers(0, 4, (S, N)), dtype=torch.int32,
                        device=cuda_device)
    shared = plain.uniform(scenario_keys(22, S, device=cuda_device), N)
    cases = [{"edge": e} for e in range(4)] + [{"eidx": eidx}, {"eidx": eidx, "u": shared}]
    for kw in cases:
        got = kernel.hop(uk, zk, DIST, mean, var, drop, N, **kw)
        want = plain.hop(uk, zk, DIST, mean, var, drop, N, **kw)
        assert torch.equal(got[0], want[0]), kw.keys()
        assert torch.equal(got[1], want[1]), kw.keys()
    assert kernel.launches == 1 + len(cases)


#: rows of the scan tests: a warp of 32 rows a block, the last one part-full
ROWS = 45


def _stream(dev, seed: int, m: int, rate: float, svc: float):
    g = np.random.default_rng(seed)
    a = np.cumsum(g.exponential(1.0 / rate, (ROWS, m)), axis=1).astype(np.float32)
    d = g.exponential(svc, (ROWS, m)).astype(np.float32)
    v = g.random((ROWS, m)) > 0.33
    v[:, -50:] = False
    a[:, -50:] = 1e30
    return (torch.tensor(x, device=dev) for x in (a, d, v))


@pytest.mark.cuda
@pytest.mark.parametrize("cores", [1, 4, station_scan.REG_CORES, station_scan.REG_CORES + 1])
def test_station_waits_match_plain_on_cuda(cuda_device, cores: int) -> None:
    """c = 1, core vectors in registers, and one past them (global
    scratch)."""
    # rows of 2001: each row starts at another offset from a 16-byte boundary
    a, d, v = _stream(cuda_device, 3, 2001, rate=40.0 * cores, svc=0.02)
    kernel = station_scan.StationScan()
    got = kernel.waits(a, d, v, cores)
    assert torch.equal(got, station_scan.PlainStationScan().waits(a, d, v, cores))
    assert kernel.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize(("ram_k", "cores"), [
    (20, 1), (6, 2), (station_scan.REG_SLOTS, station_scan.REG_CORES),
    (station_scan.REG_SLOTS + 1, 2), (20, station_scan.REG_CORES + 1), (100, 1),
])
def test_ram_core_matches_plain_on_cuda(cuda_device, ram_k: int, cores: int) -> None:
    """Carries in registers (the first three, the third at both limits) and
    in global scratch (one past either limit, and a wide one)."""
    a, d, v = _stream(cuda_device, 4, 1501, rate=60.0, svc=0.01)
    pre = torch.full_like(a, 0.001)
    post = torch.tensor(
        np.random.default_rng(9).exponential(1.5 * ram_k / 60.0, tuple(a.shape)),
        dtype=torch.float32, device=cuda_device,
    )
    kernel = station_scan.StationScan()
    got = kernel.ram_core(a, pre, d, post, v, ram_k, cores)
    want = station_scan.PlainStationScan().ram_core(a, pre, d, post, v, ram_k, cores)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert float(want[0][v].max()) > 0.0


def _single_server() -> dict:
    exp = {"mean": 0.003, "distribution": "exponential"}
    return {
        "rqs_input": {"id": "g", "avg_active_users": {"mean": 100},
                      "avg_request_per_minute_per_user": {"mean": 20},
                      "user_sampling_window": 10},
        "topology_graph": {
            "nodes": {"client": {"id": "c"}, "servers": [{
                "id": "s1", "server_resources": {"cpu_cores": 1, "ram_mb": 2048},
                "endpoints": [{"endpoint_name": "ep", "steps": [
                    {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.001}},
                    {"kind": "ram", "step_operation": {"necessary_ram": 100}},
                    {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.1}},
                ]}],
            }]},
            "edges": [{"id": e, "source": a, "target": b, "latency": exp}
                      for e, a, b in (("g-c", "g", "c"), ("c-s", "c", "s1"),
                                      ("s-c", "s1", "c"))],
        },
        "sim_settings": {"total_simulation_time": 30, "sample_period_s": 0.05},
    }


def _two_core_multi_burst() -> dict:
    data = _single_server()
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["server_resources"]["cpu_cores"] = 2
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.004}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.01}},
        {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.003}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.02}},
    ]
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_single_server, _two_core_multi_burst])
def test_fast_engine_kernels_match_plain_on_cuda(cuda_device, make) -> None:
    """The whole engine on the card, once through the kernels and once
    through their plain versions on the same inputs: every integer output
    and every completed request's clock identical."""
    plan = compile_payload(SimulationPayload.from_dict(make()))
    eng = FastEngine(plan, device=cuda_device, collect_clocks=True)
    keys = scenario_keys(5, 16, device=cuda_device)
    got = eng.run_tensors(keys)
    assert eng.draws.launches > 0 and eng.scan.launches > 0
    plain = copy.copy(eng)
    plain.draws, plain.scan = draws.PlainEdgeDraws(), station_scan.PlainStationScan()
    want = plain.run_tensors(keys)
    for field in ("hist", "thr", "lat_count", "n_generated", "n_dropped", "n_overflow",
                  "clock", "lat_sum", "gauge_means"):
        assert torch.equal(got[field], want[field]), field


@pytest.mark.cuda
def test_sweep_auto_takes_the_fast_path_on_cuda(cuda_device) -> None:
    runner = SweepRunner(_single_server())
    assert runner.engine_kind == "fast" and runner.device.type == "cuda"
    summary = runner.run(32, seed=1, chunk_size=16).summary()
    assert runner.engine.draws.launches > 0 and runner.engine.scan.launches == 2
    assert summary["completed_total"] > 0
