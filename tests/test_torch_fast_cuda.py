"""The fast path's kernels against their plain versions on a CUDA card
(marker ``cuda``; skipped without one).  This file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fast_cuda.py

Every comparison is exact: kernel and plain version run on the same card,
one float operation at a time (the kernels are built with --fmad=false),
and sum in the same order.
"""

from __future__ import annotations

import copy
import ctypes

import numpy as np
import pytest
import torch

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import draws, routing, station_scan
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
    """Every mode on rows of 20,011 lanes (most rows start unaligned):
    uniforms and gaps, the gaps' prefix sum, the gap of each of the 2**23
    uniforms, the hop over each static edge and over three LB slots, with
    and without spikes."""
    kernel, plain = draws.EdgeDraws(), draws.PlainEdgeDraws()
    keys = scenario_keys(21, S, device=cuda_device)
    assert torch.equal(kernel.uniform(keys, N), plain.uniform(keys, N))
    assert torch.equal(kernel.uniform(keys, N, gap=True), plain.uniform(keys, N, gap=True))
    assert torch.equal(kernel.gap_cumsum(keys, N), plain.gap_cumsum(keys, N))
    u = torch.arange(2**23, dtype=torch.float64, device=cuda_device).div(2**23).float()
    assert torch.equal(kernel.gap_of(u.view(8, -1)), plain.gap_of(u.view(8, -1)))
    launches = kernel.launches
    uk, zk = draws.hop_keys(keys, 32)
    mean, var, drop = _edge_params(cuda_device)
    g = np.random.default_rng(1)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32, device=cuda_device)
    alive = torch.tensor(g.random((S, N)) > 0.1, device=cuda_device)
    rank = torch.tensor(g.permuted(np.tile(np.arange(N), (S, 1)), axis=1), device=cuda_device)
    slot = torch.tensor(np.where(g.random((S, N)) < 0.1, -1, g.integers(0, 3, (S, N))),
                        dtype=torch.int32, device=cuda_device)
    spike_t = torch.tensor([0.0, 0.5, 1.5], device=cuda_device)
    spike_v = torch.zeros((3, 4), device=cuda_device)
    spike_v[1, 1], spike_v[1, 3], spike_v[2, 3] = 0.25, 0.125, 0.5
    hops = 0
    for spikes in (False, True):
        tables = draws.EdgeTables(
            dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
            lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32, device=cuda_device),
            lb_target=torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda_device),
            spike_t=spike_t if spikes else None, spike_v=spike_v if spikes else None,
        )
        for kw in [{"edge": e} for e in range(4)] + [{"rank": rank}, {"slot": slot}]:
            got = kernel.hop(tables, t_send, alive, uk, zk, **kw)
            want = plain.hop(tables, t_send, alive, uk, zk, **kw)
            for x, y in zip(got, want, strict=True):
                assert (x is None and y is None) or torch.equal(x, y), (spikes, kw.keys())
            hops += 1
    assert kernel.launches == launches + hops


#: (rows, lanes a row) of the hop checks: 17 rows (every row residue mod
#: 16) of widths 1, 3, 8 and 15 mod 16, two past a block of 2048 lanes, then
#: event_inj_lb's and lc_mixed_fleet's widths
HOP_WIDTHS = [(17, 17), (17, 2051), (17, 40), (17, 4111), (17, 28_323), (17, 20_035)]


def _spikes(dev):
    spike_t = torch.tensor([0.0, 0.5, 1.5], device=dev)
    spike_v = torch.zeros((3, 4), device=dev)
    spike_v[1, 1], spike_v[1, 3], spike_v[2, 3] = 0.25, 0.125, 0.5
    return spike_t, spike_v


@pytest.mark.cuda
@pytest.mark.parametrize(("rows", "n"), HOP_WIDTHS)
def test_hop_widths_match_plain_on_cuda(cuda_device, rows: int, n: int) -> None:
    """At each of HOP_WIDTHS, with spikes: the LB hop by slot (three slots,
    a tenth of the lanes -1), every static edge's hop and least
    connections' candidates over three slots: every output identical, the
    spans too."""
    kernel, plain = draws.EdgeDraws(), draws.PlainEdgeDraws()
    keys = scenario_keys(25, rows, device=cuda_device)
    uk, zk = draws.hop_keys(keys, 32)
    mean, var, drop = (x[:rows] for x in _edge_params(cuda_device))
    g = np.random.default_rng(4)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (rows, n)), dtype=torch.float32,
                          device=cuda_device)
    alive = torch.tensor(g.random((rows, n)) > 0.1, device=cuda_device)
    slot = torch.tensor(np.where(g.random((rows, n)) < 0.1, -1, g.integers(0, 3, (rows, n))),
                        dtype=torch.int32, device=cuda_device)
    spike_t, spike_v = _spikes(cuda_device)
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32, device=cuda_device),
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda_device),
        spike_t=spike_t, spike_v=spike_v,
    )
    for kw in [{"slot": slot}] + [{"edge": e} for e in range(4)]:
        got = kernel.hop(tables, t_send, alive, uk, zk, **kw)
        want = plain.hop(tables, t_send, alive, uk, zk, **kw)
        for x, y in zip(got, want, strict=True):
            assert (x is None and y is None) or torch.equal(x, y), kw.keys()
    uks, zks = (torch.stack(x, dim=1) for x in zip(*(draws.hop_keys(keys, 32 + k)
                                                     for k in range(3))))
    got = kernel.candidates(tables, t_send, alive, uks, zks, [3, 1, 2])
    want = plain.candidates(tables, t_send, alive, uks, zks, [3, 1, 2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernel.launches == 6 and kernel.cand_launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("faults", ["none", "staged", "global"])
@pytest.mark.parametrize("slots", [1, 2, 3, 32])
def test_candidates_match_plain_on_cuda(cuda_device, slots: int, faults: str) -> None:
    """Least connections' candidates in one launch over 1 to 32 slots
    (every law among their edges), with spikes, without fault tables and
    under shared ones (staged in shared memory) or 20,000 breakpoints a
    scenario (read in global memory): t_next and ok (S, n, slots)
    identical to the stacked hops without sums."""
    kernel, plain = draws.EdgeDraws(), draws.PlainEdgeDraws()
    keys = scenario_keys(26, S, device=cuda_device)
    mean, var, drop = _edge_params(cuda_device)
    g = np.random.default_rng(8)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32, device=cuda_device)
    alive = torch.tensor(g.random((S, N)) > 0.1, device=cuda_device)
    fault = {}
    if faults == "staged":
        fault = {"fault_t": torch.tensor([0.0, 0.3, 0.5, 0.7], device=cuda_device),
                 "fault_lat": torch.tensor(g.uniform(0.5, 3.0, (4, 4)), dtype=torch.float32,
                                           device=cuda_device),
                 "fault_drop": torch.tensor(g.uniform(-0.1, 0.6, (4, 4)), dtype=torch.float32,
                                            device=cuda_device)}
    elif faults == "global":
        times = np.sort(g.integers(0, 1127, (S, 20_000)), axis=1).astype(np.float32) / 512
        times[:, 0] = 0.0
        fault = {"fault_t": torch.tensor(times, device=cuda_device),
                 "fault_lat": torch.tensor(g.uniform(0.5, 3.0, (S, 20_000, 4)),
                                           dtype=torch.float32, device=cuda_device),
                 "fault_drop": torch.tensor(g.uniform(-0.1, 0.6, (S, 20_000, 4)),
                                            dtype=torch.float32, device=cuda_device)}
    spike_t, spike_v = _spikes(cuda_device)
    tables = draws.EdgeTables(dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
                              spike_t=spike_t, spike_v=spike_v, **fault)
    edges = [(3 + k) % 4 for k in range(slots)]
    uks, zks = (torch.stack(x, dim=1) for x in zip(*(draws.hop_keys(keys, 32 + k)
                                                     for k in range(slots))))
    got = kernel.candidates(tables, t_send, alive, uks, zks, edges)
    want = plain.candidates(tables, t_send, alive, uks, zks, edges)
    assert got[0].shape == (S, N, slots)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernel.cand_launches == kernel.launches == 1
    assert kernel.fault_launches == (0 if faults == "none" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 17, 4096, 4097, 70_000, 87_840])
def test_gap_cumsum_matches_plain_on_cuda(cuda_device, n: int) -> None:
    """The gaps' prefix sum, one launch a call (a block a row), over one to
    five levels of XLA's scan: a zero, then the sums, bit for bit."""
    kernel, plain = draws.EdgeDraws(), draws.PlainEdgeDraws()
    keys = scenario_keys(22, S, device=cuda_device)
    got = kernel.gap_cumsum(keys, n)
    assert kernel.launches == 1
    assert got.shape == (S, n + 1)
    assert torch.equal(got, plain.gap_cumsum(keys, n))


@pytest.mark.cuda
@pytest.mark.parametrize("marks", [
    ([], [], []),
    ([0.4, 0.9, 1.2, 1.6], [1, 0, 1, 0], [0, 0, 2, 2]),
    ([0.3, 0.5, 0.5, 0.8, 0.8, 1.4, 1.4], [1, 1, 1, 0, 0, 0, 1], [1, 0, 2, 0, 2, 1, 0]),
    ([-1.0, 0.2, 0.2, 0.6, 1.0, 5.0], [1, 0, 1, 1, 0, 1], [2, 1, 2, -1, 0, 1]),
    # more marks than the count kernel holds in one pass, two at one time
    ([0.05 * k + (0.0 if k % 5 else 0.025) for k in range(21)] + [1.025, 1.025],
     [1, 0] * 11 + [1], [k % 3 for k in range(21)] + [1, 2]),
])
def test_lb_route_matches_plain_on_cuda(cuda_device, marks) -> None:
    """Both lb_route kernels on rows of 20,011 lanes (three count blocks a
    row; a tenth dead, ties with the marks) against the segment form: every
    mark case, an all-down interval, same-time marks and more marks than
    one counting pass holds among them."""
    from asyncflow_tpu_torch.engines.torchsim.sortutil import time_rank

    g = np.random.default_rng(6)
    t = torch.tensor(np.round(g.uniform(0.0, 2.0, (S, N)), 3), dtype=torch.float32,
                     device=cuda_device)
    t[:, :7] = 0.5
    alive = torch.tensor(g.random((S, N)) > 0.1, device=cuda_device)
    tl = routing.Timeline(*marks, 3, cuda_device)
    kernel, plain = routing.LbRoute(), routing.PlainLbRoute()
    table = kernel.table(tl, t, alive)
    assert torch.equal(table, plain.table(tl, t, alive))
    rank = time_rank(t, alive)
    got = kernel.slots(table, rank, alive)
    assert torch.equal(got, plain.slots(table, rank, alive))
    assert kernel.launches == 2
    assert bool((got[alive] >= 0).any())


#: rows of the scan tests: blocks of 4 rows (warp walk) and 16 (thread
#: walk), the last one part-full
ROWS = 45


def _stream(dev, seed: int, m: int, rate: float, svc: float):
    g = np.random.default_rng(seed)
    a = np.cumsum(g.exponential(1.0 / rate, (ROWS, m)), axis=1).astype(np.float32)
    d = g.exponential(svc, (ROWS, m)).astype(np.float32)
    v = g.random((ROWS, m)) > 0.33
    v[:, -50:] = False
    a[:, -50:] = 1e30
    return (torch.tensor(x, device=dev) for x in (a, d, v))


def _walk(mode: int, cores: int, ram_k: int, cap: int = -1) -> str:
    return station_scan.WALK_NAMES[station_scan.walk_of(mode, cores, ram_k, cap)]


@pytest.mark.cuda
def test_station_walks_on_cuda(cuda_device) -> None:
    """The card's library runs the warp walk over 32 lanes and holds each
    carry vector as ``carry_form`` says: whole on every lane up to
    WHOLE_MAX entries, else spread over the lanes."""
    lib = station_scan._library()
    for fn in ("station_scan_lanes", "station_scan_lane_entries", "station_scan_lane_span",
               "station_scan_warp_width_max"):
        getattr(lib, fn).restype = ctypes.c_int
    assert lib.station_scan_lanes() == station_scan.WARP_LANES
    assert lib.station_scan_warp_width_max() == station_scan.WARP_WIDTH_MAX
    for width in (1, 2, 3, 4, 5, 31, 32, 33, 64, 65, 1024):
        form = (lib.station_scan_lane_entries(width), lib.station_scan_lane_span(width))
        assert form == station_scan.carry_form(width)


@pytest.mark.cuda
@pytest.mark.parametrize("cores", [1, 2, 4, 5, 8, 9, 33, station_scan.WARP_WIDTH_MAX + 1])
def test_station_waits_match_plain_on_cuda(cuda_device, cores: int) -> None:
    """c = 1 (a thread a row), the warp walk at the edges of its width
    classes (whole on every lane up to 4 cores, then spread over the lanes
    one, two, ... entries a lane), and one core past it (global scratch)."""
    # rows of 2001: each row starts at another offset from a 16-byte boundary;
    # the widest station is loaded past its cores, so that it queues at all
    rate = (40.0 if cores <= station_scan.WARP_WIDTH_MAX else 200.0) * cores
    a, d, v = _stream(cuda_device, 3, 2001, rate=rate, svc=0.02)
    kernel = station_scan.StationScan()
    got = kernel.waits(a, d, v, cores)
    want = station_scan.PlainStationScan().waits(a, d, v, cores)
    assert torch.equal(got, want)
    assert float(want[v].max()) > 0.0
    assert kernel.launches == 1
    mode = station_scan.MODE_LINDLEY if cores == 1 else station_scan.MODE_KW
    assert kernel.walk_launches[_walk(mode, cores, 0)] == 1


@pytest.mark.cuda
@pytest.mark.parametrize(("ram_k", "cores"), [
    (1, 1), (4, 4), (5, 5), (20, 1), (6, 2), (31, 1), (32, 8), (33, 2), (64, 1), (65, 9),
    (100, 1), (station_scan.WARP_WIDTH_MAX, 1), (20, 33),
    (8, station_scan.WARP_WIDTH_MAX + 1),
])
def test_ram_core_matches_plain_on_cuda(cuda_device, ram_k: int, cores: int) -> None:
    """The warp walk at the edges of its width classes for either vector,
    up to its widest, and a core vector past it (global scratch)."""
    # rows of 4001: 1024 slots fill within a row's ~2,670 valid lanes
    a, d, v = _stream(cuda_device, 4, 4001, rate=60.0, svc=0.01)
    pre = torch.full_like(a, 0.001)
    # residence about 1.5x what the slots hold at the valid lanes' rate
    post = torch.tensor(
        np.random.default_rng(9).exponential(1.5 * ram_k / 40.0, tuple(a.shape)),
        dtype=torch.float32, device=cuda_device,
    )
    kernel = station_scan.StationScan()
    got = kernel.ram_core(a, pre, d, post, v, ram_k, cores)
    want = station_scan.PlainStationScan().ram_core(a, pre, d, post, v, ram_k, cores)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert float(want[0][v].max()) > 0.0
    assert kernel.walk_launches[_walk(station_scan.MODE_RAM_CORE, cores, ram_k)] == 1


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


def _db_and_cache() -> dict:
    """A DB pool of 2 held 60 ms and a cache before it (~20 req/s)."""
    data = _single_server()
    data["rqs_input"]["avg_active_users"]["mean"] = 60
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["server_resources"]["db_connection_pool"] = 2
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "io_cache", "step_operation": {"io_waiting_time": 0.002},
         "cache_hit_probability": 0.8, "cache_miss_time": 0.030},
        {"kind": "io_db", "step_operation": {"io_waiting_time": 0.060}},
    ]
    return data


def _two_streams_outage() -> dict:
    """Two servers behind round robin, srv-1 down from 10 s to 20 s, and a
    second stream entering over its own edge."""
    exp = {"mean": 0.002, "distribution": "exponential"}
    servers = [{
        "id": sid, "server_resources": {"cpu_cores": 1, "ram_mb": 2048},
        "endpoints": [{"endpoint_name": "ep", "steps": [
            {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
            {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.012}},
        ]}],
    } for sid in ("srv-1", "srv-2")]
    edges = [("g-c", "g", "c"), ("g2-c", "g2", "c"), ("c-lb", "c", "lb"),
             ("lb-1", "lb", "srv-1"), ("lb-2", "lb", "srv-2"), ("s1-c", "srv-1", "c"),
             ("s2-c", "srv-2", "c")]
    return {
        "rqs_input": [
            {"id": "g", "avg_active_users": {"mean": 100},
             "avg_request_per_minute_per_user": {"mean": 20}, "user_sampling_window": 10},
            {"id": "g2", "avg_active_users": {"mean": 50},
             "avg_request_per_minute_per_user": {"mean": 40}, "user_sampling_window": 5},
        ],
        "topology_graph": {
            "nodes": {"client": {"id": "c"}, "servers": servers,
                      "load_balancer": {"id": "lb", "algorithms": "round_robin",
                                        "server_covered": ["srv-1", "srv-2"]}},
            "edges": [{"id": e, "source": a, "target": b, "latency": exp}
                      for e, a, b in edges],
        },
        "sim_settings": {"total_simulation_time": 30, "sample_period_s": 0.05},
        "events": [{"event_id": "o1", "target_id": "srv-1",
                    "start": {"kind": "server_down", "t_start": 10.0},
                    "end": {"kind": "server_up", "t_end": 20.0}}],
    }


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_single_server, _two_core_multi_burst, _db_and_cache,
                                  _two_streams_outage])
def test_fast_engine_kernels_match_plain_on_cuda(cuda_device, make) -> None:
    """The whole engine on the card, once through the kernels and once
    through their plain versions on the same inputs: every integer output
    and every completed request's clock identical."""
    plan = compile_payload(SimulationPayload.from_dict(make()))
    eng = FastEngine(plan, device=cuda_device, collect_clocks=True)
    keys = scenario_keys(5, 16, device=cuda_device)
    got = eng.run_tensors(keys)
    assert eng.draws.launches > 0 and eng.scan.launches > 0
    assert eng.route.launches == (2 if plan.has_timeline else 0)
    plain = copy.copy(eng)
    plain.draws, plain.scan = draws.PlainEdgeDraws(), station_scan.PlainStationScan()
    plain.route = routing.PlainLbRoute()
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


#: duplicate breakpoints of the "duplicates" tables: before the base row at
#: each index, that many decoy rows at its time (a factor of 5 and a boost
#: of 0.4 on every edge), never read: at a duplicate time the last row holds
FAULT_DECOYS = {1: 1, 4: 2, 6: 1}


@pytest.mark.cuda
@pytest.mark.parametrize(("per_row", "duplicates"), [
    pytest.param(per_row, dup, id=f"{per_row}" + ("-duplicates" if dup else ""))
    for dup in (False, True) for per_row in (False, True)
])
def test_fault_hop_matches_plain_on_cuda(cuda_device, per_row: bool, duplicates: bool) -> None:
    """The hop under edge fault tables (shared or a row a scenario: a
    partition of edge 1, overlapping degrades of edge 3, a degrade of edge 2
    from t = 0; with and without duplicate breakpoint times) over each
    static edge, three LB slots by rank and by slot, with spikes, eight
    sends a breakpoint exactly on the scenario's breakpoint times: every
    output identical."""
    kernel, plain = draws.EdgeDraws(), draws.PlainEdgeDraws()
    keys = scenario_keys(22, S, device=cuda_device)
    uk, zk = draws.hop_keys(keys, 32)
    mean, var, drop = _edge_params(cuda_device)
    g = np.random.default_rng(3)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32, device=cuda_device)
    alive = torch.tensor(g.random((S, N)) > 0.1, device=cuda_device)
    rank = torch.tensor(g.permuted(np.tile(np.arange(N), (S, 1)), axis=1), device=cuda_device)
    slot = torch.tensor(g.integers(0, 3, (S, N)), dtype=torch.int32, device=cuda_device)
    times = torch.tensor([0.0, 0.3, 0.5, 0.7, 0.9, 1.1, 1.6], device=cuda_device)
    lat = torch.ones((7, 4), device=cuda_device)
    boost = torch.zeros((7, 4), device=cuda_device)
    boost[1:3, 1] = 1.0
    lat[2:5, 3] *= 3.0
    boost[2:5, 3] += 0.2
    lat[4:6, 3] *= 1.5
    boost[4:6, 3] += 0.3
    lat[:, 2], boost[:, 2] = 2.0, 0.1
    if duplicates:
        keep = [i for i in range(7) for _ in range(FAULT_DECOYS.get(i, 0) + 1)]
        decoy = torch.tensor([j + 1 < len(keep) and keep[j + 1] == keep[j]
                              for j in range(len(keep))], device=cuda_device)
        times, lat, boost = times[keep], lat[keep].clone(), boost[keep].clone()
        lat[decoy], boost[decoy] = 5.0, 0.4
    nf = int(times.shape[0])
    if per_row:
        times = torch.clamp_min(times + 0.05 * torch.arange(S, device=cuda_device)[:, None], 0.0)
        times[:, 0] = 0.0
        lat = (lat * (1.0 + torch.rand((S, 1, 1), device=cuda_device))).contiguous()
        boost = boost.expand(S, nf, 4).contiguous()
    t_send[:, : 8 * nf] = times.expand(S, nf).repeat(1, 8)  # on the breakpoints
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32, device=cuda_device),
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda_device),
        spike_t=torch.tensor([0.0, 0.5, 1.5], device=cuda_device),
        spike_v=torch.full((3, 4), 0.125, device=cuda_device),
        fault_t=times, fault_lat=lat, fault_drop=boost,
    )
    for kw in [{"edge": e} for e in range(4)] + [{"rank": rank}, {"slot": slot}]:
        got = kernel.hop(tables, t_send, alive, uk, zk, **kw)
        want = plain.hop(tables, t_send, alive, uk, zk, **kw)
        for x, y in zip(got, want, strict=True):
            assert (x is None and y is None) or torch.equal(x, y), kw.keys()
    assert kernel.fault_launches == kernel.launches == 6


@pytest.mark.cuda
@pytest.mark.parametrize(("nf", "per_row"), [(300, False), (20_000, True)])
def test_wide_fault_tables_match_plain_on_cuda(cuda_device, nf: int, per_row: bool) -> None:
    """The LB hop by rank under fault tables of hundreds and of tens of
    thousands of breakpoints (on a grid of 1/512 s, so many repeat; the
    second past the hop's shared memory, searched in global memory), a
    send on every eighth breakpoint: every output identical."""
    kernel, plain = draws.EdgeDraws(), draws.PlainEdgeDraws()
    uk, zk = draws.hop_keys(scenario_keys(24, S, device=cuda_device), 32)
    mean, var, drop = _edge_params(cuda_device)
    g = np.random.default_rng(9)
    rows = S if per_row else 1
    times = np.sort(g.integers(0, 1127, (rows, nf)), axis=1).astype(np.float32) / 512
    times[:, 0] = 0.0
    lat = g.uniform(0.5, 3.0, (rows, nf, 4)).astype(np.float32)
    boost = g.uniform(-0.1, 0.6, (rows, nf, 4)).astype(np.float32)
    if not per_row:
        times, lat, boost = times[0], lat[0], boost[0]
    fault_t, fault_lat, fault_drop = (torch.tensor(x, device=cuda_device)
                                      for x in (times, lat, boost))
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32, device=cuda_device)
    on = fault_t.expand(S, nf)[:, ::8][:, : N // 2]
    t_send[:, : on.shape[1]] = on  # on the breakpoints
    alive = torch.tensor(g.random((S, N)) > 0.1, device=cuda_device)
    rank = torch.tensor(g.permuted(np.tile(np.arange(N), (S, 1)), axis=1), device=cuda_device)
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32, device=cuda_device),
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda_device),
        fault_t=fault_t, fault_lat=fault_lat, fault_drop=fault_drop,
    )
    got = kernel.hop(tables, t_send, alive, uk, zk, rank=rank)
    want = plain.hop(tables, t_send, alive, uk, zk, rank=rank)
    for x, y in zip(got, want, strict=True):
        assert (x is None and y is None) or torch.equal(x, y)
    assert kernel.fault_launches == kernel.launches == 1


#: (lanes, spike breakpoints, fault breakpoints, lanes a row) of the wide
#: spike tables' cases, each placed in the hop's 48 KiB of shared memory as
#: named (as in test_torch_fast_host.WIDE_SPIKES): the LB hop by slot with
#: its spikes staged, in global memory, and staged pushing 300 shared fault
#: breakpoints into global memory; the static hop and the candidates (two
#: slots) with their spikes in global memory, and staged pushing the fault
#: tables out; the last on rows of a multiple of 4 lanes (the static hop's
#: consecutive lanes a thread)
WIDE_SPIKES = [
    pytest.param("slot", 300, 0, 4111, id="slot-staged"),
    pytest.param("slot", 6000, 0, 4111, id="slot-global"),
    pytest.param("slot", 2000, 300, 4111, id="slot-staged-faults_global"),
    pytest.param("edge", 6000, 0, 4111, id="static-global"),
    pytest.param("edge", 3500, 300, 4111, id="static-staged-faults_global"),
    pytest.param("candidates", 6000, 0, 4111, id="candidates-global"),
    pytest.param("candidates", 3500, 300, 4111, id="candidates-staged-faults_global"),
    pytest.param("edge", 3500, 300, 4112, id="static-consecutive-staged-faults_global"),
]


@pytest.mark.cuda
@pytest.mark.parametrize(("lanes", "nb", "nf", "n"), WIDE_SPIKES)
def test_wide_spike_tables_match_plain_on_cuda(cuda_device, lanes: str, nb: int, nf: int,
                                               n: int) -> None:
    """The hop by slot, the static hop and the candidates under spike
    tables of hundreds and of thousands of breakpoints (on a grid of 1/512
    s, so many repeat), a send on every eighth breakpoint, with and without
    fault tables beside them, on 17 rows (of 4,111 lanes: every row residue
    mod 16): every output identical, the spans too."""
    dev = cuda_device
    kernel, plain = draws.EdgeDraws(), draws.PlainEdgeDraws()
    rows = 17
    keys = scenario_keys(27, rows, device=dev)
    mean, var, drop = (x[:rows] for x in _edge_params(dev))
    g = np.random.default_rng(12)
    times = np.sort(g.integers(0, 1127, nb)).astype(np.float32) / 512
    times[0] = 0.0
    spike_t = torch.tensor(times, device=dev)
    spike_v = torch.tensor(g.uniform(0.0, 0.5, (nb, 4)), dtype=torch.float32, device=dev)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (rows, n)), dtype=torch.float32, device=dev)
    on = spike_t[::8][: n // 2]
    t_send[:, : on.shape[0]] = on  # on the breakpoints
    alive = torch.tensor(g.random((rows, n)) > 0.1, device=dev)
    fault = {}
    if nf:
        ft = np.sort(g.integers(0, 1127, nf)).astype(np.float32) / 512
        ft[0] = 0.0
        fault = {"fault_t": torch.tensor(ft, device=dev),
                 "fault_lat": torch.tensor(g.uniform(0.5, 3.0, (nf, 4)), dtype=torch.float32,
                                           device=dev),
                 "fault_drop": torch.tensor(g.uniform(-0.1, 0.6, (nf, 4)), dtype=torch.float32,
                                            device=dev)}
    lb = lanes == "slot"
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32, device=dev) if lb else None,
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32, device=dev) if lb else None,
        spike_t=spike_t, spike_v=spike_v, **fault,
    )
    if lanes == "candidates":
        uks, zks = (torch.stack(x, dim=1) for x in zip(*(draws.hop_keys(keys, 32 + k)
                                                         for k in range(2))))
        got = kernel.candidates(tables, t_send, alive, uks, zks, [3, 1])
        want = plain.candidates(tables, t_send, alive, uks, zks, [3, 1])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert kernel.cand_launches == kernel.launches == 1
        return
    uk, zk = draws.hop_keys(keys, 32)
    slot = torch.tensor(np.where(g.random((rows, n)) < 0.1, -1, g.integers(0, 3, (rows, n))),
                        dtype=torch.int32, device=dev)
    calls = [{"slot": slot}] if lb else [{"edge": 1}, {"edge": 3}]
    for kw in calls:
        got = kernel.hop(tables, t_send, alive, uk, zk, **kw)
        want = plain.hop(tables, t_send, alive, uk, zk, **kw)
        for x, y in zip(got, want, strict=True):
            assert (x is None and y is None) or torch.equal(x, y), kw.keys()
    assert kernel.launches == len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize(("rate", "burst"), [(5.0, 50.0), (0.37, 3.0), (100.0, 1.0),
                                             (0.0, 2.0)])
def test_bucket_matches_plain_on_cuda(cuda_device, rate: float, burst: float) -> None:
    """The token bucket on 45 sorted rows of 20,011 elements (most rows
    start unaligned), a third invalid, runs of equal times."""
    g = np.random.default_rng(8)
    t = np.cumsum(g.exponential(1.0 / (1.3 * rate + 1.0), (ROWS, N)), axis=1)
    t[:, 100:110] = t[:, 100:101]
    v = g.random((ROWS, N)) < 0.7
    t = torch.tensor(np.where(v, t, 1e30), dtype=torch.float32, device=cuda_device)
    v = torch.tensor(v, device=cuda_device)
    kernel = station_scan.StationScan()
    got = kernel.bucket(t, v, rate, burst)
    assert torch.equal(got, station_scan.PlainStationScan().bucket(t, v, rate, burst))
    assert kernel.mode_launches["bucket"] == 1 and kernel.walk_launches["warp"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["sorted_tail", "sparse"])
@pytest.mark.parametrize(("rows", "m"), [(45, 20_011), (1, 31), (33, 4_099)])
def test_bucket_layouts_match_plain_on_cuda(cuda_device, layout: str, rows: int,
                                            m: int) -> None:
    """The token bucket's warp walk on rows whose valid elements come first
    (an invalid tail of each row's own length) and on sparse rows (~5%
    valid), the valid elements at 1.3x the refill rate, at row counts and
    lengths that fill no whole line or block."""
    rate, burst, share = 5.0, 3.0, 0.6 if layout == "sorted_tail" else 0.05
    g = np.random.default_rng(9)
    t = np.cumsum(g.exponential(share / (1.3 * rate), (rows, m)), axis=1)
    if layout == "sorted_tail":
        v = np.arange(m)[None, :] < g.integers(m // 3, m, (rows, 1))
    else:
        v = g.random((rows, m)) < share
    t = torch.tensor(np.where(v, t, 1e30), dtype=torch.float32, device=cuda_device)
    v = torch.tensor(v, device=cuda_device)
    kernel = station_scan.StationScan()
    got = kernel.bucket(t, v, rate, burst)
    assert torch.equal(got, station_scan.PlainStationScan().bucket(t, v, rate, burst))
    assert kernel.walk_launches["warp"] == 1


def _control_rows(dev, seed: int, m: int, cores: int):
    """(arrival, enqueue, service, post-IO, burst, valid) (ROWS, m) on the
    card: arrivals at 1.3x the cores' service rate, a third invalid, a
    tenth io-only, a 3 ms pre-IO a burst."""
    a, d, v = _stream(dev, seed, m, rate=52.0 * cores / 0.67, svc=0.025)
    g = np.random.default_rng(seed + 1)
    b = v & torch.tensor(g.random(tuple(a.shape)) < 0.9, device=dev)
    e = torch.where(v, a + np.float32(0.003), 1e30)
    post = torch.tensor(g.exponential(0.05, tuple(a.shape)), dtype=torch.float32, device=dev)
    return a, e, d, post, b, v


@pytest.mark.cuda
@pytest.mark.parametrize("cores", [1, 2, 4, station_scan.WARP_WIDTH_MAX + 1])
@pytest.mark.parametrize("cap", [-1, 1, 8, 128])
@pytest.mark.parametrize("timeout", [-1.0, 0.05])
def test_controlled_matches_plain_on_cuda(cuda_device, cores: int, cap: int,
                                          timeout: float) -> None:
    """The controlled mode on rows of 2001 (most start unaligned): the lane
    walk up to 8 cores and cap 8, else the warp walk (one core at cap 128
    too), and the global walk past the warp walk's widest vector."""
    _a, e, d, _post, b, _v = _control_rows(cuda_device, 11, 2001, min(cores, 40))
    e = torch.where(b, e, 1e30)
    kernel = station_scan.StationScan()
    got = kernel.controlled(e, d, b, cores, cap, timeout)
    want = station_scan.PlainStationScan().controlled(e, d, b, cores, cap, timeout)
    assert all(torch.equal(x, y) for x, y in zip(got, want, strict=True))
    assert kernel.mode_launches["controlled"] == 1
    walk = ("global" if cores > station_scan.WARP_WIDTH_MAX
            else "lane" if max(cores, cap) <= station_scan.LANE_WHOLE else "warp")
    assert _walk(station_scan.MODE_CONTROLLED, cores, 0, cap) == walk
    assert kernel.walk_launches[walk] == 1


@pytest.mark.cuda
@pytest.mark.parametrize(("cores", "conn"), [(1, 1), (1, 6), (2, 5), (4, 33), (1, 128),
                                             (33, 6), (station_scan.WARP_WIDTH_MAX + 1, 6)])
@pytest.mark.parametrize(("cap", "timeout"), [(-1, -1.0), (1, 0.05), (8, -1.0), (128, 0.05)])
def test_socket_matches_plain_on_cuda(cuda_device, cores: int, conn: int, cap: int,
                                      timeout: float) -> None:
    """The socket mode: the lane walk (up to 8 connections, cap and cores
    whole in a lane's registers), the warp walk's connections in their one
    spread form (1 to 128 of them) with the cores whole on every lane or
    spread, and the global walk."""
    a, e, d, post, b, v = _control_rows(cuda_device, 12, 2001, min(cores, 40))
    kernel = station_scan.StationScan()
    got = kernel.socket(a, e, d, post, b, v, cores, conn, cap, timeout)
    want = station_scan.PlainStationScan().socket(a, e, d, post, b, v, cores, conn, cap, timeout)
    assert all(torch.equal(x, y) for x, y in zip(got, want, strict=True))
    assert kernel.mode_launches["socket"] == 1
    assert kernel.walk_launches[_walk(station_scan.MODE_SOCKET, cores, conn, cap)] == 1


def _off_boundary(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts one element past its buffer's
    start, off a 16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(("cores", "conn", "cap"), [(1, 8, 8), (1, 9, 8), (1, 8, 9), (2, 8, 8),
                                                    (2, 9, 9), (8, 8, 8), (9, 6, 4), (5, 3, 1)])
def test_socket_edges_match_plain_on_cuda(cuda_device, cores: int, conn: int, cap: int) -> None:
    """The socket scan at the edges of the lane walk's shapes (8 of each,
    and one past the connections, the cap or the cores: the warp walk) on
    37 rows (a warp and a part) of 1001, then on inputs that start one
    element past a 16-byte boundary, which the wrapper copies before the
    lane walk takes them."""
    rows = tuple(x[:37, :1001].contiguous() for x in _control_rows(cuda_device, 14, 1001, cores))
    plain = station_scan.PlainStationScan()
    for args in (rows, tuple(_off_boundary(x) for x in rows)):
        kernel = station_scan.StationScan()
        got = kernel.socket(*args, cores, conn, cap, 0.05)
        want = plain.socket(*args, cores, conn, cap, 0.05)
        assert all(torch.equal(x, y) for x, y in zip(got, want, strict=True))
        assert kernel.walk_launches[_walk(station_scan.MODE_SOCKET, cores, conn, cap)] == 1


@pytest.mark.cuda
@pytest.mark.parametrize(("cores", "cap"), [(1, 8), (1, 9), (8, 8), (9, 8), (8, 9), (2, 0)])
def test_controlled_edges_match_plain_on_cuda(cuda_device, cores: int, cap: int) -> None:
    """The controlled scan at the edges of the lane walk's shapes (8 cores
    and cap 8, one past either: the warp walk) on 37 rows of 1001, then on
    inputs that start one element past a 16-byte boundary, which the
    wrapper copies before the lane walk takes them."""
    _a, e, d, _post, b, _v = (x[:37, :1001].contiguous()
                              for x in _control_rows(cuda_device, 15, 1001, cores))
    e = torch.where(b, e, 1e30)
    plain = station_scan.PlainStationScan()
    walk = "lane" if max(cores, cap) <= station_scan.LANE_WHOLE else "warp"
    for args in ((e, d, b), tuple(_off_boundary(x) for x in (e, d, b))):
        kernel = station_scan.StationScan()
        got = kernel.controlled(*args, cores, cap, 0.05)
        want = plain.controlled(*args, cores, cap, 0.05)
        assert all(torch.equal(x, y) for x, y in zip(got, want, strict=True))
        assert kernel.walk_launches[walk] == 1


#: the candidate delays' spread of a least-connections case (el, ring):
#: deliveries that outlast the row, so that counts saturate and tie, and
#: rings mostly full of live entries, so that the smallest must be
#: replaced (default 0.005 s x the ring)
LC_DELAY = {(4, 3): 50.0, (2, 4): 0.3}


@pytest.mark.cuda
@pytest.mark.parametrize(("el", "ring", "marks"), [
    (2, 23, []),
    (3, 5, [(2.0, 1, 0), (4.0, 1, 1), (4.0, 1, 2), (6.0, 0, 1), (6.0, 0, 0), (9.0, 1, 1)]),
    (routing.MAX_LC_SLOTS, routing.MAX_LC_RING, [(3.0, 1, 0)]),
    (2, 32, []),
    (2, 33, []),
    (4, 3, [(5.0, 1, 2), (7.0, 0, 2)]),
    (5, 40, [(1.0, 1, 3)]),
    (8, 100, [(2.0, 1, 7), (3.0, 0, 7)]),
    (16, 64, []),
    (16, 65, [(4.0, 1, 15)]),
    (32, 32, [(6.0, 1, 31)]),
    (32, 33, []),
    (2, 4, []),
    (2, 1, []),
])
def test_lc_matches_plain_on_cuda(cuda_device, el: int, ring: int, marks: list) -> None:
    """Least connections on 45 rows of 3001 arrivals in time order (dead
    lanes last), with and without a timeline (every slot down a while), on
    both forms of the kernel's rings: a register a slot (two slots, rings
    of 1 to 32) and a lane's column of shared memory (every other shape, up
    to 32 slots x 128); the edges of a warp's lanes (32, 33), counts that
    saturate and tie, and full rings (``LC_DELAY``)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    t = torch.sort(torch.rand(ROWS, 3001, generator=g, device=cuda_device) * 10, dim=1).values
    ok = torch.rand(ROWS, 3001, generator=g, device=cuda_device) < 0.9
    order = torch.sort((~ok).int(), dim=1, stable=True).indices
    ok = ok.gather(1, order)
    t = torch.where(ok, t.gather(1, order), 1e30)
    deliv = t[..., None] + torch.rand(ROWS, 3001, el, generator=g, device=cuda_device) * (
        LC_DELAY.get((el, ring), 0.005 * ring))
    drop = torch.rand(ROWS, 3001, el, generator=g, device=cuda_device) < 0.1
    tl = routing.Timeline([m[0] for m in marks], [m[1] for m in marks],
                          [m[2] for m in marks], el, cuda_device)
    kernel = routing.LbRoute()
    got = kernel.lc(tl, t, ok, deliv, drop, ring)
    assert torch.equal(got, routing.PlainLbRoute().lc(tl, t, ok, deliv, drop, ring))
    assert kernel.lc_launches == kernel.launches == 1


def _overload(overload: dict, cores: int = 1) -> dict:
    """One server of ``cores`` at CPU 30 ms then IO 10 ms a request, ~1.1x
    its cores' capacity, under ``overload``."""
    data = _single_server()
    data["rqs_input"]["avg_active_users"]["mean"] = 110 * cores
    data["rqs_input"]["avg_request_per_minute_per_user"]["mean"] = 20
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["server_resources"]["cpu_cores"] = cores
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.030}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.010}},
    ]
    srv["overload"] = overload
    return data


def _lc_two_streams_outage() -> dict:
    data = _two_streams_outage()
    data["topology_graph"]["nodes"]["load_balancer"]["algorithms"] = "least_connection"
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("make", [
    lambda: _overload({"rate_limit_rps": 3.0, "rate_limit_burst": 3}),
    lambda: _overload({"max_ready_queue": 8}),
    lambda: _overload({"queue_timeout_s": 0.1}, cores=2),
    lambda: _overload({"max_connections": 6, "max_ready_queue": 4, "queue_timeout_s": 0.1}),
    _lc_two_streams_outage,
])
def test_fast_engine_controls_match_plain_on_cuda(cuda_device, make) -> None:
    """The overload controls and least connections through the whole engine
    on the card, kernels against plain versions: every integer output (the
    rejections included) and every clock identical."""
    plan = compile_payload(SimulationPayload.from_dict(make()))
    eng = FastEngine(plan, device=cuda_device, collect_clocks=True)
    keys = scenario_keys(5, 16, device=cuda_device)
    got = eng.run_tensors(keys)
    assert eng.draws.launches > 0 and eng.scan.launches > 0
    assert eng.route.lc_launches == (1 if plan.lb_algo == 1 else 0)
    plain = copy.copy(eng)
    plain.draws, plain.scan = draws.PlainEdgeDraws(), station_scan.PlainStationScan()
    plain.route = routing.PlainLbRoute()
    want = plain.run_tensors(keys)
    for field in ("hist", "thr", "lat_count", "n_generated", "n_dropped", "n_overflow",
                  "n_rejected", "clock", "lat_sum", "gauge_means"):
        assert torch.equal(got[field], want[field]), field
    assert plan.lb_algo == 1 or int(got["n_rejected"].sum()) > 0


#: (rows, lanes a row, per-lane amounts) of the gauge grid's card checks:
#: stride grids in shared memory (the headline's 1 s series: 601 rows), the
#: largest there, and fine grids past it (30 s and 600 s at 0.01 s)
GAUGE_CASES = [(601, 87_840, False), (2048, 20_011, True), (2049, 20_011, False),
               (3001, 20_011, True), (60_001, 4099, False)]


@pytest.mark.cuda
@pytest.mark.parametrize(("rows", "n", "per_lane"), GAUGE_CASES)
def test_gauge_grid_matches_plain_on_cuda(cuda_device, rows: int, n: int,
                                          per_lane: bool) -> None:
    """One site's intervals into a grid holding other adds: bit-exact with
    the plain scatter (whole amounts), each form counted."""
    from asyncflow_tpu_torch.engines.torchsim import gauge_grid

    g = torch.Generator(device=cuda_device).manual_seed(rows)
    s = 16
    period = 0.01
    t0 = torch.rand((s, n), generator=g, device=cuda_device) * (period * rows)
    t1 = t0 + torch.rand((s, n), generator=g, device=cuda_device)
    t1[:, ::7] = 1e30
    on = torch.rand((s, n), generator=g, device=cuda_device) > 0.25
    amount = (torch.randint(1, 300, (s, n), generator=g, device=cuda_device).float()
              if per_lane else 1.0)
    base = torch.randint(-3, 4, (s, rows, 5), generator=g, device=cuda_device).float()
    kernel = gauge_grid.GaugeGrid()
    got = base.clone()
    kernel.add(got, 3, t0, t1, on, amount, period)
    want = base.clone()
    gauge_grid.gauge_add_plain(want, 3, t0, t1, on, amount, period)
    assert torch.equal(got, want)
    form = "shared" if rows <= 2048 else "global"
    assert kernel.launches == 1 and kernel.form_launches[form] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("option", [{"gauge_series_stride": 20}, {"collect_gauges": True}])
def test_fast_engine_gauge_grid_matches_plain_on_cuda(cuda_device, option: dict) -> None:
    """The whole engine's grid on the card, through the kernel and through
    the plain scatter: identical, and every other output as without it."""
    from asyncflow_tpu_torch.engines.torchsim import gauge_grid

    plan = compile_payload(SimulationPayload.from_dict(
        _overload({"max_connections": 6, "max_ready_queue": 4, "queue_timeout_s": 0.1})))
    eng = FastEngine(plan, device=cuda_device, **option)
    keys = scenario_keys(5, 16, device=cuda_device)
    got = eng.run_tensors(keys)
    assert eng.gauge.launches > 0
    plain = copy.copy(eng)
    plain.gauge = gauge_grid.PlainGaugeGrid()
    assert torch.equal(got["gauge"], plain.run_tensors(keys)["gauge"])
    off = FastEngine(plan, device=cuda_device).run_tensors(keys)
    for field, value in off.items():
        if field != "gauge":
            assert torch.equal(got[field], value), field
