#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``asyncflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. the card's name and power limit, the torch and nvcc versions, the
   build of every CUDA library of the port (one nvcc per library, in
   parallel) with the registers and spills ``ptxas -v`` reports for each
   instance of every kernel, and for each DES path the instance it runs, the
   pool's placement (its scanned fields in shared memory, or none),
   the block and its shared bytes, and the warps an SM holds;
2. the DES kernel against its plain PyTorch twin on the card, on the same
   keys and arrival-rate tables: on each path's own plan at its 2048
   scenarios (two_servers_lb, event_inj_lb, resilience_all and two_gen_lb
   at 600 s, db_pool_k2 at 120 s, llm_cost at 60 s) with only the
   iteration cap lowered, so that every scenario truncates (event_inj_lb's
   windows are scaled into the capped time, and every scenario must cross
   them all); and on 5 s plans: least-connection routing over every edge
   distribution with dropout, a binding RAM with an overflowing pool, each
   overload control (queue cap, connection cap, rate limit, deadline) and
   an LC breaker with an outage, each of which must reject requests; a
   cache mixture, a single DB connection, the featured mix (a DB pool of
   2, a cache, an LLM call and weighted endpoints), two streams with a
   normal entry edge, and two streams on event_inj_lb's outages and
   spikes; a binding RAM on a pool of 37 (no multiple of a warp) and on a
   pool of 2048 (too large for shared memory: the global placement).  Both
   placements must be checked.  Every integer output (``work``
   included) and every float moment must be bit-exact;
3. the six paths: ``SweepRunner(payload, engine="kernel").run(2048,
   seed=0)`` at the payload's full horizon, through the DES kernel (its
   launch count, set to 0 before each path, must move), with no truncation
   and no overflow,
   request conservation per scenario, the pooled p95 within 2% of the JAX
   reference kernel's, for resilience_all the rejected fraction within
   0.02 of it, for llm_cost the mean LLM cost per completed request within
   2% of it, and every path's event count as the earlier slices measured
   it (no draw may move); each path's kernel time is printed beside the
   one-thread-a-scenario kernel's;
4. the scan fast path's three kernels (``edge_draws``, ``station_scan``,
   ``lb_route``) against their plain PyTorch versions on the card, on each
   fast path's payload (two_servers_lb, single_server,
   heavy_inj_single_server, event_inj_lb, two_gen_lb, db_pool_k2,
   chaos_campaign, outage_retry, trace_parity_resilient, rate_limited_lb,
   overload_cap8, overload_sockets, lc_mixed_fleet) cut to 60 s (its
   events and fault windows scaled into it; chaos_campaign's tables sampled
   with its MTBF divided by ten) at 64 scenarios: every kernel call of the
   engine's run (uniforms, arrival gaps and their prefix sum, static, LB,
   slot, spiked and fault-table hops, the outage timeline's table and
   lanes, Lindley and Kiefer-Wolfowitz scans, RAM-core scans, the retry
   budget's and the rate limit's token buckets, the controlled and socket
   scans, least connections' candidates (one launch for every slot) and
   its picks)
   repeated through the plain version, bit-exact,
   and the whole engine through each, with identical integer outputs
   (the resilience counters included), per-request clocks and gauge
   means; a synthetic timeline with an all-down interval and same-time
   marks, and one of 23 marks (two counting passes), through ``lb_route``
   at full width; ``station_scan`` at every carry width of
   ``SCAN_WIDTH_CASES`` (the warp walk's width classes up to 1024
   entries, and past them the global-scratch walk) on 2048 synthetic rows;
   the hop under synthetic per-scenario fault tables (a partition,
   overlapping degrades, duplicate breakpoint times with decoy rows that
   must never be read, sends exactly on breakpoints) at the headline's
   width, static and by rank; the LB hop by slot and least connections'
   candidates at widths of every residue mod 16 on 17 rows and at
   event_inj_lb's and lc_mixed_fleet's widths; the
   token bucket on 2048 synthetic rows of 9,750 at five (rate, burst)
   pairs; the controlled and socket scans on 2048 synthetic rows over the
   grid of cores, ready-queue caps, deadlines and connection caps
   (``CONTROL_GRID``; the controlled scan must take the lane walk up to 8
   cores and cap 8, else the warp walk); the gaps' prefix sum, one launch
   a call, at the headline's 2048 x 87,840 and at ``GAP_SUM_CASES``; and
   least connections on 2048 synthetic rows with and
   without a timeline, at the widest shape (32 slots, rings of 128) and on
   rings of 32 and 33 entries, the edges of the kernel's lane layout
   (``LC_CASES``); the multiply-adds the jitted reference fuses
   (``_fused_site_check``: every law's hop with and without spikes and
   fault tables, LB edges of one law and of several, the candidates) on
   64 x 20,011 lanes; XLA's ``log1p`` in the kernel
   against its plain version on each of the 2**23 uniforms; and
   ``blame_grid`` at ``BLAME_CASES`` (static and per-lane cells, an empty
   credit, dropped lanes, rows off every multiple of 32, several passes of
   rows, the headline's width) and on a planes run's credits, each launch
   twice (the same bits) and each cell within one float32 ulp of the plain
   float64 sums;
5. the thirteen fast paths: ``SweepRunner(payload).run(2048, seed=0)``
   through ``engine="auto"`` (with the path's sweep axes), which must take
   the fast path and launch its kernels (counts set to 0 before the run:
   ``edge_draws`` and ``station_scan`` on every path, ``lb_route`` on
   event_inj_lb, the Kiefer-Wolfowitz mode on db_pool_k2, the fault-table
   hop on chaos_campaign, the token bucket on outage_retry and
   rate_limited_lb, the controlled scan on overload_cap8, the socket scan on
   overload_sockets, least connections and its candidate hops on
   lc_mixed_fleet), on
   two_servers_lb (600 s), single_server (500 s, a binding RAM of 20
   slots), heavy_inj_single_server (600 s, a 3 s spike from 180 s to 300 s,
   in default chunks of 1,797 scenarios), event_inj_lb (600 s: outages and
   spikes), two_gen_lb (600 s: two streams), db_pool_k2 (120 s: a DB pool
   of 2), chaos_campaign (600 s: a sampled chaos campaign),
   outage_retry (the resilience guide's outage sweep, 120 s: the outage
   slid over 90 s, the retry driver and its budget) and
   trace_parity_resilient (90 s: every attempt refused, retried,
   abandoned), rate_limited_lb (600 s: the resilience example's srv-2
   behind its token bucket), overload_cap8 and overload_sockets (120 s: the
   overload example's ready-queue cap of 8, and its server under a
   connection cap of 6 with a cap of 4 and a 0.1 s deadline) and
   lc_mixed_fleet (600 s: the mixed fleet's least connections at 24 MB):
   for the six earlier paths request conservation and the
   completions and drops of the earlier slice's final run; for the three
   resilience paths their invariants (dark refusals, the scorecard of the
   sampled tables equal to the reference's, the attempts' accounting) and
   the DES kernel's refusal by name; for the four overload and routing
   paths request conservation, rejections where a control binds, and the
   p95 and rejected fraction printed beside the DES kernel's on the same
   payload (the two engines sample arrivals differently); the pooled p95
   within 2% of the JAX fast path's and (the earlier paths) of the DES
   kernel's on the same payload (its sweep untruncated), where each has
   one; then the first call of each kind
   (uniform, gap, gap prefix sum, static, LB, slot, spiked or fault-table
   hop, timeline table and lanes, wait scan of one server or of several,
   RAM-core scan, token bucket, controlled and socket scans,
   least-connections candidates and picks) of the path's own run at full width,
   repeated through the kernel and through its plain version on the same
   arguments, bit-exact; each edge_draws and lb_route kind's call and the
   path's station_scan kinds timed between CUDA events beside its bound,
   its plain version's time and the library's (the closed form ``cumsum``
   / ``cummax`` for the one-core scan), and the stable rank's time;
   chaos_campaign streams both servers' ready queues (``GAUGE_PATHS``),
   launches ``gauge_grid`` and must report a finite mean time to drain;
6. the gauge grid: the headline (600 s, 2048 scenarios) with both servers'
   ready queues streamed at 1 s and without, in turns in one process (their
   walls and scen/s printed), every other output equal, the series run
   launching ``gauge_grid`` (its count set to 0 just before it) in its
   shared-memory form, ``GAUGE_HEADLINE_LAUNCHES`` launches a chunk (a
   launch a group of sites); that run's calls replayed through the kernel
   and the plain versions, bit-exact, and timed beside their bound and one
   ``scatter_add_`` of the same sites' buckets, a launch's mean and a
   chunk's sum; the gauge work a chunk (one chunk's ``run_tensors`` with and
   without the grid, in turns); the fine grid of the headline cut
   to 30 s at a 0.01 s period (3,001 rows: the global-memory form),
   bit-exact; examples/sweeps/gauge_series_sweep.py's payload at 2048
   scenarios (its ready-queue band's width and the pooled p95's interval);
   examples/sweeps/overload_policy.py's user_mean axis through
   ``make_overrides`` (each load point's p95 and rejected fraction, with
   and without a ready-queue cap of 8);
7. the observability planes: the headline (600 s, 2048 scenarios) through
   ``SweepRunner`` untraced, with ``trace=TraceConfig()`` and with both
   planes (``blame=True``), their scen/s printed, every other output
   bit-identical across the three, pooled conservation within 1e-3 in
   every coarse latency bin, the both-planes run launching ``blame_grid``
   (its count set to 0 just before it) once a chunk, its peak device
   memory; scenario 0's flight records decoded and the p95 bin's blame
   printed; outage_retry with both planes against its untraced sweep (the
   rings across attempt blocks); the headline's ``blame_grid`` call timed
   beside its bound, its plain version and one ``scatter_add_`` of the
   same credits.

It prints the redesigned kernels' times beside their bounds (and, for
this slice's two, the parent tree's times, ``PARENT_MS``) with their
instances' registers and spills (``REDESIGNED``; any spill of theirs fails
phase 1), a JSON line of per-kernel measurements, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It needs a CUDA card and
the repository beside it; it imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: examples/yaml_input/data/two_servers_lb.yml as a literal (PyYAML may be
#: missing where this runs; a CPU test holds the two equal)
TWO_SERVERS_LB = {
    "rqs_input": {
        "id": "rqs-1",
        "avg_active_users": {"mean": 400},
        "avg_request_per_minute_per_user": {"mean": 20},
        "user_sampling_window": 60,
    },
    "topology_graph": {
        "nodes": {
            "client": {"id": "client-1"},
            "load_balancer": {
                "id": "lb-1",
                "algorithms": "round_robin",
                "server_covered": ["srv-1", "srv-2"],
            },
            "servers": [
                {
                    "id": sid,
                    "server_resources": {"cpu_cores": 1, "ram_mb": 2048},
                    "endpoints": [
                        {
                            "endpoint_name": "/api",
                            "steps": [
                                {
                                    "kind": "initial_parsing",
                                    "step_operation": {"cpu_time": 0.002},
                                },
                                {"kind": "ram", "step_operation": {"necessary_ram": 128}},
                                {
                                    "kind": "io_wait",
                                    "step_operation": {"io_waiting_time": 0.012},
                                },
                            ],
                        },
                    ],
                }
                for sid in ("srv-1", "srv-2")
            ],
        },
        "edges": [
            {
                "id": eid,
                "source": src,
                "target": dst,
                "latency": {"mean": mean, "distribution": "exponential"},
            }
            for eid, src, dst, mean in (
                ("gen-client", "rqs-1", "client-1", 0.003),
                ("client-lb", "client-1", "lb-1", 0.002),
                ("lb-srv1", "lb-1", "srv-1", 0.002),
                ("lb-srv2", "lb-1", "srv-2", 0.002),
                ("srv1-client", "srv-1", "client-1", 0.003),
                ("srv2-client", "srv-2", "client-1", 0.003),
            )
        ],
    },
    "sim_settings": {"total_simulation_time": 600, "sample_period_s": 0.05},
}


def _event_inj_lb() -> dict:
    """examples/yaml_input/data/event_inj_lb.yml: the headline topology at
    120 users with three 60 s network spikes and one 60 s outage per
    server."""
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["rqs_input"]["avg_active_users"] = {"mean": 120}
    windows = (
        ("spike-client-lb", "client-lb", 100.0, 160.0, 0.015),
        ("outage-srv1", "srv-1", 180.0, 240.0, None),
        ("spike-lb-srv2", "lb-srv2", 300.0, 360.0, 0.020),
        ("outage-srv2", "srv-2", 360.0, 420.0, None),
        ("spike-gen-client", "gen-client", 480.0, 540.0, 0.010),
    )
    data["events"] = [
        {
            "event_id": eid,
            "target_id": target,
            "start": (
                {"kind": "server_down", "t_start": t0}
                if spike is None
                else {"kind": "network_spike_start", "t_start": t0, "spike_s": spike}
            ),
            "end": {"kind": "server_up" if spike is None else "network_spike_end",
                    "t_end": t1},
        }
        for eid, target, t0, t1, spike in windows
    ]
    return data


def _resilience_all() -> dict:
    """examples/sweeps/resilience_controls.py, ``build_payload("all")`` at
    its top load (150 users), over the YAML's own 600 s: srv-2 behind a
    5 rps / burst-5 token bucket, srv-1 at CPU 18 ms with an 80 ms dequeue
    deadline, and an LB breaker (5 failures, 3 s cooldown, 2 probes)."""
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["rqs_input"]["avg_active_users"]["mean"] = 150.0
    srv1, srv2 = data["topology_graph"]["nodes"]["servers"]
    srv2["overload"] = {"rate_limit_rps": 5.0, "rate_limit_burst": 5}
    srv1["endpoints"][0]["steps"][0]["step_operation"] = {"cpu_time": 0.018}
    srv1["overload"] = {"queue_timeout_s": 0.080}
    data["topology_graph"]["nodes"]["load_balancer"]["circuit_breaker"] = {
        "failure_threshold": 5,
        "cooldown_s": 3.0,
        "half_open_probes": 2,
    }
    return data


#: examples/yaml_input/data/single_server.yml as a literal
SINGLE_SERVER = {
    "rqs_input": {
        "id": "rqs-1",
        "avg_active_users": {"mean": 100},
        "avg_request_per_minute_per_user": {"mean": 20},
        "user_sampling_window": 60,
    },
    "topology_graph": {
        "nodes": {
            "client": {"id": "client-1"},
            "servers": [
                {
                    "id": "srv-1",
                    "server_resources": {"cpu_cores": 1, "ram_mb": 2048},
                    "endpoints": [
                        {
                            "endpoint_name": "ep-1",
                            "steps": [
                                {"kind": "initial_parsing",
                                 "step_operation": {"cpu_time": 0.001}},
                                {"kind": "ram", "step_operation": {"necessary_ram": 100}},
                                {"kind": "io_wait",
                                 "step_operation": {"io_waiting_time": 0.1}},
                            ],
                        },
                    ],
                },
            ],
        },
        "edges": [
            {
                "id": eid,
                "source": src,
                "target": dst,
                "latency": {"mean": 0.003, "distribution": "exponential"},
            }
            for eid, src, dst in (
                ("gen-to-client", "rqs-1", "client-1"),
                ("client-to-server", "client-1", "srv-1"),
                ("server-to-client", "srv-1", "client-1"),
            )
        ],
    },
    "sim_settings": {"total_simulation_time": 500, "sample_period_s": 0.05},
}


#: examples/yaml_input/data/heavy_inj_single_server.yml as a literal: a
#: 3 s spike on the client-to-server edge from 180 s to 300 s at ~150 req/s
HEAVY_INJ_SINGLE_SERVER = {
    "rqs_input": {
        "id": "rqs-1",
        "avg_active_users": {"mean": 300},
        "avg_request_per_minute_per_user": {"mean": 30},
        "user_sampling_window": 60,
    },
    "topology_graph": {
        "nodes": {
            "client": {"id": "client-1"},
            "servers": [
                {
                    "id": "srv-1",
                    "server_resources": {"cpu_cores": 1, "ram_mb": 8000},
                    "endpoints": [
                        {
                            "endpoint_name": "ep-1",
                            "steps": [
                                {"kind": "initial_parsing",
                                 "step_operation": {"cpu_time": 0.005}},
                                {"kind": "ram", "step_operation": {"necessary_ram": 200}},
                                {"kind": "io_wait",
                                 "step_operation": {"io_waiting_time": 0.2}},
                            ],
                        },
                    ],
                },
            ],
        },
        "edges": [
            {
                "id": eid,
                "source": src,
                "target": dst,
                "latency": {"mean": 0.003, "distribution": "exponential"},
            }
            for eid, src, dst in (
                ("gen-to-client", "rqs-1", "client-1"),
                ("client-to-server", "client-1", "srv-1"),
                ("server-to-client", "srv-1", "client-1"),
            )
        ],
    },
    "sim_settings": {"total_simulation_time": 600, "sample_period_s": 0.05},
    "events": [
        {
            "event_id": "ev-spike-heavy",
            "target_id": "client-to-server",
            "start": {"kind": "network_spike_start", "t_start": 180.0, "spike_s": 3.0},
            "end": {"kind": "network_spike_end", "t_end": 300.0},
        },
    ],
}


def db_pool_payload(pool: int | None) -> dict:
    """examples/sweeps/db_pool_sizing.py, ``payload_with_pool(pool)``: one
    server, CPU 2 ms then a 60 ms io_db query holding one of ``pool``
    connections (None: no pool), 60 users (~20 req/s), 120 s."""
    data = copy.deepcopy(SINGLE_SERVER)
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "io_db", "step_operation": {"io_waiting_time": 0.060}},
    ]
    if pool is not None:
        srv["server_resources"]["db_connection_pool"] = pool
    data["rqs_input"]["avg_active_users"]["mean"] = 60
    data["sim_settings"]["total_simulation_time"] = 120
    return data


def llm_cost_payload() -> dict:
    """examples/sweeps/llm_cost_sweep.py, ``build_payload()`` (its top
    load): 4 cores, CPU 3 ms then an io_llm call of 80 ms plus Poisson(250)
    output tokens at 0.8 ms and 2e-5 cost units each, 60 users (~20
    req/s), 60 s."""
    data = copy.deepcopy(SINGLE_SERVER)
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["server_resources"]["cpu_cores"] = 4
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.003}},
        {
            "kind": "io_llm",
            "step_operation": {"io_waiting_time": 0.080},
            "llm_tokens_mean": 250,
            "llm_time_per_token": 0.0008,
            "llm_cost_per_token": 2e-05,
        },
    ]
    data["rqs_input"]["avg_active_users"]["mean"] = 60.0
    data["sim_settings"]["total_simulation_time"] = 60
    return data


def _two_gen_lb() -> dict:
    """examples/yaml_input/data/two_servers_lb.yml with the two streams of
    docs/guides/yaml-scenarios.md (tests/parity/test_multi_generator.py,
    ``_payload``) over the YAML's 600 s: rqs-1 200 users x 20 req/min,
    window 60 s; rqs-2 100 users x 40 req/min, window 30 s, entering over
    an exponential 4 ms edge (~133 req/s in all)."""
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["rqs_input"] = [
        {
            "id": "rqs-1",
            "avg_active_users": {"mean": 200},
            "avg_request_per_minute_per_user": {"mean": 20},
            "user_sampling_window": 60,
        },
        {
            "id": "rqs-2",
            "avg_active_users": {"mean": 100},
            "avg_request_per_minute_per_user": {"mean": 40},
            "user_sampling_window": 30,
        },
    ]
    data["topology_graph"]["edges"].append(
        {
            "id": "gen2-client",
            "source": "rqs-2",
            "target": "client-1",
            "latency": {"mean": 0.004, "distribution": "exponential"},
        },
    )
    return data


def _chaos_nodes() -> dict:
    """The chaos campaign's LB over two 1-core servers of one /api endpoint."""
    steps = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "ram", "step_operation": {"necessary_ram": 128}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.012}},
    ]
    return {
        "client": {"id": "client-1"},
        "load_balancer": {"id": "lb-1", "algorithms": "round_robin",
                          "server_covered": ["srv-1", "srv-2"]},
        "servers": [
            {"id": sid, "server_resources": {"cpu_cores": 1, "ram_mb": 2048},
             "endpoints": [{"endpoint_name": "/api", "steps": copy.deepcopy(steps)}]}
            for sid in ("srv-1", "srv-2")
        ],
    }


#: examples/yaml_input/data/chaos_campaign.yml as a literal: the headline's
#: shape (400 users, two 1-core servers behind round robin) under a sampled
#: chaos campaign: rack-a darkens srv-1 (MTBF 300 s, lognormal repair of
#: 20 s), wan degrades lb-srv2 (4x latency, +5% dropout)
CHAOS_CAMPAIGN = {
    "rqs_input": {
        "id": "rqs-1",
        "avg_active_users": {"mean": 400},
        "avg_request_per_minute_per_user": {"mean": 20},
        "user_sampling_window": 60,
    },
    "topology_graph": {
        "nodes": _chaos_nodes(),
        "edges": [
            {"id": eid, "source": src, "target": dst,
             "latency": {"mean": mean, "distribution": "exponential"}}
            for eid, src, dst, mean in (
                ("gen-client", "rqs-1", "client-1", 0.003),
                ("client-lb", "client-1", "lb-1", 0.002),
                ("lb-srv1", "lb-1", "srv-1", 0.002),
                ("lb-srv2", "lb-1", "srv-2", 0.002),
                ("srv1-client", "srv-1", "client-1", 0.003),
                ("srv2-client", "srv-2", "client-1", 0.003),
            )
        ],
    },
    "hazard_model": {
        "max_faults_per_component": 4,
        "domains": [
            {"domain_id": "rack-a", "targets": ["srv-1"],
             "mtbf": {"mean": 300.0, "distribution": "exponential"},
             "mttr": {"mean": 20.0, "variance": 0.3, "distribution": "log_normal"}},
            {"domain_id": "wan", "targets": ["lb-srv2"],
             "mtbf": {"mean": 400.0, "distribution": "exponential"},
             "mttr": {"mean": 15.0, "distribution": "exponential"},
             "latency_factor": 4.0, "dropout_boost": 0.05},
        ],
    },
    "sim_settings": {"total_simulation_time": 600, "sample_period_s": 0.05},
}


def _single_server_edges(means: tuple, ids: tuple, **extra) -> list:
    return [
        {"id": eid, "source": src, "target": dst,
         "latency": {"mean": mean, **extra.get("latency", {"distribution": "exponential"})},
         **extra.get("edge", {})}
        for eid, (src, dst), mean in zip(
            ids, (("rqs-1", "client-1"), ("client-1", "srv-1"), ("srv-1", "client-1")), means)
    ]


def _outage_retry() -> dict:
    """The resilience guide's runnable outage sweep (docs/guides/
    resilience.md, "A runnable outage sweep"): tests/integration/data/
    single_server.yml at 120 s, its retry policy (0.5 s deadline, three
    attempts, backoff 0.1 s doubling to 1 s, a budget of 50 tokens refilled
    at 5 a second) and an outage of srv-1 from 10 s to 25 s, slid per
    scenario by :func:`outage_retry_axes`."""
    return {
        "rqs_input": {
            "id": "rqs-1",
            "avg_active_users": {"mean": 50},
            "avg_request_per_minute_per_user": {"mean": 20},
            "user_sampling_window": 60,
        },
        "topology_graph": {
            "nodes": {
                "client": {"id": "client-1"},
                "servers": [{
                    "id": "srv-1",
                    "server_resources": {"cpu_cores": 1, "ram_mb": 1024},
                    "endpoints": [{"endpoint_name": "ep-1", "steps": [
                        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.001}},
                        {"kind": "ram", "step_operation": {"necessary_ram": 64}},
                        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.01}},
                    ]}],
                }],
            },
            "edges": _single_server_edges((0.003, 0.002, 0.003),
                                          ("gen-client", "client-srv", "srv-client")),
        },
        "retry_policy": {
            "request_timeout_s": 0.5, "max_attempts": 3, "backoff_base_s": 0.1,
            "backoff_multiplier": 2.0, "backoff_cap_s": 1.0, "budget_tokens": 50,
            "budget_refill_per_s": 5.0,
        },
        "fault_timeline": {"events": [{
            "fault_id": "crash", "kind": "server_outage", "target_id": "srv-1",
            "t_start": 10.0, "t_end": 25.0,
        }]},
        "sim_settings": {"total_simulation_time": 120, "sample_period_s": 0.01},
    }


#: examples/yaml_input/data/trace_parity_resilient.yml as a literal: one
#: user at 6 requests a minute, degenerate latencies, a retry policy of
#: three jitter-free attempts and an outage of srv-1 over the whole horizon
TRACE_PARITY_RESILIENT = {
    "rqs_input": {
        "id": "rqs-1",
        "avg_active_users": {"mean": 1, "distribution": "normal", "variance": 0},
        "avg_request_per_minute_per_user": {"mean": 6},
        "user_sampling_window": 60,
    },
    "topology_graph": {
        "nodes": {
            "client": {"id": "client-1"},
            "servers": [{
                "id": "srv-1",
                "server_resources": {"cpu_cores": 1, "ram_mb": 1024},
                "endpoints": [{"endpoint_name": "ep-1", "steps": [
                    {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.004}},
                    {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.012}},
                ]}],
            }],
        },
        "edges": _single_server_edges(
            (0.003, 0.002, 0.005), ("gen-client", "client-srv", "srv-client"),
            latency={"distribution": "normal", "variance": 0}, edge={"dropout_rate": 0}),
    },
    "retry_policy": {"request_timeout_s": 0.05, "max_attempts": 3, "backoff_base_s": 0.1,
                     "jitter": 0.0},
    "fault_timeline": {"events": [{
        "fault_id": "dark-horizon", "kind": "server_outage", "target_id": "srv-1",
        "t_start": 0.0, "t_end": 90.0,
    }]},
    "sim_settings": {"total_simulation_time": 90, "sample_period_s": 0.1},
}


def _rate_limited_lb() -> dict:
    """examples/sweeps/resilience_controls.py, ``build_payload("none")`` at
    its top load (150 users), over the YAML's own 600 s: ``_resilience_all``
    without the breaker and the deadline (srv-2 behind a 5 rps / burst-5
    token bucket, srv-1 at CPU 18 ms)."""
    data = _resilience_all()
    del data["topology_graph"]["nodes"]["load_balancer"]["circuit_breaker"]
    del data["topology_graph"]["nodes"]["servers"][0]["overload"]
    return data


def overload_payload(users: float, overload: dict | None) -> dict:
    """examples/sweeps/overload_policy.py's ``payload_with``: single_server.yml
    with CPU 30 ms then IO 10 ms an endpoint, over 120 s, at ``users`` x 20
    req/min (its load points run 60 to 110), under ``overload``."""
    data = copy.deepcopy(SINGLE_SERVER)
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.030}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.010}},
    ]
    if overload is not None:
        srv["overload"] = overload
    data["rqs_input"]["avg_active_users"]["mean"] = users
    data["sim_settings"]["total_simulation_time"] = 120
    return data


def mixed_fleet_payload(heavy_need_mb: float = 24.0, horizon: int = 600) -> dict:
    """examples/sweeps/mixed_fleet_sweep.py's ``build_payload``: a generator
    of 60 users x 30 req/min, least connections over a 2-core node (4 GB,
    64 MB a request) and a 1-core node (1 GB) serving a light endpoint and
    a heavy one of ``heavy_need_mb``."""

    def endpoint(name: str, need: float, io_s: float) -> dict:
        return {"endpoint_name": name, "steps": [
            {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
            {"kind": "ram", "step_operation": {"necessary_ram": need}},
            {"kind": "io_wait", "step_operation": {"io_waiting_time": io_s}},
        ]}

    def edge(eid: str, source: str, target: str, mean: float) -> dict:
        return {"id": eid, "source": source, "target": target,
                "latency": {"mean": mean, "distribution": "exponential"}}

    return {
        "rqs_input": {"id": "gen", "avg_active_users": {"mean": 60.0},
                      "avg_request_per_minute_per_user": {"mean": 30.0},
                      "user_sampling_window": 10},
        "topology_graph": {
            "nodes": {
                "client": {"id": "client"},
                "load_balancer": {"id": "lb", "algorithms": "least_connection",
                                  "server_covered": ["big", "small"]},
                "servers": [
                    {"id": "big", "server_resources": {"cpu_cores": 2, "ram_mb": 4096},
                     "endpoints": [endpoint("/work", 64.0, 0.04)]},
                    {"id": "small", "server_resources": {"cpu_cores": 1, "ram_mb": 1024},
                     "endpoints": [endpoint("/light", 16.0, 0.02),
                                   endpoint("/heavy", heavy_need_mb, 0.12)]},
                ],
            },
            "edges": [
                edge("gen-client", "gen", "client", 0.003),
                edge("client-lb", "client", "lb", 0.002),
                edge("lb-big", "lb", "big", 0.02),
                edge("lb-small", "lb", "small", 0.02),
                edge("big-client", "big", "client", 0.003),
                edge("small-client", "small", "client", 0.003),
            ],
        },
        "sim_settings": {"total_simulation_time": horizon, "sample_period_s": 0.05},
    }


def outage_retry_axes(n: int) -> dict:
    """The guide's sweep axes for ``n`` scenarios: the outage slid over
    [0, 90] s, the client timeout 0.5 s (``make_overrides``' arguments)."""
    import numpy as np

    return {"fault_shift": np.linspace(0.0, 90.0, n), "retry_timeout": np.full(n, 0.5)}


OUTAGE_RETRY = _outage_retry()
EVENT_INJ_LB = _event_inj_lb()
RESILIENCE_ALL = _resilience_all()
DB_POOL_K2 = db_pool_payload(2)
LLM_COST = llm_cost_payload()
TWO_GEN_LB = _two_gen_lb()
PAYLOADS = {
    "two_servers_lb": TWO_SERVERS_LB,
    "event_inj_lb": EVENT_INJ_LB,
    "resilience_all": RESILIENCE_ALL,
    "db_pool_k2": DB_POOL_K2,
    "llm_cost": LLM_COST,
    "two_gen_lb": TWO_GEN_LB,
}

#: the scan fast path's full-width paths: the headline,
#: examples/yaml_input/data/single_server.yml (a binding RAM of 20 slots),
#: heavy_inj_single_server.yml (a network spike, 100,085 lanes), the three
#: the reference's ``auto`` also sends there: event_inj_lb (round robin
#: under outages), two_gen_lb (two streams) and db_pool_k2 (a DB pool of
#: 2), and the three resilience paths: chaos_campaign (sampled fault
#: tables in the hop and the dark windows), outage_retry (the retry driver
#: and its budget's token bucket) and trace_parity_resilient (every
#: attempt refused, retried, abandoned)
FAST_PAYLOADS = {
    "two_servers_lb": TWO_SERVERS_LB,
    "single_server": SINGLE_SERVER,
    "heavy_inj_single_server": HEAVY_INJ_SINGLE_SERVER,
    "event_inj_lb": EVENT_INJ_LB,
    "two_gen_lb": TWO_GEN_LB,
    "db_pool_k2": DB_POOL_K2,
    "chaos_campaign": CHAOS_CAMPAIGN,
    "outage_retry": OUTAGE_RETRY,
    "trace_parity_resilient": TRACE_PARITY_RESILIENT,
}
#: each fast path's sweep axes for n scenarios (``make_overrides``'
#: arguments), where its sweep has any
FAST_SWEEP_AXES = {"outage_retry": outage_retry_axes}
#: the overload and routing paths: the resilience example's srv-2
#: behind its token bucket, the overload example's ready-queue cap of 8 and
#: its server under a connection cap with the cap and deadline composed, and
#: the mixed fleet's least connections at its 24 MB point
CONTROL_PATHS = {
    "rate_limited_lb": _rate_limited_lb(),
    "overload_cap8": overload_payload(110, {"max_ready_queue": 8}),
    "overload_sockets": overload_payload(110, {"max_connections": 6, "max_ready_queue": 4,
                                               "queue_timeout_s": 0.1}),
    "lc_mixed_fleet": mixed_fleet_payload(24.0, horizon=600),
}
FAST_PAYLOADS.update(CONTROL_PATHS)
#: the resilience paths, which the DES kernel refuses by the feature named
#: the station_scan mode each overload path must launch
CONTROL_MODES = {"rate_limited_lb": "bucket", "overload_cap8": "controlled",
                 "overload_sockets": "socket"}
RESILIENCE_PATHS = {"chaos_campaign": "hazards", "outage_retry": "faults",
                    "trace_parity_resilient": "faults"}
#: the streamed series of the headline's gauge runs and of the chaos
#: campaign (its time to drain reads them): both servers' ready queues at 1 s
GAUGE_SERIES = ("ready_queue_len", ["srv-1", "srv-2"], 1.0)
#: the fast paths that stream a series
GAUGE_PATHS = {"chaos_campaign": GAUGE_SERIES}

MAIN_SCENARIOS = 2048
#: a pool too large for shared memory (des_kernel.cu, layout_of)
POOL_GLOBAL = 2048
#: iteration cap of the kernel-against-twin check on the headline's plan:
#: every scenario truncates after ~4 s of simulated time, which keeps the
#: twin (one batched step per event) under a minute on the card (8,000
#: iterations took 88.7–107.9 s, varying with the card's host: the smoke's
#: whole run must stay well inside its time limit; 5,000 until the fast
#: path's overload and routing paths joined it; 3,500 until the
#: observability planes joined it)
CHECK_ITERATIONS = 2500
#: the same for event_inj_lb's plan (~12 s simulated at ~40 req/s; 4,000
#: before)
PATH_CHECK_ITERATIONS = 3000
#: the same for resilience_all's plan (~8 s simulated; 3,000 before the
#: observability planes joined the smoke)
RESILIENCE_CHECK_ITERATIONS = 2000
#: the same for the three workload paths' plans: db_pool_k2 ~13 s
#: simulated of its 120 s, llm_cost ~12 s of its 60 s (at ~20 req/s),
#: two_gen_lb ~2 s (at ~133 req/s; 2,000 each earlier, 1,500
#: before the observability planes joined it)
WORKLOAD_CHECK_ITERATIONS = {"db_pool_k2": 1000, "llm_cost": 1000, "two_gen_lb": 1000}
#: event_inj_lb's windows, scaled into the capped check's simulated time:
#: they end by 8.1 s
EVENT_CHECK_TIME_SCALE = 0.015
#: the JAX reference kernel on each path's payload at its full horizon:
#: pooled p95 (seconds), pooled rejected fraction and mean LLM cost per
#: completed request of PallasEngine(interpret=True) on scenarios 0..31 of
#: seed 0, on the CPU (``python tests/test_torch_sweep.py --reference-p95
#: PAYLOAD``; seed 1 gave p95 0.043318 s on event_inj_lb, 0.110563 s and
#: rejected 0.1088 on resilience_all, 0.315260 s and cost 0.0049974 on
#: llm_cost, 0.034884 s on two_gen_lb).  db_pool_k2 sits at its pool's
#: knee with three user windows a scenario, so 32 scenarios leave its p95
#: noisy (0.154331 s and 0.152133 s for seeds 0 and 1): its reference is
#: scenarios 0..511 of seed 0 (``--scenarios 512``; seed 1: 0.156076 s)
REFERENCE = {
    "two_servers_lb": {"p95_s": 0.03367207812033652},
    "event_inj_lb": {"p95_s": 0.0433515210548253},
    "resilience_all": {"p95_s": 0.11077346238864245, "rejected_fraction": 0.10566745651478299},
    "db_pool_k2": {"p95_s": 0.1565684807965334},
    "llm_cost": {
        "p95_s": 0.31500274456957533, "llm_cost_per_request": 0.0049984672740168035,
    },
    "two_gen_lb": {"p95_s": 0.03485854068297543},
}
#: the JAX scan fast path on each fast payload at its full horizon: pooled
#: p95 (seconds) of FastEngine on scenarios 0..31 of seed 0, on the CPU
#: (``python tests/test_torch_sweep.py --reference-p95 PAYLOAD --engine
#: fast``; seed 1 gave 0.033682255 s, 0.119988049 s, 3.238123915 s,
#: 0.043351474 s and 0.034868085 s); db_pool_k2 at its pool's knee on
#: scenarios 0..2047 (``--scenarios 2048``: 512 gave 0.155738 s and
#: 0.158149 s for seeds 0 and 1; 2048 of seed 1 gave 0.156589189 s)
REFERENCE_FAST = {
    # the resilience paths through the reference's SweepRunner(engine="fast")
    # (its campaign sampling, its make_overrides of FAST_SWEEP_AXES) on
    # scenarios 0..2047 of seed 0, with chaos_campaign's scorecard of the
    # sampled tables, which the port must equal exactly (the same tables);
    # trace_parity_resilient completes nothing (its own invariants hold it)
    "chaos_campaign": {"p95_s": 0.03407380965208954,
                       "unavailable_s_total": 690886.5336279869,
                       "hazard_truncated_total": 33},
    "outage_retry": {"p95_s": 0.027960222587827138},
    "two_servers_lb": {"p95_s": 0.03368371799103881},
    "single_server": {"p95_s": 0.12000647249175632},
    "heavy_inj_single_server": {"p95_s": 3.2386658959732046},
    "event_inj_lb": {"p95_s": 0.04334861363138333},
    "two_gen_lb": {"p95_s": 0.034871473184246715},
    "db_pool_k2": {"p95_s": 0.1565345446763432},
    # the overload and routing paths through the reference's
    # SweepRunner(engine="fast") on scenarios 0..2047 of seed 0, with their
    # rejected fractions
    "rate_limited_lb": {"p95_s": 0.055575036266824564, "rejected_fraction": 0.3850285003265662},
    "overload_cap8": {"p95_s": 0.28224541471622583, "rejected_fraction": 0.10521060837581807},
    "overload_sockets": {"p95_s": 0.14099077131015, "rejected_fraction": 0.1613944272360538},
    "lc_mixed_fleet": {"p95_s": 0.154020766943107, "rejected_fraction": 0.0},
}
#: horizon of the fast kernels' check against their plain versions, and
#: its scenarios
FAST_CHECK_HORIZON = 60
FAST_CHECK_SCENARIOS = 64
#: station_scan's carry widths phase 4 holds to the plain versions on
#: synthetic streams: (mode, RAM slots, cores) at the edges of the warp
#: walk's width classes for either vector (whole on every lane up to 4,
#: then spread over the lanes) up to the widest it holds (1024), and one
#: core vector past it (the global-scratch walk); rows of the check, and
#: their elements (no multiple of 4: most rows start unaligned)
SCAN_WIDTH_CASES = (
    [("kw", 0, cores) for cores in (2, 4, 5, 8, 9, 33, 1025)]
    + [("ram_core", slots, 1) for slots in (1, 4, 5, 31, 32, 33, 64, 65, 1024)]
    + [("ram_core", 5, 5), ("ram_core", 20, 33), ("ram_core", 8, 1025)]
)
SCAN_CHECK_ROWS = 2048
SCAN_CHECK_ELEMENTS = 4099
P95_RTOL = 0.02
REJECTED_ATOL = 0.02
LLM_COST_RTOL = 0.02
#: events of every path as the earlier slices measured them (2048 scenarios
#: of seed 0): their draws must not move
EARLIER_EVENTS = {
    "two_servers_lb": 801_523_693,
    "event_inj_lb": 240_485_118,
    "resilience_all": 289_381_512,
    "db_pool_k2": 19_463_015,
    "llm_cost": 9_792_677,
    "two_gen_lb": 801_606_937,
}
#: each path's kernel time with the kernel's earlier design, one thread a
#: scenario, measured by this script on an NVIDIA H100 80GB HBM3 at 700 W
THREAD_KERNEL_MS = {
    "two_servers_lb": 2493.6,
    "event_inj_lb": 901.6,
    "resilience_all": 15336.9,
    "db_pool_k2": 117.4,
    "llm_cost": 327.7,
    "two_gen_lb": 2882.3,
}

# NVIDIA H100 SXM peaks: HBM3 bandwidth and fp32 outside the tensor cores
# from the data sheet; int32 at the SM's issue rate, 128 lanes a clock (four
# schedulers, a warp instruction each: the 64 int32 lanes and the integer
# adds the compiler issues to the fp32 lanes as IMAD) on 132 SMs at the
# 1.98 GHz boost clock.  The 64-lane rate is no bound: edge_draws' uniform
# mode ran 0.687 ms against the 0.925 ms it gives (NVIDIA H100 80GB HBM3,
# 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_INT32_OPS_PER_S = 132 * 128 * 1.98e9
#: float64 outside the tensor cores, from the same data sheet
PEAK_FP64_OPS_PER_S = 34e12

# (int32, fp32) operations of the simulation's work: per threefry block, per
# pool slot an event's argmin considers, per event and per unit of each
# feature's work
#: threefry2x32: key word 2 (2 xor), 2 input adds, 20 rounds of add, rotate
#: and xor, 5 key injections of 3 adds; the counter word (shift, add); u24
#: on both words (2 shifts; 2 converts and 2 multiplies)
THREEFRY_OPS = (83, 4)
#: pool_min, per slot: a float compare and two selects
ARGMIN_SLOT_OPS = (2, 1)
#: the event loop itself: fminf and the horizon test; two counters, the
#: cap test and the branch switch
EVENT_OPS = (4, 2)
#: a spike breakpoint lookup, per breakpoint: a float compare and an add
SPIKE_BREAKPOINT_OPS = (1, 1)
#: a timeline pop: the entry's three reads and the pointer step, then per LB
#: slot of the rotation a compare and a move
TIMELINE_OPS = (4, 0)
ROTATION_SLOT_OPS = (2, 0)
#: the breaker's admission at an LB arrival, per LB slot: the cooldown test
#: (a float compare) and the admit test (two compares)
BREAKER_SLOT_OPS = (2, 1)
#: a breaker report: the state read, the probe and failure counters, the
#: threshold test and the writes
BREAKER_REPORT_OPS = (6, 0)
#: a token refill: subtract, multiply, add, min, compare and subtract
REFILL_OPS = (1, 5)
#: an abandon's own bookkeeping (its core handoff is the handoff's)
ABANDON_OPS = (4, 0)
#: a draw of an LLM token loop past its threefry block: 1 - u, the clamp,
#: the log (one), the negation, the add and the limit test; the seq step
#: and the loop test
LLM_DRAW_OPS = (2, 5)
#: a cache draw past its threefry block: the hit test and the select
CACHE_DRAW_OPS = (1, 1)
#: a request joining a DB queue: the free / waiter tests, the ticket and
#: counter updates and the slot's three writes
DB_WAIT_OPS = (7, 0)
#: a DB handoff to a waiter: per pool slot the waiter scan's event, server
#: and ticket compares (DB_SCAN_SLOT_OPS); then the duration lookup, the
#: counter and the slot's three writes
DB_SCAN_SLOT_OPS = (3, 0)
DB_GRANT_OPS = (6, 1)
#: per spawn with several generators, per generator: the next-arrival
#: compare and select
GEN_MIN_OPS = (1, 1)


def operation_count(tables, out) -> tuple[int, int]:
    """(int32, fp32) operations of one run, from its own outputs.

    Every event pays the loop and the pool argmin.  Threefry blocks are
    counted per event kind: each spawn draws its arrival gap and its first
    entry edge, and each completed request also drew its other entry edges,
    the LB edge (where the plan has an LB), the endpoint pick and the exit
    edge; each of those edge draws also looks up the spike breakpoint where
    the plan has spikes.  Where the LB has a breaker, each completed request
    passed its admission over every LB slot.  Timeline pops, token refills,
    breaker reports, abandons, the draws of LLM token loops, cache draws,
    DB waits and DB handoffs (each a threefry block or a pool scan where
    the kernel does one) are the kernel's own counts (``work``); with
    several generators each spawn finds the earliest next arrival.
    This is a lower count: the draws of requests that were dropped,
    overflowed, rejected or are still in flight past those, window
    crossings of the arrival sampler, second blocks of normal draws and
    Poisson loops are left out, as are the branches' other float work (a
    libm call would count as one), the first-free-slot scan and the core
    and RAM waiter scans.
    """
    from asyncflow_tpu_torch.engines.torchsim.des_reference import WORK_KINDS

    events = int(out.n_events.sum().item())
    completed, generated = (int(x) for x in out.momi[:, :2].sum(dim=0).tolist())
    work = dict(zip(WORK_KINDS, (int(x) for x in out.work.sum(dim=0).tolist())))
    edges_per_completed = (tables.entry_edges.numel() - 1) + (tables.n_lb > 0) + 1
    edge_draws = generated + edges_per_completed * completed
    blocks = (generated + out.n_events.numel() + edge_draws + completed
              + work["llm_token_draws"] + work["cache_draws"])
    el = max(tables.n_lb, 1)
    breaker_slots = completed * el if tables.breaker_threshold > 0 else 0
    counts = (
        (events, EVENT_OPS),
        (events * tables.pool, ARGMIN_SLOT_OPS),
        (blocks, THREEFRY_OPS),
        (edge_draws * tables.n_spikes, SPIKE_BREAKPOINT_OPS),
        (work["timeline_pops"], TIMELINE_OPS),
        (work["timeline_pops"] * el, ROTATION_SLOT_OPS),
        (breaker_slots, BREAKER_SLOT_OPS),
        (work["breaker_reports"], BREAKER_REPORT_OPS),
        (work["token_refills"], REFILL_OPS),
        (work["abandons"], ABANDON_OPS),
        (work["llm_token_draws"], LLM_DRAW_OPS),
        (work["cache_draws"], CACHE_DRAW_OPS),
        (work["db_waits"], DB_WAIT_OPS),
        (work["db_grants"] * tables.pool, DB_SCAN_SLOT_OPS),
        (work["db_grants"], DB_GRANT_OPS),
        (generated * tables.n_gen if tables.n_gen > 1 else 0, GEN_MIN_OPS),
    )
    int_ops = sum(n * ops[0] for n, ops in counts)
    fp_ops = sum(n * ops[1] for n, ops in counts)
    return int_ops, fp_ops


class SmokeError(RuntimeError):
    """A phase failed."""


def _run(cmd: list[str]) -> str:
    out = subprocess.run(  # noqa: S603 - fixed argv, no shell
        cmd, capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def card_line() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


#: the kernels redesigned for this card whose instances must not spill
#: (their ptxas lines are kept for the summary line): (library, kernel)
REDESIGNED = (("lb_route", "lc_kernel"), ("edge_draws", "hop_kernel"),
              ("station_scan", "bucket_warp_kernel"), ("station_scan", "lane_walk_kernel"),
              ("edge_draws", "gap_sum_kernel"), ("gauge_grid", "gauge_shared_kernel"),
              ("gauge_grid", "gauge_global_kernel"), ("station_scan", "tree_walk_kernel"),
              ("blame_grid", "blame_partial_kernel"))
#: the dependent clocks of one valid element's chain in the redesigned
#: station_scan walks, read from their SASS (sm_90a): the bucket's tokens
#: (add, min, compare, select), the socket scan's connections (the
#: refusal's compare, the shed and deadline tests, the exit's selects, the
#: insertion's compare and select) and the controlled scan's cores (the
#: grant's max, the wait's subtract, the deadline's compare, the select and
#: the core's add); a row's chain floor is its valid elements times these
#: clocks at the card's SM clock
SCAN_CHAIN_CLOCKS = {"bucket": 18, "socket": 52, "controlled": 22}
#: the parent tree's times of this slice's redesigned kernels, (path, kind)
#: -> text: the LB hop by slot and least connections' candidates (the
#: parent's two hops without sums) at the path's own calls, by
#: scripts/torch_hop_times.py --tree the parent's checkout, its two turns in
#: one call with this tree's (parent, change, change, parent; NVIDIA H100
#: 80GB HBM3, 700 W)
PARENT_MS = {
    ("event_inj_lb", "hop_slot_spike"): "1.6511, 1.6544 ms",
    ("lc_mixed_fleet", "candidates"): "1.1172, 1.1412 ms in two launches",
}
#: ptxas' registers and spills of the redesigned kernels' instances
REDESIGNED_PTXAS: dict = {}


def phase_setup(torch) -> None:
    from asyncflow_tpu_torch.engines.torchsim import _build

    info = {
        "card": card_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": _run([_build.nvcc_path(), "--version"]).splitlines()[-1],
    }
    print(f"card: {info['card']}")
    print(f"torch {info['torch']} (CUDA {info['cuda']}); nvcc: {info['nvcc']}")
    t0 = time.perf_counter()
    paths = _build.build()
    info["build_s"] = time.perf_counter() - t0
    print(f"built {sorted(paths)} in {info['build_s']:.2f} s")
    for name, report in _build.ptxas_report.items():
        for instance, res in ptxas_instances(report).items():
            print(f"  ptxas[{name}] {instance}: {res}")
        if name in ("edge_draws", "station_scan", "lb_route", "gauge_grid", "blame_grid"):
            for entry, res in ptxas_entries(report).items():
                print(f"  ptxas[{name}] {entry}: {res}")
                if any(name == lib and entry.startswith(k) for lib, k in REDESIGNED):
                    REDESIGNED_PTXAS[entry] = res
    spilled = {e: r for e, r in REDESIGNED_PTXAS.items()
               if "0 bytes spill stores, 0 bytes spill loads" not in r}
    if spilled or not REDESIGNED_PTXAS:
        raise SmokeError(f"a redesigned kernel's instance spills (or ptxas named none): "
                         f"{spilled}")
    for name, plan in _path_plans().items():
        print(f"  {name}: {_layout_text(kernel_layout(plan))}")


def ptxas_instances(report: str) -> dict:
    """Registers and spills of each DES kernel instance in a ``ptxas -v``
    log, by its feature groups."""
    import re

    out, current = {}, None
    for line in report.splitlines():
        found = re.search(
            r"Compiling entry function '\S*des_kernelILb([01])ELb([01])ELb([01])E", line,
        )
        if found:
            flags = (int(x) for x in found.groups())
            current = "des_kernel<events={}, controls={}, workload={}>".format(*flags)
            out[current] = ""
        elif current is not None and ("spill" in line or "registers" in line):
            out[current] += (" " if out[current] else "") + line.split(":", 2)[-1].strip()
    return out


def _kernel_name(mangled: str) -> str:
    """A kernel's name in a mangled entry name: the length-prefixed name
    that ends in ``_kernel``, with an instance's integer and bool template
    arguments (``station_scan_warp_kernel<2, 2, 32, 1, 1>``,
    ``hop_kernel<true>``)."""
    import re

    i, name = 0, mangled
    while i < len(mangled):
        digits = re.match(r"\d+", mangled[i:])
        if not digits:
            i += 1
            continue
        start = i + len(digits.group())
        part = mangled[start:start + int(digits.group())]
        if part.endswith("_kernel"):
            name = part
            break
        i = start + len(part)
    if name == mangled:
        found = re.search(r"[a-z]+(?:_[a-z]+)*_kernel", mangled)
        name = found.group() if found else mangled
    # integer and bool template arguments (hop_kernel<true>)
    args = [v if kind == "i" else ("true" if v == "1" else "false")
            for kind, v in re.findall(r"L([ib])(\d+)E", mangled)]
    return name + ("<" + ", ".join(args) + ">" if args else "")


def ptxas_entries(report: str) -> dict:
    """Registers and spills of each entry function in a ``ptxas -v`` log,
    by kernel and instance (station_scan's warp walk: mode, then the
    RAM-slot and the core vector's entries a lane and lanes spanned;
    lb_route's count: its marks a pass)."""
    import re

    out, current = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = _kernel_name(entry.group(1))
            out[current] = ""
        elif current is not None and ("spill" in line or "registers" in line):
            out[current] += (" " if out[current] else "") + line.split(":", 2)[-1].strip()
    return out


def kernel_layout(plan) -> dict:
    """The DES kernel's layout and occupancy for ``plan`` on this card."""
    from asyncflow_tpu_torch.engines.torchsim import des_kernel
    from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine

    return des_kernel.launch_layout(KernelEngine(plan, device="cuda").tables)


def _layout_text(lay: dict) -> str:
    inst = lay["instance"]
    return (
        f"instance events={int(inst['events'])} controls={int(inst['controls'])} "
        f"workload={int(inst['workload'])}; pool placement {lay['placement']} "
        f"({lay['shared_fields']} fields shared), "
        f"{lay['warps_per_block']} scenarios a block, "
        f"{lay['shared_bytes']} shared bytes a block, {lay['global_words'] * 4} global "
        f"bytes a scenario; {lay['blocks_per_sm']} blocks = "
        f"{lay['warps_per_sm']} warps an SM"
    )


def _path_plans() -> dict:
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.schemas import SimulationPayload

    return {
        name: compile_payload(SimulationPayload.from_dict(data))
        for name, data in PAYLOADS.items()
    }


def _lc_mixed_payload() -> dict:
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["sim_settings"]["total_simulation_time"] = 5
    data["topology_graph"]["nodes"]["load_balancer"]["algorithms"] = "least_connection"
    edges = data["topology_graph"]["edges"]
    edges[1]["latency"] = {"mean": 0.002, "distribution": "normal", "variance": 0.001}
    edges[2]["latency"] = {"mean": 0.001, "distribution": "log_normal", "variance": 0.1}
    edges[3]["latency"] = {"mean": 0.003, "distribution": "uniform"}
    edges[4]["latency"] = {"mean": 0.002, "distribution": "poisson"}
    edges[5]["dropout_rate"] = 0.05
    return data


def _single_server_payload(users: float, steps: list, **server) -> dict:
    """5 s of one server behind the client, no LB; ``users`` x 20 req/min."""
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["sim_settings"]["total_simulation_time"] = 5
    data["rqs_input"]["avg_active_users"] = {"mean": users}
    nodes = data["topology_graph"]["nodes"]
    del nodes["load_balancer"]
    srv = nodes["servers"][0]
    srv["endpoints"][0]["steps"] = steps
    srv.update(server)
    nodes["servers"] = [srv]
    data["topology_graph"]["edges"] = [
        {"id": "gen-client", "source": "rqs-1", "target": "client-1",
         "latency": {"mean": 0.003, "distribution": "exponential"}},
        {"id": "client-srv", "source": "client-1", "target": "srv-1",
         "latency": {"mean": 0.002, "distribution": "exponential"}},
        {"id": "srv-client", "source": "srv-1", "target": "client-1",
         "latency": {"mean": 0.003, "distribution": "exponential"}},
    ]
    return data


def _cpu_io(cpu: float, io: float) -> list:
    return [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": cpu}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": io}},
    ]


def _ram_bound_payload() -> dict:
    """One server whose RAM admits two requests at a time under ~90% load."""
    steps = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "ram", "step_operation": {"necessary_ram": 128}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.09}},
    ]
    return _single_server_payload(
        60, steps, server_resources={"cpu_cores": 1, "ram_mb": 256},
    )


#: one overload control each, on one server at a load where it binds
#: (the reference's parity fixtures, tests/parity/test_pallas_engine.py)
CONTROL_PAYLOADS = {
    "queue_cap_3": lambda: _single_server_payload(
        60, _cpu_io(0.040, 0.010), overload={"max_ready_queue": 3}),
    "conn_cap_4": lambda: _single_server_payload(
        60, _cpu_io(0.002, 0.200), overload={"max_connections": 4}),
    "rate_limit_6rps": lambda: _single_server_payload(
        45, _cpu_io(0.002, 0.010), overload={"rate_limit_rps": 6.0, "rate_limit_burst": 6}),
    "deadline_120ms": lambda: _single_server_payload(
        67.5, _cpu_io(0.045, 0.010), overload={"queue_timeout_s": 0.120}),
}


def _lc_breaker_outage_payload() -> dict:
    """5 s, least connection with the breaker, a rate-limited srv-2 and a
    srv-1 outage: the LC branch of the breaker's pick, and a slot removed
    from an LC rotation."""
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["sim_settings"]["total_simulation_time"] = 5
    data["rqs_input"]["avg_active_users"] = {"mean": 60}
    nodes = data["topology_graph"]["nodes"]
    nodes["load_balancer"]["algorithms"] = "least_connection"
    nodes["load_balancer"]["circuit_breaker"] = {
        "failure_threshold": 3, "cooldown_s": 1.0, "half_open_probes": 2,
    }
    nodes["servers"][1]["overload"] = {"rate_limit_rps": 4.0, "rate_limit_burst": 4}
    data["events"] = [{
        "event_id": "srv1-down", "target_id": "srv-1",
        "start": {"kind": "server_down", "t_start": 1.5},
        "end": {"kind": "server_up", "t_end": 3.0},
    }]
    return data


def _cache_payload() -> dict:
    """5 s of the cache-dynamics parity payload's single server (~17 req/s):
    CPU 2 ms, then a cache that hits in 2 ms with probability 0.8 and misses
    in 50 ms (tests/parity/test_cache_dynamics.py, ``_payload``)."""
    steps = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "io_cache", "step_operation": {"io_waiting_time": 0.002},
         "cache_hit_probability": 0.8, "cache_miss_time": 0.050},
    ]
    return _single_server_payload(
        50, steps, server_resources={"cpu_cores": 1, "ram_mb": 1024},
    )


def _db_single_payload() -> dict:
    """5 s at 7.5 req/s through one DB connection held 30 ms
    (tests/parity/test_pallas_engine.py, ``test_db_pool_conservation``)."""
    steps = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "io_db", "step_operation": {"io_waiting_time": 0.030}},
    ]
    return _single_server_payload(
        22.5, steps,
        server_resources={"cpu_cores": 1, "ram_mb": 1024, "db_connection_pool": 1},
    )


def _featured_payload() -> dict:
    """5 s of tests/parity/test_pallas_engine.py's featured mix at 7.5
    req/s: a DB pool of 2, a cache mixture, an LLM call of Poisson(40)
    tokens and weighted endpoints on one server."""
    endpoints = [
        {
            "endpoint_name": "/mixed",
            "selection_weight": 3.0,
            "steps": [
                {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
                {"kind": "io_cache", "step_operation": {"io_waiting_time": 0.002},
                 "cache_hit_probability": 0.8, "cache_miss_time": 0.050},
                {"kind": "io_db", "step_operation": {"io_waiting_time": 0.020}},
            ],
        },
        {
            "endpoint_name": "/llm",
            "selection_weight": 1.0,
            "steps": [
                {"kind": "io_llm", "step_operation": {"io_waiting_time": 0.004},
                 "llm_tokens_mean": 40.0, "llm_time_per_token": 0.0005,
                 "llm_cost_per_token": 0.01},
            ],
        },
    ]
    return _single_server_payload(
        22.5, [], endpoints=endpoints,
        server_resources={"cpu_cores": 1, "ram_mb": 1024, "db_connection_pool": 2},
    )


def _second_stream(data: dict) -> dict:
    """``data`` with a second stream of 10 users x 60 req/min (window 4 s)
    entering the client over its own exponential 4 ms edge."""
    data["rqs_input"] = [data["rqs_input"], {
        "id": "rqs-2",
        "avg_active_users": {"mean": 10},
        "avg_request_per_minute_per_user": {"mean": 60},
        "user_sampling_window": 4,
    }]
    data["topology_graph"]["edges"].append({
        "id": "gen2-client", "source": "rqs-2", "target": "client-1",
        "latency": {"mean": 0.004, "distribution": "exponential"},
    })
    return data


def _two_gen_normal_payload() -> dict:
    """5 s of the headline topology with two streams (7.5 + 10 req/s), the
    first entering over a normal edge (tests/parity/test_pallas_engine.py,
    ``test_multi_generator_normal_edge_parity``)."""
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["sim_settings"]["total_simulation_time"] = 5
    data["rqs_input"]["avg_active_users"] = {"mean": 22.5}
    data["topology_graph"]["edges"][0]["latency"] = {
        "mean": 0.004, "distribution": "normal", "variance": 0.002,
    }
    return _second_stream(data)


def _two_gen_events_payload() -> dict:
    """event_inj_lb's outages and spikes scaled into 5 s, with a second
    stream (40 + 10 req/s)."""
    data = copy.deepcopy(EVENT_INJ_LB)
    scale = 0.875 * 5 / data["sim_settings"]["total_simulation_time"]
    data["sim_settings"]["total_simulation_time"] = 5
    for event in data["events"]:
        event["start"]["t_start"] *= scale
        event["end"]["t_end"] *= scale
    return _second_stream(data)


#: the workload group's 5 s plans, each with the work it must show
WORKLOAD_PAYLOADS = {
    "cache_mixture": (_cache_payload, ("cache_draws",)),
    "db_pool_1": (_db_single_payload, ("db_waits", "db_grants")),
    "featured_mix": (_featured_payload, ("llm_token_draws", "cache_draws")),
    "two_gen_normal_entry": (_two_gen_normal_payload, ()),
    "two_gen_event_inj": (_two_gen_events_payload, ("timeline_pops",)),
}


def time_kernel(torch, fn, repeats: int) -> float:
    """Median milliseconds of ``fn()`` between CUDA events.  Part of this
    script's interface, with ``PAYLOADS`` and ``card_line``:
    ``scripts/torch_des_scaling.py`` times the kernel with it."""
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def _bound_ms(args: tuple, out) -> dict:
    """The least time for the work of one launch: the larger of the bytes
    moved (each input read once, each output written once) over the memory
    rate and the operations over the peak rate of their type (int32 and
    fp32 run on separate lanes, so the larger of the two)."""
    tables = args[0]
    inputs = [*tables.tensors(), *args[1:]]
    moved = sum(x.numel() * x.element_size() for x in [*inputs, *out])
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    int_ops, fp_ops = operation_count(tables, out)
    t_ops = max(int_ops / PEAK_INT32_OPS_PER_S, fp_ops / PEAK_FP32_OPS_PER_S) * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
    }


def _bound_text(b: dict) -> str:
    return (
        f"bound {b['bound_ms']:.4g} ms ({b['bound_by']}; bytes {b['bytes_ms']:.4g} ms, "
        f"operations {b['operations_ms']:.4g} ms)"
    )


def _check_case(torch, name: str, eng, args, n: int) -> dict:
    """The kernel against its twin on the same arguments: every output
    bit-exact."""
    from asyncflow_tpu_torch.engines.torchsim.des_reference import WORK_KINDS, des_reference

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = des_reference(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = eng.kernel(*args)
    torch.cuda.synchronize()
    for field in ("hist", "thr", "momi", "trunc", "n_events", "work"):
        a, b = getattr(got, field), getattr(twin, field)
        if not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(dim=1).nonzero()[:5, 0].tolist()
            msg = f"{name}: kernel and twin differ in {field} (scenarios {bad})"
            raise SmokeError(msg)
    err = (got.momf - twin.momf).abs()
    if not torch.equal(got.momf, twin.momf):
        msg = f"{name}: float moments differ by up to {err.max().item()}"
        raise SmokeError(msg)
    momi = got.momi.sum(dim=0).tolist()
    result = {
        "out": got,
        "plain_ms": plain_ms,
        "max_abs_err": err.max().item(),
        "events": int(got.n_events.sum().item()),
        "truncated": int(got.trunc.sum().item()),
        "momi": momi,
        "work": dict(zip(WORK_KINDS, got.work.sum(dim=0).tolist())),
    }
    print(
        f"kernel == twin on {name}: {n} scenarios, pool {eng.plan.pool_size}, "
        f"{result['events']} events, completed {momi[0]}, generated {momi[1]}, "
        f"dropped {momi[2]}, overflow {momi[3]}, rejected {momi[4]}, "
        f"truncated {result['truncated']}; twin {plain_ms / 1e3:.1f} s",
        flush=True,
    )
    return result


def phase_kernel_vs_twin(torch) -> dict:
    """Phase 2: the kernel against its twin on the card.

    Each path's own plan at the path's 2048 scenarios, with only its
    iteration cap lowered (and, for event_inj_lb, its windows scaled into
    the capped time), so every tensor has the path's shape and the
    truncation path is checked too; then 5 s plans that reach the other
    branches: LC routing over every edge distribution, a binding RAM with
    an overflowing pool, each overload control, an LC breaker with an
    outage, and the workload group's plans.  Returns the measurements of
    the path checks by path name."""
    import numpy as np

    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.des_reference import WORK_KINDS
    from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.schemas import SimulationPayload

    def plan_of(data, **kw):
        return compile_payload(SimulationPayload.from_dict(data), **kw)

    scale = np.float32(EVENT_CHECK_TIME_SCALE)
    event_plan = plan_of(EVENT_INJ_LB)
    event_plan = dataclasses.replace(
        event_plan,
        spike_times=event_plan.spike_times * scale,
        timeline_times=event_plan.timeline_times * scale,
        max_iterations=PATH_CHECK_ITERATIONS,
    )
    paths = {
        "two_servers_lb": dataclasses.replace(
            plan_of(TWO_SERVERS_LB), max_iterations=CHECK_ITERATIONS),
        "event_inj_lb": event_plan,
        "resilience_all": dataclasses.replace(
            plan_of(RESILIENCE_ALL), max_iterations=RESILIENCE_CHECK_ITERATIONS),
        **{
            name: dataclasses.replace(plan_of(PAYLOADS[name]), max_iterations=cap)
            for name, cap in WORKLOAD_CHECK_ITERATIONS.items()
        },
    }
    #: the work each workload path's capped check must show
    path_work = {"db_pool_k2": ("db_waits", "db_grants"), "llm_cost": ("llm_token_draws",)}
    small = {
        "lc_mixed_dists": (plan_of(_lc_mixed_payload()), 128),
        "ram_bound_overflow": (plan_of(_ram_bound_payload(), pool_size=4), 256),
        "ram_bound_pool_37": (plan_of(_ram_bound_payload(), pool_size=37), 256),
        "ram_bound_pool_2048": (plan_of(_ram_bound_payload(), pool_size=POOL_GLOBAL), 128),
        **{name: (plan_of(make()), 128) for name, make in CONTROL_PAYLOADS.items()},
        "lc_breaker_outage": (plan_of(_lc_breaker_outage_payload()), 128),
        **{name: (plan_of(make()), 256) for name, (make, _) in WORKLOAD_PAYLOADS.items()},
    }
    measured: dict = {"max_abs_err": 0.0}
    placements = set()
    for name, plan in [*paths.items(), *((n, p) for n, (p, _) in small.items())]:
        lay = kernel_layout(plan)
        placements.add(lay["placement"])
        if name == "ram_bound_pool_2048" and lay["placement"] != "global":
            raise SmokeError(f"{name}: placement {lay['placement']}, expected global")
    if placements != {"scan_shared", "global"}:
        raise SmokeError(f"phase 2 checks the placements {sorted(placements)} only")
    for name, plan in paths.items():
        case = f"{name}_{plan.horizon:.0f}s_capped"
        eng = KernelEngine(plan, device="cuda")
        args = eng.prepare(scenario_keys(0, MAIN_SCENARIOS, device="cuda"))
        res = _check_case(torch, case, eng, args, MAIN_SCENARIOS)
        out = res["out"]
        if res["truncated"] != MAIN_SCENARIOS:
            msg = f"{case}: {MAIN_SCENARIOS - res['truncated']} scenarios ended before the cap"
            raise SmokeError(msg)
        if name == "event_inj_lb":
            # every scenario completed requests after the last window closed
            last = float(max(plan.spike_times.max(), plan.timeline_times.max()))
            after = out.thr[:, int(np.ceil(last)):].sum(dim=1)
            pops = out.work[:, WORK_KINDS.index("timeline_pops")]
            if int((after == 0).sum()) or int(pops.min()) != len(plan.timeline_times):
                msg = f"{case}: not every scenario crossed every window (last ends {last} s)"
                raise SmokeError(msg)
        if name == "resilience_all" and res["momi"][4] == 0:
            raise SmokeError(f"{case}: no request was rejected")
        for kind in path_work.get(name, ()):
            if res["work"][kind] == 0:
                raise SmokeError(f"{case}: no {kind}")
        ms = time_kernel(torch, lambda eng=eng, args=args: eng.kernel(*args), repeats=3)
        bound = _bound_ms(args, out)
        measured["max_abs_err"] = max(measured["max_abs_err"], res["max_abs_err"])
        measured[name] = {"ms": ms, "plain_ms": res["plain_ms"], "events": res["events"],
                          **bound}
        print(f"  kernel {ms:.2f} ms, twin {res['plain_ms']:.0f} ms, {_bound_text(bound)}")
    for name, (plan, n) in small.items():
        eng = KernelEngine(plan, device="cuda")
        args = eng.prepare(scenario_keys(0, n, device="cuda"))
        res = _check_case(torch, name, eng, args, n)
        measured["max_abs_err"] = max(measured["max_abs_err"], res["max_abs_err"])
        if name == "ram_bound_overflow" and res["momi"][3] == 0:
            raise SmokeError("the RAM-bound case did not overflow its pool")
        if (name in CONTROL_PAYLOADS or name == "lc_breaker_outage") and res["momi"][4] == 0:
            raise SmokeError(f"{name}: no request was rejected")
        for kind in WORKLOAD_PAYLOADS.get(name, (None, ()))[1]:
            if res["work"][kind] == 0:
                raise SmokeError(f"{name}: no {kind}")
    return measured


def phase_path(torch, name: str) -> dict:
    """Phase 3, one path: ``SweepRunner(payload).run(2048, seed=0)`` at the
    payload's full 600 s through the kernel, with no truncation and no
    overflow, request conservation per scenario, the pooled p95 (and, where
    the reference states it, the rejected fraction) against the JAX
    reference kernel's, then the kernel alone on the same inputs."""
    import numpy as np

    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.parallel import SweepRunner

    ref = REFERENCE[name]
    runner = SweepRunner(PAYLOADS[name], engine="kernel", device="cuda")
    kernel = runner.engine.kernel
    kernel.launches = 0
    report = runner.run(MAIN_SCENARIOS, seed=0)
    launches = kernel.launches
    if launches < 1:
        raise SmokeError(f"{name}: the sweep did not launch the DES kernel")
    summary = report.summary()
    res = report.results
    if summary["truncated_total"] != 0 or summary["overflow_total"] != 0:
        msg = (
            f"{name}: truncated {summary['truncated_total']}, "
            f"overflow {summary['overflow_total']}"
        )
        raise SmokeError(msg)
    in_flight = (
        res.total_generated - res.completed - res.total_dropped - res.overflow_dropped
        - res.total_rejected
    )
    if np.any(in_flight < 0) or np.any(in_flight > runner.plan.pool_size):
        msg = (
            f"{name}: conservation broken: in-flight range "
            f"[{in_flight.min()}, {in_flight.max()}]"
        )
        raise SmokeError(msg)
    for key in ("latency_p50_s", "latency_p95_s", "latency_p99_s", "latency_mean_s"):
        if not np.isfinite(summary[key]):
            raise SmokeError(f"{name}: {key} is not finite")
    p95 = summary["latency_p95_s"]
    rel = p95 / ref["p95_s"] - 1.0
    if abs(rel) > P95_RTOL:
        msg = f"{name}: pooled p95 {p95:.6f} s is {rel:+.2%} from the reference {ref['p95_s']}"
        raise SmokeError(msg)
    rejected = float(res.total_rejected.sum() / max(res.total_generated.sum(), 1))
    if "rejected_fraction" in ref and abs(rejected - ref["rejected_fraction"]) > REJECTED_ATOL:
        msg = (
            f"{name}: rejected fraction {rejected:.4f} is off the reference's "
            f"{ref['rejected_fraction']:.4f} by more than {REJECTED_ATOL}"
        )
        raise SmokeError(msg)
    llm_cost = summary["llm_cost_mean_per_request"]
    if "llm_cost_per_request" in ref:
        rel_cost = llm_cost / ref["llm_cost_per_request"] - 1.0
        if abs(rel_cost) > LLM_COST_RTOL:
            msg = (
                f"{name}: mean LLM cost per completed request {llm_cost:.6g} is "
                f"{rel_cost:+.2%} from the reference's {ref['llm_cost_per_request']:.6g}"
            )
            raise SmokeError(msg)
    events = int(res.events.sum())
    if events != EARLIER_EVENTS[name]:
        msg = f"{name}: {events} events, the earlier slices had {EARLIER_EVENTS[name]}"
        raise SmokeError(msg)

    # the kernel alone on the same inputs, between CUDA events
    args = runner.engine.prepare(scenario_keys(0, MAIN_SCENARIOS, device="cuda"))
    out = []
    kernel_ms = time_kernel(torch, lambda: out.append(kernel(*args)), repeats=1)
    bound = _bound_ms(args, out[0])
    lay = kernel_layout(runner.plan)
    print(
        f"path {name}: {MAIN_SCENARIOS} scenarios x {runner.plan.horizon:.0f} s, pool "
        f"{runner.plan.pool_size}, {launches} launch(es), {report.wall_seconds:.2f} s wall, "
        f"{summary['scenarios_per_second']:.1f} scen/s, kernel {kernel_ms:.1f} ms, "
        f"{events} events ({events / (kernel_ms / 1e3):.3e} events/s), "
        f"{_bound_text(bound)}",
        flush=True,
    )
    print(
        f"  p50 {summary['latency_p50_s'] * 1e3:.3f} ms, p95 {p95 * 1e3:.3f} ms "
        f"({rel:+.3%} vs the reference {ref['p95_s'] * 1e3:.3f} ms), "
        f"p99 {summary['latency_p99_s'] * 1e3:.3f} ms, mean "
        f"{summary['latency_mean_s'] * 1e3:.3f} ms; completed {summary['completed_total']}, "
        f"dropped {summary['dropped_total']}, rejected {summary['rejected_total']} "
        f"(fraction {rejected:.4f})"
        + ("" if llm_cost is None else f"; LLM cost per request {llm_cost:.6g}"),
        flush=True,
    )
    print(
        f"  {_layout_text(lay)}; kernel {kernel_ms:.1f} ms against the one-thread "
        f"kernel's {THREAD_KERNEL_MS[name]} ms (x{kernel_ms / THREAD_KERNEL_MS[name]:.4f})",
        flush=True,
    )
    return {
        "launches": launches,
        "ms": kernel_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "events": events,
        "wall_s": report.wall_seconds,
        "scen_per_s": summary["scenarios_per_second"],
        "p95_s": p95,
        "rejected_fraction": rejected,
        "llm_cost_per_request": llm_cost,
    }


# (int32, fp32, fp64) operations of an edge_draws lane: a uniform is one
# threefry block (THREEFRY_OPS' 20 rounds and key injections, the XOR of
# the two words, the mantissa shift and or; the subtract of 1.0); XLA's
# log1p (gaps) in its two branches: Cephes' rational form (the square, the
# divide, four multiplies and adds; 14 Horner steps, each a fused
# multiply-add of two operations) or log(1 + x) (the add, frexp's bit
# operations, 12 float32 operations, 9 fused multiply-adds), the negations;
# the hop's dropout test and rescale (compare, two subtracts, the max, the
# divide), the send gate, the time add, the span (two minima, subtract,
# max) and its float64 add; each delay law (exponential: 1 - u, the max,
# the log, the multiply; normal and lognormal: a second block for z,
# erfinv's log1p, square root and 9-term polynomial, the affine map and
# the max or exp); a spike: a compare a breakpoint and the add; the LB
# slot's modulo; a scan: one add a lane a level and the down-add
UNIFORM_LANE_OPS = (86, 1, 0)
LOG1P_RATIONAL_OPS = (0, 37, 0)
LOG1P_LOG_OPS = (4, 33, 0)
HOP_LANE_OPS = (0, 11, 1)
#: a least-connections candidate, a lane and slot: the hop's but the span
CAND_SLOT_OPS = (0, 7, 0)
LAW_LANE_OPS = {0: (0, 0, 0), 2: (0, 4, 0), 3: (86, 26, 0), 4: (86, 26, 0)}
LB_SLOT_OPS = (1, 0, 0)
SCAN_LANE_OPS = (0, 2, 0)
#: station_scan, an element: Lindley's two selects, add, max, two
#: subtracts and max; a Kiefer-Wolfowitz or RAM-slot step adds a compare a
#: carry entry it moves past (not counted: the data decides); the token
#: bucket's valid test, accept test and three selects, and its subtract,
#: multiply, add, min and spend
SCAN_ELEMENT_OPS = {"waits": (3, 5), "ram_core": (4, 8), "bucket": (5, 5),
                    "controlled": (9, 5), "socket": (14, 9)}
#: a hop lane under fault tables: per step of the row's search (the
#: reference's searchsorted: ceil(log2(NF + 1)) steps, whatever the kernel
#: does) the compare and the select; then the boost's add and clip (max,
#: min) and the factor's multiply
FAULT_SEARCH_STEP_OPS = (1, 1)
FAULT_LANE_OPS = (0, 4)
#: a Kiefer-Wolfowitz element, per core: the insertion's compare and select
KW_CORE_OPS = (1, 1)
#: the controlled scan, an element: the ring's read and the head's step,
#: the cap and deadline tests, the live and flag logic, the stores' selects
#: (9 integer); the ring's compare, the grant's max, the wait's subtract,
#: the deadline's compare and the release's add (5 float); the socket scan
#: adds the refusal's compare, the burst selects and the exit's two adds
#: and selects (14, 9), and a compare and a select a connection for the
#: sorted insertion of the exit (CONN_ENTRY_OPS)
CONN_ENTRY_OPS = (1, 1)


def _ops(lanes, per_lane) -> list:
    return [lanes * x for x in per_lane]


def _log1p_ops(torch, u) -> list:
    """The operations of XLA's log1p on the gaps of uniforms ``u``: each
    lane in its own branch, as this run's uniforms fall."""
    from asyncflow_tpu_torch.engines.torchsim.draws import LOG1P_SMALL

    rational = int((u < LOG1P_SMALL).sum())
    log = u.numel() - rational
    return [a + b for a, b in zip(_ops(rational, LOG1P_RATIONAL_OPS), _ops(log, LOG1P_LOG_OPS))]


def _draws_bound(torch, kind: str, args: tuple, kw: dict) -> dict:
    """The least time of one edge_draws call: bytes (each input read once,
    each output written once) against operations (each lane's threefry
    blocks, float32 and float64 operations, as this call's data takes
    them)."""
    from asyncflow_tpu_torch.engines.torchsim import draws

    if kind in ("uniform", "gap", "gap_cumsum"):
        keys, n = args
        lanes = keys.shape[0] * n
        ops = _ops(lanes, UNIFORM_LANE_OPS)
        if kind != "uniform":
            extra = _log1p_ops(torch, draws.uniform(keys, n))
            if kind == "gap_cumsum":
                extra = [a + b for a, b in zip(extra, _ops(lanes, SCAN_LANE_OPS))]
            ops = [a + b for a, b in zip(ops, extra)]
        return _bound_of(lanes * 4, *ops)
    if kind == "gap_of":
        (u,) = args
        return _bound_of(u.numel() * 8, *_log1p_ops(torch, u))
    if kind.startswith("candidates"):
        # t and alive read once, each slot's t_next and ok written; a
        # threefry block (two with a normal law) a lane and slot, the spike
        # and fault rows searched once a lane
        tables, t_send, _alive, _ukeys, _zkeys, edges = args
        lanes = t_send.numel()
        ops = [0, 0, 0]
        for e in edges:
            per = [a + b + c for a, b, c in zip(UNIFORM_LANE_OPS, CAND_SLOT_OPS,
                                                 LAW_LANE_OPS[int(tables.dist[e])])]
            ops = [a + b for a, b in zip(ops, _ops(lanes, per))]
        return _bound_of(*_hop_table_ops(tables, lanes, ops, len(edges),
                                         lanes * (5 + 5 * len(edges))))
    tables, t_send, alive, _ukey, _zkey = args
    s, n = t_send.shape
    lanes = s * n
    rank, given = kw.get("rank"), kw.get("slot")
    k_slots = 1 if kw.get("edge") is not None else int(tables.lb_edge.shape[0])
    moved = lanes * (4 + 1 + 4 + 1) + s * (4 * k_slots + 8)
    ops = [a + b for a, b in zip(_ops(lanes, UNIFORM_LANE_OPS), _ops(lanes, HOP_LANE_OPS))]
    if kw.get("edge") is not None:
        per_law = {int(tables.dist[kw["edge"]]): lanes}
    else:
        # the rank (8 B) or the slot (4 B) in, the target out
        moved += lanes * ((8 if rank is not None else 4) + 4)
        ops = [a + b for a, b in zip(ops, _ops(lanes, LB_SLOT_OPS))]
        gate = alive & (t_send < float(tables.horizon))
        if rank is not None:
            slot = torch.where(gate, rank % k_slots, 0)
        else:
            slot = torch.where(gate & (given >= 0), given.long(), 0)
        law = torch.as_tensor(tables.dist, device=slot.device).long()[tables.lb_edge.long()[slot]]
        per_law = dict(enumerate(torch.bincount(law.reshape(-1), minlength=5).tolist()))
    for law, count in per_law.items():
        if count:
            ops = [a + b for a, b in zip(ops, _ops(count, LAW_LANE_OPS[law]))]
    return _bound_of(*_hop_table_ops(tables, lanes, ops, 1, moved))


def _hop_table_ops(tables, lanes: int, ops: list, slots: int, moved: int) -> tuple:
    """(bytes, int32, fp32, fp64 operations): ``moved`` and ``ops`` with a
    hop's spike and fault work: a lane's spike search (a compare a
    breakpoint, as the reference's searchsorted scans) and fault row search
    (ceil(log2(NF + 1)) steps) once a lane, each of ``slots`` hops' spike
    add and fault arithmetic, and the fault tables' bytes."""
    ops = list(ops)
    if tables.spike_t is not None:
        nb = int(tables.spike_t.shape[0])
        ops[1] += lanes * (nb + slots)
    if tables.fault_t is not None:
        # each scenario's (or the shared) breakpoints, factors and boosts
        # read once; the row search and the fault's arithmetic a lane
        moved += sum(x.numel() * 4 for x in (tables.fault_t, tables.fault_lat,
                                             tables.fault_drop))
        steps = int(tables.fault_t.shape[-1]).bit_length()  # ceil(log2(NF + 1))
        ops[0] += lanes * (steps * FAULT_SEARCH_STEP_OPS[0] + slots * FAULT_LANE_OPS[0])
        ops[1] += lanes * (steps * FAULT_SEARCH_STEP_OPS[1] + slots * FAULT_LANE_OPS[1])
    return (moved, *ops)


#: lb_route: the table pass's mark test, a lane and a mark (the compare,
#: the add) and its alive test; the lanes pass's alive test, its search's
#: steps (a load, a compare, a select each), the offset, the modulo (about
#: 20 integer operations) and the rotation's load
ROUTE_MARK_OPS = (1, 1)
ROUTE_ALIVE_OPS = (1, 0)
ROUTE_SEARCH_STEP_OPS = (3, 0)
ROUTE_PICK_OPS = (24, 0)
#: least connections, an alive arrival: per ring entry the compare with the
#: arrival and the count's add (LC_ENTRY_OPS); per slot the warp sum and the
#: pick's key and compare (LC_SLOT_OPS); the mark test, the drop read, the
#: replaced entry's minimum, ballot and store (LC_ARRIVAL_OPS)
LC_ENTRY_OPS = (1, 1)
LC_SLOT_OPS = (4, 0)
LC_ARRIVAL_OPS = (12, 0)


def _route_bound(kind: str, args: tuple) -> dict:
    """The least time of one lb_route launch: the table pass reads t and
    alive (5 B a lane) and writes the table; the lanes pass reads the rank,
    alive and the table and writes the slot (13 B a lane); least connections
    reads t, the flag and each slot's candidate delivery and drop (5 + 5 EL
    B an arrival) and writes the pick (4 B); against the operations this
    run's alive lanes need."""
    if kind == "route_lc":
        tl, t, ok, deliv, _drop, ring = args
        lanes, n_alive, el = t.numel(), int(ok.sum()), int(deliv.shape[2])
        moved = lanes * (5 + 5 * el + 4) + tl.n_marks * 12
        int_ops = n_alive * (el * ring * LC_ENTRY_OPS[0] + el * LC_SLOT_OPS[0]
                             + LC_ARRIVAL_OPS[0])
        return _bound_of(moved, int_ops, n_alive * el * ring * LC_ENTRY_OPS[1])
    if kind == "route_table":
        tl, t, alive = args
        lanes, n_alive = t.numel(), int(alive.sum())
        table = t.shape[0] * (tl.n_marks + 1) * (2 + tl.el) * 4
        ops = [lanes * ROUTE_ALIVE_OPS[0] + n_alive * tl.n_marks * ROUTE_MARK_OPS[0],
               n_alive * tl.n_marks * ROUTE_MARK_OPS[1]]
        return _bound_of(lanes * 5 + table + tl.n_marks * 12, *ops)
    table, rank, alive = args
    lanes, n_alive = rank.numel(), int(alive.sum())
    steps = max(1, (table.shape[1] - 1).bit_length())
    int_ops = (lanes * ROUTE_ALIVE_OPS[0]
               + n_alive * (steps * ROUTE_SEARCH_STEP_OPS[0] + ROUTE_PICK_OPS[0]))
    moved = lanes * 13 + table.numel() * table.element_size()
    return _bound_of(moved, int_ops, 0)


def _scan_bound(kind: str, args: tuple) -> dict:
    """The least time of one station_scan launch: each input read once and
    each output written once, against its element operations."""
    tensors = [x for x in args if hasattr(x, "numel")]
    elems = tensors[0].numel()
    # the waits (float), the RAM-core scan's three outputs, the bucket's
    # flags, the controlled and socket scans' waits and flags
    out_bytes = {"waits": 4, "waits_kw": 4, "ram_core": 12, "bucket": 1, "controlled": 5,
                 "socket": 5}[kind]
    moved = sum(x.numel() * x.element_size() for x in tensors) + out_bytes * elems
    ops = SCAN_ELEMENT_OPS["waits" if kind == "waits_kw" else kind]
    int_ops, fp_ops = elems * ops[0], elems * ops[1]
    # the sorted insertion into the K core-free times, by selects (one core:
    # none), and the socket scan's into its connections' exits
    cores = {"waits_kw": args[3] if kind == "waits_kw" else 0,
             "controlled": args[3] if kind == "controlled" else 0,
             "socket": args[6] if kind == "socket" else 0}.get(kind, 0)
    if cores > 1:
        int_ops += elems * cores * KW_CORE_OPS[0]
        fp_ops += elems * cores * KW_CORE_OPS[1]
    if kind == "socket":
        int_ops += elems * args[7] * CONN_ENTRY_OPS[0]
        fp_ops += elems * args[7] * CONN_ENTRY_OPS[1]
    return _bound_of(moved, int_ops, fp_ops)


def _bound_of(moved: int, int_ops: int, fp_ops: int, fp64_ops: int = 0) -> dict:
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max(int_ops / PEAK_INT32_OPS_PER_S, fp_ops / PEAK_FP32_OPS_PER_S,
                fp64_ops / PEAK_FP64_OPS_PER_S) * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
    }


#: the kinds of fast-kernel call: (wrapper name, wrapper method); a hop's
#: kind says whether it takes the LB slots by rank or by slot, the spikes
#: and fault tables, a wait scan's whether it has one server or several
CALL_KINDS = {
    "uniform": ("edge_draws", "uniform"),
    "gap": ("edge_draws", "uniform"),
    "gap_cumsum": ("edge_draws", "gap_cumsum"),
    "gap_of": ("edge_draws", "gap_of"),
    "hop": ("edge_draws", "hop"),
    "hop_lb": ("edge_draws", "hop"),
    "hop_slot": ("edge_draws", "hop"),
    "hop_spike": ("edge_draws", "hop"),
    "hop_lb_spike": ("edge_draws", "hop"),
    "hop_slot_spike": ("edge_draws", "hop"),
    "hop_fault": ("edge_draws", "hop"),
    "hop_lb_fault": ("edge_draws", "hop"),
    "hop_slot_fault": ("edge_draws", "hop"),
    "hop_spike_fault": ("edge_draws", "hop"),
    "hop_lb_spike_fault": ("edge_draws", "hop"),
    "hop_slot_spike_fault": ("edge_draws", "hop"),
    "candidates": ("edge_draws", "candidates"),
    "candidates_spike": ("edge_draws", "candidates"),
    "candidates_fault": ("edge_draws", "candidates"),
    "candidates_spike_fault": ("edge_draws", "candidates"),
    "waits": ("station_scan", "waits"),
    "waits_kw": ("station_scan", "waits"),
    "ram_core": ("station_scan", "ram_core"),
    "bucket": ("station_scan", "bucket"),
    "controlled": ("station_scan", "controlled"),
    "socket": ("station_scan", "socket"),
    "route_table": ("lb_route", "table"),
    "route_slots": ("lb_route", "slots"),
    "route_lc": ("lb_route", "lc"),
}
#: the fast path's kernel wrappers, by name
FAST_KERNELS = ("edge_draws", "station_scan", "lb_route")


def _hop_kind(tables, kw: dict, lanes: str | None = None) -> str:
    """A hop's kind (``lanes``: "candidates" for least connections' one
    launch over every slot)."""
    lanes = lanes or ("hop_lb" if kw.get("rank") is not None
                      else "hop_slot" if kw.get("slot") is not None else "hop")
    return (lanes + ("_spike" if tables.spike_t is not None else "")
            + ("_fault" if tables.fault_t is not None else ""))


def _record_kernel_calls(eng, every: bool) -> list:
    """Put recorders in place of the fast engine's three kernel wrappers;
    each passes the call on and keeps ``(kind, args, kwargs)`` of every
    call (``every``) or of the first call of each kind (a uniform, a gap
    draw, a gap prefix sum, each kind of hop, a timeline table and its
    lanes, each kind of wait scan, a RAM-core scan, a token bucket)."""
    calls: list = []
    draws, scan, route = eng.draws, eng.scan, eng.route

    def keep(kind: str, args: tuple, kw: dict) -> None:
        if every or all(k != kind for k, _, _ in calls):
            calls.append((kind, args, kw))

    class Draws:
        def uniform(self, keys, n, *, gap=False):
            keep("gap" if gap else "uniform", (keys, n), {})
            return draws.uniform(keys, n, gap=gap)

        def gap_cumsum(self, keys, n):
            keep("gap_cumsum", (keys, n), {})
            return draws.gap_cumsum(keys, n)

        def hop(self, tables, *args, **kw):
            keep(_hop_kind(tables, kw), (tables, *args), kw)
            return draws.hop(tables, *args, **kw)

        def candidates(self, tables, *args):
            keep(_hop_kind(tables, {}, "candidates"), (tables, *args), {})
            return draws.candidates(tables, *args)

    class Scan:
        def waits(self, *args):
            keep("waits" if args[3] == 1 else "waits_kw", args, {})
            return scan.waits(*args)

        def ram_core(self, *args):
            keep("ram_core", args, {})
            return scan.ram_core(*args)

        def bucket(self, *args):
            keep("bucket", args, {})
            return scan.bucket(*args)

        def controlled(self, *args):
            keep("controlled", args, {})
            return scan.controlled(*args)

        def socket(self, *args):
            keep("socket", args, {})
            return scan.socket(*args)

    class Route:
        def table(self, *args):
            keep("route_table", args, {})
            return route.table(*args)

        def slots(self, *args):
            keep("route_slots", args, {})
            return route.slots(*args)

        def lc(self, *args):
            keep("route_lc", args, {})
            return route.lc(*args)

    eng.draws, eng.scan, eng.route = Draws(), Scan(), Route()
    return calls


def _wrappers(eng) -> dict:
    return {"edge_draws": eng.draws, "station_scan": eng.scan, "lb_route": eng.route}


def _set_wrappers(eng, wrappers: dict) -> None:
    eng.draws, eng.scan, eng.route = (wrappers[k] for k in FAST_KERNELS)


def _plain_wrappers() -> dict:
    from asyncflow_tpu_torch.engines.torchsim import draws, routing, station_scan

    return {"edge_draws": draws.PlainEdgeDraws(),
            "station_scan": station_scan.PlainStationScan(),
            "lb_route": routing.PlainLbRoute()}


def _call(wrapper, kind: str, args: tuple, kw: dict):
    """One recorded call through ``wrapper`` (a kernel or a plain version),
    its outputs as a tuple."""
    if kind == "gap":
        kw = {**kw, "gap": True}
    out = getattr(wrapper, CALL_KINDS[kind][1])(*args, **kw)
    return out if isinstance(out, tuple) else (out,)


def _compare(torch, label: str, got: tuple, want: tuple) -> float:
    """The largest absolute difference between a kernel's outputs and its
    plain version's; raises unless every output is bit-identical."""
    err = 0.0
    for x, y in zip(got, want, strict=True):
        if x is None and y is None:
            continue
        if x is None or y is None:
            raise SmokeError(f"{label}: the kernel and its plain version return different outputs")
        err = max(err, (x.float() - y.float()).abs().max().item())
        if not torch.equal(x, y):
            raise SmokeError(f"{label}: the kernel differs from its plain version by {err}")
    return err


def _fast_check_payload(data: dict) -> dict:
    """``data`` cut to FAST_CHECK_HORIZON seconds, its events' and fault
    windows' times scaled with it (heavy_inj_single_server's spike then runs
    from 18 s to 30 s, outage_retry's outage from 5 s to 12.5 s)."""
    data = copy.deepcopy(data)
    scale = FAST_CHECK_HORIZON / data["sim_settings"]["total_simulation_time"]
    data["sim_settings"]["total_simulation_time"] = FAST_CHECK_HORIZON
    for event in data.get("events", []):
        event["start"]["t_start"] *= scale
        event["end"]["t_end"] *= scale
    for fault in data.get("fault_timeline", {}).get("events", []):
        fault["t_start"] *= scale
        fault["t_end"] *= scale
    return data


def path_overrides(name: str, plan, n: int, *, hazard_scale: float = 1.0):
    """The overrides a path's sweep of ``n`` scenarios of seed 0 runs: its
    sweep axes (FAST_SWEEP_AXES), and a chaos campaign's fault tables
    sampled for scenarios 0 .. n-1 (MTBF divided by ``hazard_scale``), or
    None for a plain path."""
    from asyncflow_tpu_torch.compiler import hazards
    from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
    from asyncflow_tpu_torch.parallel import make_overrides

    axes = FAST_SWEEP_AXES.get(name)
    ov = make_overrides(plan, n, **axes(n)) if axes else None
    if not plan.has_hazards:
        return ov
    tables = hazards.hazard_fault_tables(plan, 0, 0, n, hazard_scale=hazard_scale)
    return (ov or base_overrides(plan))._replace(
        fault_srv_times=tables.srv_times, fault_srv_down=tables.srv_down,
        fault_edge_times=tables.edge_times, fault_edge_lat=tables.edge_lat,
        fault_edge_drop=tables.edge_drop)


def _fast_engine(torch, data: dict, horizon: float | None = None, **kw):
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.schemas import SimulationPayload

    data = copy.deepcopy(data)
    if horizon is not None:
        data["sim_settings"]["total_simulation_time"] = horizon
    return FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cuda", **kw)


def _scan_width_check(torch, kernel, plain) -> float:
    """station_scan at each of SCAN_WIDTH_CASES against its plain version on
    SCAN_CHECK_ROWS synthetic sorted streams of SCAN_CHECK_ELEMENTS made on
    the card from a seed (half the lanes valid, exponential services and
    post-IO, the station loaded past its cores or slots so that it
    queues); bit-exact, and the walk each case takes counted.  Returns the
    largest difference (0.0)."""
    from asyncflow_tpu_torch.engines.torchsim import station_scan

    err = 0.0
    s, m = SCAN_CHECK_ROWS, SCAN_CHECK_ELEMENTS
    walks = dict.fromkeys(kernel.walk_launches, 0)
    for seed, (mode, slots, cores) in enumerate(SCAN_WIDTH_CASES):
        g = torch.Generator(device="cuda").manual_seed(seed)
        rate = 60.0 * (cores if mode == "kw" else 1)
        a = torch.cumsum(torch.empty((s, m), device="cuda").exponential_(rate, generator=g),
                         dim=1)
        svc = 0.05 if mode == "kw" else 0.01
        d = torch.empty((s, m), device="cuda").exponential_(1.0 / svc, generator=g)
        v = torch.rand((s, m), device="cuda", generator=g) < 0.5
        before = dict(kernel.walk_launches)
        if mode == "kw":
            got = (kernel.waits(a, d, v, cores),)
            want = (plain.waits(a, d, v, cores),)
            waits = want[0]
        else:
            pre = torch.full_like(a, 0.001)
            # residence 1.5 times what the slots hold at the valid lanes' rate
            post = torch.empty((s, m), device="cuda").exponential_(
                30.0 / (1.5 * slots), generator=g)
            d = torch.where(torch.rand((s, m), device="cuda", generator=g) < 0.1, 0.0, d)
            got = kernel.ram_core(a, pre, d, post, v, slots, cores)
            want = plain.ram_core(a, pre, d, post, v, slots, cores)
            waits = want[0]
        label = f"fast check: station_scan {mode} with {slots} RAM slots and {cores} cores"
        err = max(err, _compare(torch, label, got, want))
        if float(waits[v].max()) <= 0.0:
            raise SmokeError(f"{label}: the synthetic station never queues")
        walk = next(k for k, n in kernel.walk_launches.items() if n > before[k])
        walks[walk] += 1
        del a, d, v, got, want, waits
    if walks["warp"] != len(SCAN_WIDTH_CASES) - 2 or walks["global"] != 2:
        raise SmokeError(f"fast check: the width cases took the walks {walks}")
    print(f"fast check: station_scan == plain at {len(SCAN_WIDTH_CASES)} carry widths "
          f"({s} x {m} synthetic streams; walks {walks})", flush=True)
    return err


#: the lanes a row of phase 4's hop width check, beside event_inj_lb's and
#: lc_mixed_fleet's own: widths 1, 3, 8 and 15 mod 16, two past a block of
#: 2048 lanes, on HOP_CHECK_ROWS rows (every row residue mod 16)
HOP_CHECK_WIDTHS = (17, 2051, 40, 4111)
HOP_CHECK_ROWS = 17


def _hop_width_check(torch, kernel, plain) -> float:
    """The LB hop by slot (a tenth of the lanes with no healthy target) and
    least connections' candidates against their plain versions at every
    row residue: on event_inj_lb's tables (its spikes, its two LB slots)
    and lc_mixed_fleet's, at HOP_CHECK_WIDTHS and each path's own width, on
    HOP_CHECK_ROWS rows of lanes made on the card from a seed.  Bit-exact;
    returns the largest difference."""
    from asyncflow_tpu_torch.engines.torchsim import draws
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.engines.torchsim.params import base_overrides

    rows, err, widths = HOP_CHECK_ROWS, 0.0, {}
    g = torch.Generator(device="cuda").manual_seed(31)
    keys = scenario_keys(31, rows, device="cuda")
    uk, zk = draws.hop_keys(keys, 32)
    for path in ("event_inj_lb", "lc_mixed_fleet"):
        eng = _fast_engine(torch, FAST_PAYLOADS[path])
        plan = eng.plan
        tables = eng._edge_tables(eng._overrides(base_overrides(plan), rows))
        edges = plan.lb_edge_index.tolist()
        uks, zks = (torch.stack(x, dim=1) for x in zip(*(draws.hop_keys(keys, 32 + k)
                                                         for k in range(len(edges)))))
        widths[path] = (*HOP_CHECK_WIDTHS, eng.n)
        for n in widths[path]:
            t_send = torch.rand((rows, n), device="cuda", generator=g) * (1.1 * plan.horizon)
            alive = torch.rand((rows, n), device="cuda", generator=g) < 0.9
            slot = torch.randint(0, len(edges), (rows, n), device="cuda", generator=g)
            slot = torch.where(torch.rand((rows, n), device="cuda", generator=g) < 0.1, -1,
                               slot).int()
            for kind, args, kw in (
                (_hop_kind(tables, {"slot": slot}), (tables, t_send, alive, uk, zk),
                 {"slot": slot}),
                (_hop_kind(tables, {}, "candidates"), (tables, t_send, alive, uks, zks, edges),
                 {}),
            ):
                err = max(err, _compare(torch, f"fast check: {kind} on {path}'s tables at "
                                        f"{rows} x {n}", _call(kernel, kind, args, kw),
                                        _call(plain, kind, args, kw)))
    print(f"fast check: the LB hop by slot and least connections' candidates == plain at "
          f"{rows} rows of {widths} lanes", flush=True)
    return err


#: the fused multiply-add sites' check (ROADMAP C.8): rows and lanes a row
FUSED_CHECK_SHAPE = (64, 20_011)


def _fused_site_check(torch, kernel, plain, dev: str = "cuda") -> float:
    """The multiply-adds the jitted reference fuses, in edge_draws' kernel
    (``__fmaf_rn``) against its plain version (``draws.fma_xla``): an edge of
    each law (uniform, exponential, normal, lognormal: ``mean + var * z``
    and the erfinv's steps), each law's static hop with and without the
    spike and under fault tables (the delay's last multiply fused into the
    spike's or the send time's add), the LB hop by rank over edges of one
    law and of several (a select: the law's delay rounded first) and least
    connections' candidates (the delay rounded before the send time's add),
    on lanes made on the card from a seed.  Bit-exact; returns the largest
    difference."""
    import numpy as np

    from asyncflow_tpu_torch.engines.torchsim import draws
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.engines.torchsim.sampling import (
        D_EXPONENTIAL,
        D_LOGNORMAL,
        D_NORMAL,
        D_UNIFORM,
    )

    rows, n = FUSED_CHECK_SHAPE
    g = torch.Generator(device=dev).manual_seed(41)
    dist = np.array([D_UNIFORM, D_EXPONENTIAL, D_NORMAL, D_LOGNORMAL, D_EXPONENTIAL], np.int32)
    ne, horizon = len(dist), 600.0
    mean = torch.rand((rows, ne), device=dev, generator=g) * 0.01 + 0.001
    var = torch.rand((rows, ne), device=dev, generator=g) * 0.3
    drop = torch.rand((rows, ne), device=dev, generator=g) * 0.2
    nb, nf = 7, 9
    spike_t = torch.cat([torch.zeros(1, device=dev),
                         torch.sort(torch.rand(nb - 1, device=dev, generator=g)).values
                         * horizon])
    spike_v = torch.rand((nb, ne), device=dev, generator=g) * 0.02
    fault_t = torch.cat([torch.zeros((rows, 1), device=dev),
                         torch.sort(torch.rand((rows, nf - 1), device=dev, generator=g),
                                    dim=1).values * horizon], dim=1)
    fault_lat = 1.0 + torch.rand((rows, nf, ne), device=dev, generator=g) * 3.0
    fault_drop = torch.rand((rows, nf, ne), device=dev, generator=g) * 0.3
    t_send = torch.rand((rows, n), device=dev, generator=g) * (1.05 * horizon)
    alive = torch.rand((rows, n), device=dev, generator=g) < 0.9
    rank = torch.randint(0, 1 << 30, (rows, n), device=dev, generator=g)
    keys = scenario_keys(41, rows, device=dev)
    uk, zk = draws.hop_keys(keys, 32)
    err, calls = 0.0, 0
    for spiked, faulted in itertools.product((False, True), (False, True)):
        extra = {}
        if spiked:
            extra.update(spike_t=spike_t, spike_v=spike_v)
        if faulted:
            extra.update(fault_t=fault_t, fault_lat=fault_lat, fault_drop=fault_drop)
        for lb_edges in ([1, 4], [0, 1, 2, 3]):
            lb = torch.as_tensor(lb_edges, dtype=torch.int32, device=dev)
            tables = draws.EdgeTables(dist=dist, mean=mean, var=var, drop=drop,
                                      horizon=horizon, lb_edge=lb,
                                      lb_target=torch.arange(len(lb_edges), dtype=torch.int32,
                                                             device=dev), **extra)
            label = (f"fast check: the fused sites, spikes {spiked}, faults {faulted}, "
                     f"LB edges {lb_edges}")
            err = max(err, _compare(torch, f"{label}, LB hop by rank",
                                    tuple(kernel.hop(tables, t_send, alive, uk, zk, rank=rank)),
                                    tuple(plain.hop(tables, t_send, alive, uk, zk, rank=rank))))
            uks, zks = (torch.stack(x, dim=1) for x in zip(*(draws.hop_keys(keys, 32 + k)
                                                             for k in range(len(lb_edges)))))
            err = max(err, _compare(
                torch, f"{label}, candidates",
                kernel.candidates(tables, t_send, alive, uks, zks, lb_edges),
                plain.candidates(tables, t_send, alive, uks, zks, lb_edges)))
            calls += 2
        for edge in range(ne):
            err = max(err, _compare(
                torch, f"fast check: the fused sites, spikes {spiked}, faults {faulted}, "
                f"edge {edge} (law {int(dist[edge])})",
                tuple(kernel.hop(tables, t_send, alive, uk, zk, edge=edge)),
                tuple(plain.hop(tables, t_send, alive, uk, zk, edge=edge))))
            calls += 1
    print(f"fast check: edge_draws' fused multiply-add sites (ROADMAP C.8) == plain in {calls} "
          f"hops and candidate launches on {rows} x {n} lanes (each law, spikes and fault "
          f"tables on and off, LB edges of one law and of several)", flush=True)
    return err


#: breakpoints of the fault hop check's wide shared table: 64 KiB of
#: float32, past the 48 KiB of shared memory the hop stages them in
WIDE_FAULTS = 16_384


def _fault_hop_check(torch, kernel, plain) -> float:
    """The hop under per-scenario fault tables at the headline's width
    (2048 x 87,840 lanes of chaos_campaign's edges), synthetic on the card
    from a seed: send times over 1.1 horizons, a tenth of the lanes dead;
    nine breakpoints a scenario shifted by up to 40 s (clipped at 0, the
    first at 0), on lb-srv2 overlapping degrades (4x, then 1.5x more and
    +0.2 dropout), a partition of lb-srv1 and a degrade of the entry edge,
    scaled per scenario; over the static entry edge and lb-srv2, and over
    the LB's slots by rank; then a shared table of ``WIDE_FAULTS``
    breakpoints over the LB's slots.  Bit-exact; returns the largest
    difference."""
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim import draws
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.schemas import SimulationPayload

    plan = compile_payload(SimulationPayload.from_dict(CHAOS_CAMPAIGN))
    s, n, ne = MAIN_SCENARIOS, plan.max_requests, plan.n_edges
    g = torch.Generator(device="cuda").manual_seed(29)
    times = torch.tensor([0.0, 50.0, 100.0, 150.0, 200.0, 300.0, 400.0, 450.0, 500.0],
                         device="cuda")
    lat = torch.ones((s, times.numel(), ne), device="cuda")
    boost = torch.zeros_like(lat)
    lat[:, 1:4, 3] = 4.0
    lat[:, 2:6, 3] *= 1.5
    boost[:, 2:6, 3] = 0.2
    boost[:, 4:6, 2] = 1.0  # the partition of lb-srv1
    lat[:, 6:8, 0] = 2.0
    # duplicate breakpoint times: before rows 2, 5 and 7, decoy rows at
    # their times (a factor of 7 and a boost of 0.45 on every edge), which
    # the search must never read (at a duplicate time the last row holds)
    keep = [0, 1, 2, 2, 3, 4, 5, 5, 5, 6, 7, 7, 8]
    decoy = [j + 1 < len(keep) and keep[j + 1] == keep[j] for j in range(len(keep))]
    times, lat, boost = times[keep], lat[:, keep].clone(), boost[:, keep].clone()
    lat[:, decoy], boost[:, decoy] = 7.0, 0.45
    fault_t = torch.clamp_min(times + 40.0 * torch.rand((s, 1), device="cuda", generator=g),
                              0.0)
    fault_t[:, 0] = 0.0
    lat = lat * (1.0 + torch.rand((s, 1, 1), device="cuda", generator=g))
    row = lambda x: torch.as_tensor(x, device="cuda").expand(s, ne).contiguous()  # noqa: E731
    tables = draws.EdgeTables(
        dist=plan.edge_dist, mean=row(plan.edge_mean), var=row(plan.edge_var),
        drop=row(plan.edge_dropout), horizon=plan.horizon,
        lb_edge=torch.as_tensor(plan.lb_edge_index, device="cuda").int(),
        lb_target=torch.as_tensor(plan.lb_target, device="cuda").int(),
        fault_t=fault_t, fault_lat=lat, fault_drop=boost)
    t_send = torch.rand((s, n), device="cuda", generator=g) * (1.1 * plan.horizon)
    alive = torch.rand((s, n), device="cuda", generator=g) < 0.9
    # 64 sends a breakpoint exactly on each scenario's breakpoint times
    nf = fault_t.shape[1]
    t_send[:, : 64 * nf] = fault_t.repeat(1, 64)
    uk, zk = draws.hop_keys(scenario_keys(29, s, device="cuda"), 32)
    err = 0.0
    rank = torch.arange(n, device="cuda").expand(s, n) + torch.arange(s, device="cuda")[:, None]
    for kw in ({"edge": 0}, {"edge": 3}, {"rank": rank}):
        args = (tables, t_send, alive, uk, zk)
        want = _call(plain, "hop_fault", args, kw)
        err = max(err, _compare(torch, f"fast check: fault hop {sorted(kw)}",
                                _call(kernel, "hop_fault", args, kw), want))
        if "rank" in kw and int(want[4].sum()) == 0:
            raise SmokeError("fast check: the synthetic fault tables dropped nothing")
        del want
    # a shared table of WIDE_FAULTS breakpoints on a grid of 1/64 s (many
    # repeat), past the hop's shared memory: its lanes search it in global
    # memory
    grid = torch.randint(0, int(64 * plan.horizon), (WIDE_FAULTS,), device="cuda", generator=g)
    wide_t = torch.sort(grid).values.float() / 64
    wide_t[0] = 0.0
    wide = draws.EdgeTables(
        dist=tables.dist, mean=tables.mean, var=tables.var, drop=tables.drop,
        horizon=tables.horizon, lb_edge=tables.lb_edge, lb_target=tables.lb_target,
        fault_t=wide_t,
        fault_lat=1.0 + 2.0 * torch.rand((WIDE_FAULTS, ne), device="cuda", generator=g),
        fault_drop=0.5 * torch.rand((WIDE_FAULTS, ne), device="cuda", generator=g))
    t_send[:, : WIDE_FAULTS // 8] = wide_t[::8]
    args, kw = (wide, t_send, alive, uk, zk), {"rank": rank}
    err = max(err, _compare(torch, "fast check: fault hop, wide shared table",
                            _call(kernel, "hop_fault", args, kw),
                            _call(plain, "hop_fault", args, kw)))
    print(f"fast check: the hop under per-scenario fault tables == plain on {s} x {n} lanes "
          f"({nf} breakpoints a scenario, four duplicates, {64 * nf} sends on breakpoints; "
          "static entry edge and lb-srv2, the LB by rank); under a shared table of "
          f"{WIDE_FAULTS} breakpoints (past shared memory), the LB by rank", flush=True)
    return err


#: the token bucket's (rate, burst) pairs phase 4 holds to the plain version
BUCKET_CASES = ((5.0, 50.0), (0.37, 3.0), (100.0, 1.0), (0.0, 2.0), (13.3, 7.0))
#: the bucket check's row layouts and their valid shares: valid elements
#: among invalid ones (the budget's wants among its lanes), the valid
#: elements first and an invalid tail (a server's arrivals as the fast path
#: sorts them for its rate limit), and sparse wants (a retry pass's)
BUCKET_LAYOUTS = {"interspersed": 0.7, "sorted tail": 0.6, "sparse": 0.05}


def _bucket_check(torch, kernel, plain) -> float:
    """station_scan's token bucket against its plain version on 2048
    synthetic sorted rows of 9,750 elements (the guide's outage sweep's
    lanes), invalid elements at INF (as the budget's non-wants), runs of
    equal times, at each of BUCKET_CASES in each of BUCKET_LAYOUTS (the
    valid elements arrive at 1.3 x rate + 1 a second in each); bit-exact."""
    s, m = MAIN_SCENARIOS, 9750
    err = 0.0
    for seed, ((rate, burst), (layout, share)) in enumerate(
            itertools.product(BUCKET_CASES, BUCKET_LAYOUTS.items())):
        g = torch.Generator(device="cuda").manual_seed(100 + seed)
        gaps = torch.empty((s, m), device="cuda").exponential_(
            (1.3 * rate + 1.0) / share, generator=g)
        t = torch.cumsum(gaps, dim=1)
        t[:, 100:110] = t[:, 100:101]
        if layout == "sorted tail":
            n_valid = (torch.rand((s, 1), device="cuda", generator=g) * 0.4 + 0.4) * m
            v = torch.arange(m, device="cuda")[None, :] < n_valid
        else:
            v = torch.rand((s, m), device="cuda", generator=g) < share
        t = torch.where(v, t, 1e30)
        want = plain.bucket(t, v, rate, burst)
        label = f"fast check: bucket at rate {rate}, burst {burst}, {layout}"
        err = max(err, _compare(torch, label, (kernel.bucket(t, v, rate, burst),), (want,)))
        if not bool((v & ~want).any()) or not bool(want.any()):
            raise SmokeError(f"{label}: the bucket never refuses or accepts")
    print(f"fast check: station_scan's token bucket == plain on {s} x {m} rows at "
          f"{len(BUCKET_CASES)} (rate, burst) pairs in each of {sorted(BUCKET_LAYOUTS)}",
          flush=True)
    return err


#: the controlled and socket scans' grid phase 4 holds to the plain
#: versions: cores (one on the thread walk, the warp walk whole and spread),
#: ready-queue caps (none, one, 8, the ring's 128), deadlines (none, 50 ms)
#: and connection caps (one, 6, the widest 128), on synthetic rows of
#: CONTROL_CHECK_ELEMENTS
CONTROL_GRID = {"cores": (1, 2, 33), "cap": (-1, 1, 8, 128), "timeout": (-1.0, 0.05),
                "conn": (1, 6, 128)}
CONTROL_CHECK_ELEMENTS = 601
#: the gap prefix sum's rows beyond the paths' calls: (rows, lanes) at the
#: edge of five levels of XLA's scan (16^4 + 1 lanes) and past them (16^5
#: + 1: six levels)
GAP_SUM_CASES = ((MAIN_SCENARIOS, 65_537), (64, 1_048_577))
#: the socket scan's lane walk at the edges of its shapes, (connections,
#: cap) at one core and at two with a deadline: LANE_WHOLE of each (the
#: lane walk) and one past either (the warp walk)
SOCKET_EDGES = ((8, 8), (9, 8), (8, 9), (9, 9))
#: least connections' synthetic cases: (LB slots, ring, marks (time, down,
#: slot)): the mixed fleet's two slots and ring of 23, a timeline with
#: marks at one time and every slot down a while (the only case that leaves
#: an alive arrival unrouted), the widest (32 slots, rings of 128: the
#: rings in shared memory), and two slots' rings of a warp's 32 lanes (the
#: registers form's widest) and of 33 (the shared-memory form)
LC_CASES = (
    (2, 23, ()),
    (3, 5, ((2.0, 1, 0), (4.0, 1, 1), (4.0, 1, 2), (6.0, 0, 1), (6.0, 0, 0), (9.0, 1, 1))),
    (32, 128, ((3.0, 1, 0),)),
    (2, 32, ()),
    (2, 33, ()),
)
LC_CHECK_ARRIVALS = 3001


def _control_rows(torch, seed: int, cores: int):
    """(arrival, enqueue, service, post-IO, burst, valid), (2048, m) on the
    card: arrivals at 1.3x the cores' service rate, a third invalid (INF),
    a tenth io-only, a 3 ms pre-IO before each burst."""
    s, m = MAIN_SCENARIOS, CONTROL_CHECK_ELEMENTS
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.cumsum(torch.empty((s, m), device="cuda").exponential_(
        52.0 * cores / 0.67, generator=g), dim=1)
    d = torch.empty((s, m), device="cuda").exponential_(40.0, generator=g)
    post = torch.empty((s, m), device="cuda").exponential_(20.0, generator=g)
    v = torch.rand((s, m), device="cuda", generator=g) < 0.67
    b = v & (torch.rand((s, m), device="cuda", generator=g) < 0.9)
    a = torch.where(v, a, 1e30)
    return a, torch.where(v, a + 0.003, 1e30), d, post, b, v


def _control_check(torch, kernel, plain) -> float:
    """station_scan's controlled and socket modes against their plain
    versions over CONTROL_GRID on 2048 synthetic rows, and the socket scan
    at SOCKET_EDGES, each on the walk its shape takes; bit-exact, and each
    control binding somewhere."""
    err, seen = 0.0, 0
    for i, (cores, cap, timeout) in enumerate(itertools.product(
            CONTROL_GRID["cores"], CONTROL_GRID["cap"], CONTROL_GRID["timeout"])):
        a, e, d, post, b, v = _control_rows(torch, 200 + i, cores)
        e_b = torch.where(b, e, 1e30)
        args = (e_b, d, b, cores, cap, timeout)
        before = dict(kernel.walk_launches)
        got = kernel.controlled(*args)
        walk = next(k for k, n in kernel.walk_launches.items() if n > before[k])
        want = plain.controlled(*args)
        err = max(err, _compare(torch, f"control check: controlled {args[3:]} ({walk})", got,
                                want))
        if walk != ("lane" if max(cores, cap) <= 8 else "warp"):
            raise SmokeError(f"control check: controlled {args[3:]} took the {walk} walk")
        for bit in (1, 2):
            seen |= bit if bool(((want[1] & bit) != 0).any()) else 0
        for conn in CONTROL_GRID["conn"]:
            args = (a, e, d, post, b, v, cores, conn, cap, timeout)
            got = kernel.socket(*args)
            want = plain.socket(*args)
            err = max(err, _compare(torch, f"control check: socket {args[6:]}", got, want))
            for bit in (1, 2, 4):
                seen |= bit if bool(((want[1] & bit) != 0).any()) else 0
    if seen != 7:
        raise SmokeError(f"control check: the flags seen over the grid are {seen}, not 7")
    for i, (cores, (conn, cap)) in enumerate(itertools.product((1, 2), SOCKET_EDGES)):
        a, e, d, post, b, v = _control_rows(torch, 400 + i, cores)
        args = (a, e, d, post, b, v, cores, conn, cap, 0.05)
        before = dict(kernel.walk_launches)
        got = kernel.socket(*args)
        walk = next(k for k, n in kernel.walk_launches.items() if n > before[k])
        want = plain.socket(*args)
        err = max(err, _compare(torch, f"control check: socket {args[6:]} ({walk})", got, want))
        if walk != ("lane" if max(conn, cap) <= 8 else "warp"):
            raise SmokeError(f"control check: socket {args[6:]} took the {walk} walk")
    print(f"fast check: station_scan's controlled and socket modes == plain on "
          f"{MAIN_SCENARIOS} x {CONTROL_CHECK_ELEMENTS} rows over {CONTROL_GRID} (the "
          f"controlled scan on the lane walk up to 8 cores and cap 8, else the warp walk) and "
          f"the socket scan's (connections, cap) at {SOCKET_EDGES} at one and two cores",
          flush=True)
    return err


#: the one-server scan's row lengths beyond the paths' calls: one element,
#: a 2,048-element tile of the tree walk, two tiles, their neighbours, and
#: the headline's width (42 tiles and a part)
LINDLEY_CHECK_LENGTHS = (1, 2_047, 2_048, 2_049, 4_095, 4_096, 4_097, 87_840)


def _lindley_tree_check(torch, kernel, plain) -> float:
    """station_scan's one-server waits (the tree walk) against the plain
    version at LINDLEY_CHECK_LENGTHS on 2048 rows near capacity, row 0
    every lane masked, row 1 one valid lane, row 2 overloaded; bit-exact."""
    from asyncflow_tpu_torch.engines.torchsim.station_scan import WALK_TREE, WALK_NAMES

    g = torch.Generator(device="cuda").manual_seed(18)
    err = 0.0
    for m in LINDLEY_CHECK_LENGTHS:
        s = MAIN_SCENARIOS
        a = torch.cumsum(torch.empty((s, m), device="cuda").exponential_(1.0, generator=g), 1)
        load = torch.full((s, 1), 0.98 / 0.67, device="cuda")
        load[2] = 1.05 / 0.67
        d = torch.empty((s, m), device="cuda").exponential_(1.0, generator=g) * load
        v = torch.rand((s, m), device="cuda", generator=g) > 0.33
        v[:2] = False
        v[1, m // 2] = True
        tree = kernel.walk_launches[WALK_NAMES[WALK_TREE]]
        got = kernel.waits(a, d, v, 1)
        if kernel.walk_launches[WALK_NAMES[WALK_TREE]] != tree + 1:
            raise SmokeError(f"lindley check: {s} x {m} did not take the tree walk")
        err = max(err, _compare(torch, f"lindley check: {s} x {m}", (got,),
                                (plain.waits(a, d, v, 1),)))
        del a, d, v, got
    print(f"fast check: station_scan's one-server waits (tree walk) == plain on {MAIN_SCENARIOS} "
          f"rows of {LINDLEY_CHECK_LENGTHS} elements", flush=True)
    return err


def _gap_sum_check(torch, kernel, plain) -> float:
    """edge_draws' gap prefix sum against its plain version at the
    headline's lanes (2048 x 87,840: five levels) and at GAP_SUM_CASES,
    each one launch; bit-exact."""
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys

    err = 0.0
    for i, (s, n) in enumerate(((MAIN_SCENARIOS, 87_840), *GAP_SUM_CASES)):
        keys = scenario_keys(500 + i, s, device="cuda")
        launches = kernel.launches
        got = kernel.gap_cumsum(keys, n)
        if kernel.launches != launches + 1:
            raise SmokeError(f"gap sum check: {s} x {n} took "
                             f"{kernel.launches - launches} launches")
        err = max(err, _compare(torch, f"gap sum check: {s} x {n}", (got,),
                                (plain.gap_cumsum(keys, n),)))
        del got
    print(f"fast check: edge_draws' gap prefix sum == plain, one launch a call, on "
          f"{MAIN_SCENARIOS} x 87840 and {GAP_SUM_CASES} (rows, lanes)", flush=True)
    return err


def _lc_check(torch, kernel, plain) -> float:
    """lb_route's least connections against its plain version on 2048
    synthetic rows of LC_CHECK_ARRIVALS sorted arrivals (dead lanes last)
    at each of LC_CASES; bit-exact."""
    from asyncflow_tpu_torch.engines.torchsim import routing

    s, n = MAIN_SCENARIOS, LC_CHECK_ARRIVALS
    err = 0.0
    for i, (el, ring, marks) in enumerate(LC_CASES):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        t = torch.sort(torch.rand((s, n), device="cuda", generator=g) * 10, dim=1).values
        ok = torch.rand((s, n), device="cuda", generator=g) < 0.9
        order = torch.sort((~ok).int(), dim=1, stable=True).indices
        ok = ok.gather(1, order)
        t = torch.where(ok, t.gather(1, order), 1e30)
        deliv = t[..., None] + torch.rand((s, n, el), device="cuda", generator=g) * (
            0.005 * ring)
        drop = torch.rand((s, n, el), device="cuda", generator=g) < 0.1
        tl = routing.Timeline([m[0] for m in marks], [m[1] for m in marks],
                              [m[2] for m in marks], el, "cuda")
        args = (tl, t, ok, deliv, drop, ring)
        want = _call(plain, "route_lc", args, {})
        err = max(err, _compare(torch, f"lc check: {el} slots, ring {ring}",
                                _call(kernel, "route_lc", args, {}), want))
        if bool((want[0][ok] < 0).any()) != (i == 1):
            raise SmokeError(f"lc check: case {i} routes every lane or none as it should not")
    print(f"fast check: lb_route's least connections == plain on {s} x {n} arrivals at "
          f"{len(LC_CASES)} (slots, ring, marks) cases", flush=True)
    return err


def phase_fast_check(torch) -> dict:
    """Phase 4: the fast path's kernels against their plain versions on the
    card, on each fast payload cut to FAST_CHECK_HORIZON seconds (events
    scaled in) at FAST_CHECK_SCENARIOS scenarios: every kernel call of the
    engine's run (all are recorded: uniforms, gap draws and prefix sums,
    static, LB, slot and spiked hops, timeline tables and lanes, scans)
    repeated through the kernel and through the plain version on the same
    arguments, bit-exact; then the whole engine once through the kernels
    and once through the plain versions: every integer output, every
    completed request's (arrival, finish) clock and every gauge mean
    identical.  Then a synthetic timeline (an all-down interval, marks at
    one time, an up mark for a slot present, a down mark for one absent)
    through lb_route on event_inj_lb's full-width lanes, and one of more
    marks than the table pass counts in a pass; station_scan at every carry
    width of SCAN_WIDTH_CASES on synthetic streams; last, XLA's log1p in the
    kernel against its plain version on each of the 2**23 uniforms."""
    from asyncflow_tpu_torch.engines.torchsim import routing
    from asyncflow_tpu_torch.engines.torchsim.keys import fold_in, scenario_keys
    from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
    from asyncflow_tpu_torch.engines.torchsim.sortutil import time_rank

    plains = _plain_wrappers()
    measured = dict.fromkeys(FAST_KERNELS, 0.0)
    kinds_seen: set = set()
    for name, data in FAST_PAYLOADS.items():
        eng = _fast_engine(torch, _fast_check_payload(data), collect_clocks=True)
        keys = scenario_keys(0, FAST_CHECK_SCENARIOS, device="cuda")
        # a chaos campaign's windows made ten times as frequent: in 60 s
        ov = path_overrides(name, eng.plan, FAST_CHECK_SCENARIOS, hazard_scale=10.0)
        kernels = _wrappers(eng)
        calls = _record_kernel_calls(eng, every=True)
        got = eng.run_tensors(keys, ov)
        _set_wrappers(eng, kernels)
        need = ["edge_draws", "station_scan"] + (["lb_route"] if eng.timeline else [])
        if any(kernels[k].launches == 0 for k in need):
            raise SmokeError(f"fast check {name}: a kernel was not launched")
        if ((eng.has_edge_faults and kernels["edge_draws"].fault_launches == 0)
                or (eng.plan.retry_budget_tokens >= 0
                    and kernels["station_scan"].mode_launches["bucket"] == 0)):
            raise SmokeError(f"fast check {name}: no fault hop or no budget bucket launched")
        for i, (kind, args, kw) in enumerate(calls):
            kernel = CALL_KINDS[kind][0]
            err = _compare(torch, f"fast check {name}: call {i} ({kind})",
                           _call(kernels[kernel], kind, args, kw),
                           _call(plains[kernel], kind, args, kw))
            measured[kernel] = max(measured[kernel], err)
        kinds_seen |= {kind for kind, _, _ in calls}
        want_eng = copy.copy(eng)
        _set_wrappers(want_eng, plains)
        want = want_eng.run_tensors(keys, ov)
        for field in ("hist", "thr", "lat_count", "n_generated", "n_dropped", "n_overflow",
                      "clock", "gauge_means", "n_rejected", "n_dark_lost", "n_timed_out",
                      "n_retries", "n_budget_exhausted", "att_hist"):
            if not torch.equal(got[field], want[field]):
                raise SmokeError(f"fast check {name}: {field} differs between the runs")
        print(
            f"fast kernels == plain on {name} ({FAST_CHECK_SCENARIOS} x "
            f"{FAST_CHECK_HORIZON} s, {eng.n} lanes): {len(calls)} calls of kinds "
            f"{sorted({kind for kind, _, _ in calls})}; completed "
            f"{int(got['lat_count'].sum())}, generated {int(got['n_generated'].sum())}, "
            f"dropped {int(got['n_dropped'].sum())}, dark-lost "
            f"{int(got['n_dark_lost'].sum())}, retries {int(got['n_retries'].sum())}; "
            "clocks and gauge means identical",
            flush=True,
        )
    wanted = {"uniform", "gap", "gap_cumsum", "hop", "hop_lb", "hop_spike", "hop_slot_spike",
              "waits", "waits_kw", "ram_core", "route_table", "route_slots", "hop_fault",
              "hop_lb_fault", "bucket", "controlled", "socket", "route_lc", "candidates"}
    if not wanted <= kinds_seen:
        raise SmokeError(f"fast check: no call of kinds {sorted(wanted - kinds_seen)}")
    # the synthetic timeline on event_inj_lb's full-width arrivals: srv-1
    # down at 50 s, srv-2 too at 100 s (every server down), three marks at
    # 150 s (srv-2 up, up again while present, srv-1 down while absent),
    # srv-1 down while absent at 300 s and up at 320 s
    eng = _fast_engine(torch, EVENT_INJ_LB)
    keys = scenario_keys(0, MAIN_SCENARIOS, device="cuda")
    ov = eng._overrides(base_overrides(eng.plan), MAIN_SCENARIOS)
    _lam, counts = eng.window_draws(keys, ov["um"], ov["rr"])
    ts, valids, _ = eng._stream_arrivals(fold_in(keys, 0), counts)
    tl = routing.Timeline([50.0, 100.0, 150.0, 150.0, 150.0, 300.0, 320.0],
                          [1, 1, 0, 0, 1, 1, 0], [0, 1, 1, 1, 0, 0, 0], 2, "cuda")
    args = (tl, ts[0], valids[0])
    want = _call(plains["lb_route"], "route_table", args, {})
    measured["lb_route"] = max(measured["lb_route"], _compare(
        torch, "fast check: synthetic timeline table",
        _call(eng.route, "route_table", args, {}), want))
    args = (want[0], time_rank(ts[0], valids[0]), valids[0])
    slots = _call(eng.route, "route_slots", args, {})
    measured["lb_route"] = max(measured["lb_route"], _compare(
        torch, "fast check: synthetic timeline lanes", slots,
        _call(plains["lb_route"], "route_slots", args, {})))
    empty = int(want[0][:, 2, 1].max())
    unrouted = int((valids[0] & (slots[0] < 0)).sum())
    if empty != 0 or unrouted == 0:
        raise SmokeError(f"fast check: the all-down interval has rotations of length "
                         f"{empty} and {unrouted} unrouted lanes")
    print(f"fast check: a synthetic timeline through lb_route == plain on {MAIN_SCENARIOS} x "
          f"{eng.n} lanes ({unrouted} lanes found every server down)", flush=True)
    # 23 marks, some at one time: two of the table pass's counting passes
    times = [15.0 * k + (0.0 if k % 5 else 7.5) for k in range(21)] + [307.5, 307.5]
    tl = routing.Timeline(times, [1, 0] * 11 + [1], [k % 2 for k in range(21)] + [0, 1], 2,
                          "cuda")
    args = (tl, ts[0], valids[0])
    want = _call(plains["lb_route"], "route_table", args, {})
    measured["lb_route"] = max(measured["lb_route"], _compare(
        torch, "fast check: a timeline of 23 marks",
        _call(eng.route, "route_table", args, {}), want))
    args = (want[0], time_rank(ts[0], valids[0]), valids[0])
    measured["lb_route"] = max(measured["lb_route"], _compare(
        torch, "fast check: a timeline of 23 marks, lanes",
        _call(eng.route, "route_slots", args, {}),
        _call(plains["lb_route"], "route_slots", args, {})))
    print(f"fast check: a timeline of {tl.n_marks} marks through lb_route == plain on "
          f"{MAIN_SCENARIOS} x {eng.n} lanes", flush=True)
    del ts, valids, args, slots, want
    width_err = _scan_width_check(torch, eng.scan, plains["station_scan"])
    measured["station_scan"] = max(measured["station_scan"], width_err)
    measured["fault_hop"] = _fault_hop_check(torch, eng.draws, plains["edge_draws"])
    measured["hop_widths"] = max(
        _hop_width_check(torch, eng.draws, plains["edge_draws"]),
        _fused_site_check(torch, eng.draws, plains["edge_draws"]))
    measured["bucket"] = _bucket_check(torch, eng.scan, plains["station_scan"])
    measured["controls"] = _control_check(torch, eng.scan, plains["station_scan"])
    measured["edge_draws"] = max(measured["edge_draws"], _gap_sum_check(
        torch, eng.draws, plains["edge_draws"]))
    measured["station_scan"] = max(measured["station_scan"], _lindley_tree_check(
        torch, eng.scan, plains["station_scan"]))
    measured["lc"] = _lc_check(torch, eng.route, plains["lb_route"])
    u = torch.arange(2**23, dtype=torch.float64, device="cuda").div(2**23).float().view(8, -1)
    measured["edge_draws"] = max(measured["edge_draws"], _compare(
        torch, "fast check: log1p_xla on every uniform", _call(eng.draws, "gap_of", (u,), {}),
        _call(plains["edge_draws"], "gap_of", (u,), {})))
    print("fast check: XLA's log1p in the kernel == plain on all 2**23 uniforms", flush=True)
    measured["blame_grid"] = _blame_grid_check(torch)
    return measured


def _time_plain(torch, fn) -> tuple:
    """Milliseconds of one ``fn()`` on the host's clock (a plain version is
    thousands of launches), and what it returned."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _lindley_closed_form(torch, a, d, v):
    """The c = 1 waits as library calls: completions are the running
    maximum of (arrival + service - cumulative service), plus it."""
    svc = torch.where(v, d, 0.0)
    arr = torch.where(v, a, 0.0)
    b = torch.where(v, arr + svc, -1e30)
    cum = torch.cumsum(svc, dim=1)
    c = cum + torch.cummax(b - cum, dim=1).values
    return torch.clamp_min(c - svc - arr, 0.0)


#: each earlier fast path's completions and drops at 2048 scenarios of
#: seed 0 (chip_smoke.py's final run of the earlier slice, NVIDIA H100
#: 80GB HBM3 at 700 W): the resilience machinery must leave them as they
#: were.  heavy_inj_single_server's spike is added with the delay's product
#: rounded once, as the jitted reference adds it: one request of 2048 x
#: 600 s now arrives past the horizon (178,873,692 completions before)
EARLIER_FAST = {
    "two_servers_lb": {"completed": 157444539, "dropped": 6460007},
    "single_server": {"completed": 33144419, "dropped": 1014953},
    "heavy_inj_single_server": {"completed": 178873691, "dropped": 5478427},
    "event_inj_lb": {"completed": 47250674, "dropped": 1937973},
    "two_gen_lb": {"completed": 157460400, "dropped": 6459417},
    "db_pool_k2": {"completed": 4793678, "dropped": 146356},
}


def _controlled_lane(plan) -> bool:
    """Whether the servers the fast path sends to the controlled scan (a
    ready-queue cap or a dequeue deadline, no connection cap, no RAM tier)
    take its lane walk (cores and cap up to LANE_WHOLE), else the warp
    walk; the walk check counts a path's controlled launches on one walk."""
    from asyncflow_tpu_torch.engines.torchsim import station_scan

    lane = set()
    for s in range(len(plan.server_cores)):
        nep = int(plan.n_endpoints[s])
        kb = int(plan.n_bursts[s, :nep].max()) if nep else 0
        ram_k = int(plan.ram_slots[s]) if len(plan.ram_slots) else 0
        cap = int(plan.server_queue_cap[s]) if len(plan.server_queue_cap) else -1
        timeout = (float(plan.server_queue_timeout[s]) if len(plan.server_queue_timeout)
                   else -1.0)
        conn = int(plan.server_conn_cap[s]) if len(plan.server_conn_cap) else -1
        if conn < 0 and kb > 0 and ram_k <= 0 and (cap >= 0 or timeout >= 0):
            walk = station_scan.walk_of(station_scan.MODE_CONTROLLED,
                                        int(plan.server_cores[s]), 0, cap)
            lane.add(walk == station_scan.WALK_LANE)
    if len(lane) > 1:
        raise SmokeError("the walk check takes a path whose controlled servers all take the "
                         "lane walk or none")
    return lane == {True}


def _socket_lane(plan) -> bool:
    """Whether the servers the fast path sends to the socket scan (a
    connection cap) take its lane walk (connections, cap and cores up to
    LANE_WHOLE); the walk check counts a path's socket launches on one
    walk."""
    from asyncflow_tpu_torch.engines.torchsim import station_scan

    lane = set()
    for s in range(len(plan.server_cores)):
        conn = int(plan.server_conn_cap[s]) if len(plan.server_conn_cap) else -1
        cap = int(plan.server_queue_cap[s]) if len(plan.server_queue_cap) else -1
        if conn >= 0:
            walk = station_scan.walk_of(station_scan.MODE_SOCKET, int(plan.server_cores[s]),
                                        conn, cap)
            lane.add(walk == station_scan.WALK_LANE)
    if len(lane) > 1:
        raise SmokeError("the walk check takes a path whose socket servers all take the "
                         "lane walk or none")
    return lane == {True}


def _check_resilience_sweep(name: str, summary: dict, res) -> None:
    """A resilience path's sweep: dark refusals are its only refusals and
    some happen; on the chaos campaign, the scorecard (availability in
    (0, 1); the dark seconds and truncated windows of the sampled tables
    equal to the reference's; a finite mean time to drain, from the ready
    queues the sweep streams, GAUGE_PATHS) and request conservation; with a
    retry policy, every ended
    attempt an issued one and every completion an ended one, and on
    outage_retry some retries and some budget denials; on
    trace_parity_resilient, whose outage spans the horizon, no completion,
    no timeout, and every ended request ended on its third attempt (each
    of its attempts refused, then abandoned)."""
    import numpy as np

    if summary["dark_lost_total"] < 1 or summary["rejected_total"] != summary["dark_lost_total"]:
        raise SmokeError(f"fast {name}: dark-lost {summary['dark_lost_total']} of "
                         f"{summary['rejected_total']} rejected")
    if name == "chaos_campaign":
        in_flight = (res.total_generated - res.completed - res.total_dropped
                     - res.overflow_dropped - res.total_rejected)
        ref = REFERENCE_FAST[name]
        if (np.any(in_flight < 0) or not 0.0 < summary["availability_fraction"] < 1.0
                or summary["unavailable_s_total"] != ref["unavailable_s_total"]
                or summary["hazard_truncated_total"] != ref["hazard_truncated_total"]
                or summary["time_to_drain_mean_s"] is None
                or not np.isfinite(summary["time_to_drain_mean_s"])):
            raise SmokeError(f"fast {name}: in flight [{in_flight.min()}, {in_flight.max()}], "
                             f"scorecard {summary}")
        return
    # an ended attempt was issued: spawned, or re-issued by a grant (the
    # relaxation's last pass may end a request on two attempts)
    ended = res.attempts_hist.sum(axis=1)
    if np.any(ended > res.total_generated + res.total_retries) or np.any(res.completed > ended):
        raise SmokeError(f"fast {name}: ended {ended.sum()} of {res.total_generated.sum()} "
                         f"generated and {res.total_retries.sum()} re-issued, "
                         f"{res.completed.sum()} completed")
    if name == "trace_parity_resilient" and (
            summary["completed_total"] != 0 or summary["timed_out_total"] != 0
            or np.any(res.attempts_hist[:, :-1] != 0) or ended.sum() == 0):
        raise SmokeError(f"fast {name}: completed {summary['completed_total']}, timed out "
                         f"{summary['timed_out_total']}, attempts {res.attempts_hist.sum(0)}")
    if name == "outage_retry" and (summary["retries_total"] < 1
                                   or summary["retry_budget_exhausted_total"] < 1):
        raise SmokeError(f"fast {name}: no retry or no budget denial: {summary}")


def phase_fast_path(torch, name: str, des: dict | None) -> dict:
    """Phase 5, one path: ``SweepRunner(payload).run(2048, seed=0)`` at the
    payload's full horizon through ``engine="auto"`` (with the path's
    sweep axes, FAST_SWEEP_AXES), which must take the fast path and launch
    its kernels (``lb_route`` where the LB has a timeline, the
    Kiefer-Wolfowitz scan where a DB pool has several connections, every
    carry scan through the warp walk, the hop under fault tables where
    faults reach an edge, the token bucket where a retry budget is set);
    for the earlier paths, request conservation and the completions and
    drops of the earlier slice's sweep, unchanged; for a resilience path,
    its own invariants (``_check_resilience_sweep``) and the DES kernel's
    refusal by name; the pooled p95 within 2% of the JAX fast path's and of
    the port's DES kernel's on the same payload, where each has one
    (``des``, phase 3's sweep of it, or a kernel sweep here; the DES
    kernel's sweep with no truncated and no overflowed scenario); then the
    first call of each kind of the path's own run, at full width, through
    the kernel and through its plain version on the same arguments,
    bit-exact; each edge_draws and lb_route kind, the path's main
    station_scan kind (the RAM-core scan or else a one-server wait scan),
    its Kiefer-Wolfowitz scan and its token bucket timed between CUDA
    events, beside its bound, its plain version's time and the library's;
    and the stable rank's time."""
    import numpy as np

    from asyncflow_tpu_torch.engines.torchsim.keys import fold_in, scenario_keys
    from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
    from asyncflow_tpu_torch.engines.torchsim.sortutil import time_rank
    from asyncflow_tpu_torch.parallel import SweepRunner

    from asyncflow_tpu_torch.errors import UnsupportedFeatureError
    from asyncflow_tpu_torch.parallel import make_overrides

    data = FAST_PAYLOADS[name]
    runner = SweepRunner(data, device="cuda", gauge_series=GAUGE_PATHS.get(name))
    if runner.engine_kind != "fast":
        raise SmokeError(f"fast {name}: auto took the {runner.engine_kind} engine")
    eng = runner.engine
    plan = eng.plan
    axes = FAST_SWEEP_AXES.get(name)
    sweep_ov = make_overrides(plan, MAIN_SCENARIOS, **axes(MAIN_SCENARIOS)) if axes else None
    runner.run(MAIN_SCENARIOS, seed=0, overrides=sweep_ov)  # warm the allocator and libraries
    for wrapper in _wrappers(eng).values():
        wrapper.launches = 0
    eng.draws.fault_launches = eng.draws.cand_launches = eng.route.lc_launches = 0
    eng.scan.mode_launches = dict.fromkeys(eng.scan.mode_launches, 0)
    eng.scan.walk_launches = dict.fromkeys(eng.scan.walk_launches, 0)
    eng.gauge.launches = 0
    torch.cuda.reset_peak_memory_stats()
    report = runner.run(MAIN_SCENARIOS, seed=0, overrides=sweep_ov)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: w.launches for k, w in _wrappers(eng).items()}
    gauge_launches = eng.gauge.launches
    if (gauge_launches > 0) != (name in GAUGE_PATHS):
        raise SmokeError(f"fast {name}: {gauge_launches} gauge_grid launches, with "
                         f"{'a' if name in GAUGE_PATHS else 'no'} streamed series")
    fault_launches = eng.draws.fault_launches
    cand_launches, lc_launches = eng.draws.cand_launches, eng.route.lc_launches
    mode_launches = dict(eng.scan.mode_launches)
    walk_launches = dict(eng.scan.walk_launches)
    need = ["edge_draws", "station_scan"] + (["lb_route"] if eng.timeline else [])
    kw_pool = bool(np.any(plan.server_db_pool > 1))
    # the carry modes and the bucket take the warp walk, the controlled and
    # socket scans too past the lane walk's shapes (no path's station is
    # wider than the warp walk holds)
    lanes = ((mode_launches["socket"] if _socket_lane(plan) else 0)
             + (mode_launches["controlled"] if _controlled_lane(plan) else 0))
    carries = (mode_launches["kw"] + mode_launches["ram_core"] + mode_launches["bucket"]
               + mode_launches["socket"] + mode_launches["controlled"] - lanes)
    if (min(launches[k] for k in need) < 1 or (kw_pool and mode_launches["kw"] < 1)
            or walk_launches["global"] != 0 or walk_launches["warp"] != carries
            or walk_launches["lane"] != lanes
            or walk_launches["tree"] != mode_launches["lindley"]
            or (eng.has_edge_faults and fault_launches < 1)
            or (plan.retry_budget_tokens >= 0 and mode_launches["bucket"] < 1)
            or (name in CONTROL_MODES and mode_launches[CONTROL_MODES[name]] < 1)
            or (eng.lc and min(lc_launches, cand_launches) < 1)):
        raise SmokeError(f"fast {name}: the sweep launched {launches} ({fault_launches} fault "
                         f"hops, {cand_launches} least-connections candidates, {lc_launches} "
                         f"least-connections walks), station_scan by mode {mode_launches} "
                         f"and by walk {walk_launches}")
    summary = report.summary()
    res = report.results
    rejected_fraction = summary["rejected_total"] / max(int(res.total_generated.sum()), 1)
    if name in RESILIENCE_PATHS:
        _check_resilience_sweep(name, summary, res)
    elif name in CONTROL_PATHS:
        in_flight = (res.total_generated - res.completed - res.total_dropped
                     - res.overflow_dropped - res.total_rejected)
        binds = name in CONTROL_MODES
        if np.any(in_flight < 0) or (summary["rejected_total"] > 0) != binds:
            raise SmokeError(f"fast {name}: in flight [{in_flight.min()}, {in_flight.max()}], "
                             f"rejected {summary['rejected_total']}")
    else:
        in_flight = (res.total_generated - res.completed - res.total_dropped
                     - res.overflow_dropped - res.total_rejected)
        if np.any(in_flight < 0):
            raise SmokeError(f"fast {name}: in flight [{in_flight.min()}, {in_flight.max()}]")
        earlier = EARLIER_FAST[name]
        now = {"completed": summary["completed_total"], "dropped": summary["dropped_total"]}
        if now != earlier:
            raise SmokeError(f"fast {name}: {now}, where the earlier slice's sweep gave "
                             f"{earlier}")
    if summary["overflow_total"] != 0:
        raise SmokeError(f"fast {name}: overflow {summary['overflow_total']}")
    quantiles = ("latency_p50_s", "latency_p95_s", "latency_p99_s", "latency_mean_s")
    for key in quantiles if summary["completed_total"] else ():
        if not np.isfinite(summary[key]):
            raise SmokeError(f"fast {name}: {key} is not finite")
    p95 = summary["latency_p95_s"]
    if name in RESILIENCE_PATHS:
        with_kernel = None
        try:
            SweepRunner(data, engine="kernel", device="cuda")
        except UnsupportedFeatureError as err:
            with_kernel = err.feature
        if with_kernel != RESILIENCE_PATHS[name]:
            raise SmokeError(f"fast {name}: the DES kernel did not refuse it by its feature "
                             f"{RESILIENCE_PATHS[name]!r} (refused: {with_kernel!r})")
        des = {"p95_s": None, "refused": with_kernel}
    elif des is None:
        sweep = SweepRunner(data, engine="kernel", device="cuda").run(MAIN_SCENARIOS, seed=0)
        des_summary = sweep.summary()
        if des_summary["truncated_total"] != 0 or des_summary["overflow_total"] != 0:
            msg = (f"fast {name}: the DES kernel's sweep truncated "
                   f"{des_summary['truncated_total']} and overflowed "
                   f"{des_summary['overflow_total']} scenarios")
            raise SmokeError(msg)
        des = {"p95_s": des_summary["latency_p95_s"], "scen_per_s": sweep.scenarios_per_second,
               "rejected_fraction": des_summary["rejected_total"]
               / max(int(sweep.results.total_generated.sum()), 1)}
    des_p95 = des["p95_s"]
    ref = REFERENCE_FAST[name]["p95_s"] if name in REFERENCE_FAST else None
    rel_ref = p95 / ref - 1.0 if ref is not None else 0.0
    rel_des = p95 / des_p95 - 1.0 if des_p95 is not None else 0.0
    # the overload and routing paths are held to the JAX fast path; their
    # DES kernel numbers are printed beside (its arrivals are sampled
    # otherwise, and its controls act on its own event order)
    held_des = 0.0 if name in CONTROL_PATHS else rel_des
    if abs(rel_ref) > P95_RTOL or abs(held_des) > P95_RTOL:
        msg = (f"fast {name}: pooled p95 {p95:.6f} s is {rel_ref:+.2%} from the JAX fast "
               f"path's {ref} and {rel_des:+.2%} from the DES kernel's {des_p95}")
        raise SmokeError(msg)

    # each kind of call of this path's own run, at full width: the kernel
    # against its plain version; each edge_draws and lb_route kind and the
    # path's station_scan kinds timed between CUDA events
    keys = scenario_keys(0, MAIN_SCENARIOS, device="cuda")
    wrappers, plains = _wrappers(eng), _plain_wrappers()
    calls = _record_kernel_calls(eng, every=False)
    t_sample = time.perf_counter()
    ov_full = path_overrides(name, plan, MAIN_SCENARIOS)
    # the host's share of a chaos sweep: its campaign's tables (numpy and
    # the port's threefry on the CPU), as the sweep samples them
    sample_s = time.perf_counter() - t_sample if plan.has_hazards else None
    eng.run_tensors(keys, ov_full)
    del ov_full
    _set_wrappers(eng, wrappers)
    kinds = {kind for kind, _, _ in calls}
    scan_kinds = {"ram_core" if "ram_core" in kinds else "waits", "waits_kw", "bucket",
                  "controlled", "socket"}
    max_err = dict.fromkeys(FAST_KERNELS, 0.0)
    timed: dict = {k: {} for k in FAST_KERNELS}
    for kind, args, kw in calls:
        kernel = CALL_KINDS[kind][0]
        plain_ms, want = _time_plain(torch, lambda: _call(plains[kernel], kind, args, kw))
        got = _call(wrappers[kernel], kind, args, kw)
        err = _compare(torch, f"fast {name}: {kind} at full width", got, want)
        max_err[kernel] = max(max_err[kernel], err)
        del got, want
        if kernel == "station_scan" and kind not in scan_kinds:
            continue
        ms = time_kernel(torch, lambda: _call(wrappers[kernel], kind, args, kw), repeats=5)
        library_ms = None
        if kind == "waits" and args[3] == 1:
            library_ms = time_kernel(torch, lambda: _lindley_closed_form(torch, *args[:3]),
                                     repeats=3)
        bound = (_draws_bound(torch, kind, args, kw) if kernel == "edge_draws"
                 else _route_bound(kind, args) if kernel == "lb_route"
                 else _scan_bound(kind, args))
        timed[kernel][kind] = {"call": kind, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": library_ms, **bound}
        if kind == "waits" and args[3] == 1:
            timed[kernel][kind]["walk"] = "tree"
        if kind == "gap_cumsum":
            # a yardstick for the scan alone: torch's cumsum over the same
            # gaps (another order, no draws: not the same function)
            gaps = wrappers[kernel].uniform(*args, gap=True)
            timed[kernel][kind]["cumsum_ms"] = time_kernel(
                torch, lambda: torch.cumsum(gaps, dim=1), repeats=5)
            del gaps
        if kind in SCAN_CHAIN_CLOCKS:
            # the valid elements: each row's are its chain's length
            valid = args[{"bucket": 1, "controlled": 2}.get(kind, 5)]
            timed[kernel][kind].update(
                shape=tuple(valid.shape), valid_share=float(valid.float().mean()),
                valid_max=int(valid.sum(dim=1).max()))
    ov = eng._overrides(base_overrides(plan), MAIN_SCENARIOS)
    _lam, counts = eng.window_draws(keys, ov["um"], ov["rr"])
    ts, valids, _ = eng._stream_arrivals(fold_in(keys, 0), counts)
    t, valid = torch.cat(ts, dim=1), torch.cat(valids, dim=1)
    del ts, valids
    rank_ms = time_kernel(torch, lambda: time_rank(t, valid), repeats=3)
    del t, valid, calls
    against = (f" ({rel_ref:+.3%} vs the JAX fast path {ref * 1e3:.4f} ms"
               if ref is not None else " (no JAX reference")
    against += (f", {rel_des:+.3%} vs the DES kernel {des_p95 * 1e3:.4f} ms)"
                if des_p95 is not None else f"; the DES kernel refuses {des['refused']!r})")
    print(
        f"fast path {name}: {MAIN_SCENARIOS} scenarios x {plan.horizon:.0f} s, "
        f"{eng.n} lanes ({eng.gen_n} a stream), chunks of {runner.default_chunk}, launches "
        f"{launches} ({fault_launches} hops under fault tables; station_scan by mode "
        f"{mode_launches}, by walk {walk_launches}), "
        f"{report.wall_seconds:.3f} s wall, {summary['scenarios_per_second']:.1f} scen/s"
        + ("" if des.get("scen_per_s") is None
           else f" (DES kernel sweep {des['scen_per_s']:.1f} scen/s)")
        + f", peak device memory {peak_gb:.2f} GB; p50 "
        f"{summary['latency_p50_s'] * 1e3:.3f} ms, p95 {p95 * 1e3:.4f} ms{against}, p99 "
        f"{summary['latency_p99_s'] * 1e3:.3f} ms; completed "
        f"{summary['completed_total']}, dropped {summary['dropped_total']}",
        flush=True,
    )
    if sample_s is not None:
        print(f"  the campaign's fault tables of {MAIN_SCENARIOS} scenarios sampled on the "
              f"host in {sample_s:.3f} s", flush=True)
    if name in CONTROL_PATHS:
        ref_rej = REFERENCE_FAST[name]["rejected_fraction"]
        print(f"  controls: rejected fraction {rejected_fraction:.6f} (JAX fast path "
              f"{ref_rej:.6f}; DES kernel {des['rejected_fraction']:.6f}, "
              f"{rejected_fraction - des['rejected_fraction']:+.6f}); p95 "
              f"{p95 * 1e3:.4f} ms, DES kernel {des_p95 * 1e3:.4f} ms ({rel_des:+.3%}); "
              f"{lc_launches} least-connections walks, {cand_launches} candidates launches",
              flush=True)
    if name in RESILIENCE_PATHS:
        print("  resilience: " + ", ".join(
            f"{key} {summary.get(key)}" for key in (
                "rejected_total", "dark_lost_total", "availability_fraction",
                "unavailable_s_total", "hazard_truncated_total", "timed_out_total",
                "retries_total", "retry_budget_exhausted_total", "goodput_fraction",
                "time_to_drain_mean_s")),
            flush=True)
    if name in GAUGE_PATHS:
        drained = int(np.isfinite(res.time_to_drain).sum()) if res.time_to_drain is not None else 0
        print(f"  streamed {GAUGE_PATHS[name]}: {gauge_launches} gauge_grid launches; time to "
              f"drain finite in {drained} of {MAIN_SCENARIOS} scenarios", flush=True)
    for kernel, modes in timed.items():
        for kind, m in modes.items():
            lib = "null" if m["library_ms"] is None else f"{m['library_ms']:.3f} ms"
            walk = f", {m['walk']} walk" if "walk" in m else ""
            print(f"  {kernel} ({kind}{walk}): {m['ms']:.3f} ms, plain {m['plain_ms']:.1f} ms, "
                  f"library {lib}, {_bound_text(m)}", flush=True)
    print(f"  stable row rank (torch.sort) of the arrivals: {rank_ms:.3f} ms; calls "
          f"{sorted(kinds)} at full width bit-exact with their plain versions", flush=True)
    hop_kind = next((k for k in ("hop_lb_fault", "hop_lb", "hop_slot_spike", "hop_spike",
                                 "hop_fault", "hop") if k in kinds), "hop")
    headline_kind = {"edge_draws": hop_kind,
                     "station_scan": "ram_core" if "ram_core" in kinds else "waits",
                     "lb_route": "route_table"}
    return {
        "launches": launches,
        "gauge_launches": gauge_launches,
        "fault_launches": fault_launches,
        "cand_launches": cand_launches,
        "lc_launches": lc_launches,
        "rejected_fraction": rejected_fraction,
        "des_rejected_fraction": des.get("rejected_fraction"),
        "hazard_sample_s": sample_s,
        "summary": {k: summary.get(k) for k in (
            "completed_total", "dropped_total", "rejected_total", "dark_lost_total",
            "availability_fraction", "unavailable_s_total", "timed_out_total",
            "retries_total", "retry_budget_exhausted_total")},
        "mode_launches": mode_launches,
        "walk_launches": walk_launches,
        "wall_s": report.wall_seconds,
        "scen_per_s": summary["scenarios_per_second"],
        "des_scen_per_s": des.get("scen_per_s"),
        "p95_s": p95,
        "des_p95_s": des_p95,
        "peak_gb": peak_gb,
        "rank_ms": rank_ms,
        "timed": {k: {"main": headline_kind[k], "modes": v} for k, v in timed.items()},
        "max_abs_err": max_err,
    }


#: gauge_grid's work a lane: the two buckets' multiplies, ceilings and
#: clamps (fp32), their conversions and addresses (int32)
GAUGE_LANE_OPS = (4, 8)
#: the fine grid's check: the headline cut to 30 s at a 0.01 s sample
#: period, 3,001 rows, past the shared form's 2,048 (the global form)
GAUGE_FINE_HORIZON = 30
GAUGE_FINE_PERIOD = 0.01
#: examples/sweeps/overload_policy.py's load points (fractions of BASE_USERS
#: = 100 users), swept through make_overrides' user_mean axis from a base at
#: the top point, 110 users (a rate raise past the base would leave the
#: fast path's proofs)
OVERLOAD_LOAD_POINTS = (0.6, 0.75, 0.9, 1.0, 1.1)
OVERLOAD_BASE_USERS = 100


def gauge_series_payload() -> dict:
    """examples/sweeps/gauge_series_sweep.py's payload: single_server.yml
    at CPU 20 ms then IO 10 ms, 120 users, 120 s."""
    data = copy.deepcopy(SINGLE_SERVER)
    data["topology_graph"]["nodes"]["servers"][0]["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.020}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.01}},
    ]
    data["rqs_input"]["avg_active_users"]["mean"] = 120
    data["sim_settings"]["total_simulation_time"] = 120
    return data


#: the wrapper's group methods: each call's grid, then its arguments
GAUGE_METHODS = ("add", "add_queue", "add_trail", "add_slots")
#: gauge_grid's launches a chunk on the headline's series run: two entry
#: hops, the LB's edges, and a visit's queue, the trailing IO and RAM and
#: the exit hop at each of the two servers
GAUGE_HEADLINE_LAUNCHES = 9
#: the same with one launch a site, the kernel's first design (NVIDIA H100
#: 80GB HBM3, 700.00 W; this script's phase 6 on that design, PERF.md):
#: 14 launches, 1.0394 ms each, 14.6 ms a chunk
GAUGE_SITE_BY_SITE = {"launches": 14, "ms": 1.0394, "chunk_ms": 14.6}


def _record_gauge_calls(eng) -> tuple:
    """Put a recorder in place of the engine's gauge_grid wrapper: each call
    is passed on, its method and arguments kept with a copy of the grid it
    was given.  Returns the calls and the wrapper, to be put back."""
    calls: list = []
    inner = eng.gauge

    class Recorder:
        pass

    def recording(method):
        def call(grid, *args, **kw):
            calls.append((method, grid.clone(), args, kw))
            getattr(inner, method)(grid, *args, **kw)
        return call

    recorder = Recorder()
    for method in GAUGE_METHODS:
        setattr(recorder, method, recording(method))
    eng.gauge = recorder
    return calls, inner


def _gauge_sites(torch, method: str, args: tuple, kw: dict) -> list:
    """The (column, t0, t1, on, amount) sites a recorded call stands for,
    built as the plain versions build them."""
    if method == "add":
        col, t0, t1, on, amount, _ = args
        return [(col, t0, t1, on, amount)]
    if method == "add_queue":
        cols, e, w, p, vb, _ = args
        return [(cols[0], e, e + w, vb & (w > 0), 1.0), (cols[1], e - p, e, vb & (p > 0), 1.0)]
    if method == "add_trail":
        cols, start, dep, t, w_ram, mine, ram, _ = args
        held = t if w_ram is None else t + w_ram
        return [(cols[0], start, dep, mine & (dep > start), 1.0),
                (cols[1], held, dep, mine & (ram > 0), ram)]
    cols, t0, t1, ok, _ = args
    pick = kw["rank"] % len(cols) if kw.get("rank") is not None else kw["slot"]
    return [(c, t0, t1, ok & (pick == k), 1.0) for k, c in enumerate(cols)]


def _gauge_moved(torch, method: str, grid, args: tuple, kw: dict) -> tuple:
    """(bytes, intervals a lane) of a call: each tensor operand read once,
    the group's columns read and written once a row."""
    seen, moved = set(), 0
    for x in (*args, *kw.values()):
        if isinstance(x, torch.Tensor) and x.ndim == 2 and id(x) not in seen:
            seen.add(id(x))
            moved += x.numel() * x.element_size()
    cols = 1 if method == "add" else len(args[0])
    intervals = {"add": 1, "add_queue": 2, "add_trail": 2, "add_slots": 1}[method]
    return moved + 2 * grid.shape[0] * grid.shape[1] * cols * 4, intervals


def _gauge_replay(torch, label: str, calls: list, *, timed: bool = False) -> dict:
    """Each recorded call through the kernel and through its plain version
    on a copy of its grid, bit-exact (the amounts are whole); with
    ``timed``, each call's ms between CUDA events, the plain version's, one
    ``scatter_add_`` of the precomputed buckets of its sites into the grid's
    columns (the library call) and the bound: means a launch, and sums over
    the calls."""
    import numpy as np

    from asyncflow_tpu_torch.engines.torchsim.gauge_grid import GaugeGrid, PlainGaugeGrid
    from asyncflow_tpu_torch.engines.torchsim.sampling import sample_bucket

    kernel, timer, plain = GaugeGrid(), GaugeGrid(), PlainGaugeGrid()
    rows = []
    for i, (method, grid, args, kw) in enumerate(calls):
        sites = _gauge_sites(torch, method, args, kw)
        for _, _, _, _, amount in sites:
            if not (isinstance(amount, float)
                    or bool(torch.all(amount == torch.round(amount)))):
                raise SmokeError(f"gauge {label}: call {i} adds fractional amounts")
        got = grid.clone()
        getattr(kernel, method)(got, *args, **kw)
        want = grid.clone()
        plain_ms, _ = _time_plain(torch, lambda: getattr(plain, method)(want, *args, **kw))
        if not torch.equal(got, want):
            diff = (got - want).abs().max().item()
            raise SmokeError(f"gauge {label}: call {i} ({method}) differs from the plain "
                             f"version by up to {diff}")
        del got, want
        if not timed:
            continue
        scratch = grid.clone()
        ms = time_kernel(torch, lambda: getattr(timer, method)(scratch, *args, **kw),
                         repeats=5)
        s_rows, n_rows, g = grid.shape
        n_samples = n_rows - 2
        idx, val = [], []
        for col, t0, t1, on, amount in sites:
            v = torch.where(on, amount, 0.0).to(torch.float32)
            idx += [sample_bucket(t0, args[-1], n_samples) * g + col,
                    sample_bucket(t1, args[-1], n_samples) * g + col]
            val += [v, -v]
        idx, val = torch.cat(idx, dim=1), torch.cat(val, dim=1)
        flat = scratch.view(s_rows, n_rows * g)
        library_ms = time_kernel(torch, lambda: flat.scatter_add_(1, idx, val), repeats=5)
        moved, intervals = _gauge_moved(torch, method, grid, args, kw)
        lanes = s_rows * args[1].shape[1] * intervals
        bound = _bound_of(moved, GAUGE_LANE_OPS[0] * lanes, GAUGE_LANE_OPS[1] * lanes)
        rows.append({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound})
        del scratch, idx, val, flat
    out = {"calls": len(calls), "forms": dict(kernel.form_launches),
           "groups": dict(kernel.group_launches), "max_abs_err": 0.0}
    if rows:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "operations_ms"):
            out[key] = float(np.mean([r[key] for r in rows]))
            out[f"{key}_sum"] = float(np.sum([r[key] for r in rows]))
        out["bound_by"] = "bytes" if out["bytes_ms"] >= out["operations_ms"] else "operations"
    return out


def _gauge_work(torch, on_eng, off_eng, keys, turns: int = 2) -> dict:
    """The gauge work a chunk: one chunk's ``run_tensors`` with the grid
    (``on_eng``) and without (``off_eng``) between CUDA events, in turns
    (off, on, on, off, ..), each the median of three; the difference of
    the medians is the grid's launches and the passes that feed them."""
    import numpy as np

    times: dict = {"off": [], "on": []}
    for turn in ("off", "on", "on", "off") * turns:
        eng = on_eng if turn == "on" else off_eng
        times[turn].append(time_kernel(torch, lambda e=eng: e.run_tensors(keys), repeats=3))
    on_ms, off_ms = float(np.median(times["on"])), float(np.median(times["off"]))
    return {"on_ms": on_ms, "off_ms": off_ms, "work_ms": on_ms - off_ms, "turns": times}


def _rows_p95(res, rows) -> float:
    import numpy as np

    from asyncflow_tpu_torch.engines.results import hist_percentile

    pooled = res.latency_hist[rows].sum(axis=0)
    return float(hist_percentile(pooled, res.hist_edges, 95)) if pooled.sum() else float(
        np.nan)


def phase_gauge(torch) -> dict:
    """Phase 6, the gauge grid: the headline with both
    servers' ready queues streamed at 1 s and the same sweep without, in
    turns (off, on, on, off), which must agree in every other output, the
    series run launching gauge_grid (counts set to 0 just before it, its
    shared form only, GAUGE_HEADLINE_LAUNCHES a chunk); that run's calls
    replayed through the kernel and the plain versions, bit-exact, and
    timed; the gauge work a chunk; the fine grid of the headline cut
    to 30 s at a 0.01 s period (the global form), bit-exact; the
    gauge_series_sweep example's payload at 2048 scenarios with its band and
    the pooled p95's interval; overload_policy's user_mean axis through
    make_overrides, each load point's p95 and rejected fraction."""
    import numpy as np

    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.parallel import SweepRunner, make_overrides
    from asyncflow_tpu_torch.schemas import SimulationPayload

    t_start = time.perf_counter()
    off = SweepRunner(TWO_SERVERS_LB, device="cuda")
    on = SweepRunner(TWO_SERVERS_LB, device="cuda", gauge_series=GAUGE_SERIES)
    eng = on.engine
    on.run(MAIN_SCENARIOS, seed=0)  # warm the gauge library
    walls = {"off": [], "on": []}
    reports = {}
    for turn in ("off", "on", "on", "off"):
        runner = on if turn == "on" else off
        if turn == "on" and not walls["on"]:
            eng.gauge.launches = 0
            eng.gauge.form_launches = dict.fromkeys(eng.gauge.form_launches, 0)
        report = runner.run(MAIN_SCENARIOS, seed=0)
        if turn == "on" and not walls["on"]:
            launches = eng.gauge.launches
            forms = dict(eng.gauge.form_launches)
        walls[turn].append(report.wall_seconds)
        reports.setdefault(turn, report)
    chunks = -(-MAIN_SCENARIOS // on.default_chunk)
    if launches != GAUGE_HEADLINE_LAUNCHES * chunks or forms["global"] != 0:
        raise SmokeError(f"gauge: the series sweep launched gauge_grid {launches} times "
                         f"({forms}) over {chunks} chunks, not {GAUGE_HEADLINE_LAUNCHES} a "
                         f"chunk")
    a, b = reports["on"].results, reports["off"].results
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if field.name.startswith("gauge_") and field.name != "gauge_means":
            continue
        if isinstance(x, np.ndarray) and not np.array_equal(x, y):
            raise SmokeError(f"gauge: the series changed {field.name} of the headline's sweep")
    series = a.gauge_series
    if series is None or series.shape != (MAIN_SCENARIOS, eng.plan.n_samples
                                          // eng.gauge_series_stride, 2) \
            or not np.isfinite(series).all() or series.min() < 0:
        raise SmokeError(f"gauge: the headline's series is {None if series is None else series.shape}")
    calls, kernel = _record_gauge_calls(eng)
    on.run(MAIN_SCENARIOS, seed=0)
    eng.gauge = kernel
    headline = _gauge_replay(torch, "headline stride grid", calls, timed=True)
    del calls
    keys = scenario_keys(0, on.default_chunk, device="cuda")
    work = _gauge_work(torch, eng, off.engine, keys)
    del keys
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["sim_settings"].update(total_simulation_time=GAUGE_FINE_HORIZON,
                                sample_period_s=GAUGE_FINE_PERIOD)
    fine_eng = FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cuda",
                          collect_gauges=True)
    calls, _ = _record_gauge_calls(fine_eng)
    fine_eng.run_tensors(scenario_keys(0, MAIN_SCENARIOS, device="cuda"))
    fine = _gauge_replay(torch, "fine grid (30 s at 0.01 s)", calls)
    del calls, fine_eng
    if headline["forms"]["shared"] != headline["calls"] or fine["forms"]["global"] != fine["calls"]:
        raise SmokeError(f"gauge: the checks took the forms {headline['forms']} and "
                         f"{fine['forms']}")
    wall_on, wall_off = min(walls["on"]), min(walls["off"])
    print(f"gauge: headline {MAIN_SCENARIOS} x {eng.plan.horizon:.0f} s streaming "
          f"{GAUGE_SERIES}: {wall_on:.3f} s wall, {MAIN_SCENARIOS / wall_on:.1f} scen/s; "
          f"without the series {wall_off:.3f} s, {MAIN_SCENARIOS / wall_off:.1f} scen/s "
          f"(turns off, on, on, off: {walls}); every other output equal", flush=True)
    print(f"gauge: gauge_grid {launches} launches ({launches // chunks} a chunk of "
          f"{on.default_chunk}: {headline['groups']}), {headline['ms']:.4f} ms a launch "
          f"(shared form), plain {headline['plain_ms']:.3f} ms, scatter_add_ "
          f"{headline['library_ms']:.4f} ms, {_bound_text(headline)}; the headline's "
          f"{headline['calls']} calls and the fine grid's {fine['calls']} ({fine['forms']}, "
          f"{fine['groups']}) bit-exact with the plain versions", flush=True)
    print(f"gauge: a chunk's launches {headline['ms_sum']:.3f} ms against their bound "
          f"{headline['bound_ms_sum']:.3f} ms ({headline['ms_sum'] / headline['bound_ms_sum']:.2f}"
          f"x), scatter_add_ of the same sites {headline['library_ms_sum']:.3f} ms; the first "
          f"design's one launch a site: {GAUGE_SITE_BY_SITE['launches']} launches, "
          f"{GAUGE_SITE_BY_SITE['ms']} ms each, {GAUGE_SITE_BY_SITE['chunk_ms']} ms a chunk",
          flush=True)
    print(f"gauge: the gauge work a chunk (run_tensors of {on.default_chunk} scenarios with "
          f"and without the grid, CUDA events, medians of turns off, on, on, off x 2): "
          f"{work['work_ms']:.3f} ms ({work['on_ms']:.3f} against {work['off_ms']:.3f} ms; "
          f"{work['turns']})", flush=True)

    sweep_runner = SweepRunner(gauge_series_payload(), device="cuda",
                               gauge_series=("ready_queue_len", ["srv-1"], 1.0))
    sweep_runner.run(MAIN_SCENARIOS, seed=7)
    sweep_runner.engine.gauge.launches = 0
    report = sweep_runner.run(MAIN_SCENARIOS, seed=7)
    sweep_launches = sweep_runner.engine.gauge.launches
    _, p10, p50, p90 = report.gauge_series_band("srv-1", 10, 90)
    est = report.pooled_percentile_ci(95)
    if sweep_launches < 1 or not (np.isfinite(p50).all() and est.lo <= est.point <= est.hi):
        raise SmokeError(f"gauge: gauge_series_sweep gave launches {sweep_launches}, "
                         f"median {p50[:4]}, interval {est}")
    print(f"gauge: gauge_series_sweep.py's payload, {MAIN_SCENARIOS} scenarios: "
          f"{report.scenarios_per_second:.1f} scen/s, ready-queue median {p50.mean():.3f}, "
          f"10-90% band width {np.mean(p90 - p10):.3f}; pooled p95 {est.point * 1e3:.3f} ms "
          f"(95% interval [{est.lo * 1e3:.3f}, {est.hi * 1e3:.3f}] ms, n {est.n}); "
          f"{sweep_launches} gauge_grid launches", flush=True)

    points = np.asarray(OVERLOAD_LOAD_POINTS)
    block = np.arange(MAIN_SCENARIOS) * len(points) // MAIN_SCENARIOS
    top = OVERLOAD_BASE_USERS * float(points.max())
    for cap in (None, 8):
        runner = SweepRunner(overload_payload(top, None if cap is None
                                              else {"max_ready_queue": cap}), device="cuda")
        users = (OVERLOAD_BASE_USERS * points[block]).astype(np.float32)
        ov = make_overrides(runner.plan, MAIN_SCENARIOS, user_mean=users)
        res = runner.run(MAIN_SCENARIOS, seed=3, overrides=ov).results
        cells = []
        for k, load in enumerate(points):
            rows = block == k
            rejected = int(res.total_rejected[rows].sum())
            shed = rejected / max(rejected + int(res.completed[rows].sum()), 1)
            p95 = _rows_p95(res, rows)
            if not np.isfinite(p95) or (cap is None and rejected):
                raise SmokeError(f"gauge: overload cap {cap} at load {load}: p95 {p95}, "
                                 f"rejected {rejected}")
            cells.append(f"{load:.0%} p95 {p95 * 1e3:.2f} ms rejected {shed:.4%}")
        label = "unbounded" if cap is None else f"ready-queue cap {cap}"
        print(f"gauge: overload_policy's user_mean axis, {label} ({MAIN_SCENARIOS} scenarios, "
              f"{MAIN_SCENARIOS // len(points)} a point): " + "; ".join(cells), flush=True)
    seconds = time.perf_counter() - t_start
    print(f"gauge: phase seconds {seconds:.1f}", flush=True)
    return {"launches": launches + sweep_launches, "headline": headline, "fine": fine,
            "wall_on_s": wall_on, "wall_off_s": wall_off, "seconds": seconds,
            "launches_a_chunk": launches // chunks, "work": work}



#: blame_grid's shapes phase 4 holds to the plain version: (scenarios,
#: lanes, credits, coarse bins, cells, per-lane cells): a segment and less,
#: rows off every multiple of 32, many credits and cells (31 rows: one pass;
#: 81 rows: two passes of 64), and the headline's width
BLAME_CASES = ((3, 1000, 4, 64, 108, True), (5, 33, 2, 64, 36, False),
               (64, 20011, 9, 64, 108, True), (17, 4111, 30, 64, 600, True),
               (5, 3001, 80, 64, 600, True), (2048, 87840, 9, 64, 108, True))


def _blame_credits(torch, s: int, n: int, c_n: int, n_cells: int, per_lane: bool, seed: int):
    """Random credits of ``s`` x ``n`` lanes (a third of each zero, the
    first all zero), a per-lane credit among them where asked, targets
    from -1 to nbb + 1 (out of range: dropped) and latencies."""
    from asyncflow_tpu_torch.engines.torchsim.blame_grid import Credit

    g = torch.Generator(device="cuda").manual_seed(seed)
    credits = []
    for c in range(c_n):
        secs = torch.rand((s, n), generator=g, device="cuda") * 0.01
        secs = torch.where(torch.rand((s, n), generator=g, device="cuda") < 0.3, 0.0, secs)
        if c == 0:
            secs = torch.zeros_like(secs)
        if per_lane and c == 2:
            slot = torch.randint(0, 3, (s, n), generator=g, device="cuda", dtype=torch.int32)
            credits.append(Credit(secs, slot=slot.to(torch.uint8),
                                  slot_cells=((7 * c) % n_cells, (7 * c + 1) % n_cells, 5)))
        else:
            credits.append(Credit(secs, cell=(13 * c) % n_cells))
    return credits, g


def _blame_compare(torch, label: str, kernel, credits, target, latency, n_cells: int,
                   nbb: int) -> float:
    """``blame_grid`` twice (the same bits) and its plain version on the
    same credits: each cell within one float32 ulp of the plain sums (the
    float64 sums' order); prints the cells that differ.  Returns the
    largest absolute difference."""
    from asyncflow_tpu_torch.engines.torchsim.blame_grid import blame_grid_plain

    grid, lat = kernel.reduce(credits, target, latency, n_cells, nbb)
    again = kernel.reduce(credits, target, latency, n_cells, nbb)
    if not (torch.equal(grid, again[0]) and torch.equal(lat, again[1])):
        raise SmokeError(f"blame_grid {label}: two launches gave different bits")
    want = blame_grid_plain(credits, target, latency, n_cells, nbb)
    worst, off = 0.0, 0
    for got, exp in zip((grid, lat), want, strict=True):
        ulps = (got.view(torch.int32).long() - exp.view(torch.int32).long()).abs()
        if int(ulps.max()) > 1:
            raise SmokeError(f"blame_grid {label}: a cell {int(ulps.max())} ulps from the "
                             "plain version")
        off += int((ulps > 0).sum())
        worst = max(worst, float((got.double() - exp.double()).abs().max()))
    print(f"fast check: blame_grid {label} == plain within 1 ulp ({off} cells 1 ulp off, "
          f"max abs {worst:.3g}); two launches bit-identical", flush=True)
    return worst


def _blame_grid_check(torch) -> float:
    """blame_grid against its plain version at BLAME_CASES and on the
    credits of a planes run of the headline cut to FAST_CHECK_HORIZON (each
    twice, which must give the same bits).  Returns the largest absolute
    difference."""
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.blame_grid import BlameGrid
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.schemas import SimulationPayload

    kernel, worst = BlameGrid(), 0.0
    for i, (s, n, c_n, nbb, n_cells, per_lane) in enumerate(BLAME_CASES):
        credits, g = _blame_credits(torch, s, n, c_n, n_cells, per_lane, i)
        target = torch.randint(-1, nbb + 2, (s, n), generator=g, device="cuda").to(torch.int16)
        latency = torch.rand((s, n), generator=g, device="cuda")
        worst = max(worst, _blame_compare(torch, f"{s} x {n}, {c_n} credits, {n_cells} cells",
                                          kernel, credits, target, latency, n_cells, nbb))
        del credits, target, latency
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["sim_settings"]["total_simulation_time"] = FAST_CHECK_HORIZON
    eng = FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cuda",
                     blame=True)
    calls, _ = _record_blame_calls(eng)
    eng.run_tensors(scenario_keys(0, FAST_CHECK_SCENARIOS, device="cuda"))
    for credits, target, latency, n_cells, nbb in calls:
        worst = max(worst, _blame_compare(torch, "the headline's credits, 64 x 60 s", kernel,
                                          credits, target, latency, n_cells, nbb))
    torch.cuda.empty_cache()
    return worst


def _record_blame_calls(eng) -> tuple:
    """Put a recorder in place of the engine's blame_grid wrapper: each call
    is passed on and its arguments kept.  Returns the calls and the
    wrapper."""
    calls: list = []
    inner = eng.blame_grid

    class Recorder:
        launches = 0

        def reduce(self, *args):
            calls.append(args)
            return inner.reduce(*args)

    eng.blame_grid = Recorder()
    return calls, inner


def _blame_timed(torch, call) -> dict:
    """One recorded blame_grid call timed between CUDA events: the kernel,
    its plain version (host clock), one ``scatter_add_`` of the same credits
    and latencies into a float32 grid (the library call, their keys made
    beforehand), and the bound: each credit, slot, target and latency read
    once, the grid and totals written once (the float64 adds far below)."""
    from asyncflow_tpu_torch.engines.torchsim.blame_grid import BlameGrid, blame_grid_plain

    credits, target, latency, n_cells, nbb = call
    kernel = BlameGrid()
    ms = time_kernel(torch, lambda: kernel.reduce(credits, target, latency, n_cells, nbb), 5)
    plain_ms, _ = _time_plain(torch, lambda: blame_grid_plain(credits, target, latency,
                                                              n_cells, nbb))
    s, n = target.shape
    tgt = torch.where((target < 0) | (target >= nbb), nbb, target.long())
    keys = [torch.as_tensor(c.cells(), device="cuda") * (nbb + 1) + tgt for c in credits]
    keys.append(n_cells * (nbb + 1) + tgt)
    idx = torch.cat([k.expand(s, n) for k in keys], dim=1)
    del keys
    val = torch.cat([c.secs for c in credits] + [latency], dim=1)
    flat = torch.zeros((s, (n_cells + 1) * (nbb + 1)), dtype=torch.float32, device="cuda")
    library_ms = time_kernel(torch, lambda: flat.zero_().scatter_add_(1, idx, val), 5)
    del idx, val, flat
    moved = (sum(c.secs.numel() * 4 + (0 if c.slot is None else c.slot.numel())
                 for c in credits)
             + target.numel() * 2 + latency.numel() * 4 + s * (n_cells + 1) * nbb * 4)
    bound = _bound_of(moved, 0, 0, (len(credits) + 1) * s * n)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "moved": moved, **bound}


#: TraceConfig of the planes phase (the reference's defaults)
PLANE_TRACE = {"sample_requests": 8, "event_slots": 48}


def _plane_fields(res) -> list:
    """The SweepResults fields of the planes (every other is held equal)."""
    return [f.name for f in dataclasses.fields(res)
            if f.name.startswith(("flight_", "blame_"))]


def _check_planes(label: str, base, traced, both) -> None:
    """Every output but the planes' bit-identical across the three runs;
    the rings equal with one plane and with both; pooled conservation in
    every coarse bin within 1e-3."""
    import numpy as np

    planes = _plane_fields(base.results)
    for field in dataclasses.fields(base.results):
        if field.name in planes:
            continue
        want = getattr(base.results, field.name)
        for other in (traced, both):
            got = getattr(other.results, field.name)
            if isinstance(want, np.ndarray) and not np.array_equal(want, got):
                raise SmokeError(f"planes {label}: the planes changed {field.name}")
    for name in ("flight_ev", "flight_node", "flight_t", "flight_n"):
        if not np.array_equal(getattr(traced.results, name), getattr(both.results, name)):
            raise SmokeError(f"planes {label}: {name} differs with blame on")
    res = both.results
    cells = res.blame_hist.sum(axis=0)
    lat = res.blame_lat_hist
    rel = np.abs(cells - lat) / np.maximum(lat, 1e-300)
    if np.any((lat == 0) & (cells != 0)) or np.any(rel[lat > 0] > 1e-3) or lat.sum() <= 0:
        raise SmokeError(f"planes {label}: pooled conservation off by up to "
                         f"{rel[lat > 0].max()} in a coarse bin")
    print(f"planes {label}: every other output bit-identical across untraced, traced and "
          f"both planes; pooled conservation within {rel[lat > 0].max():.3g} in all "
          f"{int((lat > 0).sum())} occupied coarse bins", flush=True)


def phase_planes(torch) -> dict:
    """Phase 7, the observability planes on the main path: the headline
    (600 s, 2048 scenarios) through ``SweepRunner`` untraced, with
    ``trace=TraceConfig()`` and with both planes, in turns (scen/s each),
    every other output bit-identical, pooled conservation in every coarse
    bin, the both-planes run launching blame_grid (its count set to 0 just
    before it) and its peak device memory; one scenario's flight records
    decoded and the p95 bin's blame; outage_retry with both planes against
    its untraced sweep (its rings across attempt blocks); the headline's
    blame_grid call timed."""
    from asyncflow_tpu_torch.observability import TraceConfig
    from asyncflow_tpu_torch.parallel import SweepRunner

    t_start = time.perf_counter()
    runners = {"off": SweepRunner(TWO_SERVERS_LB, device="cuda"),
               "trace": SweepRunner(TWO_SERVERS_LB, device="cuda",
                                    trace=TraceConfig(**PLANE_TRACE)),
               "both": SweepRunner(TWO_SERVERS_LB, engine="auto", device="cuda",
                                   trace=TraceConfig(**PLANE_TRACE), blame=True)}
    for runner in runners.values():
        if runner.engine_kind != "fast":
            raise SmokeError(f"planes: auto took the {runner.engine_kind} engine")
        runner.run(MAIN_SCENARIOS, seed=0)  # warm the allocator and libraries
    reports, scen_s, peak_gb = {}, {}, 0.0
    for label, runner in runners.items():
        torch.cuda.synchronize()
        if label == "both":
            runner.engine.blame_grid.launches = 0
            torch.cuda.reset_peak_memory_stats()
        reports[label] = runner.run(MAIN_SCENARIOS, seed=0)
        if label == "both":
            launches = runner.engine.blame_grid.launches
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        scen_s[label] = reports[label].scenarios_per_second
    chunks = -(-MAIN_SCENARIOS // runners["both"].default_chunk)
    if launches != chunks:
        raise SmokeError(f"planes: blame_grid launched {launches} times over {chunks} chunks")
    print("planes: the headline at 2048 x 600 s: "
          + ", ".join(f"{k} {v:.1f} scen/s" for k, v in scen_s.items())
          + f"; peak {peak_gb:.2f} GB with both planes; blame_grid {launches} launches "
          f"({chunks} chunks)", flush=True)
    _check_planes("headline", reports["off"], reports["trace"], reports["both"])
    both = reports["both"]
    plan = runners["both"].plan
    for req, rec in sorted(both.flight_records(0).items())[:2]:
        print(f"planes: scenario 0, request {req}: "
              + "; ".join(rec.describe(server_ids=plan.server_ids, edge_ids=plan.edge_ids)),
              flush=True)
    blame = both.latency_blame(0.95)
    print(f"planes: the p95 bin [{blame.bin_lo_s:.4f}, {blame.bin_hi_s:.4f}) s, "
          f"{blame.n_requests:.0f} requests: "
          + ", ".join(f"{c} {p} {share:.3f}" for c, p, share in blame.top(4)), flush=True)
    # outage_retry: the rings across attempt blocks
    data = FAST_PAYLOADS["outage_retry"]
    off = SweepRunner(data, device="cuda")
    on = SweepRunner(data, device="cuda", trace=TraceConfig(**PLANE_TRACE), blame=True)
    ov = path_overrides("outage_retry", off.plan, MAIN_SCENARIOS)
    retry_reports = [r.run(MAIN_SCENARIOS, seed=0, overrides=ov) for r in (off, on)]
    _check_planes("outage_retry", retry_reports[0], retry_reports[1], retry_reports[1])
    from asyncflow_tpu_torch.observability.simtrace import FR_RETRY, FR_SPAWN

    ev = retry_reports[1].results.flight_ev
    if not (ev == FR_RETRY).any() or ((ev == FR_SPAWN).sum(axis=2) >= 2).sum() == 0:
        raise SmokeError("planes outage_retry: no ring holds a retry and a re-issue")
    print(f"planes outage_retry: {int((ev == FR_RETRY).sum())} retries in the rings, "
          f"{int(((ev == FR_SPAWN).sum(axis=2) >= 2).sum())} requests spawned twice or more, "
          f"{int(retry_reports[1].flight_dropped_events().sum())} events past the rings",
          flush=True)
    del retry_reports, off, on
    # the headline's blame_grid call, timed
    eng = runners["both"].engine
    calls, kernel = _record_blame_calls(eng)
    runners["both"].run(MAIN_SCENARIOS, seed=0)
    eng.blame_grid = kernel
    timed = _blame_timed(torch, calls[0])
    err = _blame_compare(torch, "the headline's call at 2048 x 87,840", kernel, *calls[0])
    del calls, runners, reports, both
    torch.cuda.empty_cache()
    print(f"planes: blame_grid {timed['ms']:.3f} ms a launch, {timed['ms'] * launches / chunks:.3f} "
          f"ms a chunk ({launches // chunks} launch a chunk); bound {timed['bound_ms']:.3f} ms "
          f"({timed['bound_by']}, {timed['moved'] / 1e9:.2f} GB); plain {timed['plain_ms']:.3f} "
          f"ms; one scatter_add_ {timed['library_ms']:.3f} ms", flush=True)
    print(f"planes: {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"launches": launches, "scen_s": scen_s, "peak_gb": peak_gb,
            "max_abs_err": err, **timed}


def kernels_report(check: dict, paths: dict, fast_check: dict, fast: dict,
                   gauge: dict, planes: dict) -> list:
    """The kernels line's entries: the DES kernel at the headline's capped
    check (its launches over the six DES paths), each fast kernel at its
    headline call (its launches over the thirteen fast paths), and the
    resilience, overload and routing modes at their paths' calls."""
    from asyncflow_tpu_torch.engines.torchsim.des_kernel import DesKernel
    from asyncflow_tpu_torch.engines.torchsim.draws import EdgeDraws
    from asyncflow_tpu_torch.engines.torchsim.routing import LbRoute
    from asyncflow_tpu_torch.engines.torchsim.station_scan import StationScan

    headline = check["two_servers_lb"]
    kernels = [
        {
            "name": DesKernel.name,
            "route": DesKernel.route,
            "source": DesKernel.source,
            "replaces": DesKernel.replaces,
            "launches": sum(p["launches"] for p in paths.values()),
            "max_abs_err": check["max_abs_err"],
            "ms": headline["ms"],
            "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"],
            "library_ms": None,
            "paths": {
                name: {
                    "launches": p["launches"],
                    "ms": p["ms"],
                    "bound_ms": p["bound_ms"],
                    "bound_by": p["bound_by"],
                    "events": p["events"],
                    "capped_check": {
                        key: check[name][key]
                        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "events")
                    },
                }
                for name, p in paths.items()
            },
        },
    ]
    # each fast kernel's numbers at its headline call: the headline's LB
    # hop and Lindley scan, event_inj_lb's timeline (its table and lanes
    # launches, timed each, summed)
    for wrapper, path in ((EdgeDraws, "two_servers_lb"), (StationScan, "two_servers_lb"),
                          (LbRoute, "event_inj_lb")):
        modes = fast[path]["timed"][wrapper.name]["modes"]
        parts = ([modes["route_table"], modes["route_slots"]] if wrapper is LbRoute
                 else [modes[fast[path]["timed"][wrapper.name]["main"]]])
        bound = {"bytes": sum(m["bytes_ms"] for m in parts),
                 "operations": sum(m["operations_ms"] for m in parts)}
        kernels.append({
            "name": wrapper.name,
            "route": wrapper.route,
            "source": wrapper.source,
            "replaces": wrapper.replaces,
            "launches": sum(f["launches"][wrapper.name] for f in fast.values()),
            "max_abs_err": max(fast_check[wrapper.name],
                               *(f["max_abs_err"][wrapper.name] for f in fast.values()),
                               *((fast_check["fault_hop"], fast_check["hop_widths"])
                                 if wrapper is EdgeDraws else ()),
                               *((fast_check["bucket"], fast_check["controls"])
                                 if wrapper is StationScan else ()),
                               *((fast_check["lc"],) if wrapper is LbRoute else ())),
            "ms": sum(m["ms"] for m in parts),
            "plain_ms": sum(m["plain_ms"] for m in parts),
            "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get),
            "library_ms": parts[0]["library_ms"] if len(parts) == 1 else None,
            "call": "+".join(m["call"] for m in parts),
            "path": path,
            "paths": {
                name: {
                    "launches": f["launches"][wrapper.name],
                    "modes": {
                        kind: {k: t[k] for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                        for kind, t in f["timed"][wrapper.name]["modes"].items()
                    },
                    **({"mode_launches": f["mode_launches"],
                        "walk_launches": f["walk_launches"]} if wrapper is StationScan
                       else {"fault_launches": f["fault_launches"]} if wrapper is EdgeDraws
                       else {}),
                }
                for name, f in fast.items()
            },
        })
    # the resilience and overload modes at their paths' calls: the LB hop
    # under chaos_campaign's sampled fault tables, the retry budget's token
    # bucket of outage_retry (its launches on every path), the rate limit's
    # bucket of rate_limited_lb, the controlled and socket scans of the
    # overload paths, least connections' walk and its candidates' hops
    # without sums on lc_mixed_fleet
    def mode_total(mode: str) -> int:
        return sum(f["mode_launches"][mode] for f in fast.values())

    for label, wrapper, path, kind, replaces, launches in (
        ("edge_draws (hop under fault tables)", EdgeDraws, "chaos_campaign", "hop_lb_fault",
         "asyncflow_tpu/engines/jaxsim/fastpath.py:799 (_edge_fault), :834-839 and "
         ":849-850 (_edge_hop's fault branch), :865-867 and :891-892 (_edge_hop_dyn's)",
         sum(f["fault_launches"] for f in fast.values())),
        ("station_scan (token bucket)", StationScan, "outage_retry", "bucket",
         "asyncflow_tpu/engines/jaxsim/fastpath.py:302 (_token_bucket_scan)",
         mode_total("bucket")),
        ("station_scan (token bucket, rate limit)", StationScan, "rate_limited_lb", "bucket",
         "asyncflow_tpu/engines/jaxsim/fastpath.py:302 (_token_bucket_scan), applied "
         ":1427-1453", mode_total("bucket")),
        ("station_scan (controlled)", StationScan, "overload_cap8", "controlled",
         "asyncflow_tpu/engines/jaxsim/fastpath.py:331 (_controlled_station_scan)",
         mode_total("controlled")),
        ("station_scan (socket)", StationScan, "overload_sockets", "socket",
         "asyncflow_tpu/engines/jaxsim/fastpath.py:374 (_socket_station_scan)",
         mode_total("socket")),
        ("lb_route (least connections)", LbRoute, "lc_mixed_fleet", "route_lc",
         "asyncflow_tpu/engines/jaxsim/fastpath.py:1067 (_routed_slots_lc)",
         sum(f["lc_launches"] for f in fast.values())),
        ("edge_draws (least-connections candidates)", EdgeDraws, "lc_mixed_fleet",
         "candidates", "asyncflow_tpu/engines/jaxsim/fastpath.py:1287-1293 (_edge_hop a "
         "slot, keyed 32 + slot)", sum(f["cand_launches"] for f in fast.values())),
    ):
        m = fast[path]["timed"][wrapper.name]["modes"][kind]
        check_err = {"hop_lb_fault": "fault_hop", "bucket": "bucket", "controlled": "controls",
                     "socket": "controls", "route_lc": "lc", "candidates": "hop_widths"}[kind]
        kernels.append({
            "name": label,
            "route": wrapper.route,
            "source": wrapper.source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(fast_check[check_err],
                               fast[path]["max_abs_err"][wrapper.name]),
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "call": kind,
            "path": path,
        })
    # the gauge grid at the headline's series run: a launch's mean over its
    # calls (its launches: that run's, gauge_series_sweep's and the chaos
    # campaign's)
    from asyncflow_tpu_torch.engines.torchsim.gauge_grid import GaugeGrid

    g = gauge["headline"]
    kernels.append({
        "name": GaugeGrid.name,
        "route": GaugeGrid.route,
        "source": GaugeGrid.source,
        "replaces": GaugeGrid.replaces,
        "launches": gauge["launches"] + sum(f["gauge_launches"] for f in fast.values()),
        "max_abs_err": max(g["max_abs_err"], gauge["fine"]["max_abs_err"]),
        "ms": g["ms"],
        "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"],
        "library_ms": g["library_ms"],
        "call": "the headline's gauge sites, a launch's mean",
        "path": "two_servers_lb with a streamed series",
        "launches_a_chunk": gauge["launches_a_chunk"],
    })
    # the blame grid at the headline's call with both planes (its launches:
    # that run's)
    from asyncflow_tpu_torch.engines.torchsim.blame_grid import BlameGrid

    kernels.append({
        "name": BlameGrid.name,
        "route": BlameGrid.route,
        "source": BlameGrid.source,
        "replaces": BlameGrid.replaces,
        "launches": planes["launches"],
        "max_abs_err": max(planes["max_abs_err"], fast_check["blame_grid"]),
        "ms": planes["ms"],
        "plain_ms": planes["plain_ms"],
        "bound_ms": planes["bound_ms"],
        "bound_by": planes["bound_by"],
        "library_ms": planes["library_ms"],
        "call": "the headline's credits with both planes, a launch",
        "path": "two_servers_lb with trace and blame",
    })
    return kernels


def sm_clock_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi``), MHz."""
    out = _run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"])
    return float(out.splitlines()[0])


def redesigned_report(fast: dict) -> None:
    """The redesigned kernels at their paths' full-width calls: least
    connections on lc_mixed_fleet, the static and LB hops under
    chaos_campaign's fault tables (each beside the same run's plain-table
    hop of the headline), the token bucket on rate_limited_lb and on
    outage_retry's last pass, the socket scan on overload_sockets and the
    controlled scan on overload_cap8 (each with its valid share and chain
    floor), the LB hop by slot on event_inj_lb and least connections'
    candidates on lc_mixed_fleet, the gap prefix sum on the headline,
    heavy_inj_single_server and chaos_campaign (beside torch's cumsum over
    the same gaps), each ms beside its bound (and the parent tree's,
    PARENT_MS), and every instance's registers and spills."""
    def mode(path: str, lib: str, kind: str) -> str:
        m = fast[path]["timed"][lib]["modes"].get(kind)
        if m is None:
            return f"{kind} not called"
        return f"{kind} {m['ms']:.4f} ms (bound {m['bound_ms']:.4f} ms, {m['bound_by']})"

    print("redesigned: lb_route least connections on lc_mixed_fleet: "
          + mode("lc_mixed_fleet", "lb_route", "route_lc"), flush=True)
    print("redesigned: edge_draws under fault tables on chaos_campaign: "
          + "; ".join(mode("chaos_campaign", "edge_draws", k) for k in ("hop_fault",
                                                                         "hop_lb_fault"))
          + "; the headline's plain hops: "
          + "; ".join(mode("two_servers_lb", "edge_draws", k) for k in ("hop", "hop_lb")),
          flush=True)
    mhz = sm_clock_mhz()
    def parent(path: str, kind: str) -> str:
        was = PARENT_MS.get((path, kind))
        return "" if was is None else f"; parent {was}"

    for path, kind in (("rate_limited_lb", "bucket"), ("outage_retry", "bucket"),
                       ("overload_sockets", "socket"), ("overload_cap8", "controlled")):
        m = fast[path]["timed"]["station_scan"]["modes"].get(kind)
        if m is None:
            print(f"redesigned: station_scan {kind} on {path}: not called", flush=True)
            continue
        floor_ms = m["valid_max"] * SCAN_CHAIN_CLOCKS[kind] / (mhz * 1e3)
        print(f"redesigned: station_scan {kind} on {path} ({m['shape'][0]} x "
              f"{m['shape'][1]}, valid share {m['valid_share']:.4f}, the longest row "
              f"{m['valid_max']} valid): {m['ms']:.4f} ms (bound {m['bound_ms']:.4f} ms, "
              f"{m['bound_by']}; chain floor {floor_ms:.4f} ms at "
              f"{SCAN_CHAIN_CLOCKS[kind]} clocks an element, {mhz:.0f} MHz"
              f"{parent(path, kind)})", flush=True)
    for path, lanes, label in (("event_inj_lb", "hop_slot", "LB hop by slot"),
                               ("lc_mixed_fleet", "candidates", "least-connections candidates")):
        modes = fast[path]["timed"]["edge_draws"]["modes"]
        kind = next((k for k in modes if k.split("_spike")[0].split("_fault")[0] == lanes), None)
        if kind is None:
            print(f"redesigned: edge_draws {label} on {path}: not called", flush=True)
            continue
        m = modes[kind]
        print(f"redesigned: edge_draws {label} on {path} ({kind}): {m['ms']:.4f} ms, one "
              f"launch (bound {m['bound_ms']:.4f} ms, {m['bound_by']}{parent(path, kind)})",
              flush=True)
    for path in ("two_servers_lb", "heavy_inj_single_server", "chaos_campaign"):
        m = fast[path]["timed"]["edge_draws"]["modes"].get("gap_cumsum")
        if m is None:
            print(f"redesigned: edge_draws gap prefix sum on {path}: not called", flush=True)
            continue
        print(f"redesigned: edge_draws gap prefix sum on {path}: {m['ms']:.4f} ms, one launch "
              f"(bound {m['bound_ms']:.4f} ms, {m['bound_by']}; torch.cumsum over the same "
              f"gaps {m['cumsum_ms']:.4f} ms{parent(path, 'gap_cumsum')})", flush=True)
    for entry, res in REDESIGNED_PTXAS.items():
        print(f"redesigned: ptxas {entry}: {res}", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "asyncflow_tpu_torch").is_dir():
        print(f"chip_smoke: no asyncflow_tpu_torch package beside {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        t0 = time.perf_counter()
        phase_setup(torch)
        t1 = time.perf_counter()
        check = phase_kernel_vs_twin(torch)
        t2 = time.perf_counter()
        paths = {name: phase_path(torch, name) for name in PAYLOADS}
        t3 = time.perf_counter()
        fast_check = phase_fast_check(torch)
        t4 = time.perf_counter()
        fast = {name: phase_fast_path(torch, name, paths.get(name)) for name in FAST_PAYLOADS}
        t5 = time.perf_counter()
        gauge = phase_gauge(torch)
        t6 = time.perf_counter()
        planes = phase_planes(torch)
        t7 = time.perf_counter()
    except (SmokeError, subprocess.CalledProcessError) as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    print(f"phase seconds: setup {t1 - t0:.1f}, kernel vs twin {t2 - t1:.1f}, "
          f"paths {t3 - t2:.1f}, fast kernels vs plain {t4 - t3:.1f}, fast paths {t5 - t4:.1f}, "
          f"gauge grid {t6 - t5:.1f}, planes {t7 - t6:.1f}")
    kernels = kernels_report(check, paths, fast_check, fast, gauge, planes)
    redesigned_report(fast)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            },
        ),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
