#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``asyncflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. the card's name and power limit, the torch and nvcc versions, the
   build of every CUDA library of the port (one nvcc per library, in
   parallel) with the registers and spills ``ptxas -v`` reports for each
   instance of the DES kernel, and for each path the instance it runs, the
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
4. the scan fast path's two kernels (``edge_draws``, ``station_scan``)
   against their plain PyTorch versions on the card, on two_servers_lb
   and single_server cut to 60 s at 64 scenarios: every kernel call of
   the engine's run repeated through the plain version, bit-exact, and
   the whole engine through each, with identical integer outputs and
   per-request clocks;
5. the two fast paths: ``SweepRunner(payload).run(2048, seed=0)`` through
   ``engine="auto"``, which must take the fast path and launch both
   kernels (counts set to 0 before the run), on two_servers_lb (600 s)
   and single_server (500 s, a binding RAM of 20 slots): request
   conservation, the pooled p95 within 2% of the JAX fast path's and of
   the DES kernel's on the same payload; then the first call of each
   kind (uniform, static hop, LB hop, wait scan, RAM-core scan) of the
   path's own run at full width, repeated through the kernel and through
   its plain version on the same arguments, bit-exact; each kernel's
   timed call between CUDA events beside its bound, its plain version's
   time and the library's (the closed form ``cumsum`` / ``cummax`` for
   the one-core scan), and the stable rank's time.

It prints a JSON line of per-kernel measurements, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It needs a CUDA card and
the repository beside it; it imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
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

#: the scan fast path's two full-width paths: the headline, and
#: examples/yaml_input/data/single_server.yml (a binding RAM of 20 slots)
FAST_PAYLOADS = {
    "two_servers_lb": TWO_SERVERS_LB,
    "single_server": SINGLE_SERVER,
}

MAIN_SCENARIOS = 2048
#: a pool too large for shared memory (des_kernel.cu, layout_of)
POOL_GLOBAL = 2048
#: iteration cap of the kernel-against-twin check on the headline's plan:
#: every scenario truncates after ~10 s of simulated time, which keeps the
#: twin (one batched step per event) near two minutes on the card
CHECK_ITERATIONS = 8000
#: the same for event_inj_lb's and resilience_all's plans (~16 s simulated
#: at ~40 req/s)
PATH_CHECK_ITERATIONS = 4000
#: the same for the three workload paths' plans: db_pool_k2 ~40 s
#: simulated of its 120 s, llm_cost ~25 s of its 60 s (at ~20 req/s),
#: two_gen_lb ~6 s (at ~133 req/s)
WORKLOAD_CHECK_ITERATIONS = {"db_pool_k2": 3000, "llm_cost": 2000, "two_gen_lb": 3000}
#: event_inj_lb's windows, scaled into the capped check's simulated time:
#: they end by 10.8 s
EVENT_CHECK_TIME_SCALE = 0.02
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
#: fast``; seed 1 gave 0.033682255 s and 0.119988049 s)
REFERENCE_FAST = {
    "two_servers_lb": {"p95_s": 0.03368371799103881},
    "single_server": {"p95_s": 0.12000647249175632},
}
#: horizon of the fast kernels' check against their plain versions, and
#: its scenarios
FAST_CHECK_HORIZON = 60
FAST_CHECK_SCENARIOS = 64
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
# from the data sheet; int32 from the SM's 64 int32 lanes a clock (half its
# fp32 lanes) on 132 SMs at the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9

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
        if name in ("edge_draws", "station_scan"):
            res = " ".join(line.split(":", 2)[-1].strip() for line in report.splitlines()
                           if "spill" in line or "registers" in line)
            print(f"  ptxas[{name}]: {res}")
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
            plan_of(RESILIENCE_ALL), max_iterations=PATH_CHECK_ITERATIONS),
        **{
            name: dataclasses.replace(plan_of(PAYLOADS[name]), max_iterations=cap)
            for name, cap in WORKLOAD_CHECK_ITERATIONS.items()
        },
    }
    #: the work each workload path's capped check must show
    path_work = {"db_pool_k2": ("db_waits", "db_grants"), "llm_cost": ("llm_token_draws",)}
    small = {
        "lc_mixed_dists": (plan_of(_lc_mixed_payload()), 256),
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


# (int32, fp32) operations a lane of the fast path's kernels: a jax-style
# threefry block (THREEFRY_OPS' 20 rounds and key injections, the XOR of
# the two words, the mantissa shift and or; the subtract of 1.0); the hop's
# dropout test and rescale (compare, two subtracts, the max, the divide);
# each delay law (exponential: 1 - u, the max, the log, the multiply;
# normal and lognormal: a second block for z, erfinv's log1p, square root
# and 9-term polynomial, the affine map and the max or exp)
UNIFORM_LANE_OPS = (86, 1)
HOP_LANE_OPS = (0, 5)
LAW_LANE_OPS = {0: (0, 0), 2: (0, 4), 3: (86, 26), 4: (86, 26)}
#: station_scan, an element: Lindley's two selects, add, max, two
#: subtracts and max; a Kiefer-Wolfowitz or RAM-slot step adds a compare a
#: carry entry it moves past (not counted: the data decides)
SCAN_ELEMENT_OPS = {"waits": (3, 5), "ram_core": (4, 8)}


def _draws_bound(args: tuple, kw: dict, n: int) -> dict:
    """The least time of one edge_draws hop launch: bytes (the per-lane
    inputs read once, dropped and delay written once) against operations
    (a uniform block and the hop a lane, plus each lane's law)."""
    keys, _zkey, dist, mean, *_ = args
    s = mean.shape[0]
    lanes = s * n
    moved = lanes * (1 + 4)
    for name in ("u", "eidx"):
        if kw.get(name) is not None:
            moved += kw[name].numel() * kw[name].element_size()
    if kw.get("eidx") is not None:
        import torch

        per_law = torch.bincount(torch.as_tensor(dist, device=kw["eidx"].device)[
            kw["eidx"].long()].reshape(-1), minlength=5).tolist()
    else:
        per_law = [0] * 5
        per_law[int(dist[kw["edge"]])] = lanes
    int_ops = lanes * (UNIFORM_LANE_OPS[0] if kw.get("u") is None else 0)
    fp_ops = lanes * (HOP_LANE_OPS[1] + (UNIFORM_LANE_OPS[1] if kw.get("u") is None else 0))
    for law, count in enumerate(per_law):
        if count:
            int_ops += count * LAW_LANE_OPS[law][0]
            fp_ops += count * LAW_LANE_OPS[law][1]
    return _bound_of(moved, int_ops, fp_ops)


def _scan_bound(kind: str, args: tuple) -> dict:
    """The least time of one station_scan launch: each input read once and
    each output written once, against its element operations."""
    tensors = [x for x in args if hasattr(x, "numel")]
    elems = tensors[0].numel()
    outputs = 1 if kind == "waits" else 3
    moved = sum(x.numel() * x.element_size() for x in tensors) + outputs * 4 * elems
    ops = SCAN_ELEMENT_OPS[kind]
    return _bound_of(moved, elems * ops[0], elems * ops[1])


def _bound_of(moved: int, int_ops: int, fp_ops: int) -> dict:
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max(int_ops / PEAK_INT32_OPS_PER_S, fp_ops / PEAK_FP32_OPS_PER_S) * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
    }


#: the kinds of fast-kernel call: (wrapper name, wrapper method)
CALL_KINDS = {
    "uniform": ("edge_draws", "uniform"),
    "hop": ("edge_draws", "hop"),
    "hop_lb": ("edge_draws", "hop"),
    "waits": ("station_scan", "waits"),
    "ram_core": ("station_scan", "ram_core"),
}


def _record_kernel_calls(eng, every: bool) -> list:
    """Put recorders in place of the fast engine's two kernel wrappers; each
    passes the call on and keeps ``(kind, args, kwargs)`` of every call
    (``every``) or of the first call of each kind (the LB hop, a static
    hop, a uniform, a wait scan, a RAM-core scan)."""
    calls: list = []
    draws, scan = eng.draws, eng.scan

    def keep(kind: str, args: tuple, kw: dict) -> None:
        if every or all(k != kind for k, _, _ in calls):
            calls.append((kind, args, kw))

    class Draws:
        def uniform(self, keys, n):
            keep("uniform", (keys, n), {})
            return draws.uniform(keys, n)

        def hop(self, *args, **kw):
            keep("hop_lb" if kw.get("eidx") is not None else "hop", args, kw)
            return draws.hop(*args, **kw)

    class Scan:
        def waits(self, *args):
            keep("waits", args, {})
            return scan.waits(*args)

        def ram_core(self, *args):
            keep("ram_core", args, {})
            return scan.ram_core(*args)

    eng.draws, eng.scan = Draws(), Scan()
    return calls


def _call(wrapper, kind: str, args: tuple, kw: dict):
    """One recorded call through ``wrapper`` (a kernel or a plain version),
    its outputs as a tuple."""
    out = getattr(wrapper, CALL_KINDS[kind][1])(*args, **kw)
    return out if isinstance(out, tuple) else (out,)


def _compare(torch, label: str, got: tuple, want: tuple) -> float:
    """The largest absolute difference between a kernel's outputs and its
    plain version's; raises unless every output is bit-identical."""
    err = 0.0
    for x, y in zip(got, want, strict=True):
        err = max(err, (x.float() - y.float()).abs().max().item())
        if not torch.equal(x, y):
            raise SmokeError(f"{label}: the kernel differs from its plain version by {err}")
    return err


def _fast_engine(torch, data: dict, horizon: float | None = None, **kw):
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.schemas import SimulationPayload

    data = copy.deepcopy(data)
    if horizon is not None:
        data["sim_settings"]["total_simulation_time"] = horizon
    return FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cuda", **kw)


def phase_fast_check(torch) -> dict:
    """Phase 4: the fast path's kernels against their plain versions on the
    card, on each fast payload cut to FAST_CHECK_HORIZON seconds at
    FAST_CHECK_SCENARIOS scenarios: every kernel call of the engine's run
    (all are recorded) repeated through the kernel and through the plain
    version on the same arguments, bit-exact;
    then the whole engine once through the kernels and once through the
    plain versions: every integer output and every completed request's
    (arrival, finish) clock identical."""
    from asyncflow_tpu_torch.engines.torchsim import draws, station_scan
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys

    plain_draws, plain_scan = draws.PlainEdgeDraws(), station_scan.PlainStationScan()
    measured = {"edge_draws": 0.0, "station_scan": 0.0}
    for name, data in FAST_PAYLOADS.items():
        eng = _fast_engine(torch, data, FAST_CHECK_HORIZON, collect_clocks=True)
        keys = scenario_keys(0, FAST_CHECK_SCENARIOS, device="cuda")
        kernel_draws, kernel_scan = eng.draws, eng.scan
        calls = _record_kernel_calls(eng, every=True)
        got = eng.run_tensors(keys)
        eng.draws, eng.scan = kernel_draws, kernel_scan
        if kernel_draws.launches == 0 or kernel_scan.launches == 0:
            raise SmokeError(f"fast check {name}: a kernel was not launched")
        pairs = {"edge_draws": (kernel_draws, plain_draws),
                 "station_scan": (kernel_scan, plain_scan)}
        for i, (kind, args, kw) in enumerate(calls):
            kernel = CALL_KINDS[kind][0]
            wrapper, plain = pairs[kernel]
            err = _compare(torch, f"fast check {name}: call {i} ({kind})",
                           _call(wrapper, kind, args, kw), _call(plain, kind, args, kw))
            measured[kernel] = max(measured[kernel], err)
        want_eng = copy.copy(eng)
        want_eng.draws, want_eng.scan = plain_draws, plain_scan
        want = want_eng.run_tensors(keys)
        for field in ("hist", "thr", "lat_count", "n_generated", "n_dropped", "n_overflow",
                      "clock"):
            if not torch.equal(got[field], want[field]):
                raise SmokeError(f"fast check {name}: {field} differs between the runs")
        err = (got["gauge_means"] - want["gauge_means"]).abs().max().item()
        print(
            f"fast kernels == plain on {name} ({FAST_CHECK_SCENARIOS} x "
            f"{FAST_CHECK_HORIZON} s, {eng.n} lanes): {len(calls)} calls of kinds "
            f"{sorted({kind for kind, _, _ in calls})}; completed "
            f"{int(got['lat_count'].sum())}, generated {int(got['n_generated'].sum())}, "
            f"clocks identical; gauge means differ by {err}",
            flush=True,
        )
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


def phase_fast_path(torch, name: str, des_p95: float | None) -> dict:
    """Phase 5, one path: ``SweepRunner(payload).run(2048, seed=0)`` at the
    payload's full horizon through ``engine="auto"``, which must take the
    fast path and launch both of its kernels; request conservation; the
    pooled p95 within 2% of the JAX fast path's and of the port's DES
    kernel's on the same payload (``des_p95``, or a kernel sweep here);
    then the first call of each kind of the path's own run, at full width,
    through the kernel and through its plain version on the same
    arguments, bit-exact; each kernel's timed call (the LB hop or else a
    static hop; the RAM-core scan or else a wait scan) between CUDA
    events, beside its bound, its plain version's time and the library's;
    and the stable rank's time."""
    import numpy as np

    from asyncflow_tpu_torch.engines.torchsim import draws, station_scan
    from asyncflow_tpu_torch.engines.torchsim.keys import fold_in, scenario_keys
    from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
    from asyncflow_tpu_torch.engines.torchsim.sortutil import time_rank
    from asyncflow_tpu_torch.parallel import SweepRunner

    data = FAST_PAYLOADS[name]
    runner = SweepRunner(data, device="cuda")
    if runner.engine_kind != "fast":
        raise SmokeError(f"fast {name}: auto took the {runner.engine_kind} engine")
    eng = runner.engine
    runner.run(MAIN_SCENARIOS, seed=0)  # warm the allocator and the libraries
    eng.draws.launches = 0
    eng.scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    report = runner.run(MAIN_SCENARIOS, seed=0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"edge_draws": eng.draws.launches, "station_scan": eng.scan.launches}
    if min(launches.values()) < 1:
        raise SmokeError(f"fast {name}: the sweep launched {launches}")
    summary = report.summary()
    res = report.results
    in_flight = (res.total_generated - res.completed - res.total_dropped
                 - res.overflow_dropped - res.total_rejected)
    if np.any(in_flight < 0) or summary["overflow_total"] != 0:
        msg = (f"fast {name}: in flight [{in_flight.min()}, {in_flight.max()}], "
               f"overflow {summary['overflow_total']}")
        raise SmokeError(msg)
    for key in ("latency_p50_s", "latency_p95_s", "latency_p99_s", "latency_mean_s"):
        if not np.isfinite(summary[key]):
            raise SmokeError(f"fast {name}: {key} is not finite")
    p95 = summary["latency_p95_s"]
    des_scen_per_s = None
    if des_p95 is None:
        des = SweepRunner(data, engine="kernel", device="cuda").run(MAIN_SCENARIOS, seed=0)
        des_p95 = des.summary()["latency_p95_s"]
        des_scen_per_s = des.scenarios_per_second
    ref = REFERENCE_FAST[name]["p95_s"]
    rel_ref, rel_des = p95 / ref - 1.0, p95 / des_p95 - 1.0
    if abs(rel_ref) > P95_RTOL or abs(rel_des) > P95_RTOL:
        msg = (f"fast {name}: pooled p95 {p95:.6f} s is {rel_ref:+.2%} from the JAX fast "
               f"path's {ref} and {rel_des:+.2%} from the DES kernel's {des_p95:.6f}")
        raise SmokeError(msg)

    # each kind of call of this path's own run, at full width: the kernel
    # against its plain version, and the timed ones between CUDA events
    keys = scenario_keys(0, MAIN_SCENARIOS, device="cuda")
    wrappers = {"edge_draws": eng.draws, "station_scan": eng.scan}
    plains = {"edge_draws": draws.PlainEdgeDraws(),
              "station_scan": station_scan.PlainStationScan()}
    calls = _record_kernel_calls(eng, every=False)
    eng.run_tensors(keys)
    eng.draws, eng.scan = wrappers["edge_draws"], wrappers["station_scan"]
    kinds = {kind for kind, _, _ in calls}
    timed_kind = {"edge_draws": "hop_lb" if "hop_lb" in kinds else "hop",
                  "station_scan": "ram_core" if "ram_core" in kinds else "waits"}
    max_err = {"edge_draws": 0.0, "station_scan": 0.0}
    timed = {}
    for kind, args, kw in calls:
        kernel = CALL_KINDS[kind][0]
        plain_ms, want = _time_plain(torch, lambda: _call(plains[kernel], kind, args, kw))
        got = _call(wrappers[kernel], kind, args, kw)
        err = _compare(torch, f"fast {name}: {kind} at full width", got, want)
        max_err[kernel] = max(max_err[kernel], err)
        del got, want
        if kind != timed_kind[kernel]:
            continue
        ms = time_kernel(torch, lambda: _call(wrappers[kernel], kind, args, kw), repeats=5)
        library_ms = None
        if kind == "waits" and args[3] == 1:
            library_ms = time_kernel(torch, lambda: _lindley_closed_form(torch, *args[:3]),
                                     repeats=3)
        bound = _draws_bound(args, kw, eng.n) if kernel == "edge_draws" else _scan_bound(
            kind, args)
        timed[kernel] = {"call": kind, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, **bound}
    ov = eng._overrides(base_overrides(eng.plan), MAIN_SCENARIOS)
    _lam, counts = eng.window_draws(keys, ov["um"], ov["rr"])
    t, valid, _ = eng._arrivals(fold_in(keys, 0), counts)
    rank_ms = time_kernel(torch, lambda: time_rank(t, valid), repeats=3)
    print(
        f"fast path {name}: {MAIN_SCENARIOS} scenarios x {eng.plan.horizon:.0f} s, "
        f"{eng.n} lanes, launches {launches}, {report.wall_seconds:.3f} s wall, "
        f"{summary['scenarios_per_second']:.1f} scen/s"
        + ("" if des_scen_per_s is None else f" (DES kernel sweep {des_scen_per_s:.1f} scen/s)")
        + f", peak device memory {peak_gb:.2f} GB; p50 "
        f"{summary['latency_p50_s'] * 1e3:.3f} ms, p95 {p95 * 1e3:.4f} ms ({rel_ref:+.3%} vs "
        f"the JAX fast path {ref * 1e3:.4f} ms, {rel_des:+.3%} vs the DES kernel "
        f"{des_p95 * 1e3:.4f} ms), p99 {summary['latency_p99_s'] * 1e3:.3f} ms; completed "
        f"{summary['completed_total']}, dropped {summary['dropped_total']}",
        flush=True,
    )
    for kernel, m in timed.items():
        lib = "null" if m["library_ms"] is None else f"{m['library_ms']:.3f} ms"
        print(f"  {kernel} ({m['call']}): {m['ms']:.3f} ms, plain {m['plain_ms']:.1f} ms, "
              f"library {lib}, {_bound_text(m)}", flush=True)
    print(f"  stable row rank (torch.sort) of the arrivals: {rank_ms:.3f} ms; calls "
          f"{sorted(kinds)} at full width bit-exact with their plain versions", flush=True)
    return {
        "launches": launches,
        "wall_s": report.wall_seconds,
        "scen_per_s": summary["scenarios_per_second"],
        "p95_s": p95,
        "des_p95_s": des_p95,
        "peak_gb": peak_gb,
        "rank_ms": rank_ms,
        "timed": timed,
        "max_abs_err": max_err,
    }


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
        fast = {
            name: phase_fast_path(torch, name, paths[name]["p95_s"] if name in paths else None)
            for name in FAST_PAYLOADS
        }
        t5 = time.perf_counter()
    except (SmokeError, subprocess.CalledProcessError) as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    from asyncflow_tpu_torch.engines.torchsim.des_kernel import DesKernel
    from asyncflow_tpu_torch.engines.torchsim.draws import EdgeDraws
    from asyncflow_tpu_torch.engines.torchsim.station_scan import StationScan

    print(f"phase seconds: setup {t1 - t0:.1f}, kernel vs twin {t2 - t1:.1f}, "
          f"paths {t3 - t2:.1f}, fast kernels vs plain {t4 - t3:.1f}, fast paths {t5 - t4:.1f}")
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
    headline_fast = fast["two_servers_lb"]["timed"]
    for wrapper in (EdgeDraws, StationScan):
        m = headline_fast[wrapper.name]
        kernels.append({
            "name": wrapper.name,
            "route": wrapper.route,
            "source": wrapper.source,
            "replaces": wrapper.replaces,
            "launches": sum(f["launches"][wrapper.name] for f in fast.values()),
            "max_abs_err": max(fast_check[wrapper.name],
                               *(f["max_abs_err"][wrapper.name] for f in fast.values())),
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "paths": {
                name: {"launches": f["launches"][wrapper.name],
                       **{k: f["timed"][wrapper.name][k] for k in (
                           "call", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
                for name, f in fast.items()
            },
        })
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
