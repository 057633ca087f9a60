#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``asyncflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. the card's name and power limit, the torch and nvcc versions, and the
   build of every CUDA source of the port (one nvcc per source, in parallel);
2. the DES kernel against its plain PyTorch twin on the card, on the same
   keys and the same arrival-rate table, for three plans: the main path's
   own (two_servers_lb at 600 s, 2048 scenarios, pool 128) with its
   iteration cap lowered so that every scenario truncates; and at 5 s,
   least-connection routing over normal, lognormal, uniform and Poisson
   edges with dropout, and a plan whose RAM binds, with the pool cut so
   that overflow fires.  Integer outputs must be bit-exact, float moments
   within rtol 1e-6;
3. the main path: ``SweepRunner(two_servers_lb).run(2048, seed=0)`` at the
   scenario's full 600 s, through the kernel (its launch count must move),
   with no truncation and no overflow, request conservation per scenario,
   and the pooled p95 within 2% of the JAX reference kernel's.

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

MAIN_SCENARIOS = 2048
#: iteration cap of the kernel-against-twin check on the main path's plan:
#: every scenario truncates after ~10 s of simulated time, which keeps the
#: twin (one batched step per event) near two minutes on the card
CHECK_ITERATIONS = 8000
#: pooled p95 (seconds) of the JAX reference kernel on this payload:
#: PallasEngine(interpret=True) on scenarios 0..31 of seed 0 at 600 s, on
#: the CPU (``python tests/test_torch_sweep.py --reference-p95``)
REFERENCE_P95_S = 0.03367207812033652
P95_RTOL = 0.02
MOMENT_RTOL = 1e-6

# NVIDIA H100 SXM peaks: HBM3 bandwidth and fp32 outside the tensor cores
# from the data sheet; int32 from the SM's 64 int32 lanes a clock (half its
# fp32 lanes) on 132 SMs at the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9

# (int32, fp32) operations, counted from csrc/des_kernel.cu
#: threefry2x32: key word 2 (2 xor), 2 input adds, 20 rounds of add, rotate
#: and xor, 5 key injections of 3 adds; the counter word (shift, add); u24
#: on both words (2 shifts; 2 converts and 2 multiplies)
THREEFRY_OPS = (83, 4)
#: pool_min, per slot: a float compare and two selects
ARGMIN_SLOT_OPS = (2, 1)
#: the event loop itself: fminf and the horizon test; two counters, the
#: cap test and the branch switch
EVENT_OPS = (4, 2)


def operation_count(tables, out) -> tuple[int, int]:
    """(int32, fp32) operations of one run, from its own outputs.

    Every event pays the loop and the pool argmin.  Threefry blocks are
    counted per event kind: each spawn draws its arrival gap and its first
    entry edge, and each completed request also drew its other entry edges,
    the LB edge (where the plan has an LB), the endpoint pick and the exit
    edge.  This is a lower count: the draws of requests that were dropped,
    overflowed or are still in flight past those, window crossings of the
    arrival sampler, second blocks of normal draws and Poisson loops are
    left out, as are the branches' float work (a libm call would count as
    one) and the first-free-slot scan.
    """
    events = int(out.n_events.sum().item())
    completed, generated = (int(x) for x in out.momi[:, :2].sum(dim=0).tolist())
    per_completed = (tables.entry_edges.numel() - 1) + (tables.n_lb > 0) + 2
    blocks = 2 * generated + out.n_events.numel() + per_completed * completed
    int_ops, fp_ops = (
        events * (EVENT_OPS[k] + tables.pool * ARGMIN_SLOT_OPS[k]) + blocks * THREEFRY_OPS[k]
        for k in (0, 1)
    )
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
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")


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


def _ram_bound_payload() -> dict:
    """One server whose RAM admits two requests at a time under ~90% load."""
    data = copy.deepcopy(TWO_SERVERS_LB)
    data["sim_settings"]["total_simulation_time"] = 5
    data["rqs_input"]["avg_active_users"] = {"mean": 60}
    nodes = data["topology_graph"]["nodes"]
    del nodes["load_balancer"]
    srv = nodes["servers"][0]
    srv["server_resources"] = {"cpu_cores": 1, "ram_mb": 256}
    srv["endpoints"][0]["steps"][2]["step_operation"] = {"io_waiting_time": 0.09}
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


def _time_kernel(torch, fn, repeats: int) -> float:
    """Median milliseconds of ``fn()`` between CUDA events."""
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


def phase_kernel_vs_twin(torch) -> dict:
    """Phase 2: the kernel against its twin on the card, three plans.

    The first is the main path's own plan (two_servers_lb at 600 s, pool
    128, 11 λ-windows, 600 throughput bins) at the main path's 2048
    scenarios, with only its iteration cap lowered, so every tensor has the
    main path's shape and the truncation path is checked too."""
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.des_reference import des_reference
    from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.schemas import SimulationPayload

    main_plan = compile_payload(SimulationPayload.from_dict(TWO_SERVERS_LB))
    cases = (
        ("two_servers_lb_600s_capped",
         dataclasses.replace(main_plan, max_iterations=CHECK_ITERATIONS), MAIN_SCENARIOS),
        ("lc_mixed_dists",
         compile_payload(SimulationPayload.from_dict(_lc_mixed_payload())), 256),
        ("ram_bound_overflow",
         compile_payload(SimulationPayload.from_dict(_ram_bound_payload()), pool_size=4), 256),
    )
    measured: dict = {"max_abs_err": 0.0}
    for name, plan, n in cases:
        eng = KernelEngine(plan, device="cuda")
        args = eng.prepare(scenario_keys(0, n, device="cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twin = des_reference(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = eng.kernel(*args)
        torch.cuda.synchronize()
        for field in ("hist", "thr", "momi", "trunc", "n_events"):
            a, b = getattr(got, field), getattr(twin, field)
            if not torch.equal(a, b):
                bad = (a != b).reshape(a.shape[0], -1).any(dim=1).nonzero()[:5, 0].tolist()
                msg = f"{name}: kernel and twin differ in {field} (scenarios {bad})"
                raise SmokeError(msg)
        err = (got.momf - twin.momf).abs()
        if not torch.allclose(got.momf, twin.momf, rtol=MOMENT_RTOL, atol=0.0):
            msg = f"{name}: float moments differ by up to {err.max().item()}"
            raise SmokeError(msg)
        measured["max_abs_err"] = max(measured["max_abs_err"], err.max().item())
        momi = got.momi.sum(dim=0).tolist()
        events = int(got.n_events.sum().item())
        truncated = int(got.trunc.sum().item())
        print(
            f"kernel == twin on {name}: {n} scenarios, pool {plan.pool_size}, "
            f"{events} events, completed {momi[0]}, generated {momi[1]}, "
            f"dropped {momi[2]}, overflow {momi[3]}, truncated {truncated}; "
            f"twin {plain_ms:.0f} ms",
        )
        if name == "ram_bound_overflow" and momi[3] == 0:
            msg = "the RAM-bound case did not overflow its pool"
            raise SmokeError(msg)
        if name == "two_servers_lb_600s_capped":
            if truncated != n:
                msg = f"{name}: {n - truncated} scenarios ended before the cap"
                raise SmokeError(msg)
            ms = _time_kernel(torch, lambda: eng.kernel(*args), repeats=3)
            bound = _bound_ms(args, got)
            measured.update(ms=ms, plain_ms=plain_ms, **bound)
            print(f"  kernel {ms:.2f} ms, twin {plain_ms:.0f} ms, {_bound_text(bound)}")
    return measured


def phase_main_path(torch) -> dict:
    """Phase 3: the full-width sweep through SweepRunner."""
    import numpy as np

    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.parallel import SweepRunner

    runner = SweepRunner(TWO_SERVERS_LB, device="cuda")
    kernel = runner.engine.kernel
    kernel.launches = 0
    report = runner.run(MAIN_SCENARIOS, seed=0)
    launches = kernel.launches
    if launches < 1:
        msg = "the main path did not launch the DES kernel"
        raise SmokeError(msg)
    summary = report.summary()
    res = report.results
    if summary["truncated_total"] != 0 or summary["overflow_total"] != 0:
        msg = (
            f"truncated {summary['truncated_total']}, "
            f"overflow {summary['overflow_total']}"
        )
        raise SmokeError(msg)
    in_flight = (
        res.total_generated - res.completed - res.total_dropped - res.overflow_dropped
    )
    if np.any(in_flight < 0) or np.any(in_flight > runner.plan.pool_size):
        msg = f"conservation broken: in-flight range [{in_flight.min()}, {in_flight.max()}]"
        raise SmokeError(msg)
    for key in ("latency_p50_s", "latency_p95_s", "latency_p99_s", "latency_mean_s"):
        if not np.isfinite(summary[key]):
            raise SmokeError(f"{key} is not finite")
    p95 = summary["latency_p95_s"]
    rel = p95 / REFERENCE_P95_S - 1.0
    if abs(rel) > P95_RTOL:
        msg = f"pooled p95 {p95:.6f} s is {rel:+.2%} from the reference {REFERENCE_P95_S}"
        raise SmokeError(msg)
    events = int(res.events.sum())

    # the kernel alone on the same inputs, between CUDA events
    args = runner.engine.prepare(scenario_keys(0, MAIN_SCENARIOS, device="cuda"))
    out = []
    kernel_ms = _time_kernel(
        torch, lambda: out.append(runner.engine.kernel(*args)), repeats=1,
    )
    bound = _bound_ms(args, out[0])
    print(
        f"main path: {MAIN_SCENARIOS} scenarios x {runner.plan.horizon:.0f} s, "
        f"{launches} launch(es), {report.wall_seconds:.2f} s wall, "
        f"{summary['scenarios_per_second']:.1f} scen/s, kernel {kernel_ms:.1f} ms, "
        f"{events} events ({events / (kernel_ms / 1e3):.3e} events/s), "
        f"{_bound_text(bound)}",
    )
    print(
        f"  p50 {summary['latency_p50_s'] * 1e3:.3f} ms, p95 {p95 * 1e3:.3f} ms "
        f"({rel:+.3%} vs the reference {REFERENCE_P95_S * 1e3:.3f} ms), "
        f"p99 {summary['latency_p99_s'] * 1e3:.3f} ms, mean "
        f"{summary['latency_mean_s'] * 1e3:.3f} ms; "
        f"completed {summary['completed_total']}, "
        f"dropped {summary['dropped_total']}",
    )
    return {
        "launches": launches,
        "main_ms": kernel_ms,
        "main_bound_ms": bound["bound_ms"],
        "main_bound_by": bound["bound_by"],
        "main_events": events,
        "main_wall_s": report.wall_seconds,
        "scen_per_s": summary["scenarios_per_second"],
        "p95_s": p95,
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
        phase_setup(torch)
        check = phase_kernel_vs_twin(torch)
        main_path = phase_main_path(torch)
    except (SmokeError, subprocess.CalledProcessError) as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    from asyncflow_tpu_torch.engines.torchsim.des_kernel import DesKernel

    kernels = [
        {
            "name": DesKernel.name,
            "route": DesKernel.route,
            "source": DesKernel.source,
            "replaces": DesKernel.replaces,
            "launches": main_path["launches"],
            "max_abs_err": check["max_abs_err"],
            "ms": check["ms"],
            "plain_ms": check["plain_ms"],
            "bound_ms": check["bound_ms"],
            "bound_by": check["bound_by"],
            "library_ms": None,
            "main_ms": main_path["main_ms"],
            "main_bound_ms": main_path["main_bound_ms"],
            "main_bound_by": main_path["main_bound_by"],
            "main_events": main_path["main_events"],
        },
    ]
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
