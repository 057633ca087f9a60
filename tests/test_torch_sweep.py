"""The port's SweepRunner against the JAX reference's, and the port's
import hygiene.

Run as a script from the repository root (``PYTHONPATH=. python
tests/test_torch_sweep.py --reference-p95 [PAYLOAD] [--seed N]
[--scenarios N] [--engine kernel|fast]``) it measures the pooled
percentiles, the rejected fraction and the mean LLM cost per completed
request of the JAX reference kernel on one of ``chip_smoke.py``'s
payloads at its full horizon (``PallasEngine(interpret=True)`` on the CPU;
32 scenarios of seed 0 by default), or with ``--engine fast`` the pooled
percentiles of the JAX scan fast path (``FastEngine``) on one of
``chip_smoke.FAST_PAYLOADS``: the constants ``chip_smoke.py`` holds the
port's full-width sweeps to.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
from asyncflow_tpu_torch.errors import NoDeviceError, ProofHeadroomError
from asyncflow_tpu_torch.parallel import SweepRunner

one_torch_thread()

ROOT = Path(__file__).resolve().parents[1]
TOL = 0.08  # pooled-ensemble tolerance, as tests/parity/test_pallas_engine.py


def _payload(horizon: float = 10.0) -> dict:
    """The reference parity suite's single-server scenario (~7.5 rps)."""
    exp = {"mean": 0.003, "distribution": "exponential"}
    return {
        "rqs_input": {
            "id": "g",
            "avg_active_users": {"mean": 15},
            "avg_request_per_minute_per_user": {"mean": 30},
            "user_sampling_window": 4,
        },
        "topology_graph": {
            "nodes": {
                "client": {"id": "c"},
                "servers": [{
                    "id": "s1",
                    "server_resources": {"cpu_cores": 1, "ram_mb": 1024},
                    "endpoints": [{
                        "endpoint_name": "ep",
                        "steps": [
                            {"kind": "initial_parsing",
                             "step_operation": {"cpu_time": 0.004}},
                            {"kind": "ram", "step_operation": {"necessary_ram": 64}},
                            {"kind": "io_wait",
                             "step_operation": {"io_waiting_time": 0.02}},
                        ],
                    }],
                }],
            },
            "edges": [
                {"id": "g-c", "source": "g", "target": "c", "latency": exp,
                 "dropout_rate": 0.01},
                {"id": "c-s", "source": "c", "target": "s1", "latency": exp},
                {"id": "s-c", "source": "s1", "target": "c", "latency": exp},
            ],
        },
        "sim_settings": {"total_simulation_time": horizon, "sample_period_s": 0.01},
    }


def test_chunked_equals_unchunked() -> None:
    runner = SweepRunner(_payload(5.0), engine="kernel", device="cpu")
    whole = runner.run(7, seed=3).results
    chunked = runner.run(7, seed=3, chunk_size=3).results
    tail = runner.run(4, seed=3, first_scenario=3).results
    for field in ("completed", "latency_hist", "latency_sum", "latency_sumsq",
                  "latency_min", "latency_max", "throughput", "total_generated",
                  "total_dropped", "overflow_dropped", "truncated", "events"):
        np.testing.assert_array_equal(getattr(whole, field), getattr(chunked, field))
        np.testing.assert_array_equal(getattr(whole, field)[3:], getattr(tail, field))


@pytest.fixture(scope="module")
def both_sweeps():
    from asyncflow_tpu.parallel.sweep import SweepRunner as JaxSweepRunner
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    data = _payload()
    ref = JaxSweepRunner(
        JaxPayload.model_validate(data), engine="pallas", use_mesh=False, preflight="off",
    ).run(48, seed=0)
    port = SweepRunner(data, engine="kernel", device="cpu").run(48, seed=0)
    return ref, port


def test_summary_keys_are_reference_keys(both_sweeps) -> None:
    ref, port = both_sweeps
    keys = set(port.summary())
    assert keys <= set(ref.summary())
    assert {"latency_p50_s", "latency_p95_s", "latency_p99_s", "latency_mean_s",
            "scenarios_per_second", "completed_total", "dropped_total",
            "overflow_total", "truncated_total"} <= keys


def test_pooled_statistics_match_reference(both_sweeps) -> None:
    ref, port = both_sweeps
    a, b = ref.summary(), port.summary()
    assert b["truncated_total"] == 0
    assert b["overflow_total"] == 0
    assert abs(b["completed_total"] / a["completed_total"] - 1.0) < TOL
    assert abs(b["latency_mean_s"] / a["latency_mean_s"] - 1.0) < TOL
    assert abs(b["latency_p95_s"] / a["latency_p95_s"] - 1.0) < TOL


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_path_literals_equal_their_sources() -> None:
    """EVENT_INJ_LB is the YAML; RESILIENCE_ALL is the resilience example's
    ``build_payload("all")`` with the YAML's own 600 s horizon."""
    import copy
    import importlib.util

    import yaml

    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    smoke = _smoke()
    data = ROOT / "examples" / "yaml_input" / "data" / "event_inj_lb.yml"
    assert smoke.EVENT_INJ_LB == yaml.safe_load(data.read_text())
    spec = importlib.util.spec_from_file_location(
        "resilience_controls", ROOT / "examples" / "sweeps" / "resilience_controls.py",
    )
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert smoke.RESILIENCE_ALL["sim_settings"]["total_simulation_time"] == 600
    cut = copy.deepcopy(smoke.RESILIENCE_ALL)
    cut["sim_settings"]["total_simulation_time"] = example.HORIZON_S
    assert JaxPayload.model_validate(cut) == example.build_payload("all")


def _lowered_cap_payload() -> dict:
    """A ready-queue cap far above the load: lowered away, with a finite
    rate headroom (about 8.4x)."""
    data = _payload(5.0)
    data["topology_graph"]["nodes"]["servers"][0]["overload"] = {"max_ready_queue": 50}
    return data


def test_rate_headroom_guard() -> None:
    runner = SweepRunner(_lowered_cap_payload(), engine="kernel", device="cpu")
    headroom = runner.plan.proof_rate_headroom
    assert 2.0 < headroom < 10.0
    base = base_overrides(runner.plan)
    inside = base._replace(user_mean=np.full(2, 2.0 * base.user_mean, np.float32))
    assert runner.run(2, seed=0, overrides=inside).summary()["completed_total"] > 0
    past = base._replace(user_mean=np.full(2, 10.0 * base.user_mean, np.float32))
    with pytest.raises(ProofHeadroomError, match="headroom"):
        runner.run(2, seed=0, overrides=past)


def test_conservation_counts_rejections() -> None:
    """generated = completed + dropped + overflow + rejected + in flight,
    per scenario, with the rate limit refusing most of the load."""
    data = _payload(5.0)
    data["topology_graph"]["nodes"]["servers"][0]["overload"] = {
        "rate_limit_rps": 3.0, "rate_limit_burst": 3,
    }
    runner = SweepRunner(data, device="cpu")
    res = runner.run(6, seed=1).results
    in_flight = (res.total_generated - res.completed - res.total_dropped
                 - res.overflow_dropped - res.total_rejected)
    assert res.total_rejected.min() > 0
    assert (in_flight >= 0).all()
    assert (in_flight <= runner.plan.pool_size).all()


def test_no_device_and_no_gpu_raises() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(NoDeviceError):
        SweepRunner(_payload())


def test_unknown_engine_is_refused() -> None:
    with pytest.raises(ValueError, match="engine"):
        SweepRunner(_payload(), engine="event", device="cpu")


_PROBE = textwrap.dedent(
    """
    import importlib, importlib.util, json, pkgutil, sys
    sys.path.insert(0, {root!r})
    import asyncflow_tpu_torch
    from asyncflow_tpu_torch.parallel import SweepRunner
    payload = {payload}
    SweepRunner(payload, device="cpu").run(2, seed=0)
    sweep_path = sorted(m for m in ("pydantic", "yaml") if m in sys.modules)
    names = [m.name for m in pkgutil.walk_packages(
        asyncflow_tpu_torch.__path__, "asyncflow_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    banned = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "asyncflow_tpu" or m.startswith("asyncflow_tpu."))
    print(json.dumps({{"modules": names, "banned": banned, "sweep_path": sweep_path}}))
    """,
)


@pytest.fixture(scope="module")
def import_probe() -> dict:
    code = _PROBE.format(
        root=str(ROOT), payload=repr(_payload(5.0)), smoke=str(ROOT / "chip_smoke.py"),
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        check=True, cwd=ROOT,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(import_probe) -> None:
    for module in ("des_kernel", "fastpath", "draws", "station_scan", "sortutil"):
        assert f"asyncflow_tpu_torch.engines.torchsim.{module}" in import_probe["modules"]
    assert len(import_probe["modules"]) >= 20
    assert import_probe["banned"] == []


def test_sweep_path_needs_no_pydantic_or_yaml(import_probe) -> None:
    assert import_probe["sweep_path"] == []


def _reference_p95(name: str, seed: int, n: int) -> None:
    """Pooled p50 / p95 / p99, the rejected fraction and, on a plan with LLM
    calls, the mean LLM cost per completed request of the JAX reference
    kernel on a ``chip_smoke`` payload at its full horizon."""
    import importlib.util
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")

    from asyncflow_tpu.compiler import compile_payload
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys
    from asyncflow_tpu.engines.jaxsim.pallas_engine import PallasEngine
    from asyncflow_tpu.engines.jaxsim.params import hist_edges
    from asyncflow_tpu.engines.results import hist_percentile
    from asyncflow_tpu.schemas.payload import SimulationPayload

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = smoke.PAYLOADS[name]
    plan = compile_payload(SimulationPayload.model_validate(data))
    state = PallasEngine(plan, block=n, interpret=True).run_batch(scenario_keys(seed, n))
    pooled = state.hist.sum(axis=0)
    print(f"{name}: seed {seed}, scenarios 0..{n - 1}, pool {plan.pool_size}")
    for q in (50, 95, 99):
        print(f"p{q} {float(hist_percentile(pooled, hist_edges(1024), q))!r}")
    rejected = int(state.n_rejected.sum()) / max(int(state.n_generated.sum()), 1)
    print(f"rejected_fraction {rejected!r}")
    if plan.has_llm:
        cost = float(state.llm_sum.sum()) / max(int(state.lat_count.sum()), 1)
        print(f"llm_cost_mean_per_request {cost!r}")
    print(f"truncated {int(state.truncated.sum())} overflow {int(state.n_overflow.sum())}")


def _reference_fast_p95(name: str, seed: int, n: int) -> None:
    """Pooled p50 / p95 / p99 of the JAX scan fast path on a
    ``chip_smoke.FAST_PAYLOADS`` payload at its full horizon: a plain plan
    through ``FastEngine``, a resilience or an overload and routing plan
    (``chip_smoke.CONTROL_PATHS``) through the reference's
    ``SweepRunner(engine="fast")`` (which samples a chaos campaign's tables)
    with the path's ``chip_smoke.FAST_SWEEP_AXES``, in chunks of 256, and
    its resilience totals and rejected fraction."""
    import importlib.util
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")

    from asyncflow_tpu.compiler import compile_payload
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys
    from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine
    from asyncflow_tpu.engines.jaxsim.params import hist_edges
    from asyncflow_tpu.engines.results import hist_percentile
    from asyncflow_tpu.schemas.payload import SimulationPayload

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    plan = compile_payload(SimulationPayload.model_validate(smoke.FAST_PAYLOADS[name]))
    if name in smoke.RESILIENCE_PATHS or name in smoke.CONTROL_PATHS:
        from asyncflow_tpu.parallel.sweep import SweepRunner as JaxSweepRunner
        from asyncflow_tpu.parallel.sweep import make_overrides

        axes = smoke.FAST_SWEEP_AXES.get(name)
        runner = JaxSweepRunner(SimulationPayload.model_validate(smoke.FAST_PAYLOADS[name]),
                                engine="fast", use_mesh=False)
        report = runner.run(n, seed=seed, chunk_size=256,
                            overrides=make_overrides(plan, n, **axes(n)) if axes else None)
        summary = report.summary()
        print(f"{name}: fast path sweep, seed {seed}, scenarios 0..{n - 1}")
        for key in ("latency_p50_s", "latency_p95_s", "latency_p99_s", "completed_total",
                    "dropped_total", "rejected_total", "dark_lost_total", "timed_out_total",
                    "retries_total", "retry_budget_exhausted_total", "availability_fraction",
                    "unavailable_s_total", "hazard_truncated_total"):
            print(f"{key} {summary.get(key)!r}")
        res = report.results
        print(f"rejected_fraction "
              f"{int(res.total_rejected.sum()) / max(int(res.total_generated.sum()), 1)!r}")
        return
    state = FastEngine(plan).run_batch(scenario_keys(seed, n))
    pooled = np.asarray(state.hist).sum(axis=0)
    print(f"{name}: fast path, seed {seed}, scenarios 0..{n - 1}, lanes {plan.max_requests}")
    for q in (50, 95, 99):
        print(f"p{q} {float(hist_percentile(pooled, hist_edges(1024), q))!r}")
    print(f"completed {int(np.sum(state.lat_count))} generated "
          f"{int(np.sum(state.n_generated))} overflow {int(np.sum(state.n_overflow))}")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="JAX reference kernel statistics for a chip_smoke payload",
    )
    parser.add_argument("--reference-p95", nargs="?", const="two_servers_lb",
                        metavar="PAYLOAD", required=True,
                        help="a key of chip_smoke.PAYLOADS, or of chip_smoke.FAST_PAYLOADS "
                             "with --engine fast (default two_servers_lb)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scenarios", type=int, default=32)
    parser.add_argument("--engine", choices=("kernel", "fast"), default="kernel",
                        help="the JAX Pallas kernel (default) or the JAX scan fast path")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.engine == "fast":
        _reference_fast_p95(args.reference_p95, args.seed, args.scenarios)
    else:
        _reference_p95(args.reference_p95, args.seed, args.scenarios)
