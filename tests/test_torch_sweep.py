"""The port's SweepRunner against the JAX reference's, and the port's
import hygiene.

Run as a script (``python tests/test_torch_sweep.py --reference-p95``) it
measures the pooled p95 of the JAX reference kernel on two_servers_lb at its
full 600 s (32 scenarios of seed 0, ``PallasEngine(interpret=True)`` on the
CPU): the constant ``chip_smoke.py`` holds the port's main path to.
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

from asyncflow_tpu_torch.errors import NoDeviceError
from asyncflow_tpu_torch.parallel import SweepRunner

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
    runner = SweepRunner(_payload(5.0), device="cpu")
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


def test_no_device_and_no_gpu_raises() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(NoDeviceError):
        SweepRunner(_payload())


def test_unknown_engine_is_refused() -> None:
    with pytest.raises(ValueError, match="engine"):
        SweepRunner(_payload(), engine="fast", device="cpu")


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
    assert "asyncflow_tpu_torch.engines.torchsim.des_kernel" in import_probe["modules"]
    assert len(import_probe["modules"]) >= 20
    assert import_probe["banned"] == []


def test_sweep_path_needs_no_pydantic_or_yaml(import_probe) -> None:
    assert import_probe["sweep_path"] == []


def _reference_p95() -> None:
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import yaml

    from asyncflow_tpu.compiler import compile_payload
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys
    from asyncflow_tpu.engines.jaxsim.pallas_engine import PallasEngine
    from asyncflow_tpu.engines.jaxsim.params import hist_edges
    from asyncflow_tpu.engines.results import hist_percentile
    from asyncflow_tpu.schemas.payload import SimulationPayload

    data = yaml.safe_load(
        (ROOT / "examples" / "yaml_input" / "data" / "two_servers_lb.yml").read_text(),
    )
    plan = compile_payload(SimulationPayload.model_validate(data))
    state = PallasEngine(plan, block=32, interpret=True).run_batch(scenario_keys(0, 32))
    pooled = state.hist.sum(axis=0)
    for q in (50, 95, 99):
        print(f"p{q} {float(hist_percentile(pooled, hist_edges(1024), q))!r}")
    print(f"truncated {int(state.truncated.sum())} overflow {int(state.n_overflow.sum())}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--reference-p95"]:
        sys.path.insert(0, str(ROOT))
        _reference_p95()
    else:
        sys.exit("usage: python tests/test_torch_sweep.py --reference-p95")
