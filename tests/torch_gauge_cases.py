"""The gauge grid's CPU checks' shared cases: the payloads whose grids are
held to the JAX FastEngine's, each reference program run once a process
(memoised by payload and mode), and the reports built from them.  The
checks are split by payload over ``tests/test_torch_gauges*.py``, so that
their reference programs compile on several workers.
"""

from __future__ import annotations

import numpy as np
from torch_fast_cases import (
    example,
    inject_reference_draws,
    mutated,
    reference_window_draws,
    scaled_events,
)

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
from asyncflow_tpu_torch.parallel import SweepRunner
from asyncflow_tpu_torch.schemas import SimulationPayload


def loaded_lb() -> dict:
    """The headline's LB payload at 20 s, loaded so that the ready queues
    build and its RAM tier binds: 240 users, 20 ms of CPU a request."""
    data = example("two_servers_lb", horizon=20)
    data["rqs_input"]["avg_active_users"]["mean"] = 240
    for srv in data["topology_graph"]["nodes"]["servers"]:
        srv["endpoints"][0]["steps"][0]["step_operation"]["cpu_time"] = 0.02
    return data


#: the payloads whose grids are held to the reference's: one server, an LB
#: under outages and spikes (scaled into 30 s), a loaded LB whose RAM tier
#: binds, a ready-queue cap, a retry plan (only the last pass records) and,
#: fine grid only, a connection cap (its shed and abandoned RAM)
GRID_PAYLOADS = {
    "single_server": lambda: example("single_server", horizon=20),
    "event_inj_lb": lambda: scaled_events(example("event_inj_lb"), 30),
    "ram_bound_lb": loaded_lb,
    "overload_cap8": lambda: mutated("overload_cap8", horizon=20),
    "outage_retry": lambda: mutated("outage_retry", horizon=30),
    "overload_sockets": lambda: mutated("overload_sockets", horizon=20),
}


def grid_cases(*names: str) -> list:
    """The (payload, mode) cases of ``names``."""
    return [(name, mode) for name in names for mode in ("fine", "stride")
            if (name, mode) != ("overload_sockets", "stride")]


#: the coarse grid's stride in sample periods (1 s at their 0.05 s)
STRIDE = 20
SEED, N = 4, 6
SERIES = ("ready_queue_len", ["srv-1", "srv-2"], 1.0)

#: (payload, mode) -> (reference plan, reference engine, its state): each
#: reference program compiles once a file
_REFERENCE: dict = {}
#: payload -> the port's run without a grid, on the reference's draws
_WITHOUT_GRID: dict = {}


def plans(data: dict):
    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    return (jax_compile(JaxPayload.model_validate(data)),
            compile_payload(SimulationPayload.from_dict(data)))


def option(mode: str) -> dict:
    return {"collect_gauges": True} if mode == "fine" else {"gauge_series_stride": STRIDE}


def reference(name: str, mode: str, data: dict | None = None, overrides=None) -> tuple:
    """The JAX FastEngine's run of scenarios 0 .. N-1 of SEED on a
    payload of GRID_PAYLOADS (or ``data``), memoised."""
    import jax

    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine

    if (name, mode) not in _REFERENCE:
        ref_plan, _ = plans(data if data is not None else GRID_PAYLOADS[name]())
        eng = JaxFastEngine(ref_plan, **option(mode))
        jov = overrides(ref_plan) if overrides is not None else None
        state = jax.tree_util.tree_map(np.asarray, eng.run_batch(jax_keys(SEED, N), jov))
        _REFERENCE[name, mode] = (ref_plan, eng, state)
    return _REFERENCE[name, mode]


def check_grid(name: str, mode: str) -> None:
    """``collect_gauges`` (n_samples + 2 rows) and ``gauge_series_stride``
    (n_samples // k + 2 rows) grids equal the JAX FastEngine's, bit for
    bit; the same run without a grid gives every other output unchanged."""
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys

    ref_plan, _, ref = reference(name, mode)
    plan = compile_payload(SimulationPayload.from_dict(GRID_PAYLOADS[name]()))
    keys = np.asarray(jax_keys(SEED, N))
    windows = reference_window_draws(ref_plan, keys)
    eng = FastEngine(plan, device="cpu", **option(mode))
    got = eng.run_batch(keys, window_draws=windows)
    rows = plan.n_samples + 2 if mode == "fine" else plan.n_samples // STRIDE + 2
    assert got.gauge.shape == ref.gauge.shape == (N, rows, plan.n_gauges)
    assert np.array_equal(got.gauge, ref.gauge), name
    assert np.abs(got.gauge).sum() > 0
    assert eng.gauge_series_stride == (0 if mode == "fine" else STRIDE)
    if name not in _WITHOUT_GRID:
        _WITHOUT_GRID[name] = FastEngine(plan, device="cpu").run_batch(keys,
                                                                        window_draws=windows)
    off = _WITHOUT_GRID[name]
    assert off.gauge.shape == (N, 1, 1)
    for field in off._fields:
        if field != "gauge":
            assert np.array_equal(getattr(got, field), getattr(off, field)), (name, field)


def reference_report(name: str, spec: tuple, data: dict | None = None, overrides=None,
                     port_overrides=None):
    """The reference's SweepReport of its FastEngine's stride run (its own
    ``sweep_results``: the series' columns, cumulative sum and band
    histograms) and the port's SweepRunner report of the same scenarios on
    the reference's window draws; ``overrides`` and ``port_overrides`` map
    each package's plan to its overrides."""
    from asyncflow_tpu.engines.jaxsim.engine import sweep_results as jax_results
    from asyncflow_tpu.parallel.sweep import SweepReport as JaxReport
    from asyncflow_tpu.parallel.sweep import _resolve_gauge_series as jax_resolve

    ref_plan, eng, state = reference(name, "stride", data, overrides)
    sel, stride, ids = jax_resolve(ref_plan, spec)
    assert stride == STRIDE
    results = jax_results(eng, state, None, gauge_sel=sel)
    ref = JaxReport(results, N, 1.0, ref_plan, gauge_series_ids=ids)
    runner = SweepRunner(data if data is not None else GRID_PAYLOADS[name](), engine="fast",
                         device="cpu", gauge_series=spec)
    inject_reference_draws(runner, ref_plan)
    port_ov = port_overrides(runner.plan) if port_overrides is not None else None
    return ref, runner.run(N, seed=SEED, chunk_size=4, overrides=port_ov)
