"""Shared cases of the fast path's observability planes (the flight recorder
and the latency blame grids), held against the jitted JAX ``FastEngine``
with both planes on at once (one reference program a payload).

- :func:`planes_payload`: two generators on the LB, a DB pool of two
  connections and a ready-queue cap of one on srv-1, a binding RAM tier on
  srv-2, dropout on lb-srv1: SPAWN, TRANSIT, ARRIVE_LB / ARRIVE_SRV,
  WAIT_CPU / WAIT_RAM / WAIT_DB, RUN, REJECT (the cap's shed), DROP and
  COMPLETE;
- :func:`retry_payload`: one generator, a client retry policy with a
  0.15 s deadline on a loaded server, srv-1 dark from 0 to 1.5 s: TIMEOUT,
  RETRY, ABANDON, REJECT in the dark window, and the rings of a logical
  request across its attempt blocks.

No fast-path plan reaches FR_HEDGE or FR_CANCEL (hedging runs on the event
engines only) nor FR_PREFILL / FR_DECODE / FR_EVICT (the serving
lifecycle), so neither payload has them.
"""

from __future__ import annotations

import functools

import numpy as np
from torch_fast_cases import BASE, GUIDE_RETRY, LB, load, reference_window_draws, second_stream

#: scenarios, seed and horizon (seconds) of both payloads' runs
N, SEED, HORIZON = 3, 5, 12


def planes_payload() -> dict:
    def mutate(data: dict) -> None:
        second_stream(data)
        srv1, srv2 = data["topology_graph"]["nodes"]["servers"]
        srv1["endpoints"][0]["steps"] = [
            {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.012}},
            {"kind": "io_db", "step_operation": {"io_waiting_time": 0.030}},
        ]
        srv1["server_resources"]["db_connection_pool"] = 2
        srv1["overload"] = {"max_ready_queue": 1}
        srv2["server_resources"]["ram_mb"] = 256
        srv2["endpoints"][0]["steps"][1]["step_operation"]["necessary_ram"] = 200
        for edge in data["topology_graph"]["edges"]:
            if edge["id"] == "lb-srv1":
                edge["dropout_rate"] = 0.05

    return load(LB, mutate, horizon=HORIZON)


def retry_payload() -> dict:
    def mutate(data: dict) -> None:
        srv = data["topology_graph"]["nodes"]["servers"][0]
        srv["endpoints"][0]["steps"][0]["step_operation"]["cpu_time"] = 0.050
        data["retry_policy"] = dict(GUIDE_RETRY, request_timeout_s=0.15)
        data["fault_timeline"] = {"events": [{
            "fault_id": "srv-1-outage", "kind": "server_outage", "target_id": "srv-1",
            "t_start": 0.0, "t_end": 1.5}]}

    return load(BASE, mutate, horizon=HORIZON)


#: each case: (payload, traced requests, ring slots); the retry case's rings
#: are small enough that retried requests overflow them
CASES = {"planes": (planes_payload, 128, 24), "retry": (retry_payload, 48, 10)}


@functools.lru_cache(maxsize=None)
def runs(name: str) -> dict:
    """The case's states: "ref" the jitted JAX FastEngine with both planes
    and collect_clocks; "port" the port's with the same (the reference's
    window draws injected); "off" the port's without the planes; and for
    the planes case "trace" and "blame", the port's with one plane each.
    Memoised a process."""
    import jax

    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
    from asyncflow_tpu.observability.simtrace import TraceConfig as JaxTraceConfig
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.observability import TraceConfig
    from asyncflow_tpu_torch.schemas import SimulationPayload

    build, k, slots = CASES[name]
    data = build()
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    plan = compile_payload(SimulationPayload.from_dict(data))
    keys = jax_keys(SEED, N)
    ref = JaxFastEngine(ref_plan, trace=JaxTraceConfig(sample_requests=k, event_slots=slots),
                        blame=True, collect_clocks=True).run_batch(keys)
    windows = reference_window_draws(ref_plan, keys)
    cfg = TraceConfig(sample_requests=k, event_slots=slots)
    out = {"ref": jax.tree_util.tree_map(np.asarray, ref), "plan": plan, "slots": slots}
    runs_of = [("port", {"trace": cfg, "blame": True}), ("off", {})]
    if name == "planes":
        runs_of += [("trace", {"trace": cfg}), ("blame", {"blame": True})]
    for label, kw in runs_of:
        eng = FastEngine(plan, device="cpu", collect_clocks=True, **kw)
        out[label] = eng.run_batch(np.asarray(keys), window_draws=windows)
    return out


#: the outputs of the planes; every other FastState field is a "non-plane"
#: output
PLANES = ("fr_ev", "fr_node", "fr_t", "fr_n", "bl_grid", "bl_lat", "bl_store")
#: each blame grid cell within this relative tolerance of the reference's:
#: the reference sums a cell's credits in float32 (a few thousand adds in
#: these runs), the port in float64 rounded once
GRID_RTOL = 1e-4
#: pooled conservation of a coarse bin: the grid's cells sum to the bin's
#: latency total (the reference's own gate)
POOLED_RTOL = 1e-3
#: per-request conservation: a completed request's credits sum to its
#: latency within a few float32 ulps of its clock times
ROW_RTOL = 1e-5


def check_rings(ref, got, slots: int) -> None:
    for name in ("fr_ev", "fr_node", "fr_n"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    np.testing.assert_array_equal(got.fr_t.view(np.int32), ref.fr_t.view(np.int32))
    assert got.fr_ev.shape[2] == slots


def check_blame(ref, got) -> None:
    np.testing.assert_array_equal(got.bl_store.view(np.int32), ref.bl_store.view(np.int32))
    for name in ("bl_grid", "bl_lat"):
        want = np.asarray(getattr(ref, name), np.float64)
        have = np.asarray(getattr(got, name), np.float64)
        np.testing.assert_allclose(have, want, rtol=GRID_RTOL, atol=1e-9, err_msg=name)
    grid = np.asarray(got.bl_grid, np.float64).sum(axis=(0, 1))
    lat = np.asarray(got.bl_lat, np.float64).sum(axis=0)
    assert np.all(lat[grid == 0] == 0)
    np.testing.assert_allclose(grid, lat, rtol=POOLED_RTOL)
    # per request: the rows of the completed requests sum to their latency
    n = np.asarray(got.clock_n)
    for s in range(n.shape[0]):
        rows = np.asarray(got.bl_store[s, : n[s]], np.float64).sum(axis=1)
        lat_s = got.clock[s, : n[s], 1].astype(np.float64) - got.clock[s, : n[s], 0]
        np.testing.assert_allclose(rows, lat_s, rtol=ROW_RTOL, atol=1e-9)
