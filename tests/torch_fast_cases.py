"""Payloads and reference draws shared by the fast path's port tests
(``tests/test_torch_fast_*.py``).  The mutations copy those of the
reference's ``tests/parity/test_fastpath_parity.py`` (copied, not
imported, so that the reference's suite stays as it is)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

ROOT = Path(__file__).resolve().parents[1]
BASE = ROOT / "tests" / "integration" / "data" / "single_server.yml"
LB = ROOT / "tests" / "integration" / "data" / "two_servers_lb.yml"
EXAMPLES = ROOT / "examples" / "yaml_input" / "data"


def load(path: Path, mutate=None, *, horizon: float | None = None) -> dict:
    data = yaml.safe_load(path.read_text())
    if mutate:
        mutate(data)
    if horizon is not None:
        data["sim_settings"]["total_simulation_time"] = horizon
    return data


def _server(data) -> dict:
    return data["topology_graph"]["nodes"]["servers"][0]


def cpu_queueing(data: dict) -> None:
    _server(data)["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.03}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.02}},
    ]
    data["rqs_input"]["avg_active_users"]["mean"] = 60


def mixed_io_only(data: dict) -> None:
    """A compute endpoint and an IO-only one (plain IO here: the parity
    suite's io_cache step has no hit/miss dynamics, so it lowers to IO)."""
    _server(data)["endpoints"] = [
        {"endpoint_name": "compute", "steps": [
            {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.02}},
            {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.01}},
        ]},
        {"endpoint_name": "passthrough", "steps": [
            {"kind": "io_cache", "step_operation": {"io_waiting_time": 0.005}},
        ]},
    ]
    data["rqs_input"]["avg_active_users"]["mean"] = 80


def server_chain(data: dict) -> None:
    """client -> srv-1 -> srv-db -> client."""
    data["topology_graph"]["nodes"]["servers"].append({
        "id": "srv-db",
        "server_resources": {"cpu_cores": 1, "ram_mb": 1024},
        "endpoints": [{"endpoint_name": "query", "steps": [
            {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
            {"kind": "io_db", "step_operation": {"io_waiting_time": 0.015}},
        ]}],
    })
    for edge in data["topology_graph"]["edges"]:
        if edge["id"] == "srv-client":
            edge["target"] = "srv-db"
    data["topology_graph"]["edges"].append({
        "id": "db-client", "source": "srv-db", "target": "client-1",
        "latency": {"mean": 0.003, "distribution": "exponential"}, "dropout_rate": 0.0,
    })


def multicore(data: dict) -> None:
    _server(data)["server_resources"]["cpu_cores"] = 4


def multi_burst(data: dict) -> None:
    _server(data)["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.001}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.01}},
        {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.001}},
    ]


def two_core_multi_burst(data: dict) -> None:
    """Two cores under ~50% load, two bursts an endpoint, with weighted
    endpoints and a RAM step kept non-binding."""
    srv = _server(data)
    srv["server_resources"]["cpu_cores"] = 2
    srv["endpoints"] = [
        {"endpoint_name": "a", "selection_weight": 3.0, "steps": [
            {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.012}},
            {"kind": "ram", "step_operation": {"necessary_ram": 32}},
            {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.01}},
            {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.008}},
            {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.02}},
        ]},
        {"endpoint_name": "b", "selection_weight": 1.0, "steps": [
            {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.01}},
            {"kind": "io_db", "step_operation": {"io_waiting_time": 0.03}},
        ]},
    ]
    data["rqs_input"]["avg_active_users"]["mean"] = 150


def binding_ram(data: dict) -> None:
    srv = _server(data)
    srv["server_resources"]["ram_mb"] = 256
    srv["endpoints"][0]["steps"][1]["step_operation"]["necessary_ram"] = 200


def heterogeneous_ram(data: dict) -> None:
    srv = _server(data)
    srv["server_resources"]["ram_mb"] = 300
    srv["endpoints"] = [
        {"endpoint_name": "big", "steps": [
            {"kind": "ram", "step_operation": {"necessary_ram": 200}},
            {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.05}},
        ]},
        {"endpoint_name": "small", "steps": [
            {"kind": "ram", "step_operation": {"necessary_ram": 120}},
            {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.05}},
        ]},
    ]


def varying_pre_io(data: dict) -> None:
    srv = _server(data)
    srv["server_resources"]["ram_mb"] = 256
    srv["endpoints"] = [
        {"endpoint_name": "slowpre", "steps": [
            {"kind": "ram", "step_operation": {"necessary_ram": 200}},
            {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.5}},
            {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.01}},
        ]},
        {"endpoint_name": "fast", "steps": [
            {"kind": "ram", "step_operation": {"necessary_ram": 200}},
            {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.01}},
        ]},
    ]


def many_bursts(data: dict) -> None:
    steps = []
    for _ in range(9):
        steps.append({"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.001}})
        steps.append({"kind": "io_wait", "step_operation": {"io_waiting_time": 0.001}})
    _server(data)["endpoints"][0]["steps"] = steps


def outside_envelope(data: dict) -> None:
    _server(data)["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.018}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.015}},
        {"kind": "cpu_bound_operation", "step_operation": {"cpu_time": 0.012}},
    ]
    data["rqs_input"]["avg_active_users"]["mean"] = 80


def oversized_ram(data: dict) -> None:
    srv = _server(data)
    srv["server_resources"]["ram_mb"] = 256
    srv["endpoints"][0]["steps"][1]["step_operation"]["necessary_ram"] = 300
    srv["endpoints"][0]["steps"][2]["step_operation"]["io_waiting_time"] = 5.0


def least_connections(data: dict) -> None:
    data["topology_graph"]["nodes"]["load_balancer"]["algorithms"] = "least_connection"


def huge_inflight(data: dict) -> None:
    least_connections(data)
    for edge in data["topology_graph"]["edges"]:
        if edge["id"].startswith("lb-"):
            edge["latency"]["mean"] = 3.0
    data["rqs_input"]["avg_active_users"]["mean"] = 300


def outage(data: dict) -> None:
    data["events"] = [{
        "event_id": "o1", "target_id": "srv-1",
        "start": {"kind": "server_down", "t_start": 5.0},
        "end": {"kind": "server_up", "t_end": 10.0},
    }]


def normal_edges(data: dict) -> None:
    """The LB topology with normal and lognormal edges, dropout on the LB
    edges, and a two-hop entry chain."""
    edges = {e["id"]: e for e in data["topology_graph"]["edges"]}
    edges["gen-client"]["latency"] = {"mean": 0.004, "distribution": "normal",
                                      "variance": 0.002}
    edges["lb-srv1"]["latency"] = {"mean": 0.001, "distribution": "log_normal",
                                   "variance": 0.1}
    edges["lb-srv1"]["dropout_rate"] = 0.02
    edges["lb-srv2"]["latency"] = {"mean": 0.003, "distribution": "uniform"}
    edges["lb-srv2"]["dropout_rate"] = 0.05
    edges["srv2-client"]["latency"] = {"mean": 0.003, "distribution": "normal",
                                       "variance": 0.001}


#: (base, mutation) of every plan the plan test compares
MUTATIONS = {
    "cpu_queueing": (BASE, cpu_queueing),
    "mixed_io_only": (BASE, mixed_io_only),
    "server_chain": (BASE, server_chain),
    "multicore": (BASE, multicore),
    "multi_burst": (BASE, multi_burst),
    "two_core_multi_burst": (BASE, two_core_multi_burst),
    "binding_ram": (BASE, binding_ram),
    "heterogeneous_ram": (BASE, heterogeneous_ram),
    "varying_pre_io": (BASE, varying_pre_io),
    "many_bursts": (BASE, many_bursts),
    "outside_envelope": (BASE, outside_envelope),
    "oversized_ram": (BASE, oversized_ram),
    "least_connections": (LB, least_connections),
    "huge_inflight": (LB, huge_inflight),
    "outage": (LB, outage),
    "normal_edges": (LB, normal_edges),
}


def mutated(name: str, *, horizon: float | None = None) -> dict:
    base, mutate = MUTATIONS[name]
    return load(base, mutate, horizon=horizon)


def example(name: str, *, horizon: float | None = None) -> dict:
    return load(EXAMPLES / f"{name}.yml", horizon=horizon)


def reference_window_draws(jax_plan, keys, n_windows: int):
    """(users, counts), (S, NW) each, as the reference's ``_arrivals_stream``
    draws them for each key (``jax.random.poisson`` users at
    ``fold_in(fold_in(key, 0), 1)``, counts at ``... 2``)."""
    import jax
    import jax.numpy as jnp

    from asyncflow_tpu.engines.jaxsim.sampling import TINY, as_threefry, draw_normal

    window = jnp.float32(jax_plan.user_window)
    starts = jnp.arange(n_windows, dtype=jnp.float32) * window
    lens = jnp.minimum(starts + window, jax_plan.horizon) - starts

    def one(key):
        k0 = jax.random.fold_in(key, 0)
        if jax_plan.user_var < 0:
            users = jax.random.poisson(
                as_threefry(jax.random.fold_in(k0, 1)),
                jnp.maximum(jnp.float32(jax_plan.user_mean), TINY), (n_windows,),
            ).astype(jnp.float32)
        else:
            z = draw_normal(jax.random.fold_in(k0, 1), (n_windows,))
            users = jnp.maximum(0.0, jax_plan.user_mean + jax_plan.user_var * z)
        lam = users * jnp.float32(jax_plan.req_per_user_per_sec)
        counts = jax.random.poisson(
            as_threefry(jax.random.fold_in(k0, 2)), jnp.maximum(lam * lens, TINY),
        ).astype(jnp.int32)
        return users, jnp.where(lam > 0, counts, 0)

    users, counts = jax.vmap(one)(keys)
    return np.array(users), np.array(counts)


def run_both(data: dict, n: int, seed: int):
    """(reference state, port state, port plan) of ``n`` scenarios of
    ``seed``: the JAX ``FastEngine`` and the port's on the CPU, the port fed
    the reference's per-window user and count draws."""
    import jax

    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.schemas import SimulationPayload

    ref_plan = jax_compile(JaxPayload.model_validate(data))
    plan = compile_payload(SimulationPayload.from_dict(data))
    keys = jax_keys(seed, n)
    ref = jax.tree_util.tree_map(np.asarray, JaxFastEngine(ref_plan).run_batch(keys))
    eng = FastEngine(plan, device="cpu")
    windows = reference_window_draws(ref_plan, keys, eng.n_windows)
    got = eng.run_batch(np.asarray(keys), window_draws=windows)
    return ref, got, plan


#: one bin of the 1024-bin latency histogram (log-spaced over 1e-4..1e3 s)
ONE_BIN = 10.0 ** (7.0 / 1024)


def assert_matches_reference(ref, got, plan, name: str) -> None:
    """The slice's tolerances against the reference fast path.  Arrival
    times are prefix sums whose float32 rounding differs between the
    packages by a few ulps, so near-tied arrivals may swap their ranks,
    their round-robin slots and the draws their lanes take; counters that
    such a swap can move get max(2, 0.1%) a scenario.  Gauge means pooled
    over the scenarios agree within rtol 1e-3, except the ready-queue
    gauges: they sum waits, small differences of times near the horizon,
    so a scenario's mean wait a request must agree within 4 ulps of the
    horizon."""
    from asyncflow_tpu_torch.engines.results import hist_percentile
    from asyncflow_tpu_torch.engines.torchsim.params import hist_edges

    assert np.array_equal(got.n_generated, ref.n_generated), name
    assert np.array_equal(got.n_overflow, ref.n_overflow), name
    assert ref.n_generated.min() > 0, name
    for field in ("n_dropped", "lat_count"):
        a, b = getattr(got, field).astype(np.int64), getattr(ref, field).astype(np.int64)
        allow = np.maximum(2, np.ceil(0.001 * b))
        assert np.all(np.abs(a - b) <= allow), (
            f"{name}: {field} {a.tolist()} against {b.tolist()} (arrival rounding "
            "moved near-tied ranks past the tolerance)")
    edges = hist_edges()
    for q in (50, 95, 99):
        pa = hist_percentile(got.hist.sum(axis=0), edges, q)
        pb = hist_percentile(ref.hist.sum(axis=0), edges, q)
        assert abs(np.log(pa / pb)) <= np.log(ONE_BIN), (name, q, pa, pb)
    np.testing.assert_allclose(got.lat_sum, ref.lat_sum, rtol=1e-3, err_msg=name)
    ready = [plan.gauge_ready(s) for s in range(plan.n_servers)]
    other = [g for g in range(plan.n_gauges) if g not in ready]
    np.testing.assert_allclose(got.gauge_means[:, other].sum(axis=0),
                               ref.gauge_means[:, other].sum(axis=0), rtol=1e-3,
                               err_msg=name)
    horizon = np.float32(plan.horizon)
    wait_tol = 4 * np.spacing(horizon) * ref.n_generated / horizon
    assert np.all(np.abs(got.gauge_means - ref.gauge_means)[:, ready]
                  <= wait_tol[:, None]), name
