"""Payloads and reference draws shared by the fast path's port tests
(``tests/test_torch_fast_*.py``).  The mutations copy those of the
reference's ``tests/parity/test_fastpath_parity.py`` (copied, not
imported, so that the reference's suite stays as it is)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]
BASE = ROOT / "tests" / "integration" / "data" / "single_server.yml"
LB = ROOT / "tests" / "integration" / "data" / "two_servers_lb.yml"
EXAMPLES = ROOT / "examples" / "yaml_input" / "data"


def one_torch_thread() -> None:
    """Run torch on one intra-op thread in this test process.  The suite
    runs in several worker processes at once (pytest-xdist), and torch's
    default of a thread a core in each worker oversubscribes the cores many
    times over; the port's CPU tests pass small tensors, which gain nothing
    from threads: with the default the port's test files took ~1.7 times
    the test seconds.  Every port test file that runs torch on the CPU calls
    this when it is imported."""
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def torch_inference_mode():
    """Each test of a port test file that imports this fixture runs under
    ``torch.inference_mode()``: the port computes no gradients, and torch's
    CPU operations then skip their autograd bookkeeping (the DES twin's
    small operations ran ~20% faster)."""
    with torch.inference_mode():
        yield


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


def lc_outage(data: dict) -> None:
    """Least connections with srv-2 down from 10 s to 30 s (the reference's
    ``test_fastpath_least_connections_outage``)."""
    least_connections(data)
    data["events"] = [{
        "event_id": "o1", "target_id": "srv-2",
        "start": {"kind": "server_down", "t_start": 10.0},
        "end": {"kind": "server_up", "t_end": 30.0},
    }]


def lc_discriminates(data: dict) -> None:
    """Least connections with a congested LB edge (25x its transit time) at
    300 users (``test_fastpath_least_connections_discriminates``)."""
    least_connections(data)
    for edge in data["topology_graph"]["edges"]:
        if edge["id"] == "lb-srv1":
            edge["latency"]["mean"] = 0.05
    data["rqs_input"]["avg_active_users"]["mean"] = 300


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


def resilient_edges(data: dict) -> None:
    """normal_edges under edge fault windows: the entry edge degraded from
    t = 0, two overlapping degrades of lb-srv1 (factors multiply, boosts
    add) and a network spike on it (added after the factor), a partition of
    lb-srv2, and a dark window of srv-2."""
    normal_edges(data)
    data["events"] = [{
        "event_id": "spike", "target_id": "lb-srv1",
        "start": {"kind": "network_spike_start", "t_start": 4.0, "spike_s": 0.01},
        "end": {"kind": "network_spike_end", "t_end": 10.0},
    }]
    data["fault_timeline"] = {"events": [
        {"fault_id": "entry", "kind": "edge_degrade", "target_id": "gen-client",
         "t_start": 0.0, "t_end": 8.0, "latency_factor": 2.0, "dropout_boost": 0.05},
        {"fault_id": "slow", "kind": "edge_degrade", "target_id": "lb-srv1",
         "t_start": 3.0, "t_end": 12.0, "latency_factor": 3.0},
        {"fault_id": "lossy", "kind": "edge_degrade", "target_id": "lb-srv1",
         "t_start": 6.0, "t_end": 15.0, "latency_factor": 1.5, "dropout_boost": 0.1},
        {"fault_id": "cut", "kind": "edge_partition", "target_id": "lb-srv2",
         "t_start": 9.0, "t_end": 11.0},
        {"fault_id": "dark", "kind": "server_outage", "target_id": "srv-2",
         "t_start": 12.0, "t_end": 14.0},
    ]}


#: the client retry policy of the resilience guide's runnable outage sweep
#: (docs/guides/resilience.md, "A runnable outage sweep")
GUIDE_RETRY = {
    "request_timeout_s": 0.5, "max_attempts": 3, "backoff_base_s": 0.1,
    "backoff_multiplier": 2.0, "backoff_cap_s": 1.0, "budget_tokens": 50,
    "budget_refill_per_s": 5.0,
}


def outage_retry(data: dict) -> None:
    """The guide's outage sweep: single_server.yml with its retry policy and
    one outage of srv-1 from 10 s to 25 s."""
    data["retry_policy"] = dict(GUIDE_RETRY)
    data["fault_timeline"] = {"events": [{
        "fault_id": "srv-1-outage", "kind": "server_outage", "target_id": "srv-1",
        "t_start": 10.0, "t_end": 25.0,
    }]}


def cache_mixture(data: dict) -> None:
    """CPU 2 ms, then a cache that hits in 2 ms with probability 0.8 and
    misses in 50 ms (the reference's tests/parity/test_cache_dynamics.py):
    the miss extra lands in the trailing IO."""
    _server(data)["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "io_cache", "step_operation": {"io_waiting_time": 0.002},
         "cache_hit_probability": 0.8, "cache_miss_time": 0.050},
    ]
    data["rqs_input"]["avg_active_users"]["mean"] = 50


def cache_around_db(data: dict) -> None:
    """Caches before the CPU burst, before a DB query and after it, on one
    connection: every placement of a miss extra, and the DB station."""
    def cache(hit: float, miss: float) -> dict:
        return {"kind": "io_cache", "step_operation": {"io_waiting_time": hit},
                "cache_hit_probability": 0.7, "cache_miss_time": miss}

    srv = _server(data)
    srv["server_resources"]["db_connection_pool"] = 1
    srv["endpoints"][0]["steps"] = [
        cache(0.001, 0.010),
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.003}},
        cache(0.002, 0.020),
        {"kind": "io_db", "step_operation": {"io_waiting_time": 0.015}},
        cache(0.001, 0.030),
    ]
    data["rqs_input"]["avg_active_users"]["mean"] = 60


def second_stream(data: dict) -> None:
    """The LB topology with the second stream of docs/guides/yaml-scenarios.md
    (the reference's tests/parity/test_multi_generator.py): rqs-1 200 users
    x 20 req/min, window 60 s; rqs-2 100 users x 40 req/min, window 30 s,
    entering over an exponential 4 ms edge."""
    data["rqs_input"]["avg_active_users"]["mean"] = 200
    data["rqs_input"] = [data["rqs_input"], {
        "id": "rqs-2",
        "avg_active_users": {"mean": 100},
        "avg_request_per_minute_per_user": {"mean": 40},
        "user_sampling_window": 30,
    }]
    data["topology_graph"]["edges"].append({
        "id": "gen2-client", "source": "rqs-2", "target": "client-1",
        "latency": {"mean": 0.004, "distribution": "exponential"},
    })


def db_pool_k2(data: dict) -> None:
    """examples/sweeps/db_pool_sizing.py's server at a pool of 2: CPU 2 ms,
    then a 60 ms query holding one of 2 connections, 60 users (~20 req/s)."""
    srv = _server(data)
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "io_db", "step_operation": {"io_waiting_time": 0.060}},
    ]
    srv["server_resources"]["db_connection_pool"] = 2
    data["rqs_input"]["avg_active_users"]["mean"] = 60


def queue_cap(data: dict) -> None:
    """A ready-queue cap of 3 on one server at a load where it binds (the
    reference's tests/parity/test_pallas_engine.py)."""
    srv = _server(data)
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.040}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.010}},
    ]
    srv["overload"] = {"max_ready_queue": 3}
    data["rqs_input"]["avg_active_users"]["mean"] = 60


def conn_cap(data: dict) -> None:
    """A connection cap of 4 on one server at a load where it binds."""
    srv = _server(data)
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.200}},
    ]
    srv["overload"] = {"max_connections": 4}
    data["rqs_input"]["avg_active_users"]["mean"] = 60


def rate_limited_lb(data: dict) -> None:
    """examples/sweeps/resilience_controls.py's ``build_payload("none")``:
    srv-2 behind a 5 rps token bucket of 5, srv-1's CPU 18 ms, 150 users."""
    data["rqs_input"]["avg_active_users"]["mean"] = 150.0
    for srv in data["topology_graph"]["nodes"]["servers"]:
        if srv["id"] == "srv-2":
            srv["overload"] = {"rate_limit_rps": 5.0, "rate_limit_burst": 5}
        else:
            srv["endpoints"][0]["steps"][0]["step_operation"] = {"cpu_time": 0.018}


def _overload_server(data: dict, users: float, overload: dict | None) -> None:
    """examples/sweeps/overload_policy.py's server: CPU 30 ms then IO 10 ms
    at ``users`` x 20 req/min, with ``overload`` controls."""
    srv = _server(data)
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.030}},
        {"kind": "io_wait", "step_operation": {"io_waiting_time": 0.010}},
    ]
    if overload is not None:
        srv["overload"] = overload
    data["rqs_input"]["avg_active_users"]["mean"] = users


def overload_cap8(data: dict) -> None:
    """overload_policy.py's ``payload_with(8)`` at its top point, 110 users."""
    _overload_server(data, 110, {"max_ready_queue": 8})


def overload_deadline(data: dict) -> None:
    """The same server with a dequeue deadline of 0.2 s, 100 users."""
    _overload_server(data, 100, {"queue_timeout_s": 0.2})


def overload_sockets(data: dict) -> None:
    """The same server at 110 users under a connection cap of 6, a
    ready-queue cap of 4 and a dequeue deadline of 0.1 s (the socket scan
    with the cap and the deadline composed)."""
    _overload_server(data, 110, {"max_connections": 6, "max_ready_queue": 4,
                                 "queue_timeout_s": 0.1})


def retry_queue_cap(data: dict) -> None:
    """The guide's retry policy on overload_policy.py's server under a
    ready-queue cap of 4 at 110 users: shed attempts retry."""
    _overload_server(data, 110, {"max_ready_queue": 4})
    data["retry_policy"] = dict(GUIDE_RETRY)


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
    "lc_outage": (LB, lc_outage),
    "lc_discriminates": (LB, lc_discriminates),
    "huge_inflight": (LB, huge_inflight),
    "outage": (LB, outage),
    "normal_edges": (LB, normal_edges),
    "cache_mixture": (BASE, cache_mixture),
    "cache_around_db": (BASE, cache_around_db),
    "two_gen_lb": (EXAMPLES / "two_servers_lb.yml", second_stream),
    "db_pool_k2": (EXAMPLES / "single_server.yml", db_pool_k2),
    "queue_cap": (BASE, queue_cap),
    "conn_cap": (BASE, conn_cap),
    "resilient_edges": (LB, resilient_edges),
    "outage_retry": (BASE, outage_retry),
    "rate_limited_lb": (EXAMPLES / "two_servers_lb.yml", rate_limited_lb),
    "overload_cap8": (EXAMPLES / "single_server.yml", overload_cap8),
    "overload_deadline": (EXAMPLES / "single_server.yml", overload_deadline),
    "overload_sockets": (EXAMPLES / "single_server.yml", overload_sockets),
    "retry_queue_cap": (EXAMPLES / "single_server.yml", retry_queue_cap),
}


def mutated(name: str, *, horizon: float | None = None) -> dict:
    base, mutate = MUTATIONS[name]
    return load(base, mutate, horizon=horizon)


def example(name: str, *, horizon: float | None = None) -> dict:
    return load(EXAMPLES / f"{name}.yml", horizon=horizon)


def port_examples() -> list[str]:
    """Every example YAML whose features the port's schemas accept."""
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.errors import UnsupportedFeatureError
    from asyncflow_tpu_torch.schemas import SimulationPayload

    names = []
    for path in sorted(EXAMPLES.glob("*.yml")):
        try:
            compile_payload(SimulationPayload.from_dict(example(path.stem)))
        except UnsupportedFeatureError:
            continue
        names.append(path.stem)
    return names


def reference_window_draws(jax_plan, keys, n_windows: int | None = None, *,
                           user_mean=None, rate=None):
    """(users, counts), (S, NW) each, as the reference's ``_arrivals_stream``
    draws them for each key (``jax.random.poisson`` users at
    ``fold_in(fold_in(key, 0), 1)``, counts at ``... 2``).  With several
    generators, a list of each stream's (S, NW_g) users and one of its
    counts, stream g keyed ``fold_in(fold_in(key, 0), 101 + g)``.
    ``user_mean`` and ``rate`` (requests per user a second), where given,
    are a scenario's (S,) or, with several generators, (S, G) overrides of
    the plan's."""
    import jax
    import jax.numpy as jnp

    from asyncflow_tpu.engines.jaxsim.sampling import TINY, as_threefry, draw_normal

    horizon = jax_plan.horizon

    def stream(k_g, user_mean, user_var, window_s, rate):
        nw = int(np.ceil(horizon / float(window_s)))
        window = jnp.float32(window_s)
        starts = jnp.arange(nw, dtype=jnp.float32) * window
        lens = jnp.minimum(starts + window, horizon) - starts
        if user_var < 0:
            users = jax.random.poisson(
                as_threefry(jax.random.fold_in(k_g, 1)),
                jnp.maximum(jnp.float32(user_mean), TINY), (nw,),
            ).astype(jnp.float32)
        else:
            z = draw_normal(jax.random.fold_in(k_g, 1), (nw,))
            users = jnp.maximum(0.0, jnp.float32(user_mean) + jnp.float32(user_var) * z)
        lam = users * jnp.float32(rate)
        counts = jax.random.poisson(
            as_threefry(jax.random.fold_in(k_g, 2)), jnp.maximum(lam * lens, TINY),
        ).astype(jnp.int32)
        return users, jnp.where(lam > 0, counts, 0)

    s = np.asarray(keys).shape[0]
    g_all = jax_plan.n_generators
    base_um = (np.full(s, jax_plan.user_mean) if g_all == 1
               else np.tile(np.asarray(jax_plan.gen_user_mean), (s, 1)))
    base_rr = (np.full(s, jax_plan.req_per_user_per_sec) if g_all == 1
               else np.tile(np.asarray(jax_plan.gen_rate), (s, 1)))
    um_all = np.broadcast_to(np.asarray(base_um if user_mean is None else user_mean,
                                        np.float32), base_um.shape)
    rr_all = np.broadcast_to(np.asarray(base_rr if rate is None else rate, np.float32),
                             base_rr.shape)
    if g_all == 1:
        users, counts = jax.vmap(lambda key, um, rr: stream(
            jax.random.fold_in(key, 0), um, jax_plan.user_var,
            jax_plan.user_window, rr))(keys, um_all, rr_all)
        if n_windows is not None:
            assert users.shape[1] == n_windows
        return np.array(users), np.array(counts)
    users, counts = [], []
    for g in range(jax_plan.n_generators):
        u_g, c_g = jax.vmap(lambda key, um, rr, g=g: stream(
            jax.random.fold_in(jax.random.fold_in(key, 0), 101 + g),
            um, float(jax_plan.gen_user_var[g]),
            float(jax_plan.gen_window[g]), rr))(keys, um_all[:, g], rr_all[:, g])
        users.append(np.array(u_g))
        counts.append(np.array(c_g))
    return users, counts


def hazard_overrides(ref_plan, seed: int, n: int, **scales):
    """The reference's base overrides carrying the chaos campaign's sampled
    fault tables of scenarios 0 .. n-1 of ``seed`` (``hazard_scale`` /
    ``mttr_scale`` in ``scales``), as its sweep builds them.  The tables
    are sampled by the port's ``hazard_fault_tables`` (equal to the
    reference's, ``tests/test_torch_hazards.py``, and without the JAX
    compile of the reference's scalar draws)."""
    from asyncflow_tpu.engines.jaxsim.params import base_overrides
    from asyncflow_tpu_torch.compiler.hazards import hazard_fault_tables

    tables = hazard_fault_tables(ref_plan, seed, 0, n, **scales)
    return base_overrides(ref_plan)._replace(
        fault_srv_times=tables.srv_times, fault_srv_down=tables.srv_down,
        fault_edge_times=tables.edge_times, fault_edge_lat=tables.edge_lat,
        fault_edge_drop=tables.edge_drop,
    )


def run_both(data: dict, n: int, seed: int, transform=None, overrides=None):
    """(reference state, port state, port plan) of ``n`` scenarios of
    ``seed``: the JAX ``FastEngine`` and the port's on the CPU, the port fed
    the reference's per-window user and count draws.  ``transform``, where
    given, maps each package's compiled plan to the plan that runs;
    ``overrides``, where given, maps the reference's plan to its
    ``ScenarioOverrides``, which both engines run (the port's through
    ``overrides_from_arrays``)."""
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
    if transform is not None:
        ref_plan, plan = transform(ref_plan), transform(plan)
    from asyncflow_tpu_torch.engines.torchsim.params import overrides_from_arrays

    keys = jax_keys(seed, n)
    jov = overrides(ref_plan) if overrides is not None else None
    ref = jax.tree_util.tree_map(np.asarray, JaxFastEngine(ref_plan).run_batch(keys, jov))
    eng = FastEngine(plan, device="cpu")
    windows = reference_window_draws(ref_plan, keys)
    ov = None if jov is None else overrides_from_arrays(jov._asdict())
    got = eng.run_batch(np.asarray(keys), ov, window_draws=windows)
    return ref, got, plan


#: one bin of the 1024-bin latency histogram (log-spaced over 1e-4..1e3 s)
ONE_BIN = 10.0 ** (7.0 / 1024)


def assert_matches_reference(ref, got, plan, name: str) -> None:
    """The slice's tolerances against the reference fast path.  Arrival
    times are the reference's bit for bit (XLA's CPU ``log1p`` and
    ``cumsum`` order), drops are settled by the same uniforms, so the
    counters are exact: generated, dropped, completed, and the resilience
    counters (dark refusals, timeouts, retries, budget denials and the
    attempts histogram).  An edge delay's ``log`` / ``exp`` may round an
    ulp apart between XLA and torch on the CPU, and the reference's float
    sums associate differently: latency sums and pooled gauge means agree
    within rtol 1e-3, except the ready-queue gauges: they sum waits, small
    differences of times near the horizon, so a scenario's mean wait a
    request must agree within 4 ulps of the horizon."""
    from asyncflow_tpu_torch.engines.results import hist_percentile
    from asyncflow_tpu_torch.engines.torchsim.params import hist_edges

    assert np.array_equal(got.n_generated, ref.n_generated), name
    assert np.array_equal(got.n_overflow, ref.n_overflow), name
    assert ref.n_generated.min() > 0, name
    assert np.array_equal(got.att_hist, ref.att_hist), name
    for field in ("n_dropped", "lat_count", "n_rejected", "n_dark_lost", "n_timed_out",
                  "n_retries", "n_budget_exhausted"):
        a, b = getattr(got, field).astype(np.int64), getattr(ref, field).astype(np.int64)
        assert np.array_equal(a, b), f"{name}: {field} {a.tolist()} against {b.tolist()}"
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


#: the chi-square test's threshold: a fixed seed, so a pass is reproducible
CHI2_P_MIN = 1e-3


def assert_poisson(counts: np.ndarray, mu: float) -> None:
    """``counts`` drawn at window mean ``mu``: their mean within 4 standard
    errors, and, binned so that every bin expects at least 20 draws (the
    tails merged), a chi-square goodness-of-fit test against Poisson(mu)
    at p >= 1e-3."""
    from scipy import stats

    se = np.sqrt(mu / counts.size)
    assert abs(counts.mean() - mu) <= 4.0 * se, (counts.mean(), mu)
    # bins [lo, hi) over the support, each expecting >= 20 draws
    ks = np.arange(int(mu + 12 * np.sqrt(mu) + 20) + 1)
    pmf = stats.poisson.pmf(ks, mu)
    edges, acc = [0], 0.0
    for k, p in zip(ks, pmf):
        acc += p * counts.size
        if acc >= 20.0:
            edges.append(k + 1)
            acc = 0.0
    edges[-1] = np.inf
    obs = np.histogram(counts, bins=np.asarray(edges, float))[0]
    cdf = stats.poisson.cdf(np.asarray(edges[1:-1]) - 1, mu)
    expected = np.diff(np.r_[0.0, cdf, 1.0]) * counts.size
    assert len(obs) >= 3
    p = stats.chisquare(obs, expected).pvalue
    assert p >= CHI2_P_MIN, (mu, p)


def inject_reference_draws(runner, ref_plan) -> None:
    """Make the port's fast ``SweepRunner`` draw every window's users and
    arrival counts as the reference's ``FastEngine`` does for the same
    scenario keys and workload overrides (``reference_window_draws``), so
    that both packages' sweeps of one seed run the same arrivals."""
    eng = runner.engine
    streams = ref_plan.n_generators

    def window_draws(keys, user_mean, req_rate):
        jkeys = keys.cpu().numpy().astype(np.uint32)
        s = jkeys.shape[0]
        um = np.stack([np.broadcast_to(np.asarray(u, np.float32), (s,)) for u in user_mean],
                      axis=1)
        rr = np.stack([r.cpu().numpy() for r in req_rate], axis=1)
        if streams == 1:
            um, rr = um[:, 0], rr[:, 0]
        _users, counts = reference_window_draws(ref_plan, jkeys, user_mean=um, rate=rr)
        counts = counts if streams > 1 else [counts]
        return None, [torch.as_tensor(c, device=keys.device) for c in counts]

    eng.window_draws = window_draws


def scaled_events(data: dict, horizon: float) -> dict:
    """``data`` cut to ``horizon`` seconds with its events' and fault
    windows' times scaled with it (``chip_smoke._fast_check_payload``)."""
    import copy

    data = copy.deepcopy(data)
    scale = horizon / data["sim_settings"]["total_simulation_time"]
    data["sim_settings"]["total_simulation_time"] = horizon
    for event in data.get("events", []):
        event["start"]["t_start"] *= scale
        event["end"]["t_end"] *= scale
    for fault in data.get("fault_timeline", {}).get("events", []):
        fault["t_start"] *= scale
        fault["t_end"] *= scale
    return data
