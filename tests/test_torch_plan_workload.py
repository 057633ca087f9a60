"""The port's schemas, compiler, arrival-rate tables and sweep results for
cache mixtures, LLM calls, DB connection pools and several generators,
against the JAX reference.

Every invalid payload raises in both packages with the reference's
message; ``compile_payload`` of both packages agrees field by field on
every field the DES kernel reads; the per-generator blocks of the
arrival-rate table are keyed and laid out as the reference's.
"""

from __future__ import annotations

import copy
import importlib.util
from pathlib import Path

import numpy as np
import pydantic
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import KERNEL_FIELDS, compile_payload
from asyncflow_tpu_torch.compiler.plan import SEG_CACHE, SEG_DB, SEG_IO, SEG_LLM
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import (
    LAM_STREAM,
    KernelEngine,
    lam_table,
)
from asyncflow_tpu_torch.engines.torchsim.keys import fold_in, scenario_keys
from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.parallel import SweepRunner
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

ROOT = Path(__file__).resolve().parents[1]


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _module("chip_smoke", ROOT / "chip_smoke.py")


def db_pool(pool: int | None, *, horizon: float | None = None, users: float | None = None):
    """examples/sweeps/db_pool_sizing.py's payload, optionally cut."""
    data = SMOKE.db_pool_payload(pool)
    if horizon is not None:
        data["sim_settings"]["total_simulation_time"] = horizon
    if users is not None:
        data["rqs_input"]["avg_active_users"]["mean"] = users
    return data


def llm_cost(*, horizon: float | None = None) -> dict:
    """examples/sweeps/llm_cost_sweep.py's payload, optionally cut."""
    data = copy.deepcopy(SMOKE.LLM_COST)
    if horizon is not None:
        data["sim_settings"]["total_simulation_time"] = horizon
    return data


def cache(horizon: float = 120) -> dict:
    """tests/parity/test_cache_dynamics.py's ``_payload``: the integration
    single server (~17 req/s), CPU 2 ms, then a cache that hits in 2 ms
    with probability 0.8 and misses in 50 ms."""
    import yaml

    path = ROOT / "tests" / "integration" / "data" / "single_server.yml"
    data = yaml.safe_load(path.read_text())
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["endpoints"][0]["steps"] = [
        {"kind": "initial_parsing", "step_operation": {"cpu_time": 0.002}},
        {"kind": "io_cache", "step_operation": {"io_waiting_time": 0.002},
         "cache_hit_probability": 0.8, "cache_miss_time": 0.050},
    ]
    data["sim_settings"]["total_simulation_time"] = horizon
    return data


def two_gen(data: dict) -> dict:
    """``data`` (one generator, entering at its client) with a second,
    faster-windowed stream of 10 users x 60 req/min entering over its own
    exponential edge (tests/parity/test_pallas_engine.py:_two_gen_payload)."""
    data = copy.deepcopy(data)
    client = data["topology_graph"]["nodes"]["client"]["id"]
    data["rqs_input"] = [data["rqs_input"], {
        "id": "rqs-2",
        "avg_active_users": {"mean": 10},
        "avg_request_per_minute_per_user": {"mean": 60},
        "user_sampling_window": 4,
    }]
    data["topology_graph"]["edges"].append({
        "id": "gen2-client", "source": "rqs-2", "target": client,
        "latency": {"mean": 0.004, "distribution": "exponential"},
    })
    return data


def featured(horizon: float = 6.0) -> dict:
    """tests/parity/test_pallas_engine.py's featured mix: a DB pool of 2, a
    cache mixture, an LLM call and weighted endpoints on one server."""
    data = copy.deepcopy(SMOKE.SINGLE_SERVER)
    data["rqs_input"]["avg_active_users"]["mean"] = 40
    data["sim_settings"]["total_simulation_time"] = horizon
    srv = data["topology_graph"]["nodes"]["servers"][0]
    srv["server_resources"]["db_connection_pool"] = 2
    srv["endpoints"] = [
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
    return data


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


def _plans(data: dict):
    return (
        compile_payload(SimulationPayload.from_dict(data)),
        jax_compile(JaxPayload.model_validate(data)),
    )


# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------


def test_chip_smoke_literals_equal_their_sources() -> None:
    """SINGLE_SERVER is the YAML; db_pool_payload(K), LLM_COST and
    TWO_GEN_LB are the examples' and the multi-generator parity test's
    payloads (TWO_GEN_LB at the YAML's 600 s)."""
    import yaml

    single = ROOT / "examples" / "yaml_input" / "data" / "single_server.yml"
    assert yaml.safe_load(single.read_text()) == SMOKE.SINGLE_SERVER
    sizing = _module("db_pool_sizing", ROOT / "examples" / "sweeps" / "db_pool_sizing.py")
    for pool in (*sizing.POOL_SIZES, 64):
        want = sizing.payload_with_pool(pool)
        assert JaxPayload.model_validate(SMOKE.db_pool_payload(pool)) == want
    assert SMOKE.DB_POOL_K2 == SMOKE.db_pool_payload(2)
    sweep = _module("llm_cost_sweep", ROOT / "examples" / "sweeps" / "llm_cost_sweep.py")
    assert JaxPayload.model_validate(SMOKE.LLM_COST) == sweep.build_payload()
    multi = _module(
        "test_multi_generator", ROOT / "tests" / "parity" / "test_multi_generator.py",
    )
    assert JaxPayload.model_validate(SMOKE.TWO_GEN_LB) == multi._payload(600)


def _step(data: dict) -> dict:
    return data["topology_graph"]["nodes"]["servers"][0]["endpoints"][0]["steps"][1]


def _with_step(**fields) -> dict:
    data = db_pool(None)
    _step(data).update(fields)
    return data


def _generators(rqs) -> dict:
    data = copy.deepcopy(SMOKE.TWO_GEN_LB)
    data["rqs_input"] = rqs(data["rqs_input"])
    return data


INVALID = {
    "cache_without_miss": (
        lambda: _with_step(kind="io_cache", cache_hit_probability=0.9),
        "must be given together",
    ),
    "cache_on_io_wait": (
        lambda: _with_step(kind="io_wait", cache_hit_probability=0.9, cache_miss_time=0.05),
        "only valid on io_cache steps",
    ),
    "cache_certain_hit": (
        lambda: _with_step(
            kind="io_cache", cache_hit_probability=1.0, cache_miss_time=0.05,
        ),
        r"must be in \(0, 1\)",
    ),
    "llm_partial": (
        lambda: _with_step(kind="io_llm", llm_tokens_mean=20.0, llm_time_per_token=0.01),
        "must be given together",
    ),
    "llm_on_io_db": (
        lambda: _with_step(llm_tokens_mean=20.0, llm_time_per_token=0.01,
                           llm_cost_per_token=1.0),
        "only valid on io_llm steps",
    ),
    "llm_negative_cost": (
        lambda: _with_step(kind="io_llm", llm_tokens_mean=20.0, llm_time_per_token=0.01,
                           llm_cost_per_token=-1.0),
        "must be >= 0",
    ),
    "generators_empty": (lambda: _generators(lambda gens: []), "at least one generator"),
    "generators_duplicate": (
        lambda: _generators(lambda gens: [gens[0], dict(gens[0])]),
        "duplicate generator ids",
    ),
    "generator_without_edge": (
        lambda: _generators(lambda gens: [*gens, {**gens[0], "id": "rqs-3"}]),
        "must source exactly one edge",
    ),
    "generator_on_node_id": (
        lambda: _generators(lambda gens: [gens[0], {**gens[1], "id": "srv-1"}]),
        "collides with a node id",
    ),
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_payloads_raise_the_reference_message(name: str) -> None:
    make, match = INVALID[name]
    data = make()
    with pytest.raises(pydantic.ValidationError, match=match):
        JaxPayload.model_validate(data)
    with pytest.raises(PayloadError, match=match):
        SimulationPayload.from_dict(data)


@pytest.mark.parametrize("pool", [0, -2, 1.5])
def test_db_pool_must_be_a_positive_integer(pool) -> None:
    data = db_pool(pool)
    with pytest.raises(pydantic.ValidationError):
        JaxPayload.model_validate(data)
    with pytest.raises(PayloadError, match="db_connection_pool"):
        SimulationPayload.from_dict(data)


def test_generators_property() -> None:
    one = SimulationPayload.from_dict(SMOKE.TWO_SERVERS_LB)
    assert [g.id for g in one.generators] == ["rqs-1"]
    two = SimulationPayload.from_dict(SMOKE.TWO_GEN_LB)
    assert [g.id for g in two.generators] == ["rqs-1", "rqs-2"]
    listed = copy.deepcopy(SMOKE.TWO_SERVERS_LB)
    listed["rqs_input"] = [listed["rqs_input"]]
    plan, ref = _plans(listed)
    assert plan.n_generators == 1
    assert all(_equal(getattr(plan, f), getattr(ref, f)) for f in KERNEL_FIELDS)


# ---------------------------------------------------------------------------
# compiler
# ---------------------------------------------------------------------------

PLANS = {
    "db_pool_k1": lambda: db_pool(1),
    "db_pool_k2": lambda: db_pool(2),
    "db_pool_k6": lambda: db_pool(6),
    "db_pool_unlimited": lambda: db_pool(None),
    "db_pool_lowered": lambda: db_pool(64),
    "llm_cost": llm_cost,
    "cache": cache,
    "two_gen_lb": lambda: copy.deepcopy(SMOKE.TWO_GEN_LB),
    "featured": featured,
    "db_pool_with_conn_cap": lambda: _conn_capped(db_pool(2)),
}


def _conn_capped(data: dict) -> dict:
    """A connection cap on a server whose DB pool is modelled: the cap is
    modelled too, as the pool's waits are outside the cap's proof."""
    data["topology_graph"]["nodes"]["servers"][0]["overload"] = {"max_connections": 500}
    return data


@pytest.mark.parametrize("name", sorted(PLANS))
def test_compile_payload_matches_reference(name: str) -> None:
    plan, ref = _plans(PLANS[name]())
    diff = [f for f in KERNEL_FIELDS if not _equal(getattr(plan, f), getattr(ref, f))]
    assert diff == []
    assert plan.unsupported == ()


def test_db_pool_is_modelled_where_it_may_bind() -> None:
    """K = 1, 2 and 6 bind at ~20 req/s x 60 ms; K = 64 is proven
    non-binding and lowered away, with the proof's rate headroom."""
    for pool in (1, 2, 6):
        plan, _ = _plans(db_pool(pool))
        assert plan.has_db_pool
        assert plan.server_db_pool.tolist() == [pool]
        assert SEG_DB in plan.seg_kind
    for pool in (None, 64):
        plan, ref = _plans(db_pool(pool))
        assert not plan.has_db_pool
        assert plan.server_db_pool.tolist() == [-1]
        assert SEG_DB not in plan.seg_kind and SEG_IO in plan.seg_kind
    lowered, ref = _plans(db_pool(64))
    assert 1.0 < lowered.proof_rate_headroom < np.inf
    assert lowered.proof_rate_headroom == ref.proof_rate_headroom
    capped, _ = _plans(_conn_capped(db_pool(2)))
    assert capped.has_conn_cap


def test_segment_tables() -> None:
    plan, _ = _plans(featured())
    kinds = plan.seg_kind[0].tolist()
    assert kinds[0][:3] == [1, SEG_CACHE, SEG_DB] and kinds[1][0] == SEG_LLM
    assert plan.seg_hit_prob[0, 0, 1] == np.float32(0.8)
    assert plan.seg_miss_dur[0, 0, 1] == np.float32(0.05)
    assert plan.seg_dur[0, 0, 1] == np.float32(0.002)
    assert plan.seg_llm_tokens[0, 1, 0] == 40.0
    assert plan.seg_llm_cost[0, 1, 0] == np.float32(0.01)
    two, _ = _plans(SMOKE.TWO_GEN_LB)
    assert two.n_generators == 2
    assert two.gen_entry_edges.tolist() == [[0, 1], [6, 1]]
    assert two.gen_windows == [11, 21] and two.n_windows == 32


@pytest.mark.parametrize("name", ["db_pool_k2", "llm_cost", "two_gen_lb"])
def test_sweep_runner_auto_accepts_the_new_paths(name: str) -> None:
    data = copy.deepcopy(SMOKE.PAYLOADS[name])
    data["sim_settings"]["total_simulation_time"] = 5
    runner = SweepRunner(data, engine="auto", device="cpu")
    summary = runner.run(2, seed=0).summary()
    assert summary["completed_total"] > 0
    assert summary["truncated_total"] == 0
    assert (summary["llm_cost_total"] is not None) == (name == "llm_cost")


def test_rate_headroom_guard_reads_stream_overrides() -> None:
    """With two generators the guard takes the largest per-stream ratio of
    (S, G) overrides: one stream scaled past the headroom of a lowered-away
    proof is refused even where the total rate stays inside it."""
    from asyncflow_tpu_torch.errors import ProofHeadroomError

    data = copy.deepcopy(SMOKE.TWO_GEN_LB)
    data["sim_settings"]["total_simulation_time"] = 5
    for server in data["topology_graph"]["nodes"]["servers"]:
        server["overload"] = {"max_ready_queue": 60}
    runner = SweepRunner(data, device="cpu")
    headroom = runner.plan.proof_rate_headroom
    assert not runner.plan.has_queue_cap
    assert 2.0 < headroom < 4.0
    base = base_overrides(runner.plan)
    inside = base._replace(user_mean=np.tile(base.user_mean, (2, 1)))
    assert runner.run(2, seed=0, overrides=inside).summary()["completed_total"] > 0
    # the two streams carry equal rates: rqs-1 at 1.1x the headroom with
    # rqs-2 off is 0.55x the headroom in total, but past it on rqs-1's chain
    shifted = base.user_mean * np.array([1.1 * headroom, 0.0], np.float32)
    with pytest.raises(ProofHeadroomError, match="headroom"):
        runner.run(2, seed=0, overrides=base._replace(user_mean=np.tile(shifted, (2, 1))))


# ---------------------------------------------------------------------------
# arrival-rate tables
# ---------------------------------------------------------------------------


def test_lam_table_blocks_match_the_reference_layout() -> None:
    """One block per generator in order, ``ceil(horizon / window) + 1``
    columns each, keyed ``fold_in(key, 0x77AB + g)`` and drawn with the
    generator's own users; (S, G) overrides address one stream each."""
    import jax

    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.pallas_engine import PallasEngine

    plan, ref = _plans(SMOKE.TWO_GEN_LB)
    eng = PallasEngine(ref, interpret=True)
    assert eng._gen_nw == plan.gen_windows
    assert [int(x) for x in eng._gen_lam_off] == [0, plan.gen_windows[0]]
    keys = scenario_keys(7, 4)
    for g in range(2):
        fold = jax.vmap(lambda k, g=g: jax.random.fold_in(k, LAM_STREAM + g))
        folded = fold(jax_keys(7, 4))
        want = np.asarray(jax.random.key_data(folded))
        assert np.array_equal(fold_in(keys, LAM_STREAM + g).numpy().astype(np.uint32), want)
    table = KernelEngine(plan, device="cpu").lam_table(keys)
    assert tuple(table.shape) == (4, plan.n_windows)
    for g, (off, nw) in enumerate(zip([0, 11], plan.gen_windows)):
        block = lam_table(keys, plan.gen_user_mean[g], plan.gen_rate[g], n_windows=nw,
                          user_var=float(plan.gen_user_var[g]), stream=g)
        assert torch.equal(table[:, off : off + nw], block)
    base = base_overrides(plan)
    ov = base._replace(user_mean=np.array([[200.0, 0.0]] * 4, np.float32),
                       req_rate=np.broadcast_to(base.req_rate, (4, 2)))
    off_stream = KernelEngine(plan, device="cpu").lam_table(keys, ov)
    assert torch.equal(off_stream[:, :11], table[:, :11])
    assert float(off_stream[:, 11:].abs().sum()) == 0.0


def test_lam_table_distribution_matches_the_reference() -> None:
    """Per stream, the mean arrival rate over 256 scenarios agrees with the
    reference's table within 4 standard errors."""
    plan, ref = _plans(SMOKE.TWO_GEN_LB)
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.pallas_engine import PallasEngine
    from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base

    n = 256
    jov = jax_base(ref)
    want = np.asarray(PallasEngine(ref, interpret=True)._lam_table(
        jax_keys(3, n), jov.user_mean, jov.req_rate))
    got = KernelEngine(plan, device="cpu").lam_table(scenario_keys(3, n)).numpy()
    for off, nw in ((0, 11), (11, 21)):
        a, b = want[:, off : off + nw].ravel(), got[:, off : off + nw].ravel()
        se = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) < 4.0 * se, (off, a.mean(), b.mean())


#: mean users of the two 60 s windows of overload_cap8 (120 s) over 2048
#: scenarios of seeds 0..5, as ``lam_table`` draws them: seed 0's, 110.417,
#: is +2.5 standard errors (SE 0.164) from the mean 110, the port's
#: realisation behind its knee paths' offset from the JAX engines (both port
#: engines draw users from this stream; the JAX fast path's seed 0 has
#: 109.920); seeds 1..5: 109.754, 110.087, 110.055, 110.209, 110.141
USER_SEEDS = (0, 1, 2, 3, 4, 5)


@pytest.mark.parametrize(("case", "mean", "windows"),
                         [("mean", 60.0, 20), ("mean", 110.0, 20), ("mean", 150.0, 20),
                          ("mean", 400.0, 20), ("seeds", 110.0, 2)])
def test_lam_table_users_are_poisson(case: str, mean: float, windows: int) -> None:
    """``lam_table``'s Poisson users (``user_var < 0``) at the payloads'
    means over 2048 scenarios x 20 windows of seed 0: the mean within 4
    standard errors and a chi-square goodness-of-fit test against the
    Poisson pmf at p >= 1e-3 (``torch_fast_cases.assert_poisson``).  The
    ``seeds`` case draws overload_cap8's two windows for each of
    ``USER_SEEDS`` and holds each seed's mean users within 4 standard
    errors of the mean (the values are in ``USER_SEEDS``' comment)."""
    from torch_fast_cases import assert_poisson

    n = 2048
    if case == "mean":
        users = lam_table(scenario_keys(0, n), mean, 1.0, n_windows=windows, user_var=-1.0)
        assert_poisson(users.numpy().astype(np.int64).ravel(), mean)
        return
    se = np.sqrt(mean / (n * windows))
    for seed in USER_SEEDS:
        users = lam_table(scenario_keys(seed, n), mean, 1.0, n_windows=windows, user_var=-1.0)
        assert abs(float(users.double().mean()) - mean) < 4.0 * se, seed


# ---------------------------------------------------------------------------
# sweep results
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llm_sweeps():
    from asyncflow_tpu.parallel.sweep import SweepRunner as JaxSweepRunner

    data = llm_cost(horizon=5)
    ref = JaxSweepRunner(
        JaxPayload.model_validate(data), engine="pallas", use_mesh=False, preflight="off",
    ).run(16, seed=0)
    port = SweepRunner(data, device="cpu").run(16, seed=0)
    return ref, port


def test_llm_cost_fields_match_the_reference(llm_sweeps) -> None:
    """The LLM cost moments and summary keys, with the reference's names;
    the mean cost per completed request within the pooled tolerance (the
    two packages draw different arrival-rate tables)."""
    ref, port = llm_sweeps
    a, b = ref.summary(), port.summary()
    for key in ("llm_cost_total", "llm_cost_mean_per_request"):
        assert key in a and key in b
    assert b["llm_cost_total"] == pytest.approx(float(port.results.llm_cost_sum.sum()))
    assert b["llm_cost_mean_per_request"] == pytest.approx(
        b["llm_cost_total"] / b["completed_total"])
    assert abs(b["llm_cost_mean_per_request"] / a["llm_cost_mean_per_request"] - 1.0) < 0.08
    # 250 tokens x 2e-5 per request
    assert b["llm_cost_mean_per_request"] == pytest.approx(0.005, rel=0.05)
    assert port.results.llm_cost_sumsq.shape == port.results.llm_cost_sum.shape


def test_llm_cost_fields_are_none_without_llm_segments() -> None:
    data = db_pool(2, horizon=5)
    summary = SweepRunner(data, device="cpu").run(2, seed=0).summary()
    assert summary["llm_cost_total"] is None
    assert summary["llm_cost_mean_per_request"] is None
