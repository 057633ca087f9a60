"""``make_overrides``' edge and workload axes and the fast path's override
guard, held against the JAX reference on the CPU.

Each axis moves both packages' ``SweepRunner(engine="fast")`` alike: the
port runs the reference's window draws for the same scenario keys and
workload (``torch_fast_cases.inject_reference_draws``), so per-scenario
counters are equal and pooled percentiles agree within one histogram bin
(ROADMAP, "Parity contract").  On a least-connections plan the guard
refuses, as the reference's ``_guard_overrides_against_plan`` does, a rate
raise and a raised mean on any LB edge: both pass the in-flight ring's
proof.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    ONE_BIN,
    inject_reference_draws,
    mutated,
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.results import hist_percentile
from asyncflow_tpu_torch.errors import FastPathOverrideError
from asyncflow_tpu_torch.parallel import SweepRunner, make_overrides
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

ROOT = Path(__file__).resolve().parents[1]
#: scenarios of the axes' sweep: two a block, one block an axis
S = 10
#: each axis' block of two scenarios in the axes' sweep
BLOCKS = {"edge_mean_scale": 0, "edge_var_scale": 2, "dropout_scale": 4, "user_mean": 6,
          "req_per_minute": 8}


def _lb() -> dict:
    """The LB topology with normal, lognormal and uniform edges and dropout
    on both LB edges (every axis moves something), 10 s."""
    return mutated("normal_edges", horizon=10)


def _axes(plan) -> dict:
    """The five axes, each moving its own block of two scenarios (the other
    rows at the base plan): edge means x1.5 and x0.5 on every edge,
    variances by an (S, NE) table, dropouts x3 and x30 (clipped to 1),
    users x0.5 and x0.8, requests a minute x0.6 and x0.9 (rate cuts: the
    RAM tier was proven non-binding at the base rate)."""
    ne = plan.n_edges
    mean = np.ones(S, np.float32)
    mean[0:2] = (1.5, 0.5)
    var = np.ones((S, ne), np.float32)
    var[2] = 2.0
    var[3] = np.linspace(0.5, 3.0, ne)
    drop = np.ones(S, np.float32)
    drop[4:6] = (3.0, 30.0)
    users = np.full(S, plan.user_mean, np.float32)
    users[6:8] *= np.float32([0.5, 0.8])
    rpm = np.full(S, plan.req_per_user_per_sec * 60.0, np.float32)
    rpm[8:10] *= np.float32([0.6, 0.9])
    return {"edge_mean_scale": mean, "edge_var_scale": var, "dropout_scale": drop,
            "user_mean": users, "req_per_minute": rpm}


def _jax_plan(data: dict):
    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    return jax_compile(JaxPayload.model_validate(data))


def _both_sweeps(data: dict, n: int, seed: int, axes) -> tuple:
    """(reference report, port report) of ``n`` scenarios of ``seed`` under
    each package's ``make_overrides(plan, n, **axes(plan))``."""
    from asyncflow_tpu.parallel import SweepRunner as JaxRunner
    from asyncflow_tpu.parallel import make_overrides as jax_overrides
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    ref_runner = JaxRunner(JaxPayload.model_validate(data), engine="fast", use_mesh=False,
                           scan_inner=0)
    ref = ref_runner.run(n, seed=seed,
                         overrides=jax_overrides(ref_runner.plan, n, **axes(ref_runner.plan)))
    runner = SweepRunner(data, engine="fast", device="cpu")
    inject_reference_draws(runner, ref_runner.plan)
    got = runner.run(n, seed=seed, overrides=make_overrides(runner.plan, n, **axes(runner.plan)),
                     chunk_size=4)
    return ref, got


def _assert_rows_match(ref, got, rows: slice, label: str) -> None:
    for field in ("total_generated", "completed", "total_dropped", "overflow_dropped",
                  "total_rejected"):
        a = np.asarray(getattr(got.results, field))[rows].astype(np.int64)
        b = np.asarray(getattr(ref.results, field))[rows].astype(np.int64)
        assert np.array_equal(a, b), (label, field, a.tolist(), b.tolist())
    pooled_got = got.results.latency_hist[rows].sum(axis=0)
    pooled_ref = ref.results.latency_hist[rows].sum(axis=0)
    for q in (50, 95):
        pa = hist_percentile(pooled_got, got.results.hist_edges, q)
        pb = hist_percentile(pooled_ref, ref.results.hist_edges, q)
        assert abs(np.log(pa / pb)) <= np.log(ONE_BIN), (label, q, pa, pb)


@pytest.fixture(scope="module")
def axes_sweeps():
    return _both_sweeps(_lb(), S, 3, _axes)


@pytest.mark.parametrize("axis", sorted(BLOCKS))
def test_each_axis_moves_both_packages_alike(axes_sweeps, axis: str) -> None:
    ref, got = axes_sweeps
    start = BLOCKS[axis]
    _assert_rows_match(ref, got, slice(start, start + 2), axis)
    # the axis moved its block off the base rows
    base = got.results.latency_sum[S - 1] / got.results.completed[S - 1]
    moved = got.results.latency_sum[start:start + 2] / got.results.completed[start:start + 2]
    gen = got.results.total_generated
    assert np.any(moved != base) or np.any(gen[start:start + 2] != gen[S - 1]), axis


def test_base_rows_match(axes_sweeps) -> None:
    ref, got = axes_sweeps
    _assert_rows_match(ref, got, slice(0, S), "all")


@pytest.mark.parametrize("axis", sorted(BLOCKS))
def test_make_overrides_equals_the_references(axis: str) -> None:
    """Each axis alone gives the reference's override arrays: the scales
    multiply the base, dropout clips to [0, 1], requests a minute divide by
    60."""
    from asyncflow_tpu.parallel import make_overrides as jax_overrides

    data = _lb()
    ref_plan = _jax_plan(data)
    plan = compile_payload(SimulationPayload.from_dict(data))
    value = _axes(plan)[axis]
    got = make_overrides(plan, S, **{axis: value})
    want = jax_overrides(ref_plan, S, **{axis: value})
    for field in ("edge_mean", "edge_var", "edge_dropout", "user_mean", "req_rate"):
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype == np.float32, (axis, field)
        assert a.shape == b.shape and np.array_equal(a, b), (axis, field)


def test_per_stream_user_mean_on_two_generators() -> None:
    """(S, G) users and requests a minute on two_gen_lb: each stream's
    workload moves alone, per scenario, as in the reference."""
    data = mutated("two_gen_lb", horizon=8)

    def axes(plan):
        base = np.asarray(plan.gen_user_mean, np.float32)
        users = np.tile(base, (4, 1))
        users[1, 0] *= np.float32(0.5)
        users[2, 1] *= np.float32(0.25)
        rpm = np.tile(np.asarray(plan.gen_rate, np.float32) * np.float32(60.0), (4, 1))
        rpm[3, 1] *= np.float32(0.5)
        return {"user_mean": users, "req_per_minute": rpm}

    ref, got = _both_sweeps(data, 4, 1, axes)
    _assert_rows_match(ref, got, slice(0, 4), "two_gen_lb")
    gen = got.results.total_generated
    assert gen[1] < gen[0] and gen[2] < gen[0]


@pytest.mark.parametrize(
    ("name", "kw"),
    [
        ("two_gen_lb", {"user_mean": np.ones(4)}),
        ("two_gen_lb", {"req_per_minute": np.ones((4, 3))}),
        ("normal_edges", {"edge_mean_scale": np.ones(3)}),
        ("normal_edges", {"dropout_scale": np.ones((5, 2))}),
    ],
)
def test_shape_errors_are_the_references(name: str, kw: dict) -> None:
    from asyncflow_tpu.parallel import make_overrides as jax_overrides

    data = mutated(name, horizon=5)
    with pytest.raises(ValueError) as want:
        jax_overrides(_jax_plan(data), 4, **kw)
    with pytest.raises(ValueError) as got:
        make_overrides(compile_payload(SimulationPayload.from_dict(data)), 4, **kw)
    assert str(got.value) == str(want.value)


def _mixed_fleet() -> dict:
    """chip_smoke's lc_mixed_fleet payload (the mixed fleet's least
    connections at 24 MB), 10 s."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke.mixed_fleet_payload(24.0, horizon=10)


def _lc_without_ram() -> dict:
    """Least connections on the LB topology with no RAM step: only the
    in-flight ring's proof depends on the rate."""
    data = mutated("least_connections", horizon=5)
    for srv in data["topology_graph"]["nodes"]["servers"]:
        for ep in srv["endpoints"]:
            ep["steps"] = [st for st in ep["steps"] if st["kind"] != "ram"]
    return data


def _guard_outcome(data: dict, n: int, **axes) -> tuple[str | None, str | None]:
    """(the reference's refusal, the port's), each its message or None,
    of a fast sweep under ``make_overrides(plan, n, **axes)``."""
    from asyncflow_tpu.parallel import SweepRunner as JaxRunner
    from asyncflow_tpu.parallel import make_overrides as jax_overrides
    from asyncflow_tpu.parallel.sweep import _guard_overrides_against_plan
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    ref_runner = JaxRunner(JaxPayload.model_validate(data), engine="fast", use_mesh=False)
    ref_ov = jax_overrides(ref_runner.plan, n, **axes)
    try:
        _guard_overrides_against_plan(ref_runner.plan, ref_ov)
        want = None
    except ValueError as err:
        want = str(err)
        with pytest.raises(ValueError, match="invalidates the fast path"):
            ref_runner.run(n, seed=0, overrides=ref_ov)
    runner = SweepRunner(data, engine="fast", device="cpu")
    try:
        runner.run(n, seed=0, overrides=make_overrides(runner.plan, n, **axes))
        got = None
    except FastPathOverrideError as err:
        got = str(err)
    return want, got


def test_lc_guard_refuses_an_lb_edge_mean_raise() -> None:
    """lc_mixed_fleet with one LB edge's mean raised 1.5x: the ring was
    sized from each LB edge's delay, so both packages refuse."""
    data = _mixed_fleet()
    plan = compile_payload(SimulationPayload.from_dict(data))
    assert plan.lc_ring > 0
    scale = np.ones((2, plan.n_edges), np.float32)
    scale[:, int(plan.lb_edge_index[1])] = 1.5
    want, got = _guard_outcome(data, 2, edge_mean_scale=scale)
    assert want is not None and got is not None
    assert "least-connections in-flight bound" in want
    assert "least-connections in-flight bound" in got


def test_lc_guard_refuses_a_rate_raise() -> None:
    """users raised 1.5x under least connections: on lc_mixed_fleet the
    RAM tier's proof names the refusal, on a plan without RAM the ring's."""
    data = _mixed_fleet()
    plan = compile_payload(SimulationPayload.from_dict(data))
    want, got = _guard_outcome(data, 2, user_mean=np.full(2, 1.5 * plan.user_mean))
    assert "RAM non-binding proof" in want and "RAM non-binding proof" in got
    data = _lc_without_ram()
    plan = compile_payload(SimulationPayload.from_dict(data))
    assert plan.lc_ring > 0 and not np.any(plan.ram_slots == -1)
    want, got = _guard_outcome(data, 2, user_mean=np.full(2, 1.5 * plan.user_mean))
    assert "least-connections in-flight bound" in want
    assert "least-connections in-flight bound" in got


def test_lc_guard_lets_overrides_under_the_bound_run() -> None:
    """A non-LB edge raised 3x, the LB edges lowered and users cut: inside
    every proof, so both guards pass and the port's sweep runs."""
    data = _mixed_fleet()
    plan = compile_payload(SimulationPayload.from_dict(data))
    scale = np.ones((2, plan.n_edges), np.float32)
    lb = set(plan.lb_edge_index.tolist())
    other = next(e for e in range(plan.n_edges) if e not in lb)
    scale[:, other] = 3.0
    for e in lb:
        scale[:, e] = 0.8
    want, got = _guard_outcome(data, 2, edge_mean_scale=scale,
                               user_mean=np.full(2, 0.9 * plan.user_mean))
    assert want is None and got is None


def test_stream_workload_reaches_both_engines_draws() -> None:
    """An (S, G) ``user_mean`` from make_overrides reaches each stream's own
    draws on both port engines: the fast path's window draws (a stream
    with no users draws no arrivals) and the DES kernel's λ-table, whose
    per-stream blocks split the (S, G) array column by column, as the
    reference's PallasEngine does."""
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine, lam_table
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys

    plan = compile_payload(SimulationPayload.from_dict(mutated("two_gen_lb", horizon=8)))
    users = np.tile(np.asarray(plan.gen_user_mean, np.float32), (3, 1))
    users[1, 0] = 0.0
    users[2, 1] = 0.0
    ov = make_overrides(plan, 3, user_mean=users)
    keys = scenario_keys(2, 3)
    eng = FastEngine(plan, device="cpu")
    fov = eng._overrides(ov, 3)
    _, counts = eng.window_draws(keys, fov["um"], fov["rr"])
    assert [int(c[0].sum()) > 0 for c in counts] == [True, True]
    assert int(counts[0][1].sum()) == 0 and int(counts[1][1].sum()) > 0
    assert int(counts[1][2].sum()) == 0 and int(counts[0][2].sum()) > 0
    lam = KernelEngine(plan, device="cpu").lam_table(keys, ov)
    blocks = [lam_table(keys, users[:, g], np.asarray(ov.req_rate)[g], n_windows=nw,
                        user_var=float(plan.gen_user_var[g]), stream=g)
              for g, nw in enumerate(plan.gen_windows)]
    assert np.array_equal(lam.numpy(), np.concatenate([b.numpy() for b in blocks], axis=1))
    assert not lam[1, : plan.gen_windows[0]].any() and lam[1, plan.gen_windows[0]:].any()
