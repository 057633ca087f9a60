"""Fault windows on the port's fast path against the JAX reference on the
CPU: the fused hop under edge fault tables (shared, shifted a row a
scenario, sampled a row a scenario; a partition, overlapping degrades, a
window from t = 0) against the reference's ``_edge_hop`` and
``_edge_hop_dyn``, the drop mask exactly and the delay within 4 ulps; the
whole engine on chaos_campaign (its sampled tables injected into both) and
on a timeline of edge faults and a dark window, counters exact
(``torch_fast_cases.assert_matches_reference``); and chaos sweeps, chunked
as unchunked, scorecard included."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    assert_matches_reference,
    example,
    hazard_overrides,
    mutated,
    one_torch_thread,
    run_both,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import draws
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.parallel import SweepRunner, make_overrides
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

S, N = 4, 2001
HORIZON = 20.0


def _ulp_close(got, want, scale) -> bool:
    """|got - want| within 4 ulps of max(|want|, scale): a normal law's
    ``mean + var * z`` cancels near 0 (the scale is the lane's mean times
    its fault factor)."""
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.maximum(np.abs(want), np.asarray(scale, np.float32)))
    return bool(np.all(np.abs(np.asarray(got, np.float32) - want) <= 4 * ulp))


def _fault_rows(plan, case: str):
    """(times, latency factors, dropout boosts) of the case: the plan's
    tables shared, their times shifted a row a scenario (some before 0,
    clipped), or sampled values a row a scenario."""
    times, lat, drop = plan.fault_edge_times, plan.fault_edge_lat, plan.fault_edge_drop
    if case == "shared":
        return times, lat, drop
    g = np.random.default_rng(8)
    if case == "shifted":
        rows = np.maximum(times[None, :] + np.linspace(-2.0, 6.0, S)[:, None], 0.0)
        rows[:, 0] = 0.0
        return rows.astype(np.float32), lat, drop
    lat_s = (lat[None] * g.uniform(1.0, 3.0, (S, *lat.shape))).astype(np.float32)
    drop_s = np.minimum(drop[None] + g.uniform(0.0, 0.2, (S, *drop.shape)), 1.0)
    return np.broadcast_to(times, (S, times.size)).copy(), lat_s, drop_s.astype(np.float32)


@pytest.mark.parametrize("case", ["shared", "shifted", "sampled"])
def test_fault_hop_matches_reference(case: str) -> None:
    """Every static edge and the LB's per-lane edges, lanes sending at
    random times and at every breakpoint; the factor multiplies the law's
    delay before the spike is added (two roundings)."""
    data = mutated("resilient_edges", horizon=HORIZON)
    plan = compile_payload(SimulationPayload.from_dict(data))
    ref = jax_compile(JaxPayload.model_validate(data))
    eng = JaxFastEngine(ref)
    ft, fl, fd = _fault_rows(plan, case)
    g = np.random.default_rng(4)
    t = g.uniform(0.0, HORIZON, (S, N)).astype(np.float32)
    t[:, : plan.fault_edge_times.size] = plan.fault_edge_times
    lanes = g.integers(0, 2, (S, N))
    eidx = plan.lb_edge_index[lanes].astype(np.int32)
    axes = 0 if np.ndim(ft) == 2 else None
    vaxes = 0 if np.ndim(fl) == 3 else None
    jov = jax_base(ref)

    def ref_hop(edge):
        def one(k, tt, e, a, b, c):
            ov = jov._replace(fault_edge_times=a, fault_edge_lat=b, fault_edge_drop=c)
            if edge is None:
                return eng._edge_hop_dyn(jax.random.fold_in(k, 32), e, tt, ov)
            return eng._edge_hop(jax.random.fold_in(k, 32), edge, tt, ov)

        return jax.vmap(one, in_axes=(0, 0, 0, axes, vaxes, vaxes))(
            jax_keys(5, S), jnp.asarray(t), jnp.asarray(eidx), jnp.asarray(ft),
            jnp.asarray(fl), jnp.asarray(fd))

    rows = (lambda x: torch.as_tensor(np.ascontiguousarray(x)))
    em, ev, ed = (torch.as_tensor(np.broadcast_to(np.asarray(x, np.float32),
                                                  (S, plan.n_edges)).copy())
                  for x in (plan.edge_mean, plan.edge_var, plan.edge_dropout))
    tables = draws.EdgeTables(dist=plan.edge_dist, mean=em, var=ev, drop=ed, horizon=HORIZON,
                              fault_t=rows(ft), fault_lat=rows(fl), fault_drop=rows(fd))
    uk, zk = draws.hop_keys(scenario_keys(5, S), 32)
    t_send = torch.as_tensor(t)
    u = draws.uniform(uk, N)
    assert plan.has_spikes
    spike_t, spike_v = torch.as_tensor(plan.spike_times), torch.as_tensor(plan.spike_values)
    partitioned = 0
    for edge in [*range(plan.n_edges), None]:
        dropped, delay = (np.asarray(x) for x in ref_hop(edge))
        where = {"edge": edge} if edge is not None else {"eidx": torch.as_tensor(eidx)}
        factor, boost = (x.numpy() for x in draws.fault_lookup(tables, t_send, **where))
        got_drop, got_delay = draws.edge_hop_plain(
            u, zk, plan.edge_dist, em, ev, ed, **where, fault=(torch.as_tensor(factor),
                                                             torch.as_tensor(boost)))
        got_delay = draws.spike_add(got_delay, t_send, spike_t, spike_v, **where).value()
        mean = plan.edge_mean[edge] if edge is not None else plan.edge_mean[eidx]
        assert np.array_equal(got_drop.numpy(), dropped), edge
        assert _ulp_close(got_delay.numpy()[~dropped], delay[~dropped],
                          (mean * factor)[~dropped]), edge
        # a partitioned edge drops every send inside its window
        partitioned += int((boost >= 1.0).sum())
        assert np.all(dropped[boost >= 1.0]), edge
    assert partitioned > 0


def test_fault_hop_is_the_unfused_hop() -> None:
    """The fused hop under fault tables equals its unfused pieces: the
    drop mask, the delay and the next times exactly, and a partition
    leaves no non-finite time."""
    data = mutated("resilient_edges", horizon=HORIZON)
    plan = compile_payload(SimulationPayload.from_dict(data))
    ft, fl, fd = _fault_rows(plan, "shifted")
    em, ev, ed = (torch.as_tensor(np.broadcast_to(np.asarray(x, np.float32),
                                                  (S, plan.n_edges)).copy())
                  for x in (plan.edge_mean, plan.edge_var, plan.edge_dropout))
    tables = draws.EdgeTables(
        dist=plan.edge_dist, mean=em, var=ev, drop=ed, horizon=HORIZON,
        lb_edge=torch.as_tensor(plan.lb_edge_index.astype(np.int32)),
        lb_target=torch.as_tensor(plan.lb_target.astype(np.int32)),
        fault_t=torch.as_tensor(ft), fault_lat=torch.as_tensor(fl),
        fault_drop=torch.as_tensor(fd))
    g = np.random.default_rng(6)
    t_send = torch.as_tensor(g.uniform(0.0, 1.1 * HORIZON, (S, N)).astype(np.float32))
    alive = torch.as_tensor(g.random((S, N)) > 0.1)
    rank = torch.as_tensor(g.permuted(np.tile(np.arange(N), (S, 1)), axis=1))
    uk, zk = draws.hop_keys(scenario_keys(6, S), 32)
    gate = alive & (t_send < HORIZON)
    for kw in ({"edge": 3}, {"rank": rank}):
        got = draws.hop_plain(tables, t_send, alive, uk, zk, **kw)
        where = ({"edge": 3} if "edge" in kw
                 else {"eidx": tables.lb_edge.long()[torch.where(gate, rank % 2, 0)]})
        dropped, delay = draws.edge_hop_plain(
            draws.uniform(uk, N), zk, plan.edge_dist, em, ev, ed, **where,
            laws=draws.hop_laws(plan.edge_dist, kw.get("edge"), tables.lb_edge),
            fault=draws.fault_lookup(tables, t_send, **where))
        assert torch.equal(got.ok, gate & ~dropped)
        assert torch.equal(got.t_next, torch.where(got.ok, delay.plus(t_send), t_send))
        assert torch.equal(got.dropped, (gate & dropped).sum(dim=1))
        assert bool(torch.isfinite(got.t_next).all()) and bool(torch.isfinite(got.span).all())


CASES = {
    # the campaign's windows made dense enough to reach 60 s (MTBF / 5 .. 20)
    "chaos_campaign": (lambda: example("chaos_campaign", horizon=60),
                       lambda p: hazard_overrides(p, 1, 8, hazard_scale=np.linspace(5, 20, 8))),
    "resilient_edges": (lambda: mutated("resilient_edges", horizon=HORIZON), None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_faulted_engine_matches_reference(name: str) -> None:
    make, overrides = CASES[name]
    ref, got, plan = run_both(make(), 8, seed=1, overrides=overrides)
    assert_matches_reference(ref, got, plan, name)
    assert ref.n_dark_lost.sum() > 0 and ref.n_dropped.sum() > 0


def test_chaos_sweep_is_chunk_invariant() -> None:
    """A chaos sweep in chunks equals it whole, scorecard included; the
    campaign is sampled once for the sweep's block of scenarios."""
    runner = SweepRunner(example("chaos_campaign", horizon=30), device="cpu")
    assert runner.engine_kind == "fast"
    ov = make_overrides(runner.plan, 6, hazard_scale=np.full(6, 12.0))
    whole = runner.run(6, seed=2, overrides=ov)
    parts = runner.run(6, seed=2, overrides=ov, chunk_size=4)
    for field in ("latency_hist", "completed", "total_dropped", "total_rejected", "dark_lost",
                  "unavailable_s", "degraded_goodput", "hazard_truncated"):
        assert np.array_equal(getattr(whole.results, field), getattr(parts.results, field)), \
            field
    summary = whole.summary()
    assert summary["dark_lost_total"] > 0
    assert 0.0 < summary["availability_fraction"] < 1.0
    assert summary["unavailable_s_total"] > 0 and summary["time_to_drain_mean_s"] is None
    assert whole.results.unavailable_s.shape == (6, 2)
    assert summary["rejected_total"] == summary["dark_lost_total"]
