"""The fused edge hop's plain version (``draws.hop_plain``) on the CPU: the
same as the unfused hop (``draws.edge_hop_plain``) followed by the torch
epilogue it replaces in the fast engine (send gate, spans, drop count,
time step), per-lane outputs and drop counts exactly and gauge spans
within 1 float32 ulp; and with network spikes, the same as the JAX
reference's ``_edge_hop`` / ``_edge_hop_dyn``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    example,
    mutated,
    one_torch_thread,
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
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

S, N = 4, 3001


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def _tables(plan, *, spikes: bool) -> draws.EdgeTables:
    ne = plan.n_edges
    em, ev, ed = (torch.as_tensor(np.broadcast_to(np.asarray(x, np.float32), (S, ne)).copy())
                  for x in (plan.edge_mean, plan.edge_var, plan.edge_dropout))
    lb = plan.n_lb_edges > 0
    return draws.EdgeTables(
        dist=plan.edge_dist, mean=em, var=ev, drop=ed, horizon=plan.horizon,
        lb_edge=torch.as_tensor(plan.lb_edge_index.astype(np.int32)) if lb else None,
        lb_target=torch.as_tensor(plan.lb_target.astype(np.int32)) if lb else None,
        spike_t=torch.as_tensor(plan.spike_times) if spikes else None,
        spike_v=torch.as_tensor(plan.spike_values) if spikes else None,
    )


def _unfused(tables: draws.EdgeTables, t, alive, uk, zk, *, edge=None, rank=None):
    """The fast engine's hop before its fusion: the unfused hop, the spike
    added after the law, then the engine's epilogue over (S, n)."""
    h = np.float32(tables.horizon).item()
    alive = alive & (t < h)
    eidx = slot = None
    if rank is not None:
        slot = torch.where(alive, rank % tables.lb_edge.shape[0], 0)
        eidx = tables.lb_edge.long()[slot]
    dropped, delay = draws.edge_hop_plain(draws.uniform(uk, t.shape[1]), zk, tables.dist,
                                          tables.mean, tables.var, tables.drop, edge=edge,
                                          eidx=eidx, laws=draws.hop_laws(
                                              tables.dist, edge, tables.lb_edge))
    if tables.spike_t is not None:
        delay = draws.spike_add(delay, t, tables.spike_t, tables.spike_v, edge=edge, eidx=eidx)
    ok = alive & ~dropped
    t_end = delay.plus(t)
    lo = torch.clamp_max(t, h)
    hi = torch.clamp_max(t_end, h)
    span = torch.where(ok, torch.clamp_min(hi - lo, 0.0), 0.0)
    if slot is None:
        spans = span.sum(dim=1, keepdim=True)
    else:
        spans = torch.stack([torch.where(slot == k, span, 0.0).sum(dim=1)
                             for k in range(tables.lb_edge.shape[0])], dim=1)
    target = None if slot is None else tables.lb_target[slot]
    return (torch.where(ok, t_end, t), ok, target, spans, (alive & dropped).sum(dim=1))


def _lanes(horizon: float):
    g = np.random.default_rng(7)
    t = torch.tensor(g.uniform(0.0, 1.1 * horizon, (S, N)), dtype=torch.float32)
    alive = torch.tensor(g.random((S, N)) > 0.1)
    rank = torch.tensor(g.permuted(np.tile(np.arange(N), (S, 1)), axis=1), dtype=torch.int64)
    return t, alive, rank


CASES = {
    "headline_static": (lambda: example("two_servers_lb", horizon=30), False, False),
    "headline_lb": (lambda: example("two_servers_lb", horizon=30), True, False),
    "normal_lb": (lambda: mutated("normal_edges", horizon=30), True, False),
    "spike_static": (lambda: example("event_inj_single_server", horizon=300), False, True),
    "spike_lb": (lambda: example("event_inj_lb"), True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_hop_is_the_unfused_hop_and_its_epilogue(case: str) -> None:
    make, lb, spikes = CASES[case]
    plan = compile_payload(SimulationPayload.from_dict(make()))
    assert plan.has_spikes == spikes
    tables = _tables(plan, spikes=spikes)
    t, alive, rank = _lanes(plan.horizon)
    uk, zk = draws.hop_keys(scenario_keys(5, S), 32)
    edges = [None] if lb else range(plan.n_edges)
    for edge in edges:
        kw = {"rank": rank} if lb else {"edge": edge}
        got = draws.hop_plain(tables, t, alive, uk, zk, **kw)
        t_next, ok, target, span, dropped = _unfused(tables, t, alive, uk, zk, **kw)
        assert torch.equal(got.t_next, t_next), edge
        assert torch.equal(got.ok, ok), edge
        assert torch.equal(got.dropped, dropped), edge
        assert (target is None) == (got.target is None)
        if target is not None:
            assert torch.equal(got.target, target)
        assert _ulps(got.span, span) <= 1, edge
        assert bool((span > 0).all()), edge


@pytest.mark.parametrize("lb", [False, True])
def test_spike_hop_matches_reference(lb: bool) -> None:
    """Send times spread over the horizon cross every spike breakpoint:
    the hop adds the spike active at each lane's send time after the law,
    as the reference's ``_add_spike`` does (delays within 4 ulps)."""
    data = example("event_inj_lb") if lb else example("event_inj_single_server", horizon=300)
    plan = compile_payload(SimulationPayload.from_dict(data))
    ref = jax_compile(JaxPayload.model_validate(data))
    eng, jov = JaxFastEngine(ref), jax_base(ref)
    t, _, rank = _lanes(plan.horizon)
    t = torch.clamp_max(t, np.float32(plan.horizon).item() * 0.999)
    alive = torch.ones((S, N), dtype=torch.bool)
    site = 32 if lb else 17
    if lb:
        k = plan.n_lb_edges
        eidx = plan.lb_edge_index[(rank % k).numpy()].astype(np.int32)
        want = jax.vmap(lambda key, tt, e: eng._edge_hop_dyn(
            jax.random.fold_in(key, site), e, tt, jov))(
            jax_keys(8, S), jnp.asarray(t.numpy()), jnp.asarray(eidx))
        edge_means = plan.edge_mean[plan.lb_edge_index]
    else:
        edge = int(plan.entry_edges[-1])
        want = jax.vmap(lambda key, tt: eng._edge_hop(
            jax.random.fold_in(key, site), edge, tt, jov))(jax_keys(8, S), jnp.asarray(t.numpy()))
        edge_means = plan.edge_mean[edge : edge + 1]
    uk, zk = draws.hop_keys(scenario_keys(8, S), site)
    kw = {"rank": rank} if lb else {"edge": edge}
    got = draws.hop_plain(_tables(plan, spikes=True), t, alive, uk, zk, **kw)
    dropped, delay = (np.asarray(x) for x in want)
    assert np.array_equal(got.ok.numpy(), ~dropped)
    step = (got.t_next - t).numpy()[~dropped]
    want_step = ((t.numpy() + delay) - t.numpy())[~dropped]
    assert np.all(np.abs(step - want_step) <= 4 * np.spacing(np.float32(plan.horizon)))
    spiked = delay > 10 * float(edge_means.max())
    assert spiked.any() and (~spiked).any()
