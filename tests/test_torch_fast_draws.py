"""The fast path's draws, ranks and searches against the JAX reference on
the CPU: ``jax.random.uniform`` bit for bit, ``jax.random.normal`` and the
edge delays of the fused hop within 4 ulps (XLA's CPU ``log`` and ``exp``
may round a value differently from torch's), dropout exactly; the stable
time rank exactly, with ties, dead lanes and ``-0.0``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    mutated,
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base
from asyncflow_tpu.engines.jaxsim.sortutil import searchsorted_small as jax_search
from asyncflow_tpu.engines.jaxsim.sortutil import time_rank as jax_rank
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import draws
from asyncflow_tpu_torch.engines.torchsim.keys import fold_in, scenario_keys
from asyncflow_tpu_torch.engines.torchsim.sortutil import (
    argsort_time,
    searchsorted_small,
    time_rank,
)
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

S, N = 4, 3001


def _ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _within_4_ulps(got, want, scale: float) -> bool:
    """|got - want| within 4 ulps of max(|want|, scale): a normal edge's
    ``mean + var * z`` cancels near 0, where ulps of the result itself say
    nothing about the draw."""
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(scale)))
    return bool(np.all(np.abs(np.asarray(got, np.float32) - want) <= 4 * ulp))


def _jax_draw(fn, keys, site: int, n: int) -> np.ndarray:
    return np.asarray(jax.vmap(lambda k: fn(jax.random.fold_in(k, site), (n,)))(keys))


@pytest.mark.parametrize("site", [0, 3, 32, 129])
def test_uniform_is_jax_uniform_bit_for_bit(site: int) -> None:
    want = _jax_draw(jax.random.uniform, jax_keys(7, S), site, N)
    got = draws.uniform(fold_in(scenario_keys(7, S), site), N).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_within_4_ulps_of_jax_normal() -> None:
    want = _jax_draw(jax.random.normal, jax_keys(8, S), 2, 20_000)
    got = draws.normal(fold_in(scenario_keys(8, S), 2), 20_000).numpy()
    assert _ulps(got, want) <= 4
    assert np.abs(want).max() > 3.5  # the tails (w >= 5 of erfinv) are reached


def _plans():
    data = mutated("normal_edges", horizon=20)
    return (compile_payload(SimulationPayload.from_dict(data)),
            jax_compile(JaxPayload.model_validate(data)))


def _edge_tables(plan):
    ov = {k: torch.as_tensor(np.broadcast_to(np.asarray(v, np.float32), (S, plan.n_edges)).copy())
          for k, v in (("em", plan.edge_mean), ("ev", plan.edge_var),
                       ("ed", plan.edge_dropout))}
    return ov["em"], ov["ev"], ov["ed"]


def _tables(plan, **spikes) -> draws.EdgeTables:
    em, ev, ed = _edge_tables(plan)
    return draws.EdgeTables(
        dist=plan.edge_dist, mean=em, var=ev, drop=ed, horizon=plan.horizon,
        lb_edge=torch.as_tensor(plan.lb_edge_index.astype(np.int32)),
        lb_target=torch.as_tensor(plan.lb_target.astype(np.int32)), **spikes,
    )


def _assert_hop_is(got: draws.HopOut, want, t_send, scale: float) -> None:
    """The fused hop against the reference's (dropped, delay) of lanes all
    alive and sending before the horizon: ok is not dropped, and an ok
    lane's time moves by the reference's delay (within 4 ulps)."""
    dropped, delay = (np.asarray(x) for x in want)
    assert np.array_equal(got.ok.numpy(), ~dropped)
    t0 = np.asarray(t_send, np.float32)
    t1 = got.t_next.numpy()
    assert np.array_equal(t1[dropped], np.broadcast_to(t0, t1.shape)[dropped])
    assert _within_4_ulps((t1 - t0)[~dropped], delay[~dropped], scale)
    assert np.array_equal(got.dropped.numpy(), dropped.sum(axis=1))


@pytest.mark.parametrize("edge", range(6))
def test_static_edge_hop_matches_reference(edge: int) -> None:
    plan, ref = _plans()
    eng = JaxFastEngine(ref)
    jov = jax_base(ref)
    t = jnp.zeros(N, jnp.float32)
    want = jax.vmap(lambda k: eng._edge_hop(jax.random.fold_in(k, 16), edge, t, jov))(
        jax_keys(9, S))
    uk, zk = draws.hop_keys(scenario_keys(9, S), 16)
    t_send = torch.zeros((S, N))
    got = draws.EdgeDraws().hop(_tables(plan), t_send, torch.ones((S, N), dtype=torch.bool),
                                uk, zk, edge=edge)
    _assert_hop_is(got, want, t_send, float(plan.edge_mean[edge]))


def test_lb_edge_hop_matches_reference() -> None:
    """The routed LB hop (slot = rank % 2) over LB edges of two laws
    (lognormal and uniform) with dropout on both, and its targets."""
    plan, ref = _plans()
    eng = JaxFastEngine(ref)
    jov = jax_base(ref)
    lanes = np.random.default_rng(3).integers(0, 2, (S, N))
    eidx = plan.lb_edge_index[lanes].astype(np.int32)
    t = jnp.zeros(N, jnp.float32)
    want = jax.vmap(
        lambda k, e: eng._edge_hop_dyn(jax.random.fold_in(k, 32), e, t, jov),
    )(jax_keys(10, S), jnp.asarray(eidx))
    uk, zk = draws.hop_keys(scenario_keys(10, S), 32)
    t_send = torch.zeros((S, N))
    got = draws.EdgeDraws().hop(_tables(plan), t_send, torch.ones((S, N), dtype=torch.bool),
                                uk, zk, rank=torch.as_tensor(lanes + 2 * np.arange(N)))
    _assert_hop_is(got, want, t_send, float(plan.edge_mean[plan.lb_edge_index].min()))
    assert not got.ok.all()
    assert np.array_equal(got.target.numpy(), plan.lb_target[lanes])


def test_shared_uniform_hop_matches_reference() -> None:
    """An exit hop on the shared exit stream: u from fold_in(key, 7), z
    from the hop key."""
    plan, ref = _plans()
    eng = JaxFastEngine(ref)
    jov = jax_base(ref)
    t = jnp.zeros(N, jnp.float32)

    def one(k):
        u = jax.random.uniform(jax.random.fold_in(k, 7), (N,))
        return eng._edge_hop(jax.random.fold_in(k, 129), 5, t, jov, u=u)

    want = jax.vmap(one)(jax_keys(11, S))
    keys = scenario_keys(11, S)
    _, zk = draws.hop_keys(keys, 129)
    t_send = torch.zeros((S, N))
    got = draws.EdgeDraws().hop(_tables(plan), t_send, torch.ones((S, N), dtype=torch.bool),
                                fold_in(keys, 7), zk, edge=5)
    _assert_hop_is(got, want, t_send, float(plan.edge_mean[5]))


def _rank_inputs():
    g = np.random.default_rng(4)
    t = np.round(g.uniform(0.0, 2.0, (S, 2000)), 3).astype(np.float32)  # many ties
    t[:, ::97] = -0.0
    t[:, ::89] = 0.0
    alive = g.random((S, 2000)) > 0.2
    return t, alive


def test_time_rank_is_the_reference_rank() -> None:
    t, alive = _rank_inputs()
    want = np.stack([np.asarray(jax_rank(jnp.asarray(t[i]), jnp.asarray(alive[i])))
                     for i in range(S)])
    got = time_rank(torch.as_tensor(t), torch.as_tensor(alive))
    assert np.array_equal(got.numpy(), want)
    perm = argsort_time(torch.as_tensor(t), torch.as_tensor(alive))
    assert torch.equal(torch.gather(got, 1, perm), torch.arange(2000).expand(S, -1))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_small_is_the_reference_search(side: str) -> None:
    table = np.array([0.1, 0.25, 0.25, 0.7, 1.0], np.float32)
    q = np.random.default_rng(2).choice(
        np.r_[table, np.random.default_rng(3).random(50).astype(np.float32)], (S, 64),
    ).astype(np.float32)
    want = np.asarray(jax_search(jnp.asarray(table), jnp.asarray(q), side))
    got = searchsorted_small(torch.as_tensor(table), torch.as_tensor(q), side)
    assert np.array_equal(got.numpy(), want)
    rows = torch.as_tensor(np.sort(np.random.default_rng(5).integers(0, 90, (S, 7)), axis=1))
    slots = torch.arange(100).expand(S, -1)
    want_rows = np.stack([np.searchsorted(rows[i].numpy(), np.arange(100), side=side)
                          for i in range(S)])
    assert np.array_equal(searchsorted_small(rows, slots, side).numpy(), want_rows)
