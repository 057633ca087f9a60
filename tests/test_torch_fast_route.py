"""Round robin under an outage timeline on the fast path, against the JAX
reference on the CPU: the segment form of ``lb_route`` (its plain table and
lane map) against the arrival-by-arrival replay of the reference's scan
and against the JAX ``FastEngine._routed_slots`` itself, on every tie case
of the timeline; the LB hop's ``slot=`` form against its ``rank=`` form
where no mark is set; and the whole engine on the outage plans, fed the
reference's window draws (tolerances in
``torch_fast_cases.assert_matches_reference``)."""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    assert_matches_reference,
    example,
    mutated,
    one_torch_thread,
    run_both,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import draws, routing
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.engines.torchsim.sortutil import time_rank
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

S, N = 4, 400


def _event_inj_lb_marks():
    plan = compile_payload(SimulationPayload.from_dict(example("event_inj_lb")))
    scale = np.float32(2.0 / 600.0)  # its windows scaled into the lanes' 2 s
    return ((plan.timeline_times * scale).tolist(), plan.timeline_down.tolist(),
            plan.timeline_slot.tolist())


#: (times, down, slot) over the two LB slots of the LB topology, in table
#: order: each of the tie cases a timeline can hold
TIMELINES = {
    "no_marks": ([], [], []),
    "event_inj_lb": _event_inj_lb_marks(),
    "back_to_back": ([0.5, 1.0, 1.0, 1.5], [1, 0, 1, 0], [0, 0, 0, 0]),
    "all_down": ([0.4, 0.6, 0.9, 1.3], [1, 1, 0, 0], [0, 1, 1, 0]),
    "same_time_marks": ([0.5, 0.5, 0.5, 1.2], [1, 1, 0, 0], [1, 0, 1, 0]),
    "up_present_down_absent": ([0.3, 0.7, 0.7, 1.1], [0, 1, 1, 0], [1, 0, 0, 0]),
    "unknown_slot": ([0.5, 1.5], [1, 0], [-1, -1]),
    "before_first_after_last": ([-1.0, 0.0, 3.0, 4.0], [1, 0, 1, 0], [1, 1, 0, 0]),
}


def _lanes(seed: int):
    """(t, alive), (S, N): arrival times on a coarse grid over 2 s (ties
    between lanes and with the marks), a tenth of the lanes dead."""
    g = np.random.default_rng(seed)
    t = np.round(g.uniform(0.0, 2.0, (S, N)), 2).astype(np.float32)
    t[:, :8] = np.float32(0.5)  # arrivals at exactly a mark's time
    alive = g.random((S, N)) > 0.1
    return t, alive


def _jax_routed(tl, t, alive):
    """JAX's ``_routed_slots`` under ``jax.vmap`` on the LB topology's plan
    with the timeline replaced."""
    plan = jax_compile(JaxPayload.model_validate(mutated("outage", horizon=20)))
    times, down, slot = tl
    plan = dataclasses.replace(
        plan,
        timeline_times=np.asarray(times, np.float32),
        timeline_down=np.asarray(down, np.int32),
        timeline_slot=np.asarray(slot, np.int32),
    )
    eng = JaxFastEngine(plan)
    slot, routed = jax.jit(jax.vmap(eng._routed_slots))(jnp.asarray(t), jnp.asarray(alive))
    return np.asarray(slot), np.asarray(routed)


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_segment_form_is_the_reference_scan(name: str) -> None:
    t_np, alive_np = _lanes(7)
    t, alive = torch.tensor(t_np), torch.tensor(alive_np)
    tl = routing.Timeline(*TIMELINES[name], 2, "cpu")
    table = routing.route_table_plain(t, alive, tl.times, tl.down, tl.slot, 2)
    got = routing.route_slots_plain(table, time_rank(t, alive), alive)
    scan, routed = routing.routed_slots_scan(t, alive, tl.times, tl.down, tl.slot, 2)
    assert torch.equal(got, scan)
    want, want_routed = _jax_routed(TIMELINES[name], t_np, alive_np)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert np.array_equal(routed.numpy(), want_routed)
    assert torch.equal(routing.LbRoute().slots(routing.LbRoute().table(tl, t, alive),
                                               time_rank(t, alive), alive), got)
    if name == "all_down":
        assert bool((alive & (got < 0)).any())
    if name == "no_marks":
        assert torch.equal(got, torch.where(alive, time_rank(t, alive) % 2, -1).int())


def test_table_records_each_segment() -> None:
    """All servers down from 0.6 s to 0.9 s: the segments between those
    marks have an empty rotation; the reinserted slots come back at the
    tail in the order their up marks apply."""
    t_np, alive_np = _lanes(8)
    t, alive = torch.tensor(t_np), torch.tensor(alive_np)
    tl = routing.Timeline(*TIMELINES["all_down"], 2, "cpu")
    table = routing.route_table_plain(t, alive, tl.times, tl.down, tl.slot, 2)
    counts = [int((alive[0] & (t[0] < x)).sum()) for x in tl.times.tolist()]
    assert table[0, :, 0].tolist() == [0, *counts]
    assert table[0, :, 1].tolist() == [2, 1, 0, 1, 2]
    assert table[0, 2, 2:].tolist() == [-1, -1]
    assert table[0, 3, 2].item() == 1
    assert table[0, 4, 3].item() == 0


def test_slot_hop_is_the_rank_hop_without_marks() -> None:
    """With no mark, the lanes' slots are ``rank % K`` and the hop's slot
    form is bit-identical to its rank form: same uniforms, targets, times,
    spans and drops."""
    plan = compile_payload(SimulationPayload.from_dict(example("two_servers_lb", horizon=5)))
    t_np, alive_np = _lanes(9)
    t, alive = torch.tensor(t_np), torch.tensor(alive_np)
    g = np.random.default_rng(3)
    mean = torch.tensor(np.tile(plan.edge_mean, (S, 1)))
    tables = draws.EdgeTables(
        dist=plan.edge_dist, mean=mean, var=torch.zeros_like(mean),
        drop=torch.tensor(g.uniform(0.0, 0.1, mean.shape), dtype=torch.float32),
        horizon=1.9, lb_edge=torch.tensor(plan.lb_edge_index),
        lb_target=torch.tensor(plan.lb_target),
    )
    uk, zk = draws.hop_keys(scenario_keys(5, S), 32)
    rank = time_rank(t, alive)
    tl = routing.Timeline([], [], [], 2, "cpu")
    slot = routing.route_lanes(routing.LbRoute(), tl, t, alive)
    by_rank = draws.EdgeDraws().hop(tables, t, alive, uk, zk, rank=rank)
    by_slot = draws.EdgeDraws().hop(tables, t, alive, uk, zk, slot=slot)
    for a, b in zip(by_rank, by_slot):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="exactly one"):
        draws.EdgeDraws().hop(tables, t, alive, uk, zk, rank=rank, slot=slot)


def _scaled(data: dict, horizon: float) -> dict:
    """``data`` cut to ``horizon`` seconds, its events' times scaled with it."""
    data = copy.deepcopy(data)
    scale = horizon / data["sim_settings"]["total_simulation_time"]
    data["sim_settings"]["total_simulation_time"] = horizon
    for event in data.get("events") or []:
        event["start"]["t_start"] *= scale
        event["end"]["t_end"] *= scale
    return data


#: both servers down from 8 s to 10 s, srv-1 back and down again at 10 s
#: (its END before its START), up at 11 s, srv-2 up at 12 s: the schema
#: refuses a payload with no server up, so the marks are set on the plans
ALL_DOWN_MARKS = {
    "timeline_times": np.array([5.0, 8.0, 10.0, 10.0, 11.0, 12.0], np.float32),
    "timeline_down": np.array([1, 1, 0, 1, 0, 0], np.int32),
    "timeline_slot": np.array([0, 1, 0, 0, 0, 1], np.int32),
}


ENGINE_CASES = {
    "outage": lambda: mutated("outage", horizon=20),
    "event_inj_lb_60s": lambda: _scaled(example("event_inj_lb"), 60.0),
    "all_down": lambda: mutated("outage", horizon=20),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_fast_engine_matches_reference_under_outages(name: str) -> None:
    marks = ALL_DOWN_MARKS if name == "all_down" else {}
    ref, got, plan = run_both(ENGINE_CASES[name](), 4, seed=3,
                              transform=lambda p: dataclasses.replace(p, **marks))
    assert plan.has_timeline
    assert_matches_reference(ref, got, plan, name)
    if name == "all_down":
        # the LB dropped the requests that found no healthy server
        assert int(got.n_dropped.sum()) > 40
