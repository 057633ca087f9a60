"""Least connections on the fast path, against the JAX reference on the CPU:
``routing.routed_slots_lc_plain`` (the plain version of ``lb_route``'s
least-connections mode) against the reference's
``FastEngine._routed_slots_lc`` on the same injected candidate drops and
delays, with and without an outage timeline and with a ring small enough
to evict; the hop without sums against the hop with them; and the whole
engine on the reference's least-connections fixtures and on
``examples/sweeps/mixed_fleet_sweep.py``'s 24 MB point, fed the
reference's window draws (counters exact,
``torch_fast_cases.assert_matches_reference``)."""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    assert_matches_reference,
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
from asyncflow_tpu_torch.engines.torchsim.params import INF
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

ROOT = Path(__file__).resolve().parents[1]
S, N = 3, 900


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")

#: (mutation, ring override): the plan's own 6-sigma ring, and a ring of 3
#: that the in-flight sends overflow (the earliest delivery is evicted)
SCANS = {
    "least_connections": ("least_connections", None),
    "lc_outage": ("lc_outage", None),
    "small_ring": ("least_connections", 3),
}


@pytest.fixture(scope="module", params=sorted(SCANS))
def scan_case(request):
    name, ring = SCANS[request.param]
    data = mutated(name, horizon=40)
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    plan = compile_payload(SimulationPayload.from_dict(data))
    if ring is not None:
        ref_plan = dataclasses.replace(ref_plan, lc_ring=ring)
        plan = dataclasses.replace(plan, lc_ring=ring)
    assert plan.lc_ring == ref_plan.lc_ring and plan.lb_algo == 1
    return request.param, ref_plan, plan


def _lanes(seed: int, el: int):
    """(t, alive, drop, delay): arrivals over 40 s on a 10 ms grid (ties,
    and arrivals at the marks' times), a tenth dead, a tenth of the
    candidate sends dropped, delays of ~1 s (about 20 in flight a slot)."""
    g = np.random.default_rng(seed)
    t = np.round(g.uniform(0.0, 40.0, (S, N)), 2).astype(np.float32)
    t[:, :4] = np.float32(10.0)
    alive = g.random((S, N)) < 0.9
    t = np.where(alive, t, np.float32(INF)).astype(np.float32)
    drop = g.random((S, N, el)) < 0.1
    delay = g.exponential(1.0, (S, N, el)).astype(np.float32)
    return t, alive, drop, delay


def test_lc_plain_is_the_reference_scan(scan_case) -> None:
    name, ref_plan, plan = scan_case
    el = plan.n_lb_edges
    t, alive, drop, delay = _lanes(7, el)
    eng = JaxFastEngine(ref_plan)
    want, _ = jax.jit(jax.vmap(eng._routed_slots_lc))(t, alive, drop, delay)
    deliver = torch.from_numpy(t)[..., None] + torch.from_numpy(delay)
    got, routed = routing.routed_slots_lc_plain(
        torch.from_numpy(t), torch.from_numpy(alive), torch.from_numpy(drop), deliver,
        torch.from_numpy(plan.timeline_times), torch.from_numpy(plan.timeline_down),
        torch.from_numpy(plan.timeline_slot), el, int(plan.lc_ring))
    assert np.array_equal(got.numpy(), np.asarray(want)), name
    assert torch.equal(routed, got >= 0)
    # both slots take traffic; an outage leaves srv-2's slot none inside it
    picks = got.numpy()
    assert (picks == 0).any() and (picks == 1).any()
    if name == "lc_outage":
        inside = alive & (t > 10.0) & (t < 30.0)
        assert not (picks[inside] == 1).any()


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_candidates_are_the_stacked_hops(slots: int) -> None:
    """Least connections' candidates (``EdgeDraws.candidates``, one call for
    every slot) are each slot's hop, keyed ``32 + slot``, over its edge:
    its t_next and ok in (S, n, slots), the delay rounded before the send
    time is added (the reference stacks the slots' delays first, where a
    hop alone rounds the two once)."""
    plan = compile_payload(SimulationPayload.from_dict(mutated("normal_edges", horizon=5)))
    keys = scenario_keys(3, S)
    g = np.random.default_rng(2)
    t = torch.from_numpy(g.uniform(0.0, 6.0, (S, N)).astype(np.float32))
    alive = torch.from_numpy(g.random((S, N)) < 0.9)
    ne = plan.n_edges
    tables = draws.EdgeTables(
        dist=np.asarray(plan.edge_dist, np.int32),
        mean=torch.from_numpy(np.tile(plan.edge_mean, (S, 1)).astype(np.float32)),
        var=torch.from_numpy(np.tile(plan.edge_var, (S, 1)).astype(np.float32)),
        drop=torch.full((S, ne), 0.2), horizon=plan.horizon)
    edges = [(ne - 1 - k) % ne for k in range(slots)]
    hop_keys = [draws.hop_keys(keys, 32 + k) for k in range(slots)]
    t_next, ok = draws.EdgeDraws().candidates(
        tables, t, alive, torch.stack([k[0] for k in hop_keys], dim=1),
        torch.stack([k[1] for k in hop_keys], dim=1), edges)
    assert t_next.shape == ok.shape == (S, N, slots)
    for k, e in enumerate(edges):
        full = draws.EdgeDraws().hop(tables, t, alive, *hop_keys[k], edge=e)
        bare = draws.hop_plain(tables, t, alive, *hop_keys[k], edge=e, sums=False)
        assert torch.equal(t_next[..., k], bare.t_next) and torch.equal(ok[..., k], full.ok)
        # the two roundings of the send time's add differ by an ulp at most
        gap = (t_next[..., k] - full.t_next).abs()
        assert bool((gap <= torch.finfo(torch.float32).eps * full.t_next.abs()).all())


ENGINE_CASES = {
    "least_connections": lambda: mutated("least_connections", horizon=20),
    "lc_outage": lambda: mutated("lc_outage", horizon=40),
    "lc_discriminates": lambda: mutated("lc_discriminates", horizon=8),
    "mixed_fleet": lambda: chip_smoke.mixed_fleet_payload(24.0, horizon=30),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_fast_engine_matches_reference_under_least_connections(name: str) -> None:
    ref, got, plan = run_both(ENGINE_CASES[name](), 8, seed=5)
    assert plan.lb_algo == 1 and plan.fastpath_ok
    assert_matches_reference(ref, got, plan, name)


def test_mixed_fleet_payload_is_the_example() -> None:
    """The smoke's literal is ``mixed_fleet_sweep.build_payload``; at 24 MB
    the reference takes its fast path (its 320 MB point it declines)."""
    example = _load("mixed_fleet_sweep", ROOT / "examples" / "sweeps" / "mixed_fleet_sweep.py")
    for need in (24.0, 320.0):
        payload = example.build_payload(need, horizon=600)
        assert JaxPayload.model_validate(chip_smoke.mixed_fleet_payload(need, 600)) == payload
    assert jax_compile(example.build_payload(24.0)).fastpath_ok
    assert not jax_compile(example.build_payload(320.0)).fastpath_ok
