"""Several generators, DB connection pools and stochastic cache segments on
the fast path, against the JAX reference on the CPU: the whole engine fed
the reference's per-stream window draws (tolerances in
``torch_fast_cases.assert_matches_reference``); each stream's lanes under
an explicit ``max_requests`` as the reference rescales them; the count
sampler held to Poisson on each stream; the DB station's scan in its
Kiefer-Wolfowitz mode for a pool of 2."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    assert_matches_reference,
    assert_poisson,
    mutated,
    one_torch_thread,
    run_both,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.compiler.plan import CACHE_POST_DB, CACHE_PRE_DB
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine, stream_slots
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

#: (mutation, horizon): each cut short
CASES = {
    "two_gen_lb": ("two_gen_lb", 10),
    "db_pool_k2": ("db_pool_k2", 30),
    "cache_mixture": ("cache_mixture", 20),
    "cache_around_db": ("cache_around_db", 20),
}


def _plan(name: str, horizon: float = 10):
    return compile_payload(SimulationPayload.from_dict(mutated(name, horizon=horizon)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fast_engine_matches_reference_on_workloads(name: str) -> None:
    mutation, horizon = CASES[name]
    ref, got, plan = run_both(mutated(mutation, horizon=horizon), 4, seed=5)
    assert plan.fastpath_ok
    assert_matches_reference(ref, got, plan, name)


def test_the_cases_reach_each_piece() -> None:
    """Two streams of their own lanes; a modelled pool of 2; the cache
    extras in every placement."""
    two = _plan("two_gen_lb")
    assert two.n_generators == 2 and FastEngine(two, device="cpu").gen_n == [
        int(x) for x in two.gen_slots]
    assert _plan("db_pool_k2").server_db_pool.tolist() == [2]
    around = _plan("cache_around_db")
    assert around.server_db_pool.tolist() == [1]
    assert sorted(around.fp_cache_slot[0, 0].tolist()) == sorted([0, CACHE_PRE_DB,
                                                                  CACHE_POST_DB])
    assert _plan("cache_mixture").fp_cache_slot[0, 0].tolist() == [CACHE_PRE_DB]


@pytest.mark.parametrize("max_requests", [2, 3, 1001, 2500, 7777])
def test_stream_lanes_rescale_as_the_reference(max_requests: int) -> None:
    data = mutated("two_gen_lb", horizon=10)
    plan = compile_payload(SimulationPayload.from_dict(data))
    ref = JaxFastEngine(jax_compile(JaxPayload.model_validate(data)), max_requests=max_requests)
    got = stream_slots(plan, max_requests)
    assert got == list(ref.gen_n)
    assert sum(got) == max_requests == FastEngine(plan, device="cpu",
                                                  max_requests=max_requests).n
    with pytest.raises(ValueError, match="every stream"):
        stream_slots(plan, 1)


def test_db_pool_of_two_runs_the_kw_scan() -> None:
    """The pool of 2 is a FIFO station of two servers: the scan's
    Kiefer-Wolfowitz mode, whose waits delay departures."""
    eng = FastEngine(_plan("db_pool_k2", 30), device="cpu")
    calls = []
    waits = eng.scan.waits

    def record(a, d, v, cores):
        out = waits(a, d, v, cores)
        calls.append((cores, float(out.max())))
        return out

    eng.scan.waits = record
    eng.run_batch(scenario_keys(2, 3))
    assert calls[-1][0] == 2 and calls[-1][1] > 0.0


@pytest.mark.parametrize("stream", [0, 1])
def test_count_sampler_is_poisson_on_each_stream(stream: int) -> None:
    """Each stream's counts at a fixed window mean of 30: Poisson (the
    chi-square test of ``torch_fast_cases.assert_poisson``), and the two
    streams' draws not the same numbers."""
    eng = FastEngine(_plan("two_gen_lb", 600), device="cpu")
    keys = scenario_keys(23, 4000)

    def counts_of(g: int) -> np.ndarray:
        _, _, lens = eng._window_lens(g)
        lam = torch.full((4000, eng.stream_windows[g]), 30.0, dtype=torch.float32) / lens
        assert abs(float((lam * lens).double().mean()) - 30.0) < 1e-3
        return eng._counts(keys, lam, g).numpy()

    counts = counts_of(stream)
    assert_poisson(counts.ravel(), 30.0)
    assert not np.array_equal(counts[:, :10], counts_of(1 - stream)[:, :10])
