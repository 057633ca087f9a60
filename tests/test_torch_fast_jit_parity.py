"""The port's fast path against the jitted JAX ``FastEngine`` at full
horizons, on the CPU.

XLA's CPU compiler contracts a float multiply into the add that alone
consumes it inside one fusion: the jitted reference rounds ``starts[win] +
u * lens[win]`` (the arrivals, ``_arrivals_stream``) once where the
windows are not two, and an edge delay's last multiply with the spike or
the send time it is added to.  Run op by op the same program rounds each
operation on its own.  The port fuses the same pairs (``draws.fma_xla``,
``draws.Delay``), so that on the reference's window draws its arrivals are
the jitted reference's bit for bit, its counters equal and its fine gauge
grid equal cell for cell, over the whole 600 s of event_inj_lb (an LB under
outages and spikes), where the unfused arrivals had moved 164 cells.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    example,
    one_torch_thread,
    reference_window_draws,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
from asyncflow_tpu_torch.engines.torchsim.keys import fold_in
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

SEED, N = 4, 2
#: the counters that must be equal (the latency histogram's bins and sums
#: read edge delays through XLA's ``log``, which torch's may round an ulp
#: apart: ``torch_fast_cases.assert_matches_reference``)
COUNTERS = ("n_generated", "n_overflow", "n_dropped", "lat_count", "n_rejected",
            "n_dark_lost", "n_timed_out", "n_retries", "n_budget_exhausted", "att_hist",
            "clock_n")


def _jitted_arrivals(ref_eng, keys) -> np.ndarray:
    """The jitted reference's ``_arrivals`` of each key's stream: the program
    its ``FastEngine`` runs for them."""
    jov = jax_base(ref_eng.plan)
    return np.asarray(jax.jit(jax.vmap(
        lambda k: ref_eng._arrivals(jax.random.fold_in(k, 0), jov)[0]))(keys))


def _port_arrivals(eng: FastEngine, keys, counts) -> np.ndarray:
    kt = torch.as_tensor(np.asarray(keys).astype(np.int64))
    return eng._arrivals(fold_in(kt, 0), torch.as_tensor(counts))[0].numpy()


@pytest.fixture(scope="module")
def event_inj_lb():
    """event_inj_lb at its full 600 s: the jitted reference's run with the
    fine grid, the port's on the reference's window draws, and both
    packages' arrivals."""
    data = example("event_inj_lb")
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    ref_eng = JaxFastEngine(ref_plan, collect_gauges=True)
    keys = jax_keys(SEED, N)
    ref = jax.tree_util.tree_map(np.asarray, ref_eng.run_batch(keys))
    windows = reference_window_draws(ref_plan, np.asarray(keys))
    eng = FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cpu",
                     collect_gauges=True)
    got = eng.run_batch(np.asarray(keys), window_draws=windows)
    return (ref, got, _jitted_arrivals(ref_eng, keys), _port_arrivals(eng, keys, windows[1]),
            ref_plan)


def test_arrivals_are_the_jitted_references(event_inj_lb) -> None:
    _, _, want, got, ref_plan = event_inj_lb
    assert ref_plan.horizon == 600.0
    assert np.isfinite(want).sum() > 50_000
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_counters_are_the_jitted_references(event_inj_lb) -> None:
    ref, got, *_ = event_inj_lb
    for field in COUNTERS:
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(ref, field))
        assert np.array_equal(a.reshape(b.shape), b), field
    assert got.hist.sum() == ref.hist.sum()


def test_fine_grid_is_the_jitted_references(event_inj_lb) -> None:
    """Every cell of the 2 x 12,001 x 12 grid (the unfused arrivals had put
    one interval's end a tick over in 164 of them)."""
    ref, got, *_ = event_inj_lb
    assert got.gauge.shape == ref.gauge.shape == (N, 12_001, 12)
    assert np.abs(got.gauge).sum() > 0
    assert np.array_equal(got.gauge, ref.gauge)


@pytest.mark.parametrize(("name", "horizon"), [("single_server", 300), ("two_servers_lb", 120)])
def test_arrivals_fuse_as_the_jitted_reference(name: str, horizon: float) -> None:
    """single_server at 300 s (five windows: the sum fused) and
    two_servers_lb at 120 s (two windows: the compiler rounds the product
    on its own there) take the jitted reference's arrivals bit for bit."""
    data = example(name, horizon=horizon)
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    keys = jax_keys(SEED, 3)
    want = _jitted_arrivals(JaxFastEngine(ref_plan), keys)
    eng = FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cpu")
    _, counts = reference_window_draws(ref_plan, np.asarray(keys), eng.n_windows)
    got = _port_arrivals(eng, keys, counts)
    assert np.isfinite(want).sum() > 10_000
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
