"""The twin's cache, LLM, DB-pool and multi-generator branches against the
reference Pallas kernel.

As in ``tests/test_torch_des_kernel.py``: both packages run the same
payload on the same scenario keys and the same arrival-rate table (the
reference engine's own ``_lam_table``, injected into the port), the
reference through ``PallasEngine(plan, block=8, interpret=True)``, the port
through ``KernelEngine(plan, device="cpu")`` (the twin).

Stated tolerance, the same for every case in ``CASES``: every integer
output (histogram, throughput, counters, truncation flags) equal in every
scenario; the LLM cost sum equal to the last bit (whole token counts times
the same per-token cost, added in the reference's order); the other float
moments within rtol 1e-6 plus one ulp of the horizon (a latency is the
difference of two absolute times).  The twin adds them in the reference's
order too, but XLA's float32 ``log`` and ``exp`` on the CPU round
differently from torch's for about one argument in seven (by one ulp), an
event time that carries such a draw moves by an ulp, and the latency
moments with it; XLA may also fuse ``sum + x * x`` into one rounding.
Seen when this was written: a few scenarios per case off by at most
1.9e-7 relative in ``lat_sum`` and by one ulp of a time near 1 s
(1.2e-7) in ``lat_max``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from test_torch_des_kernel import _event_inj, _lb, _single
from test_torch_plan_workload import cache, db_pool, featured, llm_cost, two_gen
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.compiler import compile_payload as jax_compile
from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_scenario_keys
from asyncflow_tpu.engines.jaxsim.pallas_engine import PallasEngine
from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base_overrides
from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

S = 8
INT_FIELDS = ("hist", "thr", "lat_count", "n_generated", "n_dropped", "n_overflow",
              "n_rejected", "truncated")
#: float moments held to the last bit
EXACT = ("llm_sum",)
#: float moments that carry a libm rounding or a fusable multiply-add
CLOSE = ("lat_sum", "lat_sumsq", "lat_min", "lat_max", "llm_sumsq")
CLOSE_RTOL = 1e-6


def _ulp_of(horizon: float) -> float:
    return float(np.spacing(np.float32(horizon)))


def _two_gen_events() -> dict:
    """The two streams on an 8 s cut of event_inj_lb.yml: outages and
    spikes with the new feature group."""
    data = _event_inj()
    gen = data["rqs_input"]
    gen["avg_active_users"] = {"mean": 20}
    data["rqs_input"] = [gen, {
        "id": "rqs-2",
        "avg_active_users": {"mean": 10},
        "avg_request_per_minute_per_user": {"mean": 60},
        "user_sampling_window": 4,
    }]
    data["topology_graph"]["edges"].append({
        "id": "gen2-client", "source": "rqs-2", "target": "client-1",
        "latency": {"mean": 0.004, "distribution": "normal", "variance": 0.002},
    })
    return data


def _normal_entry() -> dict:
    """Two streams, the first entering over a normal edge: Box-Muller draw
    sites that a wrong entry-chain stride would reuse."""
    data = two_gen(_lb())
    data["topology_graph"]["edges"][0]["latency"] = {
        "mean": 0.004, "distribution": "normal", "variance": 0.002,
    }
    return data


def _stream_overrides(plan) -> dict:
    """(S, G) workload overrides: each scenario scales the two streams
    differently (0.5x to 1.2x)."""
    scale = np.linspace(0.5, 1.2, S * 2, dtype=np.float32).reshape(S, 2)
    base = base_overrides(plan)
    return {"user_mean": base.user_mean[None, :] * scale,
            "req_rate": np.broadcast_to(base.req_rate, (S, 2)).copy()}


CASES = {
    "cache": lambda: (cache(horizon=6), None),
    "llm": lambda: (llm_cost(horizon=6), None),
    "db_pool_k2": lambda: (db_pool(2, horizon=6), None),
    "db_pool_k1": lambda: (db_pool(1, horizon=6, users=24), None),
    "featured": lambda: (featured(), None),
    "two_gen_exponential": lambda: (two_gen(_lb()), None),
    "two_gen_normal_entry": lambda: (_normal_entry(), None),
    "two_gen_stream_overrides": lambda: (two_gen(_lb()), _stream_overrides),
    "two_gen_events": lambda: (_two_gen_events(), None),
}


def _run_both(data: dict, make_overrides=None, *, max_iterations=None):
    jplan = jax_compile(JaxPayload.model_validate(data))
    tplan = compile_payload(SimulationPayload.from_dict(data))
    if max_iterations is not None:
        jplan = dataclasses.replace(jplan, max_iterations=max_iterations)
        tplan = dataclasses.replace(tplan, max_iterations=max_iterations)
    ref = PallasEngine(jplan, block=S, interpret=True)
    keys = jax_scenario_keys(2, S)
    jov = jax_base_overrides(jplan)
    tov = base_overrides(tplan)
    if make_overrides is not None:
        fields = make_overrides(tplan)
        jov = jov._replace(**fields)
        tov = tov._replace(**fields)
    lam = np.asarray(ref._lam_table(keys, jov.user_mean, jov.req_rate))
    want = ref.run_batch(keys, jov if make_overrides is not None else None)
    got = KernelEngine(tplan, device="cpu").run_batch(
        np.asarray(keys), tov if make_overrides is not None else None, lam_table=lam,
    )
    return tplan, want, got


def _assert_agree(want, got, horizon: float) -> None:
    for field in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)).reshape(S, -1),
            np.asarray(getattr(want, field)).reshape(S, -1),
            err_msg=field,
        )
    for field in EXACT:
        np.testing.assert_array_equal(
            getattr(got, field), getattr(want, field), err_msg=field,
        )
    for field in CLOSE:
        np.testing.assert_allclose(
            getattr(got, field), getattr(want, field), rtol=CLOSE_RTOL,
            atol=_ulp_of(horizon), err_msg=field,
        )


@pytest.mark.parametrize("name", list(CASES))
def test_workload_branch_matches_reference(name: str) -> None:
    data, make_overrides = CASES[name]()
    plan, want, got = _run_both(data, make_overrides)
    _assert_agree(want, got, plan.horizon)
    assert want.lat_count.min() > 0
    assert not np.asarray(want.truncated).any()
    if name == "cache":
        # misses (50 ms) and hits (2 ms) both completed
        assert float(np.max(want.lat_max)) > 0.05 > float(np.min(want.lat_min))
    if name in ("llm", "featured"):
        assert plan.has_llm and float(np.min(want.llm_sum)) > 0
    if name.startswith("db_pool") or name == "featured":
        assert plan.has_db_pool
    if name.startswith("two_gen"):
        assert plan.n_generators == 2


def test_truncation_with_every_new_feature() -> None:
    """The featured mix cut at 60 iterations: truncation with LLM, cache
    and DB state in flight."""
    plan, want, got = _run_both(featured(), max_iterations=60)
    _assert_agree(want, got, plan.horizon)
    assert np.asarray(want.truncated).all()


def test_conservation_with_db_waits() -> None:
    """generated = completed + dropped + overflow + rejected + in flight,
    with in flight bounded by the pool, while requests queue for a single
    DB connection (tests/parity/test_pallas_engine.py:
    test_db_pool_conservation)."""
    data = db_pool(1, horizon=6, users=24)
    plan = compile_payload(SimulationPayload.from_dict(data))
    assert plan.has_db_pool
    state = KernelEngine(plan, device="cpu").run_batch(scenario_keys(4, S))
    slack = (state.n_generated - state.lat_count - state.n_dropped
             - state.n_overflow - state.n_rejected)
    assert (slack >= 0).all()
    assert (slack <= plan.pool_size).all()
    assert state.lat_count.sum() > 0.5 * state.n_generated.sum()
