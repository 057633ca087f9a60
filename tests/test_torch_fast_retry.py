"""The client retry driver on the port's fast path against the JAX
reference on the CPU: the token bucket (``station_scan``'s bucket mode,
plain version) against ``_token_bucket_scan`` exactly; the whole engine on
the resilience guide's outage sweep (shifted outages, per-scenario
timeouts), on a retry storm with jitter, short deadlines and a degraded
edge, on one-attempt deadlines and on trace_parity_resilient, every
counter exact (``torch_fast_cases.assert_matches_reference``); and the
sweep plane: ``auto`` takes the fast path, the DES kernel refuses each
resilience payload by name, and ``make_overrides`` and the sweep refuse
axes the plan cannot honour."""

from __future__ import annotations

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

from asyncflow_tpu.engines.jaxsim.fastpath import _token_bucket_scan
from asyncflow_tpu.parallel.sweep import make_overrides as jax_make_overrides
from asyncflow_tpu_torch.engines.torchsim.station_scan import token_bucket_plain
from asyncflow_tpu_torch.errors import FastPathOverrideError, UnsupportedFeatureError
from asyncflow_tpu_torch.parallel import SweepRunner, make_overrides

one_torch_thread()

S, M = 16, 2001


@pytest.mark.parametrize(("rate", "burst"), [(5.0, 50.0), (0.37, 3.0), (100.0, 1.0),
                                             (0.0, 2.0), (13.3, 7.0)])
def test_token_bucket_matches_reference(rate: float, burst: float) -> None:
    """Rows of sorted times (runs of equal times), a third of the elements
    invalid (INF, as the budget's non-wants): accepted flags exact."""
    g = np.random.default_rng(int(rate * 10) + int(burst))
    t = np.cumsum(g.exponential(1.0 / (1.3 * rate + 1.0), (S, M)), axis=1).astype(np.float32)
    t[:, 100:110] = t[:, 100:101]
    valid = g.random((S, M)) < 0.7
    t = np.where(valid, t, np.float32(1e30))
    want = np.asarray(jax.vmap(lambda a, b: _token_bucket_scan(a, b, rate, burst))(
        jnp.asarray(t), jnp.asarray(valid)))
    got = token_bucket_plain(torch.as_tensor(t), torch.as_tensor(valid), rate, burst)
    assert np.array_equal(got.numpy(), want)
    assert want.any() and (valid & ~want).any()


def _storm() -> dict:
    """Jittered backoff, a budget of 20 refilled at 2/s,
    and the client's edge slowed 30x (and lossy) over [5, 28)."""
    data = mutated("outage_retry", horizon=30)
    data["retry_policy"].update(backoff_base_s=0.05, jitter=0.3,
                                budget_tokens=20, budget_refill_per_s=2.0)
    data["fault_timeline"]["events"].append({
        "fault_id": "slow", "kind": "edge_degrade", "target_id": "client-srv",
        "t_start": 5.0, "t_end": 28.0, "latency_factor": 30.0, "dropout_boost": 0.1,
    })
    return data


def _outage_overrides(n: int, timeouts):
    return lambda plan: jax_make_overrides(plan, n, fault_shift=np.linspace(0.0, 30.0, n),
                                           retry_timeout=timeouts)


CASES = {
    # the guide's sweep at 60 s: the outage slid over [10, 55), timeout 0.5 s
    "outage_retry": (lambda: mutated("outage_retry", horizon=60), 8,
                     _outage_overrides(8, np.full(8, 0.5))),
    "retry_storm": (_storm, 4, _outage_overrides(4, np.linspace(0.02, 0.5, 4))),
    "trace_parity_resilient": (lambda: example("trace_parity_resilient"), 8, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_retry_engine_matches_reference(name: str) -> None:
    make, n, overrides = CASES[name]
    ref, got, plan = run_both(make(), n, seed=2, overrides=overrides)
    assert_matches_reference(ref, got, plan, name)
    assert ref.n_dark_lost.sum() > 0
    assert ref.n_retries.sum() > 0 and ref.att_hist.shape == (n, plan.retry_max_attempts)
    if name == "retry_storm":
        assert ref.n_timed_out.sum() > 0
    if name in ("outage_retry", "retry_storm"):
        assert ref.n_budget_exhausted.sum() > 0


def test_one_attempt_is_the_plain_journey_under_its_deadline() -> None:
    """One attempt and no budget: the lanes are the plan's own (no
    amplification), and a deadline past the horizon never fires, so the
    run equals the plan without a retry policy; a short deadline times
    attempts out, and ends each logical request in its only block."""
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.schemas import SimulationPayload

    def run(policy):
        data = mutated("outage_retry", horizon=30)
        data["retry_policy"] = policy
        if policy is None:
            del data["retry_policy"]
        eng = FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cpu")
        return eng, eng.run_batch(scenario_keys(3, 3))

    plain_eng, plain = run(None)
    eng, late = run({"request_timeout_s": 1000.0, "max_attempts": 1})
    assert eng.n == plain_eng.n and eng.attempts == 1
    for field in ("hist", "lat_count", "n_dropped", "n_dark_lost", "gauge_means"):
        assert np.array_equal(getattr(late, field), getattr(plain, field)), field
    assert late.n_timed_out.sum() == 0 and late.n_retries.sum() == 0
    _, short = run({"request_timeout_s": 0.005, "max_attempts": 1})
    assert short.n_timed_out.sum() > 0 and short.att_hist.shape == (3, 1)
    # completions and timeouts end in block 0, beside the failures
    assert np.all(short.att_hist[:, 0] >= short.lat_count + short.n_timed_out)
    assert short.lat_count.sum() < late.lat_count.sum()


RESILIENCE_PAYLOADS = {
    "chaos_campaign": lambda: example("chaos_campaign"),
    "trace_parity_resilient": lambda: example("trace_parity_resilient"),
    "outage_retry": lambda: mutated("outage_retry", horizon=120),
}


@pytest.mark.parametrize("name", sorted(RESILIENCE_PAYLOADS))
def test_auto_runs_resilience_on_the_fast_path_and_the_kernel_refuses(name: str) -> None:
    assert SweepRunner(RESILIENCE_PAYLOADS[name](), device="cpu").engine_kind == "fast"
    with pytest.raises(UnsupportedFeatureError) as err:
        SweepRunner(RESILIENCE_PAYLOADS[name](), engine="kernel", device="cpu")
    assert err.value.feature == {"chaos_campaign": "hazards"}.get(name, "faults")
    assert "ROADMAP.md" in str(err.value)


def test_retry_sweep_summary() -> None:
    """The summary's retry keys and goodput over spawns and re-issues; a
    chunked sweep equals the whole one."""
    runner = SweepRunner(mutated("outage_retry", horizon=26), device="cpu")
    ov = make_overrides(runner.plan, 3, fault_shift=np.array([-5.0, 0.0, 1.0]),
                        retry_timeout=np.full(3, 0.5))
    report = runner.run(3, seed=1, overrides=ov)
    chunked = runner.run(3, seed=1, overrides=ov, chunk_size=2)
    res = report.results
    for field in ("latency_hist", "total_retries", "attempts_hist", "dark_lost"):
        assert np.array_equal(getattr(res, field), getattr(chunked.results, field)), field
    summary = report.summary()
    assert summary["retries_total"] == int(res.total_retries.sum()) > 0
    assert summary["retry_budget_exhausted_total"] > 0
    assert summary["goodput_fraction"] == pytest.approx(
        summary["completed_total"] / (res.total_generated.sum() + summary["retries_total"]))
    assert res.attempts_hist.shape == (3, 3)
    # shifted times clip at 0; the leading identity row stays at t = 0
    assert ov.fault_srv_times.tolist() == [[0.0, 5.0, 20.0], [0.0, 10.0, 25.0],
                                           [0.0, 11.0, 26.0]]


def test_overrides_the_plan_cannot_honour_are_refused() -> None:
    plain = SweepRunner(example("single_server", horizon=5), device="cpu").plan
    with pytest.raises(ValueError, match="fault_timeline"):
        make_overrides(plain, 4, fault_shift=np.zeros(4))
    with pytest.raises(ValueError, match="retry_policy"):
        make_overrides(plain, 4, retry_timeout=np.full(4, 0.5))
    with pytest.raises(ValueError, match="hazard_model"):
        make_overrides(plain, 4, hazard_scale=np.ones(4))
    runner = SweepRunner(example("single_server", horizon=5), device="cpu")
    base = make_overrides(plain, 2)
    with pytest.raises(FastPathOverrideError, match="retry_policy"):
        runner.run(2, overrides=base._replace(retry_timeout=np.full(2, 0.5, np.float32)))
    chaos = SweepRunner(example("chaos_campaign", horizon=10), device="cpu")
    ov = make_overrides(chaos.plan, 2)
    with pytest.raises(FastPathOverrideError, match="hazard_model"):
        chaos.run(2, overrides=ov._replace(
            fault_edge_times=np.zeros((2, 1), np.float32)))


def test_make_overrides_equals_the_reference() -> None:
    """The resilience axes build the reference's override fields (those it
    sets; it leaves the fault tables' values to the engine)."""
    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload

    data = mutated("outage_retry", horizon=120)
    plan = SweepRunner(data, device="cpu").plan
    axes = {"fault_shift": np.linspace(-20.0, 110.0, 5), "retry_timeout": np.full(5, 0.25)}
    got = make_overrides(plan, 5, **axes)
    want = jax_make_overrides(jax_compile(JaxPayload.model_validate(data)), 5, **axes)
    for name in ("fault_srv_times", "fault_edge_times", "retry_timeout", "hazard_scale",
                 "mttr_scale"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
