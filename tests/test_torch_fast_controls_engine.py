"""The overload controls on the whole fast path, against the JAX fast path on
the CPU: the port's ``FastEngine`` fed the reference's window draws, on
20 s, 16-scenario versions of the documented overload sweeps
(``examples/sweeps/resilience_controls.py``'s rate-limited LB,
``overload_policy.py``'s ready-queue cap of 8, its server under a dequeue
deadline and under a connection cap with a cap and a deadline composed)
and of a retry plan whose shed attempts retry.  Counters exact (the
rejections included), p95 within a histogram bin
(``torch_fast_cases.assert_matches_reference``)."""

from __future__ import annotations

import pytest
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    assert_matches_reference,
    mutated,
    one_torch_thread,
    run_both,
    torch_inference_mode,
)

from asyncflow_tpu_torch.parallel import SweepRunner

one_torch_thread()

CASES = ("rate_limited_lb", "overload_cap8", "overload_deadline", "overload_sockets",
         "retry_queue_cap")


@pytest.mark.parametrize("name", CASES)
def test_fast_engine_matches_reference_under_overload_controls(name: str) -> None:
    ref, got, plan = run_both(mutated(name, horizon=20), 16, seed=3)
    assert plan.fastpath_ok
    assert_matches_reference(ref, got, plan, name)
    # each control binds: some requests are rejected, none by a dark window
    assert int(got.n_rejected.sum()) > 0 and int(got.n_dark_lost.sum()) == 0
    if name == "retry_queue_cap":
        assert int(got.n_retries.sum()) > 0


def test_rejections_keep_requests_conserved() -> None:
    """generated = completed + dropped + overflow + rejected + in flight on
    the socket payload through the sweep plane, which takes the fast path."""
    runner = SweepRunner(mutated("overload_sockets", horizon=10), device="cpu")
    assert runner.engine_kind == "fast"
    res = runner.run(4, seed=1).results
    in_flight = (res.total_generated - res.completed - res.total_dropped
                 - res.overflow_dropped - res.total_rejected)
    assert res.total_rejected.min() > 0
    assert (in_flight >= 0).all()
