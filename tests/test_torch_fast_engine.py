"""The port's FastEngine against the JAX reference's on the CPU, with the
reference's per-window user and count draws injected (the repo's matched
draws method): the headline topology, the parity suite's normal and
lognormal edge plan with dropout on its LB edges, and the two spike
payloads (event_inj_single_server, heavy_inj_single_server) cut to 300 s
so that their spike's start and end both fall inside.  Tolerances in
``torch_fast_cases.assert_matches_reference``."""

from __future__ import annotations

import pytest
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    assert_matches_reference,
    example,
    mutated,
    one_torch_thread,
    run_both,
    torch_inference_mode,
)

one_torch_thread()

CASES = {
    "two_servers_lb": lambda: example("two_servers_lb", horizon=30),
    "normal_edges": lambda: mutated("normal_edges", horizon=30),
    "event_inj_single_server": lambda: example("event_inj_single_server", horizon=300),
    "heavy_inj_single_server": lambda: example("heavy_inj_single_server", horizon=300),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fast_engine_matches_reference(name: str) -> None:
    ref, got, plan = run_both(CASES[name](), 6, seed=3)
    assert_matches_reference(ref, got, plan, name)
