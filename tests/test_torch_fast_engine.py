"""The port's FastEngine against the JAX reference's on the CPU, with the
reference's per-window user and count draws injected (the repo's matched
draws method): the headline topology, and the parity suite's normal and
lognormal edge plan with dropout on its LB edges.  Tolerances in
``torch_fast_cases.assert_matches_reference``."""

from __future__ import annotations

import pytest
from torch_fast_cases import assert_matches_reference, example, mutated, run_both

CASES = {
    "two_servers_lb": lambda: example("two_servers_lb", horizon=30),
    "normal_edges": lambda: mutated("normal_edges", horizon=30),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fast_engine_matches_reference(name: str) -> None:
    ref, got, plan = run_both(CASES[name](), 6, seed=3)
    assert_matches_reference(ref, got, plan, name)
