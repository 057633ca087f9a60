"""The port's FastEngine against the JAX reference's on the CPU, with the
reference's window draws injected, on the server shapes of the slice: the
binding RAM of single_server.yml (the joint RAM and core scan), two cores
with two bursts an endpoint and weighted endpoints (the Kiefer-Wolfowitz
relaxation), a server chain, and IO-only endpoints.  Tolerances in
``torch_fast_cases.assert_matches_reference``."""

from __future__ import annotations

import pytest
from torch_fast_cases import assert_matches_reference, example, mutated, run_both

CASES = {
    "single_server": lambda: example("single_server", horizon=60),
    "two_core_multi_burst": lambda: mutated("two_core_multi_burst", horizon=30),
    "server_chain": lambda: mutated("server_chain", horizon=40),
    "mixed_io_only": lambda: mutated("mixed_io_only", horizon=30),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fast_engine_matches_reference(name: str) -> None:
    ref, got, plan = run_both(CASES[name](), 6, seed=4)
    assert_matches_reference(ref, got, plan, name)
    if name == "single_server":
        assert plan.ram_slots.tolist() == [20]
    if name == "two_core_multi_burst":
        assert plan.max_bursts == 2 and plan.server_cores.tolist() == [2]

