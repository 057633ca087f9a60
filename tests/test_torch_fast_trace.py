"""The fast path's flight recorder and blame plane on the planes payload
(two generators on the LB, a DB pool and a ready-queue cap on one server,
a binding RAM tier on the other, LB dropout: ``torch_plane_cases``), held
against the jitted JAX ``FastEngine`` with both planes on, on the CPU:
the rings' codes, nodes, counts and times exactly, every counter and the
histogram exactly, the per-request blame rows bit for bit, the pooled
grids within the stated tolerances, and every other output unchanged by
either plane."""

from __future__ import annotations

import numpy as np
import pytest
from torch_fast_cases import one_torch_thread, torch_inference_mode  # noqa: F401 - autouse
from torch_plane_cases import PLANES, check_blame, check_rings, runs

from asyncflow_tpu_torch.observability import decode_flight
from asyncflow_tpu_torch.observability import simtrace as st

one_torch_thread()

#: the codes the planes payload reaches
PLANE_CODES = {st.FR_SPAWN, st.FR_TRANSIT, st.FR_ARRIVE_LB, st.FR_ARRIVE_SRV, st.FR_WAIT_CPU,
               st.FR_WAIT_RAM, st.FR_WAIT_DB, st.FR_RUN, st.FR_REJECT, st.FR_DROP,
               st.FR_COMPLETE}


@pytest.fixture(scope="module")
def planes():
    return runs("planes")


def test_rings_equal_the_jitted_reference(planes) -> None:
    ref, got = planes["ref"], planes["port"]
    check_rings(ref, got, planes["slots"])
    codes = set(np.unique(got.fr_ev).tolist()) - {0}
    assert codes == PLANE_CODES
    # the traced rows are the first requests in arrival order over both
    # streams: spawn times ascend row by row
    spawn = got.fr_t[:, :, 0]
    assert np.all(got.fr_ev[:, :, 0] == st.FR_SPAWN)
    assert np.all(np.diff(spawn, axis=1) >= 0)
    assert set(np.unique(got.fr_node[got.fr_ev == st.FR_SPAWN]).tolist()) == {0, 1}


@pytest.mark.parametrize("field", ["hist", "lat_count", "thr", "clock", "clock_n", "n_generated",
                                   "n_dropped", "n_rejected", "n_overflow", "gauge_means"])
def test_counters_equal_the_jitted_reference(planes, field: str) -> None:
    ref, got = planes["ref"], planes["port"]
    want = np.asarray(getattr(ref, field))
    have = np.asarray(getattr(got, field))
    if field == "gauge_means":
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(have, want)


def test_blame_equals_the_jitted_reference(planes) -> None:
    check_blame(planes["ref"], planes["port"])


@pytest.mark.parametrize("label", ["port", "trace", "blame"])
def test_planes_change_no_other_output(planes, label: str) -> None:
    off, on = planes["off"], planes[label]
    for field in off._fields:
        if field not in PLANES:
            np.testing.assert_array_equal(np.asarray(getattr(on, field)),
                                          np.asarray(getattr(off, field)), err_msg=field)
    both = planes["port"]
    for field in PLANES:
        which = on if (field.startswith("fr_") and label != "blame") or (
            field.startswith("bl_") and label != "trace") else None
        if which is not None:
            np.testing.assert_array_equal(getattr(which, field), getattr(both, field))
        else:
            assert np.asarray(getattr(on, field)).shape[1:] in ((1, 1), (1,))


def test_decoded_records_follow_each_request(planes) -> None:
    got = planes["port"]
    plan = planes["plan"]
    rec = decode_flight(got.fr_ev[0], got.fr_node[0], got.fr_t[0], got.fr_n[0])
    assert sorted(rec) == list(range(got.fr_ev.shape[1]))
    for r in rec.values():
        times = [t for _c, _n, t in r.events]
        assert times == sorted(times) and r.dropped == 0
        assert r.codes()[0] == st.FR_SPAWN
        lines = r.describe(server_ids=plan.server_ids, edge_ids=plan.edge_ids)
        assert len(lines) == len(r.events)
        if r.codes()[-1] == st.FR_COMPLETE:
            assert any("srv-" in line for line in lines)
