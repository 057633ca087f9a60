"""The gauge grid on the overload and retry payloads, held against the JAX
reference on the CPU, bit for bit (``torch_gauge_cases``): a ready-queue
cap, a retry plan (only the last pass records) and, fine grid only, a
connection cap (its shed and abandoned RAM); and the grouped gauge calls
against their sites one by one."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    example,
    mutated,
    one_torch_thread,
    scaled_events,
    torch_inference_mode,
)
from torch_gauge_cases import check_grid, grid_cases

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import gauge_grid
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

GRID_CASES = grid_cases("overload_cap8", "outage_retry", "overload_sockets")


@pytest.mark.parametrize(("name", "mode"), GRID_CASES)
def test_grid_equals_reference(name: str, mode: str) -> None:
    """``collect_gauges`` (n_samples + 2 rows) and ``gauge_series_stride``
    (n_samples // k + 2 rows) grids equal the JAX FastEngine's, bit for
    bit; the same run without a grid gives every other output unchanged."""
    check_grid(name, mode)


class _SiteBySite:
    """A gauge wrapper that holds each grouped call of the engine to the
    sites it stands for, scattered one by one with ``gauge_add_plain`` on
    the expressions the engine's sites built before the groups existed,
    and then adds the group (its plain version) into the engine's grid."""

    def __init__(self) -> None:
        self.kinds: set = set()

    def _same(self, grid, group, sites) -> None:
        got, want = torch.zeros_like(grid), torch.zeros_like(grid)
        group(got)
        for col, t0, t1, on, amount in sites:
            gauge_grid.gauge_add_plain(want, col, t0, t1, on, amount, self.period)
        assert torch.equal(got, want)
        group(grid)

    def add(self, grid, col, t0, t1, on, amount, period) -> None:
        self.kinds.add("site")
        gauge_grid.gauge_add_plain(grid, col, t0, t1, on, amount, period)

    def add_queue(self, grid, cols, e, w, p, vb, period) -> None:
        self.kinds.add("queue")
        self.period = period
        self._same(grid, lambda x: gauge_grid.gauge_queue_plain(x, cols, e, w, p, vb, period),
                   [(cols[0], e, e + w, vb & (w > 0), 1.0), (cols[1], e - p, e, vb & (p > 0), 1.0)])

    def add_trail(self, grid, cols, start, dep, t, w_ram, mine, ram, period) -> None:
        self.kinds.add("trail")
        self.period = period
        held = t + (torch.zeros_like(t) if w_ram is None else w_ram)
        self._same(grid, lambda x: gauge_grid.gauge_trail_plain(x, cols, start, dep, t, w_ram,
                                                                 mine, ram, period),
                   [(cols[0], start, dep, mine & (dep > start), 1.0),
                    (cols[1], held, dep, mine & (ram > 0), ram)])

    def add_slots(self, grid, cols, t0, t1, ok, period, *, rank=None, slot=None) -> None:
        self.kinds.add("slots")
        self.period = period
        pick = rank % len(cols) if rank is not None else slot
        self._same(grid, lambda x: gauge_grid.gauge_slots_plain(x, cols, t0, t1, ok, period,
                                                                 rank=rank, slot=slot),
                   [(c, t0, t1, ok & (pick == k), 1.0) for k, c in enumerate(cols)])


@pytest.mark.parametrize("name", ["event_inj_lb", "overload_cap8"])
def test_grouped_sites_are_the_sites_one_by_one(name: str) -> None:
    """Every grouped gauge call of a small run (a visit's ready queue and
    pre-IO, a server's trailing IO and RAM, the LB's edges) equals its
    sites scattered one by one as the engine built them before; the grid
    is the plain wrapper's."""
    data = (scaled_events(example("event_inj_lb"), 20) if name == "event_inj_lb"
            else mutated("overload_cap8", horizon=10))
    plan = compile_payload(SimulationPayload.from_dict(data))
    keys = np.asarray([[0, 3], [0, 8]], np.uint32)
    eng = FastEngine(plan, device="cpu", collect_gauges=True)
    eng.gauge = _SiteBySite()
    got = eng.run_batch(keys).gauge
    want = FastEngine(plan, device="cpu", collect_gauges=True).run_batch(keys).gauge
    assert np.array_equal(got, want)
    assert np.abs(got).sum() > 0
    assert eng.gauge.kinds >= ({"queue", "trail", "site"}
                               | ({"slots"} if plan.n_lb_edges else set()))
