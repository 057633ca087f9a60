"""The overload controls' station scans on the CPU: the plain versions of
``station_scan``'s controlled and socket modes against the reference's
``_controlled_station_scan`` and ``_socket_station_scan`` (JAX, on the
same float32 rows) bit for bit, waits and flags, over a grid of core
counts, ready-queue caps (none, 1, 8 and the ring's 128), dequeue
deadlines (none, 50 ms) and connection caps (1, 6, 128), on seeded rows
that hold io-only and invalid elements and load the station past its
cores, so that every control binds somewhere on the grid."""

from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.engines.jaxsim import fastpath as ref_fastpath
from asyncflow_tpu_torch.engines.torchsim import station_scan
from asyncflow_tpu_torch.engines.torchsim.params import INF

one_torch_thread()

M = 300
CORES = (1, 2, 4)
CAPS = (-1, 1, 8, 128)
TIMEOUTS = (-1.0, 0.05)
CONNS = (1, 6, 128)

_controlled = jax.jit(ref_fastpath._controlled_station_scan, static_argnums=(3, 4, 5))
_socket = jax.jit(ref_fastpath._socket_station_scan, static_argnums=(6, 7, 8, 9))


def _rows(seed: int, cores: int):
    """(arrival, enqueue, service, post-IO, burst, valid), float32 and bool
    (M,): arrivals at 1.3x the cores' service rate, a fifth invalid (INF),
    a tenth io-only, a 3 ms pre-IO before each burst."""
    g = np.random.default_rng(seed)
    a = np.cumsum(g.exponential(1.0 / (52.0 * cores), M)).astype(np.float32)
    d = g.exponential(1.0 / 40.0, M).astype(np.float32)
    post = g.exponential(1.0 / 20.0, M).astype(np.float32)
    valid = g.random(M) < 0.8
    burst = valid & (g.random(M) < 0.9)
    a = np.where(valid, a, np.float32(INF)).astype(np.float32)
    e = np.where(valid, a + np.float32(0.003), np.float32(INF)).astype(np.float32)
    return a, e, d, post, burst, valid


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))[None]


def _same(got: torch.Tensor, want) -> bool:
    return np.array_equal(got[0].numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize(("cores", "cap", "timeout"),
                         list(itertools.product(CORES, CAPS, TIMEOUTS)))
def test_controlled_plain_is_the_reference_scan(cores: int, cap: int, timeout: float) -> None:
    _a, e, d, _post, burst, _valid = _rows(10 * cores + cap, cores)
    # the controlled scan sees the burst lanes only (io-only ones skip it)
    e = np.where(burst, e, np.float32(INF)).astype(np.float32)
    w_ref, shed_ref, ab_ref = _controlled(e, np.where(burst, d, 0.0).astype(np.float32), burst,
                                          cores, cap, timeout)
    wait, flags = station_scan.controlled_plain(
        _t(e), _t(np.where(burst, d, 0.0).astype(np.float32)), _t(burst), cores, cap, timeout)
    assert _same(wait, w_ref)
    assert np.array_equal((flags[0] & station_scan.FLAG_SHED).bool().numpy(), shed_ref)
    assert np.array_equal((flags[0] & station_scan.FLAG_ABANDONED).bool().numpy(), ab_ref)
    assert not (flags & station_scan.FLAG_REFUSED).any()
    if cap == 1:
        assert bool(np.asarray(shed_ref).any())
    if timeout >= 0 and cap != 1:
        assert bool(np.asarray(ab_ref).any())


@pytest.mark.parametrize(("cores", "conn", "cap", "timeout"),
                         list(itertools.product(CORES, CONNS, CAPS, TIMEOUTS)))
def test_socket_plain_is_the_reference_scan(cores: int, conn: int, cap: int,
                                            timeout: float) -> None:
    a, e, d, post, burst, valid = _rows(100 * cores + 10 * conn + cap, cores)
    ref = _socket(a, e, d, post, burst, valid, cores, conn, cap, timeout)
    wait, flags = station_scan.socket_plain(_t(a), _t(e), _t(d), _t(post), _t(burst),
                                            _t(valid), cores, conn, cap, timeout)
    assert _same(wait, ref[0])
    for bit, want in ((station_scan.FLAG_REFUSED, ref[1]), (station_scan.FLAG_SHED, ref[2]),
                      (station_scan.FLAG_ABANDONED, ref[3])):
        assert np.array_equal((flags[0] & bit).bool().numpy(), np.asarray(want)), bit
    if conn < cores + 2:
        assert bool(np.asarray(ref[1]).any())


def test_cap_below_zero_keeps_the_ring_untested() -> None:
    """With a deadline only the ring is one entry, written and never
    tested: no element is shed however close the grants come."""
    _a, e, d, _post, burst, _valid = _rows(7, 1)
    _wait, flags = station_scan.controlled_plain(_t(e), _t(d), _t(burst), 1, -1, 0.01)
    assert not (flags & station_scan.FLAG_SHED).any()
    assert (flags & station_scan.FLAG_ABANDONED).any()


def test_wrapper_on_cpu_is_the_plain_version() -> None:
    a, e, d, post, burst, valid = _rows(3, 2)
    scan = station_scan.StationScan()
    got = scan.socket(_t(a), _t(e), _t(d), _t(post), _t(burst), _t(valid), 2, 6, 8, 0.05)
    want = station_scan.socket_plain(_t(a), _t(e), _t(d), _t(post), _t(burst), _t(valid), 2,
                                     6, 8, 0.05)
    assert all(torch.equal(x, y) for x, y in zip(got, want, strict=True))
    assert scan.launches == 0
    with pytest.raises(ValueError, match="ring"):
        station_scan._check_cap(station_scan.RING_MAX + 1)
    assert station_scan.walk_of(station_scan.MODE_CONTROLLED, 1, 0) == station_scan.WALK_LANE
    assert station_scan.walk_of(station_scan.MODE_CONTROLLED, 8, 0, 8) == station_scan.WALK_LANE
    assert station_scan.walk_of(station_scan.MODE_CONTROLLED, 1, 0, 9) == station_scan.WALK_WARP
    assert station_scan.walk_of(station_scan.MODE_CONTROLLED, 9, 0) == station_scan.WALK_WARP
    assert station_scan.walk_of(station_scan.MODE_CONTROLLED, 1025, 0) == station_scan.WALK_GLOBAL
    assert station_scan.walk_of(station_scan.MODE_SOCKET, 1, 6, 4) == station_scan.WALK_LANE
    assert station_scan.walk_of(station_scan.MODE_SOCKET, 1, 9, 4) == station_scan.WALK_WARP
    assert station_scan.walk_of(station_scan.MODE_SOCKET, 1025, 6) == station_scan.WALK_GLOBAL
    assert station_scan.walk_of(station_scan.MODE_BUCKET, 1, 0) == station_scan.WALK_WARP
