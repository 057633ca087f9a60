"""The station recursions' plain versions against the JAX reference's
scans on identical time-sorted inputs (numpy, from a seed): the
Kiefer-Wolfowitz waits and the joint RAM and core scan exactly; the
Lindley waits within 4 ulps of the horizon (the reference evaluates the
same recursion as a max-plus ``associative_scan``, whose float sums
associate differently from the sequential walk)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.engines.jaxsim.fastpath import _kw_waits, _lindley_waits, _ram_core_scan
from asyncflow_tpu_torch.engines.torchsim import station_scan

one_torch_thread()

S = 3
HORIZON = 60.0


def _stream(seed: int, m: int, rate: float, svc: float):
    """Sorted arrivals over ~HORIZON s with exponential services; a third
    of the lanes belong to another station (invalid, anywhere), and the
    tail is unused (INF)."""
    g = np.random.default_rng(seed)
    a = np.cumsum(g.exponential(1.0 / rate, (S, m)), axis=1).astype(np.float32)
    d = g.exponential(svc, (S, m)).astype(np.float32)
    v = g.random((S, m)) > 0.33
    v[:, -40:] = False
    a[:, -40:] = 1e30
    return a, d, v


def _jax_rows(fn, *arrays):
    return np.stack([np.asarray(fn(*(jnp.asarray(x[i]) for x in arrays))) for i in range(S)])


def test_lindley_within_4_ulps_of_the_horizon() -> None:
    a, d, v = _stream(1, 4000, rate=80.0, svc=0.011)  # ~0.6 utilisation
    want = _jax_rows(jax.jit(_lindley_waits), a, d, v)
    got = station_scan.lindley_plain(*(torch.as_tensor(x) for x in (a, d, v))).numpy()
    tol = 4 * np.spacing(np.float32(HORIZON))
    assert np.abs(got - want)[v].max() <= tol
    assert (want[v] > 0).mean() > 0.3


@pytest.mark.parametrize("cores", [2, 4])
def test_kw_waits_are_exact(cores: int) -> None:
    a, d, v = _stream(2, 3000, rate=60.0 * cores, svc=0.012)
    want = _jax_rows(lambda x, y, z: _kw_waits(x, y, z, cores), a, d, v)
    got = station_scan.kw_plain(*(torch.as_tensor(x) for x in (a, d, v)), cores).numpy()
    assert np.array_equal(got, want)
    assert (want[v] > 0).mean() > 0.1  # the queue forms


@pytest.mark.parametrize(("ram_k", "cores"), [(1, 1), (4, 1), (6, 3)])
def test_ram_core_scan_is_exact(ram_k: int, cores: int) -> None:
    a, d, v = _stream(3, 2500, rate=50.0, svc=0.006)
    g = np.random.default_rng(4)
    pre = np.full_like(a, 0.002)
    post = g.exponential(1.2 * ram_k / 50.0, a.shape).astype(np.float32)
    d = np.where(g.random(a.shape) < 0.1, 0.0, d).astype(np.float32)  # IO-only lanes
    want = [
        np.stack(rows)
        for rows in zip(*[
            [np.asarray(x) for x in _ram_core_scan(
                jnp.asarray(a[i]), jnp.asarray(pre[i]), jnp.asarray(d[i]),
                jnp.asarray(post[i]), jnp.asarray(v[i]), ram_k, cores)]
            for i in range(S)
        ])
    ]
    got = station_scan.ram_core_plain(
        *(torch.as_tensor(x) for x in (a, pre, d, post, v)), ram_k, cores,
    )
    for x, y in zip(got, want):
        assert np.array_equal(x.numpy(), y)
    assert (want[0][v] > 0).mean() > 0.1  # admission binds


def test_jax_scans_run_on_the_cpu() -> None:
    assert jax.default_backend() == "cpu"
