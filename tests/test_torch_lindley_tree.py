"""The one-server FIFO in the reference's tree order, on the CPU.

The reference evaluates Lindley's recursion as a max-plus
``jax.lax.associative_scan`` (``fastpath._lindley_waits``); the port's
``station_scan.lindley_plain`` evaluates the same recursion in the same
tree, so its waits equal the jitted reference's bit for bit on rows of any
length with masked lanes anywhere (an all-masked row, a row of one valid
lane, rows near and past capacity).  On the fast path that closes the last
float difference between the two packages' one-server stations: with the
reference's window draws injected, every request's clocks and the latency
histogram equal the jitted JAX ``FastEngine``'s (4 scenarios of 60 s; the
sequential walk had put 27 of 31,357 completion clocks of two_servers_lb
and 298 of 4,890 of cache_around_db, behind a DB pool of one, an ulp or
more off).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    LINDLEY_LENGTHS,
    clock_runs,
    clocks_off,
    example,
    lindley_rows,
    mutated,
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu.engines.jaxsim.fastpath import _lindley_waits
from asyncflow_tpu_torch.engines.torchsim import station_scan

one_torch_thread()

_JITTED = jax.jit(jax.vmap(_lindley_waits))


@pytest.mark.parametrize("m", LINDLEY_LENGTHS)
def test_lindley_plain_is_the_jitted_references(m: int) -> None:
    a, d, v = lindley_rows(m, m)
    want = np.asarray(_JITTED(a, d, v))
    got = station_scan.lindley_plain(*(torch.from_numpy(x) for x in (a, d, v))).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if m > 100:
        assert (want[2:][v[2:]] > 0).mean() > 0.5  # the queue forms


@pytest.mark.parametrize("name", ["two_servers_lb", "cache_around_db"])
def test_fast_path_clocks_are_the_jitted_references(name: str) -> None:
    data = example(name, horizon=60) if name == "two_servers_lb" else mutated(name, horizon=60)
    ref, got = clock_runs(data, 4, 0)
    assert int(np.asarray(ref.clock_n).sum()) > 4000
    assert np.array_equal(np.asarray(got.clock_n), np.asarray(ref.clock_n))
    assert clocks_off(ref, got) == 0
    assert np.array_equal(np.asarray(got.hist), np.asarray(ref.hist))
