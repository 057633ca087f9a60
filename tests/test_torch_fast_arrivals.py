"""The fast path's arrivals against the JAX reference on the CPU: XLA's CPU
``log1p`` (:func:`draws.log1p_xla`) on every uniform a gap can draw, XLA's
CPU ``cumsum`` order (:func:`draws.prefix_sum_xla`), both bit for bit; and
the port's own per-window count sampler (``FastEngine._counts``) held to
Poisson by a chi-square test."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    assert_poisson,
    example,
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import draws
from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

#: every float32 a uniform takes: k / 2**23
UNIFORMS = torch.arange(2**23, dtype=torch.float64).div(2**23).float()


@pytest.mark.parametrize("branch", ["rational", "log"])
def test_log1p_xla_is_jnp_log1p_on_every_uniform(branch: str) -> None:
    """-u for each of the 2**23 uniforms: |x| < sqrt(2) - 1 takes Cephes'
    rational form (3,474,676 inputs), the rest XLA's ``log(1 + x)``
    (4,913,932)."""
    x = -UNIFORMS
    small = x.abs() < draws.LOG1P_SMALL
    x = x[small] if branch == "rational" else x[~small]
    assert x.numel() == {"rational": 3_474_676, "log": 4_913_932}[branch]
    want = np.asarray(jax.jit(jnp.log1p)(x.numpy()))
    got = draws.log1p_xla(x).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [16, 17, 1000, 20280])
def test_prefix_sum_is_jax_cumsum(n: int) -> None:
    """Rows of exponential gaps through ``jax.vmap(jnp.cumsum)`` (XLA's
    blocked scan of base 16), bit for bit; a sequential float32 sum is
    not that order once a row's second block holds two lanes."""
    x = (-np.log1p(-np.random.default_rng(n).random((8, n)))).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(x))
    got = draws.prefix_sum_xla(torch.as_tensor(x)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # up to 17 lanes the order is the sequential one; past it, it is not
    sequential = np.cumsum(x, axis=1, dtype=np.float32)
    assert np.array_equal(sequential, want) == (n <= 17)


@pytest.mark.parametrize("mean", [1.0, 30.0, 8000.0])
def test_count_sampler_is_poisson(mean: float) -> None:
    """40,000 window counts (4,000 keys x 10 windows) at a fixed window
    mean: 1, 30, and the headline's ~8,000 a 60 s window, held to
    Poisson(mean) (``torch_fast_cases.assert_poisson``)."""
    plan = compile_payload(SimulationPayload.from_dict(example("single_server", horizon=600)))
    eng = FastEngine(plan, device="cpu")
    s, nw = 4000, eng.n_windows
    _, _, lens = eng._window_lens()
    assert nw == 10 and float(lens.min()) == 60.0
    lam = torch.full((s, nw), mean, dtype=torch.float32) / lens
    counts = eng._counts(scenario_keys(21, s), lam).numpy().ravel()
    window_means = (lam * lens).double().numpy().ravel()
    mu = float(np.mean(window_means))
    assert abs(mu - mean) <= 1e-3 * mean
    assert_poisson(counts, mu)
