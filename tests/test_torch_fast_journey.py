"""The port's fast-path arrivals and journey against the JAX reference's
on the CPU: the arrival times bit for bit (XLA's CPU ``log1p`` and
``cumsum`` order, given the reference's window counts), and the journey
(routing, servers, exits) on the reference's own arrival times."""

from __future__ import annotations

import pytest
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    example,
    one_torch_thread,
    torch_inference_mode,
)

one_torch_thread()


@pytest.mark.parametrize("name", ["single_server", "two_servers_lb"])
def test_journey_on_the_reference_arrivals(name: str) -> None:
    """Given JAX's own arrival times, the port's journey (routing, servers,
    exits) reproduces the reference's completions exactly and its finish
    times within 4 ulps of the horizon (XLA's and torch's CPU ``log`` may
    round an edge delay differently, and the reference's Lindley sums
    associate differently)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
    from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
    from asyncflow_tpu_torch.schemas import SimulationPayload

    data = example(name, horizon=30)
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    ref_eng, jov = JaxFastEngine(ref_plan), jax_base(ref_plan)
    keys = jax_keys(6, 4)

    def one(key):
        t, alive, _ = ref_eng._arrivals(jax.random.fold_in(key, 0), jov)
        out = ref_eng._journey(key, jov, t, alive, jnp.zeros((1, 1)),
                               jnp.zeros(ref_plan.n_gauges))
        return t, alive, out[0], out[1]

    t, alive, finish, done = (np.asarray(x) for x in jax.jit(jax.vmap(one))(keys))
    eng = FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cpu")
    got_finish, got_done = eng._journey(
        torch.as_tensor(np.asarray(keys).astype(np.int64)),
        eng._overrides(base_overrides(eng.plan), 4),
        [torch.as_tensor(t)], [torch.as_tensor(alive)],
    )[:2]
    assert np.array_equal(got_done.numpy(), done)
    diff = np.abs(got_finish.numpy() - finish)[done]
    assert diff.max() <= 4 * np.spacing(np.float32(30.0))


@pytest.mark.parametrize(("name", "horizon"), [
    ("two_servers_lb", 120), ("single_server", 300), ("heavy_inj_single_server", 300),
])
def test_arrivals_are_the_reference_arrivals(name: str, horizon: float) -> None:
    """Given the reference's per-window counts, ``FastEngine._arrivals``
    returns the reference's ``_arrivals`` times bit for bit: the gaps
    through XLA's ``log1p``, their prefix sum in XLA's order."""
    import jax
    import numpy as np
    import torch

    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
    from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.engines.torchsim.keys import fold_in
    from asyncflow_tpu_torch.schemas import SimulationPayload
    from torch_fast_cases import reference_window_draws

    data = example(name, horizon=horizon)
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    ref_eng, jov = JaxFastEngine(ref_plan), jax_base(ref_plan)
    keys = jax_keys(6, 6)
    want, valid, overflow = (np.asarray(x) for x in jax.vmap(
        lambda k: ref_eng._arrivals(jax.random.fold_in(k, 0), jov))(keys))
    eng = FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cpu")
    _, counts = reference_window_draws(ref_plan, keys, eng.n_windows)
    t, got_valid, got_overflow = eng._arrivals(
        fold_in(torch.as_tensor(np.asarray(keys).astype(np.int64)), 0), torch.as_tensor(counts))
    assert np.array_equal(got_valid.numpy(), valid)
    assert np.array_equal(got_overflow.numpy(), overflow)
    assert valid.sum() > 1000
    assert np.array_equal(t.numpy().view(np.int32), want.view(np.int32))
