"""The port's fast-path journey (routing, servers, exits) on the JAX
reference's own arrival times: the arrivals' prefix sums are the one
place the packages round differently by construction, so with them
injected the rest of the pipeline is held close to the reference."""

from __future__ import annotations

import pytest
from torch_fast_cases import example


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

    t, alive, finish, done = (np.asarray(x) for x in jax.vmap(one)(keys))
    eng = FastEngine(compile_payload(SimulationPayload.from_dict(data)), device="cpu")
    got_finish, got_done, _, _ = eng._journey(
        torch.as_tensor(np.asarray(keys).astype(np.int64)),
        eng._overrides(base_overrides(eng.plan), 4),
        torch.as_tensor(t), torch.as_tensor(alive),
    )
    assert np.array_equal(got_done.numpy(), done)
    diff = np.abs(got_finish.numpy() - finish)[done]
    assert diff.max() <= 4 * np.spacing(np.float32(30.0))
