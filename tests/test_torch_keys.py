"""The port's threefry2x32 keys against the JAX reference, bit for bit.

The reference kernel's in-kernel generator (``pallas_engine._threefry2x32``,
``_uniform_from_bits``) and its scenario key grid (``engine.scenario_keys``)
are held against the port's int64-masked torch version on the same numpy
uint32 inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_scenario_keys
from asyncflow_tpu.engines.jaxsim.pallas_engine import (
    _threefry2x32 as jax_threefry2x32,
)
from asyncflow_tpu.engines.jaxsim.pallas_engine import (
    _uniform_from_bits as jax_uniform_from_bits,
)
from asyncflow_tpu_torch.engines.torchsim.keys import (
    fold_in,
    keys_as_int32,
    prng_key,
    scenario_keys,
    threefry2x32,
    uniform_from_bits,
)


def _u32(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def test_threefry2x32_matches_reference_block() -> None:
    rng = np.random.default_rng(7)
    k0, k1, x0, x1 = (_u32(rng, 4096) for _ in range(4))
    # edge words: all zeros, all ones, the sign bit
    for arr in (k0, k1, x0, x1):
        arr[:3] = [0, 0xFFFFFFFF, 0x80000000]
    y0, y1 = jax_threefry2x32(
        jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(x0), jnp.asarray(x1),
    )
    z0, z1 = threefry2x32(_t(k0), _t(k1), _t(x0), _t(x1))
    np.testing.assert_array_equal(np.asarray(y0), z0.numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(y1), z1.numpy().astype(np.uint32))


def test_uniform_from_bits_exact() -> None:
    rng = np.random.default_rng(11)
    bits = _u32(rng, 4096)
    bits[:4] = [0, 0xFF, 0x100, 0xFFFFFFFF]
    want = np.asarray(jax_uniform_from_bits(jnp.asarray(bits)))
    got = uniform_from_bits(_t(bits)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want, got)
    assert got.max() < 1.0


@pytest.mark.parametrize("seed", [0, 3, 17, 2**31 - 1])
def test_scenario_keys_bit_equal(seed: int) -> None:
    want = np.asarray(jax.random.key_data(jax_scenario_keys(seed, 64)))
    got = scenario_keys(seed, 64).numpy().astype(np.uint32)
    np.testing.assert_array_equal(want, got)


def test_scenario_keys_prefix_stable_blocks() -> None:
    """Scenario i's key does not depend on the block it is drawn in."""
    whole = scenario_keys(5, 40)
    parts = torch.cat([scenario_keys(5, 17), scenario_keys(5, 23, first=17)])
    assert torch.equal(whole, parts)


def test_fold_in_and_prng_key_match_jax() -> None:
    key = jax.random.PRNGKey(42)
    np.testing.assert_array_equal(np.asarray(key), prng_key(42).numpy())
    for data in (0, 1, 0x77AB, 2**31 + 5, 2**32 - 1):
        want = np.asarray(jax.random.fold_in(key, np.uint32(data)))
        got = fold_in(prng_key(42), data).numpy().astype(np.uint32)
        np.testing.assert_array_equal(want, got)


def test_keys_as_int32_keeps_bits() -> None:
    keys = scenario_keys(9, 256)
    k0, k1 = keys_as_int32(keys)
    assert k0.dtype == torch.int32
    np.testing.assert_array_equal(
        k0.numpy().view(np.uint32), keys[:, 0].numpy().astype(np.uint32),
    )
    np.testing.assert_array_equal(
        k1.numpy().view(np.uint32), keys[:, 1].numpy().astype(np.uint32),
    )
