"""Counter-based threefry2x32 keys, bit-identical to ``jax.random``.

A key is a pair of 32-bit words held in an int64 tensor of shape
``(..., 2)`` with values in ``[0, 2**32)``: PyTorch has no uint32 add or
shift on the CPU, so every operation is done in int64 and masked to 32
bits.  ``scenario_keys(seed, n)`` reproduces the reference's
``fold_in(PRNGKey(seed), i)`` grid (``engines/jaxsim/engine.py:
scenario_keys``), so scenario ``i`` gets the same key in both packages and
in every chunking of a sweep.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_C240 = 0x1BD11BDA
_ROTS = (13, 15, 26, 6, 17, 29, 16, 24)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(
    k0: torch.Tensor,
    k1: torch.Tensor,
    x0: torch.Tensor,
    x1: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One 20-round threefry2x32 block; int64 words in [0, 2**32), broadcast."""
    ks = (k0, k1, (k0 ^ k1) ^ _C240)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        rots = _ROTS[:4] if i % 2 == 0 else _ROTS[4:]
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 uniform in [0, 1) with 24-bit resolution."""
    return (bits >> 8).to(torch.int32).to(torch.float32) * (2.0**-24)


def prng_key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & 0xffffffff)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter (0, data) under each key."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def scenario_keys(
    seed: int,
    n: int,
    *,
    first: int = 0,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """(n, 2) keys of scenarios ``first .. first+n-1``: ``fold_in(PRNGKey(seed), i)``."""
    idx = torch.arange(first, first + n, dtype=torch.int64, device=device)
    return fold_in(prng_key(seed, device), idx)


def keys_as_int32(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Key words as int32 tensors holding the same 32 bits (kernel input)."""
    signed = torch.where(keys >= 2**31, keys - 2**32, keys)
    return (
        signed[..., 0].to(torch.int32).contiguous(),
        signed[..., 1].to(torch.int32).contiguous(),
    )
