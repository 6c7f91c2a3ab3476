"""The reference's counter-based random numbers (JAX's threefry2x32 with its
default partitionable layout), in torch on any device.

The reference draws some of its random numbers from a fixed key: its
loop-closure verification always splits PRNGKey(0) (loop_closure.py:306),
whatever the run's seed, so those draws are a constant of the algorithm.
The port reproduces them bit for bit with the functions below, which follow
jax._src.prng (threefry_seed, threefry_split, threefry_fold_in,
threefry_random_bits) and jax.random.uniform for float32. uint32 words are
held in int64 tensors and masked after every add and shift.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key (k0, k1); every operand broadcasts."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**32: the words (0, seed)."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.split(key, n): (..., 2) keys -> (..., n, 2)."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(counts), counts)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the counter pair (0, data)."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], zero, zero + (data & _M32))
    return torch.stack([b0, b1], dim=-1)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,)) in float32 on [0, 1): (..., 2) keys ->
    (..., n), the 23 high bits of each 32-bit word as the mantissa."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(counts), counts)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
