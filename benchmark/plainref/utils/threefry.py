"""The reference's counter-based random numbers (JAX's threefry2x32 with its
default partitionable layout), in torch on any device.

Every RANSAC draw of the port comes from here, keyed as the reference keys
it, so a seed gives the JAX package's run: split(PRNGKey(seed), N-1) per
pair (vo.py:189), fold_in(key, start) per streamed chunk (checkpoint.py:127),
fold_in(key, step) per live push (stream.py:112), split(key, B) per batch
(sharding.py:83), fold_in(key, i) per dumped pair (pipeline.py:317), and
loop-closure verification's fixed PRNGKey(0) (loop_closure.py:306). The
functions follow jax._src.prng (threefry_seed, threefry_split,
threefry_fold_in, threefry_random_bits) and jax.random.uniform for float32,
bit for bit. A key is two uint32 words in an int64 tensor of shape (..., 2);
words are masked after every add and shift. The JAX package runs these as
plain element-wise XLA ops, and so does the port: no kernel.
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
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.split(key, n): (..., 2) keys -> (..., n, 2)."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(counts), counts)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the counter pair (0, data).
    data is an int or an int64 tensor that broadcasts against key[..., 0]
    (a device-resident counter, read where the call runs)."""
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


def ransac_uniforms(keys: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The draws of one LO-RANSAC call per key, as the reference makes them
    (ransac.py:88, 188, 205): uniform(key, B*8) for the hypotheses and
    uniform(fold_in(key, r), L*14) for LO round r = 1 (and 2 unless
    cfg.fused_lo_polish). keys (..., 2) -> (u_hyp (..., B*8), u_lo (...,
    rounds, L*14) or None without an LO round). All keys and draws go
    through two threefry calls, however many keys there are."""
    n_hyp = cfg.n_hypotheses * cfg.sample_size
    if cfg.lo_hypotheses <= 0:
        return uniform(keys, n_hyp), None
    n_lo = cfg.lo_hypotheses * cfg.lo_sample_size
    rounds = torch.arange(1, 2 if cfg.fused_lo_polish else 3, dtype=torch.int64, device=keys.device)
    lo_keys = fold_in(keys[..., None, :], rounds)
    # Each word depends only on its key and counter, so one call over the
    # stacked keys with the longer count gives both draws.
    u = uniform(torch.cat([keys[..., None, :], lo_keys], dim=-2), max(n_hyp, n_lo))
    return u[..., 0, :n_hyp], u[..., 1:, :n_lo]
