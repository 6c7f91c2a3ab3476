"""Hamming match reductions, plain torch: a frozen copy of the port's
`match_reductions_plain` (droplet_visual_odometry_tpu_torch/ops/cuda_match.py),
which equals its CUDA kernel exactly. Every device runs the plain twin."""

from __future__ import annotations

import torch


N_BITS = 256  # bits per descriptor: 8 words of 32
BIG = 1e9  # reported distance of an invalid entry
_INVALID = 512.0  # in-kernel distance of an invalid entry, above every real one
MAX_K = 4096  # the packed column key holds the row in 12 bits



def unpack_bits_pm1(desc: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 256) in {-1, +1}: dot(a, b) = 256 - 2*hamming(a, b)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[..., :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[:-1] + (N_BITS,))
    return (bits.to(torch.float32) * 2.0 - 1.0).to(dtype)


def hamming_matrix(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor | None = None,
    valid_b: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., Ka, 8) x (..., Kb, 8) packed descriptors -> (..., Ka, Kb) float32
    Hamming distances from an exact +-1 f32 matmul; invalid rows/cols are BIG."""
    a = unpack_bits_pm1(desc_a, torch.float32)
    b = unpack_bits_pm1(desc_b, torch.float32)
    ham = 0.5 * (N_BITS - a @ b.transpose(-1, -2))
    if valid_a is not None:
        ham = torch.where(valid_a[..., :, None], ham, torch.full_like(ham, BIG))
    if valid_b is not None:
        ham = torch.where(valid_b[..., None, :], ham, torch.full_like(ham, BIG))
    return ham


def match_reductions_plain(
    desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a: torch.Tensor, valid_b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., K, 8) x (..., K, 8) packed descriptors + (..., K) masks ->
    (d1, i1, d2, col_best), each (..., K): `hamming_matrix`, then row argmin,
    second min and column argmin (torch's argmin returns the first minimum,
    so ties go to the lowest index)."""
    dist = hamming_matrix(desc_a, desc_b)
    ok = valid_a.to(torch.bool)[..., :, None] & valid_b.to(torch.bool)[..., None, :]
    dist = torch.where(ok, dist, torch.full_like(dist, _INVALID))
    i1 = torch.argmin(dist, dim=-1)
    d1 = torch.gather(dist, -1, i1[..., None])[..., 0]
    cols = torch.arange(dist.shape[-1], device=dist.device)
    d2 = torch.where(cols == i1[..., None], torch.full_like(dist, 2 * _INVALID), dist).amin(dim=-1)
    col_best = torch.argmin(dist, dim=-2)
    big = torch.full_like(d1, BIG)
    return (
        torch.where(d1 >= _INVALID, big, d1),
        i1.to(torch.int32),
        torch.where(d2 >= _INVALID, big, d2),
        col_best.to(torch.int32),
    )


match_reductions_cuda = match_reductions_plain

