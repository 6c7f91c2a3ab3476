"""Hamming match reductions: the CUDA kernel csrc/hamming_match.cu and its plain twin.

Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_match.py:
match_reductions. The kernel computes popc(a & b) on the tensor cores
(mma.sync b1 .and.popc on the packed words, exact; hamming = popc(a) +
popc(b) - 2 popc(a & b)), reduces rows and columns in registers on packed
(distance, index) keys, and merges the column minima of a pair's row tiles
through the distributed shared memory of one thread block cluster: one
launch per call, no scratch, no K x K matrix. Bound on the H100:
2*P*K*K*256 operations at the int8 tensor-core rate, 1,979 TOP/s.

Outputs, for P pairs of K descriptors: d1 (P, K) float32 best distance,
i1 (P, K) int32 its column, d2 (P, K) float32 second best, col_best (P, K)
int32 best row per column. Ties go to the lowest index; an entry whose row
or column is invalid counts as 512 and a distance >= 512 is reported as BIG.

Descriptors are int32 tensors holding the reference's uint32 words bit for
bit. Dispatch: CPU tensors go to
`match_reductions_plain`; CUDA tensors go to the kernel, or the call raises.
The plain Hamming matrix (`hamming_matrix`) and the descriptor bit layout
(`N_BITS`, `unpack_bits_pm1`) are defined here once; frontend/orb.py and
frontend/matcher.py re-export them.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.ops import build

N_BITS = 256  # bits per descriptor: 8 words of 32
BIG = 1e9  # reported distance of an invalid entry
_INVALID = 512.0  # in-kernel distance of an invalid entry, above every real one
MAX_K = 4096  # the packed column key holds the row in 12 bits

LAUNCHES = 0  # kernel launches made by match_reductions_cuda


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


def match_reductions_cuda(
    desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a: torch.Tensor, valid_b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, K, 8) int32 x2 + (P, K) bool x2 -> (d1, i1, d2, col_best), each (P, K).

    CUDA tensors run the hand-written kernel; CPU tensors run the plain twin.
    """
    tensors = (desc_a, desc_b, valid_a, valid_b)
    if all(t.device.type == "cpu" for t in tensors):
        return match_reductions_plain(desc_a, desc_b, valid_a, valid_b)
    dev = desc_a.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"match_reductions_cuda: tensors on {[str(t.device) for t in tensors]}")
    if desc_a.dim() != 3 or desc_a.shape[-1] != 8 or desc_b.shape != desc_a.shape:
        raise ValueError(
            f"match_reductions_cuda: need equal (P, K, 8) descriptor sets, got "
            f"{tuple(desc_a.shape)} and {tuple(desc_b.shape)}"
        )
    p, k, _ = desc_a.shape
    if desc_a.dtype != torch.int32 or desc_b.dtype != torch.int32:
        raise ValueError(f"match_reductions_cuda: descriptors must be int32, got {desc_a.dtype}")
    if valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise ValueError("match_reductions_cuda: validity masks must be bool")
    if valid_a.shape != (p, k) or valid_b.shape != (p, k):
        raise ValueError(f"match_reductions_cuda: masks must be ({p}, {k})")
    if not all(t.is_contiguous() for t in (desc_a, desc_b, valid_a, valid_b)):
        raise ValueError("match_reductions_cuda: inputs must be contiguous")
    if k > MAX_K:
        raise ValueError(f"match_reductions_cuda: supports K <= {MAX_K}, got {k}")
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError("match_reductions_cuda: descriptor sets must be 16-byte aligned")

    d1 = torch.empty((p, k), dtype=torch.float32, device=dev)
    d2 = torch.empty_like(d1)
    i1 = torch.empty((p, k), dtype=torch.int32, device=dev)
    col_best = torch.empty_like(i1)
    if p * k == 0:
        return d1, i1, d2, col_best
    global LAUNCHES
    lib = build.library()
    status = lib.dvo_match_reductions(
        desc_a.data_ptr(), desc_b.data_ptr(), valid_a.data_ptr(), valid_b.data_ptr(),
        d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), col_best.data_ptr(),
        p, k, build.current_stream_ptr(dev),
    )
    LAUNCHES += 1
    build.check(status, "dvo_match_reductions")
    return d1, i1, d2, col_best
