"""Float (squared-L2) match reductions: the CUDA kernel csrc/l2_match.cu and its plain twin.

Replaces no TPU kernel: the JAX package matches SIFT and SURF sets with
`l2_matrix` and a sort or argmins over the whole (P, K, K) matrix, outside
any Pallas kernel, which at a deployment's K = 8192 needs over a gigabyte a
pair. The kernel reduces the same matrix without writing it: float32 FMA
products on the CUDA cores (TF32 never), the rows' top two and the
columns' argmins in registers, the columns merged across CTAs by atomicMin
on packed (distance, row) keys. Bound on the H100: 2*P*K*K*D operations at
the float32 rate, 67 TFLOP/s.

Outputs, for P pairs of K descriptors of D floats: d1 (P, K) float32 least
squared distance, i1 (P, K) int32 its column, d2 (P, K) float32 least over
the other columns, col_best (P, K) int32 best row per column. Ties go to
the lowest index; an entry whose row or column is invalid is BIG (1e9), as
in `l2_matrix`, so a line with no valid entry gives BIG at index 0.

Dispatch: CPU tensors go to `l2_match_reductions_plain` (`l2_matrix`, then
the argmins, exactly what the matrix-form matchers read from it); CUDA
tensors go to the kernel, or the call raises. The plain squared-L2 matrix
`l2_matrix` is defined here once; frontend/matcher.py re-exports it.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.ops import build
from droplet_visual_odometry_tpu_torch.ops.cuda_match import BIG

DIMS = (64, 128)  # descriptor lengths the kernel takes: SURF's and SIFT's

LAUNCHES = 0  # kernel launches made by l2_match_reductions_cuda


def l2_matrix(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor | None = None,
    valid_b: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., Ka, D) x (..., Kb, D) float descriptors -> (..., Ka, Kb) squared
    L2 distances |a|^2 + |b|^2 - 2 a.b (one f32 matmul, TF32 off), clamped
    at 0; invalid rows/cols are BIG."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    dot = a @ b.transpose(-1, -2)
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    d2 = torch.clamp(na[..., :, None] + nb[..., None, :] - 2.0 * dot, min=0.0)
    if valid_a is not None:
        d2 = torch.where(valid_a[..., :, None], d2, torch.full_like(d2, BIG))
    if valid_b is not None:
        d2 = torch.where(valid_b[..., None, :], d2, torch.full_like(d2, BIG))
    return d2


def l2_match_reductions_plain(
    desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a: torch.Tensor, valid_b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., K, D) x (..., K, D) float descriptors + (..., K) masks ->
    (d1, i1, d2, col_best), each (..., K): `l2_matrix`, then the row argmin,
    the least distance over the row's other columns and the column argmin
    (torch's argmin returns the first minimum, so ties go to the lowest
    index, as a stable sort's first two entries do)."""
    dist = l2_matrix(desc_a, desc_b, valid_a.to(torch.bool), valid_b.to(torch.bool))
    i1 = torch.argmin(dist, dim=-1)
    d1 = torch.gather(dist, -1, i1[..., None])[..., 0]
    cols = torch.arange(dist.shape[-1], device=dist.device)
    d2 = torch.where(cols == i1[..., None], torch.full_like(dist, torch.inf), dist).amin(dim=-1)
    col_best = torch.argmin(dist, dim=-2)
    return d1, i1.to(torch.int32), d2, col_best.to(torch.int32)


def l2_match_reductions_cuda(
    desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a: torch.Tensor, valid_b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, K, D) float32 x2 + (P, K) bool x2 -> (d1, i1, d2, col_best), each (P, K).

    CUDA tensors run the hand-written kernel; CPU tensors run the plain twin
    (which takes any D and float type). Inputs on one other device are
    checked as the kernel's would be, then refused.
    """
    tensors = (desc_a, desc_b, valid_a, valid_b)
    if all(t.device.type == "cpu" for t in tensors):
        return l2_match_reductions_plain(desc_a, desc_b, valid_a, valid_b)
    dev = desc_a.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"l2_match_reductions_cuda: tensors on {[str(t.device) for t in tensors]}")
    if desc_a.dim() != 3 or desc_a.shape[-1] not in DIMS or desc_b.shape != desc_a.shape:
        raise ValueError(
            f"l2_match_reductions_cuda: need equal (P, K, D) descriptor sets with D in {DIMS}, got "
            f"{tuple(desc_a.shape)} and {tuple(desc_b.shape)}"
        )
    p, k, d = desc_a.shape
    if desc_a.dtype != torch.float32 or desc_b.dtype != torch.float32:
        raise ValueError(f"l2_match_reductions_cuda: descriptors must be float32, got {desc_a.dtype}, {desc_b.dtype}")
    if valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise ValueError("l2_match_reductions_cuda: validity masks must be bool")
    if valid_a.shape != (p, k) or valid_b.shape != (p, k):
        raise ValueError(f"l2_match_reductions_cuda: masks must be ({p}, {k})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("l2_match_reductions_cuda: inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"l2_match_reductions_cuda: no kernel for tensors on {dev}")
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError("l2_match_reductions_cuda: descriptor sets must be 16-byte aligned")

    d1 = torch.empty((p, k), dtype=torch.float32, device=dev)
    d2 = torch.empty_like(d1)
    i1 = torch.empty((p, k), dtype=torch.int32, device=dev)
    col_best = torch.empty_like(i1)
    if p * k == 0:
        return d1, i1, d2, col_best
    scratch = torch.empty(p * k + (p + 1) // 2, dtype=torch.int64, device=dev)  # column keys, then counters
    global LAUNCHES
    lib = build.library()
    status = lib.dvo_l2_match_reductions(
        desc_a.data_ptr(), desc_b.data_ptr(), valid_a.data_ptr(), valid_b.data_ptr(),
        d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), col_best.data_ptr(), scratch.data_ptr(),
        p, k, d, build.current_stream_ptr(dev),
    )
    LAUNCHES += 1
    build.check(status, "dvo_l2_match_reductions")
    return d1, i1, d2, col_best
