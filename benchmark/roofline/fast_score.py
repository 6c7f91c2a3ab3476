"""FAST-9 scores of a pyramid level (droplet_visual_odometry_tpu_torch/csrc/fast_score.cu).

Bytes: the float32 level read once and the float32 scores written once.
Operations, as these inputs need them: every interior pixel's compass
pre-test (centre +- threshold, 8 compares, 10 operations) and, for a pixel
that passes it, the 16-pixel ring (7 operations a neighbour) and the max,
at the float32 rate outside the tensor cores. The bound is the bytes.
"""

import torch

from vobench.kerneltime import F32_OPS_PER_S

ENTRY = ("droplet_visual_odometry_tpu_torch.ops.cuda_fast", "fast_score_cuda")
THRESHOLD, ARC = 20.0, 9
PRETEST_OPS = 10
RING_OPS = 16 * 7 + 1
COMPASS = ((-3, 0), (0, 3), (3, 0), (0, -3))  # neighbours 0, 4, 8, 12 of the ring


def candidates(level: torch.Tensor, threshold: float = THRESHOLD, arc: int = ARC) -> tuple[int, int]:
    """(interior pixels, pixels that pass the compass pre-test)."""
    n, h, w = level.shape
    c = level[:, 3:-3, 3:-3]
    nb = torch.zeros_like(c, dtype=torch.int32)
    nd = torch.zeros_like(c, dtype=torch.int32)
    for dy, dx in COMPASS:
        v = level[:, 3 + dy: h - 3 + dy, 3 + dx: w - 3 + dx]
        nb += (v > c + threshold).to(torch.int32)
        nd += (v < c - threshold).to(torch.int32)
    need = 0 if arc < 4 else arc // 4
    return c.numel(), int(((nb >= need) | (nd >= need)).sum())


def counts(level: torch.Tensor) -> tuple[float, float]:
    interior, passed = candidates(level)
    return 8.0 * level.numel(), float(interior * PRETEST_OPS + passed * RING_OPS)


def calls(inputs: dict):
    for level in inputs["levels"]:
        n_bytes, n_ops = counts(level)
        yield (level, THRESHOLD, ARC), n_bytes, n_ops, F32_OPS_PER_S
