"""The fused ORB describe of a level's keypoints (droplet_visual_odometry_tpu_torch/csrc/orb_describe.cu).

Bytes: each distinct float32 pixel under a 31x31 patch read once, the
origins (12 B a keypoint) and the (30, 256, 2) int16 pair table read, 36 B
a keypoint written (eight descriptor words and the angle). Operations: the
two moments and the 30 x 256 steered pair tests, 2 * (2 * 1017 + 2 * 256)
a keypoint, at the float32 rate. The bound is the bytes.
"""

import torch

from vobench.kerneltime import F32_OPS_PER_S

ENTRY = ("droplet_visual_odometry_tpu_torch.ops.cuda_describe", "describe_cuda")
PATCH = 31
PAIR_TABLE_BYTES = 30 * 256 * 2 * 2


def counts(blur: torch.Tensor, origins: torch.Tensor) -> tuple[float, float]:
    m = origins.shape[0]
    covered = torch.zeros(blur.shape, dtype=torch.bool, device=blur.device)
    r = torch.arange(PATCH, device=blur.device)
    o = origins.long()
    covered[o[:, 0, None, None], (o[:, 1, None] + r)[:, :, None], (o[:, 2, None] + r)[:, None, :]] = True
    n_bytes = 4.0 * int(covered.sum()) + 12.0 * m + PAIR_TABLE_BYTES + 36.0 * m
    return n_bytes, float(m * (2 * 2 * 1017 + 2 * 256))


def calls(inputs: dict):
    for blur, origins in zip(inputs["blurs"], inputs["origins"]):
        n_bytes, n_ops = counts(blur, origins)
        yield (blur, origins), n_bytes, n_ops, F32_OPS_PER_S
