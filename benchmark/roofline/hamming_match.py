"""The match reductions of P descriptor-set pairs of K keypoints
(droplet_visual_odometry_tpu_torch/csrc/hamming_match.cu).

Bytes: both (P, K) sets of 32-byte descriptors and their masks read once,
four (P, K) 4-byte outputs written once. Operations: every row against
every column as a 256-bit product, 2 * K * K * 256 a pair, at the dense
int8 tensor-core rate (the data sheet gives no binary rate). The bound is
the operations.
"""

from vobench.kerneltime import INT8_OPS_PER_S

ENTRY = ("droplet_visual_odometry_tpu_torch.ops.cuda_match", "match_reductions_cuda")


def counts(p: int, k: int) -> tuple[float, float]:
    return float(2 * p * k * 32 + 2 * p * k + 4 * p * k * 4), 2.0 * p * k * k * 256


def calls(inputs: dict):
    da, db, va, vb = inputs["pairs"]
    n_bytes, n_ops = counts(da.shape[0], da.shape[1])
    yield (da, db, va, vb), n_bytes, n_ops, INT8_OPS_PER_S
