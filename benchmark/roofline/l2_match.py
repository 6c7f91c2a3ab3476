"""The float match reductions of P pairs of K SIFT (or SURF) descriptors of
D floats (droplet_visual_odometry_tpu_torch/csrc/l2_match.cu).

Bytes: both (P, K, D) float32 sets and their (P, K) masks read once, four
(P, K) 4-byte outputs written once. Operations: every row against every
column as a D-term product, 2 * K * K * D a pair, at the float32 rate
outside the tensor cores (the configuration keeps TF32 off). The bound is
the operations.
"""

from vobench.kerneltime import F32_OPS_PER_S

ENTRY = ("droplet_visual_odometry_tpu_torch.ops.cuda_l2match", "l2_match_reductions_cuda")


def counts(p: int, k: int, d: int) -> tuple[float, float]:
    return float(2 * p * k * d * 4 + 2 * p * k + 4 * p * k * 4), 2.0 * p * k * k * d


def calls(inputs: dict):
    da, db, va, vb = inputs["float_pairs"]
    n_bytes, n_ops = counts(da.shape[0], da.shape[1], da.shape[2])
    yield (da, db, va, vb), n_bytes, n_ops, F32_OPS_PER_S
