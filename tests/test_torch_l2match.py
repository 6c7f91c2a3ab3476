"""The float match's reductions (ops/cuda_l2match.py) on the CPU: the plain
twin of csrc/l2_match.cu against the matrix-form matchers it replaces in
`matcher.match`, and the wrapper's routing. The kernel itself runs on the
card only (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu_torch.frontend import matcher
from droplet_visual_odometry_tpu_torch.ops import cuda_l2match
from droplet_visual_odometry_tpu_torch.ops.cuda_match import BIG


def _sets(p, ka, kb, d, seed, ties=False, valid_share=0.85):
    """Non-negative unit-norm descriptors (as SIFT's), half of B noisy
    copies of A's rows; with ties, exact duplicates of A's rows and B's
    columns further on, so distances tie bit for bit."""
    rng = np.random.default_rng(seed)
    norm = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    a = norm(np.abs(rng.normal(size=(p, ka, d)))).astype(np.float32)
    b = norm(np.abs(rng.normal(size=(p, kb, d)))).astype(np.float32)
    m = min(ka, kb) // 2
    b[:, :m] = norm(np.abs(a[:, rng.permutation(ka)[:m]] + 0.05 * rng.normal(size=(p, m, d)))).astype(np.float32)
    if ties:
        b[:, kb - 8:] = b[:, :8]
        a[:, ka - 8:] = a[:, :8]
    va = rng.uniform(size=(p, ka)) < valid_share
    vb = rng.uniform(size=(p, kb)) < valid_share
    va[0, :5] = False
    vb[-1, :3] = False
    return tuple(torch.from_numpy(x) for x in (a, b, va, vb))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ties", [False, True])
def test_twin_equals_the_matrix_form(d, ties):
    """The twin's (d1, i1, d2, col_best) are what the matrix form reads off
    `l2_matrix` bit for bit: the stable sort's first two entries (match_ratio)
    and the argmins of rows and columns (match_crosscheck), ties to the lowest
    index, BIG for an invalid line."""
    a, b, va, vb = _sets(3, 96, 96, d, seed=d + ties, ties=ties)
    d1, i1, d2, col_best = cuda_l2match.l2_match_reductions_plain(a, b, va, vb)
    dist = cuda_l2match.l2_matrix(a, b, va, vb)
    order = torch.sort(dist, dim=-1, stable=True)
    assert torch.equal(d1, order.values[..., 0]) and torch.equal(d2, order.values[..., 1])
    assert torch.equal(i1.to(torch.int64), order.indices[..., 0])
    assert torch.equal(col_best.to(torch.int64), torch.argmin(dist, dim=-2))
    assert bool((d1[0, :5] == BIG).all()) and bool((i1[0, :5] == 0).all())
    if ties:
        assert bool((d1 == d2).any())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ka,kb", [(96, 96), (70, 96), (96, 70)])
@pytest.mark.parametrize("mode", ["crosscheck", "ratio"])
def test_float_match_equals_the_matrix_form(d, ka, kb, mode):
    """matcher.match on float sets, now through the reductions (the smaller
    set padded with invalid entries), equals the matrix-form matchers over
    the unpadded `l2_matrix` in every output, bit for bit: the float match
    is unchanged."""
    a, b, va, vb = _sets(3, ka, kb, d, seed=ka + 2 * kb + d, ties=True)
    got = matcher.match(a, b, va, vb, mode=mode, ratio=0.75)
    dist = matcher.l2_matrix(a, b, va, vb)
    if mode == "crosscheck":
        want = matcher.match_crosscheck(dist, max_distance=BIG / 2)
    else:
        want = matcher.match_ratio(dist, ratio=0.75 * 0.75, max_distance=BIG / 2)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert int(got.valid.sum()) > 0


def test_float_match_without_masks_and_in_float64():
    """No masks means every entry valid; float64 sets are matched in float32,
    as `l2_matrix` computes them."""
    a, b, _, _ = _sets(2, 40, 40, 128, seed=3)
    got = matcher.match(a.double(), b.double(), mode="ratio")
    want = matcher.match_ratio(matcher.l2_matrix(a, b), ratio=0.75 * 0.75, max_distance=BIG / 2)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _meta(*ts):
    return tuple(t.to("meta") for t in ts)


@pytest.mark.parametrize("case,message", [
    ("mixed", "tensors on"),
    ("dtype", "must be float32"),
    ("dim", "D in"),
    ("unequal", "equal"),
    ("mask_dtype", "must be bool"),
    ("strided", "contiguous"),
    ("device", "no kernel"),
])
def test_wrapper_routing_refuses_what_the_kernel_does_not_take(case, message):
    """CPU tensors go to the twin; anything else is checked as the kernel
    would take it and refused with the reason (no fallback): a mix of
    devices, float64, D outside (64, 128), unequal sets, non-bool masks,
    non-contiguous sets, and a device without the kernel. The meta device
    stands in for the card."""
    a, b, va, vb = _sets(2, 32, 32, 128, seed=1)
    args = {
        "mixed": (a, b.to("meta"), va, vb),
        "dtype": _meta(a.double(), b.double(), va, vb),
        "dim": _meta(a[..., :96].contiguous(), b[..., :96].contiguous(), va, vb),
        "unequal": _meta(a, b[:, :16].contiguous(), va, vb),
        "mask_dtype": _meta(a, b, va.to(torch.uint8), vb),
        "strided": _meta(a.transpose(0, 1).contiguous().transpose(0, 1), b, va, vb),
        "device": _meta(a, b, va, vb),
    }[case]
    with pytest.raises(ValueError, match=message):
        cuda_l2match.l2_match_reductions_cuda(*args)


def test_cpu_tensors_take_the_twin_without_a_launch():
    a, b, va, vb = _sets(2, 32, 32, 64, seed=2)
    before = cuda_l2match.LAUNCHES
    got = cuda_l2match.l2_match_reductions_cuda(a, b, va, vb)
    want = cuda_l2match.l2_match_reductions_plain(a, b, va, vb)
    assert cuda_l2match.LAUNCHES == before
    assert all(torch.equal(x, y) for x, y in zip(got, want))
