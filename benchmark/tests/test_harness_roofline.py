"""Each roofline count against shapes worked by hand."""

import torch

from vobench import cells, kerneltime


def test_fast_counts_bytes_and_candidates():
    roof = cells.module("roofline", "fast_score")
    level = torch.zeros(2, 10, 12)
    assert roof.candidates(level) == (2 * 4 * 6, 0)
    level[0, 5, 5] = 100.0  # brighter than its four compass neighbours by more than 20
    interior, passed = roof.candidates(level)
    # It passes (4 darker of 4 >= 9 // 4); so do its compass neighbours 3 px away
    # that lie inside the interior (each sees one brighter neighbour: 1 < 2, fail).
    assert (interior, passed) == (48, 1)
    n_bytes, n_ops = roof.counts(level)
    assert n_bytes == 8 * 2 * 10 * 12
    assert n_ops == 48 * roof.PRETEST_OPS + 1 * roof.RING_OPS


def test_describe_counts_distinct_patch_pixels():
    roof = cells.module("roofline", "orb_describe")
    blur = torch.zeros(1, 64, 64)
    # Two patches overlapping by 31 x 21 pixels, and one in another frame-free corner.
    origins = torch.tensor([[0, 0, 0], [0, 0, 10], [0, 33, 33]], dtype=torch.int32)
    n_bytes, n_ops = roof.counts(blur, origins)
    distinct = 31 * 41 + 31 * 31
    assert n_bytes == 4 * distinct + 12 * 3 + 30 * 256 * 2 * 2 + 36 * 3
    assert n_ops == 3 * (2 * 2 * 1017 + 2 * 256)


def test_match_counts():
    roof = cells.module("roofline", "hamming_match")
    n_bytes, n_ops = roof.counts(2, 4)
    assert n_bytes == 2 * 2 * 4 * 32 + 2 * 2 * 4 + 4 * 2 * 4 * 4
    assert n_ops == 2 * 2 * 4 * 4 * 256


def test_bound_picks_the_larger():
    ms, by = kerneltime.bound_ms(3.35e9, 1.0, kerneltime.F32_OPS_PER_S)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = kerneltime.bound_ms(1.0, 1979e9, kerneltime.INT8_OPS_PER_S)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
