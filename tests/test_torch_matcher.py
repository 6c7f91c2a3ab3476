"""Port matcher vs the JAX reference on the same numpy descriptors (CPU).

The port's match always goes through the match reductions (kernel 3 on
CUDA, its plain twin here); the reference is held both as its Pallas kernel
in interpret mode and as its default XLA path (hamming_matrix + argmins).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from droplet_visual_odometry_tpu.frontend import matcher as jmatch
from droplet_visual_odometry_tpu.ops.pallas_match import match_reductions as pallas_match_reductions

from droplet_visual_odometry_tpu_torch.frontend import matcher as tmatch
from droplet_visual_odometry_tpu_torch.ops import cuda_match

torch.set_num_threads(2)


def _descriptors(p, k, seed, ties=False):
    """(P, K, 8) uint32 words and (P, K) masks; with ties, many rows repeat
    so equal distances (and equal minima) are common."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2**32, size=(p, k, 8), dtype=np.uint32)
    if ties:
        desc = desc[:, rng.integers(0, max(k // 8, 1), size=k)]
        desc[..., 1:] = 0  # distances only from one word: values in [0, 32]
    valid = rng.uniform(size=(p, k)) > 0.2
    return desc, valid


def _t(desc, valid):
    return torch.from_numpy(desc.view(np.int32).copy()), torch.from_numpy(valid)


def _args(da, va, db, vb):
    """(desc_a, desc_b, valid_a, valid_b) torch arguments of the match reductions."""
    (ta, tva), (tb, tvb) = _t(da, va), _t(db, vb)
    return ta, tb, tva, tvb


@pytest.mark.parametrize("k", [128, 512])
@pytest.mark.parametrize("ties", [False, True])
def test_match_reductions_plain_equals_pallas(k, ties):
    da, va = _descriptors(2, k, seed=k, ties=ties)
    db, vb = _descriptors(2, k, seed=k + 1, ties=ties)
    d1, i1, d2, cb = cuda_match.match_reductions_plain(*_args(da, va, db, vb))
    for p in range(2):
        r = pallas_match_reductions(
            jnp.asarray(da[p]), jnp.asarray(db[p]), jnp.asarray(va[p]), jnp.asarray(vb[p]), interpret=True
        )
        r = [np.asarray(x) for x in r]
        np.testing.assert_array_equal(i1[p].numpy(), r[1])
        np.testing.assert_array_equal(cb[p].numpy(), r[3])
        ok1 = r[0] < jmatch.BIG
        np.testing.assert_array_equal(d1[p].numpy() < tmatch.BIG, ok1)
        np.testing.assert_array_equal(d1[p].numpy()[ok1], r[0][ok1])
        ok2 = r[2] < jmatch.BIG
        np.testing.assert_array_equal(d2[p].numpy()[ok2], r[2][ok2])


@pytest.mark.parametrize("k", [128, 512, 2048])
def test_match_reductions_plain_equals_xla_matrix(k):
    """Against the reference's default path: argmin over its Hamming matrix
    (lowest index on ties), row second-min, column argmin."""
    da, va = _descriptors(1, k, seed=3 * k, ties=True)
    db, vb = _descriptors(1, k, seed=3 * k + 1, ties=True)
    dist = np.asarray(jmatch.hamming_matrix(jnp.asarray(da[0]), jnp.asarray(db[0]), jnp.asarray(va[0]), jnp.asarray(vb[0])))
    d1, i1, d2, cb = (x[0].numpy() for x in cuda_match.match_reductions_plain(*_args(da, va, db, vb)))
    np.testing.assert_array_equal(i1, dist.argmin(axis=1))
    np.testing.assert_array_equal(cb, dist.argmin(axis=0))
    ok = dist.min(axis=1) < jmatch.BIG
    np.testing.assert_array_equal(d1[ok], dist.min(axis=1)[ok])
    dn = dist.copy()
    dn[np.arange(k), i1] = np.inf
    ok2 = dn.min(axis=1) < jmatch.BIG
    np.testing.assert_array_equal(d2[ok2], dn.min(axis=1)[ok2])
    assert np.all(d2[~ok2] >= tmatch.BIG)


_U32 = 0xFFFFFFFF


def _row_merge(best, second, ob, os_):
    """csrc/hamming_match.cu:row_merge: (best, second) keys of two disjoint column sets."""
    return torch.minimum(best, ob), torch.minimum(torch.minimum(second, os_), torch.maximum(best, ob))


def _merge_rule_reductions(desc_a, desc_b, valid_a, valid_b, rng):
    """csrc/hamming_match.cu's reductions in plain torch, with its tile merges
    made over random splits and in random orders.

    acc = popc(a & b) (the and-popc bit product); rterm = popc(a) + 257 *
    [row invalid], cterm = popc(b) + 257 * [column invalid], so h' = rterm +
    cterm - 2 * acc. Rows: keys (cterm + 256 - 2 * acc) * 4096 + col, folded
    one column at a time within each part of a random column split, the
    parts merged by the rule (min of bests; min of seconds and the losing
    best), rterm added back at the end. Columns: 16-bit keys (rterm + 256 -
    2 * acc) * 64 + local row within each 64-row tile, min over a random
    split of the tile's rows, widened to (key >> 6 << 12) | row, min over the
    tiles in a random order, cterm added back at the end. A final h' > 256
    decodes to BIG and index 0."""
    a01 = (cuda_match.unpack_bits_pm1(desc_a, torch.float32) + 1) / 2
    b01 = (cuda_match.unpack_bits_pm1(desc_b, torch.float32) + 1) / 2
    acc = (a01 @ b01.transpose(-1, -2)).to(torch.int64)
    rterm = a01.sum(-1).to(torch.int64) + 257 * (~valid_a).to(torch.int64)
    cterm = b01.sum(-1).to(torch.int64) + 257 * (~valid_b).to(torch.int64)
    p, k = rterm.shape
    idx = torch.arange(k)

    row_key = (cterm[..., None, :] + 256 - 2 * acc) * 4096 + idx
    best = torch.full((p, k), _U32, dtype=torch.int64)
    second = best.clone()
    cuts = np.sort(rng.choice(np.arange(1, k), size=min(5, k - 1), replace=False)) if k > 1 else []
    parts = np.split(rng.permutation(k), cuts)
    for part in rng.permutation(len(parts)):
        pb = torch.full((p, k), _U32, dtype=torch.int64)
        ps = pb.clone()
        for c in parts[part]:
            pb, ps = _row_merge(pb, ps, row_key[..., c], torch.full_like(pb, _U32))
        best, second = _row_merge(best, second, pb, ps)

    col = torch.full((p, k), _U32, dtype=torch.int64)
    for row0 in rng.permutation(range(0, k, 64)):
        rows = np.arange(row0, min(row0 + 64, k))
        key16 = (rterm[:, rows, None] + 256 - 2 * acc[:, rows, :]) * 64 + torch.from_numpy(rows - row0)[None, :, None]
        assert int(key16.min()) >= 0 and int(key16.max()) < 2**16
        tile = torch.full((p, k), 2**16 - 1, dtype=torch.int64)
        for sub in np.array_split(rng.permutation(len(rows)), 3):
            if len(sub):
                tile = torch.minimum(tile, key16[:, sub, :].amin(1))
        col = torch.minimum(col, ((tile >> 6) << 12) | (row0 + (tile & 63)))

    big = torch.full((p, k), cuda_match.BIG)
    h1 = (best >> 12) - 256 + rterm
    h2 = (second >> 12) - 256 + rterm
    hc = (col >> 12) - 256 + cterm
    d1 = torch.where(h1 <= 256, h1.to(torch.float32), big)
    i1 = torch.where(h1 <= 256, best & 4095, torch.zeros_like(best)).to(torch.int32)
    d2 = torch.where(h2 <= 256, h2.to(torch.float32), big)
    cb = torch.where(hc <= 256, col & 4095, torch.zeros_like(col)).to(torch.int32)
    return d1, i1, d2, cb


@pytest.mark.parametrize("k", [100, 512])
def test_kernel_merge_rule_equals_plain(k):
    """csrc/hamming_match.cu's tile-merge algebra, in plain torch over random
    column and row splits, equals match_reductions_plain exactly on tie-heavy
    inputs, with a pair that has no valid row and one with no valid column."""
    da, va = _descriptors(3, k, seed=11 * k, ties=True)
    db, vb = _descriptors(3, k, seed=11 * k + 1, ties=True)
    va[1] = False
    vb[2] = False
    args = _args(da, va, db, vb)
    got = _merge_rule_reductions(*args, np.random.default_rng(k))
    for g, w in zip(got, cuda_match.match_reductions_plain(*args)):
        assert torch.equal(g, w)


def test_hamming_matrix_equal():
    da, va = _descriptors(1, 96, seed=5)
    db, vb = _descriptors(1, 80, seed=6)
    ref = np.asarray(jmatch.hamming_matrix(jnp.asarray(da[0]), jnp.asarray(db[0]), jnp.asarray(va[0]), jnp.asarray(vb[0])))
    ta, tva = _t(da, va)
    tb, tvb = _t(db, vb)
    np.testing.assert_array_equal(tmatch.hamming_matrix(ta[0], tb[0], tva[0], tvb[0]).numpy(), ref)


@pytest.mark.parametrize("mode", ["crosscheck", "ratio"])
@pytest.mark.parametrize("k,ties", [(128, False), (128, True), (512, True)])
def test_match_equals_reference(mode, k, ties):
    """Batched port match vs the reference's default (XLA) match per pair:
    the same validity, and the same index and distance where valid."""
    da, va = _descriptors(3, k, seed=k + 7, ties=ties)
    db, vb = _descriptors(3, k, seed=k + 8, ties=ties)
    out = tmatch.match(*_args(da, va, db, vb), mode=mode)
    for p in range(3):
        ref = jmatch.match(jnp.asarray(da[p]), jnp.asarray(db[p]), jnp.asarray(va[p]), jnp.asarray(vb[p]), mode=mode)
        sel = np.asarray(ref.valid)
        np.testing.assert_array_equal(out.valid[p].numpy(), sel)
        np.testing.assert_array_equal(out.idx[p].numpy()[sel], np.asarray(ref.idx)[sel])
        np.testing.assert_array_equal(out.distance[p].numpy()[sel], np.asarray(ref.distance)[sel])


@pytest.mark.parametrize("mode", ["crosscheck", "ratio"])
def test_matrix_matchers_equal(mode):
    """match_crosscheck / match_ratio on a tied distance matrix with BIG rows."""
    rng = np.random.default_rng(9)
    dist = rng.integers(0, 6, size=(40, 50)).astype(np.float32)
    dist[rng.uniform(size=40) < 0.2] = jmatch.BIG
    fn_j = jmatch.match_crosscheck if mode == "crosscheck" else jmatch.match_ratio
    fn_t = tmatch.match_crosscheck if mode == "crosscheck" else tmatch.match_ratio
    ref = fn_j(jnp.asarray(dist))
    out = fn_t(torch.from_numpy(dist))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(out.distance.numpy(), np.asarray(ref.distance))


@pytest.mark.parametrize("mode", ["crosscheck", "ratio"])
def test_match_equals_port_matrix_form(mode):
    """The port's batched match (through the match reductions) equals its own
    matrix form, match_crosscheck / match_ratio over hamming_matrix, exactly:
    both are integer distances with lowest-index ties."""
    da, va = _descriptors(3, 256, seed=21, ties=True)
    db, vb = _descriptors(3, 256, seed=22, ties=True)
    ta, tb, tva, tvb = _args(da, va, db, vb)
    out = tmatch.match(ta, tb, tva, tvb, mode=mode)
    fn = tmatch.match_crosscheck if mode == "crosscheck" else tmatch.match_ratio
    ref = fn(tmatch.hamming_matrix(ta, tb, tva, tvb))
    np.testing.assert_array_equal(out.valid.numpy(), ref.valid.numpy())
    sel = ref.valid.numpy()
    np.testing.assert_array_equal(out.idx.numpy()[sel], ref.idx.numpy()[sel])
    np.testing.assert_array_equal(out.distance.numpy()[sel], ref.distance.numpy()[sel])


def test_gather_correspondences_equal():
    rng = np.random.default_rng(10)
    xa = rng.uniform(0, 100, size=(64, 2)).astype(np.float32)
    xb = rng.uniform(0, 100, size=(64, 2)).astype(np.float32)
    idx = rng.integers(0, 64, size=64)
    valid = rng.uniform(size=64) > 0.5
    ref = jmatch.gather_correspondences(
        jnp.asarray(xa), jnp.asarray(xb), jmatch.Matches(jnp.asarray(idx, jnp.int32), jnp.zeros(64), jnp.asarray(valid))
    )
    out = tmatch.gather_correspondences(
        torch.from_numpy(xa), torch.from_numpy(xb),
        tmatch.Matches(torch.from_numpy(idx), torch.zeros(64), torch.from_numpy(valid)),
    )
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_match_wrapper_validates_cuda_inputs():
    """The kernel wrapper raises on inputs it does not take, before any launch."""
    da, va = _t(*_descriptors(1, 16, seed=1))
    with pytest.raises(ValueError):
        cuda_match.match_reductions_cuda(da, da, va, va.to("meta"))
    with pytest.raises(ValueError, match="unknown match mode"):
        tmatch.match(da[None], da[None], va[None], va[None], mode="knn")


@pytest.mark.parametrize("mode", ["crosscheck", "ratio"])
@pytest.mark.parametrize("ka,kb", [(96, 160), (160, 96), (1, 40), (40, 2)])
def test_match_unequal_counts_equals_reference(mode, ka, kb):
    """Ka != Kb, both ways (the smaller set padded with invalid entries for
    the reductions): the same validity as the reference's XLA path per
    pair, and the same index and distance where valid; every index stays
    inside the train set and equals the reference's on every row, invalid
    rows included (their minimum ties over all columns: index 0 in both)."""
    da, va = _descriptors(2, ka, seed=ka + 3 * kb)
    db, vb = _descriptors(2, kb, seed=ka + 5 * kb + 1)
    va[1, : ka // 2] = False  # rows with no valid partner and invalid rows on both sides
    vb[1] = False
    out = tmatch.match(*_args(da, va, db, vb), mode=mode)
    assert out.idx.shape == (2, ka) and int(out.idx.max()) < kb and int(out.idx.min()) >= 0
    for p in range(2):
        ref = jmatch.match(jnp.asarray(da[p]), jnp.asarray(db[p]), jnp.asarray(va[p]), jnp.asarray(vb[p]), mode=mode)
        sel = np.asarray(ref.valid)
        np.testing.assert_array_equal(out.valid[p].numpy(), sel)
        np.testing.assert_array_equal(out.idx[p].numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(out.distance[p].numpy()[sel], np.asarray(ref.distance)[sel])
    assert not out.valid[1].any()
