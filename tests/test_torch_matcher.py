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
    with pytest.raises(NotImplementedError, match="A12"):
        tmatch.match(torch.zeros((16, 128)), torch.zeros((16, 128)))
