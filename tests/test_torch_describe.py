"""The algorithms of the port's FAST and describe kernels, proved on the CPU.

The CUDA kernels (csrc/fast_score.cu, csrc/orb_describe.cu) run only on the
card. What they compute differently from the reference is checked here with
numpy and plain PyTorch, against the port's plain twins and the JAX package:
- FAST's compass pre-test never rejects a pixel that has an arc;
- the describe kernel's pair table is the steering matrix's bit columns, its
  bit layout is `pack_bits`', and its compare form (integer moments, then
  q[p2] > q[p1]) gives the steering-matmul chain's words and angles.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.frontend import filters as jfilt
from droplet_visual_odometry_tpu.frontend import orb as jorb

from droplet_visual_odometry_tpu_torch.frontend import orb as torb
from droplet_visual_odometry_tpu_torch.ops import cuda_describe, cuda_fast

torch.set_num_threads(2)

RINGS = np.arange(1 << 16, dtype=np.uint32)


def _max_circular_run(rings: np.ndarray) -> np.ndarray:
    """Longest cyclic run of set bits in each 16-bit ring (16 for a full ring)."""
    bits = (rings[:, None] >> np.arange(16, dtype=np.uint32)) & 1
    doubled = np.concatenate([bits, bits], axis=1)
    run = np.zeros(len(rings), np.int64)
    best = np.zeros(len(rings), np.int64)
    for i in range(32):
        run = np.where(doubled[:, i] == 1, run + 1, 0)
        best = np.maximum(best, np.minimum(run, 16))
    return best


def _compass_hits(rings: np.ndarray) -> np.ndarray:
    mask = sum(1 << j for j in cuda_fast.COMPASS)
    return np.array([bin(int(r) & mask).count("1") for r in rings])


@pytest.fixture(scope="module")
def ring_runs():
    return _max_circular_run(RINGS), _compass_hits(RINGS)


@pytest.mark.parametrize("arc", range(1, 18))
def test_compass_pretest_is_exact(ring_runs, arc):
    """Over all 65,536 rings: every ring with a cyclic run >= arc has at
    least compass_need(arc) compass hits, so the pre-test rejects no corner;
    and for arcs 1..16 some such ring has exactly that many (the bound is
    tight). No ring has a run above 16, so arc 17 may reject everything."""
    runs, hits = ring_runs
    need = cuda_fast.compass_need(arc)
    has_arc = runs >= arc
    assert np.all(hits[has_arc] >= need)
    if arc <= 16:
        assert need == arc // 4
        assert np.any(hits[has_arc] == need)
    else:
        assert not has_arc.any()


def _image(h, w, seed, integer=True):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 60, size=(h, w)).astype(np.float32)
    for y, x in rng.integers(4, [h - 8, w - 8], size=(h * w // 300, 2)):
        img[y : y + 4, x : x + 4] += 150.0
    return np.round(img) if integer else img


@pytest.mark.parametrize("thr,arc", [(20.0, 9), (10.0, 12), (5.0, 16), (20.0, 5)])
@pytest.mark.parametrize("integer", [True, False])
def test_compass_pretest_keeps_every_corner(thr, arc, integer):
    """On images, the pixels that the pre-test rejects all score 0 in the
    plain twin, and some pixels are rejected: the kernel's two passes give
    the twin's map."""
    img = torch.from_numpy(_image(90, 120, seed=arc, integer=integer))
    score = cuda_fast.fast_score_plain(img, thr, arc)
    need = cuda_fast.compass_need(arc)
    nb = torch.zeros_like(img, dtype=torch.int32)
    nd = torch.zeros_like(img, dtype=torch.int32)
    for j in cuda_fast.COMPASS:
        dy, dx = cuda_fast.CIRCLE_OFFSETS[j]
        v = torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
        nb += (v > img + thr).to(torch.int32)
        nd += (v < img - thr).to(torch.int32)
    rejected = (nb < need) & (nd < need)
    assert (score > 0).sum() > 10 and rejected.sum() > 100
    assert torch.all(score[rejected] == 0)


def test_pair_table_reproduces_steer_columns():
    """Every bit column of the reference's _STEER_W is +1 at the pair's p2,
    -1 at its p1 and 0 elsewhere, or all 0 where p1 == p2."""
    ref = np.asarray(jorb._STEER_W, np.float32)[:, 2:]
    pairs = cuda_describe._PAIRS.astype(np.int64)
    assert pairs.shape == (torb.ANGLE_BINS, torb.N_BITS, 2) and cuda_describe._PAIRS.dtype == np.int16
    cols = np.zeros_like(ref)
    j = np.arange(torb.ANGLE_BINS * torb.N_BITS)
    p1 = pairs[..., 0].reshape(-1)
    p2 = pairs[..., 1].reshape(-1)
    np.add.at(cols, (p2, j), 1.0)
    np.add.at(cols, (p1, j), -1.0)
    np.testing.assert_array_equal(cols, ref)
    coincide = p1 == p2
    assert coincide.any()  # clipping makes some pairs coincide: those bits are always 0
    assert not ref[:, coincide].any()
    assert np.all((ref[:, ~coincide] != 0).sum(axis=0) == 2)


def test_pack_bits_is_natural_layout():
    """Bit j of a descriptor is bit j % 32 of word j // 32, as a warp's
    __ballot_sync over lanes 0..31 of word w gives it."""
    rng = np.random.default_rng(3)
    bits = rng.uniform(size=(50, torb.N_BITS)) > 0.5
    words = (bits.reshape(50, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    out = cuda_describe.pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(out, words.astype(np.uint32))


def _compare_form(imgs: torch.Tensor, origins: torch.Tensor):
    """The describe kernel's algorithm in plain PyTorch: integer disc moments,
    the angle and bin with the kernel's IEEE steps, then q[p2] > q[p1] from
    the pair table, packed in the natural layout."""
    m = origins.shape[0]
    p = torb.PATCH
    q = torch.round(cuda_describe.extract_patches_plain(imgs, origins)).reshape(m, p * p)
    d = torch.arange(p) - torb.HALF
    yy, xx = torch.meshgrid(d, d, indexing="ij")
    disc = yy * yy + xx * xx <= torb.HALF**2
    qi = q.to(torch.int64)
    m01 = (qi * (yy * disc).reshape(-1)).sum(-1)
    m10 = (qi * (xx * disc).reshape(-1)).sum(-1)
    ang = torch.atan2(m01.to(torch.float32), m10.to(torch.float32))
    two_pi = torch.full_like(ang, 2.0 * np.pi)
    b = torch.remainder(torch.round(ang / two_pi * torb.ANGLE_BINS), torb.ANGLE_BINS).to(torch.int64)
    pairs = torch.from_numpy(cuda_describe._PAIRS.astype(np.int64))[b]  # (M, 256, 2)
    bits = torch.gather(q, 1, pairs[..., 1]) > torch.gather(q, 1, pairs[..., 0])
    words = (bits.reshape(m, 8, 32).to(torch.int64) << torch.arange(32)).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32), ang


def _random_origins(rng, n, h, w, m):
    o = np.stack([rng.integers(0, n, m), rng.integers(0, h - 36, m), rng.integers(0, w - 36, m)], axis=1)
    o[:4, 1:] = [[0, 0], [h - 37, w - 37], [0, w - 37], [h - 37, 0]]
    return torch.from_numpy(o.astype(np.int32))


def test_compare_form_equals_describe_plain_on_integer_patches():
    """Random integer images: the compare form gives the steering-matmul
    chain's words and angles exactly, over keypoints in every angle bin and
    on every edge; the JAX describe_batch gives the same up to atan2
    bin-edge flips (none expected on these inputs, at most 0.5% allowed)."""
    rng = np.random.default_rng(21)
    n, h, w, k = 3, 80, 100, 200
    imgs = np.round(rng.uniform(0, 255, size=(n, h, w))).astype(np.float32)
    xy = rng.integers(0, [w, h], size=(n, k, 2)).astype(np.float32)
    xy[:, :4] = [[0, 0], [w - 1, h - 1], [w - 1, 0], [0, h - 1]]
    origins = torb.patch_origins(torch.from_numpy(xy), h, w)
    words, ang = _compare_form(torch.from_numpy(imgs), origins)
    ref_words, ref_ang = cuda_describe.describe_plain(torch.from_numpy(imgs), origins)
    bins = torch.remainder(torch.round(ang / (2 * np.pi) * torb.ANGLE_BINS), torb.ANGLE_BINS)
    assert len(torch.unique(bins)) == torb.ANGLE_BINS
    assert torch.equal(ang, ref_ang)
    assert torch.equal(words, ref_words)
    jd, ja = jorb.describe_batch(jnp.asarray(imgs), jnp.asarray(xy))
    flips = int(np.any(words.numpy().view(np.uint32) != np.asarray(jd).reshape(n * k, 8), axis=-1).sum())
    assert flips <= 0.005 * n * k
    np.testing.assert_allclose(ang.numpy(), np.asarray(ja).reshape(-1), atol=1e-5)


def test_compare_form_equals_reference_on_its_blur():
    """Fed the reference's blurred frames, the compare form equals
    describe_plain exactly and the JAX describe_batch up to flips from an
    atan2 ulp at an exact bin edge (orb.py:192-195), counted and bounded at
    0.5% of keypoints, as test_describe_equals_reference_on_its_blur holds
    the port's describe_batch."""
    rng = np.random.default_rng(22)
    n, h, w, k = 2, 120, 160, 200
    imgs = np.stack([_image(h, w, seed=s) for s in range(n)])
    blur = np.asarray(
        jax.jit(lambda x: jfilt.gaussian_blur(x, 2.0, 4, compute_dtype=jnp.bfloat16))(jnp.asarray(imgs))
    )
    xy = rng.integers(0, [w, h], size=(n, k, 2)).astype(np.float32)
    origins = torb.patch_origins(torch.from_numpy(xy), h, w)
    words, ang = _compare_form(torch.from_numpy(blur.copy()), origins)
    ref_words, ref_ang = cuda_describe.describe_plain(torch.from_numpy(blur.copy()), origins)
    assert torch.equal(words, ref_words) and torch.equal(ang, ref_ang)
    jd, ja = jorb.describe_batch(jnp.asarray(blur), jnp.asarray(xy))
    flips = int(np.any(words.numpy().view(np.uint32) != np.asarray(jd).reshape(n * k, 8), axis=-1).sum())
    print(f"compare form vs JAX: {flips} of {n * k} keypoints differ")
    assert flips <= 0.005 * n * k
    np.testing.assert_allclose(ang.numpy(), np.asarray(ja).reshape(-1), atol=1e-5)


def test_describe_cuda_wrapper_uses_plain_on_cpu():
    rng = np.random.default_rng(23)
    imgs = torch.from_numpy(np.round(rng.uniform(0, 255, size=(2, 60, 70))).astype(np.float32))
    origins = _random_origins(rng, 2, 60, 70, 40)
    before = cuda_describe.LAUNCHES
    words, ang = cuda_describe.describe_cuda(imgs, origins, check=True)
    assert cuda_describe.LAUNCHES == before  # the plain twin ran: no kernel launch
    ref_words, ref_ang = cuda_describe.describe_plain(imgs, origins)
    assert torch.equal(words, ref_words) and torch.equal(ang, ref_ang)
    assert words.shape == (40, 8) and words.dtype == torch.int32 and ang.shape == (40,)
