"""Port frontend vs the JAX reference on the same numpy inputs (CPU).

The JAX side runs as the JAX package's own tests run it on the CPU: its XLA
functions, plus the Pallas kernels in interpret mode at small shapes. The
port side runs its plain PyTorch twins (CPU tensors never reach a kernel).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.frontend import fast as jfast
from droplet_visual_odometry_tpu.frontend import features as jfeat
from droplet_visual_odometry_tpu.frontend import filters as jfilt
from droplet_visual_odometry_tpu.frontend import orb as jorb
from droplet_visual_odometry_tpu.ops.pallas_fast import fast_score_pallas
from droplet_visual_odometry_tpu.ops.pallas_patches import extract_patches_pallas

from droplet_visual_odometry_tpu_torch.frontend import fast as tfast
from droplet_visual_odometry_tpu_torch.frontend import features as tfeat
from droplet_visual_odometry_tpu_torch.frontend import filters as tfilt
from droplet_visual_odometry_tpu_torch.frontend import orb as torb
from droplet_visual_odometry_tpu_torch.ops import cuda_fast, cuda_patches

torch.set_num_threads(2)


def _image(h, w, seed=0, integer=True):
    """Smooth-ish image with injected bright squares so FAST fires."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 60, size=(h, w)).astype(np.float32)
    for y, x in rng.integers(10, [h - 10, w - 10], size=(25, 2)):
        img[y : y + 4, x : x + 4] += 150.0
    return np.round(img) if integer else img


def _bf16_ulp(v):
    """Spacing of bf16 values at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v).astype(np.float64), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


# --------------------------------------------------------------------------
# Constants
# --------------------------------------------------------------------------


def test_constants_equal():
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    # The reference table is bf16 holding small integers: exact in f32.
    np.testing.assert_array_equal(torb._STEER_W, np.asarray(jorb._STEER_W, np.float32))
    assert tfast.CIRCLE_OFFSETS == jfast.CIRCLE_OFFSETS
    assert tfast.BORDER == jfast.BORDER
    assert (torb.N_BITS, torb.PATCH, torb.HALF, torb.ANGLE_BINS) == (
        jorb.N_BITS, jorb.PATCH, jorb.HALF, jorb.ANGLE_BINS,
    )
    assert (tfeat.N_LEVELS, tfeat.SCALE_FACTOR) == (jfeat.N_LEVELS, jfeat.SCALE_FACTOR)


@pytest.mark.parametrize("h,w", [(1080, 1440), (480, 640), (100, 130)])
@pytest.mark.parametrize("k", [512, 128])
def test_level_shapes_and_budgets_equal(h, w, k):
    assert tfeat.level_shapes(h, w, 4, 1.32) == jfeat.level_shapes(h, w, 4, 1.32)
    assert tfeat.level_budgets(k, 4, 1.32) == jfeat.level_budgets(k, 4, 1.32)


# --------------------------------------------------------------------------
# FAST
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(96, 128), (100, 130)])
def test_fast_score_integer_images_exact(shape):
    """Integer images make every excess sum exact, so the port must equal
    both the XLA function and the Pallas kernel bit for bit."""
    img = _image(*shape)
    ref = np.asarray(jfast.fast_score(jnp.asarray(img), 20.0, 9))
    pal = np.asarray(fast_score_pallas(jnp.asarray(img), 20.0, 9, tile_h=32, interpret=True))
    out = tfast.fast_score(torch.from_numpy(img), 20.0, 9).numpy()
    assert (ref > 0).sum() > 20
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pal)


def test_fast_score_float_images():
    """Same corner set; scores to atol 1e-3 (summation order of the 16
    excesses may differ from XLA's), as tests/test_ops_pallas.py holds Pallas."""
    img = _image(100, 130, seed=1, integer=False)
    ref = np.asarray(jfast.fast_score(jnp.asarray(img), 20.0, 9))
    out = tfast.fast_score(torch.from_numpy(img), 20.0, 9).numpy()
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("thr,arc", [(10.0, 12), (35.0, 9), (20.0, 16), (20.0, 17), (5.0, 3)])
def test_fast_score_threshold_and_arc_variants(thr, arc):
    img = _image(64, 96, seed=3)
    ref = np.asarray(jfast.fast_score(jnp.asarray(img), thr, arc))
    out = tfast.fast_score(torch.from_numpy(img), thr, arc).numpy()
    np.testing.assert_array_equal(out, ref)


def test_fast_score_cuda_wrapper_uses_plain_on_cpu():
    imgs = np.stack([_image(64, 96, seed=s) for s in range(3)])
    before = cuda_fast.LAUNCHES
    out = cuda_fast.fast_score_cuda(torch.from_numpy(imgs), 20.0, 9)
    assert cuda_fast.LAUNCHES == before  # the plain twin ran: no kernel launch
    for i in range(3):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(jfast.fast_score(jnp.asarray(imgs[i]))))


# --------------------------------------------------------------------------
# NMS, top-k, sub-pixel refinement
# --------------------------------------------------------------------------


def _tied_scores(n, h, w, seed):
    """Score maps from a 4-value alphabet: ties everywhere."""
    rng = np.random.default_rng(seed)
    s = rng.choice(np.array([0.0, 0.0, 5.0, 10.0, 20.0], np.float32), size=(n, h, w))
    s[:, :, :3] = 0.0
    return s


@pytest.mark.parametrize("k,h,w", [(64, 48, 64), (300, 40, 50), (16, 8, 12)])
def test_nms_and_topk_with_ties_equal(k, h, w):
    s = _tied_scores(3, h, w, seed=k)
    ref_nms = np.asarray(jax.vmap(jfast.nms3x3)(jnp.asarray(s)))
    out_nms = tfast.nms3x3(torch.from_numpy(s))
    np.testing.assert_array_equal(out_nms.numpy(), ref_nms)
    ref = jax.vmap(lambda m: jfast.select_topk_rows(m, k))(jnp.asarray(ref_nms))
    out = tfast.select_topk_rows(out_nms, k)
    np.testing.assert_array_equal(out.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(out.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))


def test_subpixel_refine_agrees():
    rng = np.random.default_rng(4)
    score = rng.uniform(0, 100, size=(2, 40, 60)).astype(np.float32)
    xy = np.stack(
        [rng.integers(0, 60, size=(2, 50)), rng.integers(0, 40, size=(2, 50))], axis=-1
    ).astype(np.float32)
    ref = np.asarray(jax.vmap(jfast.subpixel_refine)(jnp.asarray(score), jnp.asarray(xy)))
    out = tfast.subpixel_refine(torch.from_numpy(score), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


# --------------------------------------------------------------------------
# Blur and resize
# --------------------------------------------------------------------------


def test_gaussian_blur_bf16_within_one_ulp():
    """The reference's blur is bf16 and XLA fuses its last rounding; the port
    reproduces that, and is held to 1 bf16 ulp of the value (ROADMAP C)."""
    imgs = np.stack([_image(90, 120, seed=s) for s in range(2)])
    ref = np.asarray(
        jax.jit(lambda x: jfilt.gaussian_blur(x, 2.0, 4, compute_dtype=jnp.bfloat16))(jnp.asarray(imgs))
    )
    out = tfilt.gaussian_blur(torch.from_numpy(imgs), 2.0, 4, compute_dtype=torch.bfloat16).numpy()
    differ = int((out != ref).sum())
    print(f"blur: {differ} of {ref.size} pixels differ")
    assert np.all(np.abs(out - ref) <= _bf16_ulp(ref))


def test_gaussian_blur_f32_agrees():
    img = _image(50, 70, seed=2, integer=False)
    ref = np.asarray(jfilt.gaussian_blur(jnp.asarray(img), 1.0, 2))
    out = tfilt.gaussian_blur(torch.from_numpy(img), 1.0, 2).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("new_hw", [(818, 1091), (76, 101), (47, 63)])
def test_resize_bilinear_within_one_ulp(new_hw):
    """bf16 operands, f32 products, bf16 intermediate: held to 1 bf16 ulp of
    the value (f32 summation order differs from XLA's)."""
    h, w = (1080, 1440) if new_hw[0] > 100 else (100, 133)
    rng = np.random.default_rng(5)
    img = np.round(rng.uniform(0, 255, size=(1, h, w))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jfilt.resize_bilinear(x, *new_hw))(jnp.asarray(img)))
    out = tfilt.resize_bilinear(torch.from_numpy(img), *new_hw).numpy()
    differ = int((out != ref).sum())
    print(f"resize to {new_hw}: {differ} of {ref.size} pixels differ")
    assert np.all(np.abs(out - ref) <= _bf16_ulp(ref))


# --------------------------------------------------------------------------
# Patches and describe
# --------------------------------------------------------------------------


def test_extract_patches_plain_equals_pallas():
    rng = np.random.default_rng(11)
    n, h, w = 2, 96, 160
    imgs = rng.uniform(0, 255, size=(n, h, w)).astype(np.float32)
    k = 23  # not a multiple of the Pallas kernel's block
    xy = rng.uniform(0, [w, h], size=(n, k, 2)).astype(np.float32)
    origins = torb.patch_origins(torch.from_numpy(xy), h, w)
    ref = np.asarray(extract_patches_pallas(jnp.asarray(imgs), jnp.asarray(origins.numpy()), interpret=True))
    out = cuda_patches.extract_patches_plain(torch.from_numpy(imgs), origins, check=True).numpy()
    np.testing.assert_array_equal(out, ref)
    # ...and the reference's own origin clamp (orb.extract_patches) gives the same patches.
    np.testing.assert_array_equal(
        out.reshape(n, k, torb.PATCH, torb.PATCH),
        np.asarray(jax.vmap(jorb.extract_patches)(jnp.asarray(imgs), jnp.asarray(xy))),
    )


def test_extract_patches_check_raises_out_of_range():
    imgs = torch.zeros((1, 50, 50))
    bad = torch.tensor([[0, 20, 0]], dtype=torch.int32)  # 20 + 37 > 50
    with pytest.raises(ValueError, match="out of range"):
        cuda_patches.extract_patches_cuda(imgs, bad, check=True)


def test_describe_equals_reference_on_its_blur():
    """Fed the reference's own blurred image and keypoints, descriptor words
    agree except for flips from an atan2 ulp at an exact angle-bin edge
    (orb.py:192-195): counted, and bounded at 0.5% of keypoints."""
    rng = np.random.default_rng(12)
    imgs = np.stack([_image(120, 160, seed=s) for s in range(2)])
    blur = np.asarray(
        jax.jit(lambda x: jfilt.gaussian_blur(x, 2.0, 4, compute_dtype=jnp.bfloat16))(jnp.asarray(imgs))
    )
    xy = rng.integers(0, [160, 120], size=(2, 200, 2)).astype(np.float32)
    ref_d, ref_a = jorb.describe_batch(jnp.asarray(blur), jnp.asarray(xy))
    out_d, out_a = torb.describe_batch(torch.from_numpy(blur.copy()), torch.from_numpy(xy))
    out_words = out_d.numpy().view(np.uint32)
    flips = int(np.any(out_words != np.asarray(ref_d), axis=-1).sum())
    print(f"describe: {flips} of {xy.shape[0] * xy.shape[1]} keypoints differ")
    assert flips <= 0.005 * xy.shape[0] * xy.shape[1]
    np.testing.assert_allclose(out_a.numpy(), np.asarray(ref_a), atol=1e-5)


def test_unpack_bits_pm1_equal():
    rng = np.random.default_rng(13)
    words = rng.integers(0, 2**32, size=(5, 8), dtype=np.uint32)
    ref = np.asarray(jorb.unpack_bits_pm1(jnp.asarray(words), jnp.float32))
    out = torb.unpack_bits_pm1(torch.from_numpy(words.view(np.int32)), torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)


def test_detect_and_describe_batch_equal():
    """The whole ORB frontend on two synthetic-like frames: identical
    keypoints, scores, validity and descriptor words."""
    imgs = np.stack([_image(160, 200, seed=s) for s in (21, 22)])
    ref = jax.device_get(jfeat.detect_and_describe_batch(jnp.asarray(imgs), k=128))
    out = tfeat.detect_and_describe_batch(torch.from_numpy(imgs), k=128)
    np.testing.assert_allclose(out.xy.numpy(), np.asarray(ref.xy), atol=1e-4)
    np.testing.assert_array_equal(out.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    differ = np.any(out.desc.numpy().view(np.uint32) != np.asarray(ref.desc), axis=-1)
    print(f"detect_and_describe: {int(differ.sum())} of {differ.size} descriptors differ")
    assert differ.sum() <= 0.005 * differ.size


def test_frontend_modes_not_ported_raise():
    with pytest.raises(NotImplementedError, match="A12"):
        tfeat.detect_and_describe_batch(torch.zeros((1, 64, 64)), mode="sift")
