"""The port's SIFT-mode frontend (frontend/sift.py) and float matching vs the
JAX reference (CPU), on the same numpy inputs.

The frames are the synthetic renderer's at 384x288, where three octaves fit
(the smallest is 72 px high). Tolerances are stated per test: keypoints
(positions and validity) are held equal; float responses and descriptors to
a few f32 ulps of their scale, since the reference's XLA program and torch
sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.frontend import filters as jfilt
from droplet_visual_odometry_tpu.frontend import matcher as jmatch
from droplet_visual_odometry_tpu.frontend import sift as jsift
from droplet_visual_odometry_tpu.frontend.features import detect_and_describe_batch as jdetect_batch

from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, run_sequence
from droplet_visual_odometry_tpu_torch.frontend import fast as tfast
from droplet_visual_odometry_tpu_torch.frontend import filters as tfilt
from droplet_visual_odometry_tpu_torch.frontend import matcher as tmatch
from droplet_visual_odometry_tpu_torch.frontend import sift as tsift
from droplet_visual_odometry_tpu_torch.frontend.features import (
    detect_and_describe,
    detect_and_describe_batch,
    level_budgets,
)

torch.set_num_threads(2)

FRAME_CFG = dict(n_frames=2, width=384, height=288, n_landmarks=250)


@pytest.fixture(scope="module")
def frames():
    return jsynth.render_sequence(jsynth.SyntheticConfig(**FRAME_CFG)).frames.astype(np.float32)


def _octaves(img):
    """The reference's octave images of one frame (its downsample2)."""
    out = [jnp.asarray(img)]
    for _ in range(2):
        out.append(jfilt.downsample2(out[-1]))
    return [np.array(o) for o in out]


def _kps_equal(out, ref):
    """out: the port's keypoints of one frame (a batch of 1); ref: the reference's."""
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid[0].numpy(), valid)
    np.testing.assert_array_equal(out.xy[0].numpy()[valid], np.asarray(ref.xy)[valid])
    return int(valid.sum())


def test_tables_equal():
    np.testing.assert_array_equal(tsift._GRID_INDICES, jsift._GRID_INDICES)
    np.testing.assert_array_equal(tsift._CELL_ONEHOT, jsift._CELL_ONEHOT)
    np.testing.assert_array_equal(tsift._SPATIAL_W, jsift._SPATIAL_W)


def test_select_topk_and_downsample2_agree(frames):
    """Flat top-k with ties to the lower index (the score map has runs of
    equal values), and the sigma=1 pyramid step to 1e-4 (f32 blur order)."""
    rng = np.random.default_rng(1)
    score = rng.integers(0, 4, size=(60, 80)).astype(np.float32)
    ref = jsift.select_topk(jnp.asarray(score), 100)
    out = tfast.select_topk(torch.from_numpy(score)[None], 100)
    np.testing.assert_array_equal(out.xy[0].numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(out.score[0].numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(out.valid[0].numpy(), np.asarray(ref.valid))
    ref_d = np.asarray(jfilt.downsample2(jnp.asarray(frames[0])))
    out_d = tfilt.downsample2(torch.from_numpy(frames[:1]))[0].numpy()
    assert out_d.shape == ref_d.shape
    np.testing.assert_allclose(out_d, ref_d, atol=1e-4)


def test_dog_response_and_detect_blobs_agree(frames):
    """On each of the three octaves of a 384x288 frame: the |DoG| response to
    1e-4 (0-255 intensities, f32 blurs summed in another order) and the
    detected keypoints equal on the valid entries."""
    for o, img in enumerate(_octaves(frames[0])):
        ref = np.asarray(jsift.dog_response(jnp.asarray(img)))
        out = tsift.dog_response(torch.from_numpy(img)[None])[0].numpy()
        np.testing.assert_allclose(out, ref, atol=1e-4)
        k = (256, 128, 64)[o]
        n_valid = _kps_equal(tsift.detect_blobs(torch.from_numpy(img)[None], k=k, threshold=0.5),
                             jsift.detect_blobs(jnp.asarray(img), k=k, threshold=0.5))
        print(f"octave {o} {img.shape}: {n_valid} valid keypoints equal")
        assert n_valid > 0


def test_describe_agrees_on_the_reference_keypoints(frames):
    """describe fed the reference's blur and keypoints: angles and
    descriptors to 1e-5 (unit-norm vectors; 16-term f32 cell sums)."""
    img = jnp.asarray(frames[0])
    kps = jsift.detect_blobs(img, k=256, threshold=0.5)
    blur = np.asarray(jfilt.gaussian_blur(img, sigma=2.0, radius=4))
    ref_d, ref_a = jsift.describe(jnp.asarray(blur), kps)
    tk = tfast.Keypoints(torch.from_numpy(np.asarray(kps.xy))[None], torch.from_numpy(np.asarray(kps.score))[None],
                         torch.from_numpy(np.asarray(kps.valid))[None])
    out_d, out_a = tsift.describe(torch.from_numpy(blur)[None], tk)
    np.testing.assert_allclose(out_a[0].numpy(), np.asarray(ref_a), atol=1e-5)
    np.testing.assert_allclose(out_d[0].numpy(), np.asarray(ref_d), atol=1e-5)


def test_gradient_equals_jnp_gradient():
    """torch.gradient, which the port's SIFT and SURF call at unit spacing,
    equals jnp.gradient bit for bit: central differences inside, one-sided
    at both edges, on both axes."""
    a = np.random.default_rng(2).normal(size=(3, 9, 11)).astype(np.float32)
    for axis in (1, 2):
        np.testing.assert_array_equal(torch.gradient(torch.from_numpy(a), dim=axis)[0].numpy(),
                                      np.asarray(jnp.gradient(jnp.asarray(a), axis=axis)))


def common_keypoints(out, ref, min_share: float = 0.98):
    """Pairs (port index, reference index) of the valid keypoints at the same
    position in one frame; raises unless they cover min_share of the
    reference's valid keypoints. XLA's jit fuses the f32 blur's
    multiply-adds into FMAs and torch rounds each product, so two equal DoG
    neighbours in one package can differ by an ulp in the other and the
    3x3 NMS then keeps one more or one fewer: each such flip shifts the
    top-k order after it, but not the set."""
    k = out.xy.shape[0]
    octave = np.repeat(np.arange(3), level_budgets(k, 3, 2.0))  # an octave's slots are one block
    pos = {(octave[i], *xy): i for i, (xy, v) in enumerate(zip(out.xy.tolist(), out.valid.tolist())) if v}
    ref_xy, ref_valid = np.asarray(ref.xy).tolist(), np.asarray(ref.valid)
    pairs = [(pos[(octave[j], *xy)], j) for j, xy in enumerate(ref_xy)
             if ref_valid[j] and (octave[j], *xy) in pos]
    assert len(pairs) >= min_share * ref_valid.sum(), (len(pairs), int(ref_valid.sum()))
    assert len(pos) >= min_share * ref_valid.sum()
    return np.asarray(pairs)


def assert_descriptors_close(out, ref):
    """Descriptors from each package's own blur: entries to 1e-5, except at
    most 0.1% of them, which stay within 5e-3. An ulp of the blur (FMA, see
    common_keypoints) can move a gradient sample at an orientation-bin edge
    into the neighbouring bin, which shifts that one sample's weighted
    magnitude between two entries."""
    err = np.abs(out - ref)
    print(f"descriptor entries beyond 1e-5: {int((err > 1e-5).sum())} of {err.size}, max {err.max():.2e}")
    assert (err > 1e-5).sum() <= 1e-3 * err.size
    assert err.max() <= 5e-3


def test_detect_and_describe_batch_agrees(frames):
    """The whole SIFT frontend, batched over two frames against the
    reference's vmap: at least 98% of the reference's valid keypoints at the
    same positions (see common_keypoints), and at those the scores to 1e-4
    and the descriptors as assert_descriptors_close states."""
    ref = jax.device_get(jdetect_batch(jnp.asarray(frames), k=256, mode="sift", dog_threshold=0.5))
    out = detect_and_describe_batch(torch.from_numpy(frames), k=256, mode="sift", dog_threshold=0.5)
    assert out.desc.shape == (2, 256, tsift.N_DIM) and out.desc.dtype == torch.float32
    for f in range(2):
        pairs = common_keypoints(jax.tree_util.tree_map(lambda a: a[f], out), jax.tree_util.tree_map(
            lambda a: a[f], ref))
        print(f"frame {f}: {len(pairs)} of {int(np.asarray(ref.valid[f]).sum())} keypoints in common")
        i, j = pairs[:, 0], pairs[:, 1]
        np.testing.assert_allclose(out.score[f].numpy()[i], np.asarray(ref.score[f])[j], atol=1e-4)
        assert_descriptors_close(out.desc[f].numpy()[i], np.asarray(ref.desc[f])[j])
    # Batching changes no keypoint: frame 1 alone has its row's keypoints,
    # scores and validity; its angles and descriptors agree to 1e-5 (CPU
    # reductions may group the sums by another batch shape).
    one = detect_and_describe(torch.from_numpy(frames[1]), k=256, mode="sift", dog_threshold=0.5)
    for name in ("xy", "score", "valid"):
        assert torch.equal(getattr(one, name), getattr(out, name)[1]), name
    torch.testing.assert_close(one.angle, out.angle[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(one.desc, out.desc[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["crosscheck", "ratio"])
def test_l2_matrix_and_float_match_agree(frames, mode):
    """Squared L2 distances of the reference's SIFT descriptors of two
    frames to 1e-5 (one 128-deep f32 matmul plus the norms); the float
    match's indices and validity equal, for each match mode."""
    f = jax.device_get(jdetect_batch(jnp.asarray(frames), k=256, mode="sift", dog_threshold=0.5))
    da, db = np.asarray(f.desc[0]), np.asarray(f.desc[1])
    va, vb = np.asarray(f.valid[0]), np.asarray(f.valid[1])
    ref_d = np.asarray(jmatch.l2_matrix(jnp.asarray(da), jnp.asarray(db), jnp.asarray(va), jnp.asarray(vb)))
    out_d = tmatch.l2_matrix(torch.from_numpy(da), torch.from_numpy(db), torch.from_numpy(va),
                             torch.from_numpy(vb)).numpy()
    np.testing.assert_allclose(out_d, ref_d, atol=1e-5)
    ref = jmatch.match(jnp.asarray(da), jnp.asarray(db), jnp.asarray(va), jnp.asarray(vb), mode=mode)
    out = tmatch.match(torch.from_numpy(da)[None], torch.from_numpy(db)[None], torch.from_numpy(va)[None],
                       torch.from_numpy(vb)[None], mode=mode)
    sel = np.asarray(ref.valid)
    print(f"{mode}: {int(sel.sum())} matches")
    assert sel.sum() > 20
    np.testing.assert_array_equal(out.valid[0].numpy(), sel)
    np.testing.assert_array_equal(out.idx[0].numpy()[sel], np.asarray(ref.idx)[sel])


# --------------------------------------------------------------------------
# tests/test_sift.py, run on the port
# --------------------------------------------------------------------------


def _blob_image(h=120, w=160, seed=0, n=12):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 40.0, np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    centers = rng.uniform([25, 25], [h - 25, w - 25], size=(n, 2))
    for cy, cx in centers:
        img += 120.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 2.5**2))
    return img, centers


def test_detect_blobs_finds_injected_blobs():
    img, centers = _blob_image()
    kps = tsift.detect_blobs(torch.from_numpy(img)[None], k=32, threshold=0.5)
    xy = kps.xy[0].numpy()[kps.valid[0].numpy()]
    assert len(xy) >= len(centers) // 2
    top = xy[:10]
    d = np.linalg.norm(top[:, None, :] - centers[None, :, ::-1], axis=-1).min(axis=1)
    assert np.median(d) < 2.0, d


def test_descriptor_shape_and_norm():
    img, _ = _blob_image(seed=1)
    feats = tsift.detect_and_describe(torch.from_numpy(img)[None], k=32, threshold=0.5)
    desc, valid = feats.desc[0].numpy(), feats.valid[0].numpy()
    assert desc.shape == (32, tsift.N_DIM)
    np.testing.assert_allclose(np.linalg.norm(desc[valid], axis=1), 1.0, atol=1e-3)
    assert 0.0 <= float(desc.min()) and float(desc.max()) < 1.0


def test_l2_matrix_matches_numpy():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(20, 16)).astype(np.float32)
    b = rng.normal(size=(24, 16)).astype(np.float32)
    d2 = tmatch.l2_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    expect = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2, expect, rtol=1e-4, atol=1e-4)


def test_float_match_dispatch_ratio():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(30, 16)).astype(np.float32)
    noisy = base + 0.01 * rng.normal(size=base.shape).astype(np.float32)
    perm = rng.permutation(30)
    m = tmatch.match(torch.from_numpy(base)[None], torch.from_numpy(noisy[perm])[None], mode="ratio", ratio=0.8)
    valid = m.valid[0].numpy()
    assert valid.mean() > 0.9
    np.testing.assert_array_equal(m.idx[0].numpy()[valid], np.argsort(perm)[valid])


def test_sift_mode_vo_tracks_synthetic():
    seq = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=6, width=512, height=384, n_landmarks=350))
    cfg = VOConfig(frontend="sift", match_mode="ratio", dog_threshold=0.5, n_keypoints=512,
                   ransac=RansacConfig(n_hypotheses=512, lo_hypotheses=128))
    traj = run_sequence(torch.from_numpy(seq.frames).float(), seq.marker_corners, seq.marker_present,
                        seq.marker_poses[0], seq.camera.K, seq.real_marker_length, cfg, seed=0)
    ok = traj.ok.numpy()
    assert ok.mean() >= 0.6, ok
    est = np.linalg.inv(traj.abs_poses[-1].numpy().astype(np.float64))[:3, 3]
    gt = np.linalg.inv(np.asarray(seq.marker_poses[-1], np.float64))[:3, 3]
    assert np.linalg.norm(est - gt) < 0.3, (est, gt)


def test_features_mode_switch():
    img, _ = _blob_image(seed=4)
    f_orb = detect_and_describe(torch.from_numpy(img), k=64)
    f_sift = detect_and_describe(torch.from_numpy(img), k=64, mode="sift", dog_threshold=0.5)
    assert f_orb.desc.dtype == torch.int32
    assert f_sift.desc.dtype == torch.float32
    assert f_sift.desc.shape == (64, 128)
