"""The port's SURF-mode frontend (frontend/surf.py) vs the JAX reference
(CPU), on the same numpy inputs, and tests/test_surf.py run on the port.

Frames are the synthetic renderer's at 384x288 (three octaves). Tolerances
as in test_torch_sift.py: keypoints equal when both packages start from the
same octave image; the whole frontend held by common keypoints, since XLA's
jit fuses the f32 blur into FMAs and torch does not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.frontend import filters as jfilt
from droplet_visual_odometry_tpu.frontend import surf as jsurf
from droplet_visual_odometry_tpu.frontend.features import detect_and_describe_batch as jdetect_batch

from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, run_sequence
from droplet_visual_odometry_tpu_torch.frontend import fast as tfast
from droplet_visual_odometry_tpu_torch.frontend import filters as tfilt
from droplet_visual_odometry_tpu_torch.frontend import matcher as tmatch
from droplet_visual_odometry_tpu_torch.frontend import sift as tsift
from droplet_visual_odometry_tpu_torch.frontend import surf as tsurf
from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe, detect_and_describe_batch

from test_torch_sift import FRAME_CFG, _octaves, assert_descriptors_close, common_keypoints

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    return jsynth.render_sequence(jsynth.SyntheticConfig(**FRAME_CFG)).frames.astype(np.float32)


def test_hessian_response_and_detect_blobs_agree(frames):
    """On each octave of a 384x288 frame: the response within 1e-5 of its
    largest value (second differences of second differences times s^4,
    values up to ~3e3), and the keypoints equal on the valid entries."""
    for o, img in enumerate(_octaves(frames[0])):
        ref = np.asarray(jsurf.hessian_response(jnp.asarray(img)))
        out = tsurf.hessian_response(torch.from_numpy(img)[None])[0].numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5 * float(np.abs(ref).max()) + 1e-5)
        k = (256, 128, 64)[o]
        r = jsurf.detect_blobs(jnp.asarray(img), k=k, threshold=0.5)
        t = tsurf.detect_blobs(torch.from_numpy(img)[None], k=k, threshold=0.5)
        valid = np.asarray(r.valid)
        np.testing.assert_array_equal(t.valid[0].numpy(), valid)
        np.testing.assert_array_equal(t.xy[0].numpy()[valid], np.asarray(r.xy)[valid])
        print(f"octave {o} {img.shape}: {int(valid.sum())} valid keypoints equal")
        assert valid.sum() > 0


def test_hessian_edge_rows_equal_jnp_gradient():
    """The response at the image's edge rows and columns, where jnp.gradient
    takes one-sided differences: the port's equals the reference's op-by-op
    (jax.disable_jit: no FMA fusion) exactly on a 40x52 ramp-plus-noise image."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:40, 0:52]
    img = (3.0 * yy + 0.5 * xx * xx / 52 + rng.normal(size=yy.shape)).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jsurf.hessian_response(jnp.asarray(img)))
    out = tsurf.hessian_response(torch.from_numpy(img)[None])[0].numpy()
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(out[sl], ref[sl])
    np.testing.assert_array_equal(out, ref)


def test_describe_agrees_on_the_reference_keypoints(frames):
    """describe fed the reference's blur and keypoints: angles and the 64-D
    descriptors to 1e-5."""
    img = jnp.asarray(frames[1])
    kps = jsurf.detect_blobs(img, k=256, threshold=0.5)
    blur = np.asarray(jfilt.gaussian_blur(img, sigma=2.0, radius=4))
    ref_d, ref_a = jsurf.describe(jnp.asarray(blur), kps)
    tk = tfast.Keypoints(torch.from_numpy(np.asarray(kps.xy))[None], torch.from_numpy(np.asarray(kps.score))[None],
                         torch.from_numpy(np.asarray(kps.valid))[None])
    out_d, out_a = tsurf.describe(torch.from_numpy(blur)[None], tk)
    assert out_d.shape == (1, 256, tsurf.N_DIM)
    np.testing.assert_allclose(out_a[0].numpy(), np.asarray(ref_a), atol=1e-5)
    np.testing.assert_allclose(out_d[0].numpy(), np.asarray(ref_d), atol=1e-5)


def test_detect_and_describe_batch_agrees(frames):
    """The whole SURF frontend over two frames against the reference's vmap:
    98% of its valid keypoints in common, scores to 2e-3 relative (second
    differences of second differences of each package's blur, which differ
    by FMA roundings: measured 5.3e-4), the
    descriptors as test_torch_sift.assert_descriptors_close states; and the
    float ratio match of the two frames' sets finds matches."""
    ref = jax.device_get(jdetect_batch(jnp.asarray(frames), k=256, mode="surf", dog_threshold=0.5))
    out = detect_and_describe_batch(torch.from_numpy(frames), k=256, mode="surf", dog_threshold=0.5)
    assert out.desc.shape == (2, 256, tsurf.N_DIM) and out.desc.dtype == torch.float32
    for f in range(2):
        pairs = common_keypoints(jax.tree_util.tree_map(lambda a: a[f], out),
                                 jax.tree_util.tree_map(lambda a: a[f], ref))
        i, j = pairs[:, 0], pairs[:, 1]
        rs = np.asarray(ref.score[f])[j]
        np.testing.assert_allclose(out.score[f].numpy()[i], rs, rtol=2e-3, atol=1e-4)
        assert_descriptors_close(out.desc[f].numpy()[i], np.asarray(ref.desc[f])[j])
    m = tmatch.match(out.desc[:1], out.desc[1:], out.valid[:1], out.valid[1:], mode="ratio")
    print(f"surf ratio matches between the frames: {int(m.valid.sum())}")
    assert int(m.valid.sum()) > 20


# --------------------------------------------------------------------------
# tests/test_surf.py, run on the port
# --------------------------------------------------------------------------


def _blob_image(h=120, w=160, seed=0, n=12, sigma=2.5):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 40.0, np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    centers = rng.uniform([25, 25], [h - 25, w - 25], size=(n, 2))
    for cy, cx in centers:
        img += 120.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))
    return img, centers


def _t(img):
    return torch.from_numpy(np.ascontiguousarray(img))[None]


class TestSurfDetector:
    def test_hessian_finds_blobs(self):
        img, centers = _blob_image()
        kps = tsurf.detect_blobs(_t(img), k=32, threshold=0.5)
        xy = kps.xy[0].numpy()[kps.valid[0].numpy()]
        assert len(xy) >= len(centers) // 2
        d = np.linalg.norm(xy[:10][:, None, :] - centers[None, :, ::-1], axis=-1).min(1)
        assert np.median(d) < 2.5, d

    def test_hessian_rejects_edges(self):
        img = np.full((96, 96), 50.0, np.float32)
        img[:, 48:] = 200.0
        resp = tsurf.hessian_response(_t(img))[0].numpy()
        blob, _ = _blob_image(96, 96, n=1)
        blob_resp = tsurf.hessian_response(_t(blob))[0].numpy()
        assert resp[20:76, 40:56].max() < 0.15 * blob_resp.max()

    def test_multi_sigma_catches_large_blobs(self):
        img, centers = _blob_image(160, 160, n=4, sigma=8.0)
        kps = tsurf.detect_blobs(_t(img), k=16, threshold=0.2)
        xy = kps.xy[0].numpy()[kps.valid[0].numpy()]
        assert len(xy) >= 1
        d = np.linalg.norm(xy[:4][:, None, :] - centers[None, :, ::-1], axis=-1).min(1)
        assert np.min(d) < 3.0, d


class TestSurfDescriptor:
    def test_shape_and_norm(self):
        img, _ = _blob_image(seed=1)
        feats = tsurf.detect_and_describe(_t(img), k=32, threshold=0.5)
        desc, valid = feats.desc[0].numpy(), feats.valid[0].numpy()
        assert desc.shape == (32, tsurf.N_DIM)
        np.testing.assert_allclose(np.linalg.norm(desc[valid], axis=1), 1.0, atol=1e-3)

    def test_rotation_tolerance(self):
        img, _ = _blob_image(h=128, w=128, seed=2)
        rot = np.rot90(img).copy()
        fa = tsurf.detect_and_describe(_t(img), k=24, threshold=0.5)
        fb = tsurf.detect_and_describe(_t(rot), k=24, threshold=0.5)
        m = tmatch.match(fa.desc, fb.desc, fa.valid, fb.valid, mode="ratio", ratio=0.85)
        pa, pb, mask = tmatch.gather_correspondences(fa.xy, fb.xy, m)
        pa, pb = pa[0].numpy()[mask[0].numpy()], pb[0].numpy()[mask[0].numpy()]
        assert len(pa) >= 6, len(pa)
        expect = np.stack([pa[:, 1], 128 - 1 - pa[:, 0]], axis=1)
        assert (np.linalg.norm(pb - expect, axis=1) < 3.0).mean() > 0.7


class TestSurfVO:
    def test_surf_mode_vo_tracks_synthetic(self):
        seq = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=5, width=512, height=384, n_landmarks=350))
        cfg = VOConfig(frontend="surf", match_mode="ratio", dog_threshold=0.5, n_keypoints=512,
                       ransac=RansacConfig(n_hypotheses=512, lo_hypotheses=128))
        traj = run_sequence(torch.from_numpy(seq.frames).float(), seq.marker_corners, seq.marker_present,
                            seq.marker_poses[0], seq.camera.K, seq.real_marker_length, cfg, seed=0)
        ok = traj.ok.numpy()
        assert ok.mean() >= 0.5, ok
        est = np.linalg.inv(traj.abs_poses[-1].numpy().astype(np.float64))[:3, 3]
        gt = np.linalg.inv(np.asarray(seq.marker_poses[-1], np.float64))[:3, 3]
        assert np.linalg.norm(est - gt) < 0.35, (est, gt)

    def test_mode_switch_shapes(self):
        img, _ = _blob_image(seed=4)
        f = detect_and_describe(torch.from_numpy(img), k=64, mode="surf", dog_threshold=0.5)
        assert f.desc.dtype == torch.float32
        assert f.desc.shape == (64, 64)


def _cross_scale_correct_matches(module, n_octaves):
    """Correct ratio matches between a 512x384 frame and its downsample2:
    a correct match has xy_A ~= 2 * xy_B."""
    seq = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=1, width=512, height=384, n_landmarks=250,
                                                        noise_std=1.0))
    a = torch.from_numpy(seq.frames[:1]).float()
    b = tfilt.downsample2(a)
    fa = module.detect_and_describe(a, k=128, threshold=0.5, n_octaves=n_octaves)
    fb = module.detect_and_describe(b, k=128, threshold=0.5, n_octaves=n_octaves)
    m = tmatch.match(fa.desc, fb.desc, fa.valid, fb.valid, mode="ratio", ratio=0.8)
    pa, pb, mask = tmatch.gather_correspondences(fa.xy, fb.xy, m)
    pa, pb = pa[0].numpy()[mask[0].numpy()], pb[0].numpy()[mask[0].numpy()]
    return int((np.linalg.norm(pa - 2.0 * pb, axis=1) < 4.0).sum()) if len(pa) else 0


class TestSiftOctaves:
    def test_multi_octave_matches_across_2x_scale(self):
        n1, n3 = (_cross_scale_correct_matches(tsift, n) for n in (1, 3))
        assert n3 >= 10, (n3, n1)
        assert n3 >= 2 * n1, (n3, n1)

    def test_octave_coords_within_image(self):
        img, _ = _blob_image(h=256, w=256, seed=6)
        f = tsift.detect_and_describe(_t(img), k=64, threshold=0.5, n_octaves=3)
        xy = f.xy[0].numpy()[f.valid[0].numpy()]
        assert np.all(xy >= 0) and np.all(xy[:, 0] < 256) and np.all(xy[:, 1] < 256)


class TestSurfOctaves:
    def test_scale_adapted_matches_across_2x_scale(self):
        n1, n3 = (_cross_scale_correct_matches(tsurf, n) for n in (1, 3))
        assert n3 >= 10, (n3, n1)
        assert n3 >= 2 * n1, (n3, n1)

    def test_octave_coords_within_image(self):
        img, _ = _blob_image(h=256, w=256, seed=6)
        f = tsurf.detect_and_describe(_t(img), k=64, threshold=0.5, n_octaves=3)
        xy = f.xy[0].numpy()[f.valid[0].numpy()]
        assert np.all(xy >= 0) and np.all(xy[:, 0] < 256) and np.all(xy[:, 1] < 256)
