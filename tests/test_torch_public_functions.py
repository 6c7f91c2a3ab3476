"""The port's counterparts of the JAX package's remaining public functions,
each against its JAX function on the same seeded numpy inputs (CPU):
core/camera.projection_matrix and undistort_image, estimation/scale.
scale_factor, frontend/fast.detect and select_topk_tiled,
frontend/filters.build_pyramid and frontend/orb.describe.

Bit for bit where the reference is exact (FAST scores, keypoint positions,
tile selections, descriptor words); otherwise to the tolerance stated in
each case. On the CPU, detect and describe run the kernels' plain twins.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from droplet_visual_odometry_tpu.core import camera as jcam
from droplet_visual_odometry_tpu.estimation import scale as jscale
from droplet_visual_odometry_tpu.frontend import fast as jfast
from droplet_visual_odometry_tpu.frontend import filters as jfilt
from droplet_visual_odometry_tpu.frontend import orb as jorb

from droplet_visual_odometry_tpu_torch.core import camera as tcam
from droplet_visual_odometry_tpu_torch.estimation import scale as tscale
from droplet_visual_odometry_tpu_torch.frontend import fast as tfast
from droplet_visual_odometry_tpu_torch.frontend import filters as tfilt
from droplet_visual_odometry_tpu_torch.frontend import orb as torb

torch.set_num_threads(2)

K_NP = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
# The reference's production lens (Parameters/camera_calibration.yaml:21-29), at 160x120.
DIST = np.array([-0.296079, 0.099771, 0.000222, 0.000109, 0.0], np.float32)


def _image(h, w, seed):
    """Integer image with bright squares, so FAST fires and ties occur."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 60, size=(h, w)).astype(np.float32)
    for y, x in rng.integers(10, [h - 10, w - 10], size=(25, 2)):
        img[y : y + 4, x : x + 4] += 150.0
    return np.round(img)


def _rot(rng, scale):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(scale=scale, size=3)).as_matrix().astype(np.float32)


def case_projection_matrix():
    """K [R | t], the identity default and a batch of poses: f32 products
    of the same operands, to 1e-4 absolute on entries up to ~500."""
    rng = np.random.default_rng(0)
    R = np.stack([_rot(rng, 0.3) for _ in range(3)])
    t = rng.normal(size=(3, 3)).astype(np.float32)
    K = jnp.asarray(K_NP)
    ref = np.stack([np.asarray(jcam.projection_matrix(K, jnp.asarray(r), jnp.asarray(tt))) for r, tt in zip(R, t)])
    out = tcam.projection_matrix(torch.from_numpy(K_NP), torch.from_numpy(R), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tcam.projection_matrix(torch.from_numpy(K_NP)).numpy(),
                                  np.asarray(jcam.projection_matrix(K)))


def case_undistort_image():
    """cv.undistort's counterpart with the production lens: the same
    rectify map up to f32 rounding (1e-3 px), so intensities agree to 0.05
    of a level on an integer image with 150-level steps."""
    h, w = 120, 160
    jc = jcam.make_camera(130.0, 130.0, 80.0, 60.0, dist=DIST, width=w, height=h)
    tc = tcam.make_camera(130.0, 130.0, 80.0, 60.0, dist=DIST, width=w, height=h)
    new_K = jcam.optimal_new_camera_matrix(jc, alpha=1.0)
    np.testing.assert_allclose(tcam.optimal_new_camera_matrix(tc, alpha=1.0), new_K, rtol=1e-5)
    img = _image(h, w, seed=1)
    ref = np.asarray(jcam.undistort_image(jnp.asarray(img), jc, jnp.asarray(new_K)))
    out = tcam.undistort_image(torch.from_numpy(img), tc, new_K)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=0.05)
    # A precomputed map gives the same frames, with a leading batch.
    src_map = tcam.undistort_rectify_map(tc, new_K)
    batch = tcam.undistort_image(torch.from_numpy(np.stack([img, img])), tc, new_K, src_map=src_map)
    np.testing.assert_array_equal(batch.numpy(), np.stack([out.numpy()] * 2))


def case_scale_factor():
    """The GN marker scale or the 1.0 fallback (marker invalid in the last
    pair): 5 damped steps from the same start, f32 order only (rtol 1e-3,
    the estimator's own hold in test_torch_estimation.py)."""
    rng = np.random.default_rng(9)
    L = 0.2
    model = np.array([[-L / 2, L / 2, 0], [L / 2, L / 2, 0], [L / 2, -L / 2, 0], [-L / 2, -L / 2, 0]])
    proj = lambda X: X[:, :2] / X[:, 2:3] * [K_NP[0, 0], K_NP[1, 1]] + [K_NP[0, 2], K_NP[1, 2]]
    prev, curr, Rs, ts = [], [], [], []
    for _ in range(6):
        X1 = model @ _rot(rng, 0.2).T + np.array([0.1, -0.05, 2.0]) + rng.normal(scale=0.1, size=3)
        R, t = _rot(rng, 0.03), rng.normal(scale=0.05, size=3)
        prev.append(proj(X1) + rng.normal(scale=0.3, size=(4, 2)))
        curr.append(proj(X1 @ R.T + t) + rng.normal(scale=0.3, size=(4, 2)))
        Rs.append(R)
        ts.append(t / np.linalg.norm(t))
    prev, curr, Rs, ts = (np.asarray(a, np.float32) for a in (prev, curr, Rs, ts))
    valid = np.array([True] * 5 + [False])
    ref = np.array([
        float(jscale.scale_factor(jnp.asarray(K_NP), jnp.asarray(r), jnp.asarray(t), jnp.asarray(a),
                                  jnp.asarray(b), L, jnp.asarray(m)))
        for r, t, a, b, m in zip(Rs, ts, prev, curr, valid)
    ])
    out = tscale.scale_factor(
        torch.from_numpy(K_NP), torch.from_numpy(Rs), torch.from_numpy(ts), torch.from_numpy(prev),
        torch.from_numpy(curr), L, torch.from_numpy(valid),
    ).numpy()
    assert out[-1] == ref[-1] == 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-3)


def case_detect():
    """FAST score, NMS and the row-bucketed top-k on one integer frame and
    on a batch: keypoint positions, scores and validity bit for bit."""
    imgs = np.stack([_image(96, 128, seed=s) for s in (2, 3)])
    for k in (64, 300):
        ref = [jfast.detect(jnp.asarray(im), k=k) for im in imgs]
        one = tfast.detect(torch.from_numpy(imgs[0]), k=k)
        both = tfast.detect(torch.from_numpy(imgs), k=k)
        for got in (one, tfast.Keypoints(*(f[0] for f in both))):
            np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref[0].xy))
            np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref[0].score))
            np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref[0].valid))
        np.testing.assert_array_equal(both.xy[1].numpy(), np.asarray(ref[1].xy))
        np.testing.assert_array_equal(both.score[1].numpy(), np.asarray(ref[1].score))


def case_select_topk_tiled():
    """Tile-bucketed top-k on maps with many tied integer scores and sizes
    that do not divide by the tile: selections bit for bit."""
    rng = np.random.default_rng(5)
    for h, w, k, tile, per_tile in ((40, 52, 64, 8, 3), (33, 47, 20, 8, 1), (64, 64, 30, 16, 2)):
        s = rng.integers(0, 4, size=(2, h, w)).astype(np.float32) * 10.0
        nms = tfast.nms3x3(torch.from_numpy(s))
        out = tfast.select_topk_tiled(nms, k, tile, per_tile)
        for i in range(2):
            ref = jfast.select_topk_tiled(jnp.asarray(nms[i].numpy()), k, tile, per_tile)
            np.testing.assert_array_equal(out.xy[i].numpy(), np.asarray(ref.xy))
            np.testing.assert_array_equal(out.score[i].numpy(), np.asarray(ref.score))
            np.testing.assert_array_equal(out.valid[i].numpy(), np.asarray(ref.valid))


def case_build_pyramid():
    """Power-of-two pyramid by the f32 sigma=1 blur and decimation: the
    same shapes, values to 1e-4 (the f32 blur's own hold)."""
    img = _image(90, 122, seed=4) + np.float32(0.25)
    ref = jfilt.build_pyramid(jnp.asarray(img), 4)
    out = tfilt.build_pyramid(torch.from_numpy(img), 4)
    assert [tuple(o.shape) for o in out] == [tuple(r.shape) for r in ref]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def case_describe():
    """One frame's descriptors and angles at the reference's own keypoints
    on its own blurred frame: words bit for bit, angles to 1e-5."""
    img = _image(120, 160, seed=6)
    blur = np.asarray(jfilt.gaussian_blur(jnp.asarray(img), 2.0, 4))
    kps = jfast.detect(jnp.asarray(img), k=128)
    ref_d, ref_a = jorb.describe(jnp.asarray(blur), kps)
    out_d, out_a = torb.describe(torch.from_numpy(blur.copy()), tfast.Keypoints(
        *(torch.from_numpy(np.array(f)) for f in kps)))
    assert out_d.shape == (128, 8) and out_d.dtype == torch.int32
    np.testing.assert_array_equal(out_d.numpy().view(np.uint32), np.asarray(ref_d))
    np.testing.assert_allclose(out_a.numpy(), np.asarray(ref_a), rtol=0, atol=1e-5)


CASES = {f.__name__[len("case_"):]: f for f in (
    case_projection_matrix, case_undistort_image, case_scale_factor, case_detect,
    case_select_topk_tiled, case_build_pyramid, case_describe,
)}


@pytest.mark.parametrize("name", list(CASES))
def test_public_function_equals_reference(name):
    CASES[name]()
