"""The port's ground truth, se3 and metrics additions vs the JAX reference (CPU).

Modules: groundtruth.py (select_marker through sequence_from_detections),
core/se3.py (quaternion product and conjugate, the euler conversions,
from_translation_euler, marker_to_marker, camera_to_camera,
transform_points), eval/metrics.py (per_axis_stats, gt_vo_difference) and
utils/profiling.py. Inputs are made with numpy from a seed and fed to both
packages. Tolerances: poses (cTm, se3 products) 1e-6 and float32 angles 2e-6
(an ulp of the transcendental functions, which the two libraries round
differently); presence, slots, ids and corner orders exactly; pixel lengths
1e-5 px (float32 sums of four norms; they agree exactly on these inputs).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from droplet_visual_odometry_tpu import groundtruth as jgt
from droplet_visual_odometry_tpu.core import se3 as jse3
from droplet_visual_odometry_tpu.core.camera import make_camera as jmake_camera
from droplet_visual_odometry_tpu.eval import metrics as jmetrics

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch import groundtruth as tgt
from droplet_visual_odometry_tpu_torch.core import se3 as tse3
from droplet_visual_odometry_tpu_torch.core.camera import make_camera as tmake_camera
from droplet_visual_odometry_tpu_torch.eval import metrics as tmetrics
from droplet_visual_odometry_tpu_torch.utils import profiling

POSE_TOL = 1e-6
ANGLE_TOL = 2e-6
LENGTH_TOL = 1e-5


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _detections(seed=0, n=9, m=4, ref_id=7):
    """Several markers a message; the reference id in varying slots, twice in
    one frame (the first slot must win), absent in two frames (one of them
    an empty message); NaN corners on one present and one absent frame."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 6, size=(n, m)).astype(np.int32)
    ids[np.arange(n), rng.integers(0, m, n)] = ref_id
    ids[1, 1], ids[1, 3] = ref_id, ref_id
    ids[4] = rng.integers(0, 6, m)  # absent: other ids only
    ids[6] = -1  # absent: an empty message
    t = rng.normal(size=(n, m, 3)).astype(np.float32)
    q = _quats(rng, (n, m))
    corners = rng.uniform(0, 640, size=(n, m, 4, 2)).astype(np.float32)
    corners[2] = np.nan
    corners[4, 0] = np.nan
    return ids, t, q, corners


def _both(ids, t, q, corners):
    return jgt.detections_from_arrays(ids, t, q, corners), tgt.detections_from_arrays(ids, t, q, corners)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# groundtruth.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ref_id", [7, 42])
def test_select_marker_equals_reference(ref_id):
    """ref 42 is absent everywhere: slot 0's values with found=False."""
    arrs = _detections()
    jd, td = _both(*arrs)
    got = tgt.select_marker(td, ref_id)
    want = jgt.select_marker(jd, ref_id)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    if ref_id == 42:
        assert not _np(got[3]).any()
        np.testing.assert_array_equal(_np(got[0]), arrs[1][:, 0])
    else:
        np.testing.assert_array_equal(_np(got[3]), [True] * 4 + [False, True, False, True, True])
        np.testing.assert_array_equal(_np(got[0])[1], arrs[1][1, 1])  # the first of two hits


def test_marker_keypoints_equals_reference():
    corners = np.random.default_rng(1).uniform(0, 9, (3, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(tgt.marker_keypoints(torch.from_numpy(corners)).numpy(),
                                  np.asarray(jgt.marker_keypoints(jnp.asarray(corners))))


def _corner_sets():
    """Random quads, permuted squares, quads with exactly tied angles (a
    repeated corner; two corners on one ray from the centroid), all-NaN and
    one-NaN quads."""
    rng = np.random.default_rng(2)
    quads = [rng.uniform(0, 500, (64, 4, 2))]
    sq = np.asarray([[0, 0], [40, 0], [40, 40], [0, 40]], np.float64) + 100
    quads.append(np.stack([sq[rng.permutation(4)] for _ in range(8)]))
    tied = np.asarray([[[10, 10], [10, 10], [30, 10], [20, 40]],  # a repeated corner
                       [[2, 2], [0, 0], [8, 0], [0, 8]],  # corners 0 and 1 on one ray from the centroid
                       [[2, 2], [6, 6], [0, 0], [8, 8]]],  # collinear: two pairs of tied angles
                      np.float64)
    quads.append(tied)
    nan = np.full((2, 4, 2), np.nan)
    nan[1, :3] = rng.uniform(0, 10, (3, 2))
    quads.append(nan)
    return np.concatenate(quads).astype(np.float32)


def test_reorder_corners_equals_reference():
    """Stable argsort on the angles: tied angles keep their input order, as
    jnp.argsort's stable sort does; NaN angles sort last in both."""
    c = _corner_sets()
    got = tgt.reorder_corners(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgt.reorder_corners(jnp.asarray(c))))
    np.testing.assert_array_equal(got[-4], c[-4])  # ties in input order
    np.testing.assert_array_equal(got[-3], c[-3][[0, 2, 1, 3]])


def test_pixel_lengths_equal_reference():
    c = _corner_sets()
    tc, jc = torch.from_numpy(c), jnp.asarray(c)
    for tf, jf in ((tgt.side_lengths, jgt.side_lengths), (tgt.marker_pixel_length, jgt.marker_pixel_length),
                   (tgt.marker_pixel_length_extent, jgt.marker_pixel_length_extent)):
        got, want = tf(tc).numpy(), np.asarray(jf(jc))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=LENGTH_TOL)
    sq = torch.tensor([[0.0, 0], [40, 0], [40, 40], [0, 40]]) + 100
    assert float(tgt.marker_pixel_length(sq)) == pytest.approx(40.0)
    assert float(tgt.marker_pixel_length_extent(sq)) == pytest.approx(40.0)


@pytest.mark.parametrize("use_base_link", [True, False])
def test_derive_ground_truth_equals_reference(use_base_link):
    arrs = _detections(seed=3)
    jd, td = _both(*arrs)
    jcfg = jgt.GroundTruthConfig(use_base_link=use_base_link)
    tcfg = convert.gt_config_from_jax(dataclasses.asdict(jcfg))
    got = tgt.derive_ground_truth(td, 7, tcfg)
    want = jgt.derive_ground_truth(jd, jnp.asarray(7), jcfg)
    np.testing.assert_allclose(got.cTm.numpy(), np.asarray(want.cTm), rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(got.present.numpy(), np.asarray(want.present))
    np.testing.assert_array_equal(got.corners.numpy(), np.asarray(want.corners))
    w_len = np.asarray(want.pixel_length)
    np.testing.assert_array_equal(np.isnan(got.pixel_length.numpy()), np.isnan(w_len))
    np.testing.assert_allclose(got.pixel_length.numpy(), w_len, rtol=0, atol=LENGTH_TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_relative_stream_equals_reference(masked):
    arrs = _detections(seed=4)
    jd, td = _both(*arrs)
    t_s = tgt.derive_ground_truth(td, 7)
    j_s = jgt.derive_ground_truth(jd, jnp.asarray(7))
    got = tgt.relative_stream(t_s.cTm, t_s.present if masked else None).numpy()
    want = np.asarray(jgt.relative_stream(j_s.cTm, j_s.present if masked else None))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)  # products of two cTm with |t| ~ 3
    if masked:
        np.testing.assert_array_equal(got[3], np.eye(4))


def test_sequence_from_detections_equals_reference():
    arrs = _detections(seed=5)
    jd, td = _both(*arrs)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (9, 24, 32), dtype=np.uint8)
    stamps = np.arange(9) / 20.0
    jseq = jgt.sequence_from_detections(frames, stamps, jd, 7, jmake_camera(30, 30, 16, 12, None, 32, 24), 0.2)
    tseq = tgt.sequence_from_detections(frames, stamps, td, 7, tmake_camera(30, 30, 16, 12, None, 32, 24), 0.2,
                                        device="cpu")
    for f in ("frames", "timestamps", "marker_corners", "marker_present", "marker_ids"):
        np.testing.assert_array_equal(getattr(tseq, f), getattr(jseq, f), err_msg=f)
        assert getattr(tseq, f).dtype == getattr(jseq, f).dtype, f
    np.testing.assert_allclose(tseq.marker_poses, jseq.marker_poses, rtol=0, atol=POSE_TOL)
    assert tseq.marker_poses.dtype == np.float32 and tseq.real_marker_length == jseq.real_marker_length


def test_sequence_from_detections_defaults_to_cuda():
    """Without a device the ingest entry point asks for the card: here, none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, td = _both(*_detections())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgt.sequence_from_detections(np.zeros((9, 8, 8), np.uint8), np.arange(9.0), td, 7,
                                     tmake_camera(8, 8, 4, 4, None, 8, 8), 0.2)


# --------------------------------------------------------------------------
# core/se3.py
# --------------------------------------------------------------------------


def _poses(rng, n):
    q = _quats(rng, (n,))
    t = rng.normal(scale=2.0, size=(n, 3)).astype(np.float32)
    return np.array(jse3.from_translation_quaternion(jnp.asarray(t), jnp.asarray(q)))  # writable for torch


def test_quaternion_product_and_conjugate_equal_reference():
    rng = np.random.default_rng(6)
    q1, q2 = _quats(rng, (5, 3)), _quats(rng, (5, 3))
    np.testing.assert_allclose(tse3.quat_multiply(torch.from_numpy(q1), torch.from_numpy(q2)).numpy(),
                               np.asarray(jse3.quat_multiply(jnp.asarray(q1), jnp.asarray(q2))), rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(tse3.quat_conjugate(torch.from_numpy(q1)).numpy(),
                                  np.asarray(jse3.quat_conjugate(jnp.asarray(q1))))


@pytest.mark.parametrize("axes", ["sxyz", "rxyz"])
def test_euler_conversions_equal_reference(axes):
    """Random angles, plus the gimbal lock (middle angle +-pi/2)."""
    rng = np.random.default_rng(7)
    e = rng.uniform(-np.pi, np.pi, (40, 3)).astype(np.float32)
    e[:, 1] /= 2
    e[-4:, 1] = np.float32(np.pi / 2) * np.asarray([1, -1, 1, -1], np.float32)
    R_t = tse3.euler_to_rotmat(torch.from_numpy(e), axes=axes)
    R_j = jse3.euler_to_rotmat(jnp.asarray(e), axes=axes)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0, atol=POSE_TOL)
    R = np.array(R_j)  # a writable copy for torch.from_numpy
    got = tse3.rotmat_to_euler(torch.from_numpy(R), axes=axes).numpy()
    want = np.asarray(jse3.rotmat_to_euler(jnp.asarray(R), axes=axes))
    np.testing.assert_allclose(got, want, rtol=0, atol=ANGLE_TOL)  # the lock rows too
    back = tse3.euler_to_rotmat(torch.from_numpy(got), axes=axes).numpy()
    np.testing.assert_allclose(back, R, rtol=0, atol=1e-5)  # a round trip through float32 trig
    with pytest.raises(ValueError):
        tse3.rotmat_to_euler(torch.from_numpy(R), axes="szyx")


def test_pose_helpers_equal_reference():
    rng = np.random.default_rng(8)
    A, B = _poses(rng, 6), _poses(rng, 6)
    e = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    pts = rng.normal(size=(6, 10, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(A), torch.from_numpy(B)
    ja, jb = jnp.asarray(A), jnp.asarray(B)
    for got, want in (
        (tse3.marker_to_marker(ta, tb), jse3.marker_to_marker(ja, jb)),
        (tse3.camera_to_camera(ta, tb), jse3.camera_to_camera(ja, jb)),
        (tse3.from_translation_euler(torch.from_numpy(t), torch.from_numpy(e)),
         jse3.from_translation_euler(jnp.asarray(t), jnp.asarray(e))),
        (tse3.transform_points(ta, torch.from_numpy(pts)), jse3.transform_points(ja, jnp.asarray(pts))),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)  # |t| ~ 4: a few ulps


# --------------------------------------------------------------------------
# eval/metrics.py
# --------------------------------------------------------------------------


def test_per_axis_stats_equals_reference():
    poses = _poses(np.random.default_rng(9), 30).astype(np.float64)
    got = tmetrics.per_axis_stats(poses)
    want = jmetrics.per_axis_stats(poses)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ANGLE_TOL, err_msg=k)


def test_gt_vo_difference_equals_reference():
    rng = np.random.default_rng(10)
    gt = _poses(rng, 25).astype(np.float64)
    vo = _poses(rng, 25).astype(np.float64)
    got = tmetrics.gt_vo_difference(gt, vo)
    want = jmetrics.gt_vo_difference(gt, vo)
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["translation_diff"], want["translation_diff"])
    np.testing.assert_array_equal(got["euclidean"], want["euclidean"])
    d = np.abs(got["euler_diff"] - want["euler_diff"])
    np.testing.assert_allclose(np.minimum(d, 2 * np.pi - d), 0, atol=ANGLE_TOL * 2)  # wrap-aware
    with pytest.raises(ValueError):
        tmetrics.gt_vo_difference(gt, vo[:-1])


# --------------------------------------------------------------------------
# utils/profiling.py
# --------------------------------------------------------------------------


def test_stage_timer_and_timed():
    times = profiling.StageTimes()
    for _ in range(2):
        with times.stage("a"):
            torch.ones(8).sum()
    rep = times.report()
    assert rep["a"]["calls"] == 2 and rep["a"]["total_s"] >= 0 and "a" in times.pretty()
    out, secs = profiling.timed(lambda x: x * 2, torch.ones(4))
    assert torch.equal(out, torch.full((4,), 2.0)) and secs >= 0
    assert profiling.frames_per_second(10, 2.0) == 5.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
