"""The port's live entry point (stream.OnlineVO), the ground-truth parts it
uses (groundtruth.py, se3.compose, the converters) and the float global
descriptors vs the JAX reference (CPU).

On the CPU OnlineVO runs its step eagerly (a CUDA graph on the card: the
graph against the eager step is a `cuda` test in
test_torch_cuda_kernels.py). Tolerances are stated per test.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu import groundtruth as jgt
from droplet_visual_odometry_tpu.backend import loop_closure as jlc
from droplet_visual_odometry_tpu.core import se3 as jse3
from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.estimation.vo import VOConfig as JVOConfig
from droplet_visual_odometry_tpu.frontend.features import detect_and_describe_batch as jdetect_batch
from droplet_visual_odometry_tpu.stream import OnlineVO as JOnlineVO

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch import groundtruth as tgt
from droplet_visual_odometry_tpu_torch.backend import loop_closure as tlc
from droplet_visual_odometry_tpu_torch.core import se3 as tse3
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
from droplet_visual_odometry_tpu_torch.stream import OnlineVO
from droplet_visual_odometry_tpu_torch.utils import threefry

torch.set_num_threads(2)

CFG = VOConfig()
SEQ_CFG = dict(n_frames=8, width=640, height=480, n_landmarks=350)  # tests/test_stream.py's sequence


@pytest.fixture(scope="module")
def seq():
    return tsynth.render_sequence(tsynth.SyntheticConfig(**SEQ_CFG))


def _engine(seq, cfg=CFG, **kw):
    return OnlineVO(K=np.asarray(seq.camera.K), real_marker_length=seq.real_marker_length, reference_id=0, cfg=cfg,
                    gt_cfg=tgt.GroundTruthConfig(use_base_link=False), device="cpu", **kw)


def jax_push_draws(seed: int = 0, n_hyp: int = 384, n_lo: int = 128):
    """The reference OnlineVO's per-push draws as draws(step) -> (u_hyp,
    u_lo): its key is fold_in(PRNGKey(seed), step) (stream.py:113),
    uniform(key) for the hypotheses and fold_in(key, 1) for the LO round
    (ransac.py:88, :186)."""

    def draws(step: int):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        u_hyp = np.asarray(jax.random.uniform(key, (n_hyp * 8,)))[None]
        u_lo = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (n_lo * 14,)))[None]
        return torch.from_numpy(u_hyp), torch.from_numpy(u_lo)

    return draws


# --------------------------------------------------------------------------
# tests/test_stream.py, run on the port
# --------------------------------------------------------------------------


def test_stream_gating_and_tracking(seq):
    vo = _engine(seq)
    r0 = vo.push(seq.timestamps[0], seq.frames[0], None)
    assert not r0.armed and not vo.armed
    r1 = vo.push(seq.timestamps[0], seq.frames[0], tgt.frame_detections(seq, 0))
    assert r1.armed and vo.armed
    np.testing.assert_allclose(r1.pose, seq.marker_poses[0], atol=1e-5)
    assert r1.gt_pose is not None
    oks = [vo.push(seq.timestamps[i], seq.frames[i], tgt.frame_detections(seq, i)).ok for i in range(1, len(seq))]
    assert np.mean(oks) > 0.6
    est_cam = np.linalg.inv(vo.pose)[:3, 3]
    gt_cam = np.linalg.inv(np.asarray(seq.marker_poses[-1], np.float64))[:3, 3]
    assert np.linalg.norm(est_cam - gt_cam) < 0.25, (est_cam, gt_cam)


def test_stream_pose_callbacks():
    small = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=3, width=160, height=120, n_landmarks=80))
    vo = _engine(small, VOConfig(n_keypoints=64, ransac=RansacConfig(n_hypotheses=64, lo_hypotheses=16)))
    seen = []
    vo.on_pose.append(lambda ts, pose: seen.append((ts, pose.shape)))
    vo.push(small.timestamps[0], small.frames[0], tgt.frame_detections(small, 0))
    vo.push(small.timestamps[1], small.frames[1], tgt.frame_detections(small, 1))
    assert len(seen) == 2 and seen[0][1] == (4, 4)


def test_on_marker_broadcast_per_id():
    small = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=3, width=320, height=240, n_landmarks=120))
    vo = _engine(small, VOConfig(n_keypoints=64, ransac=RansacConfig(n_hypotheses=64, lo_hypotheses=16)))
    seen = []
    vo.on_marker.append(lambda ts, mid, cTm: seen.append((ts, mid, cTm)))
    cTm = np.asarray(small.marker_poses[0], np.float64)
    t, q = tse3.to_translation_quaternion(torch.from_numpy(cTm.astype(np.float32)))
    dets = tgt.detections_from_arrays(np.asarray([[0, 7, -1]], np.int32), np.tile(t.numpy(), (1, 3, 1)),
                                      np.tile(q.numpy(), (1, 3, 1)),
                                      np.tile(np.asarray(small.marker_corners[0])[None, None], (1, 3, 1, 1)))
    vo.push(small.timestamps[0], small.frames[0], dets)
    assert [mid for _, mid, _ in seen] == [0, 7]
    for _, _, pose in seen:
        assert pose.shape == (4, 4)
        np.testing.assert_allclose(pose, cTm, atol=1e-5)


def test_host_marker_info_matches_device_path():
    """The host numpy marker math against the reference's GT path
    (derive_ground_truth: select_marker + marker_pose_to_cTm) on the same
    detections, both use_base_link branches and a missing id, to 1e-6; and
    against the port's own marker_pose_to_cTm."""
    rng = np.random.default_rng(3)
    ids = np.asarray([[7, 3]], np.int32)
    t = rng.normal(size=(1, 2, 3)).astype(np.float32)
    q = rng.normal(size=(1, 2, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    corners = rng.uniform(0, 100, (1, 2, 4, 2)).astype(np.float32)
    jdets = jgt.detections_from_arrays(ids, t, q, corners)
    dets = convert.detections_from_jax(jdets)
    for use_base in (True, False):
        jcfg = jgt.GroundTruthConfig(use_base_link=use_base)
        cfg = convert.gt_config_from_jax(dataclasses.asdict(jcfg))
        vo = OnlineVO(K=np.eye(3), real_marker_length=0.2, reference_id=3, cfg=CFG, gt_cfg=cfg, device="cpu")
        cTm, c, ok = vo._marker_info(dets)
        assert ok
        streams = jgt.derive_ground_truth(jdets, jnp.asarray(3), jcfg)
        np.testing.assert_allclose(cTm, np.asarray(streams.cTm[0]), atol=1e-6)
        np.testing.assert_array_equal(c, np.asarray(streams.corners[0]))
        np.testing.assert_allclose(cTm, tgt.marker_pose_to_cTm(dets.translations[0, 1], dets.quaternions[0, 1],
                                                               cfg).numpy(), atol=1e-6)
    vo = OnlineVO(K=np.eye(3), real_marker_length=0.2, reference_id=9, cfg=CFG, device="cpu")
    cTm, _, ok = vo._marker_info(dets)
    assert cTm is None and not ok


# --------------------------------------------------------------------------
# Against the reference's OnlineVO
# --------------------------------------------------------------------------


def test_online_vo_matches_reference_with_its_draws(seq):
    """The reference's OnlineVO and the port's on tests/test_stream.py's
    8-frame 640x480 sequence (frame 0 primes unarmed, then arms), the
    reference's fold_in(key, step) draws replayed. The C.2 tolerances of
    test_run_sequence_matches_reference: ok equal on every push, inlier
    counts within 2% and equal on all but one push, relative poses to 5e-3
    (XLA's jit moves the 8-point solves), and the chained poses to 1.2e-2."""
    jseq = jsynth.render_sequence(jsynth.SyntheticConfig(**SEQ_CFG))
    np.testing.assert_array_equal(jseq.frames, seq.frames)
    jvo = JOnlineVO(K=np.asarray(jseq.camera.K), real_marker_length=jseq.real_marker_length, reference_id=0,
                    cfg=JVOConfig(), gt_cfg=jgt.GroundTruthConfig(use_base_link=False), seed=0)
    vo = _engine(seq, draws=jax_push_draws(0))

    def jdets(i):
        d = tgt.frame_detections(seq, i)
        return None if d is None else jgt.detections_from_arrays(*(a.numpy() for a in d))

    pushes = [(0, False)] + [(i, True) for i in range(len(seq))]
    rows = []
    for i, with_marker in pushes:
        jr = jvo.push(jseq.timestamps[i], jseq.frames[i], jdets(i) if with_marker else None)
        tr = vo.push(seq.timestamps[i], seq.frames[i], tgt.frame_detections(seq, i) if with_marker else None)
        assert (tr.armed, tr.ok) == (jr.armed, jr.ok), i
        rows.append((tr, jr))
    ni = np.array([[t.n_inliers, j.n_inliers] for t, j in rows[2:]])
    print(f"n_inliers port {ni[:, 0].tolist()} reference {ni[:, 1].tolist()}")
    assert np.all(np.abs(ni[:, 0] - ni[:, 1]) <= 0.02 * ni[:, 1]) and (ni[:, 0] != ni[:, 1]).sum() <= 1
    rel = np.array([t.rel for t, _ in rows]) - np.array([j.rel for _, j in rows])
    pose = np.array([t.pose for t, _ in rows]) - np.array([j.pose for _, j in rows])
    print(f"max |rel| diff {np.abs(rel).max():.2e}, max |pose| diff {np.abs(pose).max():.2e}")
    assert np.abs(rel).max() <= 5e-3 and np.abs(pose).max() <= 1.2e-2


def test_step_eager_is_the_next_push(seq):
    """step_eager(frame, markers) computes the next push's output without
    advancing the engine: on the CPU (where the push itself runs eagerly)
    equal bit for bit to the push that follows, with the per-step keys
    fold_in(PRNGKey(seed), step) of the reference (stream.py:112)."""
    vo = _engine(seq)
    vo.push(seq.timestamps[0], seq.frames[0], tgt.frame_detections(seq, 0))
    for i in (1, 2):
        want = vo.step_eager(seq.frames[i], tgt.frame_detections(seq, i))
        r = vo.push(seq.timestamps[i], seq.frames[i], tgt.frame_detections(seq, i))
        np.testing.assert_array_equal(want[:16].numpy().reshape(4, 4), r.rel)
        assert (int(want[16]), bool(want[17])) == (r.n_inliers, r.ok)
    for step in (1, 2):
        np.testing.assert_array_equal(threefry.fold_in(threefry.prng_key(0), step).numpy(),
                                      np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), step)).astype(np.int64))


@pytest.mark.parametrize("frame", ["float32", "shape", "tensor_float32"])
def test_frames_keep_the_first_shape_and_dtype(frame):
    """The first frame pins the engine's frame shape and dtype (its graph's
    static input on the card): a later frame of another dtype or shape, as
    an array or a tensor, raises at push and at step_eager, and the engine
    does not advance."""
    small = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=3, width=160, height=120, n_landmarks=80))
    vo = _engine(small, VOConfig(n_keypoints=64, ransac=RansacConfig(n_hypotheses=64, lo_hypotheses=16)))
    vo.push(small.timestamps[0], small.frames[0], tgt.frame_detections(small, 0))
    bad = {"float32": small.frames[1].astype(np.float32), "shape": small.frames[1][:-8],
           "tensor_float32": torch.from_numpy(small.frames[1]).float()}[frame]
    for call in (lambda: vo.step_eager(bad, tgt.frame_detections(small, 1)),
                 lambda: vo.push(small.timestamps[1], bad, tgt.frame_detections(small, 1))):
        with pytest.raises(ValueError, match="the engine's frames are"):
            call()
    assert vo._step == 0
    assert vo.push(small.timestamps[1], torch.from_numpy(small.frames[1]), tgt.frame_detections(small, 1)).armed


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_host_arrays_and_tensors_push_alike(dtype):
    """A live node hands the engine host arrays or tensors: the same frames
    pushed either way give the same relative poses, chained poses, inlier
    and match counts bit for bit."""
    small = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=4, width=160, height=120, n_landmarks=80))
    cfg = VOConfig(n_keypoints=64, ransac=RansacConfig(n_hypotheses=64, lo_hypotheses=16))
    frames = small.frames.astype(dtype)
    host, tensors = _engine(small, cfg), _engine(small, cfg)
    for i in range(len(small)):
        dets = tgt.frame_detections(small, i)
        a = host.push(small.timestamps[i], frames[i], dets)
        b = tensors.push(small.timestamps[i], torch.from_numpy(frames[i]), dets)
        assert (a.armed, a.ok, a.n_inliers, a.n_matches) == (b.armed, b.ok, b.n_inliers, b.n_matches), i
        np.testing.assert_array_equal(a.rel, b.rel)
        np.testing.assert_array_equal(a.pose, b.pose)
    assert host._step == len(small) - 1 and a.n_matches > 0


def test_sift_mode_online_vo_tracks(seq):
    """OnlineVO with the SIFT frontend (the reference builds its detector
    with mode=cfg.frontend): armed pushes pass and the chain stays near the
    marker poses, as tests/test_sift.py's run_sequence bound."""
    cfg = VOConfig(frontend="sift", match_mode="ratio", dog_threshold=0.5,
                   ransac=RansacConfig(n_hypotheses=512, lo_hypotheses=128))
    vo = _engine(seq, cfg)
    oks = [vo.push(seq.timestamps[i], seq.frames[i], tgt.frame_detections(seq, i)).ok for i in range(4)]
    assert all(oks[1:])
    est = np.linalg.inv(vo.pose.astype(np.float64))[:3, 3]
    gt = np.linalg.inv(np.asarray(seq.marker_poses[3], np.float64))[:3, 3]
    assert np.linalg.norm(est - gt) < 0.3, (est, gt)


def test_online_vo_defaults_to_cuda(seq):
    """Built without a device, the engine runs on the card: here, without
    one, it raises rather than falling back to the CPU."""
    assert inspect.signature(OnlineVO).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnlineVO(K=np.asarray(seq.camera.K), real_marker_length=seq.real_marker_length)


# --------------------------------------------------------------------------
# Ground truth, se3.compose, converters, float global descriptors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(SEQ_CFG["n_frames"]))
def test_frame_detections_round_trip(seq, i):
    """Frame i as the one-frame detections a push gets (one slot, id 0):
    the push's ground-truth cTm and marker_pose_to_cTm both give back the
    frame's marker pose (float32 tolerance through the quaternion), and the
    push's corners are the frame's."""
    dets = tgt.frame_detections(seq, i)
    assert dets.ids.tolist() == [[0]] and dets.translations.shape == (1, 1, 3) and dets.corners.shape == (1, 1, 4, 2)
    cTm, corners, ok = _engine(seq)._marker_info(dets)
    assert ok
    np.testing.assert_allclose(cTm, seq.marker_poses[i], atol=1e-6)
    np.testing.assert_array_equal(corners, np.asarray(seq.marker_corners[i], np.float32))
    np.testing.assert_allclose(tgt.marker_pose_to_cTm(dets.translations[0, 0], dets.quaternions[0, 0],
                                                      tgt.GroundTruthConfig(use_base_link=False)).numpy(),
                               seq.marker_poses[i], atol=1e-6)


@pytest.mark.parametrize("case", ["absent", "other_id"])
def test_frame_detections_without_the_reference_marker(seq, case):
    """A frame that shows no marker gives None, and an engine pushed it
    stays unarmed; a marker under another id does not arm an engine that
    waits for id 0, and arms one that waits for its id at the same pose."""
    if case == "absent":
        present = np.asarray(seq.marker_present).copy()
        present[2] = False
        gap = dataclasses.replace(seq, marker_present=present)
        assert tgt.frame_detections(gap, 2) is None and tgt.frame_detections(gap, 3) is not None
        assert not _engine(seq).push(seq.timestamps[2], seq.frames[2], tgt.frame_detections(gap, 2)).armed
        return
    d = tgt.frame_detections(seq, 2)
    dets = d._replace(ids=torch.full_like(d.ids, 7))
    assert not _engine(seq).push(seq.timestamps[2], seq.frames[2], dets).armed
    vo = OnlineVO(K=np.asarray(seq.camera.K), real_marker_length=seq.real_marker_length, reference_id=7, cfg=CFG,
                  gt_cfg=tgt.GroundTruthConfig(use_base_link=False), device="cpu")
    r = vo.push(seq.timestamps[2], seq.frames[2], dets)
    assert r.armed
    np.testing.assert_allclose(r.gt_pose, seq.marker_poses[2], atol=1e-6)


def test_groundtruth_and_compose_agree():
    """GroundTruthConfig's extrinsic, marker_pose_to_cTm (both branches,
    batched) and se3.compose against the reference, to 1e-6."""
    rng = np.random.default_rng(4)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    for use_base in (True, False):
        jcfg = jgt.GroundTruthConfig(use_base_link=use_base)
        cfg = convert.gt_config_from_jax(dataclasses.asdict(jcfg))
        assert cfg == tgt.GroundTruthConfig(use_base_link=use_base)
        np.testing.assert_allclose(cfg.camera_T_base().numpy(), np.asarray(jcfg.camera_T_base()), atol=1e-6)
        ref = np.asarray(jax.vmap(lambda a, b: jgt.marker_pose_to_cTm(a, b, jcfg))(jnp.asarray(t), jnp.asarray(q)))
        np.testing.assert_allclose(tgt.marker_pose_to_cTm(torch.from_numpy(t), torch.from_numpy(q), cfg).numpy(),
                                   ref, atol=1e-6)
    Ts = [np.asarray(jse3.from_translation_quaternion(jnp.asarray(t[i]), jnp.asarray(q[i]))) for i in range(3)]
    np.testing.assert_allclose(tse3.compose(*(torch.from_numpy(T) for T in Ts)).numpy(),
                               np.asarray(jse3.compose(*(jnp.asarray(T) for T in Ts))), atol=1e-6)


def test_float_global_descriptors_and_counts_agree():
    """Loop closure on SIFT keyframe sets (the reference's features,
    converted): global descriptors to 1e-6, similarities to 1e-5, and the
    retrieval counts through the float match (crosscheck on squared L2)
    equal."""
    frames = jsynth.render_sequence(jsynth.SyntheticConfig(n_frames=4, width=384, height=288,
                                                           n_landmarks=250)).frames.astype(np.float32)
    jf = jax.device_get(jdetect_batch(jnp.asarray(frames), k=128, mode="sift", dog_threshold=0.5))
    desc, valid = torch.from_numpy(np.asarray(jf.desc)), torch.from_numpy(np.asarray(jf.valid))
    g = tlc.global_descriptors(desc, valid)
    gj = jlc.global_descriptors(jnp.asarray(jf.desc), jnp.asarray(jf.valid))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-6)
    np.testing.assert_allclose(tlc.global_similarity(g).numpy(), np.asarray(jlc.global_similarity(gj)), atol=1e-5)
    ia, ib = np.array([0, 0, 1, 2], np.int32), np.array([1, 3, 2, 3], np.int32)
    counts = tlc._retrieval_counts(desc, valid, ia, ib, 64.0).numpy()
    ref = np.asarray(jlc._retrieval_counts(jnp.asarray(jf.desc), jnp.asarray(jf.valid), jnp.asarray(ia),
                                           jnp.asarray(ib), 64.0))
    print(f"float retrieval counts port {counts.tolist()} reference {ref.tolist()}")
    np.testing.assert_array_equal(counts, ref)
    assert counts.min() > 0
