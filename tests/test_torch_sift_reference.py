"""The port's SIFT-mode VO against the benchmark's plain reference
(benchmark/plainref/frontend/sift.py, plainref/estimation/float_vo.py), on
the CPU: run_experiment(backend="none") at the bluerov_1440_sift
configuration's VO settings, with its K cut to 512 and its camera to 448x336,
on a small rendered clip; and the stages and counts the VO program marks
for the recorder.

Neither side imports JAX. Tolerances are stated per test.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))  # plainref, vobench

from plainref.core.camera import make_camera  # noqa: E402
from plainref.estimation import float_vo  # noqa: E402
from plainref.estimation.vo import VOConfig as RefVOConfig  # noqa: E402
from vobench import scene  # noqa: E402

from droplet_visual_odometry_tpu_torch import pipeline  # noqa: E402
from droplet_visual_odometry_tpu_torch.estimation import vo  # noqa: E402
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig  # noqa: E402
from droplet_visual_odometry_tpu_torch.frontend import sift  # noqa: E402

torch.set_num_threads(2)

K_SMALL = 512
SCALE = 448 / 1440
N_FRAMES = 8
SEED = 2**31 + 77


def small_config() -> dict:
    """The configuration with its camera cut to 448x336 (the focal lengths
    and principal point scaled alike, the distortion kept) and K to 512."""
    with open(os.path.join(REPO, "benchmark", "configs", "bluerov_1440_sift.json")) as f:
        cfg = json.load(f)
    cam = cfg["camera"]
    for key in ("fx", "fy", "cx", "cy"):
        cam[key] *= SCALE
    cam["width"], cam["height"] = 448, 336
    cfg["vo"]["n_keypoints"] = K_SMALL
    return cfg


@pytest.fixture(scope="module")
def clip():
    cfg = small_config()
    traffic = dict(clip_frames=N_FRAMES, sequence_frames=N_FRAMES, marker_keep=None)
    return scene.make_sequence(cfg, traffic, workers=1), cfg


@pytest.fixture(scope="module")
def runs(clip):
    """The program's run_experiment and the plain reference's float VO on
    the same raw frames and seed."""
    seq, cfg = clip
    res = pipeline.run_experiment(scene.program_sequence(seq), VOConfig(**cfg["vo"]), seed=SEED, backend="none",
                                  device="cpu")
    cam = seq.clip.camera
    camera = make_camera(cam.K[0, 0], cam.K[1, 1], cam.K[0, 2], cam.K[1, 2], cam.dist, cam.width, cam.height)
    traj, vo_abs = float_vo.run_vo(seq.frames, seq.marker_corners, seq.marker_present, seq.marker_poses, camera,
                                   seq.clip.marker_length, RefVOConfig(**cfg["vo"]), SEED % 2**32, "cpu")
    return res, traj, vo_abs


def test_sift_vo_against_the_plain_reference(runs):
    """Matches and inliers per pair equal: on the CPU both sides run the same
    float32 ops for the frontend (the reference in blocks of frames; every
    op is per frame) and read their match off the same `l2_matrix` (the
    program through the twin's argmins, the reference through the stable
    sort), and draw the same threefry uniforms, so the integer counts
    cannot differ. Relative poses within 1e-6 rad-equivalent (1e-4 deg)
    and 1e-6 m, the anchored trajectory within 1e-5 m: both chains round
    in float32 in the same order, the program's pose solve running on the
    same ops at the same batch of pairs (the reference matches 4 pairs at
    a time, then solves all 7 at once); the bounds leave room for BLAS
    choosing other kernels for other batch shapes."""
    res, traj, vo_abs = runs
    t = res.trajectory
    assert np.array_equal(t.n_matches, traj.n_matches) and np.array_equal(t.n_inliers, traj.n_inliers)
    assert int(np.min(t.n_matches)) >= 12 and bool(np.all(t.ok))
    rot = np.asarray(t.rel_poses, np.float64)[:, :3, :3] - np.asarray(traj.rel_poses, np.float64)[:, :3, :3]
    assert float(np.degrees(np.abs(rot).max())) < 1e-4
    trans = np.asarray(t.rel_poses, np.float64)[:, :3, 3] - np.asarray(traj.rel_poses, np.float64)[:, :3, 3]
    assert float(np.abs(trans).max()) < 1e-6
    assert float(np.abs(np.asarray(res.vo_abs)[:, :3, 3] - vo_abs[:, :3, 3]).max()) < 1e-5


def test_sift_reference_frontend_in_blocks_equals_the_program_frontend(clip):
    """The plain SIFT in blocks of 3 frames against the program's frontend on
    the whole batch of 5: keypoints, scores, descriptors and masks bit for
    bit (every op works within one frame); angles within 1e-6 rad, since
    the CPU reduces the orientation's 1369-term moment sums in another
    order for another batch size (one ulp, 2.4e-7, seen), which moves no
    angle bin here."""
    from plainref.frontend import sift as ref_sift

    seq, _ = clip
    frames = torch.from_numpy(seq.frames[:5].astype(np.float32))
    saved, ref_sift.BLOCK = ref_sift.BLOCK, 3
    try:
        ref = ref_sift.detect_and_describe(frames, k=K_SMALL, threshold=1.0)
    finally:
        ref_sift.BLOCK = saved
    got = sift.detect_and_describe(frames, k=K_SMALL, threshold=1.0)
    for name, x, y in zip(got._fields, got, ref):
        if name == "angle":
            assert float((x - y).abs().max()) <= 1e-6
        else:
            assert torch.equal(x, y), name


def test_vo_program_marks_its_match_and_float_stages(clip, monkeypatch):
    """The VO program marks `vo.match` around the matcher (pairs, keypoints,
    the descriptor's length, l2_kernel 0 on the CPU: the twin ran) and, with
    a float frontend, `vo.float_detect` and `vo.float_describe` (frames,
    keypoints). A stage records only inside a capture on the card, so a
    stand-in records what each stage is given here."""
    seq, cfg = clip
    marked = []

    class Stand:
        def __init__(self, name, **attrs):
            marked.append((name, attrs))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(vo.profiling, "device_stage", Stand)
    monkeypatch.setattr(sift.profiling, "device_stage", Stand)
    pipeline.run_experiment(scene.program_sequence(seq), VOConfig(**cfg["vo"]), seed=1, backend="none", device="cpu")
    stages = dict(marked)
    assert stages["vo.match"] == dict(pairs=N_FRAMES - 1, keypoints=K_SMALL, dim=128, l2_kernel=0)
    assert stages["vo.float_detect"] == stages["vo.float_describe"] == dict(frames=N_FRAMES, keypoints=K_SMALL)
    assert [n for n, _ in marked] == ["vo.frontend", "vo.float_detect", "vo.float_describe", "vo.solver", "vo.match"]

    marked.clear()
    orb = VOConfig(n_keypoints=256)
    pipeline.run_experiment(scene.program_sequence(seq), orb, seed=1, backend="none", device="cpu")
    stages = dict(marked)
    assert stages["vo.match"] == dict(pairs=N_FRAMES - 1, keypoints=256, dim=8, l2_kernel=0)
    assert "vo.float_detect" not in stages
