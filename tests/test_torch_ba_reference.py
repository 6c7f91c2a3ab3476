"""The port's windowed BA against the benchmark's plain reference
(benchmark/plainref/backend/ba.py, windowed_ba.py), on the CPU.

- backend/ba.run_ba against the plain LM (the full damped normal equations
  solved by LU) on seeded random windows;
- run_experiment(backend="ba") at the euroc_mav_752 configuration's VO and
  refine settings on a small rendered clip, against the plain windowed BA
  run on the program's own anchored VO output;
- the spans and counts refine_trajectory records, and the same result with
  the recorder off.

Tolerances are stated per test. Neither side imports JAX.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))  # plainref, vobench

from plainref.backend import ba as ref_ba  # noqa: E402
from plainref.backend import windowed_ba  # noqa: E402
from plainref import pipeline as ref_pipeline  # noqa: E402
from plainref.core.camera import make_camera  # noqa: E402
from vobench import scene  # noqa: E402

from droplet_visual_odometry_tpu_torch import pipeline  # noqa: E402
from droplet_visual_odometry_tpu_torch.backend import ba, refine  # noqa: E402
from droplet_visual_odometry_tpu_torch.core import se3  # noqa: E402
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig  # noqa: E402
from droplet_visual_odometry_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# run_ba against the plain LM
# --------------------------------------------------------------------------

def random_window(W: int, L: int, n_fixed: int, seed: int) -> ba.BAWindow:
    """A sideways camera path past L points 4-8 m away, pixel noise 0.5 px,
    a fifth of the observations dropped (each point kept in two views), the
    free poses perturbed by ~1 cm and ~0.6 deg and the points by 5 cm."""
    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]])
    pts = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(4, 8, L)], 1)
    poses = np.empty((W, 4, 4))
    for i in range(W):
        wTc = np.eye(4)
        wTc[:3, :3] = se3.se3_exp(torch.tensor([0, 0, 0, 0.01 * i, 0.02 * np.sin(i), 0.005 * i]))[:3, :3].numpy()
        wTc[:3, 3] = [0.15 * i, 0.03 * np.sin(i), 0.02 * i]
        poses[i] = np.linalg.inv(wTc)
    pc = np.einsum("wij,lj->wli", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    uv = np.stack([K[0, 0] * pc[..., 0] / pc[..., 2] + K[0, 2], K[1, 1] * pc[..., 1] / pc[..., 2] + K[1, 2]], -1)
    uv += rng.normal(scale=0.5, size=uv.shape)
    mask = rng.uniform(size=(W, L)) > 0.2
    mask[rng.integers(0, W, L), np.arange(L)] = True
    mask[(rng.integers(1, W, L) + np.argmax(mask, 0)) % W, np.arange(L)] = True
    init = poses.copy()
    for i in range(n_fixed, W):
        xi = torch.tensor(np.concatenate([rng.normal(scale=0.01, size=3), rng.normal(scale=0.01, size=3)]))
        init[i] = se3.se3_exp(xi).numpy() @ poses[i]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    return ba.BAWindow(poses=f32(init), points=f32(pts + rng.normal(scale=0.05, size=pts.shape)), obs_uv=f32(uv),
                       obs_mask=torch.as_tensor(mask), K=f32(K))


def _float64(w: ba.BAWindow) -> ba.BAWindow:
    return ba.BAWindow(*(t.double() if t.is_floating_point() else t for t in w))


@pytest.mark.parametrize("n_fixed", [1, 2])
@pytest.mark.parametrize("L", [64, 200])
@pytest.mark.parametrize("W", [3, 8])
def test_run_ba_against_the_plain_lm(W, L, n_fixed):
    """The Schur-complement LM and the plain LM on the full normal
    equations from one window, in float64 as refine_trajectory runs them.
    Tolerances: final cost to 1e-9 relative, poses to 1e-9 (rotation
    entries and metres), points to 1e-8 m at 4-8 m depth: the two solves
    round differently (a 3x3 Cholesky per landmark and a 6W system against
    one LU of 6W + 3L unknowns), in float64 at about 1e-12 (measured). The
    held poses are held exactly by both."""
    w = _float64(random_window(W, L, n_fixed, seed=100 * W + L + n_fixed))
    got = ba.run_ba(w, ba.BAConfig(n_fixed=n_fixed))
    want = ref_ba.run_ba(w.poses, w.points, w.obs_uv, w.obs_mask, w.K, ref_ba.BAConfig(n_fixed=n_fixed))
    assert got.poses.dtype == torch.float64
    assert float(got.initial_cost) == pytest.approx(want["initial_cost"], rel=1e-12)
    assert float(got.final_cost) < 0.5 * float(got.initial_cost)  # the window was solved, not left alone
    assert float(got.final_cost) == pytest.approx(want["final_cost"], rel=1e-9)
    assert torch.equal(got.poses[:n_fixed], w.poses[:n_fixed])
    assert torch.equal(want["poses"][:n_fixed], w.poses[:n_fixed])
    assert torch.allclose(got.poses, want["poses"], atol=1e-9, rtol=0)
    assert torch.allclose(got.points, want["points"], atol=1e-8, rtol=0)


def test_run_ba_float64_where_keyframes_nearly_coincide():
    """A window whose keyframes lie 5 mm apart (a hover: scale and depth
    barely observable), 300 points 1.2-3.5 m away: in float64 the port and
    the plain LM agree to 1e-9 m (measured 5e-13), while a float32 run of
    either lands more than a hundred times that from the float64 result
    (measured 3.1e-7 and 1.9e-5 m; at 0.5-1 mm apart, 1-2 mm). Why
    refine_trajectory builds its windows in float64 (refine.BA_DTYPE)."""
    rng = np.random.default_rng(5)
    K = np.array([[229.0, 0, 183], [0, 229, 124], [0, 0, 1]])
    pts = np.stack([rng.uniform(-1, 1, 300), rng.uniform(-0.7, 0.7, 300), rng.uniform(1.2, 3.5, 300)], 1)
    poses = np.stack([np.linalg.inv(np.block([[np.eye(3), np.array([[5e-3 * i], [5e-4 * np.sin(i)], [0]])],
                                              [np.zeros((1, 3)), np.ones((1, 1))]])) for i in range(8)])
    pc = np.einsum("wij,lj->wli", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    uv = np.stack([K[0, 0] * pc[..., 0] / pc[..., 2] + K[0, 2], K[1, 1] * pc[..., 1] / pc[..., 2] + K[1, 2]], -1)
    uv += rng.normal(scale=0.5, size=uv.shape)
    for i in range(2, 8):
        poses[i] = se3.se3_exp(torch.tensor(rng.normal(scale=0.002, size=6))).numpy() @ poses[i]
    w = ba.BAWindow(torch.tensor(poses), torch.tensor(pts * (1 + rng.normal(scale=0.01, size=(300, 1)))),
                    torch.tensor(uv), torch.ones((8, 300), dtype=torch.bool), torch.tensor(K))
    w32 = ba.BAWindow(*(t.float() if t.is_floating_point() else t for t in w))
    cfg, ref_cfg = ba.BAConfig(n_fixed=2), ref_ba.BAConfig(n_fixed=2)
    got = ba.run_ba(w, cfg).poses[:, :3, 3]
    gap = lambda other: float((other[:, :3, 3].double() - got).norm(dim=-1).max())
    assert gap(ref_ba.run_ba(*w, ref_cfg)["poses"]) < 1e-9
    assert gap(ba.run_ba(w32, cfg).poses) > 1e-7
    assert gap(ref_ba.run_ba(*w32, ref_cfg)["poses"]) > 1e-7


# --------------------------------------------------------------------------
# run_experiment(backend="ba") against the plain windowed BA
# --------------------------------------------------------------------------

def euroc_config() -> dict:
    """The euroc_mav_752 configuration with its camera halved (376x240, the
    same field of view), so a sequence runs on the CPU in seconds."""
    with open(os.path.join(REPO, "benchmark", "configs", "euroc_mav_752.json")) as f:
        cfg = json.load(f)
    cam = cfg["camera"]
    cfg["camera"] = dict(cam, width=376, height=240, fx=cam["fx"] / 2, fy=cam["fy"] / 2,
                         cx=(cam["cx"] + 0.5) / 2 - 0.5, cy=(cam["cy"] + 0.5) / 2 - 0.5)
    return cfg


@pytest.fixture(scope="module")
def clip():
    """A 36-frame rendered clip at the configuration's scene (at 36 frames
    the out-and-back clip moves 7.5 cm a frame, so windows hold tracks of
    three views and more), and the program's VO and refine configurations
    from the configuration."""
    cfg = euroc_config()
    traffic = dict(clip_frames=36, sequence_frames=36, marker_keep=None)
    seq = scene.make_sequence(cfg, traffic, workers=1)
    return seq, VOConfig(**cfg["vo"]), refine.RefineConfig(**cfg["refine"]), cfg


def _program(clip):
    seq, vo_cfg, refine_cfg, _ = clip
    return pipeline.run_experiment(scene.program_sequence(seq), vo_cfg, seed=7, backend="ba", refine_cfg=refine_cfg,
                                   device="cpu")


@pytest.fixture(scope="module")
def program_run(clip):
    """The program's run with the recorder on, and the clock as it began."""
    t0 = time.perf_counter()
    return _program(clip), t0


def test_run_experiment_ba_against_the_plain_reference(clip, program_run):
    """The plain windowed BA on the program's anchored VO output, from the
    raw frames: the same keyframes, the same windows solved and accepted,
    and refined poses within 1e-3 m and 0.05 deg. The bound: track
    triangulation (a 3x3 Cholesky against LU) and the two LM solves round
    differently in float32, and each window starts from the last one's
    result; measured 2.6e-6 and 2.9e-6 m on 36- and 48-frame clips of this
    scene (and up to 1e-3 on 24-frame clips, whose 11 cm steps leave
    windows of few tracks and a flat cost)."""
    seq, _, _, cfg = clip
    res, _ = program_run
    info = res.backend_info
    cam = seq.clip.camera
    camera = make_camera(cam.K[0, 0], cam.K[1, 1], cam.K[0, 2], cam.K[1, 2], cam.dist, cam.width, cam.height)
    preprocess = ref_pipeline.make_preprocessor(camera, "cpu")
    K = ref_pipeline.effective_K(camera).astype(np.float32)
    corners = ref_pipeline.effective_marker_corners(seq.marker_corners, camera, K)
    refined, ref_info = windowed_ba.refine_trajectory(
        lambda idx: preprocess(seq.frames[np.asarray(idx)]), _anchored(seq, res), res.trajectory.n_inliers, K,
        windowed_ba.RefineConfig(**cfg["refine"]), marker_corners=corners, marker_length=seq.clip.marker_length)
    assert info["n_keyframes"] == ref_info["n_keyframes"] >= 8
    assert info["windows"] == ref_info["windows"] >= 2
    assert [w["accepted"] for w in info["window_corr"]] == ref_info["accepted"]
    assert any(ref_info["accepted"])
    gap = np.linalg.norm(res.vo_abs[:, :3, 3] - refined[:, :3, 3], axis=1).max()
    assert gap < 1e-3
    dR = np.einsum("nij,nkj->nik", res.vo_abs[:, :3, :3], refined[:, :3, :3])
    assert np.degrees(np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))).max() < 0.05


def _anchored(seq, res) -> np.ndarray:
    """The program's VO poses anchored at the first marker frame, as
    run_experiment hands them to the backend."""
    vo_abs = np.asarray(res.trajectory.abs_poses, np.float64)
    first = int(np.argmax(seq.marker_present))
    if first > 0:
        vo_abs = vo_abs @ (np.linalg.inv(vo_abs[first]) @ np.asarray(seq.marker_poses[first], np.float64))
    return vo_abs


# --------------------------------------------------------------------------
# refine_trajectory's spans and counts
# --------------------------------------------------------------------------

def test_ba_window_counts_and_the_recorder_off(clip, program_run, monkeypatch):
    """run_experiment's spans hold refine.ba with refine.keyframes,
    refine.features, one ba.window per window walked and refine.reanchor;
    the windows not skipped sum to info["windows"] and their accepted
    counts to the windows the gates took. With the recorder off, no window
    span is recorded and the refined poses are the same bit for bit."""
    res, t0 = program_run
    recs = profiling.snapshot(t0)
    root = [r for r in recs if r.name == "pipeline.run_experiment"][-1]
    mine = [r for r in recs if r.root == root.seq]
    names = [r.name for r in mine]
    for name in ("refine.ba", "refine.keyframes", "refine.fetch", "refine.features", "ba.window", "ba.tracks",
                 "ba.solve", "ba.gate", "refine.reanchor"):
        assert name in names, name
    info = res.backend_info
    windows = [r for r in mine if r.name == "ba.window"]
    solved = [r for r in windows if not r.attrs["skipped"]]
    assert len(solved) == info["windows"]
    assert sum(r.attrs["accepted"] for r in windows) == sum(w["accepted"] for w in info["window_corr"])
    assert all(r.attrs["keyframes"] >= 3 and r.attrs["observations"] >= r.attrs["tracks"] * 3 for r in solved)
    assert next(r for r in mine if r.name == "refine.keyframes").attrs["keyframes"] == info["n_keyframes"]
    assert names.count("ba.solve") == names.count("ba.gate") == len(solved)
    assert names.count("ba.tracks") == len(windows)

    monkeypatch.setattr(profiling.RECORDER, "enabled", False)
    t0 = time.perf_counter()
    off = _program(clip)
    assert not [r for r in profiling.snapshot(t0) if r.name.startswith("ba.")]
    assert np.array_equal(off.vo_abs, res.vo_abs)
