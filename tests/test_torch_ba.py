"""The port's windowed-BA backend vs the JAX reference (CPU).

Modules: backend/ba.py (reprojection cost, normal blocks, the Schur solve on
random SPD blocks, run_ba on tests/test_backend.py's synthetic windows),
backend/tracks.py (track building, triangulation and the reprojection
filter on the JAX frontend's features), the config builders, and
backend/refine.refine_trajectory and run_experiment(backend="ba") on the
32-frame 448x336 marker-gap loop of torch_backend_data. Tolerances are
stated per test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu import pipeline as jpipe
from droplet_visual_odometry_tpu.backend import ba as jba
from droplet_visual_odometry_tpu.backend import keyframes as jkf
from droplet_visual_odometry_tpu.backend import refine as jrefine
from droplet_visual_odometry_tpu.backend import tracks as jtracks
from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig as JRansacConfig
from droplet_visual_odometry_tpu.estimation.vo import VOConfig as JVOConfig
from droplet_visual_odometry_tpu.frontend.features import detect_and_describe_batch as jdetect

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch import pipeline as tpipe
from droplet_visual_odometry_tpu_torch.backend import ba as tba
from droplet_visual_odometry_tpu_torch.backend import refine as trefine
from droplet_visual_odometry_tpu_torch.backend import tracks as ttracks
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.eval import tum as ttum
from droplet_visual_odometry_tpu_torch.frontend.orb import Features

from test_backend import make_ba_problem
from torch_backend_data import LOOP_CFG, RANSAC_KW, mask_marker_midrun

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _twindow(w):
    return tba.BAWindow(*(_t(a) for a in w))


# --------------------------------------------------------------------------
# backend/ba
# --------------------------------------------------------------------------

WINDOWS = {
    "noisy": dict(noise_px=0.5),
    "pose_noise": dict(noise_px=0.2, pose_noise=0.03),
    "perfect": dict(noise_px=0.0, pose_noise=0.0, point_noise=0.0),
    "wide": dict(W=8, L=300, noise_px=1.0, drop=0.3, seed=4),
}


@pytest.mark.parametrize("name", list(WINDOWS) + ["empty_rows"])
@pytest.mark.parametrize("n_fixed", [1, 2])
def test_run_ba_agrees(name, n_fixed):
    """run_ba on test_backend.py's windows (and with the last 30 landmarks
    unobserved): costs to 1e-4 relative, RMS to 1e-3 px, poses to 1e-3,
    points to 5e-3 m at 4-9 m depth (f32 LAPACK LU and einsum order against
    XLA's; measured 2.6e-4 and 1.3e-3), the fixed poses held exactly."""
    w, _, _ = make_ba_problem(**WINDOWS.get(name, {}))
    if name == "empty_rows":
        mask = np.array(w.obs_mask)
        mask[:, -30:] = False
        w = w._replace(obs_mask=jnp.asarray(mask))
    cfg = jba.BAConfig(n_fixed=n_fixed)
    ref = jax.jit(jba.run_ba, static_argnames="cfg")(w, cfg)
    out = tba.run_ba(_twindow(w), convert.ba_config_from_dict(dataclasses.asdict(cfg)))
    for f in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(out, f)), float(getattr(ref, f)), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(float(out.rms_px), float(ref.rms_px), atol=1e-3)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=1e-3)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points), atol=5e-3)
    np.testing.assert_array_equal(out.poses[:n_fixed].numpy(), np.asarray(w.poses)[:n_fixed])
    assert float(out.final_cost) <= float(out.initial_cost)


def test_normal_blocks_and_cost_agree():
    """_build_normal_blocks and reprojection_cost on a perturbed window: each
    block to 1e-4 of its largest entry (f32 einsums in another order)."""
    w, _, _ = make_ba_problem(noise_px=0.5, seed=2)
    ref = jba._build_normal_blocks(w, w.poses, w.points, 2.0, 1e-3)
    tw = _twindow(w)
    out = tba._build_normal_blocks(tw, tw.poses, tw.points, 2.0, 1e-3)
    for name, a, b in zip(("Hcc", "Hll", "Hcl", "bc", "bl"), out, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(), err_msg=name)
    c_ref, r_ref, w_ref = jba.reprojection_cost(w, w.poses, w.points, 2.0, 1e-3)
    c, r, wgt = tba.reprojection_cost(tw, tw.poses, tw.points, 2.0, 1e-3)
    np.testing.assert_allclose(float(c), float(c_ref), rtol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=1e-3)
    np.testing.assert_allclose(wgt.numpy(), np.asarray(w_ref), atol=1e-5)


@pytest.mark.parametrize("n_fixed", [0, 1, 2])
def test_schur_solve_agrees(n_fixed):
    """schur_solve on random SPD blocks (W = 5, L = 40): the pose twists and
    landmark steps to 1e-4 of their largest entry, the fixed twists zero."""
    rng = np.random.default_rng(7 + n_fixed)
    W, L = 5, 40
    J = rng.normal(size=(W, L, 2, 9)).astype(np.float32)
    H = np.einsum("wlik,wlim->wlkm", J, J)  # per observation, SPD in the joint (6 + 3) block
    Hcc = H[:, :, :6, :6].sum(1) + np.eye(6, dtype=np.float32)
    Hll = H[:, :, 6:, 6:].sum(0) + np.eye(3, dtype=np.float32)
    Hcl = H[:, :, :6, 6:]
    bc = rng.normal(size=(W, 6)).astype(np.float32)
    bl = rng.normal(size=(L, 3)).astype(np.float32)
    args = (Hcc, Hll, Hcl, bc, bl)
    dc_ref, dx_ref = jba.schur_solve(*(jnp.asarray(a) for a in args), 1e-3, n_fixed=n_fixed)
    dc, dx = tba.schur_solve(*(_t(a) for a in args), torch.tensor(1e-3), n_fixed=n_fixed)
    for a, b in ((dc, dc_ref), (dx, dx_ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max())
    assert not dc[:n_fixed].any()


# --------------------------------------------------------------------------
# backend/tracks on the JAX frontend's features
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def track_inputs():
    seq = jsynth.render_sequence(jsynth.SyntheticConfig(n_frames=12, width=640, height=480, n_landmarks=350))
    feats = jdetect(jnp.asarray(seq.frames[:5], jnp.float32))
    tfeats = Features(
        xy=_t(feats.xy), score=_t(feats.score), angle=_t(feats.angle),
        desc=torch.from_numpy(np.array(feats.desc).view(np.int32)), valid=_t(feats.valid),
    )
    jlist = [jax.tree_util.tree_map(lambda a, i=i: a[i], feats) for i in range(5)]
    poses = np.linalg.inv(seq.gt_poses[:5]).astype(np.float32)  # camera-from-world
    return seq, jlist, tfeats, poses


def test_build_tracks_equal(track_inputs):
    """The same features give the reference's track grid exactly: the
    consecutive matches in one call, then the chain."""
    _, jlist, tfeats, _ = track_inputs
    ref = jtracks.build_tracks(jlist)
    m = ttracks.match_consecutive(tfeats)
    assert m.idx.shape == (4, tfeats.xy.shape[1])
    out = ttracks.build_tracks(tfeats, m)
    np.testing.assert_array_equal(out.obs_mask.numpy(), np.asarray(ref.obs_mask))
    np.testing.assert_array_equal(out.obs_uv.numpy(), np.asarray(ref.obs_uv))
    assert out.obs_mask.sum(1)[-1] > 25


def test_triangulate_and_filter_agree(track_inputs):
    """triangulate_tracks and filter_by_reprojection on the exact track grid
    and ground-truth poses: the valid and kept masks equal, points to 1e-3
    of their depth (a 3x3 Cholesky solve in another summation order)."""
    seq, jlist, tfeats, poses = track_inputs
    ref_grid = jtracks.build_tracks(jlist)
    K = np.asarray(seq.camera.K, np.float32)
    X_ref, v_ref = jtracks.triangulate_tracks(ref_grid, jnp.asarray(poses), jnp.asarray(K), min_views=3)
    grid = ttracks.build_tracks(tfeats, ttracks.match_consecutive(tfeats))
    X, v = ttracks.triangulate_tracks(grid, _t(poses), _t(K), min_views=3)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    assert int(v.sum()) > 50
    sel = np.asarray(v_ref)
    X_ref = np.asarray(X_ref)
    np.testing.assert_allclose(X.numpy()[sel], X_ref[sel], atol=1e-3 * np.abs(X_ref[sel, 2]).max())
    f_ref = jtracks.filter_by_reprojection(ref_grid, jnp.asarray(X_ref), jnp.asarray(poses), jnp.asarray(K), 3.0, 3)
    f = ttracks.filter_by_reprojection(grid, _t(X_ref), _t(poses), _t(K), 3.0, 3)
    np.testing.assert_array_equal(f.obs_mask.numpy(), np.asarray(f_ref.obs_mask))


# --------------------------------------------------------------------------
# refine_trajectory and run_experiment(backend="ba") on the marker-gap loop
# --------------------------------------------------------------------------

JVO = JVOConfig(scale_mode="hold", ransac=JRansacConfig(**RANSAC_KW))


@pytest.fixture(scope="module")
def loop_seqs():
    j = mask_marker_midrun(jsynth.render_sequence(jsynth.SyntheticConfig(**LOOP_CFG)))
    t = mask_marker_midrun(tsynth.render_sequence(tsynth.SyntheticConfig(**LOOP_CFG)))
    np.testing.assert_array_equal(t.frames, j.frames)
    return j, t


@pytest.fixture(scope="module")
def jax_ba_run(loop_seqs):
    return jpipe.run_experiment(loop_seqs[0], JVO, seed=0, backend="ba")


def _accepted(info):
    return [i for i, r in enumerate(info.get("window_corr", [])) if r["accepted"]]


def test_refine_trajectory_agrees(loop_seqs, jax_ba_run, monkeypatch):
    """The reference run's VO outputs into both backends, the port's BA
    geometry at the reference's float32 (refine.BA_DTYPE; the main path's
    float64 is held against the plain float64 LM in
    test_torch_ba_reference.py): keyframes, windows run, the list of
    accepted windows and which gate decided each equal; RMS to 1e-3 px; the
    gates' figures to 0.02 (px, deg or fraction); refined poses to 2e-3
    (measured 5.8e-4)."""
    monkeypatch.setattr(trefine, "BA_DTYPE", torch.float32)
    j, t = loop_seqs
    traj = jax_ba_run.trajectory
    args = (np.asarray(traj.abs_poses, np.float64), np.asarray(traj.n_inliers))
    K = np.asarray(j.camera.K, np.float32)
    corners = np.asarray(j.marker_corners, np.float32)
    ref, ref_info = jrefine.refine_trajectory(jnp.asarray(j.frames, jnp.float32), *args, jnp.asarray(K),
                                              jrefine.RefineConfig(), marker_corners=corners,
                                              real_marker_length=j.real_marker_length)
    out, info = trefine.refine_trajectory(torch.from_numpy(t.frames).float(), *args, K, trefine.RefineConfig(),
                                          marker_corners=corners, real_marker_length=t.real_marker_length)
    print(f"port {info}\nreference {ref_info}")
    assert info["n_keyframes"] == ref_info["n_keyframes"] and info["windows"] == ref_info["windows"] >= 3
    assert _accepted(info) == _accepted(ref_info) and 0 < len(_accepted(info)) < info["windows"]
    for a, b in zip(info["window_corr"], ref_info["window_corr"]):
        assert sorted(a) == sorted(b)
        for k in a:
            if k != "accepted":
                np.testing.assert_allclose(a[k], b[k], atol=0.02)
    np.testing.assert_allclose(info["rms_px"], ref_info["rms_px"], atol=1e-3)
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_run_experiment_ba_agrees(loop_seqs, jax_ba_run, tmp_path):
    """run_experiment(backend="ba", device="cpu") with its default draws,
    the reference's for seed 0: the six TUM files, windows run and accepted,
    and the ATE held to the reference's seed-0 figure within 1 cm, the
    replayed-draw tolerance of ROADMAP C.2 (measured 4.6 mm; the reference's
    own seed-to-seed spread is 0.080 m: ATE RMSE 0.1465 / 0.0806 / 0.0884 /
    0.0664 m over RANSAC seeds 0-3)."""
    res = tpipe.run_experiment(loop_seqs[1], convert.vo_config_from_dict(dataclasses.asdict(JVO)), str(tmp_path), 0,
                               backend="ba", device="cpu")
    info, ref_info = res.backend_info, jax_ba_run.backend_info
    print(f"ATE port {res.ate.rmse} reference {jax_ba_run.ate.rmse}; port {info}\nreference {ref_info}")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(ttum.STREAM_NAMES)
    assert np.isfinite(res.vo_abs).all()
    assert info["windows"] >= 1 and len(_accepted(info)) >= 1 and len(info["rms_px"]) == len(_accepted(info))
    assert abs(res.ate.rmse - jax_ba_run.ate.rmse) < 1e-2


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "builder,ref",
    [
        ("ba_config_from_dict", jba.BAConfig(iters=4, n_fixed=2)),
        ("refine_config_from_dict", jrefine.RefineConfig(window=6, kf=jkf.KeyframeConfig(max_gap=4),
                                                         ba=jba.BAConfig(huber_px=1.0))),
    ],
)
def test_ba_config_converters_equal(builder, ref):
    """Each builder gives the reference's config field by field, and the
    port's defaults equal the reference's."""
    out = getattr(convert, builder)(dataclasses.asdict(ref))
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert dataclasses.asdict(type(out)()) == dataclasses.asdict(type(ref)())
