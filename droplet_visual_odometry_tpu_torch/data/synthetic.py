"""Synthetic sequence renderer with exact analytic ground truth — port of
droplet_visual_odometry_tpu/data/synthetic.py, numpy only. For the same
`SyntheticConfig` it renders byte-identical frames to the reference.

The reference validates against recorded rosbags with an AR-tag oracle
(SURVEY.md §4); it has no way to test with *exact* ground truth. This module is
the replacement: a deterministic, host-side renderer that produces a
`VOSequence` — textured-square landmarks + a known-size fiducial quad — where
every camera pose, marker pose and marker corner is analytic. Used by the unit
and integration tests and by bench.py.

Pose conventions used throughout the package:
  * `wTc` — camera pose in world frame (camera->world point transform).
  * `cTm` — marker pose in camera frame; the GT stream the reference logs
    (traj_eval_ground_truth.py:279-298).
  * VO relative pose `rel` = curr_T_prev (maps prev-camera coords to
    curr-camera coords) — equal to cTm_curr @ inv(cTm_prev), matching the
    evaluation script's GT-relative convention (trajectory_evaluation_dual_process.py:134-137).
    Absolute chaining is therefore LEFT-multiplication: abs_curr = rel @ abs_prev.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from droplet_visual_odometry_tpu_torch.core.camera import make_camera
from droplet_visual_odometry_tpu_torch.data.sequence import VOSequence


@dataclasses.dataclass
class SyntheticConfig:
    n_frames: int = 60
    width: int = 640
    height: int = 480
    fx: float = 520.0
    fy: float = 520.0
    cx: float | None = None  # principal point; None = image centre
    cy: float | None = None
    n_landmarks: int = 400
    marker_length: float = 0.2  # metres, side of the fiducial square
    orbit_radius: float = 2.0  # camera distance from the marker wall
    orbit_sweep: float = 0.5  # radians swept over the sequence ("clockwise" arc)
    dolly: float = 0.0  # forward approach: radius shrinks by this much over the run
    loop: bool = False  # out-and-back: trajectory returns to the start pose
    bob: float = 0.05  # vertical bobbing amplitude (metres)
    landmark_depth_range: tuple[float, float] = (1.2, 3.5)
    landmark_size: float = 0.05  # metres, landmark square side
    noise_std: float = 2.0  # photometric noise (uint8 levels)
    fps: float = 20.0
    seed: int = 0
    distortion: np.ndarray | None = None  # plumb_bob 5-vector or None


def _look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """world_T_camera with camera +z toward `target` (OpenCV convention)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def trajectory(cfg: SyntheticConfig) -> np.ndarray:
    """Smooth orbit facing the marker wall -> (N, 4, 4) wTc poses."""
    n = cfg.n_frames
    if cfg.loop:
        # Smooth out-and-back (0 -> 1 -> 0 phase): the camera revisits its
        # start pose — the loop-closure test trajectory.
        phase = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.linspace(0.0, 1.0, n))
    else:
        phase = np.linspace(0.0, 1.0, n)
    angles = -cfg.orbit_sweep / 2 + cfg.orbit_sweep * phase
    radii = cfg.orbit_radius - cfg.dolly * phase
    poses = np.empty((n, 4, 4))
    target = np.array([0.0, 0.0, 0.0])
    for i, a in enumerate(angles):
        eye = np.array(
            [
                radii[i] * np.sin(a),
                cfg.bob * np.sin(3.0 * a / max(cfg.orbit_sweep, 1e-6)),
                -radii[i] * np.cos(a),
            ]
        )
        poses[i] = _look_at(eye, target, np.array([0.0, -1.0, 0.0]))
    return poses


def _fill_convex_quad(img: np.ndarray, quad: np.ndarray, value: float) -> None:
    """Rasterise a convex quad (4, 2) in pixel coords into img (in place)."""
    h, w = img.shape
    u0 = max(int(np.floor(quad[:, 0].min())), 0)
    u1 = min(int(np.ceil(quad[:, 0].max())) + 1, w)
    v0 = max(int(np.floor(quad[:, 1].min())), 0)
    v1 = min(int(np.ceil(quad[:, 1].max())) + 1, h)
    if u1 <= u0 or v1 <= v0:
        return
    uu, vv = np.meshgrid(np.arange(u0, u1) + 0.5, np.arange(v0, v1) + 0.5)
    inside = np.ones(uu.shape, bool)
    # Ensure counter-clockwise orientation for the half-plane test.
    area = 0.0
    for k in range(4):
        a, b = quad[k], quad[(k + 1) % 4]
        area += (b[0] - a[0]) * (b[1] + a[1])
    q = quad if area < 0 else quad[::-1]
    for k in range(4):
        a, b = q[k], q[(k + 1) % 4]
        inside &= (b[0] - a[0]) * (vv - a[1]) - (b[1] - a[1]) * (uu - a[0]) >= 0
    img[v0:v1, u0:u1][inside] = value


def _distort_np(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """plumb_bob distortion on normalized coords (N, 2) — numpy twin of
    core.camera.distort_normalized, so rendered geometry goes through the
    same lens model the pipeline undistorts (v3:110-135 parity end-to-end)."""
    k1, k2, p1, p2, k3 = dist[:5]
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=1)


def marker_world_corners(marker_length: float) -> np.ndarray:
    """Fiducial corners in world frame: square centred at origin on the z=0
    wall, ordered like STag (consistent winding). (4, 3)."""
    s = marker_length / 2.0
    return np.array(
        [[-s, -s, 0.0], [s, -s, 0.0], [s, s, 0.0], [-s, s, 0.0]]
    )


def render_sequence(cfg: SyntheticConfig | None = None) -> VOSequence:
    cfg = cfg or SyntheticConfig()
    rng = np.random.default_rng(cfg.seed)
    w, h = cfg.width, cfg.height
    cam = make_camera(
        cfg.fx,
        cfg.fy,
        w / 2.0 - 0.5 if cfg.cx is None else cfg.cx,
        h / 2.0 - 0.5 if cfg.cy is None else cfg.cy,
        cfg.distortion,
        w,
        h,
    )
    K = np.asarray(cam.K, np.float64)

    # Landmarks: squares scattered on/near the z~0 wall, in front of the orbit.
    lo, hi = cfg.landmark_depth_range
    span_x = cfg.orbit_radius * (np.sin(cfg.orbit_sweep / 2) + 1.1)
    lm_pos = np.stack(
        [
            rng.uniform(-span_x, span_x, cfg.n_landmarks),
            rng.uniform(-0.75 * cfg.orbit_radius, 0.75 * cfg.orbit_radius, cfg.n_landmarks),
            rng.uniform(-(hi - cfg.orbit_radius), cfg.orbit_radius - lo, cfg.n_landmarks),
        ],
        axis=1,
    )
    lm_intensity = rng.uniform(40, 250, cfg.n_landmarks)
    lm_size = rng.uniform(0.5, 1.5, cfg.n_landmarks) * cfg.landmark_size
    # Inner sub-square per landmark: breaks the 4-fold corner symmetry so
    # rotation-steered descriptors can tell a square's corners apart.
    lm_inner_intensity = rng.uniform(20, 250, cfg.n_landmarks)
    lm_inner_offset = rng.uniform(-0.4, 0.4, size=(cfg.n_landmarks, 2))

    wTm = np.eye(4)  # marker frame == world frame (marker on the z=0 wall)
    m_corners_w = marker_world_corners(cfg.marker_length)
    border = cfg.marker_length * 0.25
    m_outer_w = marker_world_corners(cfg.marker_length + 2 * border)

    poses = trajectory(cfg)
    frames = np.empty((cfg.n_frames, h, w), np.uint8)
    marker_corners = np.full((cfg.n_frames, 4, 2), np.nan, np.float32)
    marker_poses = np.zeros((cfg.n_frames, 4, 4), np.float32)
    marker_present = np.zeros(cfg.n_frames, bool)

    dist = np.asarray(cam.dist, np.float64)
    has_dist = bool(np.any(dist))

    def project(cTw: np.ndarray, pts_w: np.ndarray):
        pc = pts_w @ cTw[:3, :3].T + cTw[:3, 3]
        z = pc[:, 2]
        xy = pc[:, :2] / np.maximum(z[:, None], 1e-6)
        if has_dist:
            xy = _distort_np(xy, dist)
        uv = xy * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        return uv, z

    for i in range(cfg.n_frames):
        wTc = poses[i]
        cTw = np.linalg.inv(wTc)
        # Smooth background gradient so the frame is not flat.
        yy, xx = np.mgrid[0:h, 0:w]
        img = 90.0 + 25.0 * np.sin(xx / 97.0 + i * 0.03) + 15.0 * np.cos(yy / 61.0)

        # Landmarks far-to-near (painter's algorithm).
        uv, z = project(cTw, lm_pos)
        order = np.argsort(-z)
        for j in order:
            if z[j] < 0.2:
                continue
            half_px = 0.5 * lm_size[j] * K[0, 0] / z[j]
            if half_px < 1.0 or half_px > 60.0:
                continue
            c = uv[j]
            quad = np.array(
                [
                    [c[0] - half_px, c[1] - half_px],
                    [c[0] + half_px, c[1] - half_px],
                    [c[0] + half_px, c[1] + half_px],
                    [c[0] - half_px, c[1] + half_px],
                ]
            )
            _fill_convex_quad(img, quad, lm_intensity[j])
            ic = c + lm_inner_offset[j] * half_px
            ih = half_px * 0.4
            if ih >= 1.0:
                iq = np.array(
                    [
                        [ic[0] - ih, ic[1] - ih],
                        [ic[0] + ih, ic[1] - ih],
                        [ic[0] + ih, ic[1] + ih],
                        [ic[0] - ih, ic[1] + ih],
                    ]
                )
                _fill_convex_quad(img, iq, lm_inner_intensity[j])

        # Fiducial: dark border quad then bright inner quad (STag-like contrast).
        ouv, oz = project(cTw, m_outer_w)
        iuv, iz = project(cTw, m_corners_w)
        if np.all(iz > 0.2):
            _fill_convex_quad(img, ouv, 15.0)
            _fill_convex_quad(img, iuv, 235.0)
            in_frame = (
                (iuv[:, 0] >= 0) & (iuv[:, 0] < w) & (iuv[:, 1] >= 0) & (iuv[:, 1] < h)
            )
            if np.all(in_frame):
                marker_corners[i] = iuv.astype(np.float32)
                marker_poses[i] = (cTw @ wTm).astype(np.float32)
                marker_present[i] = True

        img += rng.normal(scale=cfg.noise_std, size=img.shape)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)

    seq = VOSequence(
        frames=frames,
        timestamps=np.arange(cfg.n_frames, dtype=np.float64) / cfg.fps,
        marker_corners=marker_corners,
        marker_poses=marker_poses,
        marker_present=marker_present,
        marker_ids=np.where(marker_present, 0, -1).astype(np.int32),
        camera=cam,
        real_marker_length=cfg.marker_length,
        gt_poses=poses.astype(np.float32),
        landmarks=lm_pos.astype(np.float32),
    )
    seq.validate()
    return seq
