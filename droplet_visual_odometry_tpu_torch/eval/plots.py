"""Trajectory + frontend-debug plotting, file-based.

A copy of droplet_visual_odometry_tpu/eval/plots.py (numpy in, PNG out;
matplotlib is imported inside each function, with the Agg backend). The
reference docstring follows.

Parity with plot_and_save (traj_evaluation_data_analysis.py:73-110), the
live 3-D GT-vs-VO plots (visual_odometry_v2.py:376-447), and the reference's
feature-debug imagery: matched-keypoint side-by-sides
(visualize_key_points_matching, visual_odometry_v3.py:174-187), drawKeypoints
overlays (v3:370-379), and marker-corner plots
(visualize_4D_marker_corners, v3:242-260) — rendered headlessly to PNG
(no GUI dependency).
"""

from __future__ import annotations

import numpy as np


def plot_trajectory_3d(
    path: str,
    named_position_streams: dict[str, np.ndarray],
    title: str = "trajectory",
) -> None:
    """Plot one or more (N, 3) position streams into a 3-D PNG.

    Prints the bounding-box extent like the reference does
    (data_analysis:102-108).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    for name, pos in named_position_streams.items():
        pos = np.asarray(pos)
        ax.plot(pos[:, 0], pos[:, 1], pos[:, 2], marker=".", markersize=3, label=name)
        ext = pos.max(0) - pos.min(0)
        print(f"{name}: extent x={ext[0]:.4f} y={ext[1]:.4f} z={ext[2]:.4f}")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _agg_plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_keypoints(
    path: str,
    frame: np.ndarray,
    xy: np.ndarray,
    valid: np.ndarray | None = None,
    title: str = "keypoints",
) -> None:
    """Overlay detected keypoints on a grayscale frame (cv2.drawKeypoints
    analog, visual_odometry_v3.py:370-379). xy is (K, 2) in (x, y) pixels."""
    plt = _agg_plt()
    frame = np.asarray(frame)
    xy = np.asarray(xy)
    if valid is not None:
        xy = xy[np.asarray(valid).astype(bool)]
    fig, ax = plt.subplots(figsize=(frame.shape[1] / 110, frame.shape[0] / 110))
    ax.imshow(frame, cmap="gray", interpolation="nearest")
    ax.scatter(xy[:, 0], xy[:, 1], s=14, facecolors="none", edgecolors="lime", linewidths=0.8)
    ax.set_title(f"{title} ({len(xy)} kp)")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_matches(
    path: str,
    frame_a: np.ndarray,
    frame_b: np.ndarray,
    xy_a: np.ndarray,
    xy_b: np.ndarray,
    match_idx: np.ndarray,
    match_valid: np.ndarray,
    inliers: np.ndarray | None = None,
    max_draw: int = 100,
    title: str = "matches",
) -> None:
    """Side-by-side matched-keypoint image (cv2.drawMatches analog,
    visualize_key_points_matching, visual_odometry_v3.py:174-187).

    xy_a: (K, 2) keypoints in frame A; match_idx/match_valid: (K,) matcher
    output (index into frame B per A keypoint + validity). If `inliers` (K,)
    is given (RANSAC verdict per match), inlier lines draw green and outlier
    lines red; otherwise all valid matches draw green. At most `max_draw`
    lines are drawn (evenly strided) so dense frames stay readable.
    """
    plt = _agg_plt()
    frame_a = np.asarray(frame_a)
    frame_b = np.asarray(frame_b)
    xy_a = np.asarray(xy_a)
    xy_b = np.asarray(xy_b)
    match_idx = np.asarray(match_idx)
    ok = np.asarray(match_valid).astype(bool)

    h = max(frame_a.shape[0], frame_b.shape[0])
    w_a, w_b = frame_a.shape[1], frame_b.shape[1]
    canvas = np.zeros((h, w_a + w_b), dtype=np.float32)
    canvas[: frame_a.shape[0], :w_a] = frame_a
    canvas[: frame_b.shape[0], w_a:] = frame_b

    rows = np.flatnonzero(ok)
    if len(rows) > max_draw:
        rows = rows[:: max(1, len(rows) // max_draw)][:max_draw]

    fig, ax = plt.subplots(figsize=((w_a + w_b) / 110, h / 110))
    ax.imshow(canvas, cmap="gray", interpolation="nearest")
    for r in rows:
        pa = xy_a[r]
        pb = xy_b[match_idx[r]]
        is_in = inliers is None or bool(np.asarray(inliers)[r])
        color = "lime" if is_in else "red"
        ax.plot([pa[0], w_a + pb[0]], [pa[1], pb[1]], color=color, linewidth=0.6, alpha=0.8)
        ax.scatter([pa[0], w_a + pb[0]], [pa[1], pb[1]], s=6, c=color)
    tag = f"{ok.sum()} matches"
    if inliers is not None:
        tag += f", {int(np.asarray(inliers)[ok].sum())} inliers"
    ax.set_title(f"{title} ({tag}; {len(rows)} drawn)")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_marker_corners(
    path: str,
    corners_prev: np.ndarray,
    corners_curr: np.ndarray,
    frame: np.ndarray | None = None,
    title: str = "marker corners",
) -> None:
    """Previous vs current marker-corner pixel positions, corner index
    labelled (visualize_4D_marker_corners analog, v3:242-260)."""
    plt = _agg_plt()
    cp = np.asarray(corners_prev)
    cc = np.asarray(corners_curr)
    fig, ax = plt.subplots(figsize=(7, 6))
    if frame is not None:
        ax.imshow(np.asarray(frame), cmap="gray", interpolation="nearest")
    ax.scatter(cp[:, 0], cp[:, 1], c="tab:blue", label="previous", s=30)
    ax.scatter(cc[:, 0], cc[:, 1], c="tab:orange", label="current", s=30)
    for i, (p, c) in enumerate(zip(cp, cc)):
        ax.annotate(str(i), p, color="tab:blue", fontsize=8)
        ax.annotate(str(i), c, color="tab:orange", fontsize=8)
        ax.plot([p[0], c[0]], [p[1], c[1]], color="gray", linewidth=0.5)
    if frame is None:
        ax.invert_yaxis()  # pixel coords
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
