"""Accuracy-parity harness of the PyTorch port: the reference pipeline vs
the port, end to end, on the card.

The port's counterpart of the repo's parity.py. It renders the same five
synthetic scenarios with the port's renderer (byte-identical to the JAX
package's), runs the reference's OpenCV chain on the host in its three
variants, runs every "ours" row through the port's
pipeline.run_experiment on `--device` (the card unless "cpu"), scores each
row by ATE/RPE on camera-centre trajectories over the marker-present frames
(align='none'), and holds each "ours" row to the JAX package's row of
PARITY.md on the same scenario (JAX_ATE_RMSE, within twice the JAX
package's seed 0-3 spread, the width of JAX_ATE_RANGE; a row outside that
range of seeds is reported even where it holds).

The reference chain (file:line in the reference repository) is a copy of
parity.py's, function for function, with its six faithful quirks and the
bugs-fixed "intent" variant:

  seed    abs_0 = first GT marker pose cTm_0           dual_process:102-117, 193-198
  detect  ORB/SIFT detectAndCompute on BOTH frames     visual_odometry_v3.py:387-392
  match   BFMatcher crosscheck (orb) / KNN+ratio       v3:191-239
  E       findEssentialMat(p_prev, p_curr, K, RANSAC,
          prob=.999, thr=1.0) + recoverPose            v3:297-306
  scale   triangulatePoints(prev_P, K[R|t], corners),
          scale = L / dist(corner0, corner1)           v3:263-291, 309-326
  rel     Trans(t*scale) @ Rot(euler round-trip)       v3:328-345
  chain   abs = abs_prev @ rel                         v3:349-368
  rect    cv.undistort under getOptimalNewCameraMatrix(alpha=1) when the
          camera has distortion                         v3:110-135

`faithful=True` keeps the reference's quirks: (1) corners from the previous
valid set, (2) triangulated corners not divided by w, (3) the previous
pair's K[R|t] as projMatr1, (4) the rxyz/sxyz euler round-trip, (5) abs =
abs_prev @ rel, (6) on a distorted camera the original K for the geometry
and the raw corner detections. `faithful=False` fixes all six. Only
marker-bearing frames enter the reference's stream
(get_valid_message_stream.py:21-37); the port processes every frame.

Gates (full mode; --quick shrinks the sequences and runs "ours none" only,
so it is a smoke run and exits 0): in every scenario the best "ours" row
and the shipped default (pose_graph+hold) are no worse than the best
reference row of the same run, and every "ours" row lies within its hold of
the JAX package's row. The exit code is 1 when any of them fails.

Usage:
  python -m droplet_visual_odometry_tpu_torch.parity [--device cpu] [--quick]
      [--scenario NAME] [--write-md] [--commit TEXT]
Prints one JSON line per scenario; --write-md writes PARITY_TORCH.md in the
working directory, its header naming the card and the commit (--commit's
text where the package is not in a git checkout).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

from droplet_visual_odometry_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# The reference pipeline, ported (OpenCV + numpy, like the original): a copy
# of parity.py's, function for function.
# ---------------------------------------------------------------------------


def _euler_roundtrip_rotation(R_mat: np.ndarray) -> np.ndarray:
    """v3:334-339 -> :138-142: euler_from_matrix(R, 'rxyz') then
    euler_matrix(euler, 'sxyz'). tf 'rxyz' (rotating/intrinsic xyz) is
    scipy 'XYZ'; tf 'sxyz' (static/extrinsic xyz) is scipy 'xyz'. The
    mismatched conventions permute the composition order — reproduced, not
    fixed, in the faithful port."""
    from scipy.spatial.transform import Rotation

    euler = Rotation.from_matrix(R_mat).as_euler("XYZ")
    return Rotation.from_euler("xyz", euler).as_matrix()


class ReferenceVO:
    """Faithful port of VisualOdometry (visual_odometry_v3.py:29-408) +
    the dual_process driver loop (trajectory_evaluation_dual_process.py:170-254).

    mode='orb' is the reference's default-parameter path (cv.ORB_create() =
    500 keypoints, BFMatcher NORM_HAMMING crossCheck — v3:96, 75) with its
    match-indexing type bug (v3:233-238 indexes a flat DMatch list as nested)
    resolved to its evident intent; mode='knn_sift' is the mode the driver's
    folder naming says was actually run (*_knn_sift.bag — dual_process:296).
    """

    def __init__(
        self, K, real_marker_length, mode="orb", faithful=True,
        dist=None, size=None,
    ):
        import cv2

        self.cv2 = cv2
        self.K = np.asarray(K, np.float64)
        self.real_marker_length = float(real_marker_length)
        self.mode = mode
        self.faithful = faithful
        # Undistortion leg (v3:110-135): active only when the camera model
        # has distortion. new_K is hoisted out of the per-frame loop (the
        # reference recomputes an identical matrix every frame, v3:117-123).
        self.dist = None
        self.new_K = None
        if dist is not None and np.any(np.asarray(dist)):
            assert size is not None, "distorted camera needs (width, height)"
            self.dist = np.asarray(dist, np.float64).reshape(-1)
            w, h = int(size[0]), int(size[1])
            self.size = (w, h)
            self.new_K, _ = cv2.getOptimalNewCameraMatrix(
                self.K, self.dist, (w, h), 1, (w, h)
            )
        # Geometry matrix for E/recoverPose/projection: the reference keeps
        # using the ORIGINAL K after rectifying under new_K (quirk #6,
        # v3:297-309); the intent variant uses new_K consistently.
        self.geom_K = self.K
        if self.new_K is not None and not faithful:
            self.geom_K = np.asarray(self.new_K, np.float64)
        if mode == "orb":
            self.detector = cv2.ORB_create()
            self.bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        elif mode == "knn_sift":
            self.detector = cv2.SIFT_create()
            self.bf = cv2.BFMatcher(cv2.NORM_L1, crossCheck=False)
        else:
            raise ValueError(mode)
        # v3:164-166 (controlled branch — the uncontrolled branch leaves this
        # None and crashes on the first triangulation, so the working
        # configuration is ported).
        self.previous_projection_matrix = self.geom_K @ np.hstack(
            [np.eye(3), np.zeros((3, 1))]
        )
        self.n_failures = 0

    def _rectify(self, img):
        """cv.undistort leg (v3:110-113) — identity for distortion-free cams."""
        if self.dist is None:
            return img
        return self.cv2.undistort(
            img, self.K, self.dist, newCameraMatrix=self.new_K
        )

    def _corners_for_scale(self, corners):
        """Marker corners as the scale triangulation sees them. Faithful: the
        raw distorted-stream detections (quirk #6). Intent: undistorted into
        the new_K pixel frame the rectified keypoints live in."""
        if self.dist is None or self.faithful:
            return np.asarray(corners, np.float64)
        c = np.asarray(corners, np.float64).reshape(-1, 1, 2)
        und = self.cv2.undistortPoints(c, self.K, self.dist, P=self.new_K)
        return und.reshape(-1, 2)

    def _match(self, d1, k1, d2, k2):
        cv2 = self.cv2
        if self.mode == "orb":
            matches = sorted(self.bf.match(d1, d2), key=lambda m: m.distance)
        else:  # knn + Lowe ratio (v3:204, 225-230)
            knn = self.bf.knnMatch(d1, d2, k=2)
            matches = [m for m, n in knn if m.distance < 0.75 * n.distance]
        p1 = np.float32([k1[m.queryIdx].pt for m in matches])
        p2 = np.float32([k2[m.trainIdx].pt for m in matches])
        return p1, p2

    def step(self, prev_img, curr_img, prev_abs, prev_corners, curr_corners):
        """One visual_odometry_calculations pair (v3:384-408).

        Returns (abs, rel); on the degenerate cases where the reference would
        crash (too few matches, E estimation failure), counts the failure and
        holds the pose (rel = I) so the run can be scored at all.
        """
        cv2 = self.cv2
        prev_img = self._rectify(prev_img)
        curr_img = self._rectify(curr_img)
        k1, d1 = self.detector.detectAndCompute(prev_img, None)
        k2, d2 = self.detector.detectAndCompute(curr_img, None)
        if d1 is None or d2 is None:
            self.n_failures += 1
            return prev_abs @ np.eye(4), np.eye(4)
        p1, p2 = self._match(d1, k1, d2, k2)
        if len(p1) < 8:
            self.n_failures += 1
            return prev_abs @ np.eye(4), np.eye(4)

        E, _ = cv2.findEssentialMat(
            p1, p2, self.geom_K, method=cv2.RANSAC, prob=0.999, threshold=1.0
        )  # v3:297-300 (geom_K == original K when faithful, quirk #6)
        if E is None or E.shape != (3, 3):
            self.n_failures += 1
            return prev_abs @ np.eye(4), np.eye(4)
        _, R, t, _ = cv2.recoverPose(E, p1, p2, self.geom_K)  # v3:303-306

        current_P = self.geom_K @ np.hstack([R, t.reshape(3, 1)])  # v3:309
        prev_P = self.previous_projection_matrix if self.faithful else (
            self.geom_K @ np.hstack([np.eye(3), np.zeros((3, 1))])
        )
        X4 = cv2.triangulatePoints(
            prev_P,
            current_P,
            self._corners_for_scale(prev_corners).T,
            self._corners_for_scale(curr_corners).T,
        )  # v3:265
        if self.faithful:
            # v3:269-279: raw homogeneous rows, no division by w.
            c = X4[:3, :2]
        else:
            c = (X4[:3] / np.where(np.abs(X4[3:]) < 1e-12, 1e-12, X4[3:]))[:, :2]
        dist = float(np.linalg.norm(c[:, 0] - c[:, 1]))
        scale = self.real_marker_length / max(dist, 1e-12)  # v3:276-279

        t_scaled = t.T[0] * scale  # v3:321-326
        R_rel = _euler_roundtrip_rotation(R) if self.faithful else R
        rel = np.eye(4)
        rel[:3, :3] = R_rel
        rel[:3, 3] = t_scaled  # make_transform_mat: Trans @ Rot (v3:138-142)

        self.previous_projection_matrix = current_P  # v3:344
        if self.faithful:
            abs_pose = prev_abs @ rel  # v3:367
        else:
            abs_pose = rel @ prev_abs  # consistent curr_T_prev chaining
        return abs_pose, rel


def run_reference(seq, mode="orb", faithful=True):
    """Drive ReferenceVO over a VOSequence with the dual_process loop
    semantics. Returns (present_idx, est_abs (V, 4, 4), n_failures)."""
    present = np.flatnonzero(np.asarray(seq.marker_present))
    frames = np.asarray(seq.frames)
    corners = np.asarray(seq.marker_corners, np.float64)
    vo = ReferenceVO(
        np.asarray(seq.camera.K),
        seq.real_marker_length,
        mode=mode,
        faithful=faithful,
        dist=np.asarray(seq.camera.dist),
        size=(seq.camera.width, seq.camera.height),
    )
    est = np.empty((len(present), 4, 4))
    est[0] = np.asarray(seq.marker_poses[present[0]], np.float64)  # seed cTm_0
    # dual_process:182/214: the corner list gets frame i's corners on the
    # first iteration, then frame i-1's corners ever after (the copy-paste
    # bug) — so VO pair (i-1, i) sees corner pair (i-2, i-1).
    corner_log = [corners[present[0]]]
    for v in range(1, len(present)):
        i_prev, i_curr = present[v - 1], present[v]
        corner_log.append(corners[i_prev if faithful else i_curr])
        est[v], _ = vo.step(
            frames[i_prev],
            frames[i_curr],
            est[v - 1],
            corner_log[-2],
            corner_log[-1],
        )
    return present, est, vo.n_failures


# ---------------------------------------------------------------------------
# Scenarios + evaluation.
# ---------------------------------------------------------------------------


def _corner_jitter(seq, std_px: float, seed: int = 1):
    """Perturb the marker-corner observations (both pipelines see the same
    jitter): detector noise on the fiducial, the dominant real-world error
    source for marker-triangulated scale."""
    rng = np.random.default_rng(seed)
    noisy = np.asarray(seq.marker_corners).copy()
    mask = np.asarray(seq.marker_present)
    noisy[mask] += rng.normal(scale=std_px, size=noisy[mask].shape).astype(np.float32)
    return dataclasses.replace(seq, marker_corners=noisy)


def _marker_gap(seq, start: int, stop: int):
    """Hide the fiducial for frames [start, stop): these frames vanish from
    the reference's valid stream entirely; the port keeps processing them
    (scale_mode='hold')."""
    present = np.asarray(seq.marker_present).copy()
    present[start:stop] = False
    corners = np.asarray(seq.marker_corners).copy()
    corners[start:stop] = np.nan
    return dataclasses.replace(seq, marker_present=present, marker_corners=corners)


SCENARIOS = ("clean", "corner_noise_1px", "marker_gap", "drift_loop", "distorted_1440")


def scenarios(quick: bool = False):
    """parity.py's five scenarios, rendered by the port: clean,
    corner_noise_1px, marker_gap (render seeds 3/13/23; 3 alone in quick
    mode), the 200-frame drift_loop and distorted_1440 (the reference's
    production camera, 1440x1080 with its plumb_bob lens,
    Parameters/camera_calibration.yaml:21-29)."""
    from droplet_visual_odometry_tpu_torch.data import synthetic

    n1 = 30 if quick else 60
    n2 = 60 if quick else 200
    base = synthetic.SyntheticConfig(n_frames=n1, width=640, height=480)
    return {
        "clean": synthetic.render_sequence(base),
        "corner_noise_1px": _corner_jitter(
            synthetic.render_sequence(dataclasses.replace(base, seed=2)), 1.0
        ),
        "marker_gap": [
            _marker_gap(
                synthetic.render_sequence(dataclasses.replace(base, seed=sd)),
                n1 // 3,
                2 * n1 // 3,
            )
            for sd in ((3,) if quick else (3, 13, 23))
        ],
        "drift_loop": synthetic.render_sequence(
            dataclasses.replace(
                base, n_frames=n2, seed=4, loop=True, orbit_sweep=0.9, dolly=0.3
            )
        ),
        "distorted_1440": synthetic.render_sequence(
            dataclasses.replace(
                base,
                n_frames=n1,
                seed=5,
                width=1440,
                height=1080,
                fx=1173.854081,
                fy=1170.565083,
                cx=747.788206,
                cy=574.700374,
                distortion=np.array(
                    [-0.296079, 0.099771, 0.000222, 0.000109, 0.0]
                ),
                n_landmarks=700,
                landmark_size=0.07,
            )
        ),
    }


def evaluate(seq, present_idx, est_abs):
    """ATE/RPE on camera-center trajectories in the marker frame, over the
    given marker-present frames (identical treatment for every pipeline)."""
    from droplet_visual_odometry_tpu_torch.eval import metrics

    gt = np.linalg.inv(np.asarray(seq.marker_poses, np.float64)[present_idx])
    es = np.linalg.inv(np.asarray(est_abs, np.float64))
    a = metrics.ate(gt, es, align="none")
    r = metrics.rpe(gt, es, delta=1)
    return {
        "ate_rmse_m": round(a.rmse, 6),
        "ate_max_m": round(a.max, 6),
        "rpe_trans_rmse_m": round(r.trans_rmse, 6),
        "rpe_rot_rmse_deg": round(r.rot_rmse_deg, 6),
    }


# ---------------------------------------------------------------------------
# The port's rows.
# ---------------------------------------------------------------------------


def ours_config(scale_mode: str = "marker", frontend: str = "orb"):
    """parity.py:run_ours's VOConfig: the float-descriptor modes pair with
    Lowe-ratio matching (v3:223-230)."""
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig

    if frontend == "orb":
        return VOConfig(scale_mode=scale_mode)
    return VOConfig(scale_mode=scale_mode, frontend=frontend, match_mode="ratio", dog_threshold=0.5)


def run_ours(seq, backend="none", scale_mode="marker", seed=0, frontend="orb", device="cuda"):
    """One "ours" row: the port's run_experiment on `device`; returns
    (marker-present frame indices, their estimated cTm)."""
    from droplet_visual_odometry_tpu_torch import pipeline

    res = pipeline.run_experiment(
        seq, ours_config(scale_mode, frontend), seed=seed, backend=backend, device=device
    )
    present = np.flatnonzero(np.asarray(seq.marker_present))
    return present, res.vo_abs[present]


REF_VARIANTS = [
    ("reference (faithful port)", dict(mode="orb", faithful=True), False),
    ("reference (intent, bugs fixed)", dict(mode="orb", faithful=False), True),
    ("reference knn_sift (intent)", dict(mode="knn_sift", faithful=False), True),
]
DEFAULT_LABEL = "ours default (pose_graph+hold)"


def ours_rows(name: str, quick: bool = False) -> list[tuple[str, str, str, str, bool]]:
    """parity.py:run_scenario's "ours" rows of a scenario:
    (label, backend, scale_mode, frontend, all_seeds). scale_mode is 'hold'
    on marker_gap; the shipped default (pose_graph+hold) runs everywhere;
    sift and surf on clean and corner_noise_1px."""
    sm = "hold" if name == "marker_gap" else "marker"
    rows = [("ours none", "none", sm, "orb", True)]
    if not quick:
        rows += [
            ("ours ba", "ba", sm, "orb", False),
            ("ours pose_graph", "pose_graph", sm, "orb", False),
            (DEFAULT_LABEL, "pose_graph", "hold", "orb", True),
        ]
        if name in ("clean", "corner_noise_1px"):
            rows += [
                ("ours sift", "none", sm, "sift", False),
                ("ours surf", "none", sm, "surf", False),
            ]
    return rows


def _as_list(seq) -> list:
    return list(seq) if isinstance(seq, (list, tuple)) else [seq]


def _reference_tasks(seqs: list):
    """(label, sequence, variant kwargs) in parity.py's order: each variant
    on the first render seed, those flagged all_seeds on every seed."""
    for si, sq in enumerate(seqs):
        for label, kwargs, all_seeds in REF_VARIANTS:
            if si == 0 or all_seeds:
                yield label, sq, kwargs


def _reference_sample(seq, kwargs: dict) -> dict:
    pres, est, nf = run_reference(seq, **kwargs)
    return evaluate(seq, pres, est) | {"n_failures": nf}


def ours_samples(name: str, seqs: list, quick=False, device="cuda", known=None) -> dict:
    """The port's rows of a scenario on each render seed: {label: [metrics]};
    identical (backend, scale_mode, frontend) rows run once per seed.

    known: {(backend, scale_mode, frontend): evaluate(...) dict} for the
    first seed, rows the caller has already run on the same device (taken
    as they are, not run again)."""
    per_label = {}
    for si, sq in enumerate(seqs):
        cache = dict(known or {}) if si == 0 else {}
        for label, backend, scale_mode, frontend, all_seeds in ours_rows(name, quick):
            if si > 0 and not all_seeds:
                continue
            key = (backend, scale_mode, frontend)
            if key not in cache:
                pres, est = run_ours(
                    sq, backend=backend, scale_mode=scale_mode, frontend=frontend, device=device
                )
                cache[key] = evaluate(sq, pres, est)
            per_label.setdefault(label, []).append(dict(cache[key]))
    return per_label


def summarize(per_label: dict) -> dict:
    """Each row's mean over its samples; `n_failures` summed, `seeds` the
    sample count."""
    rows = {}
    for label, samples in per_label.items():
        keys = [k for k in samples[0] if isinstance(samples[0][k], (int, float))]
        rows[label] = {
            k: round(float(np.mean([s[k] for s in samples])), 6) for k in keys
        }
        if "n_failures" in samples[0]:  # total across seeds, not a mean
            rows[label]["n_failures"] = int(sum(s["n_failures"] for s in samples))
        rows[label]["seeds"] = len(samples)
    return rows


def run_scenario(name, seq, quick=False, device="cuda"):
    """Every row of one scenario, as parity.py:run_scenario (see run_all)."""
    return run_all({name: seq}, quick, device)[0][name]


def run_all(scen: dict, quick=False, device="cuda", known=None) -> tuple[dict, dict]:
    """Every row of every scenario of `scen`, as parity.py:run_scenario.
    Each scenario maps to one VOSequence or a list of them (render seeds):
    rows flagged all_seeds are scored on every seed and reported as the
    mean, the others on the first seed only (`seeds` records each row's
    sample count). known: {name: see ours_samples}. The reference chain
    (host OpenCV, independent of the port) runs in spawned worker
    processes, half the host's cores, while this one runs the port's rows.
    Returns ({name: rows}, walls in s: each scenario's port rows, and
    "reference" until the last reference row)."""
    tasks = [(name, *task) for name, seq in scen.items() for task in _reference_tasks(_as_list(seq))]
    workers = max(1, min(len(tasks), (os.cpu_count() or 2) // 2))
    ctx = multiprocessing.get_context("spawn")
    t_ref = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
    try:
        futures = [(name, label, pool.submit(_reference_sample, sq, kwargs)) for name, label, sq, kwargs in tasks]
        ours, walls = {}, {}
        for name, seq in scen.items():
            t0 = time.perf_counter()
            ours[name] = ours_samples(name, _as_list(seq), quick, device, (known or {}).get(name))
            walls[name] = time.perf_counter() - t0
        refs = {name: {} for name in scen}
        for name, label, fut in futures:
            refs[name].setdefault(label, []).append(fut.result())
        walls["reference"] = time.perf_counter() - t_ref
    finally:  # a failed port row stops the workers' queue too
        pool.shutdown(wait=True, cancel_futures=True)
    return {name: summarize(refs[name] | ours[name]) for name in scen}, walls


# ---------------------------------------------------------------------------
# The hold against the JAX package and the gates.
# ---------------------------------------------------------------------------

# The JAX package's "ours" rows (ATE RMSE, m) on the full-size scenarios at
# RANSAC seed 0 (PARITY.md's run), and each row's range (min, max) over
# RANSAC seeds 0-3, from
#   JAX_PLATFORMS=cpu python tools/jax_parity_figures.py --seeds 0 1 2 3
# run on a CPU. On marker_gap the none and default rows are the mean over
# render seeds 3/13/23 (their range is that mean's), the others seed 3's.
# A port row is held within twice its spread (max - min) of the JAX row, and
# reported when it lies outside the range of the four seeds. The port's rows
# draw the JAX package's seed-0 samples (utils/threefry.py), but XLA's jit
# moves the 8-point solves and near-tied MSAC winners (ROADMAP C.2), so a
# row is not the JAX row to the digit.
JAX_ATE_RMSE = {
    "clean": {
        "ours none": 0.113883, "ours ba": 0.093239, "ours pose_graph": 0.113883, DEFAULT_LABEL: 0.113883,
        "ours sift": 0.209324, "ours surf": 0.172966,
    },
    "corner_noise_1px": {
        "ours none": 0.086198, "ours ba": 0.055213, "ours pose_graph": 0.086198, DEFAULT_LABEL: 0.086198,
        "ours sift": 0.205362, "ours surf": 0.210208,
    },
    "marker_gap": {
        "ours none": 0.13824, "ours ba": 0.214228, "ours pose_graph": 0.080536, DEFAULT_LABEL: 0.065907,
    },
    "drift_loop": {
        "ours none": 0.109735, "ours ba": 0.111412, "ours pose_graph": 0.090596, DEFAULT_LABEL: 0.090596,
    },
    "distorted_1440": {
        "ours none": 0.248967, "ours ba": 0.238076, "ours pose_graph": 0.248967, DEFAULT_LABEL: 0.248967,
    },
}
JAX_ATE_RANGE = {
    "clean": {
        "ours none": (0.10269, 0.113883), "ours ba": (0.093239, 0.11857),
        "ours pose_graph": (0.10269, 0.113883), DEFAULT_LABEL: (0.10269, 0.113883),
        "ours sift": (0.19256, 0.217775), "ours surf": (0.159583, 0.172966),
    },
    "corner_noise_1px": {
        "ours none": (0.086198, 0.126311), "ours ba": (0.055213, 0.096185),
        "ours pose_graph": (0.086198, 0.126311), DEFAULT_LABEL: (0.086198, 0.126311),
        "ours sift": (0.205362, 0.216163), "ours surf": (0.20314, 0.230098),
    },
    "marker_gap": {
        "ours none": (0.110806, 0.152447), "ours ba": (0.183704, 0.279325),
        "ours pose_graph": (0.077106, 0.135999), DEFAULT_LABEL: (0.050834, 0.075363),
    },
    "drift_loop": {
        "ours none": (0.109735, 0.140803), "ours ba": (0.108985, 0.151401),
        "ours pose_graph": (0.090596, 0.140855), DEFAULT_LABEL: (0.090596, 0.140855),
    },
    "distorted_1440": {
        "ours none": (0.214286, 0.266152), "ours ba": (0.209227, 0.26841),
        "ours pose_graph": (0.214286, 0.266152), DEFAULT_LABEL: (0.214286, 0.266152),
    },
}


def holds(results: dict) -> dict:
    """{scenario: {label: hold}} for every "ours" row with a JAX row: the
    port's and the JAX package's ATE, their difference, the tolerance
    (twice the JAX seed spread), the margin (tolerance - |difference|),
    whether it holds, and whether the port's row lies inside the JAX
    package's range over its seeds."""
    out = {}
    for name, rows in results.items():
        for label, m in rows.items():
            if not label.startswith("ours") or label not in JAX_ATE_RMSE.get(name, {}):
                continue
            jax_ate, (lo, hi) = JAX_ATE_RMSE[name][label], JAX_ATE_RANGE[name][label]
            port = m["ate_rmse_m"]
            tol = 2.0 * (hi - lo)
            diff = port - jax_ate
            out.setdefault(name, {})[label] = dict(
                port=port, jax=jax_ate, diff=round(diff, 6), tol=round(tol, 6),
                margin=round(tol - abs(diff), 6), ok=bool(abs(diff) <= tol),
                jax_range=[lo, hi], in_range=bool(lo <= port <= hi),
            )
    return out


def outside_range(hold: dict) -> list[str]:
    """The port's rows that lie outside the JAX package's range of seeds,
    held or not."""
    return [
        f"{name}: {label} ATE {h['port']} outside the JAX seeds' [{h['jax_range'][0]}, {h['jax_range'][1]}]"
        for name, rows in hold.items()
        for label, h in rows.items()
        if not h["in_range"]
    ]


def gate_failures(results: dict) -> list[str]:
    """parity.py's two gates, per scenario: the best "ours" row and the
    shipped default no worse than the best reference row of the same run."""
    failures = []
    for name, rows in results.items():
        best_ref = min(v["ate_rmse_m"] for k, v in rows.items() if k.startswith("reference"))
        best_ours = min(v["ate_rmse_m"] for k, v in rows.items() if k.startswith("ours"))
        if best_ours > best_ref:
            failures.append(f"{name}: ours {best_ours} > reference {best_ref}")
        default = rows.get(DEFAULT_LABEL)
        if default is not None and default["ate_rmse_m"] > best_ref:
            failures.append(f"{name}: default config {default['ate_rmse_m']} > reference {best_ref}")
    return failures


def hold_failures(results: dict) -> list[str]:
    return [
        f"{name}: {label} ATE {h['port']} vs the JAX package's {h['jax']} +- {h['tol']}"
        for name, rows in holds(results).items()
        for label, h in rows.items()
        if not h["ok"]
    ]


def exit_code(results: dict, quick: bool = False) -> int:
    """1 when a gate or a hold fails (each printed), else 0. Quick mode
    shrinks the sequences and skips the backends, so its margins are not
    the claim: it always exits 0."""
    if quick:
        print("quick mode: smoke only, exit gates skipped", file=sys.stderr)
        return 0
    failures = gate_failures(results) + hold_failures(results)
    for msg in failures:
        print(f"PARITY FAIL: {msg}", file=sys.stderr)
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# Output.
# ---------------------------------------------------------------------------


def format_md(
    results: dict,
    title: str = "# PARITY — accuracy of the reference pipeline vs this framework",
    command: str = "python parity.py --write-md",
) -> str:
    """The results as parity.py:format_md writes them (the same text for the
    default title and command)."""
    lines = [
        title,
        "",
        f"Generated by `{command}` (see its docstring for the",
        "port's provenance, faithful-quirk list, and evaluation protocol).",
        "ATE/RPE over shared marker-present frames, camera-center trajectories",
        "in the marker frame, align='none'. Lower is better.",
        "",
    ]
    for scen, rows in results.items():
        lines += [f"## {scen}", ""]
        n_seeds = max(m.get("seeds", 1) for m in rows.values())
        if n_seeds > 1:
            lines += [
                f"Mean over {n_seeds} render seeds for the gated rows "
                "(single-seed margins here are seed-luck-sized — see "
                "run_scenario's docstring); `seeds` column = sample count.",
                "",
            ]
        lines.append(
            "| pipeline | ATE RMSE (m) | ATE max (m) | RPE trans RMSE (m) | RPE rot RMSE (deg) | seeds |"
        )
        lines.append("|---|---|---|---|---|---|")
        for label, m in rows.items():
            fail = f" ({m['n_failures']} failures)" if m.get("n_failures") else ""
            lines.append(
                f"| {label}{fail} | {m['ate_rmse_m']:.4f} | {m['ate_max_m']:.4f} "
                f"| {m['rpe_trans_rmse_m']:.4f} | {m['rpe_rot_rmse_deg']:.4f} "
                f"| {m.get('seeds', 1)} |"
            )
        lines.append("")
        best_ref = min(
            v["ate_rmse_m"] for k, v in rows.items() if k.startswith("reference")
        )
        best_ours = min(
            v["ate_rmse_m"] for k, v in rows.items() if k.startswith("ours")
        )
        verdict = "PASS" if best_ours <= best_ref else "FAIL"
        lines.append(
            f"Best reference ATE {best_ref:.4f} m vs best ours {best_ours:.4f} m "
            f"-> **{verdict}**"
        )
        default = rows.get(DEFAULT_LABEL)
        if default is not None:
            dv = "PASS" if default["ate_rmse_m"] <= best_ref else "FAIL"
            lines.append(
                f"Single shipped default (pose_graph+hold) ATE "
                f"{default['ate_rmse_m']:.4f} m -> **{dv}**"
            )
        lines.append("")
    return "\n".join(lines)


def format_holds_md(hold: dict) -> str:
    """The hold of every "ours" row against the JAX package's, as a table."""
    lines = [
        "## Hold against the JAX package",
        "",
        "Each row within twice the JAX package's seed 0-3 spread of its",
        "PARITY.md row (`tools/jax_parity_figures.py`, run on a CPU); the last",
        "column says whether it lies inside the JAX package's range over those seeds.",
        "",
        "| scenario | row | port ATE (m) | JAX ATE (m) | difference | tolerance | margin | holds "
        "| JAX seeds 0-3 (m) | inside |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name, rows in hold.items():
        for label, h in rows.items():
            lo, hi = h["jax_range"]
            lines.append(
                f"| {name} | {label} | {h['port']:.6f} | {h['jax']:.6f} | {h['diff']:+.6f} "
                f"| {h['tol']:.6f} | {h['margin']:+.6f} | {'yes' if h['ok'] else '**no**'} "
                f"| {lo:.6f} - {hi:.6f} | {'yes' if h['in_range'] else '**no**'} |"
            )
    lines.append("")
    return "\n".join(lines)


def card_line(device) -> str:
    """The card as nvidia-smi names it (name, power limit), or the CPU."""
    if device.type != "cuda":
        return "CPU (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def commit_name() -> str:
    """The commit of the checkout that holds this package (with '+
    uncommitted changes' when its tree differs), or 'unknown' when the
    package's parent directory is not the root of a git checkout: git
    searches no further up, so a copy inside another repository does not
    name that repository's commit."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, GIT_CEILING_DIRECTORIES=os.path.dirname(root))
    git = lambda *a: subprocess.run(["git", "-C", root, *a], capture_output=True, text=True, check=True,
                                    env=env).stdout.strip()
    try:
        head, dirty = git("rev-parse", "HEAD"), git("status", "--porcelain", "--untracked-files=no")
    except (OSError, subprocess.CalledProcessError):
        return "unknown (not a git checkout)"
    return head + (" + uncommitted changes" if dirty else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the port's rows (the reference chain is always host OpenCV)")
    ap.add_argument("--write-md", action="store_true", help="write PARITY_TORCH.md")
    ap.add_argument("--quick", action="store_true",
                    help="small sequences, frame-to-frame backend only (exit gates skipped)")
    ap.add_argument("--scenario", default=None, choices=SCENARIOS, help="run a single scenario")
    ap.add_argument("--commit", default=None,
                    help="the commit to name in PARITY_TORCH.md where the package is not in a git checkout")
    args = ap.parse_args(argv)

    import cv2

    device = resolve_device(args.device)
    card = card_line(device)
    scen = scenarios(args.quick)
    if args.scenario:
        scen = {args.scenario: scen[args.scenario]}
    results, walls = run_all(scen, quick=args.quick, device=device)
    for name, rows in results.items():
        print(json.dumps({name: rows}))
    print(f"walls (s): {json.dumps({k: round(v, 1) for k, v in walls.items()})}", file=sys.stderr)

    hold = {} if args.quick else holds(results)
    if hold:
        print(json.dumps({"holds": hold}))
    for msg in outside_range(hold):
        print(f"parity: {msg}", file=sys.stderr)
    if args.write_md:
        commit = commit_name()
        if commit.startswith("unknown") and args.commit:
            commit = args.commit
        header = "\n".join([
            f"Card: {card}. Commit: {commit}. "
            f"Reference rows on OpenCV {cv2.__version__}, port rows on `{device}`"
            f"{' (quick mode)' if args.quick else ''}.",
            "",
        ])
        text = format_md(
            results,
            title="# PARITY_TORCH — accuracy of the reference pipeline vs the PyTorch port",
            command="python -m droplet_visual_odometry_tpu_torch.parity --write-md",
        )
        first, rest = text.split("\n", 1)
        with open("PARITY_TORCH.md", "w") as f:
            f.write(first + "\n\n" + header + rest + "\n" + (format_holds_md(hold) if hold else ""))
        print("wrote PARITY_TORCH.md", file=sys.stderr)

    return exit_code(results, args.quick)


if __name__ == "__main__":
    sys.exit(main())
