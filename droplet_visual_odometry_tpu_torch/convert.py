"""Build the port's configs and camera from plain data.

This system has no learned weights: its state is the configs, the camera,
the constant tables and the backends' problems (a pose graph, a BA window).
These helpers take the reference package's state as plain Python/numpy data
(`dataclasses.asdict` of its configs, its camera arrays, the fields of its
PoseGraph and BAWindow), so tests can build both packages from one source.
"""

from __future__ import annotations

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.backend.ba import BAConfig, BAWindow
from droplet_visual_odometry_tpu_torch.backend.keyframes import KeyframeConfig
from droplet_visual_odometry_tpu_torch.backend.loop_closure import LoopClosureConfig
from droplet_visual_odometry_tpu_torch.backend.pose_graph import PoseGraph, PoseGraphConfig
from droplet_visual_odometry_tpu_torch.backend.refine import PoseGraphRefineConfig, RefineConfig
from droplet_visual_odometry_tpu_torch.core.camera import Camera
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
from droplet_visual_odometry_tpu_torch.groundtruth import GroundTruthConfig, MarkerDetections, detections_from_arrays
from droplet_visual_odometry_tpu_torch.utils.config import ExperimentConfig
from droplet_visual_odometry_tpu_torch.utils.device import resolve_device


def ransac_config_from_dict(d: dict) -> RansacConfig:
    return RansacConfig(**d)


def vo_config_from_dict(d: dict) -> VOConfig:
    d = dict(d)
    if "ransac" in d:
        d["ransac"] = ransac_config_from_dict(d["ransac"])
    return VOConfig(**d)


def keyframe_config_from_dict(d: dict) -> KeyframeConfig:
    return KeyframeConfig(**d)


def loop_closure_config_from_dict(d: dict) -> LoopClosureConfig:
    return LoopClosureConfig(**d)


def pose_graph_config_from_dict(d: dict) -> PoseGraphConfig:
    return PoseGraphConfig(**d)


def pose_graph_refine_config_from_dict(d: dict) -> PoseGraphRefineConfig:
    d = dict(d)
    for name, build in (("kf", keyframe_config_from_dict), ("lc", loop_closure_config_from_dict),
                        ("pg", pose_graph_config_from_dict)):
        if name in d:
            d[name] = build(d[name])
    return PoseGraphRefineConfig(**d)


def ba_config_from_dict(d: dict) -> BAConfig:
    return BAConfig(**d)


def refine_config_from_dict(d: dict) -> RefineConfig:
    d = dict(d)
    for name, build in (("kf", keyframe_config_from_dict), ("ba", ba_config_from_dict)):
        if name in d:
            d[name] = build(d[name])
    return RefineConfig(**d)


def experiment_config_from_dict(d: dict) -> ExperimentConfig:
    d = dict(d)
    if "vo" in d:
        d["vo"] = vo_config_from_dict(d["vo"])
    return ExperimentConfig(**d)


def camera_from_arrays(K, dist, width: int, height: int) -> Camera:
    return Camera(
        K=np.asarray(K, np.float32).reshape(3, 3),
        dist=np.asarray(dist, np.float32).reshape(5),
        width=int(width),
        height=int(height),
    )


def gt_config_from_jax(d: dict) -> GroundTruthConfig:
    """The port's GroundTruthConfig from `dataclasses.asdict` of the reference's."""
    return GroundTruthConfig(**{k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in d.items()})


def detections_from_jax(dets) -> MarkerDetections:
    """The port's MarkerDetections from the reference's (ids, translations,
    quaternions, corners), each converted with np.asarray."""
    return detections_from_arrays(*(np.asarray(a) for a in dets))


def pose_graph_from_jax(graph, device="cuda") -> PoseGraph:
    """The port's PoseGraph on `device` from the reference's fields in its
    order (poses, edge_i, edge_j, edge_meas, edge_weight), each copied
    with np.array: float32 poses, measurements and weights, int64 edges."""
    dev = resolve_device(device)
    poses, ei, ej, meas, w = (np.array(a) for a in graph)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    return PoseGraph(poses=f32(poses), edge_i=i64(ei), edge_j=i64(ej), edge_meas=f32(meas), edge_weight=f32(w))


def ba_window_from_jax(window, device="cuda") -> BAWindow:
    """The port's BAWindow on `device` from the reference's fields in its
    order (poses, points, obs_uv, obs_mask, K), each copied with
    np.array."""
    dev = resolve_device(device)
    poses, points, obs_uv, obs_mask, K = (np.array(a) for a in window)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return BAWindow(poses=f32(poses), points=f32(points), obs_uv=f32(obs_uv),
                    obs_mask=torch.as_tensor(obs_mask, dtype=torch.bool, device=dev), K=f32(K))
