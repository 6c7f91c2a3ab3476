"""Build the port's configs and camera from plain data.

This system has no learned weights: its state is the configs, the camera and
the constant tables. These helpers take the reference package's state as
plain Python/numpy data (`dataclasses.asdict` of its configs, its camera
arrays), so tests can build both packages from one source.
"""

from __future__ import annotations

import numpy as np

from droplet_visual_odometry_tpu_torch.backend.keyframes import KeyframeConfig
from droplet_visual_odometry_tpu_torch.backend.loop_closure import LoopClosureConfig
from droplet_visual_odometry_tpu_torch.backend.pose_graph import PoseGraphConfig
from droplet_visual_odometry_tpu_torch.backend.refine import PoseGraphRefineConfig
from droplet_visual_odometry_tpu_torch.core.camera import Camera
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
from droplet_visual_odometry_tpu_torch.utils.config import ExperimentConfig


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
