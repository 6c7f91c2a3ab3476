"""Build the port's configs and camera from plain data.

This system has no learned weights: its state is the configs, the camera and
the constant tables. These helpers take the reference package's state as
plain Python/numpy data (`dataclasses.asdict` of its configs, its camera
arrays), so tests can build both packages from one source.
"""

from __future__ import annotations

import numpy as np

from droplet_visual_odometry_tpu_torch.core.camera import Camera
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig


def ransac_config_from_dict(d: dict) -> RansacConfig:
    return RansacConfig(**d)


def vo_config_from_dict(d: dict) -> VOConfig:
    d = dict(d)
    if "ransac" in d:
        d["ransac"] = ransac_config_from_dict(d["ransac"])
    return VOConfig(**d)


def camera_from_arrays(K, dist, width: int, height: int) -> Camera:
    return Camera(
        K=np.asarray(K, np.float32).reshape(3, 3),
        dist=np.asarray(dist, np.float32).reshape(5),
        width=int(width),
        height=int(height),
    )
