"""Fiducial-marker ground truth: the parts that stream.OnlineVO uses — port
of droplet_visual_odometry_tpu/groundtruth.py (GroundTruthConfig,
MarkerDetections, marker_pose_to_cTm, detections_from_arrays).

Conventions are the reference's: the marker detector reports bTm as a
translation and an xyzw quaternion; with `use_base_link`, cTm = cTb @ bTm
with the rig's fixed camera<-base_link extrinsic, else cTm = bTm. The
detections are host (CPU) tensors, as the reference's live path reads them
on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.core import se3

# Fixed camera_T_baselink extrinsics of the BlueROV rig: translation
# [0, 0, -0.133] m, quaternion (xyzw) [0.5, -0.5, 0.5, 0.5].
DEFAULT_CAMERA_T_BASE_TRANSLATION = (0.0, 0.0, -0.133)
DEFAULT_CAMERA_T_BASE_QUAT_XYZW = (0.5, -0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class GroundTruthConfig:
    """Same fields and defaults as the reference's GroundTruthConfig."""

    camera_t_base: tuple = DEFAULT_CAMERA_T_BASE_TRANSLATION
    camera_q_base_xyzw: tuple = DEFAULT_CAMERA_T_BASE_QUAT_XYZW
    use_base_link: bool = True

    def camera_T_base(self) -> torch.Tensor:
        return se3.from_translation_quaternion(
            torch.tensor(self.camera_t_base, dtype=torch.float32),
            torch.tensor(self.camera_q_base_xyzw, dtype=torch.float32),
        )


class MarkerDetections(NamedTuple):
    """Up to M marker detections per frame; slots beyond the count have id -1."""

    ids: torch.Tensor  # (N, M) int32
    translations: torch.Tensor  # (N, M, 3) float32 — bTm translation
    quaternions: torch.Tensor  # (N, M, 4) float32 xyzw — bTm rotation
    corners: torch.Tensor  # (N, M, 4, 2) float32 pixel corners


def marker_pose_to_cTm(
    t: torch.Tensor, q_xyzw: torch.Tensor, cfg: GroundTruthConfig = GroundTruthConfig()
) -> torch.Tensor:
    """Detections' (translation (..., 3), xyzw quaternion (..., 4)) -> camera_T_marker (..., 4, 4)."""
    bTm = se3.from_translation_quaternion(t, q_xyzw)
    if not cfg.use_base_link:
        return bTm
    return se3.compose(cfg.camera_T_base().to(bTm.device), bTm)


def detections_from_arrays(
    ids: np.ndarray, translations: np.ndarray, quaternions: np.ndarray, corners: np.ndarray
) -> MarkerDetections:
    """Host-side constructor from numpy arrays (e.g. a converted bag)."""
    return MarkerDetections(
        ids=torch.as_tensor(np.asarray(ids, np.int32)),
        translations=torch.as_tensor(np.asarray(translations, np.float32)),
        quaternions=torch.as_tensor(np.asarray(quaternions, np.float32)),
        corners=torch.as_tensor(np.asarray(corners, np.float32)),
    )
