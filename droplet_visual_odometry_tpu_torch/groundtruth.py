"""Fiducial-marker ground truth — port of droplet_visual_odometry_tpu/groundtruth.py.

Conventions are the reference's: the marker detector reports bTm as a
translation and an xyzw quaternion; with `use_base_link`, cTm = cTb @ bTm
with the rig's fixed camera<-base_link extrinsic, else cTm = bTm. A frame's
ground truth is the detection whose id equals `reference_id`; frames
without it are flagged absent (a mask, never a crash).

Every function is batched over frames and over the up-to-M detections per
frame and runs on the device of its input tensors: a whole sequence's
ground truth is a handful of launches (the reference jits it into one
program), with no per-frame Python loop. `sequence_from_detections`, the
ingest entry point, runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.utils.device import resolve_device

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


def select_marker(
    dets: MarkerDetections, reference_id: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per frame, the detection with `reference_id`: (t (N, 3), q (N, 4),
    corners (N, 4, 2), found (N,) bool). The first matching slot wins; when
    the id is absent the outputs are slot 0's values with found=False."""
    hit = dets.ids == reference_id  # (N, M)
    found = torch.any(hit, dim=1)
    slot = torch.argmax(hit.to(torch.uint8), dim=1)  # the first maximal index: the first hit, or 0

    def take(x: torch.Tensor) -> torch.Tensor:
        idx = slot.reshape((-1,) + (1,) * (x.ndim - 1)).expand((-1, 1) + x.shape[2:])
        return torch.gather(x, 1, idx)[:, 0]

    return take(dets.translations), take(dets.quaternions), take(dets.corners), found


def marker_keypoints(corners: torch.Tensor) -> torch.Tensor:
    """Corner array -> (N*4, 2) flat keypoint list."""
    return corners.reshape(-1, 2)


def reorder_corners(corners: torch.Tensor) -> torch.Tensor:
    """Sort 4 corners counter-clockwise by angle around their centroid,
    (..., 4, 2) -> (..., 4, 2). The sort is stable, as the reference's:
    tied angles keep their input order."""
    d = corners - torch.mean(corners, dim=-2, keepdim=True)
    order = torch.argsort(torch.atan2(d[..., 1], d[..., 0]), dim=-1, stable=True)
    return torch.gather(corners, -2, order[..., None].expand(corners.shape))


def side_lengths(corners: torch.Tensor) -> torch.Tensor:
    """Consecutive-corner distances of the angle-ordered quad: (..., 4, 2) -> (..., 4)."""
    ordered = reorder_corners(corners)
    return torch.linalg.vector_norm(torch.roll(ordered, -1, dims=-2) - ordered, dim=-1)


def marker_pixel_length(corners: torch.Tensor) -> torch.Tensor:
    """Mean side length in pixels (the reference's primary estimator)."""
    return torch.mean(side_lengths(corners), dim=-1)


def marker_pixel_length_extent(corners: torch.Tensor) -> torch.Tensor:
    """max-X - min-X extent (the reference's variant 2; biased for rotated markers)."""
    x = corners[..., 0]
    return torch.amax(x, dim=-1) - torch.amin(x, dim=-1)


class GroundTruthStreams(NamedTuple):
    """Per-frame ground truth for a sequence."""

    cTm: torch.Tensor  # (N, 4, 4)
    corners: torch.Tensor  # (N, 4, 2)
    present: torch.Tensor  # (N,) bool
    pixel_length: torch.Tensor  # (N,) float32 mean side length


def derive_ground_truth(
    dets: MarkerDetections, reference_id: int, cfg: GroundTruthConfig = GroundTruthConfig()
) -> GroundTruthStreams:
    """Whole-sequence ground truth on the detections' device: the reference
    marker selected in every frame, its pose as cTm, its pixel side length."""
    t, q, corners, found = select_marker(dets, reference_id)
    return GroundTruthStreams(
        cTm=marker_pose_to_cTm(t, q, cfg),
        corners=corners,
        present=found,
        pixel_length=marker_pixel_length(corners),
    )


def relative_stream(cTm: torch.Tensor, present: torch.Tensor | None = None) -> torch.Tensor:
    """Ground-truth relative poses cTm_curr @ inv(cTm_prev) of consecutive
    frames; identity where either frame lacks the marker (given `present`)."""
    rel = se3.gt_relative(cTm[:-1], cTm[1:])
    if present is not None:
        ok = (present[:-1] & present[1:])[:, None, None]
        rel = torch.where(ok, rel, torch.eye(4, dtype=rel.dtype, device=rel.device))
    return rel


def sequence_from_detections(
    frames: np.ndarray,
    timestamps: np.ndarray,
    dets: MarkerDetections,
    reference_id: int,
    camera,
    real_marker_length: float,
    cfg: GroundTruthConfig = GroundTruthConfig(),
    *,
    device="cuda",
):
    """A VOSequence from stamp-aligned frames and raw marker detections (the
    reference's ingest path: paired stream -> ground-truth poses), with the
    ground truth derived on `device` ("cuda" or "cpu"). Pair the streams
    first (data.native_store.pair_stamps or data.sequence.pair_timestamps)."""
    from droplet_visual_odometry_tpu_torch.data.sequence import VOSequence

    dev = resolve_device(device)
    streams = derive_ground_truth(MarkerDetections(*(a.to(dev) for a in dets)), reference_id, cfg)
    present = streams.present.cpu().numpy()
    corners = np.where(present[:, None, None], streams.corners.cpu().numpy(), np.nan).astype(np.float32)
    seq = VOSequence(
        frames=np.asarray(frames),
        timestamps=np.asarray(timestamps, np.float64),
        marker_corners=corners,
        marker_poses=streams.cTm.cpu().numpy().astype(np.float32),
        marker_present=present,
        marker_ids=np.where(present, reference_id, -1).astype(np.int32),
        camera=camera,
        real_marker_length=float(real_marker_length),
    )
    seq.validate()
    return seq


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


def frame_detections(seq, i: int) -> MarkerDetections | None:
    """Frame i of a sequence as the one-frame MarkerDetections a live push
    gets (M = 1): marker id 0 at the frame's marker pose (bTm,
    so cTm with use_base_link=False) and corners; None where the frame
    shows no marker."""
    if not seq.marker_present[i]:
        return None
    t, q = se3.to_translation_quaternion(torch.as_tensor(np.asarray(seq.marker_poses[i], np.float32)))
    return detections_from_arrays(np.zeros((1, 1), np.int32), t.numpy()[None, None],
                                  q.numpy()[None, None], np.asarray(seq.marker_corners[i])[None, None])
