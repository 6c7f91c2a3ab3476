"""Experiment configuration — port of the ExperimentConfig dataclass of
droplet_visual_odometry_tpu/utils/config.py.

Same fields and defaults: the shipped default is backend="pose_graph" with
VOConfig(scale_mode="hold"). The YAML round-trip (to_yaml / from_yaml /
save / load) comes with the CLI (ROADMAP A15).
"""

from __future__ import annotations

import dataclasses

from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Everything needed to reproduce one experiment run."""

    sequence: str = ""  # VOSequence .npz path ('' -> synthetic)
    out_dir: str = ""  # where the six stamped_*.txt streams go
    marker_id: int = 0
    real_marker_length: float = 0.2  # metres
    calibration: str = ""  # camera yaml ('' -> sequence-embedded intrinsics)
    controlled: bool = False  # calibration schema switch
    backend: str = "pose_graph"  # 'none' | 'ba' | 'pose_graph'
    seed: int = 0
    checkpoint_path: str = ""  # '' disables checkpointing
    checkpoint_every: int = 0  # frames between checkpoints (0 = chunk only)
    vo: VOConfig = VOConfig(scale_mode="hold")
