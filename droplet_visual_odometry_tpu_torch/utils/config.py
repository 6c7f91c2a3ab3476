"""Experiment configuration — port of droplet_visual_odometry_tpu/utils/config.py:
the ExperimentConfig dataclass and its YAML round-trip.

Same fields and defaults: the shipped default is backend="pose_graph" with
VOConfig(scale_mode="hold"). Nested configs (VO, RANSAC) map to nested YAML
mappings in field order, the same text as the reference writes; unknown keys
raise instead of being dropped. PyYAML is imported by the functions that
read or write YAML.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
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


_NESTED = {"vo": VOConfig, "ransac": RansacConfig}


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def _from_dict(cls, d: dict):
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise KeyError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**{
        name: _from_dict(_NESTED[name], value) if name in _NESTED and isinstance(value, dict) else value
        for name, value in d.items()
    })


def to_yaml(cfg: ExperimentConfig) -> str:
    import yaml

    return yaml.safe_dump(_to_dict(cfg), sort_keys=False)


def from_yaml(text: str) -> ExperimentConfig:
    import yaml

    return _from_dict(ExperimentConfig, yaml.safe_load(text) or {})


def save(path: str, cfg: ExperimentConfig) -> None:
    with open(path, "w") as f:
        f.write(to_yaml(cfg))


def load(path: str) -> ExperimentConfig:
    with open(path) as f:
        return from_yaml(f.read())
