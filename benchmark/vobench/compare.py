"""What decides `correct`: the numbers a driver compares, each against its
limit in limits/<cell>.json, and the lower-precision control.

Every number is a widest gap between what the timed path produced and what
the plain reference (plainref/) works out again from the same raw inputs,
so it is 0 or small for a sound run. The control is the reference put in
the program's place with TF32 on: the configurations state float32 with
TF32 off, so TF32 is the nearest precision below. A number is within its
limit when it is finite and no larger than the limit.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def rot_gap_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle in degrees of the rotation between poses a and b (..., 4, 4),
    from the chord ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2), which stays
    exact near 0 where arccos of the trace does not."""
    d = np.asarray(a, np.float64)[..., :3, :3] - np.asarray(b, np.float64)[..., :3, :3]
    chord = np.sqrt(np.sum(d * d, axis=(-2, -1)))
    return np.degrees(2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def trans_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance between the translations of poses a and b (..., 4, 4)."""
    return np.linalg.norm(np.asarray(a, np.float64)[..., :3, 3] - np.asarray(b, np.float64)[..., :3, 3], axis=-1)


def widest(values) -> float:
    """The largest of the values; NaN if any is not finite (it fails)."""
    v = np.asarray(list(values), np.float64).ravel()
    if v.size == 0:
        return math.nan
    return float(v.max()) if np.all(np.isfinite(v)) else math.nan


def chain64(init_pose: np.ndarray, rels: np.ndarray) -> np.ndarray:
    """abs_0 = init_pose, abs_i = rel_i @ abs_(i-1), in float64."""
    out = [np.asarray(init_pose, np.float64)]
    for r in np.asarray(rels, np.float64):
        out.append(r @ out[-1])
    return np.stack(out)


def judge(numbers: dict[str, float], limits: dict[str, dict]) -> tuple[bool, list[str]]:
    """(every number within its limit and every limit's number present,
    one line per number: its name, value and limit)."""
    lines, ok = [], True
    for name, lim in limits.items():
        v = numbers.get(name, math.nan)
        within = math.isfinite(v) and v <= lim["limit"]
        ok &= within
        lines.append(f"{name} {v!r} limit {lim['limit']!r} {'ok' if within else 'FAILED'}")
    return ok, lines


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for matmuls and convolutions on or off inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
