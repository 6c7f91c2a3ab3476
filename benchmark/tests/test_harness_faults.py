"""The run's comparison sees each fault a cell can have, planted in the
timed path underneath a run on the CPU: an answer altered where it is
produced, half of the batch left out, and a step that returns its state
unchanged. (The cells run on one chip: no exchange between chips.)"""

import pytest

from harness_tiny import drive, run_cell_body

ALTER_ONE_PAIR = """
import numpy as np
from droplet_visual_odometry_tpu_torch import pipeline
orig = pipeline.run_sequence
def faulty(*a, **k):
    t = orig(*a, **k)
    t.rel_poses[3, 0, 3] += 0.01  # one pair's answer altered where it is produced
    return t
pipeline.run_sequence = faulty
"""
HALF_THE_PAIRS = """
import torch
from droplet_visual_odometry_tpu_torch import pipeline
orig = pipeline.run_sequence
def faulty(*a, **k):
    t = orig(*a, **k)
    n = t.rel_poses.shape[0]
    t.rel_poses[n // 2:] = torch.eye(4)  # the second half of the pairs left out
    return t
pipeline.run_sequence = faulty
"""
STREAM_HALF_THE_PAIRS = """
import numpy as np
from droplet_visual_odometry_tpu_torch import pipeline
orig = pipeline.run_sequence_checkpointed
def faulty(*a, **k):
    t = orig(*a, **k)
    n = t.rel_poses.shape[0]
    t.rel_poses[n // 2:] = np.eye(4)  # the chunks' second half of the pairs left out
    return t
pipeline.run_sequence_checkpointed = faulty
"""
BACKEND_UNCHANGED = """
from droplet_visual_odometry_tpu_torch import pipeline
orig = pipeline.pose_graph_trajectory
def faulty(frames, abs_poses, *a, **k):
    refined, info = orig(frames, abs_poses, *a, **k)
    return abs_poses.copy(), info  # the backend's step returns its state unchanged
pipeline.pose_graph_trajectory = faulty
"""
PUSH_UNCHANGED = """
import dataclasses
import numpy as np
from droplet_visual_odometry_tpu_torch.stream import OnlineVO
orig = OnlineVO.push
def faulty(self, *a, **k):
    before = self.pose
    res = orig(self, *a, **k)
    if res.armed and res.n_matches:
        self._pose = before  # the step leaves the engine's state unchanged
        return dataclasses.replace(res, pose=before, rel=np.eye(4, dtype=np.float32))
    return res
OnlineVO.push = faulty
"""


@pytest.mark.parametrize("cell, patch", [
    ("tiny_cam.offline_t", ALTER_ONE_PAIR),
    ("tiny_cam.offline_t", HALF_THE_PAIRS),
    ("tiny_cam.offline_t", BACKEND_UNCHANGED),
    ("tiny_cam.stream_t", STREAM_HALF_THE_PAIRS),
    ("tiny_cam.live_t", PUSH_UNCHANGED),
], ids=["answer_altered", "half_left_out", "backend_unchanged", "stream_half_left_out", "push_unchanged"])
def test_fault_makes_the_run_incorrect(tiny_root, cell, patch):
    res = drive(tiny_root, run_cell_body(cell, 2**31 + 3, 0.5, False, patch))
    assert res["correct"] is False, res["checks"]
    assert any(line.endswith("FAILED") for line in res["lines"])


@pytest.mark.parametrize("cell", ["tiny_cam.offline_t", "tiny_cam.stream_t", "tiny_cam.live_t"])
def test_sound_run_is_correct(tiny_root, cell):
    res = drive(tiny_root, run_cell_body(cell, 2**31 + 3, 0.5, False))
    assert res["correct"] is True, res["checks"]
