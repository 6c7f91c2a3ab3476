"""The live node: OnlineVO.push of uint8 host frames with their marker
detections, in an open loop at the camera's rate.

Push k is due at k / rate_hz after the window opens and carries the next
frame of the clip, cycled over frames 0 .. clip-2 (the clip is a closed
loop), with the marker's detection (its id, pose as translation and
quaternion, and corners) where the marker is wholly in view. The engine
is armed and its graph captured by `warm_pushes` pushes in set-up.

`correct`: a sample of the window's pushes drawn from the seed against the
plain reference's push step, worked out again from the same two raw
frames, corners and draws (the rotation and the scaled translation of the
step: they rest on the frontend, the match, LO-RANSAC and the marker
scale), and every pose the engine returned against the float64 chain of
the steps it returned, from the arming detection (the one stage that
follows the program's state; the steps are held above).
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from vobench import compare, scene, window


@dataclasses.dataclass
class State:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    seq: scene.Sequence
    engine: object
    detections: list
    pushes: list  # (step, previous clip frame, clip frame, result) of every armed push, in order
    arm_frame: int = -1
    arm_pose: np.ndarray | None = None
    next_frame: int = 0
    step: int = 0  # armed pushes so far: push `step` draws from fold_in(PRNGKey(seed), step)
    setup_s: dict = dataclasses.field(default_factory=dict)  # set-up's phases

    def close(self) -> None:
        pass


def _quaternion_xyzw(R: np.ndarray) -> np.ndarray:
    """A rotation matrix's unit quaternion (x, y, z, w), w >= 0."""
    m = np.asarray(R, np.float64)
    w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
    x = np.sqrt(max(0.0, 1.0 + m[0, 0] - m[1, 1] - m[2, 2])) / 2.0
    y = np.sqrt(max(0.0, 1.0 - m[0, 0] + m[1, 1] - m[2, 2])) / 2.0
    z = np.sqrt(max(0.0, 1.0 - m[0, 0] - m[1, 1] + m[2, 2])) / 2.0
    x = np.copysign(x, m[2, 1] - m[1, 2])
    y = np.copysign(y, m[0, 2] - m[2, 0])
    z = np.copysign(z, m[1, 0] - m[0, 1])
    return np.array([x, y, z, w])


def _detections(seq: scene.Sequence) -> list:
    """Each clip frame's detection of marker 0 as the program's type (None
    where the marker is not wholly in view)."""
    from droplet_visual_odometry_tpu_torch.groundtruth import detections_from_arrays

    clip = seq.clip
    out = []
    for i in range(clip.frames.shape[0]):
        if not clip.marker_present[i]:
            out.append(None)
            continue
        pose = clip.marker_poses[i]
        out.append(detections_from_arrays(
            np.asarray([[0]], np.int32), np.asarray(pose[:3, 3], np.float32)[None, None],
            _quaternion_xyzw(pose[:3, :3]).astype(np.float32)[None, None], clip.marker_corners[i][None, None]))
    return out


def setup(config: dict, traffic: dict, seed: int, device, workers: int | None = None) -> State:
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.groundtruth import GroundTruthConfig
    from droplet_visual_odometry_tpu_torch.stream import OnlineVO

    t0 = time.perf_counter()
    seq = scene.make_sequence(config, traffic, workers)
    t1 = time.perf_counter()
    clip = seq.clip
    engine = OnlineVO(K=np.asarray(clip.camera.K), real_marker_length=clip.marker_length,
                      cfg=VOConfig(**config["vo"]), gt_cfg=GroundTruthConfig(use_base_link=False),
                      seed=scene.ransac_seed(seed), device=device)
    state = State(config, traffic, seed, torch.device(device), seq, engine, _detections(seq), [])
    for _ in range(int(traffic["warm_pushes"])):  # arms the engine, then captures its graph
        push(state, -1)
    if state.arm_frame < 0:
        raise RuntimeError("no marker armed the engine during the warm pushes")
    state.setup_s = {"render": t1 - t0, "warm_pushes": time.perf_counter() - t1}
    return state


def push(state: State, k: int):
    n_cycle = int(state.traffic["clip_frames"]) - 1
    i = state.next_frame
    prev = (i - 1) % n_cycle
    state.next_frame = (i + 1) % n_cycle
    was_armed = state.engine.armed
    res = state.engine.push(i / float(state.config["fps"]), state.seq.clip.frames[i], state.detections[i])
    if not was_armed and res.armed:
        state.arm_frame = i
        state.arm_pose = res.pose
    elif was_armed:
        state.step += 1
        state.pushes.append((state.step, prev, i, res))
    return res


def run_window(state: State, seconds: float, tracer=None) -> window.Window:
    rate = float(state.traffic["rate_hz"])
    if tracer is None:
        return window.open_loop(lambda k: push(state, k), seconds, rate)

    def traced(k):
        with tracer.span("push"):
            return push(state, k)
    return window.open_loop(traced, seconds, rate)


def trace_targets(tracer) -> None:
    tracer.wrap_replays()


def end_to_end(state: State, win: window.Window) -> dict[str, float]:
    return {"push_p95_ms": window.percentile(window.latencies_ms(win), 95)}


def notes(state: State, win: window.Window) -> list[str]:
    """How late the generator sent the window's pushes."""
    late = window.lateness_ms(win)
    return [f"set-up phases (s): {json.dumps(state.setup_s)}",
            f"pushes {len(win.calls)} at {state.traffic['rate_hz']} Hz; sent late by median "
            f"{window.percentile(late, 50)!r} ms, p95 {window.percentile(late, 95)!r} ms, max {float(late.max())!r} ms"]


def window_pushes(state: State, win: window.Window) -> list:
    """The armed pushes the window made, in order."""
    ids = {id(c.output) for c in win.calls if c.error is None}
    return [p for p in state.pushes if id(p[3]) in ids]


def outputs(state: State, win: window.Window) -> dict:
    """What the engine returned: the steps of a sample of the window's
    pushes drawn from the seed (the last push always in it), and every
    relative pose and pose since arming."""
    w = window_pushes(state, win)
    n = min(int(state.traffic["sample_pushes"]), len(w))
    rng = np.random.default_rng(scene.ransac_seed(state.seed))
    pick = np.unique(np.concatenate([rng.choice(len(w) - 1, n - 1, replace=False), [len(w) - 1]])) if n else []
    sample = [w[i] for i in pick]
    return dict(steps=np.array([p[0] for p in sample]), prev=np.array([p[1] for p in sample], np.int64),
                curr=np.array([p[2] for p in sample], np.int64), rel=np.stack([p[3].rel for p in sample]),
                arm_pose=state.arm_pose, all_rel=np.stack([p[3].rel for p in state.pushes]),
                poses=np.stack([state.arm_pose] + [p[3].pose for p in state.pushes]))


def reference_outputs(state: State, out: dict, as_control: bool = False) -> dict:
    """The reference's push step for each sampled push, as the engine runs
    it: each frame detected and described alone, one pair at a time (LO-
    RANSAC's sums differ with the batch), the step's own draws; in float32
    with TF32 off, or with TF32 on for the control."""
    from plainref import pipeline as ref
    from plainref.estimation.vo import VOConfig

    clip = state.seq.clip
    corners = np.nan_to_num(clip.marker_corners)
    valid = clip.marker_present
    prev, curr = out["prev"], out["curr"]
    with compare.tf32(as_control):
        r = ref.push_steps(clip.frames, prev, curr, out["steps"],
                           np.where(valid[prev][:, None, None], corners[prev], 0.0),
                           np.where(valid[curr][:, None, None], corners[curr], 0.0), valid[prev] & valid[curr],
                           np.asarray(clip.camera.K), clip.marker_length, VOConfig(**state.config["vo"]),
                           scene.ransac_seed(state.seed), state.device)
    return dict(rel=r["rel"], n_matches=r["n_matches"])


def control_outputs(state: State, out: dict) -> dict:
    """The control in the program's place: its steps for the sampled
    pushes in TF32, and the chain of the window's steps in bfloat16 (the
    engine chains on the host in float32: bfloat16 is the nearest below)."""
    c = reference_outputs(state, out, as_control=True)
    poses = [torch.as_tensor(out["arm_pose"], dtype=torch.bfloat16)]
    for r in out["all_rel"]:
        poses.append(torch.as_tensor(r, dtype=torch.bfloat16) @ poses[-1])
    return dict(out, rel=c["rel"], poses=torch.stack(poses).float().numpy())


def numbers(state: State, out: dict, ref: dict) -> dict[str, float]:
    """The sampled steps against the reference's, and every pose against
    the float64 chain of the steps returned, from the arming detection."""
    arm = state.seq.clip.marker_poses[state.arm_frame]
    chain = compare.chain64(out["arm_pose"], out["all_rel"])
    return {
        "push_rot_gap_deg": compare.widest(compare.rot_gap_deg(out["rel"], ref["rel"])),
        "push_trans_gap_m": compare.widest(compare.trans_gap(out["rel"], ref["rel"])),
        "push_chain_gap_m": compare.widest(np.concatenate([compare.trans_gap(out["poses"], chain),
                                                           compare.trans_gap(out["arm_pose"][None], arm[None])])),
    }
