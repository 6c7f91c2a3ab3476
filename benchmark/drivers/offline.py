"""Offline runs of a recorded sequence: a closed loop of run_experiment,
one client, the next sequence started when the previous one returns.

The mix names the clip, the sequence length, the marker runs, the backend,
whether VO streams in chunks, and whether the six TUM files are written
(under TMPDIR). Every sequence of the window is the same sequence with the
same RANSAC seed, so the warm-up call captures every program at every
shape the window meets, keyframe counts included.

`correct`: every sequence's output against the plain reference, worked out
once from the same raw frames: per pair the rotation and the scaled
translation (they rest on the frontend's keypoints and descriptors, the
match, LO-RANSAC, the marker scale and its hold), the VO trajectory against the reference's own pairs
chained in float64, and with a backend the refined trajectory against the
reference backend run on that sequence's VO output (the one stage that
follows the program's state; the VO it starts from is held above).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from vobench import compare, scene, window

CHUNK = 256  # pairs a streamed chunk holds: run_experiment's default, unless the mix names one


@dataclasses.dataclass
class State:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    seq: scene.Sequence
    program_seq: object
    out_dir: str | None
    vo_cfg: dict
    setup_s: dict = dataclasses.field(default_factory=dict)  # set-up's phases

    @property
    def frames_per_call(self) -> int:
        return int(self.seq.frames.shape[0])

    @property
    def chunk(self) -> int:
        return int(self.traffic.get("chunk", CHUNK))

    def close(self) -> None:
        if self.out_dir:
            shutil.rmtree(self.out_dir, ignore_errors=True)


def setup(config: dict, traffic: dict, seed: int, device, workers: int | None = None) -> State:
    t0 = time.perf_counter()
    seq = scene.make_sequence(config, traffic, workers)
    t1 = time.perf_counter()
    state = State(config, traffic, seed, torch.device(device), seq, scene.program_sequence(seq),
                  tempfile.mkdtemp(prefix="vobench-tum-") if traffic.get("tum_files") else None,
                  dict(config["vo"]))
    call(state, -1)  # the warm pass: every capture of the window's programs falls here
    state.setup_s = {"render": t1 - t0, "warm_pass": time.perf_counter() - t1}
    return state


def notes(state: State, win: window.Window) -> list[str]:
    walls = np.array([c.end - c.start for c in win.calls]) * 1e3
    return [f"set-up phases (s): {json.dumps(state.setup_s)}; sequences {len(win.calls)} of "
            f"{state.frames_per_call} frames in {win.seconds!r} s; a sequence's wall (ms) p10 "
            f"{np.percentile(walls, 10)!r} median {np.median(walls)!r} p90 {np.percentile(walls, 90)!r} "
            f"max {walls.max()!r}"]


def call(state: State, k: int) -> dict:
    """One sequence through the program's run_experiment: what it produced."""
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.pipeline import run_experiment

    res = run_experiment(
        state.program_seq, VOConfig(**state.vo_cfg), out_dir=state.out_dir, seed=scene.ransac_seed(state.seed),
        backend=state.traffic["backend"], stream=bool(state.traffic["stream"]), checkpoint_chunk=state.chunk,
        device=state.device,
    )
    t = res.trajectory
    return dict(n_matches=np.asarray(t.n_matches), n_inliers=np.asarray(t.n_inliers),
                rel=np.asarray(t.rel_poses), abs=np.asarray(t.abs_poses), scale_ok=np.asarray(t.scale_ok),
                refined=np.asarray(res.vo_abs))


def run_window(state: State, seconds: float, tracer=None) -> window.Window:
    if tracer is None:
        return window.closed_loop(lambda k: call(state, k), seconds)

    def traced(k):
        with tracer.span("run_experiment", frames=state.frames_per_call):
            return call(state, k)
    return window.closed_loop(traced, seconds)


def trace_targets(tracer) -> None:
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.utils import graphs

    tracer.wrap_span(pipeline, "run_sequence", frames_arg=0)
    tracer.wrap_span(pipeline, "run_sequence_checkpointed", frames_arg=0)
    tracer.wrap_span(pipeline, "pose_graph_trajectory")
    tracer.wrap_programs(graphs)
    tracer.wrap_replays()


def end_to_end(state: State, win: window.Window) -> dict[str, float]:
    return {"seq_fps": window.items_per_s(win, state.frames_per_call)}


def release(state: State) -> None:
    """Free the program's captured programs and their pools."""
    from droplet_visual_odometry_tpu_torch.utils import graphs

    graphs.clear()


def kernel_frames(state: State) -> np.ndarray:
    """The raw frames of one VO program: the whole sequence, or a chunk's
    pairs and the frame before them when VO streams."""
    n = state.frames_per_call if not state.traffic["stream"] else min(state.frames_per_call, state.chunk + 1)
    return state.seq.frames[:n]


def outputs(state: State, win: window.Window) -> list[dict]:
    return [c.output for c in win.calls if c.error is None]


# -- the plain reference ------------------------------------------------------

def _ref_inputs(state: State):
    from plainref.core.camera import make_camera
    from plainref.estimation.vo import VOConfig

    cam = state.seq.clip.camera
    return make_camera(cam.K[0, 0], cam.K[1, 1], cam.K[0, 2], cam.K[1, 2], cam.dist, cam.width, cam.height), \
        VOConfig(**state.vo_cfg)


def reference_outputs(state: State, out: list[dict], as_control: bool = False) -> dict:
    """The reference's VO over the sequence, in float32 with TF32 off; or,
    with as_control, the reference in the program's place with TF32 on, its
    backend too. Every sequence of `out` is the same work, so one run serves
    them all."""
    from plainref import pipeline as ref

    camera, cfg = _ref_inputs(state)
    s = state.seq
    with compare.tf32(as_control):
        traj, vo_abs, _, _ = ref.run_vo(s.frames, s.marker_corners, s.marker_present, s.marker_poses, camera,
                                        s.clip.marker_length, cfg, scene.ransac_seed(state.seed), state.device,
                                        stream=bool(state.traffic["stream"]), chunk=state.chunk)
        res = dict(n_matches=traj.n_matches, n_inliers=traj.n_inliers, rel=traj.rel_poses, abs=traj.abs_poses,
                   scale_ok=traj.scale_ok, refined=vo_abs)
        if as_control and state.traffic["backend"] == "pose_graph":
            res["refined"] = _reference_backend(state, res)
    return res


def control_outputs(state: State, out: list[dict]) -> list[dict]:
    """The control in the program's place: one sequence's outputs."""
    return [reference_outputs(state, out, as_control=True)]


def _anchored(state: State, abs_poses: np.ndarray) -> np.ndarray:
    present = state.seq.marker_present
    first = int(np.argmax(present)) if present.any() else 0
    vo_abs = np.asarray(abs_poses, np.float64)
    if first > 0:
        vo_abs = vo_abs @ (np.linalg.inv(vo_abs[first]) @ np.asarray(state.seq.marker_poses[first], np.float64))
    return vo_abs


def _reference_backend(state: State, out: dict) -> np.ndarray:
    from plainref import pipeline as ref

    camera, cfg = _ref_inputs(state)
    s = state.seq
    return ref.run_pose_graph(s.frames, _anchored(state, out["abs"]), out["n_inliers"], out["scale_ok"],
                              s.marker_corners, s.marker_present, camera, s.clip.marker_length, cfg, state.device)


MAX_BACKEND_CHECKS = 4  # distinct VO outputs whose backend the reference runs again


def numbers(state: State, outputs: list[dict], ref: dict) -> dict[str, float]:
    """The widest gaps of the outputs from the reference (see the module)."""
    s = state.seq
    first = int(np.argmax(s.marker_present)) if s.marker_present.any() else 0
    ref_traj = compare.chain64(s.marker_poses[first], ref["rel"])
    nums = {
        "rel_rot_gap_deg": compare.widest(compare.rot_gap_deg(o["rel"], ref["rel"]).max() for o in outputs),
        "rel_trans_gap_m": compare.widest(compare.trans_gap(o["rel"], ref["rel"]).max() for o in outputs),
        "traj_gap_m": compare.widest(compare.trans_gap(o["abs"], ref_traj).max() for o in outputs),
    }
    if state.traffic["backend"] == "pose_graph":
        groups: dict[str, list[dict]] = {}
        for o in outputs:
            h = hashlib.sha1(b"".join(np.ascontiguousarray(o[k]).tobytes()
                                      for k in ("abs", "n_inliers", "scale_ok"))).hexdigest()
            groups.setdefault(h, []).append(o)
        largest = sorted(groups.values(), key=len, reverse=True)[:MAX_BACKEND_CHECKS]
        gaps = []
        for group in largest:
            refined = _reference_backend(state, group[0])
            gaps += [compare.trans_gap(o["refined"], refined).max() for o in group]
        nums["refined_gap_m"] = compare.widest(gaps)
    return nums
