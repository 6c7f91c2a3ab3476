"""Offline runs through the windowed bundle adjustment: a closed loop of
run_experiment(backend="ba"), one client, the next sequence started when
the previous one returns.

The set-up, the window and the outputs are the offline driver's
(drivers/offline.py); what differs is the backend's configuration, the
configuration's `refine` (RefineConfig fields), handed to run_experiment,
and the check of the refined trajectory.

`correct`: the offline driver's three VO gaps, and `refined_gap_m`: the
program's refined trajectory against the plain windowed BA
(plainref/backend/windowed_ba.py) run again on that sequence's own
anchored VO output, from the raw frames. Sequences with the same VO output
are one group, and the reference runs once a group.
"""

from __future__ import annotations

import hashlib
import tempfile
import time

import numpy as np
import torch

from vobench import cells, compare, scene, window

offline = cells.module("drivers", "offline")

State = offline.State
notes = offline.notes
end_to_end = offline.end_to_end
release = offline.release
kernel_frames = offline.kernel_frames
outputs = offline.outputs


def setup(config: dict, traffic: dict, seed: int, device, workers: int | None = None) -> State:
    t0 = time.perf_counter()
    seq = scene.make_sequence(config, traffic, workers)
    t1 = time.perf_counter()
    state = State(config, traffic, seed, torch.device(device), seq, scene.program_sequence(seq),
                  tempfile.mkdtemp(prefix="vobench-tum-") if traffic.get("tum_files") else None,
                  dict(config["vo"]))
    call(state, -1)  # the warm pass: the VO program and both BA window shapes are captured here
    state.setup_s = {"render": t1 - t0, "warm_pass": time.perf_counter() - t1}
    return state


def call(state: State, k: int) -> dict:
    """One sequence through the program's run_experiment with the BA backend."""
    from droplet_visual_odometry_tpu_torch.backend.refine import RefineConfig
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.pipeline import run_experiment

    res = run_experiment(
        state.program_seq, VOConfig(**state.vo_cfg), out_dir=state.out_dir, seed=scene.ransac_seed(state.seed),
        backend=state.traffic["backend"], refine_cfg=RefineConfig(**state.config["refine"]),
        stream=bool(state.traffic["stream"]), device=state.device,
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

    offline.trace_targets(tracer)
    tracer.wrap_span(pipeline, "refine_trajectory")


# -- the plain reference ------------------------------------------------------

def reference_outputs(state: State, out: list[dict], as_control: bool = False) -> dict:
    """The reference's VO (offline.reference_outputs); with as_control, its
    windowed BA too, each one precision below the configuration's: the VO
    and the keyframe frontend with TF32 on, the windows' geometry in float32
    (the configuration states float64 there)."""
    res = offline.reference_outputs(state, out, as_control)
    if as_control:
        with compare.tf32(True):
            res["refined"] = _reference_backend(state, res, torch.float32)
    return res


def control_outputs(state: State, out: list[dict]) -> list[dict]:
    """The control in the program's place: one sequence's outputs."""
    return [reference_outputs(state, out, as_control=True)]


def _reference_backend(state: State, out: dict, dtype=torch.float64) -> np.ndarray:
    """The plain windowed BA over a sequence's anchored VO output, its
    keyframes fetched from the raw frames and undistorted by the reference,
    its windows' geometry in `dtype`."""
    from plainref import pipeline as ref
    from plainref.backend import windowed_ba

    camera, _ = offline._ref_inputs(state)
    s = state.seq
    preprocess = ref.make_preprocessor(camera, state.device)
    K = ref.effective_K(camera).astype(np.float32)
    corners = ref.effective_marker_corners(s.marker_corners, camera, K)
    refined, _ = windowed_ba.refine_trajectory(
        lambda idx: preprocess(s.frames[np.asarray(idx)]), offline._anchored(state, out["abs"]), out["n_inliers"],
        K, windowed_ba.RefineConfig(**state.config["refine"]), marker_corners=corners,
        marker_length=s.clip.marker_length, dtype=dtype,
    )
    return refined


def numbers(state: State, outputs: list[dict], ref: dict) -> dict[str, float]:
    """The offline driver's VO gaps, and the widest refined gap over the
    largest groups of sequences with one VO output."""
    nums = offline.numbers(state, outputs, ref)
    groups: dict[str, list[dict]] = {}
    for o in outputs:
        h = hashlib.sha1(b"".join(np.ascontiguousarray(o[k]).tobytes() for k in ("abs", "n_inliers"))).hexdigest()
        groups.setdefault(h, []).append(o)
    largest = sorted(groups.values(), key=len, reverse=True)[:offline.MAX_BACKEND_CHECKS]
    gaps = []
    for group in largest:
        refined = _reference_backend(state, group[0])
        gaps += [compare.trans_gap(o["refined"], refined).max() for o in group]
    nums["refined_gap_m"] = compare.widest(gaps)
    return nums
