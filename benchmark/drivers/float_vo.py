"""Offline runs in the reference's SIFT mode: a closed loop of
run_experiment(backend="none") with a float frontend, one client, the next
sequence started when the previous one returns.

The program's side is the offline driver's (drivers/offline.py): set-up,
warm pass, window, outputs and the numbers compared. What differs is the
reference, plainref/estimation/float_vo.py (the plain SIFT frontend in
blocks of frames, the plain L2 match over each pair's whole matrix in
blocks of pairs, then LO-RANSAC, scale and chain over all pairs at once
with the program's draws), its
control (the same with TF32 on, one precision below the configuration's),
and the inputs of the L2 match's roofline share: one VO program's pairs of
SIFT sets, made by the plain frontend from the cell's raw frames.

`correct`: the offline driver's three VO gaps (per pair the rotation and
the scaled translation, and the trajectory against the reference's pairs
chained in float64).
"""

from __future__ import annotations

from vobench import cells, compare, scene

offline = cells.module("drivers", "offline")

State = offline.State
setup = offline.setup
notes = offline.notes
call = offline.call
run_window = offline.run_window
trace_targets = offline.trace_targets
end_to_end = offline.end_to_end
release = offline.release
kernel_frames = offline.kernel_frames
outputs = offline.outputs
numbers = offline.numbers


def reference_outputs(state: State, out: list[dict], as_control: bool = False) -> dict:
    """The plain float VO over the sequence's raw frames, TF32 off; with
    as_control, TF32 on. Every sequence of `out` is the same work, so one
    run serves them all. The program's captured programs are freed first:
    the reference's LO-RANSAC over all 143 pairs of 8,192 points needs the
    card's memory (a next call captures again)."""
    from plainref.estimation import float_vo

    release(state)
    camera, cfg = offline._ref_inputs(state)
    s = state.seq
    with compare.tf32(as_control):
        traj, vo_abs = float_vo.run_vo(s.frames, s.marker_corners, s.marker_present, s.marker_poses, camera,
                                       s.clip.marker_length, cfg, scene.ransac_seed(state.seed), state.device)
    return dict(n_matches=traj.n_matches, n_inliers=traj.n_inliers, rel=traj.rel_poses, abs=traj.abs_poses,
                scale_ok=traj.scale_ok, refined=vo_abs)


def control_outputs(state: State, out: list[dict]) -> list[dict]:
    """The control in the program's place: one sequence's outputs."""
    return [reference_outputs(state, out, as_control=True)]


def l2_match_inputs(run) -> dict:
    """The L2 match's inputs at one VO program's shapes: the pairs' SIFT
    sets (desc_a, desc_b, valid_a, valid_b) under `float_pairs`, and the
    first frame under `levels` (which says the device), made once a run."""
    if "l2_match_inputs" not in run.cache:
        from plainref.estimation import float_vo

        camera, cfg = offline._ref_inputs(run.state)
        pairs = float_vo.descriptor_pairs(kernel_frames(run.state), camera, cfg, run.device)
        run.cache["l2_match_inputs"] = dict(levels=[pairs[0][:1]], float_pairs=pairs)
    return run.cache["l2_match_inputs"]
