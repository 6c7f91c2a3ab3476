"""vo_solver_ms_per_frame.seq: the device time of the VO program's solver
stage (`vo.solver`, timed inside every replay: match, LO-RANSAC, scale,
chain) over the frames of the window's replays, in ms a frame."""

from vobench import programspans


def read(run):
    return programspans.stage_ms_per_frame(run, "vo.solver")
