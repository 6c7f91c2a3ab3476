"""vo_frontend_ms_per_frame.seq: the device time of the VO program's
frontend stage (`vo.frontend`, timed inside every replay: pyramid, FAST,
NMS/top-k, blur, describe) over the frames of the window's replays, in ms
a frame."""

from vobench import programspans


def read(run):
    return programspans.stage_ms_per_frame(run, "vo.frontend")
