"""float_describe_ms_per_frame.seq: the device time of the float
frontend's describe stage (`vo.float_describe`, timed inside every replay:
the blur, the patches, orientation and the gradient histograms) over the
frames of the window's replays, in ms a frame."""

from vobench import programspans


def read(run):
    return programspans.stage_ms_per_frame(run, "vo.float_describe")
