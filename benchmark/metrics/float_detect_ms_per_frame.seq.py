"""float_detect_ms_per_frame.seq: the device time of the float frontend's
detect stage (`vo.float_detect`, timed inside every replay: the octave
pyramid, the DoG response, NMS and top-k) over the frames of the window's
replays, in ms a frame."""

from vobench import programspans


def read(run):
    return programspans.stage_ms_per_frame(run, "vo.float_detect")
