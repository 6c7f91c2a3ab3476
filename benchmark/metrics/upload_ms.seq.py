"""upload_ms.seq: per sequence, the device time of every frame copy to the
card with its remap (the program's spans `pipeline.preprocess`: in-memory
frames; `checkpoint.copy`: a streamed chunk; `refine.upload`: streamed
keyframes), in ms; the median over the window's sequences."""

from vobench import programspans

NAMES = ("pipeline.preprocess", "checkpoint.copy", "refine.upload")


def read(run):
    return programspans.median_per_sequence(run, lambda g: programspans.device_ms(g, NAMES))
