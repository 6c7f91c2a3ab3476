"""ba_ms.seq: the program's `refine.ba` span (refine_trajectory: keyframes,
the keyframe frontend and match, every BA window, re-anchoring), host wall
in ms; the median over the window's sequences."""

from vobench import programspans


def read(run):
    return programspans.median_per_sequence(run, lambda g: programspans.host_ms(g, ("refine.ba",)))
