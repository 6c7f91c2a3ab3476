"""ba_host_ms.seq: per sequence, the host walls of the BA backend's host
spans (`refine.keyframes`; per window `ba.tracks`: the tracks' build,
triangulation and filter with the track count's read-back, and `ba.gate`:
the trust gates; `refine.reanchor`), in ms; the median over the window's
sequences."""

from vobench import programspans

NAMES = ("refine.keyframes", "ba.tracks", "ba.gate", "refine.reanchor")


def read(run):
    return programspans.median_per_sequence(run, lambda g: programspans.host_ms(g, NAMES))
