"""backend_host_ms.seq: per sequence, the host walls of the pose-graph
backend's host-only spans (`refine.keyframes`, `loop.select`, `loop.pick`,
`refine.graph`, `refine.reanchor`, and `refine.gather`, the streamed
keyframes' host gather inside `refine.fetch`), in ms; the median over the
window's sequences."""

from vobench import programspans

NAMES = ("refine.keyframes", "loop.select", "loop.pick", "refine.graph", "refine.reanchor", "refine.gather")


def read(run):
    return programspans.median_per_sequence(run, lambda g: programspans.host_ms(g, NAMES))
