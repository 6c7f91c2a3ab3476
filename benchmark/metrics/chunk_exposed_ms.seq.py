"""chunk_exposed_ms.seq: per sequence, the walls of the chunk loop's
`checkpoint.chunk` spans less the part of each that its replay's device
interval (`graphs.replay`) covers: the host fill, copy, fetch and
bookkeeping that no chunk's compute overlaps, in ms; the median over the
window's sequences."""

from vobench import programspans


def _exposed_ms(group):
    chunks = [r for r in group if r.name == "checkpoint.chunk"]
    replays = [r for r in group if r.name == "graphs.replay" and r.dev_t0 is not None]
    if not chunks or not replays:
        return None
    exposed = 0.0
    for c in chunks:
        covered = sum(max(0.0, min(c.t1, r.dev_t1) - max(c.t0, r.dev_t0)) for r in replays if r.parent == c.seq)
        exposed += c.t1 - c.t0 - covered
    return exposed * 1e3


def read(run):
    return programspans.median_per_sequence(run, _exposed_ms)
