"""match_ms_per_pair.seq: the device time of the VO program's match stage
(`vo.match`, timed inside every replay: the descriptor match of every
pair, through csrc/l2_match.cu for float sets) over the pairs of the
window's replays, in ms a pair."""

from vobench import programspans


def read(run):
    stages = [r for r in programspans.records(run) or () if r.name == "vo.match" and r.dev_t0 is not None]
    pairs = sum(r.attrs.get("pairs", 0) for r in stages)
    return sum(r.dev_t1 - r.dev_t0 for r in stages) * 1e3 / pairs if pairs else None
