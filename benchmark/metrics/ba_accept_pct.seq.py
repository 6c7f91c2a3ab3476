"""ba_accept_pct.seq: 100 x the BA windows the trust gates accepted over
the windows solved (not skipped for too few tracks), summed over the
window's `ba.window` spans (counts `accepted` and `skipped`)."""

from vobench import programspans


def read(run):
    solved = [r for r in programspans.records(run) or () if r.name == "ba.window" and not r.attrs.get("skipped", 1)]
    return 100.0 * sum(r.attrs["accepted"] for r in solved) / len(solved) if solved else None
