"""verify_yield_pct.seq: 100 x the loop edges accepted over the (restart,
slot) pairs verified, summed over the window's `loop.verify` spans (counts
`accepted` and `slots`): the share of verification's work that became an
edge."""

from vobench import programspans


def read(run):
    spans = [r for r in programspans.records(run) or () if r.name == "loop.verify"]
    slots = sum(r.attrs["slots"] for r in spans)
    return 100.0 * sum(r.attrs["accepted"] for r in spans) / slots if slots else None
