"""l2_match_roofline_pct.seq: the float match reductions of one VO
program's pairs at the cell's K and D (SIFT sets made by the plain
frontend from the cell's raw frames), alone on the card (L2 evicted, launch
hidden), as a share in % of the least time that roofline/l2_match.py counts
for them at the H100's published float32 rate. Nothing to read where the
driver makes no float sets or the program has no such kernel."""


def read(run):
    from vobench import kernels

    inputs = getattr(run.driver, "l2_match_inputs", None)
    return kernels.roofline_pct("l2_match", inputs(run)) if inputs else None
