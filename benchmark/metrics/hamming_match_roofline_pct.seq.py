"""hamming_match_roofline_pct.seq: the match reductions of one VO program's
pairs at K = 512, alone on the card (L2 evicted, launch hidden), as a
share in % of the least time that roofline/hamming_match.py counts for it
at the H100's published peaks."""


def read(run):
    from vobench import kernels

    return kernels.roofline_pct("hamming_match", run.kernel_inputs())
