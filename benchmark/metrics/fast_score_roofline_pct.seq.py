"""fast_score_roofline_pct.seq: FAST's scores on every pyramid level of one
VO program, alone on the card (L2 evicted, launch hidden), as a share in %
of the least time that roofline/fast_score.py counts for it at the H100's
published peaks."""


def read(run):
    from vobench import kernels

    return kernels.roofline_pct("fast_score", run.kernel_inputs())
