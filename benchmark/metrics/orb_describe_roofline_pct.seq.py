"""orb_describe_roofline_pct.seq: the fused ORB describe at K = 512 keypoints
a frame on every level of one VO program, alone on the card (L2 evicted,
launch hidden), as a share in % of the least time that
roofline/orb_describe.py counts for it at the H100's published peaks."""


def read(run):
    from vobench import kernels

    return kernels.roofline_pct("orb_describe", run.kernel_inputs())
